// Nearest-code search on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vq_argmin_kernel`
// (pgmvae_tpu/ops/pallas_vq.py:38, launched by `vq_codes_fused`).
//
// What it computes. For z [n, B, D] and per-variable codebooks W [n, D, K],
// both float32 or both bfloat16 and contiguous, it writes int32 out[n, B]
// with
//   out[v, b] = argmin_k (|W[v,:,k]|^2 - 2 z[v,b,:].W[v,:,k]).
// |z|^2 is left out: it does not move the argmin. Ties go to the lowest
// index, as with jnp.argmin. The [n, B, K] score tensor is never built. In
// the float32 instance each score is a = fmaf chain of z[d]*W[d,k] over d =
// 0..D-1 in order, |W_k|^2 = fmaf chain of W[d,k]^2 in the same order, s =
// |W_k|^2 - 2a: fp32 FMAs on the SIMT units, as TF32 tensor-core products
// would round z and W to 10 mantissa bits and move codes. The bfloat16
// instance is noted at its own kernel below.
//
// What bounds the float32 instance. 2*n*B*D*K fp32 flops against 4*n*(B*D + D*K + B) bytes
// (each input read once, the output written once). On an H100 (67 TFLOP/s
// fp32 outside the tensor cores, 3.35 TB/s) the ridge is 20 flops a byte:
// stage-2 chunks (B=32, D=20, K=50) sit near 10 and are bound by bytes;
// large codebooks (B=256, K=4096) near 120 and are bound by the FMA rate.
// Either way the card has to be full: many variables with few codes (bbc)
// and few variables with many codes (the kdd sweep, n=64, K=4096) both.
//
// Its design (the launch is planned in Python, `cuda_vq.plan`, and checked
// here). A design of one thread per sample over all K codes gets no
// parallelism from K: at the kdd sweep's (64, 32, 10, 4096) it runs 64
// one-warp blocks on 132 SMs. So:
// - Register micro-tiles. Each thread scores RB (4 or 8) samples x RK = 4
//   codes: per d one 16-byte shared-memory read of its 4 codes, RB/4 reads
//   of its samples and RB*4 FMAs. A warp is TX = 4 code lanes x 8 sample
//   rows, so its reads touch 64 bytes of codes and 128-256 bytes of
//   samples, one or two shared-memory wavefronts for 16-32 FMAs.
// - The d loop reads row d + 1 before it scores row d, so shared-memory
//   latency hides behind the FMAs. It is unrolled to DPAD: D exactly for
//   the D the registry trains (10, 20, 30: no exit at all), else D rounded
//   up, with an exit at D before each step's loads. The samples are read
//   by asm loads, which the compiler leaves in the loop: they are the same
//   in every pass, and an exact instance's loop, with no exit to stop it,
//   would otherwise keep all RB * D of them in registers and spill.
// - K adds parallelism inside the block: WK warps split a code sub-tile of
//   WK*16 codes, WY warps split the samples. The z tile [TB = WY*8*RB][D]
//   is staged once, transposed to [D][TB + 4] (the pad spreads the
//   transposing stores over the banks; unpadded they were 32-way bank
//   conflicts, slower than the scoring at K = 50). Codebook tiles of SUB
//   sub-tiles, [D][SUB*WK*16], stream through a ring of STAGES buffers
//   filled with cp.async (16 bytes .cg where K is a multiple of 4 and W is
//   16-byte aligned, else 4 bytes .ca; zero-fill past K), so the next tile
//   loads while this one is scored. SUB = 4 where a strip holds two such
//   ring tiles or more spreads the ring's wait and barriers over four
//   sub-tiles.
// - With SUB = 4 (K = 4096: the kdd sweep, its Gibbs chain and stage 2) a
//   thread walks 8 groups of RK codes or more, and their selection is
//   grouped:
//   - |W_k|^2 once per ring tile, into a shared table [tk] beside the ring,
//     by the in-order fmaf chain on the tile's values (not once a pass in
//     every thread); codes past the strip's end get +inf, so their scores
//     (fmaf(-2, a, +inf) = +inf) never win a strict <, and the loop tests
//     no code against K. A pass reads its 4 codes' values in one read.
//   - A grouped minimum. For each of its samples a thread takes the
//     minimum of a pass's RK scores (3 FMNMX) and keeps it only on a
//     strict < against its running minimum, with the pass's first code:
//     one compare and two selects for RK scores, not for each. Its codes
//     walk upward, so the earliest group keeps a tie.
//   - The merges below run on (minimum, group). Groups are disjoint runs of
//     RK codes, so of two equal minima the lower group holds the lower
//     code. Then one thread a sample recomputes its winning group's RK
//     scores by the same chains, from the z tile (still in shared memory)
//     and W (the ring, where the group's tile is one of the last two; else
//     device memory, in L2), and takes the lowest code whose score is the
//     minimum: the codes and minima of a compare and select on every score,
//     bit for bit.
//   With SUB = 1 (strips of few codes: bbc's and nltcs's K = 50, the
//   out-of-core twin's 64, small grids cut into narrow strips) a thread
//   walks a few groups, and the recomputation would cost about what the
//   grouping saves: each score is compared and selected on its own, with
//   |W_k|^2 chained in the d loop.
// - The merge of a sample's minima, over the TX lanes by warp shuffles and
//   then over the WK warps through shared memory, orders by (value, then
//   index), so the lowest index wins every tie.
// - Small grids split K. When n * ceil(B/TB) gives fewer than two blocks an
//   SM (kdd: 64), the codes are cut into strips of whole tiles, one block
//   each (grid.z); each block writes its strip's (min, index) to a partial
//   [strips, n, B], and a second launch merges the strips in order with
//   strict <. The result does not depend on block order.
// - Small K packs variables. Where K fits two sub-tiles and a block would
//   be under 128 threads, VPB variables share a block (bbc's stage-2 chunk:
//   two).
// - 128 registers a thread (two blocks of 256 threads an SM): at 80 (three
//   blocks) the loop's shared-memory addresses no longer fit, and the
//   Gibbs step's instance issues 6% more instructions a pass and runs 3%
//   slower.
// What still bounds it (H100, PERF.md): instruction slots, not FMAs or
// bytes. At the Gibbs step's shape (D = 10, RB = 8, K = 4096) a pass of
// 32 scores issues 449 instructions (14.0 a score; 320 of them the
// scores' FMAs, 30 + 1 shared-memory reads, 80 for the scores and the
// grouped minimum), about 49% of the fp32 rate's bound; the barriers and
// tile waits of short blocks are not all hidden.
//
// The bfloat16 instance (`vq_argmin_bf16`, the same Pallas kernel's
// f32-accumulated dot on bf16 operands under bf16 compute, its
// `preferred_element_type=jnp.float32` dot) is a kernel of its own, on the
// tensor cores (`vq_argmin_bf16_kernel`).
// - What bounds it. The products are exact in f32, so the bf16 tensor-core
//   rate (989 TFLOP/s) may take them: 2nBDK operations there against
//   2n(BD + DK) + 4nB bytes, a ridge near 300 operations a byte, and every
//   shape of the port (D <= 30) sits below it: the bound is bytes. What
//   the card spends is otherwise: mma.sync m16n8k16 takes about 18 cycles
//   an HMMA per scheduler on the H100 (a build without the epilogue keeps
//   70% of the kernel's 0.43 ms at (1058, 256, 20, 4096); PERF.md), D pads
//   to 16 or 32, and every score is compared and selected on the SIMT
//   units (3 instructions). bbc's shapes (K = 50) are bound by the latency
//   of each block's loads.
// - Tensor cores for z.W: mma.sync m16n8k16 (bf16 in, f32 accumulate). A
//   block of wm warps holds wm * MT 16-row tiles of z; each warp keeps its
//   A fragments in registers for the whole block (read once from the z
//   tile, which is copied as one run of values) and walks every code of a
//   ring tile 16 at a time, B fragments by ldmatrix.trans from the code
//   tile [DP][TK + 8] (W's own layout). D is padded to DP, a multiple of 16,
//   with zeros in both operands: z's columns past D are zeroed in the A
//   registers, the code tiles' rows past D once in shared memory, so the
//   padding adds exact zeros. The + 8 pad puts the 8 rows an ldmatrix phase
//   reads on 8 different 16-byte bank groups.
// - |W_k|^2 once per code tile, into shared memory, by the float32
//   instance's in-order fmaf chain on the widened values, and the
//   accumulator starts at -|W_k|^2 / 2 (exact): the tensor core leaves
//   acc = z.W_k - |W_k|^2 / 2 = -s_k / 2, and the argmin of s is the argmax
//   of acc, with no arithmetic on a score before its compare. Codes past the
//   strip's end start at -inf and are never taken.
// - Raw bf16 tiles by cp.async: the code ring (two stages) is filled with
//   16-byte .cg copies where K % 8 == 0 and W is 16-byte aligned, 4-byte .ca
//   copies where K is even and W 4-byte aligned, else plain loads (odd K);
//   the z tile likewise by B * D. Tile t + 1 loads while tile t is scored.
// - Epilogue and merge: a thread keeps a running (max, index) for each of
//   its fragment rows (g, g + 8), replaced on a strict > while its columns
//   walk upward, then merged over the quad by shuffles by (value, then
//   lowest index). Small grids split K into strips of two ring tiles or
//   more (`cuda_vq.plan_bf16`: kdd's batch 16 one-warp strips), whose
//   partials (-acc = s / 2, in the float32 instance's order) go through the
//   same merge launch. The result does not depend on block order.
// - Why its codes may differ from the float32 instance's on the same widened
//   values only on near-ties: the products are the same exact values, but
//   the tensor core sums them (and -|W_k|^2 / 2) in its own order and
//   rounding where the fmaf chain sums them one by one, so two scores apart
//   by a few float32 roundings may swap. Two identical code columns get the
//   same accumulator wherever they sit, so the lowest index wins every tie.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RK = 4;              // codes a thread scores per tile
constexpr int TX = 4;              // code lanes of a warp
constexpr int ROWS = 32 / TX;      // sample rows of a warp
constexpr int MAX_THREADS = 256;   // threads a block
constexpr int MAX_D = 128;         // widest latent the kernel takes
constexpr int SMEM_BYTES = 48 * 1024;
constexpr int STAGES = 2;          // code tiles in the ring
constexpr int BLOCKS_PER_SM = 2;   // for __launch_bounds__: 128 registers
constexpr int NO_CODE = 0x7fffffff;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes of shared memory at shared address a + OFFSET. An asm load, so
// that the compiler keeps it where it is written: the z tile's values are
// the same in every pass, and hoisted out of the loops they would take
// RB * D registers (80 at RB = 8, D = 10) and spill
template <int OFFSET>
__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+%5];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a), "n"(OFFSET));
  return v;
}

// a thread's RB samples of one z tile row, at shared address a
template <int RB>
__device__ __forceinline__ void load_z(float4 (&zv)[RB / 4], unsigned a) {
  static_assert(RB == 4 || RB == 8, "RB is 4 or 8");
  zv[0] = lds128<0>(a);
  if constexpr (RB == 8) zv[1] = lds128<16>(a);
}

// (value, index) order: the lower value, then the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

struct Shape {
  int n, B, D, K;
  int wy, wk, vpb, strip_k;
  bool vec;  // vector reads of W: 4 codes at once
};

// a bfloat16 value as its 16-bit word
using bf16 = uint16_t;

__device__ __forceinline__ float widen(float x) { return x; }
// exact: a bfloat16 is the high half of the float32 of the same value
__device__ __forceinline__ float widen(bf16 x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// Shared memory of a block, in floats: the z tile [vpb][D][tb + 4], the
// ring [STAGES][vpb][D][tk], |W_k|^2 of a ring tile [vpb][tk] and the merge
// buffer [vpb][wk][tb] of (value, index).
__host__ __device__ __forceinline__ int smem_floats(int D, int tb, int tk,
                                                    int wk, int vpb) {
  return vpb * (D * (tb + 4) + STAGES * D * tk + tk + 2 * wk * tb);
}

// Fills code tile [k0, k0 + tk) of rows [row0, row0 + rows) of W viewed as
// [n*D][K] into dst [rows][tk] (float32). Thread t takes 4 codes, column
// chunk t % (tk/4), of every (threads / (tk/4))-th row; rows past n*D and
// codes past K are zero-filled. The copies are cp.async, in flight until
// the caller waits for their group.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* w,
                                          const Shape& s, int row0, int rows,
                                          int k0, int tk, int threads) {
  const int cpr = tk / 4;
  const int c = (threadIdx.x % cpr) * 4;
  const int step = threads / cpr;
  const int k = k0 + c;
  const int nrows = s.n * s.D;
  for (int r = threadIdx.x / cpr; r < rows; r += step) {
    const int gr = row0 + r;
    const T* src = w + (size_t)gr * s.K + k;
    float* d = dst + r * tk + c;
    if (s.vec) {
      const bool valid = gr < nrows && k < s.K;
      cp_async16(d, valid ? src : w, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = gr < nrows && k + j < s.K;
        cp_async4(d + j, valid ? src + j : w, valid);
      }
    }
  }
}

// grid (sample tiles, variable groups, strips); block 32*wy*wk*vpb threads.
// The d loops run to DPAD, and stop at s.D unless EXACT (DPAD == s.D).
// SUB > 1 (a strip of two ring tiles of SUB sub-tiles or more, so a lane
// walks 8 groups or more) takes the grouped minimum; SUB = 1 (few codes,
// where a group's resolution would cost what it saves) compares and selects
// every score, with |W_k|^2 in the d loop.
template <typename T, int DPAD, bool EXACT, int RB, int SUB>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
vq_argmin_kernel(const T* __restrict__ z, const T* __restrict__ w,
                 int32_t* __restrict__ out, float* __restrict__ part_v,
                 int32_t* __restrict__ part_i, Shape s) {
  static_assert(RK == 4, "the grouped minimum takes 4 codes");
  constexpr bool GROUPED = SUB > 1;
  extern __shared__ float4 smem4[];
  const int tb = s.wy * ROWS * RB;
  const int tbp = tb + 4;
  const int tks = s.wk * TX * RK;                  // codes a sub-tile
  const int tk = tks * SUB;                        // codes a ring tile
  const int threads = 32 * s.wy * s.wk * s.vpb;
  float* zs = reinterpret_cast<float*>(smem4);     // [vpb][D][tbp]
  float* ring = zs + s.vpb * s.D * tbp;            // [STAGES][vpb][D][tk]
  const int ring_stride = s.vpb * s.D * tk;
  float* w2s = ring + STAGES * ring_stride;        // [vpb][tk]
  float* red_v = w2s + s.vpb * tk;                 // [vpb][wk][tb]
  int* red_i = reinterpret_cast<int*>(red_v + s.vpb * s.wk * tb);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = lane % TX;
  const int wk = warp % s.wk;
  const int wy = (warp / s.wk) % s.wy;
  const int vb = warp / (s.wk * s.wy);
  const int row = wy * ROWS + lane / TX;           // sample row in the tile
  const int b0 = blockIdx.x * tb;
  const int v0 = blockIdx.y * s.vpb;
  const int ks = blockIdx.z * s.strip_k;
  const int ke = min(ks + s.strip_k, s.K);
  const int ntiles = (ke - ks + tk - 1) / tk;
  const int rows = s.vpb * s.D;
  const float inf = __int_as_float(0x7f800000);

  // tile 0 in flight while the z tile is staged
  load_tile(ring, w, s, v0 * s.D, rows, ks, tk, threads);
  cp_async_commit();

  // the z tile, transposed; samples past B and variables past n are zero.
  // i / D in float: exact here, as i < tb*D <= 2^14 and 1/D errs by 2^-24
  const float inv_d = 1.0f / s.D;
  for (int vv = 0; vv < s.vpb; ++vv) {
    const int v = v0 + vv;
    const T* zv = z + ((size_t)v * s.B + b0) * s.D;
    for (int i = threadIdx.x; i < tb * s.D; i += threads) {
      const int bb = (int)((i + 0.5f) * inv_d);
      const int d = i - bb * s.D;
      zs[(vv * s.D + d) * tbp + bb] =
          (v < s.n && b0 + bb < s.B) ? widen(zv[i]) : 0.0f;
    }
  }

  // a sample's running minimum, and its code or (GROUPED) the first code of
  // the group that holds it; NO_CODE while none is below +inf
  float best[RB];
  int best_k[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    best[r] = inf;
    best_k[r] = NO_CODE;
  }
  const unsigned za0 = smem_addr(zs + vb * s.D * tbp + row * RB);
  const int col = (wk * TX + tx) * RK;             // first code in the tile

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t is in; every thread is done with tile t - 1
    const int k0 = ks + t * tk;
    if (t + 1 < ntiles) {      // tile t + 1 loads while tile t is scored
      load_tile(ring + ((t + 1) % STAGES) * ring_stride, w, s, v0 * s.D,
                rows, k0 + tk, tk, threads);
    }
    cp_async_commit();
    const float* tile = ring + (t % STAGES) * ring_stride;
    if constexpr (GROUPED) {
      // |W_k|^2 of the tile's codes, the in-order fmaf chain; +inf past
      // the strip's end
      for (int j = threadIdx.x; j < s.vpb * tk; j += threads) {
        const int vv = j / tk;
        const int c = j - vv * tk;
        const float* wc = tile + vv * s.D * tk + c;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < DPAD; ++d) {
          if (!EXACT && d == s.D) break;
          acc = fmaf(wc[d * tk], wc[d * tk], acc);
        }
        w2s[j] = k0 + c < ke ? acc : inf;
      }
      __syncthreads();
    }

    // the d loop reads row d + 1 before it scores row d, so shared-memory
    // latency hides behind the FMAs. Row D, read and unused at the end of
    // a padded instance's loop, is still inside the block's shared memory:
    // the next variable's rows, the ring after the z tile, the |W_k|^2
    // table after the ring.
#pragma unroll 1  // one copy of the d loop: four would overflow the
    for (int u = 0; u < SUB; ++u) {  // instruction cache
      const float* wp = tile + vb * s.D * tk + u * tks + col;
      unsigned za = za0;
      float4 wv = *reinterpret_cast<const float4*>(wp);
      float4 zv[RB / 4];
      load_z<RB>(zv, za);
      float acc[RB][RK];
      float w2[RK];
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        w2[c] = 0.0f;
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r][c] = 0.0f;
      }
#pragma unroll
      for (int d = 0; d < DPAD; ++d) {
        if (!EXACT && d == s.D) break;
        const float wc[RK] = {wv.x, wv.y, wv.z, wv.w};
        float zr[RB];
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          zr[4 * q] = zv[q].x;
          zr[4 * q + 1] = zv[q].y;
          zr[4 * q + 2] = zv[q].z;
          zr[4 * q + 3] = zv[q].w;
        }
        if (!EXACT || d + 1 < DPAD) {
          wp += tk;
          za += 4 * tbp;
          wv = *reinterpret_cast<const float4*>(wp);
          load_z<RB>(zv, za);
        }
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          if constexpr (!GROUPED) w2[c] = fmaf(wc[c], wc[c], w2[c]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            acc[r][c] = fmaf(zr[r], wc[c], acc[r][c]);
          }
        }
      }
      const int kc = k0 + u * tks + col;
      if constexpr (GROUPED) {
        // the minimum of the pass's RK scores, kept with the pass's first
        // code on a strict <
        const float4 h = *reinterpret_cast<const float4*>(
            w2s + vb * tk + u * tks + col);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float m = fminf(fminf(fmaf(-2.0f, acc[r][0], h.x),
                                      fmaf(-2.0f, acc[r][1], h.y)),
                                fminf(fmaf(-2.0f, acc[r][2], h.z),
                                      fmaf(-2.0f, acc[r][3], h.w)));
          if (m < best[r]) {
            best[r] = m;
            best_k[r] = kc;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          if (kc + c < ke) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float sc = fmaf(-2.0f, acc[r][c], w2[c]);
              if (sc < best[r]) {
                best[r] = sc;
                best_k[r] = kc + c;
              }
            }
          }
        }
      }
    }
  }

  // merge a sample's (minimum, code or group) over the TX code lanes of the
  // warp, then over the WK warps in shared memory, by (value, then lowest
  // index): groups are disjoint runs of RK codes, so of two equal minima
  // the lower group holds the lower code
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int off = TX >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[r], off);
      if (better(ov, ok, best[r], best_k[r])) {
        best[r] = ov;
        best_k[r] = ok;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int o = (vb * s.wk + wk) * tb + row * RB + r;
      red_v[o] = best[r];
      red_i[o] = best_k[r];
    }
  }
  __syncthreads();
  if (tx == 0 && wk == 0 && s.wk > 1) {
    for (int j = 1; j < s.wk; ++j) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int o = (vb * s.wk + j) * tb + row * RB + r;
        if (better(red_v[o], red_i[o], best[r], best_k[r])) {
          best[r] = red_v[o];
          best_k[r] = red_i[o];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int o = vb * s.wk * tb + row * RB + r;
      red_v[o] = best[r];
      red_i[o] = best_k[r];
    }
  }
  __syncthreads();

  // each sample's result, one sample a thread. GROUPED: the lowest code of
  // the group whose score, by the same chains from the z tile and W, is the
  // minimum; W from the ring where the group's tile is one of the last
  // STAGES (still there), else from device memory
  for (int i = threadIdx.x; i < s.vpb * tb; i += threads) {
    const int vv = i / tb;
    const int bb = i - vv * tb;
    const int v = v0 + vv;
    const int b = b0 + bb;
    if (v >= s.n || b >= s.B) continue;
    const int o_red = vv * s.wk * tb + bb;
    float bv = red_v[o_red];
    int bk = red_i[o_red];
    if (GROUPED && bk != NO_CODE) {
      const int kc = bk;
      const float* zr = zs + vv * s.D * tbp + bb;
      const T* wr = w + (size_t)v * s.D * s.K + kc;
      const int tw = (kc - ks) / tk;               // the group's ring tile
      const bool in_ring = tw + STAGES >= ntiles;
      const float* rr = ring + (tw % STAGES) * ring_stride + vv * s.D * tk
                        + (kc - ks - tw * tk);
      float a[RK], h[RK];
#pragma unroll
      for (int c = 0; c < RK; ++c) a[c] = h[c] = 0.0f;
      // RD rows' loads at a time; rows past D add exact zeros (a and h
      // start at +0 and are never -0)
      constexpr int RD = DPAD < 10 ? DPAD : 10;
      for (int d0 = 0; d0 < s.D; d0 += RD) {
        float zd[RD], x[RD][RK];
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          const int d = d0 + j;
          zd[j] = d < s.D ? zr[d * tbp] : 0.0f;
#pragma unroll
          for (int c = 0; c < RK; ++c) {
            x[j][c] = !(d < s.D && kc + c < ke) ? 0.0f
                      : in_ring ? rr[d * tk + c]
                                : widen(wr[(size_t)d * s.K + c]);
          }
        }
#pragma unroll
        for (int j = 0; j < RD; ++j) {
#pragma unroll
          for (int c = 0; c < RK; ++c) {
            a[c] = fmaf(zd[j], x[j][c], a[c]);
            h[c] = fmaf(x[j][c], x[j][c], h[c]);
          }
        }
      }
      bv = inf;
      bk = NO_CODE;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        const float sc = fmaf(-2.0f, a[c], h[c]);
        if (kc + c < ke && sc < bv) {
          bv = sc;
          bk = kc + c;
        }
      }
    }
    const size_t o = (size_t)v * s.B + b;
    if (gridDim.z == 1) {
      out[o] = bk == NO_CODE ? 0 : bk;
    } else {
      const size_t p = (size_t)blockIdx.z * s.n * s.B + o;
      part_v[p] = bv;
      part_i[p] = bk;
    }
  }
}

// out[i] = the strips' (min, index) merged in strip order, strict <
__global__ void vq_merge_kernel(const float* __restrict__ part_v,
                                const int32_t* __restrict__ part_i,
                                int32_t* __restrict__ out, int64_t nb,
                                int strips) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  float best = __int_as_float(0x7f800000);
  int best_k = NO_CODE;
  for (int p = 0; p < strips; ++p) {
    const float v = part_v[p * nb + i];
    const int k = part_i[p * nb + i];
    if (better(v, k, best, best_k)) {
      best = v;
      best_k = k;
    }
  }
  out[i] = best_k == NO_CODE ? 0 : best_k;
}

// ---- the bfloat16 instance: mma.sync on the tensor cores ----

constexpr int BF_STAGES = 2;       // code tiles in the ring
constexpr int BF_PAD = 8;          // bf16 pad of a code-tile row
constexpr int BF_MAX_WARPS = MAX_THREADS / 32;

struct ShapeBf16 {
  int n, B, D, K;
  int wm, nt, strip_k;      // warps over rows, 8-code tiles a ring tile
  int zcopy, wcopy;         // bytes a copy of z and W: 16, 4 (cp.async), 2
};

// Shared memory of a block, in bytes: the z tile [tb * d] (bf16, rounded up
// to 16 bytes), the ring [BF_STAGES][dp][tk + 8] (bf16) and -|W_k|^2 / 2 of
// a tile [tk].
__host__ __device__ __forceinline__ int bf16_smem_bytes(int d, int dp, int tb,
                                                        int tk) {
  return (2 * tb * d + 15) / 16 * 16 + BF_STAGES * 2 * dp * (tk + BF_PAD)
         + 4 * tk;
}

// one cp.async of `bytes` (16: .cg, 4: .ca; the helpers take addresses
// only), zero-filled where !valid, or for 2 bytes a plain load and store
__device__ __forceinline__ void copy_one(bf16* dst, const bf16* src,
                                        bool valid, int bytes) {
  if (bytes == 16) {
    cp_async16(reinterpret_cast<float*>(dst),
               reinterpret_cast<const float*>(src), valid);
  } else if (bytes == 4) {
    cp_async4(reinterpret_cast<float*>(dst),
              reinterpret_cast<const float*>(src), valid);
  } else {
    *dst = valid ? *src : bf16(0);
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d = A (16 x 16, row) * B (16 x 8, col) + c, bf16 in, f32 accumulate;
// c apart from d, so that the first k-step reads -|W_k|^2 / 2 where it is
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, float c0, float c1,
                                         float c2, float c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// (value, index) order of the bf16 instance's accumulators: the higher
// value, then the lower index
__device__ __forceinline__ bool better_max(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Code tile [k0, k0 + tk) of a variable's W [D][K] into dst [D][tk + 8]:
// copies of s.wcopy bytes, a power of two of them a row, so a thread's row
// and column come by shifts; codes past K are zero-filled. cp.async copies
// are in flight until the caller waits for their group.
__device__ __forceinline__ void load_codes(bf16* dst, const bf16* wv,
                                           const ShapeBf16& s, int k0,
                                           int tk, int threads) {
  const int per = s.wcopy / 2;                  // values a copy
  const int cpr = tk / per;                     // copies a row: a power of 2
  const int sh = __ffs(cpr) - 1;
  for (int i = threadIdx.x; i < s.D * cpr; i += threads) {
    const int r = i >> sh;
    const int c = (i & (cpr - 1)) * per;
    const bool valid = k0 + c < s.K;   // copies hold whole codes (K % per)
    copy_one(dst + r * (tk + BF_PAD) + c,
             valid ? wv + (size_t)r * s.K + k0 + c : wv, valid, s.wcopy);
  }
}

// grid (sample tiles, variables, strips); block 32 * wm threads. Warp wm
// scores sample rows [wm * MT * 16, (wm + 1) * MT * 16) of the tile against
// every code of each ring tile.
template <int KS, int MT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
vq_argmin_bf16_kernel(const bf16* __restrict__ z, const bf16* __restrict__ w,
                      int32_t* __restrict__ out, float* __restrict__ part_v,
                      int32_t* __restrict__ part_i, ShapeBf16 s) {
  constexpr int DP = 16 * KS;
  extern __shared__ float4 smem4[];
  const int tb = s.wm * MT * 16;
  const int tk = 8 * s.nt;
  const int wld = tk + BF_PAD;
  const int threads = 32 * s.wm;
  bf16* zs = reinterpret_cast<bf16*>(smem4);              // [tb * D]
  bf16* ring = zs + (tb * s.D + 7) / 8 * 8;               // [STAGES][DP][wld]
  const int stage = DP * wld;
  float* w2s = reinterpret_cast<float*>(ring + BF_STAGES * stage);  // [tk]

  const int lane = threadIdx.x & 31;
  const int wm = threadIdx.x >> 5;
  const int g = lane >> 2;                   // fragment row (and row + 8)
  const int t4 = lane & 3;                   // fragment column pair
  const int v = blockIdx.y;
  const int b0 = blockIdx.x * tb;
  const int ks = blockIdx.z * s.strip_k;
  const int ke = min(ks + s.strip_k, s.K);
  const int ntiles = (ke - ks + tk - 1) / tk;
  const bf16* wv = w + (size_t)v * s.D * s.K;

  // the z tile, rows b0.. of the variable: one contiguous run of values
  // (rows past B are left as they are: a row's scores depend on its own
  // row only and are not written), and code tile 0, one group
  {
    const bf16* zv = z + ((size_t)v * s.B + b0) * s.D;
    const int per = s.zcopy / 2;
    const int count = min(tb, s.B - b0) * s.D;
    for (int i = threadIdx.x * per; i < count; i += threads * per) {
      copy_one(zs + i, zv + i, true, s.zcopy);
    }
  }
  load_codes(ring, wv, s, ks, tk, threads);
  cp_async_commit();
  // the ring's pad rows D..DP-1 are zero for the whole block
  for (int st = 0; st < BF_STAGES; ++st) {
    uint4* pad = reinterpret_cast<uint4*>(ring + st * stage + s.D * wld);
    for (int i = threadIdx.x; i < (DP - s.D) * wld / 8; i += threads) {
      pad[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float best[MT][2];
  int best_k[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    best[mi][0] = best[mi][1] = neg_inf();
    best_k[mi][0] = best_k[mi][1] = NO_CODE;
  }
  uint32_t a[MT][KS][4];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
      // A fragments for the whole block: register q holds row g (q even)
      // or g + 8 (q odd), columns c = kk * 16 + (q >> 1) * 8 + 2 t4 and
      // c + 1 in its low and high half; columns past D are zero
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bf16* zr =
                zs + (wm * MT * 16 + mi * 16 + (q & 1) * 8 + g) * s.D;
            const int c = kk * 16 + (q >> 1) * 8 + 2 * t4;
            const uint32_t lo = c < s.D ? zr[c] : 0u;
            const uint32_t hi = c + 1 < s.D ? zr[c + 1] : 0u;
            a[mi][kk][q] = lo | hi << 16;
          }
        }
      }
    }
    const int k0 = ks + t * tk;
    if (t + 1 < ntiles) {      // tile t + 1 loads while tile t is scored
      load_codes(ring + ((t + 1) & 1) * stage, wv, s, k0 + tk, tk, threads);
    }
    cp_async_commit();
    const bf16* tile = ring + (t & 1) * stage;
    // -|W_k|^2 / 2 by the float32 instance's in-order fmaf chain; -inf past
    // the strip. The loads are unrolled ahead of the chain.
    for (int j = threadIdx.x; j < tk; j += threads) {
      float x[DP];
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        x[d] = d < s.D ? widen(tile[d * wld + j]) : 0.0f;
      }
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        if (d < s.D) acc = fmaf(x[d], x[d], acc);
      }
      w2s[j] = k0 + j < ke ? -0.5f * acc : neg_inf();
    }
    __syncthreads();

    // the tile's 16-code groups that start before the strip's end (one
    // group's registers at a time: two would lower the blocks an SM)
    const int c_end = min(tk, ke - k0);
#pragma unroll 1
    for (int c0 = 0; c0 < c_end; c0 += 16) {
      // C = -|W_k|^2 / 2 of this thread's columns 2 t4, 2 t4 + 1 of the two
      // 8-code tiles, for both of its rows
      const float2 h0 = *reinterpret_cast<const float2*>(w2s + c0 + 2 * t4);
      const float2 h1 =
          *reinterpret_cast<const float2*>(w2s + c0 + 8 + 2 * t4);
      float acc[MT][2][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];     // k rows 0-7, 8-15 of codes c0..+7, c0+8..+15
        ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 15)) * wld + c0
                                 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float(&d0)[4] = acc[mi][0];
          float(&d1)[4] = acc[mi][1];
          if (kk == 0) {
            mma_bf16(d0, a[mi][kk], b[0], b[1], h0.x, h0.y, h0.x, h0.y);
            mma_bf16(d1, a[mi][kk], b[2], b[3], h1.x, h1.y, h1.x, h1.y);
          } else {
            mma_bf16(d0, a[mi][kk], b[0], b[1], d0[0], d0[1], d0[2], d0[3]);
            mma_bf16(d1, a[mi][kk], b[2], b[3], d1[0], d1[1], d1[2], d1[3]);
          }
        }
      }
      // strict > while this thread's columns walk upward: the lowest index
      // keeps a tie
      const int kc = k0 + c0 + 2 * t4;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q >> 1;
            if (acc[mi][ni][q] > best[mi][r]) {
              best[mi][r] = acc[mi][ni][q];
              best_k[mi][r] = kc + ni * 8 + (q & 1);
            }
          }
        }
      }
    }
  }

  // over the quad (the 4 lanes of a row)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[mi][r], off);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[mi][r], off);
        if (better_max(ov, ok, best[mi][r], best_k[mi][r])) {
          best[mi][r] = ov;
          best_k[mi][r] = ok;
        }
      }
    }
  }
  if (t4 != 0) return;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = b0 + wm * MT * 16 + mi * 16 + r * 8 + g;
      if (b >= s.B) continue;
      const size_t o = (size_t)v * s.B + b;
      if (gridDim.z == 1) {
        out[o] = best_k[mi][r] == NO_CODE ? 0 : best_k[mi][r];
      } else {   // s / 2 = -acc: the merge launch orders by (min, index)
        const size_t pi = (size_t)blockIdx.z * s.n * s.B + o;
        part_v[pi] = -best[mi][r];
        part_i[pi] = best_k[mi][r];
      }
    }
  }
}

template <int KS, int MT>
cudaError_t launch_bf16(const bf16* z, const bf16* w, int32_t* out,
                        float* part_v, int32_t* part_i, const ShapeBf16& s,
                        int strips, cudaStream_t stream) {
  const int tb = s.wm * MT * 16;
  const dim3 grid((s.B + tb - 1) / tb, s.n, strips);
  const size_t smem = bf16_smem_bytes(s.D, 16 * KS, tb, 8 * s.nt);
  vq_argmin_bf16_kernel<KS, MT>
      <<<grid, 32 * s.wm, smem, stream>>>(z, w, out, part_v, part_i, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || strips == 1) return err;
  const int64_t nb = (int64_t)s.n * s.B;
  vq_merge_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, stream>>>(
      part_v, part_i, out, nb, strips);
  return cudaGetLastError();
}

template <typename T, int DPAD, bool EXACT, int RB, int SUB>
cudaError_t launch(const T* z, const T* w, int32_t* out,
                   float* part_v, int32_t* part_i, const Shape& s,
                   int strips, cudaStream_t stream) {
  const int tb = s.wy * ROWS * RB;
  const dim3 grid((s.B + tb - 1) / tb, (s.n + s.vpb - 1) / s.vpb, strips);
  const int threads = 32 * s.wy * s.wk * s.vpb;
  const size_t smem = sizeof(float) * smem_floats(s.D, tb,
                                                  s.wk * TX * RK * SUB,
                                                  s.wk, s.vpb);
  vq_argmin_kernel<T, DPAD, EXACT, RB, SUB>
      <<<grid, threads, smem, stream>>>(z, w, out, part_v, part_i, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || strips == 1) return err;
  const int64_t nb = (int64_t)s.n * s.B;
  vq_merge_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, stream>>>(
      part_v, part_i, out, nb, strips);
  return cudaGetLastError();
}

// D exactly where the registry trains it (10, 20, 30: `cuda_vq.EXACT_D`),
// else D rounded up to 8, 16, 24, 32, 48, 64, 96 or 128 (the unrolled d
// loop stops at D); RB = 8 and SUB = 4 only up to D = 32, past which their
// registers would spill
template <typename T, int RB, int SUB>
cudaError_t dispatch(const T* z, const T* w, int32_t* out,
                     float* part_v, int32_t* part_i, const Shape& s,
                     int strips, cudaStream_t st) {
#define VQ_LAUNCH(P, EXACT) \
  launch<T, P, EXACT, RB, SUB>(z, w, out, part_v, part_i, s, strips, st)
  if (s.D == 10) return VQ_LAUNCH(10, true);
  if (s.D == 20) return VQ_LAUNCH(20, true);
  if (s.D == 30) return VQ_LAUNCH(30, true);
  if (s.D <= 8) return VQ_LAUNCH(8, false);
  if (s.D <= 16) return VQ_LAUNCH(16, false);
  if (s.D <= 24) return VQ_LAUNCH(24, false);
  if (s.D <= 32) return VQ_LAUNCH(32, false);
  if constexpr (RB == 4 && SUB == 1) {
    if (s.D <= 48) return VQ_LAUNCH(48, false);
    if (s.D <= 64) return VQ_LAUNCH(64, false);
    if (s.D <= 96) return VQ_LAUNCH(96, false);
    if (s.D <= 128) return VQ_LAUNCH(128, false);
  }
#undef VQ_LAUNCH
  return cudaErrorInvalidValue;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <typename T>
int run(const T* z, const T* w, int32_t* out, float* part_v, int32_t* part_i,
        int n, int B, int D, int K, int rb, int wy, int wk, int sub, int vpb,
        int strip_k, int strips, void* stream) {
  const int threads = 32 * wy * wk * vpb;
  const int tk = wk * TX * RK * sub;
  const int tb = wy * ROWS * rb;
  if (n < 1 || B < 1 || D < 1 || D > MAX_D || K < 1
      || !(rb == 4 || (rb == 8 && D <= 32))
      || !(sub == 1 || (sub == 4 && D <= 32)) || !pow2(wy) || !pow2(wk)
      || !pow2(vpb) || threads > MAX_THREADS || strip_k < tk
      || strip_k % tk != 0 || strips != (K + strip_k - 1) / strip_k
      || (strips > 1 && (part_v == nullptr || part_i == nullptr))
      || (n + vpb - 1) / vpb > 65535 || strips > 65535
      || 4L * smem_floats(D, tb, tk, wk, vpb) > SMEM_BYTES) {
    return (int)cudaErrorInvalidValue;
  }
  // vector reads of 4 codes: 16 bytes of float32, 8 of bfloat16
  const Shape s{n, B, D, K, wy, wk, vpb, strip_k,
                K % 4 == 0
                    && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rb == 4) {
    err = sub == 1
              ? dispatch<T, 4, 1>(z, w, out, part_v, part_i, s, strips, st)
              : dispatch<T, 4, 4>(z, w, out, part_v, part_i, s, strips, st);
  } else {
    err = sub == 1
              ? dispatch<T, 8, 1>(z, w, out, part_v, part_i, s, strips, st)
              : dispatch<T, 8, 4>(z, w, out, part_v, part_i, s, strips, st);
  }
  return (int)err;
}

// the widest copy (bytes) that runs of `values` bf16 values from p allow
int copy_bytes(const bf16* p, long long values) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (values % 8 == 0 && a % 16 == 0) return 16;
  if (values % 2 == 0 && a % 4 == 0) return 4;
  return 2;
}

// KS = 16-deep k-steps (D padded to 16, 32, 64 or 128), MT = 16-row tiles a
// warp (1, or 2 up to D = 64)
int run_bf16(const bf16* z, const bf16* w, int32_t* out, float* part_v,
             int32_t* part_i, int n, int B, int D, int K, int mt, int wm,
             int wn, int nt, int vpb, int strip_k, int strips, void* stream) {
  const int ks = D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8;
  const int tb = wm * mt * 16;
  const int tk = 8 * nt;
  if (n < 1 || B < 1 || D < 1 || D > MAX_D || K < 1
      || !(mt == 1 || (mt == 2 && ks <= 4)) || !pow2(wm)
      || wm > BF_MAX_WARPS || !pow2(nt) || nt < 2 || wn != 1 || vpb != 1
      || strip_k < tk || strip_k % tk != 0
      || strips != (K + strip_k - 1) / strip_k
      || (strips > 1 && (part_v == nullptr || part_i == nullptr))
      || n > 65535 || strips > 65535
      || bf16_smem_bytes(D, 16 * ks, tb, tk) > SMEM_BYTES) {
    return (int)cudaErrorInvalidValue;
  }
  // a block copies z in one run from (v * B + b0) * D (b0 a multiple of
  // 16) and W in rows from (v * D + d) * K + k0 (k0 a multiple of 16)
  const ShapeBf16 s{n, B, D, K, wm, nt, strip_k,
                    copy_bytes(z, (long long)B * D), copy_bytes(w, K)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define VQ_BF16(KS, MT) \
  launch_bf16<KS, MT>(z, w, out, part_v, part_i, s, strips, st)
  if (mt == 1) {
    err = ks == 1 ? VQ_BF16(1, 1) : ks == 2 ? VQ_BF16(2, 1)
          : ks == 4 ? VQ_BF16(4, 1) : VQ_BF16(8, 1);
  } else {
    err = ks == 1 ? VQ_BF16(1, 2) : ks == 2 ? VQ_BF16(2, 2) : VQ_BF16(4, 2);
  }
#undef VQ_BF16
  return (int)err;
}

}  // namespace

// Launches the search for z [n, B, D] and W [n, D, K] on `stream` of the
// current CUDA device: `vq_argmin` (float32) with the launch plan (rb, wy,
// wk, sub, vpb, strip_k, strips) of `cuda_vq.plan`, `vq_argmin_bf16`
// (bfloat16, as their 16-bit words) with `cuda_vq.plan_bf16`'s (mt, wm, wn,
// nt, 1, strip_k, strips) in the same places. With strips > 1, part_v and
// part_i hold strips * n * B floats and ints of scratch, and a second launch
// merges them. Returns the launch's cudaError_t (0 on success); a plan the
// kernel does not take returns cudaErrorInvalidValue and launches nothing. It
// does not synchronise.
extern "C" int vq_argmin(const float* z, const float* w, int32_t* out,
                         float* part_v, int32_t* part_i, int n, int B, int D,
                         int K, int rb, int wy, int wk, int sub, int vpb,
                         int strip_k, int strips, void* stream) {
  return run(z, w, out, part_v, part_i, n, B, D, K, rb, wy, wk, sub, vpb,
             strip_k, strips, stream);
}

extern "C" int vq_argmin_bf16(const bf16* z, const bf16* w, int32_t* out,
                              float* part_v, int32_t* part_i, int n, int B,
                              int D, int K, int mt, int wm, int wn, int nt,
                              int vpb, int strip_k, int strips,
                              void* stream) {
  return run_bf16(z, w, out, part_v, part_i, n, B, D, K, mt, wm, wn, nt, vpb,
                  strip_k, strips, stream);
}

extern "C" const char* vq_argmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
