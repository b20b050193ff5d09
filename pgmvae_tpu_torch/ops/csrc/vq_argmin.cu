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
// index, as with jnp.argmin. The [n, B, K] score tensor is never built. Each
// score is a = fmaf chain of z[d]*W[d,k] over d = 0..D-1 in order, |W_k|^2 =
// fmaf chain of W[d,k]^2 in the same order, s = |W_k|^2 - 2a: fp32 FMAs on
// the SIMT units, as TF32 tensor-core products would round z and W to 10
// mantissa bits and move codes.
//
// What bounds it. 2*n*B*D*K fp32 flops against 4*n*(B*D + D*K + B) bytes
// (each input read once, the output written once). On an H100 (67 TFLOP/s
// fp32 outside the tensor cores, 3.35 TB/s) the ridge is 20 flops a byte:
// stage-2 chunks (B=32, D=20, K=50) sit near 10 and are bound by bytes;
// large codebooks (B=256, K=4096) near 120 and are bound by the FMA rate.
// Either way the card has to be full: many variables with few codes (bbc)
// and few variables with many codes (the kdd sweep, n=64, K=4096) both.
//
// Design (the launch is planned in Python, `cuda_vq.plan`, and checked
// here). A design of one thread per sample over all K codes gets no
// parallelism from K: at the kdd sweep's (64, 32, 10, 4096) it runs 64
// one-warp blocks on 132 SMs. So:
// - Register micro-tiles. Each thread scores RB (4 or 8) samples x RK = 4
//   codes: per d one 16-byte shared-memory read of its 4 codes, RB/4 reads
//   of its samples and RB*4 FMAs, and its codes' |W_k|^2 chains in the same
//   d loop (1/RB more FMAs, no barrier). A warp is TX = 4 code lanes x 8
//   sample rows, so its reads touch 64 bytes of codes and 128-256 bytes of
//   samples, one or two shared-memory wavefronts for 20-36 FMAs.
// - The d loop reads row d + 1 before it scores row d. Unrolled to DPAD (D
//   rounded up) with an exit at D, each step's loads would otherwise sit
//   behind that exit branch and wait out their latency.
// - K adds parallelism inside the block: WK warps split a code sub-tile of
//   WK*16 codes, WY warps split the samples. The z tile [TB = WY*8*RB][D]
//   is staged once, transposed to [D][TB + 4] (the pad spreads the
//   transposing stores over the banks; unpadded they were 32-way bank
//   conflicts, slower than the scoring at K = 50). Codebook tiles of SUB
//   sub-tiles, [D][SUB*WK*16], stream through a ring of STAGES buffers
//   filled with cp.async (16 bytes .cg where K is a multiple of 4 and W is
//   16-byte aligned, else 4 bytes .ca; zero-fill past K), so the next tile
//   loads while this one is scored. SUB = 4 where a strip holds enough codes
//   spreads the ring's wait and two barriers over four sub-tiles.
// - Each thread keeps a running (min, index) per sample, replaced only on a
//   strict < while its codes walk upward. The merge of a sample's minima,
//   over the TX lanes by warp shuffles and then over the WK warps through
//   shared memory, orders by (value, then index), so the lowest index wins
//   every tie.
// - Small grids split K. When n * ceil(B/TB) gives fewer than two blocks an
//   SM (kdd: 64), the codes are cut into strips of whole tiles, one block
//   each (grid.z); each block writes its strip's (min, index) to a partial
//   [strips, n, B], and a second launch merges the strips in order with
//   strict <. The result does not depend on block order.
// - Small K packs variables. Where K fits two sub-tiles and a block would
//   be under 128 threads, VPB variables share a block (bbc's stage-2 chunk:
//   two).
// - bfloat16 inputs (`vq_argmin_bf16`, the Pallas kernel's f32-accumulated
//   dot on bf16 operands under bf16 compute). Each value is widened to
//   float32 on its way into shared memory: the widening is exact and a
//   product of two widened values is exact in float32, so the shared-memory
//   tiles, the scoring, the tie order, the strips and the merge are those of
//   the float32 instance, and `cuda_vq.plan`'s shared-memory arithmetic holds
//   as it is. Only the global reads halve: a thread reads its 4 codes as one
//   8-byte load (K a multiple of 4, W 8-byte aligned; else 4 scalar loads)
//   and stores them widened. These are plain loads, not cp.async (which
//   copies bytes and cannot widen), so a bf16 code tile is loaded when its
//   ring slot is filled and its latency is not hidden behind the scoring.
// What still bounds it (H100, PERF.md): instruction slots and latency, not
// FMAs or bytes. A good share of a thread's instructions are not the scores'
// FMAs (|W_k|^2, the compare-and-select per score, loads, loop), and the
// barriers and tile waits of short blocks are not all hidden.

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
constexpr int BLOCKS_PER_SM = 3;   // for __launch_bounds__
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
// ring [STAGES][vpb][D][tk] and the merge buffer [vpb][wk][tb] of (value,
// index).
__host__ __device__ __forceinline__ int smem_floats(int D, int tb, int tk,
                                                    int wk, int vpb) {
  return vpb * (D * (tb + 4) + STAGES * D * tk + 2 * wk * tb);
}

// Fills code tile [k0, k0 + tk) of rows [row0, row0 + rows) of W viewed as
// [n*D][K] into dst [rows][tk] (float32). Thread t takes 4 codes, column
// chunk t % (tk/4), of every (threads / (tk/4))-th row; rows past n*D and
// codes past K are zero-filled. float32 W: cp.async copies, in flight until
// the caller waits for their group. bfloat16 W: loads widened and stored
// before it returns.
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
    if constexpr (sizeof(T) == 4) {
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
    } else {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s.vec) {
        if (gr < nrows && k < s.K) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
          f = make_float4(__uint_as_float(raw.x << 16),
                          __uint_as_float(raw.x & 0xffff0000u),
                          __uint_as_float(raw.y << 16),
                          __uint_as_float(raw.y & 0xffff0000u));
        }
      } else if (gr < nrows) {
        f.x = k < s.K ? widen(src[0]) : 0.0f;
        f.y = k + 1 < s.K ? widen(src[1]) : 0.0f;
        f.z = k + 2 < s.K ? widen(src[2]) : 0.0f;
        f.w = k + 3 < s.K ? widen(src[3]) : 0.0f;
      }
      *reinterpret_cast<float4*>(d) = f;
    }
  }
}

// grid (sample tiles, variable groups, strips); block 32*wy*wk*vpb threads
template <typename T, int DPAD, int RB, int SUB>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
vq_argmin_kernel(const T* __restrict__ z, const T* __restrict__ w,
                 int32_t* __restrict__ out, float* __restrict__ part_v,
                 int32_t* __restrict__ part_i, Shape s) {
  extern __shared__ float4 smem4[];
  const int tb = s.wy * ROWS * RB;
  const int tbp = tb + 4;
  const int tks = s.wk * TX * RK;                  // codes a sub-tile
  const int tk = tks * SUB;                        // codes a ring tile
  const int threads = 32 * s.wy * s.wk * s.vpb;
  float* zs = reinterpret_cast<float*>(smem4);     // [vpb][D][tbp]
  float* ring = zs + s.vpb * s.D * tbp;            // [STAGES][vpb][D][tk]
  const int ring_stride = s.vpb * s.D * tk;
  float* red_v = ring + STAGES * ring_stride;      // [vpb][wk][tb]
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

  // tiles 0 .. STAGES-2 in flight before the loop; one commit group each
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) {
      load_tile(ring + t * ring_stride, w, s, v0 * s.D, rows, ks + t * tk,
                tk, threads);
    }
    cp_async_commit();
  }

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

  float best[RB];
  int best_k[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_k[r] = NO_CODE;
  }
  const float* zp = zs + vb * s.D * tbp + row * RB;
  const int col = (wk * TX + tx) * RK;             // first code in the tile

  for (int t = 0; t < ntiles; ++t) {
    // tile t + STAGES - 1 into the buffer that tile t - 1 left; then wait
    // for tile t (groups stay one per tile, empty past the last)
    const int tn = t + STAGES - 1;
    if (tn < ntiles) {
      load_tile(ring + (tn % STAGES) * ring_stride, w, s, v0 * s.D, rows,
                ks + tn * tk, tk, threads);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const float* tile = ring + (t % STAGES) * ring_stride;
    // the d loop reads row d + 1 before it scores row d, so shared-memory
    // latency hides behind the FMAs. Row D, read and unused at the end, is
    // still inside the block's shared memory: the next variable's rows, the
    // ring after the z tile, the merge buffer after the ring.
#pragma unroll 1  // one copy of the d loop: four would overflow the
    for (int u = 0; u < SUB; ++u) {  // instruction cache
      const float* wp = tile + vb * s.D * tk + u * tks + col;
      const float* zq = zp;
      float4 wv = *reinterpret_cast<const float4*>(wp);
      float4 zv[RB / 4];
#pragma unroll
      for (int q = 0; q < RB / 4; ++q) {
        zv[q] = *reinterpret_cast<const float4*>(zq + 4 * q);
      }
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
        if (d == s.D) break;
        wp += tk;
        zq += tbp;
        const float4 wn = *reinterpret_cast<const float4*>(wp);
        float4 zn[RB / 4];
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          zn[q] = *reinterpret_cast<const float4*>(zq + 4 * q);
        }
        const float wc[RK] = {wv.x, wv.y, wv.z, wv.w};
        float zr[RB];
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          zr[4 * q] = zv[q].x;
          zr[4 * q + 1] = zv[q].y;
          zr[4 * q + 2] = zv[q].z;
          zr[4 * q + 3] = zv[q].w;
        }
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          w2[c] = fmaf(wc[c], wc[c], w2[c]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            acc[r][c] = fmaf(zr[r], wc[c], acc[r][c]);
          }
        }
        wv = wn;
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) zv[q] = zn[q];
      }
      const int kc = ks + t * tk + u * tks + col;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        if (kc + c < ke) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float sc = w2[c] - 2.0f * acc[r][c];
            if (sc < best[r]) {
              best[r] = sc;
              best_k[r] = kc + c;
            }
          }
        }
      }
    }
    __syncthreads();  // this ring buffer is free to refill
  }

  // merge a sample's minima by (value, then lowest index): over the TX code
  // lanes of the warp, then over the WK warps in shared memory
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
  if (s.wk > 1) {
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int o = (vb * s.wk + wk) * tb + row * RB + r;
        red_v[o] = best[r];
        red_i[o] = best_k[r];
      }
    }
    __syncthreads();
    if (tx == 0 && wk == 0) {
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
    }
  }
  const int v = v0 + vb;
  if (tx != 0 || wk != 0 || v >= s.n) return;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int b = b0 + row * RB + r;
    if (b >= s.B) break;
    const size_t o = (size_t)v * s.B + b;
    if (gridDim.z == 1) {
      out[o] = best_k[r] == NO_CODE ? 0 : best_k[r];
    } else {
      const size_t p = (size_t)blockIdx.z * s.n * s.B + o;
      part_v[p] = best[r];
      part_i[p] = best_k[r];
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

template <typename T, int DPAD, int RB, int SUB>
cudaError_t launch(const T* z, const T* w, int32_t* out,
                   float* part_v, int32_t* part_i, const Shape& s,
                   int strips, cudaStream_t stream) {
  const int tb = s.wy * ROWS * RB;
  const dim3 grid((s.B + tb - 1) / tb, (s.n + s.vpb - 1) / s.vpb, strips);
  const int threads = 32 * s.wy * s.wk * s.vpb;
  const size_t smem = sizeof(float) * smem_floats(s.D, tb,
                                                  s.wk * TX * RK * SUB,
                                                  s.wk, s.vpb);
  vq_argmin_kernel<T, DPAD, RB, SUB>
      <<<grid, threads, smem, stream>>>(z, w, out, part_v, part_i, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || strips == 1) return err;
  const int64_t nb = (int64_t)s.n * s.B;
  vq_merge_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, stream>>>(
      part_v, part_i, out, nb, strips);
  return cudaGetLastError();
}

// D rounded up to 8, 16, 24, 32, 48, 64, 96 or 128 (the unrolled d loop
// stops at D); RB = 8 and SUB = 4 only up to D = 32, past which their
// registers would spill
template <typename T, int RB, int SUB>
cudaError_t dispatch(const T* z, const T* w, int32_t* out,
                     float* part_v, int32_t* part_i, const Shape& s,
                     int strips, cudaStream_t st) {
#define VQ_LAUNCH(P) \
  launch<T, P, RB, SUB>(z, w, out, part_v, part_i, s, strips, st)
  if (s.D <= 8) return VQ_LAUNCH(8);
  if (s.D <= 16) return VQ_LAUNCH(16);
  if (s.D <= 24) return VQ_LAUNCH(24);
  if (s.D <= 32) return VQ_LAUNCH(32);
  if constexpr (RB == 4 && SUB == 1) {
    if (s.D <= 48) return VQ_LAUNCH(48);
    if (s.D <= 64) return VQ_LAUNCH(64);
    if (s.D <= 96) return VQ_LAUNCH(96);
    if (s.D <= 128) return VQ_LAUNCH(128);
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

}  // namespace

// Launches the search for z [n, B, D] and W [n, D, K] with the launch plan
// (rb, wy, wk, sub, vpb, strip_k, strips) of `cuda_vq.plan` on `stream` of the
// current CUDA device. With strips > 1, part_v and part_i hold
// strips * n * B floats and ints of scratch, and a second launch merges
// them. Returns the launch's cudaError_t (0 on success); a plan the kernel
// does not take returns cudaErrorInvalidValue and launches nothing. It does
// not synchronise. `vq_argmin` takes float32 z and W, `vq_argmin_bf16`
// bfloat16 ones (as their 16-bit words); the plan is the same for both.
extern "C" int vq_argmin(const float* z, const float* w, int32_t* out,
                         float* part_v, int32_t* part_i, int n, int B, int D,
                         int K, int rb, int wy, int wk, int sub, int vpb,
                         int strip_k, int strips, void* stream) {
  return run(z, w, out, part_v, part_i, n, B, D, K, rb, wy, wk, sub, vpb,
             strip_k, strips, stream);
}

extern "C" int vq_argmin_bf16(const bf16* z, const bf16* w, int32_t* out,
                              float* part_v, int32_t* part_i, int n, int B,
                              int D, int K, int rb, int wy, int wk, int sub,
                              int vpb, int strip_k, int strips,
                              void* stream) {
  return run(z, w, out, part_v, part_i, n, B, D, K, rb, wy, wk, sub, vpb,
             strip_k, strips, stream);
}

extern "C" const char* vq_argmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
