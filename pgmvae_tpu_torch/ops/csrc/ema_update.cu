// The EMA codebook step of a training step on Hopper (sm_90a), in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA
// (`code_stats` and `ema_update`, pgmvae_tpu/ops/quantizer.py), and the port
// ran it as about 25 PyTorch operations around a one-hot [n, B, K] (their
// plain version, `cuda_ema.ema_update_plain`). It was added because at the
// packed kdd sweep's shape (n 256, B 32, D 10, K 4096) those operations
// stream a 134 MB one-hot three times, the [n, D, K] state six to eight
// times and copy the new state back: half of a step's device time.
//
// What it computes. For the codes indices [n, B] int32 of z [n, B, D]
// float32 (weights w [B] float32, or 1 where w is null) and one network's
// state counts [n, K], dw [n, D, K], codebook [n, D, K], all in place:
//   bc[k]     = sum_b w_b [idx_b = k]                (batch counts, written)
//   bdw[d, k] = sum_b (z[b, d] * w_b) [idx_b = k]
//   c'        = c * decay + bc * (1 - decay)
//   dw'       = dw * decay + bdw * (1 - decay)
//   t[k]      = c'[k] / bias          (bias = 1 - decay^step, from device
//   ew        = dw' / bias             memory; both divisions left out
//                                      where bias is null: no debias)
//   n         = sum_k t[k]
//   s[k]      = (t[k] + eps) / (n + K * eps) * n
//   codebook  = ew / s[k]
// in the plain version's order, each product, sum and quotient rounded on
// its own (__fmul_rn, __fadd_rn, __fdiv_rn; the library is also built with
// -fmad=false), with the plain version's float32 constants (decay, 1 -
// decay, eps and K * eps rounded from double by the caller). The result
// then differs from the plain version's only through the order of two sums:
// bdw over the rows that share a code (here in row order) and n over K
// (here a fixed tree). The batch counts of 0/1 weights are exact, so they
// and c' are bit-equal to the plain version's.
//
// What bounds it. Per network it must read dw and the counts and write dw,
// the codebook and the counts, 4 * (3DK + 2K) bytes (and the batch counts,
// 4K more), for about 10 float operations a dw element, two of them
// divisions. It is bound by bytes: 40 us at 3.35 TB/s at the packed kdd
// shape. The batch touches at most B of the K codes, so its statistics are
// a few hundred values: the one-hot and the dense bdw need never exist.
//
// Design. One block per network (n = 256 at packed kdd, 1058 at bbc),
// planned in Python (`cuda_ema.plan`: threads a block, rows a tile, the hash
// table's size, codes a chunk, where the tables live) and checked here.
// Nothing a block keeps grows with K but the chunk, which the plan fits to
// the shared memory, so the kernel takes any K.
// - The prologue. Every block starts at once and none streams until it has
//   n, so the state's first loads (a thread's first CU counts and UNROLL
//   float4 groups of dw) are issued first, before the batch statistics, and
//   wait in registers.
// - The batch statistics. The block walks its network's B rows in tiles of
//   TILE = 32, staged in shared memory (codes, weights, z). In each tile a
//   warp matches the rows' codes (__match_any_sync: each row's peer mask),
//   the first row of each code finds or takes the code's slot: in a dense
//   [K] map where one chunk holds all of K and the tables fit in shared
//   memory (every main path's shape), else in an open-addressing hash of the
//   hit codes (2^hbits >= 4 min(B, K) entries, linear probing, each slot
//   noting its code); slots in order of arrival (a slot only stores, so the
//   order does not touch any value). Then one thread for each (that row, d)
//   and one for its count add the code's rows of the tile into the slot by
//   walking the mask upward, after the earlier tiles' rows: every sum is the
//   rows' sum in row order. The hash and the slots' statistics (the tables)
//   live in shared memory, or in a scratch buffer in device memory where the
//   plan finds them too large (a batch past a few thousand distinct codes).
// - The counts pass over K: c' (a code's slot from the first chunk's dense
//   map in shared memory, under the hash scattered from the slots' codes;
//   past that chunk, from the hash), the batch counts, t = c' / bias (kept
//   for the first chunk) and each thread's share of n, summed by a fixed
//   tree.
// - The streaming pass over the network's D * K elements of dw, a chunk of
//   kc codes at a time (kc = K wherever K fits, every main path's shape):
//   the chunk's smoothed counts s[k] (a later chunk's t from the counts just
//   written: the same operations, so the same values) and its codes' slots
//   go to shared memory first. Then the chunk's elements, flat, in float4
//   groups where D * K % 4 == 0 and the pointers are 16-byte aligned (groups
//   that may cross a row only where one chunk holds all of K; else one value
//   at a time), UNROLL groups a thread a round, software pipelined: a thread
//   issues the loads of its next round before it computes and stores this
//   one, so its loads are in flight while it computes (UNROLL 2 keeps the
//   kernel within 64 registers unspilled). The row d and code k of a group
//   come from one division; where K % 4 == 0 a group lies in one row and its
//   four codes' slots and smoothed counts are one 16-byte shared-memory read
//   each. A code with a slot adds its bdw, any other adds 0 (as the plain
//   version's dense bdw does). dw is read and written with the evict-first
//   hint: L2 keeps the step's other data, the codebook among it.
// - dw, the codebook and the counts are written where they are: the caller
//   keeps its state tensors and copies nothing back. Each element is read
//   and written by one thread, and a network by one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int UNROLL = 2;            // float4 groups a thread holds a round
constexpr int CU = 8;                // counts a thread loads at once
constexpr int TILE = 32;             // batch rows a tile: one warp's match
constexpr int NONE = -1;             // no slot; an empty hash entry
constexpr int MAX_SMEM = 232448;     // H100: 227 KB a block, opted in

struct Args {
  const int32_t* idx;      // [n, B]
  const float* z;          // [n, B, D]
  const float* w;          // [B], or null: weight 1
  const float* bias;       // 0-dim, or null: no debias
  float* counts;           // [n, K], in place
  float* dw;               // [n, D, K], in place
  float* codebook;         // [n, D, K], written
  float* batch_counts;     // [n, K], written
  int* tables;             // [n, table_words], or null: in shared memory
  int B, D, K, tb, slots, hbits, kc;
  float decay, omd, eps, keps;   // omd = 1 - decay, keps = K * eps
  int vec;                 // 0: one value at a time; 1: float4 groups over
                           // the rows (kc == K); 2: float4 groups inside a
                           // row (K % 4 == 0)
};

// a network's tables, in 4-byte words (`cuda_ema._table_words`): the hash's
// keys and slots [2^hbits] each, the slots' codes, counts and z-sums
// [slots * (D + 2)]
__host__ __device__ inline long long table_words(int D, int slots,
                                                 int hbits) {
  return 2LL * (1LL << hbits) + (long long)slots * (D + 2);
}

// shared memory of a block, in 4-byte words (`cuda_ema._smem_bytes` / 4):
// a chunk's smoothed counts and slots [kc] each, the tile's codes, weights,
// slots, peer masks and z [tb * (D + 4)], the tree's 33 words and the slot
// counter, and the tables where they are not in device memory
__host__ __device__ inline long long smem_words(int D, int tb, int slots,
                                                int hbits, int kc,
                                                bool tables) {
  return 2LL * kc + (long long)tb * (D + 4) + 34
         + (tables ? table_words(D, slots, hbits) : 0);
}

__device__ __forceinline__ unsigned hash_of(int code, int hbits) {
  return ((unsigned)code * 0x9E3779B1u) >> (32 - hbits);
}

// the slot of `code` in the hash, or NONE
__device__ __forceinline__ int find_slot(const int* hkey, const int* hval,
                                         int code, int hbits) {
  const unsigned mask = (1u << hbits) - 1;
  for (unsigned h = hash_of(code, hbits);; h = (h + 1) & mask) {
    const int key = hkey[h];
    if (key == code) return hval[h];
    if (key == NONE) return NONE;
  }
}

// BIG: K in chunks or the tables in device memory. The instance without
// (every main path's shape) keeps the dense slot map, folds the chunk loop
// and the hash away and addresses its tables in shared memory, so it holds
// fewer registers: at bbc's 128 threads a block, the registers decide
// whether its 1,058 networks run in one wave or two.
template <bool BIG>
__global__ void __launch_bounds__(MAX_THREADS)
ema_update_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int B = a.B, D = a.D, K = a.K, tb = a.tb, kc = BIG ? a.kc : K;
  const int hbits = a.hbits, hsize = 1 << hbits;
  float* sc = smem;                                         // [kc]
  int* slotc = reinterpret_cast<int*>(sc + kc);             // [kc]
  int* tidx = slotc + kc;                                   // [tb]
  float* tw = reinterpret_cast<float*>(tidx + tb);          // [tb]
  int* tj = reinterpret_cast<int*>(tw + tb);                // [tb]
  unsigned* tmask = reinterpret_cast<unsigned*>(tj + tb);   // [tb]
  float* tz = reinterpret_cast<float*>(tmask + tb);         // [tb][D]
  float* red = tz + (size_t)tb * D;                         // [33]
  int* nslots = reinterpret_cast<int*>(red + 33);           // [1]

  const int v = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  int* hkey = !BIG || a.tables == nullptr
                  ? nslots + 1
                  : a.tables + (size_t)v * table_words(D, a.slots, hbits);
  int* hval = hkey + hsize;                                 // [hsize]
  int* scode = hval + hsize;                                // [slots]
  float* lead_c = reinterpret_cast<float*>(scode + a.slots);  // [slots]
  float* lead_w = lead_c + a.slots;                         // [slots][D]
  const size_t base = (size_t)v * D * K;
  float* counts = a.counts + (size_t)v * K;
  float* dw = a.dw + base;
  float4* dw4 = reinterpret_cast<float4*>(dw);
  // the float4 group i of chunk [k0, k0 + w) is element 4i of the chunk's
  // D x w elements flat: its float4 in dw is i where the chunk holds all
  // of K (vec 1: the group may run on into the next row), else that of its
  // row d and its code's place kk in the chunk
  auto float4_of = [&](int i, int k0, int w, int d, int kk) -> size_t {
    return !BIG || w == K ? (size_t)i : ((size_t)d * K + k0 + kk) >> 2;
  };
  auto float4_at = [&](int i, int k0, int w) -> size_t {
    const int e = 4 * i, d = !BIG || w == K ? 0 : e / w;
    return float4_of(i, k0, w, d, e - d * w);
  };

  // The state's first loads leave before the batch statistics: neither
  // depends on them, and every block is in this prologue at once.
  float cpre[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    const int k = tid + u * nt;
    cpre[u] = k < K ? counts[k] : 0.f;
  }
  const int w0 = BIG ? min(kc, K) : K;
  float4 xpre[UNROLL];
  if (a.vec) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = tid + u * nt;
      if (i < (D * w0) >> 2) xpre[u] = __ldcs(&dw4[float4_at(i, 0, w0)]);
    }
  }

  for (int kk = tid; kk < w0; kk += nt) slotc[kk] = NONE;
  if (BIG) {
    for (int h = tid; h < hsize; h += nt) hkey[h] = NONE;
  }
  for (int e = tid; e < a.slots * (D + 1); e += nt) lead_c[e] = 0.f;
  if (tid == 0) *nslots = 0;
  __syncthreads();

  // ---- the batch's statistics, tile by tile in row order
  const int32_t* idx = a.idx + (size_t)v * B;
  const float* z = a.z + (size_t)v * B * D;
  for (int b0 = 0; b0 < B; b0 += tb) {
    const int rows = min(tb, B - b0);
    for (int r = tid; r < rows; r += nt) {
      tidx[r] = idx[b0 + r];
      tw[r] = a.w == nullptr ? 1.f : a.w[b0 + r];
    }
    for (int e = tid; e < rows * D; e += nt) tz[e] = z[(size_t)b0 * D + e];
    __syncthreads();
    // warp 0, a lane a row: the rows of each code (a peer mask), and the
    // first of them finds the code's slot or takes a new one: in the dense
    // map of the one chunk, or (BIG) in the hash (the tile's first rows are
    // of distinct codes, so two lanes never insert the same key)
    if (warp == 0) {
      const int code = lane < rows ? tidx[lane] : NONE;
      const bool valid = code >= 0 && code < K;
      // rows past the tile or out of range match no other row
      const unsigned peers = __match_any_sync(0xffffffffu,
                                              valid ? code : -1 - lane);
      if (lane < rows) {
        int j = NONE;
        if (!BIG && valid && __ffs(peers) - 1 == lane) {
          j = slotc[code];
          if (j == NONE) {
            j = atomicAdd(nslots, 1);
            slotc[code] = j;
          }
        } else if (valid && __ffs(peers) - 1 == lane) {
          const unsigned mask = (unsigned)hsize - 1;
          volatile int* keys = hkey;
          for (unsigned h = hash_of(code, hbits);; h = (h + 1) & mask) {
            int key = keys[h];
            if (key == NONE) key = atomicCAS(&hkey[h], NONE, code);
            if (key == NONE) {                 // inserted here
              j = atomicAdd(nslots, 1);
              hval[h] = j;
              scode[j] = code;
              break;
            }
            if (key == code) {                 // an earlier tile's code
              j = hval[h];
              break;
            }
          }
        }
        tj[lane] = j;
        tmask[lane] = peers;
      }
    }
    __syncthreads();
    // (first row, d) for d < D: the slot's z-sum; d = D: its count; each
    // adds its code's rows in row order after the earlier tiles' rows
    for (int it = tid; it < rows * (D + 1); it += nt) {
      const int r = it / (D + 1), d = it - r * (D + 1);
      const int j = tj[r];
      if (j == NONE) continue;
      unsigned m = tmask[r];
      float* acc = d == D ? &lead_c[j] : &lead_w[j * D + d];
      float s = *acc;
      while (m) {
        const int r2 = __ffs(m) - 1;
        m &= m - 1;
        s = d == D ? __fadd_rn(s, tw[r2])
                   : __fadd_rn(s, __fmul_rn(tz[r2 * D + d], tw[r2]));
      }
      *acc = s;
    }
    __syncthreads();
  }

  // BIG: the first chunk's codes' slots, from the slots' codes
  const int ns = *nslots;
  if (BIG) {
    for (int j = tid; j < ns; j += nt) {
      if (scode[j] < w0) slotc[scode[j]] = j;
    }
    __syncthreads();
  }

  // ---- counts: c', the batch counts, t = c' / bias (kept for the first
  // chunk), each thread's part of n
  const bool debias = a.bias != nullptr;
  const float bias = debias ? *a.bias : 1.f;
  float* bcounts = a.batch_counts + (size_t)v * K;
  float part = 0.f;
  for (int k0 = tid; k0 < K; k0 += nt * CU) {
    float c[CU];
    if (k0 == tid) {
#pragma unroll
      for (int u = 0; u < CU; ++u) c[u] = cpre[u];
    } else {
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int k = k0 + u * nt;
        c[u] = k < K ? counts[k] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int k = k0 + u * nt;
      if (k >= K) break;
      const int j = !BIG || k < w0 ? slotc[k]
                                   : find_slot(hkey, hval, k, hbits);
      const float bc = j == NONE ? 0.f : lead_c[j];
      const float cn = __fadd_rn(__fmul_rn(c[u], a.decay),
                                 __fmul_rn(bc, a.omd));
      counts[k] = cn;
      bcounts[k] = bc;
      const float t = debias ? __fdiv_rn(cn, bias) : cn;
      if (k < w0) sc[k] = t;
      part = __fadd_rn(part, t);
    }
  }
  // n by a fixed tree: each warp's butterfly (every lane ends with the same
  // sum), then the warps' sums in order by warp 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  }
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (nt >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    }
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  const float n = red[32];
  const float denom = __fadd_rn(n, a.keps);

  // ---- dw and the codebook, a chunk of kc codes at a time
  float* cb = a.codebook + base;
  float4* cb4 = reinterpret_cast<float4*>(cb);
  // element (d, k) of dw, with the slot j and smoothed count sk of code k
  auto update = [&](float x, int d, int j, float sk, float& cbv) -> float {
    const float bdw = j == NONE ? 0.f : lead_w[j * D + d];
    const float d1 = __fadd_rn(__fmul_rn(x, a.decay), __fmul_rn(bdw, a.omd));
    const float ew = debias ? __fdiv_rn(d1, bias) : d1;
    cbv = __fdiv_rn(ew, sk);
    return d1;
  };
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int w = BIG ? min(kc, K - k0) : K;
    if (BIG && k0 > 0) {
      // a later chunk: its codes' slots, from the slots' codes
      for (int kk = tid; kk < w; kk += nt) slotc[kk] = NONE;
      __syncthreads();
      for (int j = tid; j < ns; j += nt) {
        const int kk = scode[j] - k0;
        if (kk >= 0 && kk < w) slotc[kk] = j;
      }
    }
    // the chunk's smoothed counts, from t: the counts pass's (the first
    // chunk) or the counts it wrote (the same operations, the same values)
    for (int kk = tid; kk < w; kk += nt) {
      float t;
      if (!BIG || k0 == 0) {
        t = sc[kk];
      } else {
        const float cn = counts[k0 + kk];
        t = debias ? __fdiv_rn(cn, bias) : cn;
      }
      sc[kk] = __fmul_rn(__fdiv_rn(__fadd_rn(t, a.eps), denom), n);
    }
    __syncthreads();
    if (a.vec) {
      // dw is read and written once a step: evict-first, so that L2 keeps
      // what the rest of the step reads (the codebook among it)
      const int groups = (D * w) >> 2;
      float4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = tid + u * nt;
        if (!BIG || k0 == 0) {
          x[u] = xpre[u];
        } else if (i < groups) {
          x[u] = __ldcs(&dw4[float4_at(i, k0, w)]);
        }
      }
      for (int i0 = tid; i0 < groups; i0 += nt * UNROLL) {
        float4 y[UNROLL];        // the next round's groups
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + (UNROLL + u) * nt;
          if (i < groups) y[u] = __ldcs(&dw4[float4_at(i, k0, w)]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * nt;
          if (i >= groups) break;
          const int e = 4 * i;
          int d = e / w, kk = e - d * w;
          const size_t g = float4_of(i, k0, w, d, kk);
          const float vals[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
          float outd[4], outc[4];
          if (a.vec == 2) {
            // K % 4 == 0: the group lies in one row, its codes' slots and
            // smoothed counts are one 16-byte read each
            const int4 j4 = *reinterpret_cast<const int4*>(&slotc[kk]);
            const float4 s4 = *reinterpret_cast<const float4*>(&sc[kk]);
            const int js[4] = {j4.x, j4.y, j4.z, j4.w};
            const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              outd[c] = update(vals[c], d, js[c], ss[c], outc[c]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              outd[c] = update(vals[c], d, slotc[kk], sc[kk], outc[c]);
              if (++kk == w) {
                kk = 0;
                ++d;
              }
            }
          }
          __stcs(&dw4[g], make_float4(outd[0], outd[1], outd[2], outd[3]));
          cb4[g] = make_float4(outc[0], outc[1], outc[2], outc[3]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) x[u] = y[u];
      }
    } else {
      for (int e = tid; e < D * w; e += nt) {
        const int d = e / w, kk = e - d * w;
        const size_t g = (size_t)d * K + k0 + kk;
        float cbv;
        dw[g] = update(dw[g], d, slotc[kk], sc[kk], cbv);
        cb[g] = cbv;
      }
    }
    if (BIG && k0 + kc < K) __syncthreads();  // the next chunk rewrites sc
  }
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Launches the EMA codebook step on `stream` of the current CUDA device:
// one block of `threads` threads a network, the batch staged `tb` (at most
// TILE) rows at a time, `slots` = min(B, K) slots of batch statistics in a
// hash of 2^hbits entries, the streaming pass `kc` codes a chunk (K, or a
// multiple of 4), the tables in `tables` ([n, table_words] int32 of device
// memory) or, where it is null, in shared memory (the plan of
// `cuda_ema.plan`); the BIG instance where kc < K or `tables` is given.
// `w` may be null (weight 1), `bias` null (no debias). counts, dw and
// codebook are updated in place and batch_counts written.
// Returns the launch's cudaError_t (0 on success); a plan the kernel does
// not take returns cudaErrorInvalidValue and launches nothing. It does not
// synchronise.
extern "C" int ema_update(const int32_t* idx, const float* z, const float* w,
                          const float* bias, float* counts, float* dw,
                          float* codebook, float* batch_counts, int* tables,
                          int n, int B, int D, int K, int threads, int tb,
                          int slots, int hbits, int kc, float decay,
                          float one_minus_decay, float eps, float k_eps,
                          void* stream) {
  if (n < 1 || B < 1 || D < 1 || K < 1 || (long long)D * K >= (1LL << 31)
      || !pow2(threads) || threads < 32 || threads > MAX_THREADS || tb < 1
      || tb > B || tb > TILE || slots != (B < K ? B : K) || hbits < 1
      || hbits > 30 || (1 << hbits) <= slots || kc < 1 || kc > K
      || (kc != K && kc % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem =
      4 * smem_words(D, tb, slots, hbits, kc, tables == nullptr);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ema_update_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(ema_update_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SMEM);
    }
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  // float4 groups of dw and the codebook inside a row: 2; groups over the
  // rows, where one chunk holds every code: 1; one value at a time: 0
  const bool aligned = (long long)D * K % 4 == 0
                       && reinterpret_cast<uintptr_t>(dw) % 16 == 0
                       && reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  const int vec = !aligned ? 0 : K % 4 == 0 ? 2 : kc == K ? 1 : 0;
  const Args a{idx, z, w, bias, counts, dw, codebook, batch_counts, tables,
               B, D, K, tb, slots, hbits, kc, decay, one_minus_decay, eps,
               k_eps, vec};
  const auto kernel = kc != K || tables != nullptr ? ema_update_kernel<true>
                                                  : ema_update_kernel<false>;
  kernel<<<n, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ema_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
