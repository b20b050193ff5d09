// Single-pass Adam update of a whole table of parameter leaves on Hopper
// (sm_90a), in one launch.
//
// Replaces the Pallas TPU kernel `_adam_kernel`
// (pgmvae_tpu/ops/fused_adam.py:79, launched once per leaf by
// `_leaf_update_pallas`), and the JAX package's bfloat16-moment update
// (`upd16`, pgmvae_tpu/ops/fused_adam.py:187, an XLA path).
//
// What it computes. For each leaf of `numel` float32 values p, its moments m
// and v and its gradient g, in place (the Pallas kernel aliases p, m, v to its
// outputs; this kernel writes them where they are, which saves a second copy
// of the optimizer state):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   p' = p + (-lr * ((m'/bc1) / (sqrt(v'/bc2) + eps)))
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t. The wrapper computes the powers
// [b1^t, b2^t] on the device from the step count, and the kernel reads them
// and lr from device memory, as the Pallas kernel reads its scalars from
// SMEM: a step needs no host round trip and the learning rate stays a
// runtime value. b1, b2 and eps are launch arguments; (1-b1), (1-b2), bc1 and
// bc2 are taken in float32, as optax takes them.
//
// Rounding. The library is built with -fmad=false and without
// --use_fast_math: every product and sum rounds on its own, division and sqrt
// are IEEE-rounded. That is what PyTorch's separate elementwise operations
// do, so the kernel is bit-equal to `adam_update_plain` on the same inputs.
// Contracting to FMAs would buy nothing here (see the bound).
//
// What bounds it. Each parameter reads p, m, v, g and writes p, m, v: 28
// bytes (20 with bfloat16 moments) for 14 float operations, with no reuse.
// At 3.35 TB/s against 67 TFLOP/s (H100 SXM) the ridge is 20 operations a
// byte and this kernel sits at 0.5 (0.7): it is bound by memory bandwidth,
// and at small leaf sets (nltcs's 20 leaves hold 31,200 parameters) by the
// cost of a launch. So the design is about launches, filling the card and
// bytes in flight.
//
// Design.
// - One launch per update. The leaves travel in an AdamTable passed by
//   value as a kernel parameter (__grid_constant__, read from the constant
//   bank): at most TABLE_CAPACITY leaves, within the 4 KB parameter limit.
//   A CUDA graph captures the table with the launch; there is no device-side
//   table to copy. An update with more leaves takes one launch per table.
// - The work split. Each leaf is cut into chunks of CHUNK values, numbered
//   across the table (a leaf's first chunk is `first_chunk`), and the grid
//   has one block per chunk. A block finds its chunk's leaf by a binary
//   search of the first chunks. (A persistent grid of the card's resident
//   blocks walking the chunks was slower at bbc's and ad's leaves, and no
//   faster at nltcs's and kdd's.)
// - Bytes in flight. A thread issues the loads of UNROLL float4 groups of p,
//   g, m and v (bfloat16 moments: pairs of __nv_bfloat162, 8 bytes for four
//   values) before any arithmetic, then computes and stores them; ITERS such
//   rounds make a chunk. UNROLL, ITERS and the blocks an SM must hold
//   (MIN_BLOCKS, a register cap) depend on the moment type (`Split`), as
//   measured on the H100. A leaf takes that vector path when all four
//   pointers are aligned for a vector of four values (`vec`, set by the
//   wrapper: 16 bytes of p and g, and of m and v when they are float32; 8
//   bytes for bfloat16 moments); a chunk starts at a multiple of CHUNK, so
//   every chunk of such a leaf is aligned. The leaf's numel % 4 tail and
//   leaves that are not aligned take the scalar loop.
// - Cache policy: default caching. kdd's and nltcs's whole state (26 MB and
//   0.9 MB) fits the 50 MB L2; the evict-first hints (__ldcs/__stcs) on
//   leaves far larger than L2 were slower at bbc's and ad's leaves.
//
// bfloat16 moments (adam_impl 'fused_bf16'). The update is templated on the
// moments' storage type M. With M = bfloat16, m and v widen exactly to
// float32; the arithmetic is the float32 path's, and p is updated from the
// unrounded float32 m' and v'. Only the stores of m' and v' round to
// bfloat16, to nearest even (__float2bfloat16_rn), as XLA's f32->bf16 convert
// does. Each parameter then moves 20 bytes instead of 28 (p 8, g 4, m and v
// 4 each): the bound falls to 20/28 of the float32 update's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int64_t CHUNK = 4096;  // values a block updates
constexpr int TABLE_CAPACITY = 64;

// The layout the wrapper's ctypes structures (ops/fused_adam.py `_Leaf`,
// `_Table`) repeat; the asserts below are the layout's record.
struct AdamLeaf {
  float* p;
  void* m;               // float or __nv_bfloat16, by the launch
  void* v;
  const float* g;
  long long numel;       // > 0
  long long first_chunk; // in the table's numbering
  int vec;               // all four pointers aligned for a vector of four
  int pad;
};

struct AdamTable {
  long long chunks;      // sum of ceil(numel / CHUNK) over the leaves
  int n_leaves;          // 1..TABLE_CAPACITY
  int pad;
  AdamLeaf leaves[TABLE_CAPACITY];
};

static_assert(CHUNK == 4096, "CHUNK");
static_assert(TABLE_CAPACITY == 64, "TABLE_CAPACITY");
static_assert(sizeof(AdamLeaf) == 56, "sizeof(AdamLeaf)");
static_assert(offsetof(AdamLeaf, p) == 0, "offsetof(AdamLeaf, p)");
static_assert(offsetof(AdamLeaf, m) == 8, "offsetof(AdamLeaf, m)");
static_assert(offsetof(AdamLeaf, v) == 16, "offsetof(AdamLeaf, v)");
static_assert(offsetof(AdamLeaf, g) == 24, "offsetof(AdamLeaf, g)");
static_assert(offsetof(AdamLeaf, numel) == 32, "offsetof(AdamLeaf, numel)");
static_assert(offsetof(AdamLeaf, first_chunk) == 40,
              "offsetof(AdamLeaf, first_chunk)");
static_assert(offsetof(AdamLeaf, vec) == 48, "offsetof(AdamLeaf, vec)");
static_assert(sizeof(AdamTable) == 3600, "sizeof(AdamTable)");
static_assert(offsetof(AdamTable, chunks) == 0, "offsetof(AdamTable, chunks)");
static_assert(offsetof(AdamTable, n_leaves) == 8,
              "offsetof(AdamTable, n_leaves)");
static_assert(offsetof(AdamTable, leaves) == 16,
              "offsetof(AdamTable, leaves)");
// the table and the launch's other arguments within the 4 KB parameter limit
static_assert(sizeof(AdamTable) + 2 * sizeof(void*) + 3 * sizeof(float)
                  <= 4096, "kernel parameters");

namespace {

struct Coef {
  float b1, b2, omb1, omb2, eps, bc1, bc2, nlr;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v,
                                         const float g, const Coef& c) {
  m = c.b1 * m + c.omb1 * g;
  v = c.b2 * v + c.omb2 * (g * g);
  const float u = (m / c.bc1) / (sqrtf(v / c.bc2) + c.eps);
  p = p + c.nlr * u;
}

// How a block takes its chunk, by moment type: a thread updates UNROLL
// groups of four values a round, ITERS rounds a chunk, and the kernel keeps
// to the registers that let MIN_BLOCKS blocks share an SM. Chosen on the
// H100 at bbc's and ad's leaves (see Design).
template <typename M>
struct Split;

template <>
struct Split<float> {
  static constexpr int UNROLL = 4, ITERS = 1, MIN_BLOCKS = 1;
};

template <>
struct Split<__nv_bfloat16> {
  static constexpr int UNROLL = 2, ITERS = 2, MIN_BLOCKS = 4;
};

static_assert(THREADS * 4 * Split<float>::UNROLL * Split<float>::ITERS ==
                  CHUNK, "Split<float>");
static_assert(THREADS * 4 * Split<__nv_bfloat16>::UNROLL *
                      Split<__nv_bfloat16>::ITERS == CHUNK,
              "Split<__nv_bfloat16>");

// Loads and stores of four moments as a float4 (M = float) or two
// __nv_bfloat162 (M = __nv_bfloat16), and of one moment.
template <typename M>
struct Moments;

template <>
struct Moments<float> {
  static __device__ __forceinline__ float4 load4(const float* x, int64_t i) {
    return reinterpret_cast<const float4*>(x)[i];
  }
  static __device__ __forceinline__ void store4(float* x, int64_t i,
                                                const float4 y) {
    reinterpret_cast<float4*>(x)[i] = y;
  }
  static __device__ __forceinline__ float load1(const float* x, int64_t i) {
    return x[i];
  }
  static __device__ __forceinline__ void store1(float* x, int64_t i,
                                                const float y) {
    x[i] = y;
  }
};

template <>
struct Moments<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* x,
                                                 int64_t i) {
    const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t i,
                                                const float4 y) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(x)[i] = raw;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* x,
                                                int64_t i) {
    return __bfloat162float(x[i]);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* x, int64_t i,
                                                const float y) {
    x[i] = __float2bfloat16_rn(y);
  }
};

// Values [start, end) of a leaf, one at a time.
template <typename M>
__device__ __forceinline__ void chunk_scalar(float* p, M* m, M* v,
                                             const float* g, int64_t start,
                                             int64_t end, const Coef& c) {
  using IO = Moments<M>;
  for (int64_t i = start + threadIdx.x; i < end; i += THREADS) {
    float pp = p[i], mm = IO::load1(m, i), vv = IO::load1(v, i);
    adam_one(pp, mm, vv, g[i], c);
    p[i] = pp;
    IO::store1(m, i, mm);
    IO::store1(v, i, vv);
  }
}

// Values [start, end) of an aligned leaf, start a multiple of 4 and
// end - start <= THREADS * 4 * UNROLL: each thread loads its UNROLL groups
// of four of all four arrays, then updates and stores them; the scalar loop
// takes the values past the last whole group (the leaf's numel % 4 tail).
template <typename M>
__device__ __forceinline__ void round_vector(float* p, M* m, M* v,
                                             const float* g, int64_t start,
                                             int64_t end, const Coef& c) {
  using IO = Moments<M>;
  constexpr int UNROLL = Split<M>::UNROLL;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const int64_t first = start / 4 + threadIdx.x;
  const int64_t groups = end / 4;
  float4 pp[UNROLL], gg[UNROLL], mm[UNROLL], vv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i < groups) {
      pp[u] = p4[i];
      gg[u] = g4[i];
      mm[u] = IO::load4(m, i);
      vv[u] = IO::load4(v, i);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i < groups) {
      adam_one(pp[u].x, mm[u].x, vv[u].x, gg[u].x, c);
      adam_one(pp[u].y, mm[u].y, vv[u].y, gg[u].y, c);
      adam_one(pp[u].z, mm[u].z, vv[u].z, gg[u].z, c);
      adam_one(pp[u].w, mm[u].w, vv[u].w, gg[u].w, c);
      p4[i] = pp[u];
      IO::store4(m, i, mm[u]);
      IO::store4(v, i, vv[u]);
    }
  }
  chunk_scalar<M>(p, m, v, g, groups * 4, end, c);
}

template <typename M>
__global__ void __launch_bounds__(THREADS, Split<M>::MIN_BLOCKS)
adam_table_kernel(const __grid_constant__ AdamTable table,
                  const float* __restrict__ powers,
                  const float* __restrict__ lr, float b1, float b2,
                  float eps) {
  constexpr int64_t ROUND = THREADS * 4 * Split<M>::UNROLL;
  Coef c;
  c.b1 = b1;
  c.b2 = b2;
  c.omb1 = 1.0f - b1;
  c.omb2 = 1.0f - b2;
  c.eps = eps;
  c.bc1 = 1.0f - powers[0];
  c.bc2 = 1.0f - powers[1];
  c.nlr = -lr[0];
  const int64_t chunk = blockIdx.x;
  // the last leaf whose first chunk is at or before this one
  int lo = 0, hi = table.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaves[mid].first_chunk <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const AdamLeaf& leaf = table.leaves[lo];
  const int64_t start = (chunk - leaf.first_chunk) * CHUNK;
  const int64_t end = min(start + CHUNK, (int64_t)leaf.numel);
  M* m = static_cast<M*>(leaf.m);
  M* v = static_cast<M*>(leaf.v);
  if (!leaf.vec) {
    chunk_scalar<M>(leaf.p, m, v, leaf.g, start, end, c);
    return;
  }
  for (int it = 0; it < Split<M>::ITERS; ++it) {
    const int64_t s = start + it * ROUND;
    if (s >= end) break;
    round_vector<M>(leaf.p, m, v, leaf.g, s, min(s + ROUND, end), c);
  }
}

template <typename M>
int launch(const AdamTable* table, const float* powers, const float* lr,
           float b1, float b2, float eps, void* stream) {
  if (table->n_leaves < 1 || table->n_leaves > TABLE_CAPACITY ||
      table->chunks < 1 || table->chunks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  adam_table_kernel<M><<<(unsigned)table->chunks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *table, powers, lr, b1, b2, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one update of every leaf of `table` (copied into the launch's
// parameters, so the caller may reuse it at once) on `stream` of the current
// CUDA device, one block per chunk, and returns the launch's cudaError_t (0
// on success). It does not synchronise. `powers` is [b1^t, b2^t] and `lr`
// the learning rate, float32 in device memory; bf16 = 0 takes float32
// moments, 1 bfloat16 moments.
extern "C" int adam_update_table(const AdamTable* table, const float* powers,
                                 const float* lr, float b1, float b2,
                                 float eps, int bf16, void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(table, powers, lr, b1, b2, eps, stream);
  }
  return launch<float>(table, powers, lr, b1, b2, eps, stream);
}

extern "C" const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
