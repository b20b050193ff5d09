// Single-pass Adam update of one parameter leaf on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_adam_kernel`
// (pgmvae_tpu/ops/fused_adam.py:79, launched once per leaf by
// `_leaf_update_pallas`).
//
// What it computes. For a leaf of `numel` float32 values p, its moments m and
// v and its gradient g, in place (the Pallas kernel aliases p, m, v to its
// outputs; this kernel writes them where they are, which saves a second copy
// of the optimizer state):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   p' = p + (-lr * ((m'/bc1) / (sqrt(v'/bc2) + eps)))
// bc1 = 1 - b1^t, bc2 = 1 - b2^t and lr are read from `scalars` [3] in device
// memory, as the Pallas kernel reads them from SMEM: the wrapper computes them
// on the device from the step count, so a step needs no host round trip and
// the learning rate stays a runtime value. b1, b2 and eps are launch
// arguments; (1-b1) and (1-b2) are taken in float32, as optax takes them.
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
// byte and this kernel sits at 0.5 (0.7): it is bound by memory bandwidth at
// every size.
//
// Design. One grid-stride launch per leaf, 256 threads a block. When all four
// pointers are aligned for a vector of four values (16 bytes of p and g, and
// of m and v when they are float32), each thread moves four values at a time,
// and a scalar loop finishes the numel % 4 tail; otherwise the scalar loop
// does the whole leaf.
//
// bfloat16 moments (adam_impl 'fused_bf16'; in the JAX package an XLA path,
// `upd16` in pgmvae_tpu/ops/fused_adam.py:187, not a Pallas kernel). The
// update is templated on the moments' storage type M. With M = bfloat16, m
// and v load as pairs of __nv_bfloat162 (8 bytes for four values) and widen
// exactly to float32; the arithmetic is the float32 path's, and p is updated
// from the unrounded float32 m' and v'. Only the stores of m' and v' round to
// bfloat16, to nearest even (__float2bfloat16_rn), as XLA's f32->bf16 convert
// does. Each parameter then moves 20 bytes instead of 28 (p 8, g 4, m and v
// 4 each): the bound falls to 20/28 of the float32 update's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 4096;

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
  static __device__ __forceinline__ float load(const float* x, int64_t i) {
    return x[i];
  }
  static __device__ __forceinline__ void store(float* x, int64_t i,
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
  static __device__ __forceinline__ float load(const __nv_bfloat16* x,
                                               int64_t i) {
    return __bfloat162float(x[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* x, int64_t i,
                                               const float y) {
    x[i] = __float2bfloat16_rn(y);
  }
};

template <typename M, bool VEC>
__global__ void __launch_bounds__(THREADS)
adam_kernel(float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
            const float* __restrict__ g, const float* __restrict__ scalars,
            int64_t n, float b1, float b2, float eps) {
  using IO = Moments<M>;
  Coef c;
  c.b1 = b1;
  c.b2 = b2;
  c.omb1 = 1.0f - b1;
  c.omb2 = 1.0f - b2;
  c.eps = eps;
  c.bc1 = scalars[0];
  c.bc2 = scalars[1];
  c.nlr = -scalars[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (VEC) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = first; i < n4; i += stride) {
      float4 pp = p4[i], mm = IO::load4(m, i), vv = IO::load4(v, i);
      const float4 gg = g4[i];
      adam_one(pp.x, mm.x, vv.x, gg.x, c);
      adam_one(pp.y, mm.y, vv.y, gg.y, c);
      adam_one(pp.z, mm.z, vv.z, gg.z, c);
      adam_one(pp.w, mm.w, vv.w, gg.w, c);
      p4[i] = pp;
      IO::store4(m, i, mm);
      IO::store4(v, i, vv);
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + first; i < n; i += stride) {
    float pp = p[i], mm = IO::load(m, i), vv = IO::load(v, i);
    adam_one(pp, mm, vv, g[i], c);
    p[i] = pp;
    IO::store(m, i, mm);
    IO::store(v, i, vv);
  }
}

template <typename M>
int launch(float* p, M* m, M* v, const float* g, const float* scalars,
           long long numel, float b1, float b2, float eps, void* stream) {
  if (numel < 1) return (int)cudaErrorInvalidValue;
  // four moments are 4 * sizeof(M) bytes: 16 for float, 8 for bfloat16
  const uintptr_t moment_align = 4 * sizeof(M) - 1;
  const bool vec = (((reinterpret_cast<uintptr_t>(p) |
                      reinterpret_cast<uintptr_t>(g)) & 15) |
                    ((reinterpret_cast<uintptr_t>(m) |
                      reinterpret_cast<uintptr_t>(v)) & moment_align)) == 0;
  const int64_t work = vec ? (numel + 3) / 4 : numel;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    adam_kernel<M, true><<<(unsigned)blocks, THREADS, 0, s>>>(
        p, m, v, g, scalars, (int64_t)numel, b1, b2, eps);
  } else {
    adam_kernel<M, false><<<(unsigned)blocks, THREADS, 0, s>>>(
        p, m, v, g, scalars, (int64_t)numel, b1, b2, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches one update of a leaf of `numel` parameters on `stream` (of
// the current CUDA device) and returns the launch's cudaError_t (0 on
// success). They do not synchronise. adam_update takes float32 moments,
// adam_update_bf16 bfloat16 moments.
extern "C" int adam_update(float* p, float* m, float* v, const float* g,
                           const float* scalars, long long numel, float b1,
                           float b2, float eps, void* stream) {
  return launch<float>(p, m, v, g, scalars, numel, b1, b2, eps, stream);
}

extern "C" int adam_update_bf16(float* p, __nv_bfloat16* m, __nv_bfloat16* v,
                                const float* g, const float* scalars,
                                long long numel, float b1, float b2,
                                float eps, void* stream) {
  return launch<__nv_bfloat16>(p, m, v, g, scalars, numel, b1, b2, eps,
                               stream);
}

extern "C" const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
