// Nearest-code search on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vq_argmin_kernel`
// (pgmvae_tpu/ops/pallas_vq.py:38, launched by `vq_codes_fused`).
//
// What it computes. For z [n, B, D] and per-variable codebooks W [n, D, K],
// both float32 and contiguous, it writes int32 out[n, B] with
//   out[v, b] = argmin_k (|W[v,:,k]|^2 - 2 z[v,b,:].W[v,:,k]).
// |z|^2 is left out: it does not move the argmin. Ties go to the lowest
// index, as with jnp.argmin. The [n, B, K] score tensor is never built. All
// products are fp32 FMAs: TF32 tensor-core products would round z and W to
// 10 mantissa bits and move codes.
//
// What bounds it. 2*n*B*D*K fp32 flops against 4*n*(B*D + D*K + B) bytes
// (each input read once, the output written once). On an H100 (67 TFLOP/s
// fp32 outside the tensor cores, 3.35 TB/s) the ridge is 20 flops a byte:
// stage-2 chunks (B=32, D=20, K=50) sit near 10 and are bound by bytes; large
// codebooks (B=256, K=4096) near 120 and are bound by the FMA rate.
//
// Design. One block per (variable, tile of up to 128 samples), one thread per
// sample; a loop over K tiles inside the block takes the place of the TPU's
// sequential K grid. The thread keeps its z row in registers (D rounded up to
// a multiple of 8 is a template parameter, at most 128). The variable's
// codebook streams through shared memory TILE_K codes at a time together with
// their |W_k|^2, computed once per tile for the whole block. Each thread
// scores four codes per step from one 16-byte shared-memory read (a broadcast:
// the whole warp reads one address), so shared-memory reads are a quarter of
// the FMAs. It keeps a running (min, index), replaced only on a strict < while
// k walks upward, so the lowest index wins every tie. Codes past K in the last
// tile are zero-filled and skipped; samples past B take part in the tile loads
// and barriers but store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_K = 64;        // codes per shared-memory tile
constexpr int MAX_THREADS = 128;  // samples per block
constexpr int MAX_D = 128;        // widest latent the kernel takes

template <int DPAD>
__global__ void __launch_bounds__(MAX_THREADS)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ w,
                 int32_t* __restrict__ out, int B, int D, int K) {
  extern __shared__ float4 smem4[];
  float* w_tile = reinterpret_cast<float*>(smem4);  // [D][TILE_K]
  float* w2 = w_tile + D * TILE_K;                   // [TILE_K], 16B aligned

  const int v = blockIdx.x;
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const float* wv = w + (size_t)v * D * K;
  const float* zb = z + ((size_t)v * B + (live ? b : 0)) * D;

  float zr[DPAD];
#pragma unroll
  for (int d = 0; d < DPAD; ++d) zr[d] = (live && d < D) ? zb[d] : 0.0f;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += TILE_K) {
    const int tk = min(TILE_K, K - k0);
    for (int i = threadIdx.x; i < D * TILE_K; i += blockDim.x) {
      const int d = i / TILE_K;
      const int j = i % TILE_K;
      w_tile[i] = j < tk ? wv[(size_t)d * K + k0 + j] : 0.0f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < TILE_K; j += blockDim.x) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float x = w_tile[d * TILE_K + j];
        s = fmaf(x, x, s);
      }
      w2[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < tk; j += 4) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int d = 0; d < DPAD; ++d) {
        if (d < D) {
          const float4 wq =
              *reinterpret_cast<const float4*>(w_tile + d * TILE_K + j);
          a0 = fmaf(zr[d], wq.x, a0);
          a1 = fmaf(zr[d], wq.y, a1);
          a2 = fmaf(zr[d], wq.z, a2);
          a3 = fmaf(zr[d], wq.w, a3);
        }
      }
      const float4 n2 = *reinterpret_cast<const float4*>(w2 + j);
      const float s[4] = {n2.x - 2.0f * a0, n2.y - 2.0f * a1,
                          n2.z - 2.0f * a2, n2.w - 2.0f * a3};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q < tk && s[q] < best) {
          best = s[q];
          best_k = k0 + j + q;
        }
      }
    }
    __syncthreads();
  }
  if (live) out[(size_t)v * B + b] = best_k;
}

template <int DPAD>
cudaError_t launch(const float* z, const float* w, int32_t* out, int n, int B,
                   int D, int K, int threads, cudaStream_t stream) {
  const dim3 grid(n, (B + threads - 1) / threads);
  const size_t smem = sizeof(float) * (size_t)(D + 1) * TILE_K;
  vq_argmin_kernel<DPAD><<<grid, threads, smem, stream>>>(z, w, out, B, D, K);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of CUDA device `device` and returns the
// launch's cudaError_t (0 on success). It does not synchronise.
extern "C" int vq_argmin(const float* z, const float* w, int32_t* out, int n,
                         int B, int D, int K, int device, void* stream) {
  if (n < 1 || B < 1 || D < 1 || D > MAX_D || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = ((B + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if ((B + threads - 1) / threads > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 7) / 8) {
    case 1: return (int)launch<8>(z, w, out, n, B, D, K, threads, s);
    case 2: return (int)launch<16>(z, w, out, n, B, D, K, threads, s);
    case 3: return (int)launch<24>(z, w, out, n, B, D, K, threads, s);
    case 4: return (int)launch<32>(z, w, out, n, B, D, K, threads, s);
    case 5: return (int)launch<40>(z, w, out, n, B, D, K, threads, s);
    case 6: return (int)launch<48>(z, w, out, n, B, D, K, threads, s);
    case 7: return (int)launch<56>(z, w, out, n, B, D, K, threads, s);
    case 8: return (int)launch<64>(z, w, out, n, B, D, K, threads, s);
    case 9: return (int)launch<72>(z, w, out, n, B, D, K, threads, s);
    case 10: return (int)launch<80>(z, w, out, n, B, D, K, threads, s);
    case 11: return (int)launch<88>(z, w, out, n, B, D, K, threads, s);
    case 12: return (int)launch<96>(z, w, out, n, B, D, K, threads, s);
    case 13: return (int)launch<104>(z, w, out, n, B, D, K, threads, s);
    case 14: return (int)launch<112>(z, w, out, n, B, D, K, threads, s);
    case 15: return (int)launch<120>(z, w, out, n, B, D, K, threads, s);
    case 16: return (int)launch<128>(z, w, out, n, B, D, K, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vq_argmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
