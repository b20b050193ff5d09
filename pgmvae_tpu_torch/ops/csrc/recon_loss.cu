// The reconstruction tail of a training step on Hopper (sm_90a): the
// decoder's sigmoid, the leave-one-out masked MSE and MAE, and the MSE's
// backward, as one forward and one backward launch.
//
// Replaces no TPU kernel: the JAX package leaves the loss to XLA, which
// fuses it. The port ran it as separate PyTorch operations (their plain
// version, `cuda_recon.recon_loss_plain` and `recon_loss_grad_plain`): the
// sigmoid, the error, its square, the [n, 1, n] mask, the [B] weights and
// the sum, autograd's backward of each, and the MAE's second pass, about 15
// passes over [n, B, n] a step (1.12 GB each at bbc batch 250).
//
// What it computes. For the decoder's last pre-activation x [F, B, N]
// (float32 or bfloat16; packed: F = S * fps rows of S seeds), labels y
// [S, B, N] float32 and sample weights w [B] float32, element (f, b, c) of
// seed s, network f' = f mod fps:
//   r    = sigmoid(x)                 1 / (1 + exp(-x)), torch.sigmoid's
//   e    = r - y
//   m    = [c != lo + f'] [c < n_active] [lo + f' < n_active]   (loo_mask)
//   mse_s = sum m w_b e^2 / D,  mae_s = sum m w_b |e| / D,
//   D    = n_active (n_active - 1) max(sum_b w_b, 1)   (or a given sum)
//   dx   = g_s / D * w_b * m * 2e * (1 - r) * r        (the backward)
// in PyTorch's order and rounding for each element, products and
// quotients rounded one at a time (__fmul_rn, __fdiv_rn: never fused). In
// bfloat16 the rounding of today's composition: r, e, e^2 rounded to
// bfloat16 (against y rounded to bfloat16) before the float32 mask and
// weights; the MAE against the float32 labels; in the backward the grad of
// e^2 rounded to bfloat16, then its product with 2e, then the sigmoid's
// backward as PyTorch computes it for bfloat16 on the card: 1 - r, its
// product with the gradient and that product with r, each rounded to
// bfloat16 (its CPU kernel rounds once). The mask is never built: a row
// knows its own column.
//
// The sums are deterministic, with no float atomics: a lane adds its
// elements of a row in float32 (at most ceil(N / 64) pairs), then adds
// that into a float64 sum; lanes, warps and blocks combine in a fixed tree
// and order; each block writes its seed's partial, takes a ticket (an
// integer atomic), and the last block to finish sums every seed's
// partials in block order and writes mse, mae and D. A graph's replay is
// bit-equal to the eager call.
//
// What bounds it. Bytes: the forward reads x (4 or 2 bytes an element)
// once, the backward reads x and writes dx; y ([S, B, N], reread by every
// network) stays in L2. At bbc batch 250 (F = N = 1058) that is 1.12 GB
// forward, 2.24 GB backward: 0.33 and 0.67 ms at 3.35 TB/s. The sigmoid's
// exp and IEEE division come near that: ~30 instructions an element.
//
// Design. A warp takes `rpw` rows of one seed in a row, its lanes
// striding over a row's columns two at a time (one at a time where N is
// odd or a pointer unaligned); a block of `threads` threads takes
// consecutive warps' rows of one seed (grid: bps blocks by S seeds). The
// logits are read with the evict-first hint. A row's network, batch row,
// weight and own column are worked out once a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_THREADS = 256;   // threads a block (`cuda_recon.THREADS`)
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* logits;   // [F, B, N] float or bfloat16
  const float* y;       // [S, B, N]
  const float* w;       // [B]
  const float* wsum;    // 0-dim, or null: the sum of w
  int B, N, fps, lo, n_active, rpw;
  long long nn1;        // n_active * (n_active - 1)
};

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.sigmoid's float arithmetic: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_of(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, size_t i, float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 2) {
      const float2 t = __ldcs(reinterpret_cast<const float2*>(p + i));
      v[0] = t.x;
      v[1] = t.y;
    } else {
      v[0] = __ldcs(p + i);
    }
  } else {
    if constexpr (V == 2) {
      const __nv_bfloat162 t =
          __ldcs(reinterpret_cast<const __nv_bfloat162*>(p + i));
      v[0] = __low2float(t);
      v[1] = __high2float(t);
    } else {
      v[0] = __bfloat162float(__ldcs(p + i));
    }
  }
}

template <int V>
__device__ __forceinline__ void load_y(const float* p, size_t i,
                                       float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p + i));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p + i);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, size_t i, const float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p + i) = make_float2(v[0], v[1]);
    } else {
      p[i] = v[0];
    }
  } else {
    if constexpr (V == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p + i) =
          __floats2bfloat162_rn(v[0], v[1]);
    } else {
      p[i] = __float2bfloat16_rn(v[0]);
    }
  }
}

// A row of a seed: its network's own column, the row's mask factor and
// weight, and the offsets of its logits and labels.
struct Row {
  int own;
  float rowm, wb;
  size_t x, y;
};

__device__ __forceinline__ Row row_of(const Args& a, int s, int r) {
  const int f = r / a.B, b = r - f * a.B;
  Row row;
  row.own = a.lo + f;
  row.rowm = row.own < a.n_active ? 1.0f : 0.0f;
  row.wb = __ldg(a.w + b);
  row.x = ((size_t)s * a.fps * a.B + r) * a.N;
  row.y = ((size_t)s * a.B + b) * a.N;
  return row;
}

__device__ __forceinline__ float mask_of(const Args& a, const Row& row,
                                         int c) {
  return c != row.own && c < a.n_active ? row.rowm : 0.0f;
}

// the sums of the block's threads (fixed order): every thread gets them
__device__ __forceinline__ void block_sum(double& p, double& q,
                                          double (*red)[MAX_THREADS / WARP]) {
  for (int o = WARP / 2; o; o >>= 1) {
    p += __shfl_xor_sync(FULL, p, o);
    q += __shfl_xor_sync(FULL, q, o);
  }
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  if (lane == 0) {
    red[0][warp] = p;
    red[1][warp] = q;
  }
  __syncthreads();
  p = q = 0.0;
  for (int i = 0; i < (int)(blockDim.x / WARP); ++i) {
    p += red[0][i];
    q += red[1][i];
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    recon_loss_fwd_kernel(Args a, double* partial, unsigned* ticket,
                          float* mse, float* mae, float* denom) {
  __shared__ double red[2][MAX_THREADS / WARP];
  __shared__ bool last;
  __shared__ float dsh;
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const T* x = static_cast<const T*>(a.logits);
  const int s = blockIdx.y, warps = blockDim.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int rows = a.fps * a.B;
  const int r0 = (blockIdx.x * warps + threadIdx.x / WARP) * a.rpw;
  const int r1 = min(r0 + a.rpw, rows);
  double dsq = 0.0, dab = 0.0;
  for (int r = r0; r < r1; ++r) {
    const Row row = row_of(a, s, r);
    float sq = 0.0f, ab = 0.0f;
#pragma unroll 4
    for (int c = lane * V; c < a.N; c += WARP * V) {
      float xv[V], yv[V];
      load<T, V>(x, row.x + c, xv);
      load_y<V>(a.y, row.y + c, yv);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float m = mask_of(a, row, c + u);
        float e2, ae;
        if constexpr (BF) {
          const float rv = bf_round(sigmoid_of(xv[u]));
          const float e = bf_round(__fsub_rn(rv, bf_round(yv[u])));
          e2 = bf_round(__fmul_rn(e, e));
          ae = fabsf(__fsub_rn(rv, yv[u]));
        } else {
          const float e = __fsub_rn(sigmoid_of(xv[u]), yv[u]);
          e2 = __fmul_rn(e, e);
          ae = fabsf(e);
        }
        sq = __fadd_rn(sq, __fmul_rn(__fmul_rn(e2, m), row.wb));
        ab = __fadd_rn(ab, __fmul_rn(__fmul_rn(ae, m), row.wb));
      }
    }
    dsq += (double)sq;
    dab += (double)ab;
  }
  block_sum(dsq, dab, red);
  if (threadIdx.x == 0) {
    const size_t k = ((size_t)s * gridDim.x + blockIdx.x) * 2;
    partial[k] = dsq;
    partial[k + 1] = dab;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: D, then each seed's partials in block order
  __threadfence();
  if (threadIdx.x == 0) {
    float ws = 0.0f;
    if (a.wsum != nullptr) {
      ws = __ldcg(a.wsum);
    } else {
      for (int b = 0; b < a.B; ++b) ws = __fadd_rn(ws, __ldg(a.w + b));
    }
    // torch.clamp(ws, min=1.0), NaN kept
    dsh = __fmul_rn(__ll2float_rn(a.nn1), ws < 1.0f ? 1.0f : ws);
    *denom = dsh;
  }
  __syncthreads();
  const float d = dsh;
  for (int s2 = 0; s2 < (int)gridDim.y; ++s2) {
    double p = 0.0, q = 0.0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
      const size_t k = ((size_t)s2 * gridDim.x + i) * 2;
      p += __ldcg(partial + k);
      q += __ldcg(partial + k + 1);
    }
    block_sum(p, q, red);
    if (threadIdx.x == 0) {
      mse[s2] = __fdiv_rn(__double2float_rn(p), d);
      mae[s2] = __fdiv_rn(__double2float_rn(q), d);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    recon_loss_bwd_kernel(Args a, const float* g, int gstride,
                          const float* denom, T* grad) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const T* x = static_cast<const T*>(a.logits);
  const int s = blockIdx.y, warps = blockDim.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int rows = a.fps * a.B;
  const int r0 = (blockIdx.x * warps + threadIdx.x / WARP) * a.rpw;
  const int r1 = min(r0 + a.rpw, rows);
  // autograd's order: (g / D) * w, then * m, then * 2e, then the
  // sigmoid's backward (grad * (1 - r)) * r
  const float gd = __fdiv_rn(__ldg(g + (size_t)s * gstride), __ldg(denom));
  for (int r = r0; r < r1; ++r) {
    const Row row = row_of(a, s, r);
    const float gw = __fmul_rn(gd, row.wb);
#pragma unroll 4
    for (int c = lane * V; c < a.N; c += WARP * V) {
      float xv[V], yv[V], dv[V];
      load<T, V>(x, row.x + c, xv);
      load_y<V>(a.y, row.y + c, yv);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float m = mask_of(a, row, c + u);
        if constexpr (BF) {
          const float rv = bf_round(sigmoid_of(xv[u]));
          const float e = bf_round(__fsub_rn(rv, bf_round(yv[u])));
          const float t = bf_round(__fmul_rn(gw, m));
          const float t2 = bf_round(__fmul_rn(t, __fmul_rn(2.0f, e)));
          // the card's bfloat16 sigmoid backward: each operation rounded
          const float omr = bf_round(__fsub_rn(1.0f, rv));
          dv[u] = __fmul_rn(bf_round(__fmul_rn(t2, omr)), rv);
        } else {
          const float rv = sigmoid_of(xv[u]);
          const float e = __fsub_rn(rv, yv[u]);
          const float t = __fmul_rn(__fmul_rn(gw, m), __fmul_rn(2.0f, e));
          dv[u] = __fmul_rn(__fmul_rn(t, __fsub_rn(1.0f, rv)), rv);
        }
      }
      store<T, V>(grad, row.x + c, dv);
    }
  }
}

// Checks a launch's shape and plan; fills `a`. Returns 0 or
// cudaErrorInvalidValue.
int setup(Args& a, const void* logits, const float* y, const float* w,
          const float* wsum, int F, int B, int N, int S, int lo,
          int n_active, int threads, int rpw, int bps) {
  if (F < 1 || B < 1 || N < 1 || S < 1 || S > 65535 || F % S != 0
      || lo < 0 || n_active < 1 || n_active > N || lo + F / S > N
      || (long long)F * B >= (1LL << 31) || threads < WARP
      || threads > MAX_THREADS || threads % WARP != 0 || rpw < 1
      || bps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // every row of a seed has a warp, and no block is empty
  const long long rows = (long long)(F / S) * B;
  const long long per_block = (long long)(threads / WARP) * rpw;
  if ((long long)bps * per_block < rows
      || (long long)(bps - 1) * per_block >= rows) {
    return (int)cudaErrorInvalidValue;
  }
  a = Args{logits, y, w, wsum, B, N, F / S, lo, n_active, rpw,
           (long long)n_active * (n_active - 1)};
  return 0;
}

// pairs of values where N is even and every row starts 8-byte (float) or
// 4-byte (bfloat16) aligned
bool pairs(int N, int bf16, const void* x, const void* y, const void* out) {
  const uintptr_t ax = bf16 ? 4 : 8;
  return N % 2 == 0 && reinterpret_cast<uintptr_t>(x) % ax == 0
         && reinterpret_cast<uintptr_t>(y) % 8 == 0
         && (out == nullptr || reinterpret_cast<uintptr_t>(out) % ax == 0);
}

}  // namespace

// The forward on `stream` of the current CUDA device: logits [F, B, N]
// (float32, or bfloat16 where `bf16`), y [S, B, N], w [B], wsum null or
// the weights' sum to divide by; grid `bps` blocks by S seeds of `threads`
// threads, `rpw` rows a warp (`cuda_recon.plan`). `partial` is scratch of
// 2 * S * bps doubles, `ticket` one unsigned int (set to 0 here, by a
// memset on the stream). Writes mse [S], mae [S] and denom [1]. Returns
// the memset's or the launch's cudaError_t (0 on success); a shape or plan
// it does not take returns cudaErrorInvalidValue and launches nothing. It
// does not synchronise.
extern "C" int recon_loss_fwd(const void* logits, int bf16, const float* y,
                              const float* w, const float* wsum,
                              double* partial, unsigned* ticket, float* mse,
                              float* mae, float* denom, int F, int B, int N,
                              int S, int lo, int n_active, int threads,
                              int rpw, int bps, void* stream) {
  Args a;
  const int bad = setup(a, logits, y, w, wsum, F, B, N, S, lo, n_active,
                        threads, rpw, bps);
  if (bad) return bad;
  const dim3 grid(bps, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const bool two = pairs(N, bf16, logits, y, nullptr);
  if (bf16) {
    if (two) {
      recon_loss_fwd_kernel<__nv_bfloat16, 2><<<grid, threads, 0, st>>>(
          a, partial, ticket, mse, mae, denom);
    } else {
      recon_loss_fwd_kernel<__nv_bfloat16, 1><<<grid, threads, 0, st>>>(
          a, partial, ticket, mse, mae, denom);
    }
  } else if (two) {
    recon_loss_fwd_kernel<float, 2><<<grid, threads, 0, st>>>(
        a, partial, ticket, mse, mae, denom);
  } else {
    recon_loss_fwd_kernel<float, 1><<<grid, threads, 0, st>>>(
        a, partial, ticket, mse, mae, denom);
  }
  return (int)cudaGetLastError();
}

// The backward: writes grad [F, B, N] (the logits' type) from g, the
// upstream gradient of mse (seed s's at g[s * gstride]), and the forward's
// denom; the other arguments as the forward's.
extern "C" int recon_loss_bwd(const void* logits, int bf16, const float* y,
                              const float* w, const float* g, int gstride,
                              const float* denom, void* grad, int F, int B,
                              int N, int S, int lo, int n_active,
                              int threads, int rpw, int bps, void* stream) {
  Args a;
  const int bad = setup(a, logits, y, w, nullptr, F, B, N, S, lo, n_active,
                        threads, rpw, bps);
  if (bad || gstride < 0) return bad ? bad : (int)cudaErrorInvalidValue;
  const dim3 grid(bps, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = pairs(N, bf16, logits, y, grad);
  if (bf16) {
    auto* out = static_cast<__nv_bfloat16*>(grad);
    if (two) {
      recon_loss_bwd_kernel<__nv_bfloat16, 2><<<grid, threads, 0, st>>>(
          a, g, gstride, denom, out);
    } else {
      recon_loss_bwd_kernel<__nv_bfloat16, 1><<<grid, threads, 0, st>>>(
          a, g, gstride, denom, out);
    }
  } else {
    auto* out = static_cast<float*>(grad);
    if (two) {
      recon_loss_bwd_kernel<float, 2><<<grid, threads, 0, st>>>(
          a, g, gstride, denom, out);
    } else {
      recon_loss_bwd_kernel<float, 1><<<grid, threads, 0, st>>>(
          a, g, gstride, denom, out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* recon_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
