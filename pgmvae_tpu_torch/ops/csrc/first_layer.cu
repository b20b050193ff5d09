// The masked first encoder layer on Hopper (sm_90a): every network's
// first dense layer over the shared sample rows, its own input dropped as
// the weight operand is loaded, so the [n, B, n] masked input is never
// built.
//
// Replaces no TPU kernel: the JAX package builds the masked input
// (`y[None] * loo_mask(...)`, `pgmvae_tpu/models/vqvae.py`, `encode`) and
// leaves the product to XLA. The port did the same in PyTorch (the plain
// version, `cuda_first_layer.first_layer_plain`): a float32 [n, B, n]
// tensor written (4.48 MB a row at bbc's n = 1058), then read by a
// batched `baddbmm` as n private copies of the same rows, and kept by
// autograd for the weight gradient.
//
// What it computes. For samples y [S, B, N] (S packed seeds), weights
// w [S * F, N, O] and biases b [S * F, 1, O] of F networks a seed that
// start at global network `lo` (a shard of the variable axis), for seed s,
// network v, row r and output o:
//   out[s F + v, r, o] = b[s F + v, 0, o]
//                        + sum_{k != lo + v, k < n_active} y[s, r, k] w[s F + v, k, o]
// and out = b where lo + v >= n_active (`loo_mask`'s padding rows). The
// dropped terms enter the sum as the exact zero the masked input gave
// them: their weight is loaded as 0. Float32 FFMA in a per-thread order
// over k; TF32 is never used.
//
// What bounds it. Operations: 2 S B N F O (bbc, one seed, F = N = 1058,
// O = 111: 0.248 GFLOP a row, 0.93 ms at 250 rows at 67 TFLOP/s).
// Bytes: the weights once, 4 S F N O (497 MB at bbc: 0.148 ms at
// 3.35 TB/s), the rows and the output. So a call of more than ~41 rows is
// bound by the float32 FFMA rate and one of fewer by streaming the
// weights.
//
// Design. One GEMM a seed: rows y [B, N] times a [N, F O] operand whose
// column c = v O + o is network v's output o, read straight from w's
// [F, N, O] layout (a row of O floats a network and k, 4-byte aligned
// only, so it is copied one float at a time; consecutive threads take
// consecutive columns, so a warp's copies are contiguous but for the
// network boundaries). Flattening the columns keeps a tile's 128 columns
// full across networks, where a tile a network would pad 111 to 128. A
// block computes a BM x BN tile of one seed, BK = 16 values of k at a
// time, through a three-stage ring in shared memory filled by cp.async:
// two tiles are in flight while the third is multiplied, with one barrier
// a tile and no registers spent on staging. The mask is the copy itself:
// a network's own input (and the padding) is copied with source size 0,
// which writes the zero the masked input held, so the weight column's
// network, own input and liveness are worked out once a thread and each
// copy tests one compare. Each thread keeps TM x TN sums, read from
// shared memory as float4 (two groups of four columns and, where TM = 8,
// two of four rows). k runs to n_active only (the rest is zero). The row
// tiles of one column tile are neighbouring blocks, so they run together
// and the second reads the weight tile from L2: the weights stream from
// device memory once. The tile comes from the rows
// (`cuda_first_layer.plan`): 128 rows where B passes 64 (the compute-bound
// shapes; 2 blocks an SM), 64, 32 or 8 below, so a small call pads few
// rows while it streams the weights. Register-staged double buffering
// reached 44-46% of the operations bound at 250 rows on an H100 at any
// tile shape; the cp.async ring 56% (1.66 ms; `PERF.md`), where a warp
// tile of 8 x 4 threads, four stages or BK = 32 moved it by under 1%.
// Nor is it the copies' issue that holds it: a loader of a fifth the
// instructions a tile (one row and consecutive k a thread) gave the same
// time, so the FFMA and shared-memory stream sets the rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* y;      // [S, B, N]
  const float* w;      // [S * F, N, O]
  const float* bias;   // [S * F, 1, O]
  float* out;          // [S * F, B, O]
  int B, N, O, F, lo, n_active;
  int cols;            // F * O: a seed's output columns
  int mtiles;          // row tiles: ceil(B / BM)
};

template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int TX = BN / TN;             // threads along columns
  static constexpr int RG = TM < 4 ? TM : 4;     // rows a group (one load)
  static constexpr int NRG = TM / RG;            // row groups a thread
  static constexpr int NCG = TN / 4;             // column groups a thread
  static constexpr int AS = BM + 4;              // y tile's row stride
  static constexpr int A_LOADS = BM * BK / THREADS;
  static constexpr int W_LOADS = BK * BN / THREADS;
  static constexpr int AMS = THREADS / BK;       // y tile: row step
  static constexpr int WKS = THREADS / BN;       // weight tile: k step
  static_assert(TN % 4 == 0 && TM % RG == 0 && BM % (TM / RG * 4) == 0
                    && BN % (TN / 4 * 4) == 0,
                "thread tile");
  static_assert(THREADS % BK == 0 && THREADS % BN == 0
                    && (BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "tile loads");
};

// cp.async of one float into shared memory, or a zero where `on` is false
// (src-size 0: nothing is read; `src` need only be a valid address)
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src,
                                             bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int ST = 3;     // stages of the copy pipeline

template <int BM, int BN, int BK, int TM, int TN>
constexpr int smem_bytes() {
  return ST * BK * (Tile<BM, BN, BK, TM, TN>::AS + BN) * 4;
}

template <int BM, int BN, int BK, int TM, int TN, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
    first_layer_kernel(const Args a) {
  using T = Tile<BM, BN, BK, TM, TN>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [ST][BK][AS]
  float* Ws = smem + ST * BK * T::AS;    // [ST][BK][BN]

  const int tid = threadIdx.x;
  const int mt = blockIdx.x % a.mtiles;
  const int c0 = (blockIdx.x / a.mtiles) * BN;
  const int m0 = mt * BM;
  const int s = blockIdx.y;

  // the weight column this thread loads, fixed over k
  const int wc = tid % BN;
  const int wk0 = tid / BN;
  const float* wp = a.w;
  int own = -1;
  bool live = false;
  {
    const int c = c0 + wc;
    if (c < a.cols) {
      const int v = c / a.O;
      own = a.lo + v;
      live = own < a.n_active;
      wp = a.w + (static_cast<size_t>(s) * a.F + v) * a.N * a.O
           + (c - v * a.O);
    }
  }
  // the y values this thread loads: one k, rows am0 + i AMS
  const int ak = tid % BK;
  const int am0 = tid / BK;
  const float* yp = a.y + static_cast<size_t>(s) * a.B * a.N;

  // tile t's y and weights into stage b, a network's own input as zero
  auto issue = [&](int t, int b) {
    const int k0 = t * BK;
#pragma unroll
    for (int i = 0; i < T::A_LOADS; ++i) {
      const int m = m0 + am0 + i * T::AMS, k = k0 + ak;
      const bool on = m < a.B && k < a.N;
      copy_or_zero(&As[(b * BK + ak) * T::AS + am0 + i * T::AMS],
                   on ? yp + static_cast<size_t>(m) * a.N + k : yp, on);
    }
#pragma unroll
    for (int i = 0; i < T::W_LOADS; ++i) {
      const int k = k0 + wk0 + i * T::WKS;
      const bool on = live && k < a.n_active && k != own;
      copy_or_zero(&Ws[(b * BK + wk0 + i * T::WKS) * BN + wc],
                   on ? wp + static_cast<size_t>(k) * a.O : a.w, on);
    }
  };

  const int tx = tid % T::TX, ty = tid / T::TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int ktiles = (a.n_active + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ktiles) issue(t, t);
    commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    wait_pending<ST - 2>();
    __syncthreads();     // tile t landed; stage (t - 1) % ST is read out
    if (t + ST - 1 < ktiles) issue(t + ST - 1, (t + ST - 1) % ST);
    commit();
    const float* at = As + (t % ST) * BK * T::AS;
    const float* wt = Ws + (t % ST) * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float fa[TM], fw[TN];
#pragma unroll
      for (int g = 0; g < T::NRG; ++g) {
        const float* p = at + kk * T::AS + g * (BM / T::NRG) + ty * T::RG;
        if constexpr (T::RG == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          fa[g * 4 + 0] = v.x;
          fa[g * 4 + 1] = v.y;
          fa[g * 4 + 2] = v.z;
          fa[g * 4 + 3] = v.w;
        } else {
#pragma unroll
          for (int r = 0; r < T::RG; ++r) fa[g * T::RG + r] = p[r];
        }
      }
#pragma unroll
      for (int g = 0; g < T::NCG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            wt + kk * BN + g * (BN / T::NCG) + tx * 4);
        fw[g * 4 + 0] = v.x;
        fw[g * 4 + 1] = v.y;
        fw[g * 4 + 2] = v.z;
        fw[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(fa[i], fw[j], acc[i][j]);
    }
  }
  wait_pending<0>();

  // out = sums + bias, column by column
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = c0 + (j / 4) * (BN / T::NCG) + tx * 4 + (j % 4);
    if (c >= a.cols) continue;
    const int v = c / a.O, o = c - v * a.O;
    const size_t net = static_cast<size_t>(s) * a.F + v;
    const float bj = __ldg(a.bias + net * a.O + o);
    float* op = a.out + net * a.B * a.O + o;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (i / T::RG) * (BM / T::NRG) + ty * T::RG
                    + (i % T::RG);
      if (m < a.B) op[static_cast<size_t>(m) * a.O] = acc[i][j] + bj;
    }
  }
}

// The tiles (`cuda_first_layer.INSTANCES`, in this order): BM, BN, BK,
// TM, TN, threads.
constexpr int INSTANCES = 4;
constexpr int SHAPES[INSTANCES][6] = {{128, 128, 16, 8, 8, 256},
                                      {64, 128, 16, 8, 8, 128},
                                      {32, 128, 16, 4, 8, 128},
                                      {8, 128, 16, 1, 8, 128}};

template <int BM, int BN, int BK, int TM, int TN, int MINB>
cudaError_t launch(const Args& a, int S, cudaStream_t st) {
  const long long blocks =
      static_cast<long long>((a.cols + BN - 1) / BN) * a.mtiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<BM, BN, BK, TM, TN>();
  auto* kernel = first_layer_kernel<BM, BN, BK, TM, TN, MINB>;
  if constexpr (bytes > 48 * 1024) {
    // past 48 KB a kernel's shared memory is opted into, once a device
    // (the first call is eager: the graphs' warm-up makes it)
    static unsigned long long devices = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!(devices >> dev & 1ULL)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      devices |= 1ULL << dev;
    }
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), S),
           Tile<BM, BN, BK, TM, TN>::THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The layer on `stream` of the current CUDA device: y [S, B, N], w
// [S * F, N, O], bias [S * F, 1, O] (float32, contiguous) into out
// [S * F, B, O]; networks lo .. lo + F - 1 of n_active live ones. `inst`
// is the tile (`cuda_first_layer.plan`), whose rows `bm` and columns `bn`
// the caller states. Returns the launch's cudaError_t (0 on success); a
// shape or plan it does not take returns cudaErrorInvalidValue and
// launches nothing. It does not synchronise.
extern "C" int first_layer_fwd(const float* y, const float* w,
                               const float* bias, float* out, int S, int B,
                               int N, int O, int F, int lo, int n_active,
                               int inst, int bm, int bn, void* stream) {
  if (inst < 0 || inst >= INSTANCES || SHAPES[inst][0] != bm
      || SHAPES[inst][1] != bn || S < 1 || S > 65535 || B < 1 || N < 1
      || O < 1 || F < 1 || lo < 0 || n_active < 1 || n_active > N
      || static_cast<long long>(F) * O >= (1LL << 31)
      || static_cast<long long>(lo) + F > N)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{y, w, bias, out, B, N, O, F, lo, n_active, F * O,
         (B + bm - 1) / bm};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 0: return static_cast<int>(launch<128, 128, 16, 8, 8, 2>(a, S, st));
    case 1: return static_cast<int>(launch<64, 128, 16, 8, 8, 1>(a, S, st));
    case 2: return static_cast<int>(launch<32, 128, 16, 4, 8, 1>(a, S, st));
    default: return static_cast<int>(launch<8, 128, 16, 1, 8, 1>(a, S, st));
  }
}

extern "C" const char* first_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
