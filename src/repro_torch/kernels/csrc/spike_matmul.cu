// Event-driven spike matmul for Hopper (sm_90a).
//
//   out[M, N] = spikes[M, K] @ w[K, N]      spikes in {0, 1}
//
// spikes and w are both float32 or both bfloat16, contiguous row-major; the
// sum is float32 and out is written in w's dtype. No dimension is padded:
// edge tiles load zeros outside the matrices and store only inside them.
//
// Replaces repro/kernels/spike_matmul.py::spike_matmul_pallas, which walks a
// sequential (m, n, k) grid of 128-tiles padded to 128 with an f32 VMEM
// accumulator, and guards each k-step's MXU pass with
// pl.when(any(spike tile != 0)). Here the k loop runs inside the block: each
// block owns a 64 x 64 tile of out in registers (4 x 4 per thread, 256
// threads) and walks K in steps of 16. A step stages its 64 x 16 spike tile
// and 16 x 64 weight tile in shared memory as float32; __syncthreads_or over
// "my spike values are not all zero" is both the barrier and the event test,
// and a block whose spike tile is all zero skips that step's multiply-adds,
// as the Pallas kernel skips its MXU pass. The next step's tiles are loaded
// into registers while the current step computes. The multiply-adds are
// CUDA-core float32 FMAs: tensor cores would need TF32, which changes float32
// results, or bf16 operands; packing the binary spikes narrower and wgmma
// are later work. An optional counter receives the number of skipped
// (block, k-step) pairs.
//
// Bound: operations or bytes, by shape and density. A dense float32 product
// needs 2 M K N flops at 67 TFLOP/s; only nonzero spikes contribute, so the
// data needs 2 nnz(spikes) N. Bytes: spikes and w read once, out written
// once. At the im2col shapes of the Spike-VGG16 training step's convolutions
// (M = 8 H W, K = 9 Cin, N = Cout) the dense flops dominate for the deep
// layers, the bytes for the wide early ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;              // 16 x 16 threads, 4 x 4 outputs
constexpr int kLoads = kBM * kBK / kThreads;   // 4 spike values per thread
static_assert(kBK * kBN / kThreads == kLoads, "tile loads must balance");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ S,
                                           const T* __restrict__ W, int M,
                                           int K, int N, int m0, int n0,
                                           int k0, float (&a)[kLoads],
                                           float (&b)[kLoads]) {
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int am = m0 + i / kBK, ak = k0 + i % kBK;
    a[r] = (am < M && ak < K)
        ? to_f32(S[static_cast<int64_t>(am) * K + ak]) : 0.f;
    const int bk = k0 + i / kBN, bn = n0 + i % kBN;
    b[r] = (bk < K && bn < N)
        ? to_f32(W[static_cast<int64_t>(bk) * N + bn]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spike_mm_kernel(const T* __restrict__ S, const T* __restrict__ W,
                T* __restrict__ out, int M, int K, int N,
                unsigned long long* __restrict__ skipped) {
  __shared__ float As[kBK][kBM + 1];       // spike tile, transposed
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};
  float a[kLoads], b[kLoads];
  unsigned long long n_skipped = 0;
  const int n_steps = (K + kBK - 1) / kBK;
  if (n_steps > 0) load_tiles(S, W, M, K, N, m0, n0, 0, a, b);
  for (int step = 0; step < n_steps; ++step) {
    int events = 0;
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      As[i % kBK][i / kBK] = a[r];
      Bs[i / kBN][i % kBN] = b[r];
      events |= (a[r] != 0.f);
    }
    const bool any_events = __syncthreads_or(events) != 0;
    if (step + 1 < n_steps)
      load_tiles(S, W, M, K, N, m0, n0, (step + 1) * kBK, a, b);
    if (any_events) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else {
      ++n_skipped;
    }
    __syncthreads();                       // tiles are rewritten next step
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<int64_t>(m) * N + n] = from_f32<T>(acc[i][j]);
    }
  }
  if (skipped != nullptr && threadIdx.x == 0 && n_skipped > 0)
    atomicAdd(skipped, n_skipped);
}

template <typename T>
cudaError_t launch(const void* spikes, const void* w, void* out, int M, int K,
                   int N, void* skipped, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  spike_mm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(spikes), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N,
      static_cast<unsigned long long*>(skipped));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32, 1 bfloat16 (spikes, w and
// out alike). `skipped` is null or a device pointer to one 64-bit counter
// that the kernel adds its skipped (block, k-step) pairs to.
extern "C" int repro_spike_matmul(const void* spikes, const void* w,
                                  void* out, int M, int K, int N, int dtype,
                                  void* skipped, int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(spikes, w, out, M, K, N, skipped, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(spikes, w, out, M, K, N, skipped, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
