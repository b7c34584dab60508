// Per-row link-traffic segment sum for Hopper (sm_90a).
//
//   out[b, l] = sum_k w[b, k] * (ids[b, k] == l),   0 <= l < n_links
//
// ids [B, K] int32 holds directed-link ids in [0, n_links]; id n_links is route
// padding and is dropped, as is any id outside [0, n_links). w [B, K] float32.
// out [B, n_links] float32.
//
// Replaces repro/kernels/noc_segsum.py::link_traffic_pallas, which recasts the
// sum as one-hot [1, bk] x [bk, L] matmuls on the TPU's matrix unit. Here the
// sum is a histogram: each block owns one row b and one tile of the link axis,
// kept as float32 bins in shared memory. Threads stride over K with
// neighbouring threads on neighbouring addresses, add into the bins with
// shared-memory atomics, and the block writes its tile out with plain stores.
// The grid is B x ceil(n_links / tile), so topologies with many links split
// the link axis across blocks (each block then rereads its row of ids/w).
//
// Bound: bytes. At the PPO rollout shape (B=256, K=4340, n_links=256) the call
// must read 8.9 MB of ids+w and write 0.26 MB, about 2.7 us at 3.35 TB/s; the
// B*K adds are negligible against the card's float32 rate. Float atomics add
// in a run-dependent order, so sums are exact only while every partial sum is
// an integer below 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8192;  // 32 KB of bins, under the 48 KB static limit

__global__ void link_traffic_kernel(const int32_t* __restrict__ ids,
                                    const float* __restrict__ w,
                                    float* __restrict__ out, int K,
                                    int n_links, int tile) {
  extern __shared__ float bins[];
  const int64_t b = blockIdx.x;
  const int l0 = blockIdx.y * tile;
  const int len = min(tile, n_links - l0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) bins[i] = 0.f;
  __syncthreads();
  const int32_t* row_ids = ids + b * K;
  const float* row_w = w + b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    // one unsigned compare drops the pad id, negatives and other tiles' ids
    const unsigned rel = static_cast<unsigned>(__ldg(row_ids + k) - l0);
    if (rel < static_cast<unsigned>(len)) atomicAdd(&bins[rel], __ldg(row_w + k));
  }
  __syncthreads();
  float* row_out = out + b * n_links + l0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) row_out[i] = bins[i];
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// row-major tensors.
extern "C" int repro_link_traffic(const void* ids, const void* w, void* out,
                                  int B, int K, int n_links, int device,
                                  void* stream) {
  if (B <= 0 || n_links <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = n_links < kMaxTile ? n_links : kMaxTile;
  const dim3 grid(B, (n_links + tile - 1) / tile);
  link_traffic_kernel<<<grid, kThreads, tile * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(w),
      static_cast<float*>(out), K, n_links, tile);
  return static_cast<int>(cudaGetLastError());
}
