// Per-row link-traffic segment sum for Hopper (sm_90a), in two entries.
//
// repro_link_traffic, the TPU kernel's own contract:
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
//
// repro_link_traffic_routes, the same sum with the route gather fused in,
// which is what the scorer (core/noc_batch.py) computes:
//
//   out[b, l] = sum_{e, h} vol[e] * (routes[idx[b, e], h] == l)
//
// idx [B, E] int32 or int64 holds each edge's (src core, dst core) pair
// index into routes [P, H] int32, the padded link-id route table (pad id
// n_links); vol [E] float32. By definition it is repro_link_traffic of
// ids = routes[idx].reshape(B, E * H) and w = vol broadcast to [B, E, H],
// which the reference builds in device memory before its Pallas call
// (repro/core/noc_batch.py, backend "pallas"): two [B, E * H] tensors,
// 8.9 MB at the PPO rollout shape (B=256, E=310, H=14 on the 8x8 mesh),
// written once and read back by the segment sum. Here neither exists.
// Bound: bytes. The call must read idx (0.64 MB as int64 at that shape),
// the route rows it names (the 229 KB table at most, L2-resident across the
// B rows), vol and write out (0.26 MB): about 1.1 MB, 0.34 us at 3.35 TB/s.
// Design: one block per row b (and tile of the link axis, as above), bins in
// shared memory. Each warp takes 32 edges at a time: every lane loads one
// edge's idx and vol (coalesced; vol is read with the same load pattern and
// stays in L1/L2, so it is not staged in shared memory), then the warp walks
// the chunk's 32 x H (edge, hop) pairs flat, lane q taking pairs q, q + 32,
// ...: a pair's edge index and volume come from the owning lane by
// __shfl_sync, its link id from the route row through __ldg, so a warp
// instruction covers 32 / H edges with no lane idle past the route's end.
// Four route loads are issued before their four shared atomics, to keep
// loads in flight (eight spill registers to local memory and are no
// faster). The block has one warp per 32 edges (64 to 512 threads), so at
// the PPO shape each of the 256 blocks is 10 warps that each walk one
// chunk: the call is one dependent chain of idx load, route loads and adds.
// What bounds it is latency, not bytes: a float atomicAdd to shared memory
// is a compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS),
// which serialises lanes and warps that hit one link. Per-warp private bins
// with __match_any_sync to merge lanes, tried instead, were slower. An idx
// outside [0, P) traps (__trap, a device-side error, as the gather it
// replaces raises a device-side assert) before any route is read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

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

constexpr int kMaxRouteThreads = 512;
constexpr int kUnroll = 4;            // route loads issued before their adds
constexpr unsigned kFull = 0xffffffffu;

template <typename Idx>
__global__ void __launch_bounds__(kMaxRouteThreads)
link_traffic_routes_kernel(const Idx* __restrict__ idx,
                           const int32_t* __restrict__ routes,
                           const float* __restrict__ vol,
                           float* __restrict__ out, int E, int H,
                           int64_t n_pairs, int n_links, int tile) {
  extern __shared__ float bins[];
  const int64_t b = blockIdx.x;
  const int l0 = blockIdx.y * tile;
  const int len = min(tile, n_links - l0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) bins[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const Idx* row_idx = idx + b * E;
  // pair q = lane + 32 k of a chunk is (edge q / H, hop q % H); stepping q
  // by 32 steps the edge by 32 / H and the hop by 32 % H, with one carry
  const int step_e = 32 / H, step_h = 32 % H;
  for (int e0 = warp * 32; e0 < E; e0 += n_warps * 32) {
    const int n_e = min(32, E - e0);
    int row = 0;
    float v = 0.f;
    if (lane < n_e) {
      const long long i = __ldg(row_idx + e0 + lane);
      if (i < 0 || i >= n_pairs) __trap();
      row = static_cast<int>(i);
      v = __ldg(vol + e0 + lane);
    }
    int el = lane / H, h = lane % H;
    for (int k = 0; k < H; k += kUnroll) {
      int id[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int r = __shfl_sync(kFull, row, el & 31);
        w[j] = __shfl_sync(kFull, v, el & 31);
        id[j] = (k + j < H && el < n_e)
            ? __ldg(routes + static_cast<int64_t>(r) * H + h) : -1;
        el += step_e;
        h += step_h;
        if (h >= H) {
          h -= H;
          ++el;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        // one unsigned compare drops the pad id, negatives, other tiles'
        // ids and the -1 of a pair past the chunk
        const unsigned rel = static_cast<unsigned>(id[j] - l0);
        if (rel < static_cast<unsigned>(len)) atomicAdd(&bins[rel], w[j]);
      }
    }
  }
  __syncthreads();
  float* row_out = out + b * n_links + l0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) row_out[i] = bins[i];
}

int route_threads(int E) {
  const int warps = (E + 31) / 32;
  const int t = 32 * (warps < 2 ? 2 : warps);
  return t < kMaxRouteThreads ? t : kMaxRouteThreads;
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// row-major tensors.
extern "C" int repro_link_traffic(const void* ids, const void* w, void* out,
                                  int B, int K, int n_links, int device,
                                  void* stream) {
  if (B <= 0 || n_links <= 0) return 0;
  const int tile = n_links < kMaxTile ? n_links : kMaxTile;
  const dim3 grid(B, (n_links + tile - 1) / tile);
  return static_cast<int>(on_device(device, [&] {
    link_traffic_kernel<<<grid, kThreads, tile * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ids), static_cast<const float*>(w),
        static_cast<float*>(out), K, n_links, tile);
    return cudaGetLastError();
  }));
}

// The fused entry, on `stream` of `device`; returns the launch's
// cudaError_t. idx [B, E] (int64 when idx64, else int32), routes [P, H]
// int32, vol [E] float32, out [B, n_links] float32, all contiguous device
// memory; 1 <= H and P < 2^31. An idx outside [0, P) traps in the kernel.
extern "C" int repro_link_traffic_routes(const void* idx, int idx64,
                                         const void* routes, const void* vol,
                                         void* out, int B, int E, int H,
                                         long long P, int n_links, int device,
                                         void* stream) {
  if (B <= 0 || n_links <= 0) return 0;
  if (H <= 0 || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = n_links < kMaxTile ? n_links : kMaxTile;
  const dim3 grid(B, (n_links + tile - 1) / tile);
  const int threads = route_threads(E);
  const size_t smem = tile * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(routes);
  const float* v = static_cast<const float*>(vol);
  float* o = static_cast<float*>(out);
  return static_cast<int>(on_device(device, [&] {
    if (idx64)
      link_traffic_routes_kernel<long long><<<grid, threads, smem, st>>>(
          static_cast<const long long*>(idx), r, v, o, E, H, P, n_links, tile);
    else
      link_traffic_routes_kernel<int><<<grid, threads, smem, st>>>(
          static_cast<const int*>(idx), r, v, o, E, H, P, n_links, tile);
    return cudaGetLastError();
  }));
}

// Blocks of the fused kernel resident on one SM at the launch shape of
// (E, n_links), from the CUDA occupancy calculator; -1 on an error.
extern "C" int repro_link_traffic_routes_occupancy(int idx64, int E,
                                                   int n_links) {
  const int tile = n_links < kMaxTile ? n_links : kMaxTile;
  int blocks = -1;
  const cudaError_t err = idx64
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, link_traffic_routes_kernel<long long>, route_threads(E),
            tile * sizeof(float))
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, link_traffic_routes_kernel<int>, route_threads(E),
            tile * sizeof(float));
  return err == cudaSuccess ? blocks : -1;
}
