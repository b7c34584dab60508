// Per-chain O(degree) swap delta for Hopper (sm_90a).
//
//   out[r] = sum_k vol[r, k] * (hops[sa[r, k], da[r, k]] - hops[sb[r, k], db[r, k]])
//
// sb/db/sa/da [R, K] int32 hold the before/after (src, dst) cores of the K
// incident-edge entries of chain r's proposed swap; vol [R, K] float32 (0 on
// padding); hops [C, C] float32 row-major. out [R] float32. A core id outside
// [0, C) reads hop 0 (the reference's one-hot gather gives 0 there too), so
// the kernel never reads outside hops.
//
// Replaces repro/kernels/delta_cost.py::delta_cost_pallas, which turns both
// hop gathers into one-hot [bk, Cp] x [Cp, Cp] products on the TPU's matrix
// unit (about C times the work) over a 128-padded hop matrix and a K axis
// padded to its tile. Here the gathers are direct: one warp per chain, lanes
// striding K with neighbouring lanes on neighbouring entries, hops read
// through the read-only cache (16 KB at C=64, 4 MB at C=1024: L2-resident),
// and a float32 warp-shuffle reduction. No padding of C or K is needed.
//
// Bound: bytes. Each entry reads four ids and one volume once (20 bytes),
// plus the hop table once and one float out per chain: at the SA path's shape
// (R=64, K=32, C=64) that is 57 KB, about 0.02 us at 3.35 TB/s, so a launch
// there is bound by launch latency. The 3 flops per entry are negligible
// against 67 TFLOP/s float32. The warp reduction reorders the sum, so results
// are exact on integer volumes only while partial sums stay below 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 chains per block
constexpr int kWarp = 32;

__device__ __forceinline__ float hop(const float* __restrict__ hops, int s,
                                     int d, int C) {
  // one unsigned compare per endpoint rejects negatives and ids >= C
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(C) ||
      static_cast<unsigned>(d) >= static_cast<unsigned>(C))
    return 0.f;
  return __ldg(hops + static_cast<int64_t>(s) * C + d);
}

__global__ void delta_cost_kernel(const int32_t* __restrict__ sb,
                                  const int32_t* __restrict__ db,
                                  const int32_t* __restrict__ sa,
                                  const int32_t* __restrict__ da,
                                  const float* __restrict__ vol,
                                  const float* __restrict__ hops,
                                  float* __restrict__ out, int R, int K,
                                  int C) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= R) return;                     // uniform across the warp
  const int64_t base = r * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    const int64_t e = base + k;
    const float v = __ldg(vol + e);
    const float after = hop(hops, __ldg(sa + e), __ldg(da + e), C);
    const float before = hop(hops, __ldg(sb + e), __ldg(db + e), C);
    acc += v * (after - before);
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[r] = acc;
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// row-major tensors; `out` holds R floats.
extern "C" int repro_delta_cost(const void* sb, const void* db, const void* sa,
                                const void* da, const void* vol,
                                const void* hops, void* out, int R, int K,
                                int C, int device, void* stream) {
  if (R <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chains_per_block = kThreads / kWarp;
  const int blocks = (R + chains_per_block - 1) / chains_per_block;
  delta_cost_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sb), static_cast<const int32_t*>(db),
      static_cast<const int32_t*>(sa), static_cast<const int32_t*>(da),
      static_cast<const float*>(vol), static_cast<const float*>(hops),
      static_cast<float*>(out), R, K, C);
  return static_cast<int>(cudaGetLastError());
}
