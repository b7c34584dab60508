// Fused LIF membrane update for Hopper (sm_90a).
//
//   hard reset: u' = ((decay * u) * (1 - s)) + I
//   soft reset: u' = ((decay * u) - (threshold * s)) + I
//   s' = (u' > threshold)
//
// u, s, I and both outputs hold n elements of one dtype (float32 or
// bfloat16), contiguous, in any shape: the kernel walks them flat. The math
// is float32; both outputs are rounded once to the input dtype.
//
// Replaces repro/kernels/lif.py::lif_step_pallas, which runs the same update
// on (256, 128) VMEM tiles of inputs that the wrapper first flattens and pads
// to [rows, 128]. That padding serves the TPU's vector layout only; here the
// kernel takes any element count and masks nothing but the tail.
//
// Bound: bytes. Each element reads u, s, I once and writes u', s' once:
// 20 bytes in float32 (10 in bfloat16) against 4 or 5 flops, far below the
// card's 67 TFLOP/s float32. At the largest state of the Spike-VGG16 training
// step (8 x 64 x 32 x 32 = 524,288 elements, 10.5 MB) that is about 3.1 us at
// 3.35 TB/s; the smaller states are bound by launch latency. Design: each
// thread moves 16 bytes per load and store (4 floats or 8 bfloat16) when all
// five pointers are 16-byte aligned, in a grid-stride loop; a scalar loop
// takes the tail and any unaligned call.
//
// Exactness: the arithmetic is written with __fmul_rn / __fsub_rn /
// __fadd_rn in the reference's order, so nvcc cannot contract it into an FMA,
// and the result is bit-identical to the plain PyTorch version (one rounded
// float32 operation after another). Build without --use_fast_math: flushing
// subnormals to zero would break u' > threshold <=> u' - threshold > 0, the
// identity that makes this spike equal the reference's spike(u' - threshold).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // 16 blocks per SM of the H100

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

template <typename T, bool kHard>
__device__ __forceinline__ void lif_one(T u, T s, T c, float threshold,
                                        float decay, T& u_out, T& s_out) {
  const float uf = to_f32(u), sf = to_f32(s), cf = to_f32(c);
  const float leak = __fmul_rn(decay, uf);
  const float un = kHard
      ? __fadd_rn(__fmul_rn(leak, __fsub_rn(1.0f, sf)), cf)
      : __fadd_rn(__fsub_rn(leak, __fmul_rn(threshold, sf)), cf);
  u_out = from_f32<T>(un);
  s_out = from_f32<T>(un > threshold ? 1.0f : 0.0f);
}

template <typename T, bool kHard>
__global__ void __launch_bounds__(kThreads)
lif_kernel(const T* __restrict__ u, const T* __restrict__ s,
           const T* __restrict__ c, T* __restrict__ u_out,
           T* __restrict__ s_out, int64_t n, float threshold, float decay,
           bool vectorized) {
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte access
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t n_vec = n / kVec;
    for (int64_t i = tid; i < n_vec; i += stride) {
      const uint4 ru = __ldg(reinterpret_cast<const uint4*>(u) + i);
      const uint4 rs = __ldg(reinterpret_cast<const uint4*>(s) + i);
      const uint4 rc = __ldg(reinterpret_cast<const uint4*>(c) + i);
      const T* pu = reinterpret_cast<const T*>(&ru);
      const T* ps = reinterpret_cast<const T*>(&rs);
      const T* pc = reinterpret_cast<const T*>(&rc);
      uint4 wu, ws;
      T* qu = reinterpret_cast<T*>(&wu);
      T* qs = reinterpret_cast<T*>(&ws);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        lif_one<T, kHard>(pu[j], ps[j], pc[j], threshold, decay, qu[j],
                          qs[j]);
      reinterpret_cast<uint4*>(u_out)[i] = wu;
      reinterpret_cast<uint4*>(s_out)[i] = ws;
    }
    done = n_vec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    lif_one<T, kHard>(u[i], s[i], c[i], threshold, decay, u_out[i],
                      s_out[i]);
}

template <typename T>
cudaError_t launch(const void* u, const void* s, const void* c, void* u_out,
                   void* s_out, int64_t n, float threshold, float decay,
                   bool hard, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(u) |
                        reinterpret_cast<uintptr_t>(s) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(u_out) |
                        reinterpret_cast<uintptr_t>(s_out);
  const bool vectorized = (any % 16) == 0;
  const int64_t per_thread = vectorized ? 16 / sizeof(T) : 1;
  const int64_t work = (n + per_thread - 1) / per_thread;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* pu = static_cast<const T*>(u);
  const T* ps = static_cast<const T*>(s);
  const T* pc = static_cast<const T*>(c);
  T* qu = static_cast<T*>(u_out);
  T* qs = static_cast<T*>(s_out);
  if (hard)
    lif_kernel<T, true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        pu, ps, pc, qu, qs, n, threshold, decay, vectorized);
  else
    lif_kernel<T, false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        pu, ps, pc, qu, qs, n, threshold, decay, vectorized);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32, 1 bfloat16; hard 1 is the
// hard reset, 0 the soft one. Pointers are device pointers to n contiguous
// elements each.
extern "C" int repro_lif_step(const void* u, const void* s, const void* c,
                              void* u_out, void* s_out, long long n,
                              float threshold, float decay, int hard,
                              int dtype, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(u, s, c, u_out, s_out, n, threshold, decay, hard != 0,
                        st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(u, s, c, u_out, s_out, n, threshold, decay,
                                hard != 0, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
