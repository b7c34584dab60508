// Fused LIF membrane update and its backward for Hopper (sm_90a).
//
// Forward (repro_lif_step):
//   hard reset: u' = ((decay * u) * (1 - s)) + I
//   soft reset: u' = ((decay * u) - (threshold * s)) + I
//   s' = (u' > threshold)
//
// Backward (repro_lif_backward), the cotangents of one update given those of
// its outputs, g_u for u' and g_s for s' (either may be absent):
//   g   = g_u + g_s * surrogate(u' - threshold)    (the cotangent of u', and
//                                                   of I)
//   hard reset: d_u = decay * (g * (1 - s)),  d_s = -(g * (decay * u))
//   soft reset: d_u = decay * g,              d_s = -(threshold * g)
// with the surrogate one of
//   rect:    (|x| < alpha / 2) / alpha
//   sigmoid: (alpha * sigma) * (1 - sigma),  sigma = 1 / (1 + exp(-(alpha x)))
//   atan:    (1 / (2 * (1 + (c x)^2))) * alpha,  c = pi / 2 * alpha
// and d_u / d_s computed only where the caller asks for them.
//
// Every tensor holds n elements of one dtype (float32 or bfloat16),
// contiguous, in any shape: the kernels walk them flat. The math is float32.
//
// Replaces repro/kernels/lif.py::lif_step_pallas, which runs the forward on
// (256, 128) VMEM tiles of inputs that the wrapper first flattens and pads to
// [rows, 128]. That padding serves the TPU's vector layout only; here the
// kernels take any element count and mask nothing but the tail. The
// reference differentiates lif_step with JAX autodiff (XLA fuses the
// backward into one loop); the port's backward was about 13 separate torch
// operations, each a launch, and is one launch here.
//
// Bound: bytes. The forward reads u, s, I once and writes u', s' once: 20
// bytes an element in float32 (10 in bfloat16) against 4 or 5 flops, far
// below the card's 67 TFLOP/s float32. The backward reads g_u, g_s, u, s, u'
// and writes d_u, d_s, g: 32 bytes an element in float32 with every input
// present and every output asked for, less otherwise (a soft reset reads
// neither u nor s; with g_s absent, g is g_u and is not written), against
// about 10 flops (sigmoid and atan add an exp or a division). At the largest
// state of the Spike-VGG16 training step (8 x 64 x 32 x 32 = 524,288
// elements) that is about 3.1 us forward and 5.0 us backward at 3.35 TB/s;
// the smaller states are bound by launch latency. Design: each thread moves
// 16 bytes per load and store (4 floats or 8 bfloat16) when every pointer is
// 16-byte aligned, in a grid-stride loop; a scalar loop takes the tail and
// any unaligned call. The backward is templated on the reset, the
// surrogate and which cotangents are present, so an absent input costs
// neither a load nor a branch.
//
// Exactness: the arithmetic is written with __fmul_rn / __fsub_rn /
// __fadd_rn / __fdiv_rn in the plain version's order, so nvcc cannot
// contract it into an FMA. The forward rounds once to the storage dtype.
// The backward rounds every intermediate to the storage dtype, as each torch
// operation of the plain version stores its result: in float32 that is the
// identity and the rect result is bit for bit the plain version's; in
// bfloat16 the rect window sees the same rounded u' - threshold as the plain
// version, so no element near the window's edge lands on the other side of
// it. The Python constants enter as float32, and the window's half-width is
// rounded to the storage dtype, as PyTorch rounds a comparison's scalar
// (its arithmetic kernels differ in whether they round a scalar first, so
// bfloat16 results are held to a tolerance, not claimed equal). sigmoid and
// atan call expf and divide as PyTorch's kernels do, but their bits are not
// claimed equal either. Build without --use_fast_math: flushing
// subnormals to zero would break u' > threshold <=> u' - threshold > 0, the
// identity that makes this spike equal the reference's spike(u' - threshold).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // 16 blocks per SM of the H100

enum Surrogate { kRect = 0, kSigmoid = 1, kAtan = 2 };

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
// x rounded to T and back: what a torch operation stores in a T tensor
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

int64_t grid_for(int64_t n, bool vectorized, int elem_bytes) {
  const int64_t per_thread = vectorized ? 16 / elem_bytes : 1;
  const int64_t work = (n + per_thread - 1) / per_thread;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return (any % 16) == 0;
}

// ---- forward ----------------------------------------------------------------

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
  const bool vectorized = aligned16({u, s, c, u_out, s_out});
  const int blocks = static_cast<int>(grid_for(n, vectorized, sizeof(T)));
  const T* pu = static_cast<const T*>(u);
  const T* ps = static_cast<const T*>(s);
  const T* pc = static_cast<const T*>(c);
  T* qu = static_cast<T*>(u_out);
  T* qs = static_cast<T*>(s_out);
  if (hard)
    lif_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        pu, ps, pc, qu, qs, n, threshold, decay, vectorized);
  else
    lif_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        pu, ps, pc, qu, qs, n, threshold, decay, vectorized);
  return cudaGetLastError();
}

// ---- backward ---------------------------------------------------------------

// Device pointers (null where absent or not asked for) and the constants,
// each rounded once from Python's double to float.
struct BwdArgs {
  const void* g_u;
  const void* g_s;
  const void* u;
  const void* s;
  const void* u_new;
  void* d_u;
  void* d_s;
  void* g;
  int64_t n;
  float threshold, decay, half_alpha, alpha, atan_scale;
};

template <typename T, int kSur>
__device__ __forceinline__ float surrogate(float x, const BwdArgs& a) {
  if (kSur == kRect) {
    const float inside = fabsf(x) < rnd<T>(a.half_alpha) ? 1.0f : 0.0f;
    return rnd<T>(__fdiv_rn(inside, a.alpha));
  }
  if (kSur == kSigmoid) {
    const float z = rnd<T>(__fmul_rn(a.alpha, x));
    const float sig = rnd<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
    return rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(a.alpha, sig)),
                            rnd<T>(__fsub_rn(1.0f, sig))));
  }
  const float y = rnd<T>(__fmul_rn(a.atan_scale, x));
  const float den = rnd<T>(__fmul_rn(
      2.0f, rnd<T>(__fadd_rn(1.0f, rnd<T>(__fmul_rn(y, y))))));
  return rnd<T>(__fmul_rn(rnd<T>(__fdiv_rn(1.0f, den)), a.alpha));
}

// One element: the cotangent g of u' and, where asked for, d_u and d_s.
template <typename T, bool kHard, int kSur, bool kHasGU, bool kHasGS>
__device__ __forceinline__ void grad_one(float gu, float gs, float u, float s,
                                         float un, const BwdArgs& a,
                                         bool need_u, bool need_s, float& g,
                                         float& du, float& ds) {
  if (kHasGS) {
    const float x = rnd<T>(__fsub_rn(un, a.threshold));
    const float g_spike = rnd<T>(__fmul_rn(gs, surrogate<T, kSur>(x, a)));
    g = kHasGU ? rnd<T>(__fadd_rn(gu, g_spike)) : g_spike;
  } else {
    g = gu;
  }
  const float decay = a.decay;
  if (need_u)
    du = kHard ? rnd<T>(__fmul_rn(decay, rnd<T>(__fmul_rn(
                     g, rnd<T>(__fsub_rn(1.0f, s))))))
               : rnd<T>(__fmul_rn(decay, g));
  if (need_s)
    ds = kHard ? -rnd<T>(__fmul_rn(g, rnd<T>(__fmul_rn(decay, u))))
               : -rnd<T>(__fmul_rn(a.threshold, g));
}

template <typename T, bool kHard, int kSur, bool kHasGU, bool kHasGS>
__global__ void __launch_bounds__(kThreads)
lif_backward_kernel(BwdArgs a, bool vectorized) {
  constexpr int kVec = 16 / sizeof(T);
  const T* __restrict__ gu = static_cast<const T*>(a.g_u);
  const T* __restrict__ gs = static_cast<const T*>(a.g_s);
  const T* __restrict__ u = static_cast<const T*>(a.u);
  const T* __restrict__ s = static_cast<const T*>(a.s);
  const T* __restrict__ un = static_cast<const T*>(a.u_new);
  T* __restrict__ du = static_cast<T*>(a.d_u);
  T* __restrict__ ds = static_cast<T*>(a.d_s);
  T* __restrict__ g = static_cast<T*>(a.g);
  const bool need_u = du != nullptr, need_s = ds != nullptr;
  const bool read_s = kHard && need_u, read_u = kHard && need_s;
  const int64_t n = a.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t n_vec = n / kVec;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    auto load = [](const T* p, int64_t i) {
      return __ldg(reinterpret_cast<const uint4*>(p) + i);
    };
    for (int64_t i = tid; i < n_vec; i += stride) {
      const uint4 r_gu = kHasGU ? load(gu, i) : zero;
      const uint4 r_gs = kHasGS ? load(gs, i) : zero;
      const uint4 r_un = kHasGS ? load(un, i) : zero;
      const uint4 r_u = read_u ? load(u, i) : zero;
      const uint4 r_s = read_s ? load(s, i) : zero;
      const T* p_gu = reinterpret_cast<const T*>(&r_gu);
      const T* p_gs = reinterpret_cast<const T*>(&r_gs);
      const T* p_un = reinterpret_cast<const T*>(&r_un);
      const T* p_u = reinterpret_cast<const T*>(&r_u);
      const T* p_s = reinterpret_cast<const T*>(&r_s);
      uint4 w_g, w_du, w_ds;
      T* q_g = reinterpret_cast<T*>(&w_g);
      T* q_du = reinterpret_cast<T*>(&w_du);
      T* q_ds = reinterpret_cast<T*>(&w_ds);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float gj = 0.f, duj = 0.f, dsj = 0.f;
        grad_one<T, kHard, kSur, kHasGU, kHasGS>(
            to_f32(p_gu[j]), to_f32(p_gs[j]), to_f32(p_u[j]), to_f32(p_s[j]),
            to_f32(p_un[j]), a, need_u, need_s, gj, duj, dsj);
        q_g[j] = from_f32<T>(gj);
        q_du[j] = from_f32<T>(duj);
        q_ds[j] = from_f32<T>(dsj);
      }
      if (kHasGS) reinterpret_cast<uint4*>(g)[i] = w_g;
      if (need_u) reinterpret_cast<uint4*>(du)[i] = w_du;
      if (need_s) reinterpret_cast<uint4*>(ds)[i] = w_ds;
    }
    done = n_vec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float gi = 0.f, dui = 0.f, dsi = 0.f;
    grad_one<T, kHard, kSur, kHasGU, kHasGS>(
        kHasGU ? to_f32(gu[i]) : 0.f, kHasGS ? to_f32(gs[i]) : 0.f,
        read_u ? to_f32(u[i]) : 0.f, read_s ? to_f32(s[i]) : 0.f,
        kHasGS ? to_f32(un[i]) : 0.f, a, need_u, need_s, gi, dui, dsi);
    if (kHasGS) g[i] = from_f32<T>(gi);
    if (need_u) du[i] = from_f32<T>(dui);
    if (need_s) ds[i] = from_f32<T>(dsi);
  }
}

template <typename T, bool kHard, int kSur, bool kHasGU, bool kHasGS>
cudaError_t launch_backward(const BwdArgs& a, cudaStream_t stream) {
  const bool vectorized = aligned16({a.g_u, a.g_s, a.u, a.s, a.u_new, a.d_u,
                                     a.d_s, a.g});
  const int blocks = static_cast<int>(grid_for(a.n, vectorized, sizeof(T)));
  lif_backward_kernel<T, kHard, kSur, kHasGU, kHasGS>
      <<<blocks, kThreads, 0, stream>>>(a, vectorized);
  return cudaGetLastError();
}

// the cotangents present: g_s (with or without g_u), or g_u alone, where the
// surrogate plays no part and g is g_u itself
template <typename T, bool kHard, int kSur>
cudaError_t pick_inputs(const BwdArgs& a, cudaStream_t stream) {
  if (a.g_s == nullptr)
    return launch_backward<T, kHard, kRect, true, false>(a, stream);
  if (a.g_u == nullptr)
    return launch_backward<T, kHard, kSur, false, true>(a, stream);
  return launch_backward<T, kHard, kSur, true, true>(a, stream);
}

template <typename T, bool kHard>
cudaError_t pick_surrogate(const BwdArgs& a, int sur, cudaStream_t stream) {
  switch (sur) {
    case kRect: return pick_inputs<T, kHard, kRect>(a, stream);
    case kSigmoid: return pick_inputs<T, kHard, kSigmoid>(a, stream);
    case kAtan: return pick_inputs<T, kHard, kAtan>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_backward_any(const BwdArgs& a, bool hard, int sur,
                                cudaStream_t stream) {
  return hard ? pick_surrogate<T, true>(a, sur, stream)
              : pick_surrogate<T, false>(a, sur, stream);
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    return dtype == 0
        ? launch<float>(u, s, c, u_out, s_out, n, threshold, decay, hard != 0,
                        st)
        : launch<__nv_bfloat16>(u, s, c, u_out, s_out, n, threshold, decay,
                                hard != 0, st);
  }));
}

// The backward of one repro_lif_step, on `stream` of `device`; returns the
// launch's cudaError_t. g_u or g_s may be null (not both): an absent
// cotangent counts as zero. g (the cotangent of u' and of I) is written only
// when g_s is present (else it is g_u) and must then be non-null; d_u and
// d_s are written where non-null. u is read only for d_s of a hard reset, s
// only for d_u of a hard reset, u_new only with g_s. surrogate 0 is rect, 1
// sigmoid, 2 atan; half_alpha, alpha and atan_scale are alpha / 2, alpha and
// pi / 2 * alpha, each rounded once from double to float.
extern "C" int repro_lif_backward(const void* g_u, const void* g_s,
                                  const void* u, const void* s_prev,
                                  const void* u_new, void* d_u, void* d_s,
                                  void* g, long long n, float threshold,
                                  float decay, float half_alpha, float alpha,
                                  float atan_scale, int hard, int surrogate,
                                  int dtype, int device, void* stream) {
  if (n <= 0) return 0;
  if ((g_u == nullptr && g_s == nullptr) || (g_s != nullptr && g == nullptr) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{g_u, g_s, u, s_prev, u_new, d_u, d_s, g_s ? g : nullptr, n,
                  threshold, decay, half_alpha, alpha, atan_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    return dtype == 0
        ? launch_backward_any<float>(a, hard != 0, surrogate, st)
        : launch_backward_any<__nv_bfloat16>(a, hard != 0, surrogate, st);
  }));
}
