// Event-driven spike matmul for Hopper (sm_90a), on the tensor cores.
//
//   out[M, N] = spikes[M, K] @ w[K, N]      spikes in {0, 1}
//
// spikes and w are both float32 or both bfloat16, contiguous row-major; the
// sum is float32 and out is written in w's dtype. No dimension is padded in
// device memory: edge tiles stage zeros outside the matrices and store only
// inside them.
//
// Replaces repro/kernels/spike_matmul.py::spike_matmul_pallas, which walks a
// sequential (m, n, k) grid of 128-tiles padded to 128 with an f32 VMEM
// accumulator, and guards each k-step's MXU pass with
// pl.when(any(spike tile != 0)). Here a block of 8 warps (2 x 4, each a
// 32 x 16 tile) owns a 64 x 64 tile of out, float32 accumulators in
// registers, and walks K in steps of 64 through a three-stage ring of
// 16-byte cp.async copies, so two steps' loads are in flight while one
// computes. The tiles land in shared memory as they lie in device memory
// (rows padded so that the fragment reads hit distinct banks), and each
// warp builds its mma.sync m16n8k16 bf16 fragments from them in registers.
//
// Events. A warp loads its spike fragments of the whole step first; if they
// are all zero (a warp vote) it skips the step's MMAs, as the Pallas kernel
// skips its MXU pass. The one barrier of each step, __syncthreads_or, also
// ORs the previous step's spikes over the block, which counts the skipped
// (64 x 64 tile, k-step) pairs exactly as zero_tiles() does; an optional
// counter receives that count.
//
// Operands. Spikes in {0, 1} are exact in bf16, as is any spike value bf16
// represents (0.5, 2, ...), so the spike operand loses nothing. A float32
// weight is cut on the fly into three bf16 terms, the 8-bit slices of its
// significand, w = hi + mid + lo exactly (for |w| >= 2^-110); each term is
// one MMA, and the products are exact. Two terms would leave up to 2^-15
// |w|, random in sign: over the ~700 events of a Spike-VGG16 deep-layer
// output that is about 1e-4, the checks' own tolerance where outputs cancel
// to near zero (two rounded terms, measured on an H100, missed it). Each
// step's products go to a fresh
// tensor-core accumulator that float32 adds then fold into the running sum,
// so the tensor cores' own accumulation rounds within one step only. bf16
// weights take one term. The split is done on load, in registers: a
// pre-pass would read w and write three bf16 copies (K N 10 bytes more a
// call) where the deep layers, whose bytes are mostly weights, are bound
// by bytes.
//
// Split-K. The deep Spike-VGG16 layers (M = 32 or 128, K = 4608, N = 512)
// have 8-16 output tiles for 132 SMs, so the wrapper splits K across
// blocks (blockIdx.z) when there are fewer than 128 output tiles: each split
// writes its float32 partial tile to a scratch [splits, M, N] that the
// wrapper allocates, and a second kernel sums the splits in order 0, 1, ...
// and writes out. No float atomics: results are the same from run to run.
//
// Bound: bytes at the im2col shapes of the Spike-VGG16 training step's
// convolutions (M = 8 H W, K = 9 Cin, N = Cout): spikes and w read once and
// out written once, against 2 nnz(spikes) N flops the data needs. Later
// work: TMA bulk loads with warp-specialised producers (the loads, not the
// MMAs, hold it back), spikes packed narrower than float32 by the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kWarpsM = 2, kWarpsN = 4;   // warps along M and N
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;    // m16 tiles of a warp
constexpr int kNT = kBN / kWarpsN / 8;     // n8 tiles of a warp
constexpr int kStages = 3;
constexpr int kKK = kBK / 16;              // k16 MMA steps a k-step

// Shared row strides, in elements of T, padded so that the fragment reads
// below hit distinct banks: a spike pair (row g, k 2t..2t+1) at g * A + 2t,
// a weight (k, n) at k * B + n with k = 2t (+1, +8, +9) and n = g.
template <typename T> struct Ld;
template <> struct Ld<float> {
  static constexpr int A = kBK + 8, B = kBN + 4;
};
template <> struct Ld<__nv_bfloat16> {
  static constexpr int A = kBK + 8, B = kBN + 8;
};

template <typename T>
struct Stage {
  T a[kBM * Ld<T>::A];                     // spikes [64][64], as stored
  T b[kBK * Ld<T>::B];                     // weights [64][64], as stored
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Two neighbouring spikes p[0], p[1] as one bf16x2 register (nearest even:
// exact for values bf16 represents); `bits` collects their magnitude bits,
// nonzero once any spike is (x != 0 is |x|'s bits != 0).
__device__ __forceinline__ uint32_t spike_pair(const float* p,
                                               uint32_t& bits) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  bits |= (__float_as_uint(v.x) | __float_as_uint(v.y)) & 0x7fffffffu;
  return tc::pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t spike_pair(const __nv_bfloat16* p,
                                               uint32_t& bits) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  bits |= v & 0x7fff7fffu;
  return v;
}

// The B register of weights (x0, x1) (k 2t and 2t + 1 of one column) as
// kTerms bf16x2 registers whose sum is (x0, x1). A float32 weight is cut
// into three 8-bit slices of its significand: hi is w with its low 16 bits
// cleared (a bf16 value), mid the same of w - hi, lo what is left, which
// has at most 8 significant bits; each difference is exact, so w = hi +
// mid + lo exactly while every remainder is a normal float32 (|w| >=
// 2^-110). A bf16 weight is one term. Each slice is the upper halves of two
// floats, one byte permute.
template <int kTerms>
__device__ __forceinline__ void weight_terms(float x0, float x1,
                                             uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
    t[i] = __byte_perm(u0, u1, 0x7632);
    x0 -= __uint_as_float(u0 & 0xffff0000u);
    x1 -= __uint_as_float(u1 & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The k-step at k0 into one stage: the 64 x 32 spike tile and the 32 x 64
// weight tile, zeros outside the matrices. `vec` (K and N multiples of 16
// bytes' worth of T, pointers on 16 bytes) takes 16-byte cp.async copies;
// otherwise element-wise loads and stores.
template <typename T>
__device__ __forceinline__ void load_stage(Stage<T>& st, const T* S,
                                           const T* W, int M, int K, int N,
                                           int m0, int n0, int k0, bool vec) {
  constexpr int E = 16 / sizeof(T), LA = Ld<T>::A, LB = Ld<T>::B;
  if (vec) {
    for (int i = threadIdx.x; i < kBM * kBK / E; i += kThreads) {
      const int r = i / (kBK / E), c = (i % (kBK / E)) * E;
      const int m = m0 + r, kk = k0 + c;
      const bool in = m < M && kk < K;
      tc::cp_async_16(st.a + r * LA + c,
                      in ? S + static_cast<int64_t>(m) * K + kk : S,
                      in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kBK * kBN / E; i += kThreads) {
      const int r = i / (kBN / E), c = (i % (kBN / E)) * E;
      const int kk = k0 + r, n = n0 + c;
      const bool in = kk < K && n < N;
      tc::cp_async_16(st.b + r * LB + c,
                      in ? W + static_cast<int64_t>(kk) * N + n : W,
                      in ? 16 : 0);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK, m = m0 + r, kk = k0 + c;
      st.a[r * LA + c] =
          (m < M && kk < K) ? S[static_cast<int64_t>(m) * K + kk] : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN, kk = k0 + r, n = n0 + c;
      st.b[r * LB + c] =
          (kk < K && n < N) ? W[static_cast<int64_t>(kk) * N + n] : zero;
    }
  }
}

// Split z of blockIdx.z takes k-steps [z sps, min((z + 1) sps, steps)).
// With `part` null the block writes out; otherwise its float32 partial goes
// to part[z][M][N].
template <typename T>
__global__ void __launch_bounds__(kThreads)
spike_mma_kernel(const T* __restrict__ S, const T* __restrict__ W,
                 T* __restrict__ out, float* __restrict__ part, int M, int K,
                 int N, int sps, int vec,
                 unsigned long long* __restrict__ skipped) {
  constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;
  constexpr int LA = Ld<T>::A, LB = Ld<T>::B;
  extern __shared__ uint4 smem_raw[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp / kWarpsN) * (kBM / kWarpsM);
  const int wn = (warp % kWarpsN) * (kBN / kWarpsN);
  const bool rows = m0 + wm < M;           // a warp past M has no MMAs
  const int steps = (K + kBK - 1) / kBK;
  const int s_lo = blockIdx.z * sps, s_hi = min(s_lo + sps, steps);
  const int n = max(s_hi - s_lo, 0);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  unsigned long long n_skipped = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n)
      load_stage(ring[st], S, W, M, K, N, m0, n0, (s_lo + st) * kBK, vec);
    tc::cp_async_commit();
  }
  bool events = false;                     // this thread's spikes, last step
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<kStages - 2>();      // step i has landed
    // the barrier that publishes step i also tells whether step i - 1's
    // spike tile held an event anywhere in the block
    const bool any_before = __syncthreads_or(events) != 0;
    if (i > 0 && !any_before) ++n_skipped;
    // refill the stage read one step ago
    if (i + kStages - 1 < n)
      load_stage(ring[(i + kStages - 1) % kStages], S, W, M, K, N, m0, n0,
                 (s_lo + i + kStages - 1) * kBK, vec);
    tc::cp_async_commit();
    const Stage<T>& st = ring[i % kStages];

    // A fragments of the warp's rows over the whole k-step: the warp's
    // event test
    uint32_t a[kKK][kMT][4];
    uint32_t bits = 0;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const T* p = st.a + (wm + mt * 16 + g) * LA + kk * 16 + 2 * t;
        a[kk][mt][0] = spike_pair(p, bits);
        a[kk][mt][1] = spike_pair(p + 8 * LA, bits);
        a[kk][mt][2] = spike_pair(p + 8, bits);
        a[kk][mt][3] = spike_pair(p + 8 * LA + 8, bits);
      }
    events = bits != 0;
    if (!rows || !__any_sync(0xffffffffu, events)) continue;

    // the step's products go to a fresh tensor-core accumulator, added to
    // acc with float32 adds, so that the tensor cores' own accumulation
    // rounds within one step only
    float fresh[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const T* p = st.b + (kk * 16 + 2 * t) * LB + wn + j * 8 + g;
        uint32_t b0[kTerms], b1[kTerms];
        weight_terms<kTerms>(to_f32(p[0]), to_f32(p[LB]), b0);
        weight_terms<kTerms>(to_f32(p[8 * LB]), to_f32(p[9 * LB]), b1);
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            tc::mma_bf16(fresh[mt][j], a[kk][mt], b0[u], b1[u]);
      }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += fresh[mt][j][e];
  }
  if (n > 0 && __syncthreads_or(events) == 0) ++n_skipped;
  tc::cp_async_wait<0>();

  float* pz = part == nullptr ? nullptr
                              : part + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + g + (e / 2) * 8;
        const int c = n0 + wn + j * 8 + 2 * t + (e % 2);
        if (m >= M || c >= N) continue;
        const int64_t idx = static_cast<int64_t>(m) * N + c;
        if (pz != nullptr)
          pz[idx] = acc[mt][j][e];
        else
          out[idx] = from_f32<T>(acc[mt][j][e]);
      }
  if (skipped != nullptr && threadIdx.x == 0 && n_skipped > 0)
    atomicAdd(skipped, n_skipped);
}

// out = sum over z of part[z], in order z = 0, 1, ...
template <typename T>
__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, int64_t mn,
                                  int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < mn; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * mn + i];
    out[i] = from_f32<T>(s);
  }
}

bool on16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* spikes, const void* w, void* out, void* part,
                   int M, int K, int N, int splits, int sps, void* skipped,
                   cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int vec = K % E == 0 && N % E == 0 && on16(spikes) && on16(w);
  constexpr int bytes = static_cast<int>(kStages * sizeof(Stage<T>));
  auto kern = spike_mma_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(spikes), static_cast<const T*>(w),
      static_cast<T*>(out), p, M, K, N, sps, vec,
      static_cast<unsigned long long*>(skipped));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return err;
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int64_t want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  splitk_sum_kernel<T><<<blocks, 256, 0, stream>>>(p, static_cast<T*>(out),
                                                   mn, splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32, 1 bfloat16 (spikes, w and
// out alike). With splits > 1, K is split into `splits` ranges of
// `steps_per_split` 32-deep k-steps and `scratch` is a float32 device buffer
// of splits * M * N elements; with splits == 1 it may be null. `skipped` is
// null or a device pointer to one 64-bit counter that the kernel adds its
// skipped (block, k-step) pairs to.
extern "C" int repro_spike_matmul(const void* spikes, const void* w,
                                  void* out, void* scratch, int M, int K,
                                  int N, int splits, int steps_per_split,
                                  int dtype, void* skipped, int device,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || splits < 1 || splits > 65535 || steps_per_split < 1 ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(spikes, w, out, scratch, M, K, N, splits,
                        steps_per_split, skipped, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(spikes, w, out, scratch, M, K, N, splits,
                                steps_per_split, skipped, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
