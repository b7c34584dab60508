// Rotary position embedding (RoPE) for Hopper (sm_90a), forward and inverse.
//
// For x [B, S, H, D] (D even, any strides with a contiguous last dim),
// positions p of [S] (shared by every batch row) or [B, S], int32 or int64,
// and freq [D/2] float32 (kernels/rope.py's rope_freqs, computed by torch):
//
//   angle_i = float(p) * freq_i,   c_i = cosf(angle_i),   s_i = sinf(angle_i)
//   y[..., i]       = x[..., i] * c_i - x[..., i + D/2] * s_i
//   y[..., i + D/2] = x[..., i + D/2] * c_i + x[..., i] * s_i
//
// and the inverse, the rotation by -angle, which is the backward of the same
// map given the output's cotangent d:
//
//   dx[..., i]       = (d[..., i] * c_i + d[..., i + D/2] * s_i) + 0
//   dx[..., i + D/2] = (d[..., i + D/2] * c_i - d[..., i] * s_i) + 0
//
// in float32, each result rounded once to x's dtype (float32, bfloat16 or
// float16); y is written with its own strides (the wrapper gives a new
// contiguous tensor).
//
// Replaces no Pallas kernel: the reference computes RoPE in plain JAX
// (repro/models/layers.py:38, apply_rope), which XLA fuses into one loop.
// The port's torch version was about 18 launches a call forward (the angles,
// cos and sin rebuilt every call, a float32 copy of x, four products, two
// sums, a cat and a cast) and about 14 in autograd's backward (two of them
// slice_backward writing zero-filled float32 tensors of the whole head
// dim). Here each direction is one launch.
//
// Bound: bytes. A call reads x once and writes y once, 2 * B * S * H * D *
// sizeof(T) bytes; the angles and their cos and sin are D/2 values a
// position, computed on the chip. At internlm2-1.8b's training shape, q
// [32, 4096, 16, 128] bf16 is 537 MB each way: 0.32 ms at 3.35 TB/s, k half
// that. The 10 flops an element are far below the card's float32 rate.
//
// Design. One block per position s (and batch slice): its first D/2 threads
// compute the position's angles, cos and sin once into shared memory, and
// every head of every batch row of the block reuses them, so no table of
// the tensor's size is read. Each thread takes one chunk of 8 pairs (i,
// i + D/2) and keeps its 8 cos and 8 sin in registers; it walks the block's
// (batch row, head) rows with a fixed stride, moving 16 bytes per load and
// store (two of each in float32), neighbouring threads on neighbouring
// chunks of a head. That vector path needs D/2 a multiple of 8 and every
// pointer and stride on 16 bytes; any other even D up to 256 (or a view off
// 16 bytes) takes a pair a thread. Where positions are shared the grid is
// S x ceil(B / rows) blocks, with the batch rows split just enough for two
// waves of 8 blocks on each of the 132 SMs (internlm2: 4096 blocks of 32
// rows); with [B, S] positions each block takes one batch row.
//
// Exactness: the same numbers as the torch ops (rope_plain). The angle is
// float(p) rounded once times freq (__fmul_rn); cosf and sinf are CUDA's
// accurate ones, as torch.cos and torch.sin call them on the card (build
// without --use_fast_math); products and sums are __fmul_rn / __fadd_rn /
// __fsub_rn in the torch ops' order, so nvcc cannot contract them into an
// FMA. The inverse adds +0 last: autograd's backward sums the two halves'
// zero-filled slice gradients, which turns a -0 into +0. Conversions round to
// nearest even (__float2bfloat16_rn, __float2half_rn), as torch's casts do.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 8;                 // pairs a thread on the vector path
constexpr int kMaxHalf = 128;             // D / 2, up to D 256
constexpr int64_t kWaveBlocks = 2 * 132 * 8;

struct Args {
  const void* x;
  void* y;
  const void* pos;
  const float* freqs;
  int64_t b, s, h;
  int half;                               // D / 2
  int64_t xsb, xss, xsh;                  // strides of x, in elements
  int64_t ysb, yss, ysh;                  // strides of y
  int64_t psb, pss;                       // strides of positions (psb 0: shared)
  int64_t rows_per_block;                 // batch rows a block
  int pos64;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// W elements of T moved by one load or store: 16 bytes (two in float32)
// on the vector path, one element otherwise
template <typename T, int W>
struct alignas(W == 1 ? alignof(T) : 16) Vec {
  T v[W];
};

// blockIdx.x: the position s; blockIdx.y: the slice of batch rows. The
// block's threads are (chunk, row) pairs: chunk = threadIdx.x % chunks,
// first row threadIdx.x / chunks, rows stepping by blockDim.x / chunks.
template <typename T, int W, bool kInverse>
__global__ void __launch_bounds__(kThreads) rope_kernel(const Args a) {
  __shared__ float table[2 * kMaxHalf];   // cos, then sin
  const int64_t s = blockIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * a.rows_per_block;
  const int64_t pidx = b0 * a.psb + s * a.pss;
  const float p = a.pos64
      ? static_cast<float>(static_cast<const long long*>(a.pos)[pidx])
      : static_cast<float>(static_cast<const int*>(a.pos)[pidx]);
  for (int i = threadIdx.x; i < a.half; i += blockDim.x) {
    const float angle = __fmul_rn(p, a.freqs[i]);
    table[i] = cosf(angle);
    table[kMaxHalf + i] = sinf(angle);
  }
  __syncthreads();

  const int chunks = a.half / W;
  const int c = threadIdx.x % chunks;
  const int step = blockDim.x / chunks;
  float cs[W], sn[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    cs[j] = table[c * W + j];
    sn[j] = table[kMaxHalf + c * W + j];
  }
  const int64_t left = a.b - b0;
  const int h = static_cast<int>(a.h);
  const int rows =
      static_cast<int>(left < a.rows_per_block ? left : a.rows_per_block) * h;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ y = static_cast<T*>(a.y);
#pragma unroll 2
  for (int r = threadIdx.x / chunks; r < rows; r += step) {
    const int64_t bb = b0 + r / h;
    const int64_t hh = r % h;
    const T* xr = x + bb * a.xsb + s * a.xss + hh * a.xsh + c * W;
    T* yr = y + bb * a.ysb + s * a.yss + hh * a.ysh + c * W;
    const Vec<T, W> v1 = *reinterpret_cast<const Vec<T, W>*>(xr);
    const Vec<T, W> v2 = *reinterpret_cast<const Vec<T, W>*>(xr + a.half);
    Vec<T, W> o1, o2;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float x1 = to_f32(v1.v[j]);
      const float x2 = to_f32(v2.v[j]);
      float r1, r2;
      if constexpr (kInverse) {
        r1 = __fadd_rn(__fadd_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j])),
                       0.0f);
        r2 = __fadd_rn(__fsub_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j])),
                       0.0f);
      } else {
        r1 = __fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j]));
        r2 = __fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j]));
      }
      o1.v[j] = from_f32<T>(r1);
      o2.v[j] = from_f32<T>(r2);
    }
    *reinterpret_cast<Vec<T, W>*>(yr) = o1;
    *reinterpret_cast<Vec<T, W>*>(yr + a.half) = o2;
  }
}

template <typename T, int W>
cudaError_t launch_width(const Args& a, bool inverse, dim3 grid, int threads,
                         cudaStream_t stream) {
  if (inverse)
    rope_kernel<T, W, true><<<grid, threads, 0, stream>>>(a);
  else
    rope_kernel<T, W, false><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool on16(int64_t bytes) { return bytes % 16 == 0; }

template <typename T>
cudaError_t launch(Args a, bool inverse, cudaStream_t stream) {
  const int64_t e = sizeof(T);
  const bool vec =
      a.half % kPairs == 0 &&
      on16(static_cast<int64_t>(reinterpret_cast<uintptr_t>(a.x))) &&
      on16(static_cast<int64_t>(reinterpret_cast<uintptr_t>(a.y))) &&
      on16(a.xsb * e) && on16(a.xss * e) && on16(a.xsh * e) &&
      on16(a.ysb * e) && on16(a.yss * e) && on16(a.ysh * e);
  const int width = vec ? kPairs : 1;
  const int chunks = a.half / width;
  // batch rows a block: one where each row has its own positions, else
  // just enough blocks for two waves
  int64_t slices = a.b;
  if (a.psb == 0) {
    const int64_t want = (kWaveBlocks + a.s - 1) / a.s;
    slices = want < a.b ? want : a.b;
  }
  a.rows_per_block = (a.b + slices - 1) / slices;
  slices = (a.b + a.rows_per_block - 1) / a.rows_per_block;
  const int64_t rows = a.rows_per_block * a.h;
  int64_t step = kThreads / chunks;
  if (step > rows) step = rows;
  const int threads = static_cast<int>(step * chunks);
  const dim3 grid(static_cast<unsigned>(a.s), static_cast<unsigned>(slices));
  return vec ? launch_width<T, kPairs>(a, inverse, grid, threads, stream)
             : launch_width<T, 1>(a, inverse, grid, threads, stream);
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). x and y are [b, s, h, d] with the strides
// x_strides / y_strides (3 each, in elements, for b, s and h; the last dim
// contiguous); positions are indexed [bi * pos_sb + si * pos_ss] (pos_sb 0:
// one [s] vector for every batch row), int64 where pos64 is 1, else int32;
// freqs holds d / 2 float32 values. dtype 0 is float32, 1 bfloat16, 2
// float16; inverse 1 rotates by -angle (the backward). d must be even and at
// most 256, b at most 65535, s and b * h below 2^31.
extern "C" int repro_rope(const void* x, void* y, const void* positions,
                          const void* freqs, long long b, long long s,
                          long long h, int d, const long long* x_strides,
                          const long long* y_strides, long long pos_sb,
                          long long pos_ss, int pos64, int inverse, int dtype,
                          int device, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (d <= 0 || d % 2 != 0 || d > 2 * kMaxHalf || b > 65535 ||
      s >= (1LL << 31) || b * h >= (1LL << 31) || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, y, positions, static_cast<const float*>(freqs), b, s, h, d / 2,
         x_strides[0], x_strides[1], x_strides[2], y_strides[0], y_strides[1],
         y_strides[2], pos_sb, pos_ss, 0, pos64};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  return static_cast<int>(on_device(device, [&] {
    switch (dtype) {
      case 0: return launch<float>(a, inv, st);
      case 1: return launch<__nv_bfloat16>(a, inv, st);
      default: return launch<__half>(a, inv, st);
    }
  }));
}
