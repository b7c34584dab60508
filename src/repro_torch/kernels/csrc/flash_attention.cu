// Flash attention forward for Hopper (sm_90a): tiled online-softmax
// attention with float32 running max, sum and accumulator.
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,g,j,:]) v[b,g,j,:]
//   g = h / (H / Hkv)                     (GQA: no repeated K/V heads)
//   masked (j > i when causal; j <= i - window with a window) -> -1e30
//
// q [B, H, S, D], k and v [B, Hkv, S, D], out [B, H, S, D], each with its
// own element strides over (b, h, s) and a contiguous head dim; float32 or
// bfloat16 in, out in the same dtype; any S, any D up to 256; scale is
// 1/sqrt(D) of the true head dim.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas. That
// kernel walks a (B, H, S/bq, S/bk) grid in order on one TensorCore and
// carries (m, l, acc) in VMEM scratch from one kv step to the next; its
// wrapper pads S to the block and D to 128 for the MXU. Here blocks run in
// parallel, so one block owns one (b, h, 64-row q tile) and walks its kv
// tiles in a loop, keeping (m, l, acc) in registers. Nothing is padded: rows
// past S are masked like the reference's padded keys, and the head dim runs
// to D (shared-memory columns past D stay zero).
//
// Masking follows the reference exactly: masked scores are -1e30, not
// -inf, so a row that is fully masked inside a visible tile gets p = 1
// there and is wiped by alpha = exp(-1e30 - m) = 0 once it meets a real
// key (with -inf it would be NaN); the final division floors l at 1e-30.
// Tiles that no (q, k) pair of the q tile can see are skipped (the
// reference's `visible` test): with causal masking every kv tile past the
// q tile's last row, with a window every kv tile before its reach.
//
// Bound: operations. A visible (q, k) pair costs 4 D flops (q.k and p.v);
// at B=4, H=16, S=2048, D=128 causal that is about 69 GFLOP a layer against
// 34 MB of q, k, v and out. This first design computes on CUDA cores in
// float32 (tensor cores, wgmma and TMA are later work): 256 threads, each
// owning a 4 x 4 patch of the 64 x 64 score tile (float4 reads of Q^T and
// K^T from shared memory, 16 FMAs per pair of reads) and 4 rows x D/16
// columns of the accumulator. K^T is staged in shared memory and then
// overwritten by P for the P.V product, so three tiles of 64 x DMAX floats
// fit twice on an SM for D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

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

struct Strides {
  long long b, h, s;             // elements; the head dim is contiguous
};

// Shared floats of one block: Q^T [DMAX][kBQ], K^T [DMAX][kBK] (reused as
// P [kBQ][kPStride]) and V [kBK][DMAX].
template <int DMAX>
constexpr int smem_floats() {
  return DMAX * kBQ +
         (DMAX * kBK > kBQ * kPStride ? DMAX * kBK : kBQ * kPStride) +
         kBK * DMAX;
}

// Stage rows [row0, row0 + 64) of x (clipped to S) transposed into
// dst[d][r], zeros past S and past D. Consecutive threads take consecutive
// rows, so the shared-memory stores do not collide.
template <typename T, int DMAX>
__device__ __forceinline__ void load_transposed(float* dst, const T* x,
                                                long long s_stride, int row0,
                                                int S, int D) {
  for (int idx = threadIdx.x; idx < 64 * (DMAX / 4); idx += kThreads) {
    const int r = idx % 64, d4 = (idx / 64) * 4;
    const int row = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < S) {
      const T* p = x + row * s_stride;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d4 + u < D) v[u] = to_f32(p[d4 + u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(d4 + u) * 64 + r] = v[u];
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int rep, int S,
                 int D, float scale, int causal, int window) {
  constexpr int kCols = DMAX / 64;           // float4 column groups / thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                           // [DMAX][kBQ]
  float* Kt = Qt + DMAX * kBQ;                // [DMAX][kBK], then P
  float* Ps = Kt;                             // [kBQ][kPStride]
  float* Vs = Kt + (DMAX * kBK > kBQ * kPStride ? DMAX * kBK
                                                : kBQ * kPStride);

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  // kv tiles this q tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  int t_lo = 0;
  int t_hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  if (window > 0) {
    // tile t is visible iff t*kBK + kBK - 1 > q0 - window
    const int lo = q0 - window - kBK + 2;
    t_lo = lo <= 0 ? 0 : (lo + kBK - 1) / kBK;
  }

  load_transposed<T, DMAX>(Qt, qb, qs.s, q0, S, D);

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][c][u] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    load_transposed<T, DMAX>(Kt, kb, ks.s, k0, S, D);
    for (int idx = threadIdx.x; idx < kBK * DMAX; idx += kThreads) {
      const int c = idx / DMAX, d = idx % DMAX;
      const int row = k0 + c;
      Vs[c * DMAX + d] = (row < S && d < D) ? to_f32(vb[row * vs.s + d])
                                            : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4+i against columns tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool keep = kpos < S;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();                         // every thread is done with K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * kPStride + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][c][u] *= alpha[i];
#pragma unroll 2
    for (int c4 = 0; c4 < kBK; c4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(
            Ps + (ty * 4 + i) * kPStride + c4);
        p[i][0] = pv.x; p[i][1] = pv.y; p[i][2] = pv.z; p[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (c4 + cc) * DMAX + (tx + 16 * c) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(p[i][cc], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p[i][cc], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p[i][cc], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p[i][cc], vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();                         // before the next tile's loads
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = (tx + 16 * c) * 4 + u;
        if (d < D) ob[row * os.s + d] = from_f32<T>(acc[i][c][u] * inv_l);
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, int B, int H, int Hkv, int S, int D,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H,
      H / Hkv, S, D, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const Strides& qs, const Strides& ks, const Strides& vs,
                     const Strides& os, int B, int H, int Hkv, int S, int D,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D,
                         scale, causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D,
                          scale, causal, window, stream);
  return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D, scale,
                        causal, window, stream);
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32, 1 bfloat16. Strides are
// in elements, three per tensor: (batch, head, position); the head dim is
// contiguous. window <= 0 means no window. H must be a multiple of Hkv;
// 1 <= D <= 256; B and H at most 65535.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, int B, int H,
    int Hkv, int S, int D, float scale, int causal, int window, int dtype,
    int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const Strides os{o_strides[0], o_strides[1], o_strides[2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D,
                          scale, causal, window, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S,
                                  D, scale, causal, window, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
