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
// tiles in a loop, keeping (m, l, acc) in registers. Nothing is padded in
// device memory: rows past S are masked like the reference's padded keys,
// and the head dim runs to D (shared-memory columns past D stay zero).
//
// Masking follows the reference exactly: masked scores are -1e30, not
// -inf, so a row that is fully masked inside a visible tile gets p = 1
// there and is wiped by alpha = exp(-1e30 - m) = 0 once it meets a real
// key (with -inf it would be NaN); the final division floors l at 1e-30.
// Tiles that no (q, k) pair of the q tile can see are skipped (the
// reference's `visible` test): with causal masking every kv tile past the
// q tile's last row, with a window every kv tile before its reach. Heavy
// q tiles (the last, under a causal mask) are launched first.
//
// Bound: operations. A visible (q, k) pair costs 4 D flops (q.k and p.v);
// at B=4, H=16, S=2048, D=128 causal that is about 69 GFLOP a layer against
// 101 MB of q, k, v and out, so only the tensor cores can approach it.
//
// Two routes, chosen by dtype (not a fallback: each dtype has exactly one):
//
// * bfloat16 -> flash_fwd_mma_kernel, on the tensor cores (FA-2 style).
//   A block owns 128 q rows: 4 warps of 32 rows (two m16 row tiles that
//   share every K and V fragment, halving shared-memory reads per MMA) up
//   to a head dim of 128, 8 warps of 16 rows past it. Q.K^T and P.V are
//   mma.sync m16n8k16 bf16 products with float32 sums, their operands read
//   from shared memory by ldmatrix (.trans for V); the scores, m, l and the
//   output accumulator stay in float32 registers, the row max and sum
//   reduce over the 4 lanes of a fragment row by shuffles, and exp2 runs
//   with scale * log2(e) folded in. P is rounded to bf16 for P.V, as FA-2
//   does; the reference's jnp.dot on float32 operands runs at JAX's default
//   matmul precision, bf16 passes on the TPU's MXU, too. K and V tiles
//   stream through a two-stage ring of 16-byte cp.async copies (zero fill
//   past S and past D), so the next tile's loads overlap this tile's MMAs;
//   Q is loaded once, and a warp skips the kv tiles none of its rows can
//   see. The kernel is templated on the head dim rounded up to a multiple
//   of 32 (DP = 32 ... 256, as FA-2 buckets it; kv tiles of 64 rows, 32
//   for DP > 128): D is zero-padded to DP in shared memory only, and the
//   unrolled MMA loops run over DP with no guard, since a runtime guard
//   splits them into basic blocks that the compiler cannot overlap (it was
//   measurably slower on an H100). Shared rows carry 16 bytes of padding,
//   so the 8 rows an ldmatrix reads fall in distinct banks (104 KB at DP =
//   128: two blocks an SM). Head dims that are not a multiple of 8,
//   or strides and pointers off 16 bytes, take element-wise loads and
//   stores instead of 16-byte ones, in the same kernel. Later work: wgmma
//   from shared memory, TMA loads and warp-specialised producers.
// * float32 -> flash_fwd_kernel, on CUDA cores, the first design. Its
//   contract is float32 within 1e-5 of the plain version, which neither
//   bf16 nor TF32 tensor cores can give; no served model runs float32
//   attention. 256 threads, each owning a 4 x 4 patch of the 64 x 64 score
//   tile (float4 reads of Q^T and K^T from shared memory, 16 FMAs per pair
//   of reads) and 4 rows x D/16 columns of the accumulator. K^T is staged
//   in shared memory and then overwritten by P for the P.V product, so
//   three tiles of 64 x DMAX floats fit twice on an SM for D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

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
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int H, int rep, int S, int D, float scale,
                 int causal, int window) {
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
    // every thread of the row holds the full m and l
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
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
                   float* lse, const Strides& qs, const Strides& ks,
                   const Strides& vs, const Strides& os, int B, int H,
                   int Hkv, int S, int D, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, qs, ks, vs, os,
      H, H / Hkv, S, D, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, const Strides& qs, const Strides& ks,
                     const Strides& vs, const Strides& os, int B, int H,
                     int Hkv, int S, int D, float scale, int causal,
                     int window, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, qs, ks, vs, os, B, H, Hkv, S, D,
                         scale, causal, window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, qs, ks, vs, os, B, H, Hkv, S,
                          D, scale, causal, window, stream);
  return launch<T, 256>(q, k, v, out, lse, qs, ks, vs, os, B, H, Hkv, S, D,
                        scale, causal, window, stream);
}

// ---- bfloat16: the tensor-core route ---------------------------------------

// DP: the head dim rounded up to a multiple of 32 (the template bucket);
// columns past D are zeros in shared memory, so the MMAs run over DP with
// no guard inside the unrolled loops. A block of NW warps owns BQ = 16 WM
// NW = 128 q rows, WM m16 row tiles (16 WM consecutive rows) a warp: two
// row tiles share each K and V fragment up to DP = 128, one past it, where
// the accumulator alone takes DP / 2 registers.
template <int DP>
struct MmaTile {
  static constexpr int NW = DP <= 128 ? 4 : 8;
  static constexpr int WM = DP <= 128 ? 2 : 1;
  static constexpr int NT = 32 * NW;
  static constexpr int BQ = 16 * WM * NW;
  static constexpr int BK = DP <= 128 ? 64 : 32;  // kv rows per tile
  static constexpr int LD = DP + 8;     // shared row stride: 16 bytes pad
  // Q [BQ][LD], then K and V rings [2][BK][LD] each, in bf16
  static constexpr int smem_bytes = (BQ + 4 * BK) * LD * 2;
};

// Rows [row0, row0 + ROWS) of x into dst [ROWS][LD], columns [0, DP): rows
// past S and columns past D are zeros. `vec` (D a multiple of 8, x and its
// row stride on 16 bytes) takes asynchronous 16-byte copies that the
// caller commits and waits for; otherwise element-wise loads and stores.
template <int ROWS, int DP>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x,
                                           long long s_stride, int row0,
                                           int S, int D, bool vec) {
  constexpr int LD = MmaTile<DP>::LD, NT = MmaTile<DP>::NT;
  if (vec) {
    constexpr int NCH = DP / 8;       // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * NCH; i += NT) {
      const int r = i / NCH, c = (i % NCH) * 8;
      const int row = row0 + r;
      const bool in = row < S && c < D;
      tc::cp_async_16(dst + r * LD + c, in ? x + row * s_stride + c : x,
                      in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const int row = row0 + r;
      dst[r * LD + c] = (row < S && c < D) ? x[row * s_stride + c]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(MmaTile<DP>::NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int rep, int S, int D,
                     float scale_log2, int causal, int window, int vec) {
  using Tile = MmaTile<DP>;
  constexpr int BQ = Tile::BQ, BK = Tile::BK, LD = Tile::LD, WM = Tile::WM;
  constexpr int NS = BK / 8;       // n8 tiles of a row tile's scores
  constexpr int NO = DP / 8;       // n8 tiles of its output
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  const int n_q = (S + BQ - 1) / BQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;

  // kv tiles this q tile can see
  const int q_last = min(q0 + BQ, S) - 1;
  int t_lo = 0;
  const int t_hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  if (window > 0) {
    const int lo = q0 - window - BK + 2;
    t_lo = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  stage_rows<BQ, DP>(Qs, qb, qs.s, q0, S, D, vec);
  if (t_lo < t_hi) {
    stage_rows<BK, DP>(Ks, kb, ks.s, t_lo * BK, S, D, vec);
    stage_rows<BK, DP>(Vs, vb, vs.s, t_lo * BK, S, D, vec);
  }
  tc::cp_async_commit();

  // this warp's rows [w0, w0 + 16 WM); row tile mt holds rows w0 + 16 mt +
  // lane / 4 (fragment elements 0, 1) and that + 8 (elements 2, 3); l is
  // this lane's share of each row sum until the end
  const int w0 = q0 + warp * 16 * WM;
  float o[WM][NO][4], m[WM][2], l[WM][2];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const __nv_bfloat16* q_frag =
      Qs + (warp * 16 * WM + lane % 16) * LD + (lane / 16) * 8;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {              // the next tile, into the other stage
      stage_rows<BK, DP>(Ks + (stage ^ 1) * BK * LD, kb, ks.s, (t + 1) * BK,
                         S, D, vec);
      stage_rows<BK, DP>(Vs + (stage ^ 1) * BK * LD, vb, vs.s, (t + 1) * BK,
                         S, D, vec);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();          // this tile (and Q) have landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * BK * LD;
    const __nv_bfloat16* Vt = Vs + stage * BK * LD;
    const int k0 = t * BK;
    // a warp whose rows see no key of the tile skips it (its p would be 0)
    const bool seen = !(causal && k0 > w0 + 16 * WM - 1) &&
                      !(window > 0 && k0 + BK - 1 <= w0 - window);
    if (seen) {
      // S = Q K^T: K rows are keys, so K is the "col" operand as stored
      float s[WM][NS][4];
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[WM][4];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
          tc::ldmatrix_x4(a[mt], q_frag + mt * 16 * LD + kk * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4];
          tc::ldmatrix_x4(bk, Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD
                                  + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mt = 0; mt < WM; ++mt) {
            tc::mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
            tc::mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // scale to log2 units; mask only tiles that hold a masked pair of
      // this warp's rows
#pragma unroll
      for (int mt = 0; mt < WM; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale_log2;
      if (k0 + BK > S || (causal && k0 + BK - 1 > w0) ||
          (window > 0 && k0 <= w0 + 16 * WM - 1 - window)) {
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = w0 + 16 * mt + lane / 4 + (e / 2) * 8;
              const int key = k0 + j * 8 + (lane % 4) * 2 + (e % 2);
              bool keep = key < S;
              if (causal) keep = keep && key <= row;
              if (window > 0) keep = keep && key > row - window;
              if (!keep) s[mt][j][e] = kNegInf;
            }
      }
      // online softmax
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[mt][r] - mx[r]);
          m[mt][r] = mx[r];
          l[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][j][e] = exp2f(s[mt][j][e] - m[mt][e / 2]);
            l[mt][e / 2] += s[mt][j][e];
          }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[mt][j][0] *= alpha[0];
          o[mt][j][1] *= alpha[0];
          o[mt][j][2] *= alpha[1];
          o[mt][j][3] *= alpha[1];
        }
      }

      // O += P V: the score fragments of two n8 tiles are the A fragment
      // of one k16 step; V rows are keys, so V is read transposed
#pragma unroll
      for (int kj = 0; kj < BK / 16; ++kj) {
        uint32_t a[WM][4];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          a[mt][0] = tc::pack_bf16(s[mt][2 * kj][0], s[mt][2 * kj][1]);
          a[mt][1] = tc::pack_bf16(s[mt][2 * kj][2], s[mt][2 * kj][3]);
          a[mt][2] = tc::pack_bf16(s[mt][2 * kj + 1][0], s[mt][2 * kj + 1][1]);
          a[mt][3] = tc::pack_bf16(s[mt][2 * kj + 1][2], s[mt][2 * kj + 1][3]);
        }
        const __nv_bfloat16* v_frag =
            Vt + (kj * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
            (lane / 16) * 8;
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bv[4];
          tc::ldmatrix_x4_trans(bv, v_frag + dn * 16);
#pragma unroll
          for (int mt = 0; mt < WM; ++mt) {
            tc::mma_bf16(o[mt][2 * dn], a[mt], bv[0], bv[1]);
            tc::mma_bf16(o[mt][2 * dn + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                 // this stage is refilled next-but-one
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* ob = out + b * os.b + h * os.h;
  // stage the warp's rows in its own rows of Q (no other warp reads them)
  // for 16-byte stores
  __syncwarp();
  __nv_bfloat16* Os = Qs + warp * 16 * WM * LD;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.f / fmaxf(sum, 1e-30f);
      // m is in log2 units: the natural-log lse is m ln 2 + log l
      const int row = w0 + 16 * mt + lane / 4 + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && row < S)
        lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
            m[mt][r] * 0.6931471805599453f + logf(fmaxf(sum, 1e-30f));
    }
    if (vec) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        __nv_bfloat16* p = Os + (16 * mt + lane / 4) * LD + j * 8 +
                           (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(p) =
            tc::pack_bf16(o[mt][j][0] * inv[0], o[mt][j][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(p + 8 * LD) =
            tc::pack_bf16(o[mt][j][2] * inv[1], o[mt][j][3] * inv[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + 16 * mt + lane / 4 + (e / 2) * 8;
          const int c = j * 8 + (lane % 4) * 2 + (e % 2);
          if (row < S && c < D)
            ob[row * os.s + c] =
                __float2bfloat16_rn(o[mt][j][e] * inv[e / 2]);
        }
    }
  }
  if (vec) {
    __syncwarp();
    const int nch = D / 8;
    for (int i = lane; i < 16 * WM * nch; i += 32) {
      const int r = i / nch, c = (i - r * nch) * 8;
      if (w0 + r < S)
        *reinterpret_cast<uint4*>(ob + (w0 + r) * os.s + c) =
            *reinterpret_cast<const uint4*>(Os + r * LD + c);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, const Strides& qs,
                       const Strides& ks,
                       const Strides& vs, const Strides& os, int B, int H,
                       int Hkv, int S, int D, float scale, int causal,
                       int window, int vec, cudaStream_t stream) {
  constexpr int bytes = MmaTile<DP>::smem_bytes;
  auto kern = flash_fwd_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + MmaTile<DP>::BQ - 1) / MmaTile<DP>::BQ, H, B);
  kern<<<grid, MmaTile<DP>::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, qs, ks, vs, os, H / Hkv, S, D, scale * 1.4426950408889634f,
      causal, window, vec);
  return cudaGetLastError();
}

bool on16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool strides8(const Strides& s) {
  return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0;
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, float* lse, const Strides& qs,
                         const Strides& ks,
                         const Strides& vs, const Strides& os, int B, int H,
                         int Hkv, int S, int D, float scale, int causal,
                         int window, cudaStream_t stream) {
  const int vec = D % 8 == 0 && on16(q) && on16(k) && on16(v) && on16(out) &&
                  strides8(qs) && strides8(ks) && strides8(vs) &&
                  strides8(os);
#define REPRO_FA_CASE(DP)                                                    \
  case DP / 32:                                                              \
    return launch_mma<DP>(q, k, v, out, lse, qs, ks, vs, os, B, H, Hkv, S,  \
                          D, scale, causal, window, vec, stream);
  switch ((D + 31) / 32) {
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(160)
    REPRO_FA_CASE(192)
    REPRO_FA_CASE(224)
    REPRO_FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

// ---- backward ----------------------------------------------------------------
//
// The backward computes the reference's `_flash_bwd`, the custom VJP of
// `_flash` in repro/models/layers.py (pure JAX there, no Pallas), from the
// forward's saved (q, k, v, out) and lse:
//
//   delta_i = sum_d dout[i, d] out[i, d]
//   p_ij = exp(scale q_i.k_j - lse_i)      (0 where the forward masks)
//   dv_j = sum_i p_ij dout_i      ds_ij = p_ij (dout_i.v_j - delta_i) scale
//   dq_i = sum_j ds_ij k_j        dk_j = sum_i ds_ij q_i
//
// with dk and dv summed over the H / Hkv query heads of each kv head (the
// VJP of the reference's repeated heads). Bound: operations. A visible
// pair needs 10 D flops (q.k, dout.v, and the three products); at the
// trained internlm2-1.8b layer (B2, H16, S4096, D128, causal) that is
// 3.4e11 flops against 0.2 GB of inputs and gradients.
//
// Three launches, each deterministic (no float atomics): a pre-pass (delta,
// a warp a row); dQ, a block per (b, h, q tile) walking its visible kv
// tiles; dK/dV, a block per (b, kv head, kv tile) walking the q tiles of all
// its query heads that can see it, heads then tiles in order, with dK and
// dV in registers, so the GQA sum happens in a fixed order inside the
// block. Each recomputes the scores and dP it needs (14 D flops a pair in
// all, FA-2's price for no atomics). Masks, windows and invisible tiles are
// the forward's. The routes, chosen before the launch by dtype, head dim
// and alignment (never after a failure):
//
// * bfloat16 up to D 128, where TMA can read q, k, v and dO (D a multiple
//   of 8, pointers and strides on 16 bytes, no zero stride) ->
//   flash_bwd_dkdv_hop_kernel and flash_bwd_dq_hop_kernel on Hopper's wgmma
//   (their note below), after flash_bwd_prep_kernel (delta and lse log2 e
//   in rows padded to 128). What holds a tensor-core backward back, and
//   what they do about it: (1) load latency: a 3-stage ring of TMA copies
//   that a producer warp keeps in flight, signalled by mbarriers, instead of
//   copies waited on inside each step; (2) registers: setmaxnreg gives the
//   two consumer warpgroups 240 a thread and the producer 24, so dK and dV
//   (or dQ) and the score fragments of 64 rows fit (one 384-thread block an
//   SM); (3) dQ's recomputation stays (14 D, deterministic without
//   atomics; fusing dQ into dK/dV would need an ordered reduction across
//   blocks), but each kernel runs at the wgmma rate; (4) mma.sync: every
//   product is a wgmma (S^T = K Q^T and dP^T = V dO^T from shared memory,
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 in
//   registers, B MN-major), each its own group so that it overlaps the
//   element-wise work (below); (5) GQA: a block still walks every query
//   head of its kv head in order; at qwen3-moe's 32/4 that is 256 blocks
//   of one per SM, about two even waves under the heavy-first order, and
//   splitting the heads over blocks (a fixed-order reduction of partial dK,
//   dV) is left open (PERF.md).
// * bfloat16 otherwise up to D 128 -> flash_bwd_dq_mma_kernel and
//   flash_bwd_dkdv_mma_kernel (mma.sync m16n8k16 with ldmatrix fragments, 4
//   warps of 16 rows, element-wise or 16-byte cp.async loads, one stage).
// * bfloat16 past D 128 -> flash_bwd_dq_wide_kernel and
//   flash_bwd_dkdv_wide_kernel (8 warps, one accumulator a warp, a
//   two-stage ring; their note below).
// In all three, S, dP, P and dS are float32, and P and dS are rounded to
// bf16 as the A operand of the next product, as the forward rounds P.
// * float32 -> flash_bwd_dq_kernel and flash_bwd_dkdv_kernel on CUDA cores
//   (the forward's float32 design: 256 threads, an R x R patch of the score
//   tile each, K^T / V^T staged transposed and overwritten by dS, K rows),
//   float32 throughout, within 1e-4 of the plain version.

// Tiles of the CUDA-core backward kernels: BM q rows and BM kv rows a tile, 256
// threads as a 16 x 16 grid, each owning an R x R patch of the BM x BM
// score tile and R rows x DMAX / 16 columns of an accumulator.
template <int DMAX>
struct BwdTile {
  static constexpr int BM = DMAX <= 128 ? 64 : 32;
  static constexpr int R = BM / 16;
  static constexpr int NT = 256;
  static constexpr int PS = BM + 4;          // row stride of P and dS
  static constexpr int COLS = DMAX / 64;     // float4 column groups a thread
  static constexpr int TILE = DMAX * BM;     // floats of a BM x DMAX tile
  static constexpr int PT = BM * PS;         // floats of a BM x BM tile
  // dQ: Q^T, dO^T, K^T (then dS), V^T (then K)
  static constexpr int DQ_FLOATS = 3 * TILE + (TILE > PT ? TILE : PT);
  // dK/dV: K^T, V^T, Q^T (then Q), dO^T (then dO), P^T, dS^T
  static constexpr int DKV_FLOATS = 4 * TILE + 2 * PT;
};

// R consecutive floats of shared memory (16- or 8-byte aligned).
template <int R>
__device__ __forceinline__ void lds(float (&r)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
}

template <int R>
__device__ __forceinline__ void sts(float* p, const float (&r)[R]) {
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
}

// Rows [row0, row0 + BM) of x (clipped to S) into dst[d][r], transposed;
// zeros past S and past D.
template <typename T, int DMAX>
__device__ __forceinline__ void bwd_load_t(float* dst, const T* x,
                                           long long s_stride, int row0,
                                           int S, int D) {
  using Tl = BwdTile<DMAX>;
  for (int idx = threadIdx.x; idx < Tl::BM * (DMAX / 4); idx += Tl::NT) {
    const int r = idx % Tl::BM, d4 = (idx / Tl::BM) * 4;
    const int row = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < S) {
      const T* p = x + row * s_stride;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d4 + u < D) v[u] = to_f32(p[d4 + u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(d4 + u) * Tl::BM + r] = v[u];
  }
}

// The same rows into dst[r][d], row-major.
template <typename T, int DMAX>
__device__ __forceinline__ void bwd_load_rows(float* dst, const T* x,
                                              long long s_stride, int row0,
                                              int S, int D) {
  using Tl = BwdTile<DMAX>;
  for (int idx = threadIdx.x; idx < Tl::BM * DMAX; idx += Tl::NT) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int row = row0 + r;
    dst[idx] = (row < S && d < D) ? to_f32(x[row * s_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  bool keep = qpos < S && kpos < S;
  if (causal) keep = keep && kpos <= qpos;
  if (window > 0) keep = keep && kpos > qpos - window;
  return keep;
}

// delta[b, h, i] = sum_d dout[b, h, i, d] out[b, h, i, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides os, Strides dos,
                       int H, int S, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (row >= S) return;
  const T* o = out + b * os.b + h * os.h + row * os.s;
  const T* g = dout + b * dos.b + h * dos.h + row * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + row] = acc;
}

// dQ of one (b, h, BM-row q tile) over its visible kv tiles:
//   p = exp(scale q.k - lse), ds = p (dout.v - delta) scale, dq += ds k.
template <typename T, int DMAX>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int H, int rep, int S, int D, float scale,
                    int causal, int window) {
  using Tl = BwdTile<DMAX>;
  constexpr int BM = Tl::BM, R = Tl::R, PS = Tl::PS, COLS = Tl::COLS;
  extern __shared__ float4 bwd_smem[];
  float* Qt = reinterpret_cast<float*>(bwd_smem);  // [DMAX][BM]
  float* dOt = Qt + Tl::TILE;                       // [DMAX][BM]
  float* Vt = dOt + Tl::TILE;                       // [DMAX][BM], then K
  float* Kt = Vt + Tl::TILE;                        // [DMAX][BM], then dS
  float* Kr = Vt;                                   // [BM][DMAX]
  float* dS = Kt;                                   // [BM][PS]

  const int n_q = (S + BM - 1) / BM;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;
  const long long rows = (static_cast<long long>(b) * H + h) * S;

  const int q_last = min(q0 + BM, S) - 1;
  int t_lo = 0;
  const int t_hi = causal ? q_last / BM + 1 : n_q;
  if (window > 0) {
    const int lo = q0 - window - BM + 2;
    t_lo = lo <= 0 ? 0 : (lo + BM - 1) / BM;
  }

  bwd_load_t<T, DMAX>(Qt, qb, qs.s, q0, S, D);
  bwd_load_t<T, DMAX>(dOt, dob, dos.s, q0, S, D);
  float lse_r[R], dl_r[R], acc[R][COLS][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    lse_r[i] = row < S ? lse[rows + row] : 0.f;
    dl_r[i] = row < S ? delta[rows + row] : 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][c][u] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BM;
    bwd_load_t<T, DMAX>(Kt, kb, ks.s, k0, S, D);
    bwd_load_t<T, DMAX>(Vt, vb, vs.s, k0, S, D);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], c[R], e[R], f[R];
      lds<R>(a, Qt + d * BM + ty * R);
      lds<R>(c, Kt + d * BM + tx * R);
      lds<R>(e, dOt + d * BM + ty * R);
      lds<R>(f, Vt + d * BM + tx * R);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool keep = visible(q0 + ty * R + i, k0 + tx * R + j, S, causal,
                                  window);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl_r[i]) * scale;     // ds
      }
    __syncthreads();                         // every thread is done with K^T, V^T
#pragma unroll
    for (int i = 0; i < R; ++i) sts<R>(dS + (ty * R + i) * PS + tx * R, s[i]);
    bwd_load_rows<T, DMAX>(Kr, kb, ks.s, k0, S, D);
    __syncthreads();
#pragma unroll 2
    for (int c0 = 0; c0 < BM; c0 += R) {
      float w[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i) lds<R>(w[i], dS + (ty * R + i) * PS + c0);
#pragma unroll
      for (int cc = 0; cc < R; ++cc)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(
              Kr + (c0 + cc) * DMAX + (tx + 16 * c) * 4);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][c][0] = fmaf(w[i][cc], kk.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(w[i][cc], kk.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(w[i][cc], kk.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(w[i][cc], kk.w, acc[i][c][3]);
          }
        }
    }
    __syncthreads();                         // before the next tile's loads
  }

  T* gb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = (tx + 16 * c) * 4 + u;
        if (d < D) gb[row * dqs.s + d] = from_f32<T>(acc[i][c][u]);
      }
  }
}

// dK and dV of one (b, kv head g, BM-row kv tile): every q tile of every
// query head of g that can see the tile, heads then q tiles in order, with
// dK and dV in registers (the GQA sum in a fixed order, no atomics):
//   dv += p^T dout, dk += ds^T q.
template <typename T, int DMAX>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, int H, int rep,
                      int S, int D, float scale, int causal, int window) {
  using Tl = BwdTile<DMAX>;
  constexpr int BM = Tl::BM, R = Tl::R, PS = Tl::PS, COLS = Tl::COLS;
  extern __shared__ float4 bwd_smem[];
  float* Kt = reinterpret_cast<float*>(bwd_smem);   // [DMAX][BM]
  float* Vt = Kt + Tl::TILE;                         // [DMAX][BM]
  float* X1 = Vt + Tl::TILE;                         // Q^T, then Q [BM][DMAX]
  float* X2 = X1 + Tl::TILE;                         // dO^T, then dO
  float* Pt = X2 + Tl::TILE;                         // [BM kv][PS]
  float* dSt = Pt + Tl::PT;                          // [BM kv][PS]

  const int n_t = (S + BM - 1) / BM;
  const int kt = blockIdx.x;             // tile 0 is the heaviest when causal
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  // q tiles that can see this kv tile
  const int qt_lo = causal ? kt : 0;
  int qt_hi = n_t;
  if (window > 0) qt_hi = min(n_t, (k0 + BM + window - 2) / BM + 1);

  bwd_load_t<T, DMAX>(Kt, kb, ks.s, k0, S, D);
  bwd_load_t<T, DMAX>(Vt, vb, vs.s, k0, S, D);
  float adk[R][COLS][4], adv[R][COLS][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) adk[i][c][u] = adv[i][c][u] = 0.f;

  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long rows = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BM;
      bwd_load_t<T, DMAX>(X1, qb, qs.s, q0, S, D);
      bwd_load_t<T, DMAX>(X2, dob, dos.s, q0, S, D);
      float lse_c[R], dl_c[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = q0 + tx * R + j;
        lse_c[j] = col < S ? lse[rows + col] : 0.f;
        dl_c[j] = col < S ? delta[rows + col] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float st[R][R], dpt[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[R], c[R], e[R], f[R];
        lds<R>(a, Kt + d * BM + ty * R);
        lds<R>(c, X1 + d * BM + tx * R);
        lds<R>(e, Vt + d * BM + ty * R);
        lds<R>(f, X2 + d * BM + tx * R);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            st[i][j] = fmaf(a[i], c[j], st[i][j]);
            dpt[i][j] = fmaf(e[i], f[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const bool keep = visible(q0 + tx * R + j, k0 + ty * R + i, S,
                                    causal, window);
          const float p = keep ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
          st[i][j] = p;
          dpt[i][j] = p * (dpt[i][j] - dl_c[j]) * scale;   // ds^T
        }
      __syncthreads();                       // done with Q^T, dO^T
#pragma unroll
      for (int i = 0; i < R; ++i) {
        sts<R>(Pt + (ty * R + i) * PS + tx * R, st[i]);
        sts<R>(dSt + (ty * R + i) * PS + tx * R, dpt[i]);
      }
      bwd_load_rows<T, DMAX>(X1, qb, qs.s, q0, S, D);
      bwd_load_rows<T, DMAX>(X2, dob, dos.s, q0, S, D);
      __syncthreads();
#pragma unroll 2
      for (int c0 = 0; c0 < BM; c0 += R) {
        float pw[R][R], sw[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          lds<R>(pw[i], Pt + (ty * R + i) * PS + c0);
          lds<R>(sw[i], dSt + (ty * R + i) * PS + c0);
        }
#pragma unroll
        for (int cc = 0; cc < R; ++cc)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int col = (tx + 16 * c) * 4;
            const float4 oo = *reinterpret_cast<const float4*>(
                X2 + (c0 + cc) * DMAX + col);
            const float4 qq = *reinterpret_cast<const float4*>(
                X1 + (c0 + cc) * DMAX + col);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              adv[i][c][0] = fmaf(pw[i][cc], oo.x, adv[i][c][0]);
              adv[i][c][1] = fmaf(pw[i][cc], oo.y, adv[i][c][1]);
              adv[i][c][2] = fmaf(pw[i][cc], oo.z, adv[i][c][2]);
              adv[i][c][3] = fmaf(pw[i][cc], oo.w, adv[i][c][3]);
              adk[i][c][0] = fmaf(sw[i][cc], qq.x, adk[i][c][0]);
              adk[i][c][1] = fmaf(sw[i][cc], qq.y, adk[i][c][1]);
              adk[i][c][2] = fmaf(sw[i][cc], qq.z, adk[i][c][2]);
              adk[i][c][3] = fmaf(sw[i][cc], qq.w, adk[i][c][3]);
            }
          }
      }
      __syncthreads();                       // before the next q tile
    }
  }

  T* dkb = dk + b * dks.b + g * dks.h;
  T* dvb = dv + b * dvs.b + g * dvs.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = (tx + 16 * c) * 4 + u;
        if (d < D) {
          dkb[row * dks.s + d] = from_f32<T>(adk[i][c][u]);
          dvb[row * dvs.s + d] = from_f32<T>(adv[i][c][u]);
        }
      }
  }
}

// ---- the backward on mma.sync (bfloat16, D <= 128, off 16 bytes) ----------
//
// The inputs the wgmma kernels below cannot read by TMA (D not a multiple
// of 8, a pointer or stride off 16 bytes, a zero stride) take these.

// 4 warps of 16 rows each; tiles in shared memory as bf16 rows of LD = DP +
// 8, MmaTile<DP>'s layout, so stage_rows loads them (cp.async, zero fill).
template <int DP>
struct BwdMma {
  static constexpr int NT = 128;
  static constexpr int BR = 64;        // rows a block owns, 16 a warp
  static constexpr int BQ = 32;        // q rows a step of the dK/dV kernel
  static constexpr int BK = 64;        // kv rows a step of the dQ kernel
  static constexpr int LD = DP + 8;
  // dK/dV: K, V [BR][LD] and Q, dO [BQ][LD] in bf16; lse2, delta [BQ]
  static constexpr int DKV_BYTES = (2 * BR + 2 * BQ) * LD * 2 + 2 * BQ * 4;
  // dQ: Q, dO [BR][LD] and K, V [BK][LD] in bf16
  static constexpr int DQ_BYTES = (2 * BR + 2 * BK) * LD * 2;
};

// dK and dV of one (b, kv head g, 64-row kv tile), a warp's 16 keys each,
// over every 32-row q tile of every query head of g that can see them:
// S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T and dS^T in
// float32 registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// rounded to bf16 as the A operand (as the forward rounds P for P.V).
template <int DP>
__global__ void __launch_bounds__(BwdMma<DP>::NT)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Strides qs,
                          Strides ks, Strides vs, Strides dos, Strides dks,
                          Strides dvs, int H, int rep, int S, int D,
                          float scale, float scale_log2, int causal,
                          int window, int vec) {
  using Tl = BwdMma<DP>;
  constexpr int BR = Tl::BR, BQ = Tl::BQ, LD = Tl::LD;
  constexpr int NQ = BQ / 8;       // n8 tiles of a warp's S^T
  constexpr int ND = DP / 8;       // n8 tiles of its dK and dV
  extern __shared__ uint4 bwd_mma_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bwd_mma_smem);
  __nv_bfloat16* Vs = Ks + BR * LD;
  __nv_bfloat16* Qs = Vs + BR * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* lse2_s = reinterpret_cast<float*>(dOs + BQ * LD);
  float* dl_s = lse2_s + BQ;

  const int n_q = (S + BQ - 1) / BQ;
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = static_cast<int>(blockIdx.x) * BR;  // tile 0 is the heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw0 = k0 + warp * 16;                      // this warp's keys
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;

  // q tiles that can see this kv tile
  const int qt_lo = causal ? k0 / BQ : 0;
  int qt_hi = n_q;
  if (window > 0) qt_hi = min(n_q, (k0 + BR + window - 2) / BQ + 1);

  stage_rows<BR, DP>(Ks, kb, ks.s, k0, S, D, vec);
  stage_rows<BR, DP>(Vs, vb, vs.s, k0, S, D, vec);
  tc::cp_async_commit();

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  const __nv_bfloat16* k_frag = Ks + (warp * 16 + lane % 16) * LD +
                                (lane / 16) * 8;
  const __nv_bfloat16* v_frag = Vs + (warp * 16 + lane % 16) * LD +
                                (lane / 16) * 8;
  // a B operand stored [n][k] (Q and dO as the "col" operand of S^T, dP^T)
  const int col_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  // a B operand stored [k][n], read transposed (Q and dO for dK and dV)
  const int row_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
    const long long rows = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();               // every warp is done with the last tile
      stage_rows<BQ, DP>(Qs, qb, qs.s, q0, S, D, vec);
      stage_rows<BQ, DP>(dOs, dob, dos.s, q0, S, D, vec);
      tc::cp_async_commit();
      for (int i = threadIdx.x; i < BQ; i += Tl::NT) {
        const int row = q0 + i;
        lse2_s[i] = row < S ? lse[rows + row] * 1.4426950408889634f : 0.f;
        dl_s[i] = row < S ? delta[rows + row] : 0.f;
      }
      tc::cp_async_wait<0>();
      __syncthreads();
      // a warp none of whose keys the tile's queries can see skips it
      const bool seen = kw0 < S && !(causal && kw0 > q0 + BQ - 1) &&
                        !(window > 0 && kw0 + 15 <= q0 - window);
      if (!seen) continue;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[4], av[4];
        tc::ldmatrix_x4(ak, k_frag + kk * 16);
        tc::ldmatrix_x4(av, v_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4], bo[4];
          const int off = np * 16 * LD + col_off + kk * 16;
          tc::ldmatrix_x4(bq, Qs + off);
          tc::ldmatrix_x4(bo, dOs + off);
          tc::mma_bf16(st[2 * np], ak, bq[0], bq[1]);
          tc::mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
          tc::mma_bf16(dpt[2 * np], av, bo[0], bo[1]);
          tc::mma_bf16(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T: rows are this warp's keys, columns the tile's queries
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw0 + lane / 4 + (e / 2) * 8;
          const int qi = j * 8 + (lane % 4) * 2 + (e % 2);
          const bool keep = visible(q0 + qi, key, S, causal, window);
          const float p =
              keep ? exp2f(st[j][e] * scale_log2 - lse2_s[qi]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl_s[qi]) * scale;
        }
      // dV += P^T dO and dK += dS^T Q: the queries are the k dimension
#pragma unroll
      for (int kj = 0; kj < BQ / 16; ++kj) {
        uint32_t ap[4], as[4];
        ap[0] = tc::pack_bf16(st[2 * kj][0], st[2 * kj][1]);
        ap[1] = tc::pack_bf16(st[2 * kj][2], st[2 * kj][3]);
        ap[2] = tc::pack_bf16(st[2 * kj + 1][0], st[2 * kj + 1][1]);
        ap[3] = tc::pack_bf16(st[2 * kj + 1][2], st[2 * kj + 1][3]);
        as[0] = tc::pack_bf16(dpt[2 * kj][0], dpt[2 * kj][1]);
        as[1] = tc::pack_bf16(dpt[2 * kj][2], dpt[2 * kj][3]);
        as[2] = tc::pack_bf16(dpt[2 * kj + 1][0], dpt[2 * kj + 1][1]);
        as[3] = tc::pack_bf16(dpt[2 * kj + 1][2], dpt[2 * kj + 1][3]);
        const int off = kj * 16 * LD + row_off;
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bo[4], bq[4];
          tc::ldmatrix_x4_trans(bo, dOs + off + dn * 16);
          tc::ldmatrix_x4_trans(bq, Qs + off + dn * 16);
          tc::mma_bf16(adv[2 * dn], ap, bo[0], bo[1]);
          tc::mma_bf16(adv[2 * dn + 1], ap, bo[2], bo[3]);
          tc::mma_bf16(adk[2 * dn], as, bq[0], bq[1]);
          tc::mma_bf16(adk[2 * dn + 1], as, bq[2], bq[3]);
        }
      }
    }
  }

  tc::cp_async_wait<0>();             // K and V, when no q tile came
  __nv_bfloat16* dkb = dk + b * dks.b + g * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + g * dvs.h;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kw0 + lane / 4 + (e / 2) * 8;
      const int c = j * 8 + (lane % 4) * 2 + (e % 2);
      if (row < S && c < D) {
        dkb[row * dks.s + c] = __float2bfloat16_rn(adk[j][e]);
        dvb[row * dvs.s + c] = __float2bfloat16_rn(adv[j][e]);
      }
    }
}

// dQ of one (b, h, 64-row q tile), a warp's 16 queries each, over its
// visible 64-row kv tiles: S = Q K^T and dP = dO V^T on the tensor cores,
// P and dS in float32 registers, dQ += dS K with dS rounded to bf16.
template <int DP>
__global__ void __launch_bounds__(BwdMma<DP>::NT)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, Strides qs,
                        Strides ks, Strides vs, Strides dos, Strides dqs,
                        int H, int rep, int S, int D, float scale,
                        float scale_log2, int causal, int window, int vec) {
  using Tl = BwdMma<DP>;
  constexpr int BR = Tl::BR, BK = Tl::BK, LD = Tl::LD;
  constexpr int NS = BK / 8;       // n8 tiles of a warp's S
  constexpr int ND = DP / 8;       // n8 tiles of its dQ
  extern __shared__ uint4 bwd_mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bwd_mma_smem);
  __nv_bfloat16* dOs = Qs + BR * LD;
  __nv_bfloat16* Ks = dOs + BR * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int n_q = (S + BR - 1) / BR;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw0 = q0 + warp * 16;                      // this warp's queries
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;
  const long long rows = (static_cast<long long>(b) * H + h) * S;

  const int q_last = min(q0 + BR, S) - 1;
  int t_lo = 0;
  const int t_hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  if (window > 0) {
    const int lo = q0 - window - BK + 2;
    t_lo = lo <= 0 ? 0 : (lo + BK - 1) / BK;
  }

  stage_rows<BR, DP>(Qs, qb, qs.s, q0, S, D, vec);
  stage_rows<BR, DP>(dOs, dob, dos.s, q0, S, D, vec);
  tc::cp_async_commit();
  // this lane's rows qw0 + lane / 4 (fragment elements 0, 1) and + 8 (2, 3)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + lane / 4 + 8 * r;
    lse2[r] = row < S ? lse[rows + row] * 1.4426950408889634f : 0.f;
    dl[r] = row < S ? delta[rows + row] : 0.f;
  }
  float adq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;
  const __nv_bfloat16* q_frag = Qs + (warp * 16 + lane % 16) * LD +
                                (lane / 16) * 8;
  const __nv_bfloat16* do_frag = dOs + (warp * 16 + lane % 16) * LD +
                                 (lane / 16) * 8;
  const int col_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int row_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                 // every warp is done with the last tile
    stage_rows<BK, DP>(Ks, kb, ks.s, k0, S, D, vec);
    stage_rows<BK, DP>(Vs, vb, vs.s, k0, S, D, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    const bool seen = qw0 < S && !(causal && k0 > qw0 + 15) &&
                      !(window > 0 && k0 + BK - 1 <= qw0 - window);
    if (!seen) continue;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      tc::ldmatrix_x4(aq, q_frag + kk * 16);
      tc::ldmatrix_x4(ao, do_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4], bv[4];
        const int off = np * 16 * LD + col_off + kk * 16;
        tc::ldmatrix_x4(bk, Ks + off);
        tc::ldmatrix_x4(bv, Vs + off);
        tc::mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        tc::mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        tc::mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
        tc::mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qw0 + lane / 4 + (e / 2) * 8;
        const int key = k0 + j * 8 + (lane % 4) * 2 + (e % 2);
        const bool keep = visible(row, key, S, causal, window);
        const float p =
            keep ? exp2f(s[j][e] * scale_log2 - lse2[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;     // ds
      }
    // dQ += dS K: the keys are the k dimension
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      uint32_t a[4];
      a[0] = tc::pack_bf16(s[2 * kj][0], s[2 * kj][1]);
      a[1] = tc::pack_bf16(s[2 * kj][2], s[2 * kj][3]);
      a[2] = tc::pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      a[3] = tc::pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3]);
      const int off = kj * 16 * LD + row_off;
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bk[4];
        tc::ldmatrix_x4_trans(bk, Ks + off + dn * 16);
        tc::mma_bf16(adq[2 * dn], a, bk[0], bk[1]);
        tc::mma_bf16(adq[2 * dn + 1], a, bk[2], bk[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* gb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qw0 + lane / 4 + (e / 2) * 8;
      const int c = j * 8 + (lane % 4) * 2 + (e % 2);
      if (row < S && c < D) gb[row * dqs.s + c] = __float2bfloat16_rn(adq[j][e]);
    }
}

// ---- the backward on the tensor cores past D 128 (bfloat16, D <= 256) -----
//
// A warp of the kernels above holds two 16 x DP float32 accumulators (dK and
// dV), DP registers a thread: past DP 128, with the score fragments, that
// passes 255. So the wide kernels give a warp one accumulator each, eight
// warps a block, and exchange the one operand the other product needs
// through shared memory:
//
// * dK/dV, a block per (b, kv head, 64 kv rows) and two roles of four warps
//   (16 keys a warp in each). The P role computes S^T = K Q^T for the step's
//   64 queries, forms P^T = exp2(S^T scale log2 e - lse log2 e) under the
//   mask, writes it to shared memory in float32 and adds P^T dO to dV (P^T
//   rounded to bf16 as the A operand, from registers). The dS role computes
//   dP^T = V dO^T meanwhile, reads P^T after a barrier, forms dS^T = P^T
//   (dP^T - delta) scale and adds dS^T Q to dK. Steps walk the q tiles of
//   each query head of the kv head, heads then tiles, as above.
// * dQ, a block per (b, h, 64 q rows): warp (r, c) computes S and dP of its
//   16 rows against key half c of the 64-key tile, forms dS in registers
//   (P never leaves them), writes it in bf16 to shared memory, and after a
//   barrier adds dS K to its 16 rows x DP / 2 columns of dQ (DP / 4
//   registers a thread).
//
// K and V (dK/dV) or Q and dO (dQ) stay in shared memory; the streamed
// tiles, with lse and delta for dK/dV, go through a two-stage ring of
// cp.async copies, the next step's issued right after the barrier that
// frees its stage, so they land while this step multiplies. mma.sync
// m16n8k16 with ldmatrix operands, as above; masks are evaluated only on
// tiles where a warp has a masked pair. Shared memory (bf16 rows of LD = DP
// + 8, 6 tiles of 64 rows): dK/dV 222,208 bytes at DP 256 (P^T 18 KB, lse
// and delta 1 KB), 173,056 at DP 192, 148,480 at DP 160; dQ 211,968 at DP
// 256; one block an SM. Most of a step goes to the two products, which
// this design does not overlap with each other or with the element-wise
// work between its barriers (PERF.md). A wgmma version of the same design
// (a warpgroup a role, its products waited on each step) gave bit-identical
// results but ran slower; wgmma needs that overlap to pay off.
template <int DP>
struct BwdWide {
  static_assert(DP > 128 && DP <= 256 && DP % 32 == 0, "the wide buckets");
  static constexpr int NT = 256;       // eight warps
  static constexpr int BR = 64;        // rows a block owns
  static constexpr int BS = 64;        // rows of a streamed tile
  static constexpr int LD = DP + 8;
  static constexpr int XLD = BS + 8;   // row stride of P^T or dS
  static constexpr int TILE = BR * LD; // bf16 elements of a 64-row tile
  // dK/dV: K, V, then Q and dO in two stages (bf16); P^T [BR][XLD] float32;
  // lse and delta [2][BS] float32 each
  static constexpr int DKV_BYTES = 6 * TILE * 2 + BR * XLD * 4 + 4 * BS * 4;
  // dQ: Q, dO, then K and V in two stages (bf16); dS [BR][XLD] bf16
  static constexpr int DQ_BYTES = 6 * TILE * 2 + BR * XLD * 2;
  // stage_rows stages these tiles with MmaTile<DP>'s stride and threads
  static_assert(MmaTile<DP>::NT == NT && MmaTile<DP>::LD == LD, "stage_rows");
  static_assert(DKV_BYTES <= 232448 && DQ_BYTES <= 232448, "shared memory");
};

constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__global__ void __launch_bounds__(BwdWide<DP>::NT, 1)
flash_bwd_dkdv_wide_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Strides qs,
                           Strides ks, Strides vs, Strides dos, Strides dks,
                           Strides dvs, int H, int rep, int S, int D,
                           float scale, float scale_log2, int causal,
                           int window, int vec) {
  using Tl = BwdWide<DP>;
  constexpr int BR = Tl::BR, BS = Tl::BS, LD = Tl::LD, XLD = Tl::XLD;
  constexpr int NQ = BS / 8;       // n8 tiles of a warp's S^T or dP^T
  constexpr int ND = DP / 8;       // n8 tiles of its dV or dK
  extern __shared__ uint4 bwd_wide_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bwd_wide_smem);
  __nv_bfloat16* Vs = Ks + Tl::TILE;
  __nv_bfloat16* Qs = Vs + Tl::TILE;                 // [2][BS][LD]
  __nv_bfloat16* dOs = Qs + 2 * Tl::TILE;            // [2][BS][LD]
  float* Pt = reinterpret_cast<float*>(dOs + 2 * Tl::TILE);  // [BR][XLD]
  float* lse_s = Pt + BR * XLD;                      // [2][BS]
  float* dl_s = lse_s + 2 * BS;                      // [2][BS]

  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = static_cast<int>(blockIdx.x) * BR;  // tile 0 is the heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;           // 0: P^T and dV; 1: dS^T and dK
  const int kw0 = k0 + (warp % 4) * 16;               // this warp's keys
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;

  // q tiles that can see this kv tile, the same for every query head of g
  const int n_q = (S + BS - 1) / BS;
  const int qt_lo = causal ? k0 / BS : 0;
  int qt_hi = n_q;
  if (window > 0) qt_hi = min(n_q, (k0 + BR + window - 2) / BS + 1);
  const int n_qt = max(qt_hi - qt_lo, 0);
  const int n_it = rep * n_qt;

  // step `it`: q tile qt_lo + it % n_qt of query head g rep + it / n_qt,
  // its Q and dO rows, lse and delta into stage `st`
  auto stage_step = [&](int it, int st) {
    const int h = g * rep + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BS;
    stage_rows<BS, DP>(Qs + st * Tl::TILE, q + b * qs.b + h * qs.h, qs.s,
                       q0, S, D, vec);
    stage_rows<BS, DP>(dOs + st * Tl::TILE, dout + b * dos.b + h * dos.h,
                       dos.s, q0, S, D, vec);
    const long long rows = (static_cast<long long>(b) * H + h) * S;
    for (int i = threadIdx.x; i < 2 * BS; i += Tl::NT) {
      const int r = i % BS, row = q0 + r;
      const float* src = (i < BS ? lse : delta) + rows + row;
      tc::cp_async_4((i < BS ? lse_s : dl_s) + st * BS + r,
                     row < S ? src : lse, row < S ? 4 : 0);
    }
  };

  stage_rows<BR, DP>(Ks, kb, ks.s, k0, S, D, vec);
  stage_rows<BR, DP>(Vs, vb, vs.s, k0, S, D, vec);
  if (n_it > 0) stage_step(0, 0);
  tc::cp_async_commit();

  float acc[ND][4];                    // dV (P role) or dK (dS role)
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // the A operand of the first product: the warp's 16 rows of K or V
  const __nv_bfloat16* a_frag = (role ? Vs : Ks) +
                                ((warp % 4) * 16 + lane % 16) * LD +
                                (lane / 16) * 8;
  const int col_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int row_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
  // this lane's P^T entries: keys lane / 4 (+ 8), queries j 8 + 2 (lane % 4)
  float* p_frag = Pt + ((warp % 4) * 16 + lane / 4) * XLD + (lane % 4) * 2;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    tc::cp_async_wait<0>();
    __syncthreads();                 // step it landed; step it - 1 is done
    if (it + 1 < n_it) stage_step(it + 1, st ^ 1);
    tc::cp_async_commit();
    const int q0 = (qt_lo + it % n_qt) * BS;
    const __nv_bfloat16* Qt = Qs + st * Tl::TILE;
    const __nv_bfloat16* dOt = dOs + st * Tl::TILE;
    const float* lse_t = lse_s + st * BS;
    const float* dl_t = dl_s + st * BS;
    // a warp none of whose keys the step's queries see skips it (both
    // roles alike); `edge`: some pair of the warp's is masked
    const bool seen = kw0 < S && !(causal && kw0 > q0 + BS - 1) &&
                      !(window > 0 && kw0 + 15 <= q0 - window);
    const bool edge = q0 + BS > S || kw0 + 16 > S ||
                      (causal && kw0 + 15 > q0) ||
                      (window > 0 && kw0 <= q0 + BS - 1 - window);
    float x[NQ][4];                  // S^T, then P^T (P role); dP^T, dS^T
    if (seen) {
      // S^T = K Q^T or dP^T = V dO^T: the step's rows are the "col" operand
      const __nv_bfloat16* bt = role ? dOt : Qt;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, a_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          tc::ldmatrix_x4(bq, bt + np * 16 * LD + col_off + kk * 16);
          tc::mma_bf16(x[2 * np], a, bq[0], bq[1]);
          tc::mma_bf16(x[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      if (role == 0) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = j * 8 + (lane % 4) * 2 + (e % 2);
            const int key = kw0 + lane / 4 + (e / 2) * 8;
            const bool keep =
                !edge || visible(q0 + qi, key, S, causal, window);
            x[j][e] = keep ? exp2f(x[j][e] * scale_log2 - lse_t[qi] * kLog2e)
                           : 0.f;
          }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(p_frag + r * 8 * XLD + j * 8) =
                make_float2(x[j][2 * r], x[j][2 * r + 1]);
      }
    }
    __syncthreads();                 // P^T is in shared memory
    if (seen) {
      if (role == 1) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 p = *reinterpret_cast<const float2*>(
                p_frag + r * 8 * XLD + j * 8);
            const int qi = j * 8 + (lane % 4) * 2;
            x[j][2 * r] = p.x * (x[j][2 * r] - dl_t[qi]) * scale;
            x[j][2 * r + 1] = p.y * (x[j][2 * r + 1] - dl_t[qi + 1]) * scale;
          }
      }
      // dV += P^T dO or dK += dS^T Q: the queries are the k dimension, the
      // A operand this warp's fragments rounded to bf16
      const __nv_bfloat16* bt = role ? Qt : dOt;
#pragma unroll
      for (int kj = 0; kj < BS / 16; ++kj) {
        uint32_t a[4];
        a[0] = tc::pack_bf16(x[2 * kj][0], x[2 * kj][1]);
        a[1] = tc::pack_bf16(x[2 * kj][2], x[2 * kj][3]);
        a[2] = tc::pack_bf16(x[2 * kj + 1][0], x[2 * kj + 1][1]);
        a[3] = tc::pack_bf16(x[2 * kj + 1][2], x[2 * kj + 1][3]);
        const int off = kj * 16 * LD + row_off;
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bb[4];
          tc::ldmatrix_x4_trans(bb, bt + off + dn * 16);
          tc::mma_bf16(acc[2 * dn], a, bb[0], bb[1]);
          tc::mma_bf16(acc[2 * dn + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  tc::cp_async_wait<0>();             // K and V, when no step came
  __nv_bfloat16* ob = role ? dk + b * dks.b + g * dks.h
                           : dv + b * dvs.b + g * dvs.h;
  const long long o_s = role ? dks.s : dvs.s;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kw0 + lane / 4 + (e / 2) * 8;
      const int c = j * 8 + (lane % 4) * 2 + (e % 2);
      if (row < S && c < D) ob[row * o_s + c] = __float2bfloat16_rn(acc[j][e]);
    }
}

template <int DP>
__global__ void __launch_bounds__(BwdWide<DP>::NT, 1)
flash_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Strides qs,
                         Strides ks, Strides vs, Strides dos, Strides dqs,
                         int H, int rep, int S, int D, float scale,
                         float scale_log2, int causal, int window, int vec) {
  using Tl = BwdWide<DP>;
  constexpr int BR = Tl::BR, BS = Tl::BS, LD = Tl::LD, XLD = Tl::XLD;
  constexpr int NS = BS / 16;      // n8 tiles of a warp's S and dP (32 keys)
  constexpr int NH = DP / 16;      // n8 tiles of its half of dQ
  extern __shared__ uint4 bwd_wide_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bwd_wide_smem);
  __nv_bfloat16* dOs = Qs + Tl::TILE;
  __nv_bfloat16* Ks = dOs + Tl::TILE;                // [2][BS][LD]
  __nv_bfloat16* Vs = Ks + 2 * Tl::TILE;             // [2][BS][LD]
  __nv_bfloat16* dSs = Vs + 2 * Tl::TILE;            // [BR][XLD]

  const int n_q = (S + BR - 1) / BR;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / 4;           // key half of S / dP, column half of dQ
  const int qw0 = q0 + (warp % 4) * 16;               // this warp's queries
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;
  const long long rows = (static_cast<long long>(b) * H + h) * S;

  const int q_last = min(q0 + BR, S) - 1;
  int t_lo = 0;
  const int t_hi = causal ? q_last / BS + 1 : (S + BS - 1) / BS;
  if (window > 0) {
    const int lo = q0 - window - BS + 2;
    t_lo = lo <= 0 ? 0 : (lo + BS - 1) / BS;
  }

  stage_rows<BR, DP>(Qs, qb, qs.s, q0, S, D, vec);
  stage_rows<BR, DP>(dOs, dob, dos.s, q0, S, D, vec);
  if (t_lo < t_hi) {
    stage_rows<BS, DP>(Ks, kb, ks.s, t_lo * BS, S, D, vec);
    stage_rows<BS, DP>(Vs, vb, vs.s, t_lo * BS, S, D, vec);
  }
  tc::cp_async_commit();
  // this lane's rows qw0 + lane / 4 (fragment elements 0, 1) and + 8 (2, 3)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + lane / 4 + 8 * r;
    lse2[r] = row < S ? lse[rows + row] * kLog2e : 0.f;
    dl[r] = row < S ? delta[rows + row] : 0.f;
  }
  float adq[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;
  const int frag = ((warp % 4) * 16 + lane % 16) * LD + (lane / 16) * 8;
  const __nv_bfloat16* ds_frag =
      dSs + ((warp % 4) * 16 + lane % 16) * XLD + (lane / 16) * 8;
  __nv_bfloat16* ds_out = dSs + ((warp % 4) * 16 + lane / 4) * XLD +
                          half * 32 + (lane % 4) * 2;
  const int col_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int row_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();                 // tile t landed; tile t - 1 is done
    if (t + 1 < t_hi) {
      stage_rows<BS, DP>(Ks + (st ^ 1) * Tl::TILE, kb, ks.s, (t + 1) * BS, S,
                         D, vec);
      stage_rows<BS, DP>(Vs + (st ^ 1) * Tl::TILE, vb, vs.s, (t + 1) * BS, S,
                         D, vec);
    }
    tc::cp_async_commit();
    const __nv_bfloat16* Kt = Ks + st * Tl::TILE;
    const __nv_bfloat16* Vt = Vs + st * Tl::TILE;
    const int k0 = t * BS, kh0 = k0 + half * 32;      // this warp's keys
    const bool seen = qw0 < S && !(causal && kh0 > qw0 + 15) &&
                      !(window > 0 && kh0 + 31 <= qw0 - window);
    const bool edge = qw0 + 16 > S || kh0 + 32 > S ||
                      (causal && kh0 + 31 > qw0) ||
                      (window > 0 && kh0 <= qw0 + 15 - window);
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if (seen) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t aq[4], ao[4];
        tc::ldmatrix_x4(aq, Qs + frag + kk * 16);
        tc::ldmatrix_x4(ao, dOs + frag + kk * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4], bv[4];
          const int off = (half * 32 + np * 16) * LD + col_off + kk * 16;
          tc::ldmatrix_x4(bk, Kt + off);
          tc::ldmatrix_x4(bv, Vt + off);
          tc::mma_bf16(s[2 * np], aq, bk[0], bk[1]);
          tc::mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
          tc::mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
          tc::mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qw0 + lane / 4 + (e / 2) * 8;
          const int key = kh0 + j * 8 + (lane % 4) * 2 + (e % 2);
          const bool keep = !edge || visible(row, key, S, causal, window);
          const float p =
              keep ? exp2f(s[j][e] * scale_log2 - lse2[e / 2]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;     // ds
        }
    }
    // dS in bf16 (zeros where the warp saw nothing) for the dQ product
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      *reinterpret_cast<uint32_t*>(ds_out + j * 8) =
          tc::pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(ds_out + 8 * XLD + j * 8) =
          tc::pack_bf16(s[j][2], s[j][3]);
    }
    __syncthreads();                 // dS is in shared memory
    // dQ += dS K over the tile's 64 keys, this warp's 16 rows and column
    // half; the keys are the k dimension
    const bool rows_seen = qw0 < S && !(causal && k0 > qw0 + 15) &&
                           !(window > 0 && k0 + BS - 1 <= qw0 - window);
    if (rows_seen) {
#pragma unroll
      for (int kj = 0; kj < BS / 16; ++kj) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, ds_frag + kj * 16);
        const int off = kj * 16 * LD + row_off + half * (DP / 2);
#pragma unroll
        for (int dn = 0; dn < DP / 32; ++dn) {
          uint32_t bk[4];
          tc::ldmatrix_x4_trans(bk, Kt + off + dn * 16);
          tc::mma_bf16(adq[2 * dn], a, bk[0], bk[1]);
          tc::mma_bf16(adq[2 * dn + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* gb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qw0 + lane / 4 + (e / 2) * 8;
      const int c = half * (DP / 2) + j * 8 + (lane % 4) * 2 + (e % 2);
      if (row < S && c < D)
        gb[row * dqs.s + c] = __float2bfloat16_rn(adq[j][e]);
    }
}

// ---- the backward on Hopper's wgmma (bfloat16, D <= 128) -------------------
//
// Two warp-specialised kernels of 384 threads: two consumer warpgroups
// (threads 0-255, 64 rows each, 240 registers a thread by setmaxnreg) and a
// producer warpgroup (24 registers) of which one thread issues every copy.
// One tile shape serves every copy and operand: 64 rows x 64 columns of bf16
// (128 bytes a row) in the 128-byte swizzle, loaded by TMA from a 4-d map
// built from the tensor's own strides (zeros past S and past D); a head dim
// DP spans NC = DP / 64 rounded up of them (D 96 computes its products' N
// over 128 columns, D 32 over 64).
//
// * dK/dV, a block per (b, kv head g, 128 kv rows), warpgroup w owning keys
//   k0 + 64 w ...: K and V stay resident; Q and dO tiles of 64 q rows, with
//   their lse log2 e and delta (cp.async.bulk from the pre-pass's padded
//   rows), stream through a 3-stage ring (full / empty mbarriers), every q
//   tile of every query head of g that can see the block, heads then tiles
//   in order (the GQA sum in a fixed order). A step of warpgroup w:
//     dP^T = V_w dO^T                    wgmma, A and B K-major in shared
//     P^T = exp2(S^T scale log2 e - lse log2 e)  (0 where masked)
//     dV_w += P^T dO                     wgmma, P^T bf16 from registers,
//                                        dO MN-major in shared memory
//     S^T(next) = K_w Q(next)^T          wgmma
//     dS^T = P^T (dP^T - delta) scale    (P^T as rounded for dV)
//     dK_w += dS^T Q                     wgmma, dS^T bf16 from registers
//   dK_w and dV_w stay in float32 registers (64 each at DP 128).
// * dQ, a block per (b, h, 128 q rows), warpgroup w owning queries q0 +
//   64 w ...: Q and dO resident, K and V tiles of 64 kv rows streamed; dP =
//   dO_w V^T, P from S = Q_w K^T, S(next), dS in float32, dQ_w += dS K (K
//   MN-major). 14 D flops a visible pair in all (dQ recomputes S and dP),
//   no atomics: both kernels write each output element once.
//
// Overlap. Each product is its own wgmma group, and wgmma.wait_group lets a
// warpgroup work while one is in flight: dP's product runs under P's exp2;
// dV's and the next step's S under dS (the next S is issued before this
// step's dS work, once dP has landed); only dK (dK/dV) or dQ (dQ) is
// waited for with nothing to do. No product is in flight across the loop's
// back edge, and no register is written by other instructions while a
// product that reads or writes it is in flight, or ptxas serialises every
// wgmma of the kernel (its C7514 / C7515 notes; a variant that carried the
// next step's products across the back edge ran 1.9x slower). In dK/dV the
// two warpgroups take turns to issue each batch of products (named
// barriers), so one's exp2 and dS run while the other's products fill the
// tensor cores; in dQ, whose steps are shorter, turns cost more than they
// gave, and the warpgroups run unsynchronised. The producer keeps the ring
// loading throughout. Masks are evaluated without branches and only on
// steps that hold a masked pair.
template <int DP>
struct BwdHop {
  static constexpr int NT = 384;
  static constexpr int NC = (DP + 63) / 64;     // 64-column chunks of a row
  static constexpr int KS = DP / 16;            // k16 steps over the head dim
  static constexpr int TILE = 64 * 64 * 2;      // bytes of a 64 x 64 chunk
  static constexpr int NS = 3;                  // stages of the ring
  static constexpr int RES = 4 * NC * TILE;     // resident: 2 x 128 rows
  static constexpr int STAGE = 2 * NC * TILE;   // streamed: 2 x 64 rows
  static constexpr int VEC = RES + NS * STAGE;  // lse log2 e, delta (dK/dV)
  static constexpr int BARS = VEC + NS * 512;
  static constexpr int BYTES = BARS + 8 * (2 * NS + 1) + 1024;  // + align
};

// What the wgmma kernels read besides their tensor maps: the pre-pass's
// rows (lse log2 e and delta, [B, H, s_pad] float32, zeros past S) and the
// outputs (dK and dV, or dQ and nothing).
struct HopArgs {
  const float* lse2;
  const float* delta;
  __nv_bfloat16* g0;
  __nv_bfloat16* g1;
  Strides g0s, g1s;
  int H, rep, S, s_pad, D;
  float scale, scale_log2;
  int causal, window;
};

// delta = rowsum(dO * O) and lse log2 e of every row of [B, H, s_pad] (0
// past S): one warp a row.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse2, Strides os, Strides dos, int H,
                      int S, int s_pad, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  float acc = 0.f, l = 0.f;
  if (row < S) {
    const __nv_bfloat16* o = out + b * os.b + h * os.h + row * os.s;
    const __nv_bfloat16* g = dout + b * dos.b + h * dos.h + row * dos.s;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(__bfloat162float(o[d]), __bfloat162float(g[d]), acc);
    l = lse[bh * S + row] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[bh * s_pad + row] = acc;
    lse2[bh * s_pad + row] = l;
  }
}

// acc = A B^T over the head dim (S^T = K Q^T, dP^T = V dO^T, S = Q K^T,
// dP = dO V^T): 64-row tiles at `a` and `b`, both K-major; one wgmma group.
template <int DP>
__device__ __forceinline__ void hop_scores(float (&acc)[32], uint32_t a,
                                           uint32_t b) {
  using Tl = BwdHop<DP>;
#pragma unroll
  for (int kk = 0; kk < Tl::KS; ++kk) {
    const uint32_t off = (kk / 4) * Tl::TILE + (kk % 4) * 32;
    hop::wgmma_m64n64k16_ss(acc, hop::desc_sw128(a + off, 16, 1024),
                            hop::desc_sw128(b + off, 16, 1024), kk > 0);
  }
  hop::wgmma_commit();
}

// acc[c] += A B over 64 rows of K: A (64 x 64, bf16) from registers, k16
// step kk in fr[kk]; B the 64-row tile at `b`, MN-major; one wgmma group.
template <int DP>
__device__ __forceinline__ void hop_accumulate(float (&acc)[BwdHop<DP>::NC][32],
                                               const uint32_t (&fr)[4][4],
                                               uint32_t b) {
  using Tl = BwdHop<DP>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < Tl::NC; ++c)
      hop::wgmma_m64n64k16_rs_mn(
          acc[c], fr[kk],
          hop::desc_sw128(b + c * Tl::TILE + kk * 2048, Tl::TILE, 1024));
  hop::wgmma_commit();
}

// The k16 A fragments of a 64 x 64 accumulator, rounded to bf16.
__device__ __forceinline__ void hop_pack(uint32_t (&fr)[4][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      fr[kk][r] = tc::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Element e of the accumulator that hop_pack rounded into fr.
__device__ __forceinline__ float hop_unpack(const uint32_t (&fr)[4][4],
                                            int e) {
  const uint32_t u = fr[e / 8][(e % 8) / 2];
  return __uint_as_float(e % 2 ? u & 0xffff0000u : u << 16);
}

// visible() without branches, for the wgmma kernels: a branch a score
// splits a warp inside a step and cost them as much as their products.
__device__ __forceinline__ bool hop_keep(int qpos, int kpos, int S,
                                         int causal, int window) {
  return (qpos < S) & (kpos < S) & (!causal | (kpos <= qpos)) &
         ((window <= 0) | (kpos > qpos - window));
}

__device__ __forceinline__ uint8_t* hop_base(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
}

// dK and dV of one (b, kv head g, 128 kv rows); see the note above.
template <int DP>
__global__ void __launch_bounds__(BwdHop<DP>::NT, 1)
flash_bwd_dkdv_hop_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          const HopArgs a) {
  using Tl = BwdHop<DP>;
  constexpr int NC = Tl::NC, TILE = Tl::TILE, NS = Tl::NS;
  extern __shared__ uint8_t hop_smem[];
  uint8_t* base = hop_base(hop_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Tl::BARS);
  uint64_t* empty = full + NS;
  uint64_t* once = empty + NS;

  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = static_cast<int>(blockIdx.x) * 128;  // tile 0 the heaviest
  const int S = a.S;
  const int n_q = (S + 63) / 64;
  const int qt_lo = a.causal ? k0 / 64 : 0;           // q tiles that see it
  int qt_hi = n_q;
  if (a.window > 0) qt_hi = min(n_q, (k0 + 128 + a.window - 2) / 64 + 1);
  const int nqt = qt_hi - qt_lo;
  const int n = a.rep * nqt;                          // steps: heads x tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);                   // a consumer warp each
    }
    hop::mbar_init(once, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (wg == 2) {                                      // the producer
    hop::regs_dec<24>();
    if (threadIdx.x == 256) {
      hop::tma_prefetch_map(&qmap);
      hop::tma_prefetch_map(&omap);
      hop::mbar_expect_tx(once, 4 * NC * TILE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          hop::tma_load_4d(base + (w * NC + c) * TILE, &kmap, once, c * 64,
                           k0 + 64 * w, g, b);
          hop::tma_load_4d(base + (2 * NC + w * NC + c) * TILE, &vmap, once,
                           c * 64, k0 + 64 * w, g, b);
        }
      for (int i = 0; i < n; ++i) {
        const int st = i % NS;
        const int h = g * a.rep + i / nqt, q0 = (qt_lo + i % nqt) * 64;
        hop::mbar_wait(&empty[st], ((i / NS) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], 2 * NC * TILE + 512);
        uint8_t* tiles = base + Tl::RES + st * Tl::STAGE;
        for (int c = 0; c < NC; ++c) {
          hop::tma_load_4d(tiles + c * TILE, &qmap, &full[st], c * 64, q0, h,
                           b);
          hop::tma_load_4d(tiles + (NC + c) * TILE, &omap, &full[st], c * 64,
                           q0, h, b);
        }
        const long long row = (static_cast<long long>(b) * a.H + h) * a.s_pad
                              + q0;
        float* vec = reinterpret_cast<float*>(base + Tl::VEC + st * 512);
        hop::bulk_load(vec, a.lse2 + row, 256, &full[st]);
        hop::bulk_load(vec + 64, a.delta + row, 256, &full[st]);
      }
    }
  } else {                                            // consumers
    hop::regs_inc<240>();
    const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32;
    const int kw0 = k0 + 64 * wg;                      // this warpgroup's keys
    const int key_r = kw0 + 16 * wi + lane / 4;        // + 8 ((e / 2) % 2)
    const uint32_t kA = hop::smem_u32(base + wg * NC * TILE);
    const uint32_t vA = hop::smem_u32(base + (2 * NC + wg * NC) * TILE);
    const uint32_t ring = hop::smem_u32(base + Tl::RES);
    float dk[NC][32], dv[NC][32], s[32], dp[32], p[32];
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;
    hop::mbar_wait(once, 0);
    // A step starts with its S^T in registers. The warpgroups take turns to
    // issue their products (named barrier 1 + w is warpgroup w's turn: it
    // waits on its own, then lets the other go): warpgroup 0 first, and
    // warpgroup 1 leaves its last turn unsignalled, so every arrival meets
    // a wait.
    if (wg == 1 && n > 0) hop::bar_arrive(1, 256);
    if (n > 0) {
      hop::mbar_wait(&full[0], 0);
      hop::bar_sync(1 + wg, 256);
      hop::wgmma_fence();
      hop_scores<DP>(s, kA, ring);
      hop::bar_arrive(2 - wg, 256);
      hop::wgmma_wait<0>();
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % NS, st1 = (i + 1) % NS;
      const bool next = i + 1 < n;
      const int q0 = (qt_lo + i % nqt) * 64;
      const float* vec =
          reinterpret_cast<const float*>(base + Tl::VEC + st * 512);
      const uint32_t qB = ring + st * Tl::STAGE, oB = qB + NC * TILE;
      const uint32_t qB1 = ring + st1 * Tl::STAGE;
      hop::fence_regs(s);
      hop::bar_sync(1 + wg, 256);
      hop::wgmma_fence();
      hop_scores<DP>(dp, vA, oB);              // dP^T(i) under P^T's exp2
      hop::bar_arrive(2 - wg, 256);
      const bool edge = (a.causal && kw0 + 63 > q0) ||
                        (a.window > 0 && q0 + 63 - a.window >= kw0) ||
                        q0 + 64 > S || kw0 + 64 > S;
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
          const float x = exp2f(s[e] * a.scale_log2 - vec[col]);
          p[e] =
              hop_keep(q0 + col, key_r + 8 * ((e / 2) % 2), S, a.causal,
                       a.window) ? x : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
          p[e] = exp2f(s[e] * a.scale_log2 - vec[col]);
        }
      }
      hop_pack(pa, p);
      hop::bar_sync(1 + wg, 256);
      hop::wgmma_fence();
      hop_accumulate<DP>(dv, pa, oB);          // dV(i) under dS^T
      hop::wgmma_wait<1>();                    // dP^T(i)
      hop::fence_regs(dp);
      if (next) {                              // S^T(i+1) under dS^T too
        hop::mbar_wait(&full[st1], ((i + 1) / NS) & 1);
        hop_scores<DP>(s, kA, qB1);
      }
      hop::bar_arrive(2 - wg, 256);
      float ds[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        ds[e] = hop_unpack(pa, e) * (dp[e] - vec[64 + col]) * a.scale;
      }
      hop_pack(sa, ds);
      hop::bar_sync(1 + wg, 256);
      hop::wgmma_fence();
      hop_accumulate<DP>(dk, sa, qB);
      if (!(wg == 1 && !next)) hop::bar_arrive(2 - wg, 256);
      hop::wgmma_wait<0>();
      hop::fence_regs(pa);
      hop::fence_regs(sa);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[st]);   // the stage is free
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hop::fence_regs(dk[c]);
      hop::fence_regs(dv[c]);
    }
    __nv_bfloat16* dkb = a.g0 + b * a.g0s.b + g * a.g0s.h;
    __nv_bfloat16* dvb = a.g1 + b * a.g1s.b + g * a.g1s.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = key_r + 8 * ((e / 2) % 2);
        const int col = 64 * c + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        if (row < S && col < a.D) {
          dkb[row * a.g0s.s + col] = __float2bfloat16_rn(dk[c][e]);
          dvb[row * a.g1s.s + col] = __float2bfloat16_rn(dv[c][e]);
        }
      }
  }
}

// dQ of one (b, h, 128 q rows); see the note above.
template <int DP>
__global__ void __launch_bounds__(BwdHop<DP>::NT, 1)
flash_bwd_dq_hop_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap,
                        const HopArgs a) {
  using Tl = BwdHop<DP>;
  constexpr int NC = Tl::NC, TILE = Tl::TILE, NS = Tl::NS;
  extern __shared__ uint8_t hop_smem[];
  uint8_t* base = hop_base(hop_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Tl::BARS);
  uint64_t* empty = full + NS;
  uint64_t* once = empty + NS;

  const int S = a.S;
  const int n_qt = (S + 127) / 128;
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);  // heavy first
  const int q0 = qt * 128;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int t_lo = a.window > 0 ? max(0, q0 - a.window + 1) / 64 : 0;
  const int t_hi = a.causal ? min(q0 + 127, S - 1) / 64 + 1 : (S + 63) / 64;
  const int n = t_hi - t_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);
    }
    hop::mbar_init(once, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (wg == 2) {                                      // the producer
    hop::regs_dec<24>();
    if (threadIdx.x == 256) {
      hop::tma_prefetch_map(&kmap);
      hop::tma_prefetch_map(&vmap);
      hop::mbar_expect_tx(once, 4 * NC * TILE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          hop::tma_load_4d(base + (w * NC + c) * TILE, &qmap, once, c * 64,
                           q0 + 64 * w, h, b);
          hop::tma_load_4d(base + (2 * NC + w * NC + c) * TILE, &omap, once,
                           c * 64, q0 + 64 * w, h, b);
        }
      for (int j = 0; j < n; ++j) {
        const int st = j % NS, kv0 = (t_lo + j) * 64;
        hop::mbar_wait(&empty[st], ((j / NS) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], 2 * NC * TILE);
        uint8_t* tiles = base + Tl::RES + st * Tl::STAGE;
        for (int c = 0; c < NC; ++c) {
          hop::tma_load_4d(tiles + c * TILE, &kmap, &full[st], c * 64, kv0, g,
                           b);
          hop::tma_load_4d(tiles + (NC + c) * TILE, &vmap, &full[st], c * 64,
                           kv0, g, b);
        }
      }
    }
  } else {                                            // consumers
    hop::regs_inc<240>();
    const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32;
    const int qw0 = q0 + 64 * wg;                      // this warpgroup's rows
    const int row_r = qw0 + 16 * wi + lane / 4;        // + 8 ((e / 2) % 2)
    const uint32_t qA = hop::smem_u32(base + wg * NC * TILE);
    const uint32_t oA = hop::smem_u32(base + (2 * NC + wg * NC) * TILE);
    const uint32_t ring = hop::smem_u32(base + Tl::RES);
    const long long rows = (static_cast<long long>(b) * a.H + h) * a.s_pad;
    const float lse2_r[2] = {a.lse2[rows + row_r], a.lse2[rows + row_r + 8]};
    const float dl_r[2] = {a.delta[rows + row_r], a.delta[rows + row_r + 8]};
    float dq[NC][32], s[32], dp[32], p[32];
    uint32_t sa[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
    hop::mbar_wait(once, 0);
    if (n > 0) {
      hop::mbar_wait(&full[0], 0);
      hop::wgmma_fence();
      hop_scores<DP>(s, qA, ring);
      hop::wgmma_wait<0>();
    }
    for (int j = 0; j < n; ++j) {
      const int st = j % NS, st1 = (j + 1) % NS;
      const bool next = j + 1 < n;
      const int kv0 = (t_lo + j) * 64;
      const uint32_t kB = ring + st * Tl::STAGE;
      const uint32_t kB1 = ring + st1 * Tl::STAGE;
      hop::fence_regs(s);
      hop::wgmma_fence();
      hop_scores<DP>(dp, oA, kB + NC * TILE);  // dP(j) under P's exp2
      const bool edge = (a.causal && kv0 + 63 > qw0) ||
                        (a.window > 0 && qw0 + 63 - a.window >= kv0) ||
                        qw0 + 64 > S || kv0 + 64 > S;
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e / 2) % 2;
          const int key = kv0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
          const float x = exp2f(s[e] * a.scale_log2 - lse2_r[r]);
          p[e] = hop_keep(row_r + 8 * r, key, S, a.causal, a.window) ? x
                                                                     : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          p[e] = exp2f(s[e] * a.scale_log2 - lse2_r[(e / 2) % 2]);
      }
      hop::wgmma_wait<0>();                    // dP(j)
      hop::fence_regs(dp);
      if (next) {                              // S(j+1) under dS
        hop::mbar_wait(&full[st1], ((j + 1) / NS) & 1);
        hop::wgmma_fence();
        hop_scores<DP>(s, qA, kB1);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        p[e] = p[e] * (dp[e] - dl_r[(e / 2) % 2]) * a.scale;    // dS
      hop_pack(sa, p);
      hop::wgmma_fence();
      hop_accumulate<DP>(dq, sa, kB);
      hop::wgmma_wait<0>();
      hop::fence_regs(sa);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) hop::fence_regs(dq[c]);
    __nv_bfloat16* dqb = a.g0 + b * a.g0s.b + h * a.g0s.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = row_r + 8 * ((e / 2) % 2);
        const int col = 64 * c + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        if (row < S && col < a.D)
          dqb[row * a.g0s.s + col] = __float2bfloat16_rn(dq[c][e]);
      }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, H, Hkv, S, D;
  float scale;
  int causal, window;
};

template <typename T, int DMAX>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using Tl = BwdTile<DMAX>;
  const int rep = a.H / a.Hkv;
  flash_bwd_delta_kernel<T><<<dim3((a.S + 7) / 8, a.H, a.B), 256, 0,
                              stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta,
      a.os, a.dos, a.H, a.S, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = Tl::DQ_FLOATS * static_cast<int>(sizeof(float));
  auto dq_kern = flash_bwd_dq_kernel<T, DMAX>;
  err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const int n_t = (a.S + Tl::BM - 1) / Tl::BM;
  dq_kern<<<dim3(n_t, a.H, a.B), Tl::NT, dq_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.H,
      rep, a.S, a.D, a.scale, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkv_bytes = Tl::DKV_FLOATS * static_cast<int>(sizeof(float));
  auto dkv_kern = flash_bwd_dkdv_kernel<T, DMAX>;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  dkv_kern<<<dim3(n_t, a.Hkv, a.B), Tl::NT, dkv_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.H, rep, a.S, a.D, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

// float32 (and float32 copies of mixed inputs) on the CUDA cores
template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_bwd<T, 64>(a, stream);
  if (a.D <= 128) return launch_bwd<T, 128>(a, stream);
  return launch_bwd<T, 256>(a, stream);
}

cudaError_t launch_delta_bf16(const BwdArgs& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  flash_bwd_delta_kernel<bf><<<dim3((a.S + 7) / 8, a.H, a.B), 256, 0,
                               stream>>>(
      static_cast<const bf*>(a.out), static_cast<const bf*>(a.dout), a.delta,
      a.os, a.dos, a.H, a.S, a.D);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_mma(const BwdArgs& a, int vec, cudaStream_t stream) {
  using Tl = BwdMma<DP>;
  const int rep = a.H / a.Hkv;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  using bf = __nv_bfloat16;
  cudaError_t err = launch_delta_bf16(a, stream);
  if (err != cudaSuccess) return err;

  auto dq_kern = flash_bwd_dq_mma_kernel<DP>;
  err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::DQ_BYTES);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3((a.S + Tl::BR - 1) / Tl::BR, a.H, a.B), Tl::NT,
            Tl::DQ_BYTES, stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.H,
      rep, a.S, a.D, a.scale, scale_log2, a.causal, a.window, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kern = flash_bwd_dkdv_mma_kernel<DP>;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::DKV_BYTES);
  if (err != cudaSuccess) return err;
  dkv_kern<<<dim3((a.S + Tl::BR - 1) / Tl::BR, a.Hkv, a.B), Tl::NT,
             Tl::DKV_BYTES, stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.H, rep, a.S, a.D, a.scale, scale_log2,
      a.causal, a.window, vec);
  return cudaGetLastError();
}

// The dynamic shared memory a wide kernel asks for, with the SM's carveout
// at its largest (one block an SM).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links against nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, heads, S, D] bf16 tensor of strides `st` (elements, the head dim
// contiguous) as a 4-d TMA map of 64 x 64 boxes in the 128-byte swizzle:
// rows past S and columns past D read as zeros.
cudaError_t tile_map(CUtensorMap* map, const void* p, const Strides& st,
                     int B, int heads, int S, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch_bwd_hop(const BwdArgs& a, cudaStream_t stream) {
  using Tl = BwdHop<DP>;
  using bf = __nv_bfloat16;
  const int s_pad = (a.S + 127) / 128 * 128;
  float* lse2 = a.delta + static_cast<long long>(a.B) * a.H * s_pad;
  flash_bwd_prep_kernel<<<dim3(s_pad / 8, a.H, a.B), 256, 0, stream>>>(
      static_cast<const bf*>(a.out), static_cast<const bf*>(a.dout), a.lse,
      a.delta, lse2, a.os, a.dos, a.H, a.S, s_pad, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, om;
  if ((err = tile_map(&qm, a.q, a.qs, a.B, a.H, a.S, a.D)) != cudaSuccess ||
      (err = tile_map(&km, a.k, a.ks, a.B, a.Hkv, a.S, a.D)) != cudaSuccess ||
      (err = tile_map(&vm, a.v, a.vs, a.B, a.Hkv, a.S, a.D)) != cudaSuccess ||
      (err = tile_map(&om, a.dout, a.dos, a.B, a.H, a.S, a.D)) != cudaSuccess)
    return err;
  HopArgs args{lse2, a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
               a.dks, a.dvs, a.H, a.H / a.Hkv, a.S, s_pad, a.D, a.scale,
               a.scale * kLog2e, a.causal, a.window};

  auto dkv_kern = flash_bwd_dkdv_hop_kernel<DP>;
  err = allow_smem(dkv_kern, Tl::BYTES);
  if (err != cudaSuccess) return err;
  dkv_kern<<<dim3(s_pad / 128, a.Hkv, a.B), Tl::NT, Tl::BYTES, stream>>>(
      qm, km, vm, om, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  args.g0 = static_cast<bf*>(a.dq);
  args.g0s = a.dqs;
  auto dq_kern = flash_bwd_dq_hop_kernel<DP>;
  err = allow_smem(dq_kern, Tl::BYTES);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3(s_pad / 128, a.H, a.B), Tl::NT, Tl::BYTES, stream>>>(
      qm, km, vm, om, args);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_wide(const BwdArgs& a, int vec, cudaStream_t stream) {
  using Tl = BwdWide<DP>;
  using bf = __nv_bfloat16;
  const int rep = a.H / a.Hkv;
  const float scale_log2 = a.scale * kLog2e;
  const int n_t = (a.S + Tl::BR - 1) / Tl::BR;
  cudaError_t err = launch_delta_bf16(a, stream);
  if (err != cudaSuccess) return err;

  auto dq_kern = flash_bwd_dq_wide_kernel<DP>;
  err = allow_smem(dq_kern, Tl::DQ_BYTES);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3(n_t, a.H, a.B), Tl::NT, Tl::DQ_BYTES, stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.H,
      rep, a.S, a.D, a.scale, scale_log2, a.causal, a.window, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kern = flash_bwd_dkdv_wide_kernel<DP>;
  err = allow_smem(dkv_kern, Tl::DKV_BYTES);
  if (err != cudaSuccess) return err;
  dkv_kern<<<dim3(n_t, a.Hkv, a.B), Tl::NT, Tl::DKV_BYTES, stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.H, rep, a.S, a.D, a.scale, scale_log2,
      a.causal, a.window, vec);
  return cudaGetLastError();
}

bool strides_positive(const Strides& s) {
  return s.b > 0 && s.h > 0 && s.s > 0;
}

// bfloat16: the tensor cores at every head dim, DP the head dim rounded up
// to 32 as the forward buckets it. Up to 128 the wgmma kernels where TMA
// can read q, k, v and dO (16-byte copies: `vec`, and no zero stride), the
// mma.sync ones otherwise; past 128 the wide kernels. `route` receives 2,
// 1 or 3 (before the launch).
cudaError_t dispatch_bwd_bf16(const BwdArgs& a, cudaStream_t stream,
                              int* route) {
  const int vec = a.D % 8 == 0 && on16(a.q) && on16(a.k) && on16(a.v) &&
                  on16(a.dout) && strides8(a.qs) && strides8(a.ks) &&
                  strides8(a.vs) && strides8(a.dos);
  const int dp = (a.D + 31) / 32;
  if (dp <= 4 && vec && strides_positive(a.qs) && strides_positive(a.ks) &&
      strides_positive(a.vs) && strides_positive(a.dos)) {
    *route = 2;
    switch (dp) {
      case 1: return launch_bwd_hop<32>(a, stream);
      case 2: return launch_bwd_hop<64>(a, stream);
      case 3: return launch_bwd_hop<96>(a, stream);
      default: return launch_bwd_hop<128>(a, stream);
    }
  }
  *route = dp <= 4 ? 1 : 3;
  switch (dp) {
    case 1: return launch_bwd_mma<32>(a, vec, stream);
    case 2: return launch_bwd_mma<64>(a, vec, stream);
    case 3: return launch_bwd_mma<96>(a, vec, stream);
    case 4: return launch_bwd_mma<128>(a, vec, stream);
    case 5: return launch_bwd_wide<160>(a, vec, stream);
    case 6: return launch_bwd_wide<192>(a, vec, stream);
    case 7: return launch_bwd_wide<224>(a, vec, stream);
    case 8: return launch_bwd_wide<256>(a, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32 (the CUDA-core kernel), 1
// bfloat16 (the tensor-core kernel). Strides are
// in elements, three per tensor: (batch, head, position); the head dim is
// contiguous. window <= 0 means no window. H must be a multiple of Hkv;
// 1 <= D <= 256; B and H at most 65535. `lse` (contiguous [B, H, S]
// float32) may be null; given, it receives each row's log-sum-exp.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
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
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, lse_f, qs, ks, vs, os, B, H, Hkv, S,
                          D, scale, causal, window, st);
  else if (dtype == 1)
    err = dispatch_mma(q, k, v, out, lse_f, qs, ks, vs, os, B, H, Hkv, S, D,
                       scale, causal, window, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// The backward: dq [B, H, S, D], dk and dv [B, Hkv, S, D] from q, k, v, out,
// dout and the forward's lse (contiguous [B, H, S] float32); `delta` is
// scratch of 2 B H s_pad float32, s_pad = S rounded up to 128. Three
// launches on `stream`: the delta pre-pass, dQ, and dK/dV. Strides as for
// the forward; dtype 0 float32, 1 bfloat16 (every tensor in that dtype).
// `route` receives the kernels' route, chosen before any launch: 0 float32
// on the CUDA cores, 1 bf16 mma.sync up to D 128, 2 bf16 wgmma up to D 128,
// 3 bf16 past D 128.
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides,
    const long long* do_strides, const long long* dq_strides,
    const long long* dk_strides, const long long* dv_strides, int B, int H,
    int Hkv, int S, int D, float scale, int causal, int window, int dtype,
    int device, void* stream, int* route) {
  *route = dtype == 0 ? 0 : -1;
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st3 = [](const long long* p) { return Strides{p[0], p[1], p[2]}; };
  const BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, st3(q_strides),
                  st3(k_strides), st3(v_strides), st3(o_strides),
                  st3(do_strides), st3(dq_strides), st3(dk_strides),
                  st3(dv_strides), B, H, Hkv, S, D, scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_bwd<float>(a, st);
  else if (dtype == 1)
    err = dispatch_bwd_bf16(a, st, route);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
