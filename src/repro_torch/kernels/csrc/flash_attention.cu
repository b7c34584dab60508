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

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
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
                     __nv_bfloat16* __restrict__ out, Strides qs, Strides ks,
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
                       void* out, const Strides& qs, const Strides& ks,
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
      qs, ks, vs, os, H / Hkv, S, D, scale * 1.4426950408889634f, causal,
      window, vec);
  return cudaGetLastError();
}

bool on16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool strides8(const Strides& s) {
  return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0;
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, const Strides& qs, const Strides& ks,
                         const Strides& vs, const Strides& os, int B, int H,
                         int Hkv, int S, int D, float scale, int causal,
                         int window, cudaStream_t stream) {
  const int vec = D % 8 == 0 && on16(q) && on16(k) && on16(v) && on16(out) &&
                  strides8(qs) && strides8(ks) && strides8(vs) &&
                  strides8(os);
#define REPRO_FA_CASE(DP)                                                    \
  case DP / 32:                                                              \
    return launch_mma<DP>(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D,     \
                          scale, causal, window, vec, stream);
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

}  // namespace

// Launches on `stream` (a cudaStream_t) of `device`; returns the launch's
// cudaError_t (0 on success). dtype 0 is float32 (the CUDA-core kernel), 1
// bfloat16 (the tensor-core kernel). Strides are
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
    err = dispatch_mma(q, k, v, out, qs, ks, vs, os, B, H, Hkv, S, D, scale,
                       causal, window, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
