// The device SA's swap delta, and its whole annealing loop, for Hopper (sm_90a).
//
// delta_cost_kernel: per-chain O(degree) swap delta
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
//
// sa_chains_kernel: R annealing chains, `iters` steps each, in one launch
//
// The reference runs its device SA as one jitted lax.scan whose body calls
// delta_cost_pallas (repro/core/placement/device_search.py::_sa_chains). A
// loop of small launches on this card pays about 61 launches a step on the
// host; this kernel keeps the loop on the card instead. One warp owns one
// chain: its slots array lives in shared memory, its cost, best cost and
// temperature in registers (every lane holds the same values, so the warp
// never diverges on them). Each step, in the reference's order:
//   1. proposed = !(i == j || (i >= n && j >= n));
//   2. the delta of swapping slots i and j, over node a's D incident entries
//      and then node b's (the sentinel row n serves a free slot; a-b edges
//      are zeroed in b's half), through warp_delta, the same function the
//      standalone kernel runs, so both give the same bits;
//   3. accept = proposed && (delta <= 0 || u < expf(min(-delta / max(t,
//      1e-9), 0))), computed by every lane from the broadcast delta;
//   4. the swap in shared memory, then __syncwarp();
//   5. cost += accept ? delta : 0;
//   6. every refresh_every steps, cost = the float64 sum of e_vol * hops over
//      the E edges, rounded once to float32;
//   7. on a strict improvement, best = cost and the warp copies its slots
//      to best_slots in device memory;
//   8. t *= cooling.
// Before the loop t = max(t0 * max(cost0, 1), 1e-9). Arithmetic is IEEE
// (explicit _rn intrinsics, expf, no fast math), as torch's on the card, so
// the kernel agrees bit for bit with the Python loop that launches
// delta_cost_kernel once a step, wherever that loop's float64 refresh sums
// are exact (integer volumes and sums below 2^53).
//
// The draws arrive transposed to [R, iters] (i, j int32; u float32): each
// lane loads one step of the next 32, coalesced, and the warp broadcasts each
// step with __shfl_sync. The trajectory (cost, best cost, t, accepted,
// proposed) goes out the same way, 32 steps at a time into [R, iters]
// buffers. The hop table sits in dynamic shared memory when it fits beside
// the slots (C up to about 220), the incident tables too; otherwise they are
// read through the read-only cache from L2.
//
// Bound: a latency floor. The draws are read once (12 bytes a chain-step)
// and the trajectory written once (14 bytes): 8.3 MB at 64 chains x 5000
// steps, 2.5 us at 3.35 TB/s. But the steps of a chain are serial, and each
// is a chain of dependent shared-memory loads, a five-level shuffle tree, a
// division and an expf, some hundreds of cycles; the chains run side by
// side, one warp each, so the kernel's time is iters x one step's latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // delta_cost: 8 chains per block
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// sa_chains: warps (chains) a block; 1, 2, 4 and 8 ran within 5% of each
// other at 64 chains x 5000 steps on the H100, and 4 keeps 16 blocks on 16 SMs
constexpr int kChainsPerBlock = 4;

// A read of a table that sits in shared memory or, else, in device memory
// (through the read-only cache).
template <bool kShared, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

template <bool kShared>
__device__ __forceinline__ float hop(const float* hops, int s, int d, int C) {
  // one unsigned compare per endpoint rejects negatives and ids >= C
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(C) ||
      static_cast<unsigned>(d) >= static_cast<unsigned>(C))
    return 0.f;
  return load<kShared>(hops + static_cast<int64_t>(s) * C + d);
}

// One chain's swap delta over its K entries: lanes stride K, each entry is
// fetched by `entry(k, sb, db, sa, da, vol)`, and lane 0 ends with the sum.
// Both kernels call this, so they compute a delta with the same instructions.
template <bool kHopsShared, class Entry>
__device__ __forceinline__ float warp_delta(const float* hops, int C, int K,
                                            int lane, Entry entry) {
  float acc = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    int sb, db, sa, da;
    float v;
    entry(k, sb, db, sa, da, v);
    const float after = hop<kHopsShared>(hops, sa, da, C);
    const float before = hop<kHopsShared>(hops, sb, db, C);
    acc = __fmaf_rn(v, __fsub_rn(after, before), acc);
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  return acc;
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
  const float acc = warp_delta<false>(
      hops, C, K, lane,
      [&](int k, int& e_sb, int& e_db, int& e_sa, int& e_da, float& v) {
        const int64_t e = base + k;
        v = __ldg(vol + e);
        e_sa = __ldg(sa + e);
        e_da = __ldg(da + e);
        e_sb = __ldg(sb + e);
        e_db = __ldg(db + e);
      });
  if (lane == 0) out[r] = acc;
}

struct SaArgs {
  const int32_t* slots0;      // [R, S]
  const float* t0;            // [R]
  const int32_t* inc_other;   // [n + 1, D], values in [0, n]
  const float* inc_vol;       // [n + 1, D]
  const uint8_t* inc_src;     // [n + 1, D]
  const float* hops;          // [C, C]
  const int32_t* e_src;       // [E], values in [0, n)
  const int32_t* e_dst;       // [E]
  const float* e_vol;         // [E]
  const int32_t* draw_i;      // [R, iters], values in [0, S)
  const int32_t* draw_j;      // [R, iters]
  const float* draw_u;        // [R, iters]
  int32_t* best_slots;        // [R, S]
  float* best_cost;           // [R]
  float* tr_cost;             // [R, iters], and the four below
  float* tr_best;
  float* tr_t;
  uint8_t* tr_acc;
  uint8_t* tr_prop;
  float cooling;
  int R, S, n, D, C, E, iters, refresh_every;
};

// The chain's comm cost: a float64 sum over the E edges, rounded once.
template <bool kHopsShared>
__device__ __forceinline__ float warp_full_cost(const SaArgs& a,
                                                const int32_t* slots,
                                                const float* hops, int lane) {
  double acc = 0.0;
  for (int e = lane; e < a.E; e += kWarp) {
    const int s = slots[__ldg(a.e_src + e)];
    const int d = slots[__ldg(a.e_dst + e)];
    acc = __dadd_rn(acc, __dmul_rn(static_cast<double>(__ldg(a.e_vol + e)),
                                   static_cast<double>(hop<kHopsShared>(hops, s, d, a.C))));
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc = __dadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  return __double2float_rn(__shfl_sync(kFull, acc, 0));
}

template <bool kHopsShared, bool kIncShared>
__global__ void __launch_bounds__(kChainsPerBlock * kWarp)
    sa_chains_kernel(const SaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int S = a.S, n = a.n, D = a.D;

  // layout: [chains x S slots][C x C hops][(n+1) x D other, vol, src]
  unsigned char* cursor = smem + static_cast<size_t>(kChainsPerBlock) * S * 4;
  const float* hops_p = a.hops;
  if constexpr (kHopsShared) {
    float* h = reinterpret_cast<float*>(cursor);
    for (int x = threadIdx.x; x < a.C * a.C; x += blockDim.x)
      h[x] = __ldg(a.hops + x);
    hops_p = h;
    cursor += static_cast<size_t>(a.C) * a.C * 4;
  }
  const int32_t* other = a.inc_other;
  const float* ivol = a.inc_vol;
  const uint8_t* isrc = a.inc_src;
  if constexpr (kIncShared) {
    const int nd = (n + 1) * D;
    int32_t* o = reinterpret_cast<int32_t*>(cursor);
    float* v = reinterpret_cast<float*>(cursor + static_cast<size_t>(nd) * 4);
    uint8_t* s = cursor + static_cast<size_t>(nd) * 8;
    for (int x = threadIdx.x; x < nd; x += blockDim.x) {
      o[x] = __ldg(a.inc_other + x);
      v[x] = __ldg(a.inc_vol + x);
      s[x] = __ldg(a.inc_src + x);
    }
    other = o;
    ivol = v;
    isrc = s;
  }
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kChainsPerBlock + warp;
  int32_t* slots = reinterpret_cast<int32_t*>(smem) +
                   static_cast<size_t>(warp) * S;
  if (r < a.R) {
    for (int x = lane; x < S; x += kWarp) {
      const int32_t c = __ldg(a.slots0 + r * S + x);
      slots[x] = c;
      a.best_slots[r * S + x] = c;
    }
  }
  __syncthreads();                        // the only block-wide barrier
  if (r >= a.R) return;                   // uniform across the warp

  const int K = 2 * D;
  float cost = warp_full_cost<kHopsShared>(a, slots, hops_p, lane);
  float best = cost;
  float t = fmaxf(__fmul_rn(__ldg(a.t0 + r), fmaxf(cost, 1.f)), 1e-9f);
  const int64_t row = r * a.iters;
  for (int base = 0; base < a.iters; base += kWarp) {
    const int mine = base + lane;
    const bool live = mine < a.iters;
    const int my_i = live ? __ldg(a.draw_i + row + mine) : 0;
    const int my_j = live ? __ldg(a.draw_j + row + mine) : 0;
    const float my_u = live ? __ldg(a.draw_u + row + mine) : 0.f;
    float rec_cost = 0.f, rec_best = 0.f, rec_t = 0.f;
    uint8_t rec_acc = 0, rec_prop = 0;
    const int steps = min(kWarp, a.iters - base);
    for (int s = 0; s < steps; ++s) {
      const int i = __shfl_sync(kFull, my_i, s);
      const int j = __shfl_sync(kFull, my_j, s);
      const float u = __shfl_sync(kFull, my_u, s);
      const bool proposed = !(i == j || (i >= n && j >= n));
      const int ci = slots[i], cj = slots[j];
      const int na = i < n ? i : n;       // node id or the sentinel row n
      const int nb = j < n ? j : n;
      const float part = warp_delta<kHopsShared>(
          hops_p, a.C, K, lane,
          [&](int k, int& sb, int& db, int& sa, int& da, float& v) {
            const int half = k >= D;      // node a's entries, then node b's
            const int at = (half ? nb : na) * D + (k - half * D);
            const int oth = load<kIncShared>(other + at);
            // a-b edges count once, in node a's half
            v = oth == na ? 0.f : load<kIncShared>(ivol + at);
            const bool is_src = load<kIncShared>(isrc + at) != 0;
            const int oc_b = oth < n ? slots[oth] : 0;
            // the other endpoint moves too when it is the partner node
            const int oc_a = oth == na ? cj : (oth == nb ? ci : oc_b);
            const int cu_b = half ? cj : ci, cu_a = half ? ci : cj;
            sb = is_src ? cu_b : oc_b;
            db = is_src ? oc_b : cu_b;
            sa = is_src ? cu_a : oc_a;
            da = is_src ? oc_a : cu_a;
          });
      const float delta = __shfl_sync(kFull, part, 0);
      const bool accept =
          proposed &&
          (delta <= 0.f ||
           u < expf(fminf(__fdiv_rn(-delta, fmaxf(t, 1e-9f)), 0.f)));
      if (accept && lane == 0) {
        slots[i] = cj;
        slots[j] = ci;
      }
      __syncwarp();
      cost = __fadd_rn(cost, accept ? delta : 0.f);
      if ((base + s + 1) % a.refresh_every == 0)
        cost = warp_full_cost<kHopsShared>(a, slots, hops_p, lane);
      if (cost < best) {
        best = cost;
        for (int x = lane; x < S; x += kWarp)
          a.best_slots[r * S + x] = slots[x];
      }
      t = __fmul_rn(t, a.cooling);
      if (lane == s) {
        rec_cost = cost;
        rec_best = best;
        rec_t = t;
        rec_acc = accept;
        rec_prop = proposed;
      }
    }
    if (live) {
      a.tr_cost[row + mine] = rec_cost;
      a.tr_best[row + mine] = rec_best;
      a.tr_t[row + mine] = rec_t;
      a.tr_acc[row + mine] = rec_acc;
      a.tr_prop[row + mine] = rec_prop;
    }
  }
  if (lane == 0) a.best_cost[r] = best;
}

template <bool kHopsShared, bool kIncShared>
cudaError_t launch_sa(const SaArgs& a, size_t smem,
                      cudaStream_t stream) {
  auto* kernel = sa_chains_kernel<kHopsShared, kIncShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (a.R + kChainsPerBlock - 1) / kChainsPerBlock;
  kernel<<<blocks, kChainsPerBlock * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
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

// Runs R chains of `iters` annealing steps in one launch on `stream` of
// `device`; returns the launch's cudaError_t (0 on success). Shapes and
// value ranges are those of SaArgs; the caller has checked them. Four
// chains share a block; `hops_shared` and `inc_shared` place those tables in
// dynamic shared memory, whose size in bytes is `smem`, laid out as the
// kernel's comment says.
extern "C" int repro_sa_chains(
    const void* slots0, const void* t0, const void* inc_other,
    const void* inc_vol, const void* inc_src, const void* hops,
    const void* e_src, const void* e_dst, const void* e_vol,
    const void* draw_i, const void* draw_j, const void* draw_u,
    void* best_slots, void* best_cost, void* tr_cost, void* tr_best,
    void* tr_t, void* tr_acc, void* tr_prop, float cooling, int R, int S,
    int n, int D, int C, int E, int iters, int refresh_every, int hops_shared,
    int inc_shared, long long smem, int device, void* stream) {
  if (R <= 0) return 0;
  if (refresh_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SaArgs a{
      static_cast<const int32_t*>(slots0), static_cast<const float*>(t0),
      static_cast<const int32_t*>(inc_other),
      static_cast<const float*>(inc_vol),
      static_cast<const uint8_t*>(inc_src), static_cast<const float*>(hops),
      static_cast<const int32_t*>(e_src), static_cast<const int32_t*>(e_dst),
      static_cast<const float*>(e_vol), static_cast<const int32_t*>(draw_i),
      static_cast<const int32_t*>(draw_j), static_cast<const float*>(draw_u),
      static_cast<int32_t*>(best_slots), static_cast<float*>(best_cost),
      static_cast<float*>(tr_cost), static_cast<float*>(tr_best),
      static_cast<float*>(tr_t), static_cast<uint8_t*>(tr_acc),
      static_cast<uint8_t*>(tr_prop), cooling, R, S, n, D, C, E, iters,
      refresh_every};
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (hops_shared && inc_shared) err = launch_sa<true, true>(a, bytes, s);
  else if (hops_shared) err = launch_sa<true, false>(a, bytes, s);
  else if (inc_shared) err = launch_sa<false, true>(a, bytes, s);
  else err = launch_sa<false, false>(a, bytes, s);
  return static_cast<int>(err);
}
