// Tensor-core and asynchronous-copy building blocks shared by the port's
// Hopper kernels (sm_90a), as inline PTX: 16-byte cp.async with zero fill,
// ldmatrix (plain and transposed) and the bf16 m16n8k16 mma.sync with
// float32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16, row-major, 4 registers of two bf16 each:
//     a0 (row g,     cols 2t, 2t+1)   a1 (row g + 8, cols 2t, 2t+1)
//     a2 (row g,     cols 2t+8, +9)   a3 (row g + 8, cols 2t+8, +9)
//   B 16 x 8 (k x n), 2 registers:
//     b0 (k 2t, 2t+1; col g)          b1 (k 2t+8, 2t+9; col g)
//   C/D 16 x 8, 4 floats:
//     c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g + 8, cols 2t, 2t+1)
// The lower 16 bits of a register hold the element of lower index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; `src_bytes` < 16 fills the
// rest with zeros (0: all zeros, nothing is read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way (a k-major tile read as the
// "col" B operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b on one 16 x 8 tile, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
