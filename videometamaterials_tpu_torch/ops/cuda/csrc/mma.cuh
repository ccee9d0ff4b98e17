// Tensor-core tile building blocks shared by the temporal kernels and the
// split-K contraction (sm_90a; no library GEMM).
//
// Products run as mma.sync.aligned.m16n8k16 on bf16 operands with fp32
// accumulation. Operands are staged in shared memory by cp.async (16 bytes
// a thread, zero-filled past a ragged edge) and read into fragments with
// ldmatrix. Shared tiles keep rows padded by 16 bytes (a row pitch that is
// an odd number of 16-byte units): the eight row addresses of an ldmatrix
// phase then fall in eight different bank groups, which does what an XOR
// swizzle does without a layout function.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4, t = lane % 4,
//   A (16 x 16, row-major) a0: (g, 2t..2t+1), a1: (g+8, 2t..), a2: (g, 2t+8..),
//     a3: (g+8, 2t+8..)
//   B (16 x 8)             b0: (k 2t..2t+1, n g), b1: (k 2t+8.., n g)
//   C (16 x 8, fp32)       c0, c1: (g, 2t..2t+1), c2, c3: (g+8, 2t..2t+1)
#pragma once

#include "common.cuh"

namespace vmt {

// ---- cp.async

// 16 bytes global -> shared; valid == false fills the 16 bytes with zeros
// (the source address is not read, but must be a mapped pointer)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- ldmatrix

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two 8 x 8 matrices (lanes 0-15 give the row addresses): the B fragment
// of one n8 tile stored [n][k]
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// two 8 x 8 matrices transposed (lanes 0-15 give the row addresses): the B
// fragment of one n8 tile stored [k][n]
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// ---- the product

// d += a * b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- fragment addressing (lane's row address for ldsm_x4 / ldsm_x4_t)
//
// A tile stored row-major [m][k] (k contiguous), 16 x 16 at (m0, k0):
//   ldsm_x4(a, &tile[(m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8])
// A tile stored [k][m] (m contiguous: the contraction's A^T):
//   ldsm_x4_t(a, &tile[(k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0
//                      + ((lane >> 3) & 1) * 8])
// B stored [n][k] (k contiguous), two n8 tiles at (n0, k0): b of tile 0 is
// {r0, r1}, of tile 1 {r2, r3}:
//   ldsm_x4(r, &tile[(n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0
//                    + ((lane >> 3) & 1) * 8])
// B stored [k][n] (n contiguous), two n8 tiles at (k0, n0), same result:
//   ldsm_x4_t(r, &tile[(k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch
//                      + n0 + (lane >> 4) * 8])

__device__ __forceinline__ int a_row_off(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col_off(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row_off(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int bn_col_off(int lane) {
  return ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bk_row_off(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bk_col_off(int lane) { return (lane >> 4) * 8; }
// A^T ([k][m]) uses the B [n][k] offsets with the roles of the axes swapped
__device__ __forceinline__ int at_row_off(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int at_col_off(int lane) {
  return ((lane >> 3) & 1) * 8;
}

}  // namespace vmt
