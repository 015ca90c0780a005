// Tensor-core building blocks shared by the port's kernels (the MSDA
// kernels through msda_common.cuh, and window_attention_fwd.cu): bf16
// packing, the m16n8k16 bf16 product of mma.sync, and ldmatrix.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Two floats as a bf16 pair in one 32-bit register, lo in the low half: the
// operand format of mma.sync's bf16 fragments.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B on the tensor cores, one warp: A 16x16 bf16 (row-major
// fragment), B 16x8 bf16 (column fragment), D 16x8 float32.  With g = lane / 4
// and t = lane % 4 the fragments hold
//   a[0]: A[g][2t, 2t+1]    a[1]: A[g+8][2t, 2t+1]
//   a[2]: A[g][2t+8, +9]    a[3]: A[g+8][2t+8, +9]
//   b[0]: B[2t, 2t+1][g]    b[1]: B[2t+8, 2t+9][g]
//   d[0], d[1]: D[g][2t, 2t+1]    d[2], d[3]: D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one warp: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned), and
// r[i] receives matrix i's row g, elements 2t and 2t+1.  With .trans each
// matrix arrives transposed: r[i] holds its elements (2t, g) and (2t+1, g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
