// Pieces shared by the MSDA kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu, ms_deform_attn_r4.cu, ms_deform_attn_fk.cu): the
// level table, the value-type conversions, the two layouts of the query
// parameters and the host function that fills the level table.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// Where the query parameters of warp (n, m, q) are.  Sample (l, p) has
// element index idx = base + (l * P + p) * step into aw; its x is at
// x[idx * kXY] and its y at y[idx * kXY].
//   CmLayout:  x, y, aw each (N, M, L, P, Lq).
//   StdLayout: locs (N, Lq, M, L, P, 2) with x and y interleaved (the x
//              pointer is locs, the y pointer locs + 1) and attn
//              (N, Lq, M, L, P).
struct CmLayout {
  static constexpr int kXY = 1;
  __device__ static long long base(int n, int m, int q, int n_heads, int lp, int lq) {
    return (static_cast<long long>(n) * n_heads + m) * lp * lq + q;
  }
  __device__ static long long step(int lq) { return lq; }
};

struct StdLayout {
  static constexpr int kXY = 2;
  __device__ static long long base(int n, int m, int q, int n_heads, int lp, int lq) {
    return ((static_cast<long long>(n) * lq + q) * n_heads + m) * lp;
  }
  __device__ static long long step(int) { return 1; }
};

// Fills the level table; false if the level count is out of range or the
// level sizes do not add up to s_total.
static inline bool make_levels(Levels* levels, const int* level_h, const int* level_w,
                               int n_levels, int s_total) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS) return false;
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    levels->h[l] = level_h[l];
    levels->w[l] = level_w[l];
    levels->start[l] = start;
    start += level_h[l] * level_w[l];
  }
  return start == s_total;
}
