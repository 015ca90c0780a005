// Pieces shared by the MSDA kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu, ms_deform_attn_r4.cu, ms_deform_attn_fk.cu): the
// level table, the value-type conversions, the two layouts of the query
// parameters and the host function that fills the level table; the
// tensor-core pieces come from tensor_core.cuh.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tensor_core.cuh"

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

// Where the query parameters of query (n, m, q) are.  Sample (l, p) has
// element index idx = base + (l * P + p) * step into aw; its x is at
// x[idx * kXY] and its y at y[idx * kXY].  kSampleMajor says which index
// runs over contiguous memory: the samples of one query (standard layout)
// or the queries of one sample (CM layout).
//   CmLayout:  x, y, aw each (N, M, L, P, Lq).
//   StdLayout: locs (N, Lq, M, L, P, 2) with x and y interleaved (the x
//              pointer is locs, the y pointer locs + 1) and attn
//              (N, Lq, M, L, P).
struct CmLayout {
  static constexpr int kXY = 1;
  static constexpr bool kSampleMajor = false;
  __device__ static long long base(int n, int m, int q, int n_heads, int lp, int lq) {
    return (static_cast<long long>(n) * n_heads + m) * lp * lq + q;
  }
  __device__ static long long step(int lq) { return lq; }
};

struct StdLayout {
  static constexpr int kXY = 2;
  static constexpr bool kSampleMajor = true;
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
