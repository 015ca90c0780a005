// Pieces shared by the MSDA forward and backward kernels
// (ms_deform_attn_fwd.cu, ms_deform_attn_bwd.cu): the level table, the
// value-type conversions and the host function that fills the table.

#pragma once

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
