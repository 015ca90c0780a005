// Pieces shared by the MSDA kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu, ms_deform_attn_r4.cu, ms_deform_attn_fk.cu): the
// level table, the value-type conversions, 16-byte channel vectors, the two
// layouts of the query parameters, the walk over a query tile's parameters
// that the gather kernels (K1-K4) stage and store with, their block size,
// and the host function that fills the level table; the tensor-core pieces
// come from tensor_core.cuh.

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

// 16 bytes of channels: 4 float32 or 8 bf16, unpacked to and packed from
// float32.
template <typename scalar_t>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  }
};

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

// The gather kernels (K1-K4) give a block q_block consecutive queries
// q0.. of one (n, m) and keep the query parameters of every sample s of
// them in shared (L * P, ld) arrays, ld = q_block + 1.  This calls
// f(slot, idx) for each (s, query) of the tile with q < lq: slot = s * ld +
// qi in those arrays, idx the parameters' element (x at idx * kXY).
// Consecutive threads take consecutive memory in either layout (in the CM
// layout the queries of one sample, in the standard one the samples of one
// query), and the row stride ld keeps the shared side free of bank
// conflicts.
template <typename Layout, typename F>
__device__ __forceinline__ void for_each_slot(int n, int m, int q0, int q_block, int n_heads,
                                              int lp, int lq, F&& f) {
  const int ld = q_block + 1;
  for (int e = threadIdx.x; e < q_block * lp; e += blockDim.x) {
    int s, qi;
    if (Layout::kSampleMajor) {
      qi = e / lp;
      s = e - qi * lp;
    } else {
      s = e / q_block;
      qi = e - s * q_block;
    }
    if (q0 + qi >= lq) continue;
    f(s * ld + qi, Layout::base(n, m, q0 + qi, n_heads, lp, lq) +
                       static_cast<long long>(s) * Layout::step(lq));
  }
}

// Queries per block of the gather kernels, whose threads each own one
// 16-byte chunk of a query's head row (`chunks` per row): max_threads /
// chunks, but no more than the whole warps that lq queries fill (the
// decoder's calls have lq = 5: a block of one warp, not 256 threads that
// stage and wait for 64), halved while `per_slot` floats for each (sample,
// query) slot exceed 48 KB of shared memory.
static inline int msda_q_block(int lq, int chunks, int max_threads, int lp, int per_slot) {
  const int q_warp = chunks >= 32 ? 1 : 32 / chunks;
  int q_block = max_threads / chunks;
  const int need = (lq + q_warp - 1) / q_warp * q_warp;
  if (need < q_block) q_block = need;
  while (q_block > 1 && sizeof(float) * per_slot * lp * (q_block + 1) > 48 * 1024) q_block /= 2;
  return q_block;
}

static inline size_t msda_smem_bytes(int q_block, int lp, int per_slot) {
  return sizeof(float) * per_slot * lp * (q_block + 1);
}

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
