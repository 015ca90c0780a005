// Multi-scale deformable attention forward as dense sampling rows on the
// tensor cores, channel-major query parameters.
//
// Replaces ocpg_tpu/ops/ms_deform_attn_pallas.py::ms_deform_attn_pallas_cm_r4
// (kernel body _msda_cm_r4_kernel), a forward-only reformulation of the CM
// forward (K1) that the MSDA kernel bench compares with it.  Per query q and
// level l it builds the dense sampling row over the level's H*W keys,
//
//   M_q[h*W + w] = sum_p aw[q,l,p] * ry_p[h] * cx_p[w]
//
// (ry_p, cx_p the two-corner bilinear hat rows, zero outside the map: at
// most four non-zeros per point), then contracts it with the level's value
// rows once: out[q, :] += M_q @ V_l[(h, w), :].  The output is the same
// function as K1's: grid_sample bilinear, zero padding, align_corners=False,
// x * W - 0.5.
//
// Operands go to the tensor cores in bf16, as the TPU kernel rounds them:
// M is summed over the points in float32 and rounded once; V is rounded
// from the value's type.  Accumulation is float32; the output is in the
// value's type.  A sample whose pixel coordinate lies wholly outside the
// map, or is not finite (a wholly padded frame has NaN reference points),
// contributes nothing, as in K1 and the plain gather version (the
// interpreted TPU kernel returns NaN there instead).
//
// Layouts: value (N, S, M, D), S = sum_l H_l * W_l; x, y, aw (N, M, L, P, Lq)
// float32; out (N, Lq, M * D).  D a multiple of 8 up to 64, P up to 8.
//
// What bounds it on an H100.  The function is K1's: at the serving encoder
// call (N=5, S=Lq=5100, M=8, D=32, L=P=4, bf16) about 65 MB to move, ~19.5
// us at 3.35 TB/s.  The formulation executes 2 * Lq * S * D * N * M = 67
// GFLOP of bf16 tensor-core work (every key of every level against every
// query), >= 0.067 ms at 989 TFLOP/s, almost all of it on zeros: each M row
// has at most 16 non-zeros per level.  With mma.sync fed from shared memory
// (no wgmma, no TMA) and the scatter and staging between the products, the
// products do not reach that rate; the kernel is for measuring the
// formulation, not for the main path.
//
// Design.  One block of 4 warps per (n, m) and tile of 64 queries.  Per
// level, the block first writes every sample's four corners (flat key
// h*W + w and weight aw * w_c) to shared memory.  It then walks the level's
// keys in chunks of 64; for each chunk that some corner of the tile lands
// in (the others are skipped, decided with one __syncthreads_or):
//   * each thread zeroes its half of one row of the float32 M tile
//     (64 x 64) and adds the row's corners that fall in its half;
//   * the block stages the chunk's 64 value rows transposed (D x 64, bf16);
//   * each warp multiplies its 16 rows of M (rounded to bf16 as the
//     fragments are built) by V^T with mma.sync m16n8k16 into float32
//     accumulators that it keeps in registers across chunks and levels.
// No W padding is needed: the flat key index is used directly.  Row strides
// of 72 elements keep the fragment loads free of bank conflicts.  wgmma,
// TMA staging and a pipeline of chunks are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn_variants.py::ms_deform_attn_cm_r4.

#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kTileQ = 64;          // queries per block
constexpr int kChunk = 64;          // keys per chunk
constexpr int kThreads = 128;       // 4 warps x 16 query rows
constexpr int kMaxPoints = 8;
constexpr int kCorners = 4 * kMaxPoints;
constexpr int kStride = kChunk + 8;  // row stride (elements) of the M and V^T tiles

template <typename scalar_t, int NT>   // NT = D / 8 output tiles of 8 channels
__global__ void __launch_bounds__(kThreads)
msda_r4_kernel(const scalar_t* __restrict__ value, const float* __restrict__ x_cm,
               const float* __restrict__ y_cm, const float* __restrict__ aw_cm,
               scalar_t* __restrict__ out, Levels levels, int s_total, int n_heads,
               int dim, int n_levels, int n_points, int lq) {
  __shared__ __align__(16) float m_tile[kTileQ][kStride];
  __shared__ __align__(16) __nv_bfloat16 vt_tile[8 * NT][kStride];
  // one spare column: the scatter's threads read one row each, on distinct banks
  __shared__ int c_key[kTileQ][kCorners + 1];
  __shared__ float c_wt[kTileQ][kCorners + 1];

  const int n_qtiles = (lq + kTileQ - 1) / kTileQ;
  const long long nm = blockIdx.x / n_qtiles;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kTileQ;
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const long long row_stride = static_cast<long long>(n_heads) * dim;
  const scalar_t* v_nm = value + static_cast<long long>(n) * s_total * row_stride +
                         static_cast<long long>(m) * dim;
  const int n_corners = 4 * n_points;
  // scatter ownership: row s_row, columns [32 * s_half, 32 * s_half + 32)
  const int s_row = tid & (kTileQ - 1);
  const int s_half = tid >> 6;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int l = 0; l < n_levels; ++l) {
    const int h = levels.h[l];
    const int w = levels.w[l];
    const int hw = h * w;
    const scalar_t* v_l = v_nm + static_cast<long long>(levels.start[l]) * row_stride;

    __syncthreads();   // the previous level's chunks are done with c_key / c_wt
    for (int task = tid; task < kTileQ * n_points; task += kThreads) {
      const int r = task / n_points;
      const int p = task % n_points;
      const int q = q0 + r;
      int keys[4] = {-1, -1, -1, -1};
      float wts[4] = {0.f, 0.f, 0.f, 0.f};
      if (q < lq) {
        const long long idx = ((nm * n_levels + l) * n_points + p) * lq + q;
        const float a = __ldg(aw_cm + idx);
        const float xp = __ldg(x_cm + idx) * w - 0.5f;
        const float yp = __ldg(y_cm + idx) * h - 0.5f;
        if (xp > -1.f && yp > -1.f && xp < w && yp < h) {   // false for NaN / inf
          const float xf = floorf(xp);
          const float yf = floorf(yp);
          const float dx = xp - xf;
          const float dy = yp - yf;
          const int x0 = static_cast<int>(xf);
          const int y0 = static_cast<int>(yf);
          const float cw[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                               (1.f - dx) * dy, dx * dy};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cx = x0 + (c & 1);
            const int cy = y0 + (c >> 1);
            if (cx < 0 || cx > w - 1 || cy < 0 || cy > h - 1) continue;
            keys[c] = cy * w + cx;
            wts[c] = a * cw[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        c_key[r][4 * p + c] = keys[c];
        c_wt[r][4 * p + c] = wts[c];
      }
    }
    __syncthreads();

    for (int k0 = 0; k0 < hw; k0 += kChunk) {
      const int lo = k0 + 32 * s_half;
      int hit = 0;
      for (int c = 0; c < n_corners; ++c) {
        const int key = c_key[s_row][c];
        hit |= key >= lo && key < lo + 32;
      }
      // also the barrier after the previous chunk's products
      if (!__syncthreads_or(hit)) continue;

      float* mrow = &m_tile[s_row][32 * s_half];
#pragma unroll
      for (int i = 0; i < 32; i += 4)
        *reinterpret_cast<float4*>(mrow + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hit) {
        for (int c = 0; c < n_corners; ++c) {
          const int key = c_key[s_row][c];
          if (key >= lo && key < lo + 32) mrow[key - lo] += c_wt[s_row][c];
        }
      }
      // V^T tile: vt_tile[d][k] = V_l[k0 + k][d], zero past the level or D
      for (int e = tid; e < 8 * NT * (kChunk / 2); e += kThreads) {
        const int d = e % (8 * NT);
        const int kp = 2 * (e / (8 * NT));
        float v0 = 0.f, v1 = 0.f;
        if (d < dim) {
          if (k0 + kp < hw) v0 = to_float(v_l[static_cast<long long>(k0 + kp) * row_stride + d]);
          if (k0 + kp + 1 < hw)
            v1 = to_float(v_l[static_cast<long long>(k0 + kp + 1) * row_stride + d]);
        }
        *reinterpret_cast<uint32_t*>(&vt_tile[d][kp]) = pack_bf16(v0, v1);
      }
      __syncthreads();

      const float* a_lo = &m_tile[16 * warp + g][0];
      const float* a_hi = &m_tile[16 * warp + g + 8][0];
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        const float2 f0 = *reinterpret_cast<const float2*>(a_lo + ks + 2 * t);
        const float2 f1 = *reinterpret_cast<const float2*>(a_hi + ks + 2 * t);
        const float2 f2 = *reinterpret_cast<const float2*>(a_lo + ks + 2 * t + 8);
        const float2 f3 = *reinterpret_cast<const float2*>(a_hi + ks + 2 * t + 8);
        const uint32_t a[4] = {pack_bf16(f0.x, f0.y), pack_bf16(f1.x, f1.y),
                               pack_bf16(f2.x, f2.y), pack_bf16(f3.x, f3.y)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* b = &vt_tile[8 * j + g][ks + 2 * t];
          mma_bf16_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(b),
                         *reinterpret_cast<const uint32_t*>(b + 8));
        }
      }
    }
  }

  scalar_t* o = out + static_cast<long long>(n) * lq * row_stride +
                static_cast<long long>(m) * dim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + 16 * warp + g + 8 * half;
    if (q >= lq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < dim) store(o + static_cast<long long>(q) * row_stride + d, acc[j][2 * half + e]);
      }
    }
  }
}

template <typename scalar_t, int NT>
int launch(const void* value, const void* x_cm, const void* y_cm, const void* aw_cm,
           void* out, const Levels& levels, long long blocks, int s_total, int n_heads,
           int dim, int n_levels, int n_points, int lq, cudaStream_t s) {
  msda_r4_kernel<scalar_t, NT><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const scalar_t*>(value), static_cast<const float*>(x_cm),
      static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
      static_cast<scalar_t*>(out), levels, s_total, n_heads, dim, n_levels, n_points, lq);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int launch_dim(int nt, const void* value, const void* x_cm, const void* y_cm,
               const void* aw_cm, void* out, const Levels& levels, long long blocks,
               int s_total, int n_heads, int dim, int n_levels, int n_points, int lq,
               cudaStream_t s) {
#define MSDA_R4_CASE(NT_)                                                            \
  case NT_:                                                                          \
    return launch<scalar_t, NT_>(value, x_cm, y_cm, aw_cm, out, levels, blocks,      \
                                 s_total, n_heads, dim, n_levels, n_points, lq, s);
  switch (nt) {
    MSDA_R4_CASE(1) MSDA_R4_CASE(2) MSDA_R4_CASE(3) MSDA_R4_CASE(4)
    MSDA_R4_CASE(5) MSDA_R4_CASE(6) MSDA_R4_CASE(7) MSDA_R4_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef MSDA_R4_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32 value/output, 1 = bfloat16 value/output.
// Returns the cudaError_t of the launch (0 on success).
int msda_cm_r4_fwd(const void* value, const void* x_cm, const void* y_cm,
                   const void* aw_cm, void* out, const int* level_h, const int* level_w,
                   int n_batch, int s_total, int n_heads, int dim, int n_levels,
                   int n_points, int lq, int dtype, void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  if (dim < 1 || dim > 64 || dim % 8 != 0 || n_points < 1 || n_points > kMaxPoints)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(n_batch) * n_heads *
                           ((lq + kTileQ - 1) / kTileQ);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(dim / 8, value, x_cm, y_cm, aw_cm, out, levels, blocks,
                             s_total, n_heads, dim, n_levels, n_points, lq, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(dim / 8, value, x_cm, y_cm, aw_cm, out, levels, blocks,
                                     s_total, n_heads, dim, n_levels, n_points, lq, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
