// Multi-scale deformable attention forward as separable hat-row products
// with the levels fused on the contraction axis, on the tensor cores;
// channel-major query parameters.
//
// Replaces ocpg_tpu/ops/ms_deform_attn_pallas.py::ms_deform_attn_pallas_cm_fk
// (kernel body _msda_cm_fk_kernel), a forward-only reformulation of the CM
// forward (K1) that the MSDA kernel bench compares with it.  Bilinear
// sampling is separable: with cx_l the two-corner hat row of x over the W_l
// columns and ry_l that of y over the H_l rows (zero outside the map),
//
//   out[q, d] = sum_{l, p} aw * sum_h ry_l[h] * sum_w cx_l[w] * V_l[h, w, d].
//
// "Fused K": per point, the hat rows of all levels are concatenated into one
// row cx_all over K = sum_l W_l (150 at the serving and train level sets),
// and stage 1 is one product over that axis with the block-diagonal value
// operand: A = cx_all @ blockdiag(V'_l), V'_l[w, (h, d)] = V_l[h, w, d].
// Stage 2 weights each A column (l, h, d) by ry_l[h] * aw and sums over h, p
// and l into out[q, d].  On the TPU the weighting and the sums are two more
// matmuls with 0/1 matrices (REP, SEL); here they are index arithmetic on
// the accumulator registers.  The output is K1's function: grid_sample
// bilinear, zero padding, align_corners=False, x * W - 0.5.
//
// Operands go to the tensor cores in bf16, as the TPU kernel rounds them
// (cx_all and V'); A stays float32 in registers, the ry * aw weights are
// float32, the output is in the value's type.  A sample whose pixel
// coordinate lies wholly outside the map, or is not finite, contributes
// nothing, as in K1 and the plain gather version (the interpreted TPU
// kernel returns NaN there instead).
//
// Layouts: value (N, S, M, D), S = sum_l H_l * W_l; x, y, aw (N, M, L, P, Lq)
// float32; out (N, Lq, M * D).  D in {8, 16, 32, 64}; sum_l W_l up to 864.
//
// The structurally zero blocks of blockdiag(V'_l) are skipped at the
// granularity of 16-deep K steps: the columns of level l are multiplied only
// over the K steps that overlap rows [sum_{l'<l} W_l', + W_l) of cx_all; a
// step that straddles two levels multiplies the other level's hat entries by
// staged zeros.  At the serving level set that is sum_l 16 steps_l H_l =
// 5568 (k, h) pairs per channel, against sum_l W_l H_l = 5100 with no zeros
// and 150 x 90 = 13500 with all of them.
//
// What bounds it on an H100.  The function is K1's: at the serving encoder
// call about 65 MB to move, ~19.5 us at 3.35 TB/s.  The formulation
// executes every (l, h, d) column of A for every query and point, although
// ry keeps only two h per level: 2 * 64 * 64 * 16 * sum_l(steps_l *
// ceil(H_l D / 64)) per (n, m, point, 64-query tile), 0.29 TFLOP of bf16
// tensor-core work at the serving encoder call (>= 0.29 ms at 989 TFLOP/s;
// 0.70 TFLOP if no zero block were skipped).  It is expected to lose to K1,
// as it did on the TPU.
//
// Design.  One block of 4 warps per (n, m) and tile of 64 queries; each warp
// owns 16 query rows.  For each point p: the block zeroes cx_all (64 x K,
// bf16, shared memory), writes each row's two x-corner weights per level
// into it and each row's y corner (y0, (1 - dy) aw, dy aw) per level into a
// table.  Then for each level and each block of 64 A columns (64 / D rows h
// of D channels): the block stages that slice of V' transposed (64 x K, bf16),
// and each warp runs mma.sync m16n8k16 over the level's K steps into 8 tiles
// of float32 accumulators, multiplies each accumulator by its row's weight
// for the tile's h and adds it into the output accumulators, which stay in
// registers over points, levels and column blocks.  Row strides of K + 8
// keep fragment loads free of bank conflicts.  Staging V' once for all
// points (at the cost of 4x the shared memory for cx_all), wgmma and TMA are
// later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn_variants.py::ms_deform_attn_cm_fk.

#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kTileQ = 64;      // queries per block
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kCols = 64;       // A columns per product: 8 tiles of 8

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kThreads)
msda_fk_kernel(const scalar_t* __restrict__ value, const float* __restrict__ x_cm,
               const float* __restrict__ y_cm, const float* __restrict__ aw_cm,
               scalar_t* __restrict__ out, Levels levels, int s_total, int n_heads,
               int n_levels, int n_points, int lq, int kpad) {
  constexpr int HB = kCols / D;   // rows h per column block
  constexpr int DT = D / 8;       // 8-channel tiles per row h
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = kpad + 8;        // row stride (elements) of cx_all and V'^T
  __nv_bfloat16* cx_all = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][ks]
  __nv_bfloat16* vt = cx_all + kTileQ * ks;                          // [64][ks]
  __shared__ int ry_y0[kTileQ][MSDA_MAX_LEVELS];
  __shared__ float ry_w0[kTileQ][MSDA_MAX_LEVELS];
  __shared__ float ry_w1[kTileQ][MSDA_MAX_LEVELS];

  const int n_qtiles = (lq + kTileQ - 1) / kTileQ;
  const long long nm = blockIdx.x / n_qtiles;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kTileQ;
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = 16 * warp + g;   // this thread's two accumulator rows
  const int r1 = r0 + 8;
  const long long row_stride = static_cast<long long>(n_heads) * D;
  const scalar_t* v_nm = value + static_cast<long long>(n) * s_total * row_stride +
                         static_cast<long long>(m) * D;

  float o_acc[2][DT][2];
#pragma unroll
  for (int i = 0; i < DT; ++i) o_acc[0][i][0] = o_acc[0][i][1] = o_acc[1][i][0] = o_acc[1][i][1] = 0.f;

  for (int p = 0; p < n_points; ++p) {
    __syncthreads();   // the previous point's products are done with cx_all and the table
    for (int i = tid; i < kTileQ * ks / 2; i += kThreads)
      reinterpret_cast<uint32_t*>(cx_all)[i] = 0u;
    __syncthreads();
    for (int task = tid; task < kTileQ * n_levels; task += kThreads) {
      const int r = task / n_levels;
      const int l = task % n_levels;
      const int q = q0 + r;
      const int h = levels.h[l];
      const int w = levels.w[l];
      int y0 = -2;                 // matches no row
      float w0 = 0.f, w1 = 0.f;
      if (q < lq) {
        int koff = 0;
        for (int i = 0; i < l; ++i) koff += levels.w[i];
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
          y0 = static_cast<int>(yf);
          __nv_bfloat16* row = cx_all + r * ks + koff;
          if (x0 >= 0) row[x0] = __float2bfloat16(1.f - dx);
          if (x0 + 1 <= w - 1) row[x0 + 1] = __float2bfloat16(dx);
          if (y0 >= 0) w0 = (1.f - dy) * a;
          if (y0 + 1 <= h - 1) w1 = dy * a;
        }
      }
      ry_y0[r][l] = y0;
      ry_w0[r][l] = w0;
      ry_w1[r][l] = w1;
    }
    __syncthreads();

    int koff = 0;
    for (int l = 0; l < n_levels; ++l) {
      const int h = levels.h[l];
      const int w = levels.w[l];
      const int k_lo = koff & ~15;
      const int k_hi = (koff + w + 15) & ~15;
      const scalar_t* v_l = v_nm + static_cast<long long>(levels.start[l]) * row_stride;
      const int ya = ry_y0[r0][l], yb = ry_y0[r1][l];
      const float wa0 = ry_w0[r0][l], wa1 = ry_w1[r0][l];
      const float wb0 = ry_w0[r1][l], wb1 = ry_w1[r1][l];

      for (int hb = 0; hb < h; hb += HB) {
        __syncthreads();   // the previous products are done with vt
        // vt[c][k] = V'_l[k - koff, (hb + c / D, c % D)], zero outside the level
        for (int e = tid; e < kCols * (k_hi - k_lo) / 2; e += kThreads) {
          const int c = e % kCols;
          const int k = k_lo + 2 * (e / kCols);
          const int hrow = hb + c / D;
          const int dd = c % D;
          float v0 = 0.f, v1 = 0.f;
          if (hrow < h) {
            const int w0i = k - koff;
            if (w0i >= 0 && w0i < w)
              v0 = to_float(v_l[static_cast<long long>(hrow * w + w0i) * row_stride + dd]);
            if (w0i + 1 >= 0 && w0i + 1 < w)
              v1 = to_float(v_l[static_cast<long long>(hrow * w + w0i + 1) * row_stride + dd]);
          }
          *reinterpret_cast<uint32_t*>(vt + c * ks + k) = pack_bf16(v0, v1);
        }
        __syncthreads();

        float acc[kCols / 8][4];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int k = k_lo; k < k_hi; k += 16) {
          const __nv_bfloat16* a_lo = cx_all + r0 * ks + k + 2 * t;
          const __nv_bfloat16* a_hi = cx_all + r1 * ks + k + 2 * t;
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a_lo),
                                 *reinterpret_cast<const uint32_t*>(a_hi),
                                 *reinterpret_cast<const uint32_t*>(a_lo + 8),
                                 *reinterpret_cast<const uint32_t*>(a_hi + 8)};
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            const __nv_bfloat16* b = vt + (8 * j + g) * ks + k + 2 * t;
            mma_bf16_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(b),
                           *reinterpret_cast<const uint32_t*>(b + 8));
          }
        }
        // stage 2: tile j holds row h = hb + j / DT, channels 8 (j % DT) + 2t, +1
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int hrow = hb + j / DT;
          const float wa = (hrow == ya ? wa0 : 0.f) + (hrow == ya + 1 ? wa1 : 0.f);
          const float wb = (hrow == yb ? wb0 : 0.f) + (hrow == yb + 1 ? wb1 : 0.f);
          o_acc[0][j % DT][0] += wa * acc[j][0];
          o_acc[0][j % DT][1] += wa * acc[j][1];
          o_acc[1][j % DT][0] += wb * acc[j][2];
          o_acc[1][j % DT][1] += wb * acc[j][3];
        }
      }
      koff += w;
    }
  }

  scalar_t* o = out + static_cast<long long>(n) * lq * row_stride +
                static_cast<long long>(m) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + (half ? r1 : r0);
    if (q >= lq) continue;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      store(o + static_cast<long long>(q) * row_stride + 8 * i + 2 * t, o_acc[half][i][0]);
      store(o + static_cast<long long>(q) * row_stride + 8 * i + 2 * t + 1, o_acc[half][i][1]);
    }
  }
}

template <typename scalar_t, int D>
int launch(const void* value, const void* x_cm, const void* y_cm, const void* aw_cm,
           void* out, const Levels& levels, long long blocks, int s_total, int n_heads,
           int n_levels, int n_points, int lq, int kpad, cudaStream_t s) {
  const int smem = 2 * kTileQ * (kpad + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(msda_fk_kernel<scalar_t, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_fk_kernel<scalar_t, D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const scalar_t*>(value), static_cast<const float*>(x_cm),
      static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
      static_cast<scalar_t*>(out), levels, s_total, n_heads, n_levels, n_points, lq, kpad);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int launch_dim(int dim, const void* value, const void* x_cm, const void* y_cm,
               const void* aw_cm, void* out, const Levels& levels, long long blocks,
               int s_total, int n_heads, int n_levels, int n_points, int lq, int kpad,
               cudaStream_t s) {
#define MSDA_FK_CASE(D_)                                                             \
  case D_:                                                                           \
    return launch<scalar_t, D_>(value, x_cm, y_cm, aw_cm, out, levels, blocks,       \
                                s_total, n_heads, n_levels, n_points, lq, kpad, s);
  switch (dim) {
    MSDA_FK_CASE(8) MSDA_FK_CASE(16) MSDA_FK_CASE(32) MSDA_FK_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef MSDA_FK_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32 value/output, 1 = bfloat16 value/output.
// Returns the cudaError_t of the launch (0 on success).
int msda_cm_fk_fwd(const void* value, const void* x_cm, const void* y_cm,
                   const void* aw_cm, void* out, const int* level_h, const int* level_w,
                   int n_batch, int s_total, int n_heads, int dim, int n_levels,
                   int n_points, int lq, int dtype, void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  int w_sum = 0;
  for (int l = 0; l < n_levels; ++l) w_sum += level_w[l];
  const int kpad = (w_sum + 15) & ~15;
  if (kpad > 864 || n_points < 1) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(n_batch) * n_heads *
                           ((lq + kTileQ - 1) / kTileQ);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(dim, value, x_cm, y_cm, aw_cm, out, levels, blocks, s_total,
                             n_heads, n_levels, n_points, lq, kpad, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(dim, value, x_cm, y_cm, aw_cm, out, levels, blocks,
                                     s_total, n_heads, n_levels, n_points, lq, kpad, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
