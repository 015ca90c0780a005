// Multi-scale deformable attention backward, in two layouts of the query
// parameters: channel-major (CM) and the standard one.
//
// Replaces two Pallas kernels of ocpg_tpu/ops/ms_deform_attn_pallas.py:
//   * msda_cm_bwd: ms_deform_attn_pallas_bwd_cm (kernel body
//     _msda_cm_bwd_kernel), gradients d_x, d_y, d_aw each (N, M, L, P, Lq);
//   * msda_std_bwd: ms_deform_attn_pallas_bwd (kernel body _msda_bwd_kernel),
//     the backward of ms_deform_attn_fast, gradients d_locs
//     (N, Lq, M, L, P, 2) with d_x and d_y interleaved and d_attn
//     (N, Lq, M, L, P).
// Both compute the same contract, not the TPU formulation (hat-row matmuls
// with a d_value accumulator carried across a sequential grid): each
// sample's four corners are gathered directly, as the reference CUDA col2im
// kernels did.  One kernel body serves both layouts (QueryLayout in
// msda_common.cuh).  For the cotangent g (N, Lq, M*D)
// of out = ms_deform_attn_cm(value, x, y, aw), with xp = x * W_l - 0.5 and
// yp = y * H_l - 0.5 and w_c the bilinear weight of corner c:
//
//   d_value[n, s(l, cy, cx), m, d] += aw * w_c * g[n, q, m*D + d]   (in-map corners)
//   d_aw = sum_d g * bilinear(V)
//   d_x  = W_l * aw * sum_d g * d bilinear / d xp   (d_y likewise with H_l)
//
// Zero padding, align_corners=False, float32 accumulation.  At exactly
// integer xp the derivative is the right-sided one (x0 = floor(xp)), as in
// the gather formulation's autodiff and grid_sample's backward.  The
// gradient's support is wider than the forward's: at xp = -1 the forward is
// 0 but the right-sided derivative is v[., 0], so a sample is skipped only
// outside xp in [-1, W), yp in [-1, H), or at a non-finite coordinate (a
// wholly padded frame), where d_x, d_y and d_aw are 0.
//
// Layouts: value (N, S, M, D) float32 or bfloat16; query parameters float32
// as above; g (N, Lq, M*D) in the value's type; d_value (N, S, M, D) float32
// scratch that the wrapper zeroes and casts to the value's type afterwards;
// the coordinate and weight gradients float32 in the parameters' layout,
// every element written here (d_x and d_y already scaled by W_l and H_l, as
// the Pallas kernels' wrappers scale them).
//
// What bounds it on an H100.  At the train encoder call (N=3, S=Lq=6800,
// M=8, D=32, L=P=4, bf16 value) the function must move about 94 MB (value,
// g, d_value in bf16; x, y, aw read and d_x, d_y, d_aw written in float32),
// ~28 us at 3.35 TB/s.  Beyond that it gathers 10.4 M value rows of 64
// bytes and adds as many 128-byte float32 rows into the 20.9 MB d_value
// scratch, which stays in the 50 MB L2.  Those adds are its limit: on an
// H100 80GB HBM3 at 700 W, 10.4 M random 128-byte rows take 0.49 ms as
// 16-byte global reductions, 0.68 ms as scalar atomics into each CTA's own
// shared memory and 4.1 ms as scalar atomics into a cluster's distributed
// shared memory, so a cluster that held d_value in distributed shared
// memory would be slower, not faster; and without its reductions this
// kernel takes 0.17 of its 0.42 ms (both measured by
// ocpg_tpu_torch/scripts/bench_msda_bwd.py).
//
// Design (K1's, ms_deform_attn_fwd.cu).  A thread owns 16 bytes of channels
// (8 bf16 or 4 float32) of one (n, m, q): a head row of D = 32 is 4 threads
// (bf16) or 8 (float32) wide, and a warp covers 8 (or 4) consecutive
// queries of one (n, m).  A block of up to 256 threads takes q_block
// consecutive queries of one (n, m), sized to Lq by msda_q_block (one warp
// for the decoder's Lq = 5), and first stages their x, y and aw for all
// L * P samples in shared memory with coalesced loads (for_each_slot).  Per
// sample a thread issues its four 16-byte corner loads together
// (predicated), forms t_c = sum over its channels of g * v_c, and from
// those its partial sums of d_aw and of the derivatives along xp and yp;
// 2 (bf16) or 3 (float32) xor shuffles sum them over the threads of the
// query, whose first thread writes d_aw, d_x and d_y into shared memory in
// the staged parameters' layout.  Each in-map corner's aw * w_c * g goes
// into d_value with 16-byte float32 vector reductions (atomicAdd on a
// float4, sm_90): one per thread for float32, two for bf16, where the
// thread's red channels are interleaved (4 contiguous floats at 4 * c and
// at 4 * (chunks + c)) so that each warp instruction covers 64 contiguous
// bytes, two whole 32-byte sectors, of each of its 8 rows.  The smallest
// levels, whose rows a block's corners outnumber (the coarsest level at
// the encoder calls: 80 rows against 1024 corners a block), are summed in
// the block's shared memory first and added to d_value once at its end,
// which takes most of a quarter of the global reductions away.  After a
// barrier the block stores d_x, d_y and d_aw with coalesced stores (in the
// CM layout, contiguous over queries; in the standard layout, each query's
// L * P values).  Atomics make the order of d_value's sums vary from run
// to run.  D / (16 bytes) must be a power of two of at most 32, and value,
// g and d_value 16-byte aligned (the wrappers check).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrappers are
// ocpg_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_cm_backward (CM) and
// ::ms_deform_attn_backward (standard), called from the autograd Functions
// behind ms_deform_attn_cm and ms_deform_attn_fast.

#include <stdint.h>

#include "msda_common.cuh"

#define MSDA_BWD_THREADS 256
#define MSDA_BWD_MIN_BLOCKS 4    // per SM: 32 warps, at most 64 registers a thread
#define MSDA_BWD_PER_SLOT 6      // shared floats per (sample, query): x, y, aw, d_x, d_y, d_aw

// The levels whose d_value rows a block first sums in its own shared memory
// (bit l of mask; row r of level l at private row off[l] + r, D + 1 floats
// a row), adding them to d_value once at its end.
struct PrivateLevels {
  int mask;
  int rows;
  int off[MSDA_MAX_LEVELS];
};

// p[0..3] += (a, b, c, d): one 16-byte float32 reduction (sm_90).
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// *p += v in shared memory.
__device__ __forceinline__ void shared_add(float* p, float v) { atomicAdd(p, v); }

template <typename scalar_t, typename Layout>
__global__ void __launch_bounds__(MSDA_BWD_THREADS, MSDA_BWD_MIN_BLOCKS)
msda_bwd_kernel(const scalar_t* __restrict__ value, const float* __restrict__ x_ptr,
                const float* __restrict__ y_ptr, const float* __restrict__ aw_ptr,
                const scalar_t* __restrict__ grad_out, float* __restrict__ d_value,
                float* __restrict__ d_x, float* __restrict__ d_y, float* __restrict__ d_aw,
                Levels levels, PrivateLevels priv, int s_total, int n_heads, int dim,
                int n_levels, int n_points, int lq, int q_block, int q_tiles) {
  using V = Vec16<scalar_t>;
  constexpr int kReds = V::kN / 4;                // 16-byte float32 reds per corner
  // x, y, aw and then d_x, d_y, d_aw: (L * P, q_block) each, row stride
  // q_block + 1 (for_each_slot); then the private d_value rows
  extern __shared__ float sparam[];
  const int lp = n_levels * n_points;
  const int ld = q_block + 1;
  float* sx = sparam;
  float* sy = sx + lp * ld;
  float* sa = sy + lp * ld;
  float* gx_s = sa + lp * ld;
  float* gy_s = gx_s + lp * ld;
  float* ga_s = gy_s + lp * ld;
  const int pstride = dim + 1;                    // spreads a warp's rows over the banks
  float* dv_s = ga_s + lp * ld;

  const int nm = blockIdx.x / q_tiles;            // n * M + m
  const int q0 = (blockIdx.x - nm * q_tiles) * q_block;
  const int m = nm % n_heads;
  const int n = nm / n_heads;
  for_each_slot<Layout>(n, m, q0, q_block, n_heads, lp, lq, [&](int slot, long long idx) {
    sx[slot] = __ldg(x_ptr + idx * Layout::kXY);
    sy[slot] = __ldg(y_ptr + idx * Layout::kXY);
    sa[slot] = __ldg(aw_ptr + idx);
  });
  for (int i = threadIdx.x; i < priv.rows * pstride; i += blockDim.x) dv_s[i] = 0.f;
  __syncthreads();

  // every thread stays in the loop below (whole warps for the shuffles); a
  // thread past the tile or past Lq is idle: it samples nothing
  const int chunks = dim / V::kN;                 // 16-byte chunks per head row
  const int qi = threadIdx.x / chunks;
  const int c16 = threadIdx.x - qi * chunks;
  const bool active = qi < q_block && q0 + qi < lq;
  const int qs = active ? qi : 0;
  const long long row_stride = static_cast<long long>(n_heads) * dim;  // one s step
  const long long nm_offset = static_cast<long long>(n) * s_total * row_stride +
                              static_cast<long long>(m) * dim;
  const scalar_t* v_nm = value + nm_offset + c16 * V::kN;
  float* dv_nm = d_value + nm_offset;
  const scalar_t* g_row = grad_out + (static_cast<long long>(n) * lq + q0 + qs) * row_stride +
                          static_cast<long long>(m) * dim;
  // g at the thread's gather channels (c16 * kN ..) and at its red channels
  // (4 * (k * chunks + c16) .., k < kReds)
  float g[V::kN], gr[V::kN];
  {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (active) raw = __ldg(reinterpret_cast<const uint4*>(g_row + c16 * V::kN));
    V::unpack(raw, g);
#pragma unroll
    for (int k = 0; k < kReds; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gr[4 * k + i] = active ? to_float(g_row[4 * (k * chunks + c16) + i]) : 0.f;
  }

  for (int l = 0; l < n_levels; ++l) {
    const int h = levels.h[l];
    const int w = levels.w[l];
    const long long level_offset = static_cast<long long>(levels.start[l]) * row_stride;
    const bool private_level = priv.mask >> l & 1;
    float* dv_l = dv_s + priv.off[l] * pstride;
    for (int p = 0; p < n_points; ++p) {
      const int sq = (l * n_points + p) * ld + qs;
      const float a = sa[sq];
      // two roundings, no fused multiply-add: the plain version computes
      // x * W - 0.5 the same way, so the two agree on which coordinates
      // are exactly integer, where the derivative is one-sided
      const float xp = __fsub_rn(__fmul_rn(sx[sq], static_cast<float>(w)), 0.5f);
      const float yp = __fsub_rn(__fmul_rn(sy[sq], static_cast<float>(h)), 0.5f);
      // the gradient's support; false for NaN and inf, and keeps the casts
      // in range
      const bool in = active && xp >= -1.f && yp >= -1.f && xp < w && yp < h;
      const float xf = in ? floorf(xp) : 0.f;
      const float yf = in ? floorf(yp) : 0.f;
      const float dx = xp - xf;
      const float dy = yp - yf;
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      int row[4];
      uint4 raw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0 + (c & 1);
        const int cy = y0 + (c >> 1);
        row[c] = in && cx >= 0 && cx <= w - 1 && cy >= 0 && cy <= h - 1 ? cy * w + cx : -1;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        raw[c] = row[c] >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                                   v_nm + level_offset + row[c] * row_stride))
                             : make_uint4(0u, 0u, 0u, 0u);
      const float wts[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                            (1.f - dx) * dy, dx * dy};
      const float wdx[4] = {-(1.f - dy), 1.f - dy, -dy, dy};   // d w_c / d xp
      const float wdy[4] = {-(1.f - dx), -dx, 1.f - dx, dx};   // d w_c / d yp
      float s_aw = 0.f, s_dx = 0.f, s_dy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row[c] < 0) continue;
        float v[V::kN];
        V::unpack(raw[c], v);
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < V::kN; ++i) t += g[i] * v[i];
        s_aw += wts[c] * t;
        s_dx += wdx[c] * t;
        s_dy += wdy[c] * t;
        const float aw_c = a * wts[c];
        if (private_level) {
          float* dv = dv_l + row[c] * pstride;
#pragma unroll
          for (int k = 0; k < kReds; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              shared_add(dv + 4 * (k * chunks + c16) + i, aw_c * gr[4 * k + i]);
        } else {
          float* dv = dv_nm + level_offset + row[c] * row_stride;
#pragma unroll
          for (int k = 0; k < kReds; ++k)
            red_add4(dv + 4 * (k * chunks + c16), aw_c * gr[4 * k], aw_c * gr[4 * k + 1],
                     aw_c * gr[4 * k + 2], aw_c * gr[4 * k + 3]);
        }
      }
      for (int o = 1; o < chunks; o <<= 1) {
        s_aw += __shfl_xor_sync(0xffffffffu, s_aw, o);
        s_dx += __shfl_xor_sync(0xffffffffu, s_dx, o);
        s_dy += __shfl_xor_sync(0xffffffffu, s_dy, o);
      }
      if (active && c16 == 0) {
        ga_s[sq] = s_aw;
        gx_s[sq] = in ? static_cast<float>(w) * a * s_dx : 0.f;
        gy_s[sq] = in ? static_cast<float>(h) * a * s_dy : 0.f;
      }
    }
  }
  __syncthreads();
  for_each_slot<Layout>(n, m, q0, q_block, n_heads, lp, lq, [&](int slot, long long idx) {
    d_x[idx * Layout::kXY] = gx_s[slot];
    d_y[idx * Layout::kXY] = gy_s[slot];
    d_aw[idx] = ga_s[slot];
  });
  // the private rows into d_value, 16 bytes a thread, skipping zeros (rows
  // no query of the block reached)
  const int units = dim / 4;
  for (int l = 0; l < n_levels; ++l) {
    if (!(priv.mask >> l & 1)) continue;
    const int rows = levels.h[l] * levels.w[l];
    const float* src = dv_s + priv.off[l] * pstride;
    float* dst = dv_nm + static_cast<long long>(levels.start[l]) * row_stride;
    for (int e = threadIdx.x; e < rows * units; e += blockDim.x) {
      const int r = e / units;
      const int u = e - r * units;
      const float* q = src + r * pstride + 4 * u;
      if (q[0] != 0.f || q[1] != 0.f || q[2] != 0.f || q[3] != 0.f)
        red_add4(dst + r * row_stride + 4 * u, q[0], q[1], q[2], q[3]);
    }
  }
}

template <typename scalar_t, typename Layout>
static int launch_typed(const void* value, const float* x, const float* y, const float* aw,
                        const void* grad_out, void* d_value, float* d_x, float* d_y,
                        float* d_aw, const Levels& levels, int n_batch, int s_total,
                        int n_heads, int dim, int n_levels, int n_points, int lq,
                        cudaStream_t s) {
  constexpr int vec = Vec16<scalar_t>::kN;
  const int chunks = dim / vec;
  const uintptr_t align = reinterpret_cast<uintptr_t>(value) |
                          reinterpret_cast<uintptr_t>(grad_out) |
                          reinterpret_cast<uintptr_t>(d_value);
  if (dim % vec != 0 || chunks > 32 || (chunks & (chunks - 1)) != 0 || (align & 15u) != 0)
    return cudaErrorInvalidValue;
  const int lp = n_levels * n_points;
  const int q_block = msda_q_block(lq, chunks, MSDA_BWD_THREADS, lp, MSDA_BWD_PER_SLOT);
  // A level's d_value rows are summed in shared memory first where they fit
  // beside the slots in 48 KB (smallest levels first) and the block's
  // corners outnumber them at least 8 times: then most of the level's
  // global reductions become shared ones, and each row goes to d_value once
  // per block.  At the encoder calls that is the coarsest level (8 x 10 at
  // the train call, 6 x 10 at the serving one, 10.6 KB beside 25 KB of
  // slots); never at the decoder's (Lq = 5: a block of 8 queries has 128
  // corners a level).
  size_t smem = msda_smem_bytes(q_block, lp, MSDA_BWD_PER_SLOT);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  PrivateLevels priv = {};
  for (int l = n_levels - 1; l >= 0; --l) {
    const int rows = levels.h[l] * levels.w[l];
    const size_t bytes = sizeof(float) * (dim + 1) * rows;
    if (smem + bytes <= 48 * 1024 && q_block * n_points * 4 >= 8 * rows) {
      priv.off[l] = priv.rows;
      priv.rows += rows;
      priv.mask |= 1 << l;
      smem += bytes;
    }
  }
  const int threads = (q_block * chunks + 31) / 32 * 32;
  const int q_tiles = (lq + q_block - 1) / q_block;
  const long long blocks = static_cast<long long>(n_batch) * n_heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  msda_bwd_kernel<scalar_t, Layout><<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      static_cast<const scalar_t*>(value), x, y, aw, static_cast<const scalar_t*>(grad_out),
      static_cast<float*>(d_value), d_x, d_y, d_aw, levels, priv, s_total, n_heads, dim,
      n_levels, n_points, lq, q_block, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename Layout>
static int launch_bwd(const void* value, const float* x, const float* y,
                      const float* aw, const void* grad_out, void* d_value,
                      float* d_x, float* d_y, float* d_aw, const int* level_h,
                      const int* level_w, int n_batch, int s_total, int n_heads,
                      int dim, int n_levels, int n_points, int lq, int dtype,
                      void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  if (static_cast<long long>(n_batch) * n_heads * lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float, Layout>(value, x, y, aw, grad_out, d_value, d_x, d_y, d_aw,
                                       levels, n_batch, s_total, n_heads, dim, n_levels,
                                       n_points, lq, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, Layout>(value, x, y, aw, grad_out, d_value, d_x, d_y,
                                               d_aw, levels, n_batch, s_total, n_heads, dim,
                                               n_levels, n_points, lq, s);
  return cudaErrorInvalidValue;
}

extern "C" {

// dtype: 0 = float32 value/grad_out, 1 = bfloat16 value/grad_out.
// Each returns the cudaError_t of the launch (0 on success).

// x_cm, y_cm, aw_cm and d_x, d_y, d_aw (N, M, L, P, Lq) float32.
int msda_cm_bwd(const void* value, const void* x_cm, const void* y_cm,
                const void* aw_cm, const void* grad_out, void* d_value,
                void* d_x, void* d_y, void* d_aw, const int* level_h,
                const int* level_w, int n_batch, int s_total, int n_heads,
                int dim, int n_levels, int n_points, int lq, int dtype,
                void* stream) {
  return launch_bwd<CmLayout>(value, static_cast<const float*>(x_cm),
                              static_cast<const float*>(y_cm),
                              static_cast<const float*>(aw_cm), grad_out, d_value,
                              static_cast<float*>(d_x), static_cast<float*>(d_y),
                              static_cast<float*>(d_aw), level_h, level_w, n_batch,
                              s_total, n_heads, dim, n_levels, n_points, lq, dtype, stream);
}

// locs and d_locs (N, Lq, M, L, P, 2), attn and d_attn (N, Lq, M, L, P) float32.
int msda_std_bwd(const void* value, const void* locs, const void* attn,
                 const void* grad_out, void* d_value, void* d_locs, void* d_attn,
                 const int* level_h, const int* level_w, int n_batch, int s_total,
                 int n_heads, int dim, int n_levels, int n_points, int lq, int dtype,
                 void* stream) {
  const float* xy = static_cast<const float*>(locs);
  float* dxy = static_cast<float*>(d_locs);
  return launch_bwd<StdLayout>(value, xy, xy + 1, static_cast<const float*>(attn),
                               grad_out, d_value, dxy, dxy + 1,
                               static_cast<float*>(d_attn), level_h, level_w, n_batch,
                               s_total, n_heads, dim, n_levels, n_points, lq, dtype, stream);
}

}  // extern "C"
