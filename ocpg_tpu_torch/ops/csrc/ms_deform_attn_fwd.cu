// Multi-scale deformable attention forward, in two layouts of the query
// parameters: channel-major (CM) and the standard one.
//
// Replaces two Pallas kernels of ocpg_tpu/ops/ms_deform_attn_pallas.py:
//   * msda_cm_fwd: ms_deform_attn_pallas_cm (kernel body _msda_cm_kernel),
//     query parameters x, y, aw each (N, M, L, P, Lq);
//   * msda_std_fwd: ms_deform_attn_pallas (kernel body _msda_kernel), the
//     row-folded op behind ms_deform_attn_fast, query parameters in the
//     reference MSDeformAttnFunction's layout: locs (N, Lq, M, L, P, 2) with
//     x and y interleaved, attn (N, Lq, M, L, P).
// Both compute the same contract, not the TPU formulation: there are no
// hat-row matmuls here, each sample is gathered directly, as the reference
// CUDA im2col kernel did.  One kernel body serves both; a layout type says
// where a sample's x, y and aw are (QueryLayout in msda_common.cuh).
//
//   out[n, q, m*D + d] = sum_{l, p} aw[n,m,l,p,q] *
//       bilinear(V_l[n, :, :, m, d], x[n,m,l,p,q] * W_l - 0.5, y[n,m,l,p,q] * H_l - 0.5)
//
// with zero padding outside the map (grid_sample, align_corners=False),
// weights and accumulation in float32, output in the value's type.
//
// Layouts: value (N, S, M, D) with S = sum_l H_l * W_l, row-major per level;
// query parameters float32 as above; out (N, Lq, M * D).
//
// What bounds it on an H100.  Each input is read once and the output written
// once: at the serving shapes (N=5, S=Lq=5100, M=8, D=32, L=P=4, bf16 value)
// that is about 65 MB, ~19.5 us at 3.35 TB/s.  The gathers, though, touch
// 4 corners x L x P = 64 rows of D channels per (n, m, q): about 0.84 GB of
// 64-byte rows through L1/L2.  The value (13 MB) fits in the 50 MB L2, so the
// real limit is L2/L1 gather throughput rather than HBM.
//
// Design.  One warp per (n, m, q), lanes over the D channels (a loop over
// 32-channel chunks when D > 32).  Each corner read is one coalesced 64-byte
// (bf16) or 128-byte (f32) row, the (N, S, M, D) storage making a head's D
// channels contiguous.  The warp's x, y and aw scalars are uniform loads
// (one address per warp): in the CM layout consecutive warps (consecutive
// queries of one (n, m)) share their cache lines; in the standard layout one
// warp's L * P samples are contiguous.  The level's rows a warp gathers stay
// hot in L1 for its neighbours.  Faster designs (staging the parameters in
// shared memory, several queries per warp, cp.async) are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrappers are
// ocpg_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_cm (CM) and
// ::ms_deform_attn_fast (standard).

#include <stdint.h>

#include "msda_common.cuh"

template <typename scalar_t, typename Layout>
__global__ void msda_fwd_kernel(const scalar_t* __restrict__ value,
                                const float* __restrict__ x_ptr,
                                const float* __restrict__ y_ptr,
                                const float* __restrict__ aw_ptr,
                                scalar_t* __restrict__ out,
                                Levels levels, int n_batch, int s_total,
                                int n_heads, int dim, int n_levels,
                                int n_points, int lq) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(n_batch) * n_heads * lq;
  if (warp >= n_warps) return;

  const int q = static_cast<int>(warp % lq);
  const long long nm = warp / lq;          // n * M + m
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);

  const long long p_base = Layout::base(n, m, q, n_heads, n_levels * n_points, lq);
  const long long p_step = Layout::step(lq);
  const long long row_stride = static_cast<long long>(n_heads) * dim;  // one s step
  const scalar_t* v_nm = value + static_cast<long long>(n) * s_total * row_stride +
                         static_cast<long long>(m) * dim;
  scalar_t* o = out + (static_cast<long long>(n) * lq + q) * row_stride +
                static_cast<long long>(m) * dim;

  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < dim;
    float acc = 0.f;
    for (int l = 0; l < n_levels; ++l) {
      const int h = levels.h[l];
      const int w = levels.w[l];
      const scalar_t* v_l = v_nm + static_cast<long long>(levels.start[l]) * row_stride;
      for (int p = 0; p < n_points; ++p) {
        const long long idx = p_base + static_cast<long long>(l * n_points + p) * p_step;
        const float a = __ldg(aw_ptr + idx);
        const float xp = __ldg(x_ptr + idx * Layout::kXY) * w - 0.5f;
        const float yp = __ldg(y_ptr + idx * Layout::kXY) * h - 0.5f;
        // samples wholly outside the map (or NaN) contribute nothing; this
        // also keeps the float -> int casts below in range
        if (!(xp > -1.f && yp > -1.f && xp < w && yp < h)) continue;
        const float xf = floorf(xp);
        const float yf = floorf(yp);
        const float dx = xp - xf;
        const float dy = yp - yf;
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float wts[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                              (1.f - dx) * dy, dx * dy};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cx = x0 + (c & 1);
          const int cy = y0 + (c >> 1);
          if (cx < 0 || cx > w - 1 || cy < 0 || cy > h - 1 || !active) continue;
          const float v = to_float(v_l[static_cast<long long>(cy * w + cx) * row_stride + d]);
          acc += a * wts[c] * v;
        }
      }
    }
    if (active) store(o + d, acc);
  }
}

template <typename Layout>
static int launch_fwd(const void* value, const float* x, const float* y,
                      const float* aw, void* out, const int* level_h,
                      const int* level_w, int n_batch, int s_total, int n_heads,
                      int dim, int n_levels, int n_points, int lq, int dtype,
                      void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  const long long n_warps = static_cast<long long>(n_batch) * n_heads * lq;
  if (n_warps == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (n_warps * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_fwd_kernel<float, Layout><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(value), x, y, aw, static_cast<float*>(out), levels,
        n_batch, s_total, n_heads, dim, n_levels, n_points, lq);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16, Layout><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), x, y, aw,
        static_cast<__nv_bfloat16*>(out), levels, n_batch, s_total, n_heads, dim,
        n_levels, n_points, lq);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// dtype: 0 = float32 value/output, 1 = bfloat16 value/output.
// Each returns the cudaError_t of the launch (0 on success).

// x_cm, y_cm, aw_cm (N, M, L, P, Lq) float32.
int msda_cm_fwd(const void* value, const void* x_cm, const void* y_cm,
                const void* aw_cm, void* out, const int* level_h,
                const int* level_w, int n_batch, int s_total, int n_heads,
                int dim, int n_levels, int n_points, int lq, int dtype,
                void* stream) {
  return launch_fwd<CmLayout>(value, static_cast<const float*>(x_cm),
                              static_cast<const float*>(y_cm),
                              static_cast<const float*>(aw_cm), out, level_h, level_w,
                              n_batch, s_total, n_heads, dim, n_levels, n_points, lq,
                              dtype, stream);
}

// locs (N, Lq, M, L, P, 2), attn (N, Lq, M, L, P) float32.
int msda_std_fwd(const void* value, const void* locs, const void* attn, void* out,
                 const int* level_h, const int* level_w, int n_batch, int s_total,
                 int n_heads, int dim, int n_levels, int n_points, int lq, int dtype,
                 void* stream) {
  const float* xy = static_cast<const float*>(locs);
  return launch_fwd<StdLayout>(value, xy, xy + 1, static_cast<const float*>(attn), out,
                               level_h, level_w, n_batch, s_total, n_heads, dim,
                               n_levels, n_points, lq, dtype, stream);
}

}  // extern "C"
