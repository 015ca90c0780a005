// Multi-scale deformable attention forward, channel-major query parameters.
//
// Replaces ocpg_tpu/ops/ms_deform_attn_pallas.py::ms_deform_attn_pallas_cm
// (kernel body _msda_cm_kernel).  It computes the same contract, not the TPU
// formulation: there are no hat-row matmuls here, each sample is gathered
// directly, as the reference CUDA im2col kernel did.
//
//   out[n, q, m*D + d] = sum_{l, p} aw[n,m,l,p,q] *
//       bilinear(V_l[n, :, :, m, d], x[n,m,l,p,q] * W_l - 0.5, y[n,m,l,p,q] * H_l - 0.5)
//
// with zero padding outside the map (grid_sample, align_corners=False),
// weights and accumulation in float32, output in the value's type.
//
// Layouts: value (N, S, M, D) with S = sum_l H_l * W_l, row-major per level;
// x, y, aw (N, M, L, P, Lq) float32; out (N, Lq, M * D).
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
// (one address per warp).  Consecutive warps take consecutive queries of
// the same (n, m), so their scalar loads share cache lines and the level's
// rows they gather stay hot in L1.  Faster designs (staging the CM
// parameters in shared memory, several queries per warp, cp.async) are
// later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_cm.

#include <stdint.h>

#include "msda_common.cuh"

template <typename scalar_t>
__global__ void msda_cm_fwd_kernel(const scalar_t* __restrict__ value,
                                   const float* __restrict__ x_cm,
                                   const float* __restrict__ y_cm,
                                   const float* __restrict__ aw_cm,
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

  // CM parameters of this (n, m): index ((nm * L + l) * P + p) * Lq + q
  const long long cm_base = nm * n_levels * n_points * lq + q;
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
        const long long idx = cm_base + static_cast<long long>(l * n_points + p) * lq;
        const float a = __ldg(aw_cm + idx);
        const float xp = __ldg(x_cm + idx) * w - 0.5f;
        const float yp = __ldg(y_cm + idx) * h - 0.5f;
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

extern "C" {

// dtype: 0 = float32 value/output, 1 = bfloat16 value/output.
// Returns the cudaError_t of the launch (0 on success).
int msda_cm_fwd(const void* value, const void* x_cm, const void* y_cm,
                const void* aw_cm, void* out, const int* level_h,
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
    msda_cm_fwd_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(x_cm),
        static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
        static_cast<float*>(out), levels, n_batch, s_total, n_heads, dim,
        n_levels, n_points, lq);
  } else if (dtype == 1) {
    msda_cm_fwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(x_cm),
        static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
        static_cast<__nv_bfloat16*>(out), levels, n_batch, s_total, n_heads,
        dim, n_levels, n_points, lq);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
