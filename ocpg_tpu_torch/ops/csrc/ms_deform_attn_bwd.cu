// Multi-scale deformable attention backward, channel-major query parameters.
//
// Replaces ocpg_tpu/ops/ms_deform_attn_pallas.py::ms_deform_attn_pallas_bwd_cm
// (kernel body _msda_cm_bwd_kernel).  It computes the same contract, not the
// TPU formulation (hat-row matmuls with a d_value accumulator carried across
// a sequential grid): each sample's four corners are gathered directly, as
// the reference CUDA col2im kernels did.  For the cotangent g (N, Lq, M*D)
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
// Layouts: value (N, S, M, D) float32 or bfloat16; x, y, aw (N, M, L, P, Lq)
// float32; g (N, Lq, M*D) in the value's type; d_value (N, S, M, D) float32
// scratch that the wrapper zeroes and casts to the value's type afterwards;
// d_x, d_y, d_aw (N, M, L, P, Lq) float32, every element written here.
//
// What bounds it on an H100.  At the train encoder call (N=3, S=Lq=6800,
// M=8, D=32, L=P=4, bf16 value) the function must move about 94 MB (value,
// g, d_value in bf16; x, y, aw read and d_x, d_y, d_aw written in float32),
// ~28 us at 3.35 TB/s.  The kernel also makes 10.4 M float32 atomic adds of
// one 128-byte row (32 lanes) each into the 20.9 MB scratch, which stays in
// the 50 MB L2, and gathers as many 64-byte value rows: L2 atomic and
// gather throughput, not HBM, is its real limit.
//
// Design.  One warp per (n, m, q), lanes over the D channels (a loop over
// 32-channel chunks when D > 32), as in the forward kernel.  Per sample the
// warp reads the four corner rows, adds aw * w_c * g into each in-map
// corner's d_value row with atomicAdd (one coalesced 128-byte red per
// corner), and reduces g * bilinear and g times its two partial derivatives
// over the lanes with shuffles; lane 0 writes d_aw, d_x, d_y.  Atomics make
// the order of d_value's sums vary from run to run.  Faster designs
// (segmented reductions over queries that share corners, bf16x2 red ops,
// staged parameters) are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_cm_backward, called
// from the autograd Function behind ms_deform_attn_cm.

#include <stdint.h>

#include "msda_common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename scalar_t>
__global__ void msda_cm_bwd_kernel(const scalar_t* __restrict__ value,
                                   const float* __restrict__ x_cm,
                                   const float* __restrict__ y_cm,
                                   const float* __restrict__ aw_cm,
                                   const scalar_t* __restrict__ grad_out,
                                   float* __restrict__ d_value,
                                   float* __restrict__ d_x,
                                   float* __restrict__ d_y,
                                   float* __restrict__ d_aw,
                                   Levels levels, int n_batch, int s_total,
                                   int n_heads, int dim, int n_levels,
                                   int n_points, int lq) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(n_batch) * n_heads * lq;
  if (warp >= n_warps) return;             // whole warps only: shuffles stay full

  const int q = static_cast<int>(warp % lq);
  const long long nm = warp / lq;          // n * M + m
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);

  // CM parameters of this (n, m): index ((nm * L + l) * P + p) * Lq + q
  const long long cm_base = nm * n_levels * n_points * lq + q;
  const long long row_stride = static_cast<long long>(n_heads) * dim;  // one s step
  const long long nm_offset = static_cast<long long>(n) * s_total * row_stride +
                              static_cast<long long>(m) * dim;
  const scalar_t* v_nm = value + nm_offset;
  float* dv_nm = d_value + nm_offset;
  const scalar_t* g_row = grad_out + (static_cast<long long>(n) * lq + q) * row_stride +
                          static_cast<long long>(m) * dim;

  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < dim;
    const float g = active ? to_float(g_row[d]) : 0.f;
    for (int l = 0; l < n_levels; ++l) {
      const int h = levels.h[l];
      const int w = levels.w[l];
      const long long level_offset = static_cast<long long>(levels.start[l]) * row_stride;
      for (int p = 0; p < n_points; ++p) {
        const long long idx = cm_base + static_cast<long long>(l * n_points + p) * lq;
        const float a = __ldg(aw_cm + idx);
        // two roundings, no fused multiply-add: the plain version computes
        // x * W - 0.5 the same way, so the two agree on which coordinates
        // are exactly integer, where the derivative is one-sided
        const float xp = __fsub_rn(__fmul_rn(__ldg(x_cm + idx), static_cast<float>(w)), 0.5f);
        const float yp = __fsub_rn(__fmul_rn(__ldg(y_cm + idx), static_cast<float>(h)), 0.5f);
        // warp-uniform; false for NaN and inf, and keeps the casts in range
        const bool in = xp >= -1.f && yp >= -1.f && xp < w && yp < h;
        float s_aw = 0.f, s_dx = 0.f, s_dy = 0.f;
        if (in) {
          const float xf = floorf(xp);
          const float yf = floorf(yp);
          const float dx = xp - xf;
          const float dy = yp - yf;
          const int x0 = static_cast<int>(xf);
          const int y0 = static_cast<int>(yf);
          const float wts[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                                (1.f - dx) * dy, dx * dy};
          const float wdx[4] = {-(1.f - dy), 1.f - dy, -dy, dy};   // d w_c / d xp
          const float wdy[4] = {-(1.f - dx), -dx, 1.f - dx, dx};   // d w_c / d yp
          const float ag = a * g;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cx = x0 + (c & 1);
            const int cy = y0 + (c >> 1);
            if (cx < 0 || cx > w - 1 || cy < 0 || cy > h - 1 || !active) continue;
            const long long off = level_offset +
                                  static_cast<long long>(cy * w + cx) * row_stride + d;
            const float v = to_float(v_nm[off]);
            s_aw += wts[c] * v;
            s_dx += wdx[c] * v;
            s_dy += wdy[c] * v;
            atomicAdd(dv_nm + off, ag * wts[c]);
          }
          s_aw = warp_sum(g * s_aw);
          s_dx = warp_sum(g * s_dx);
          s_dy = warp_sum(g * s_dy);
        }
        if (lane == 0) {
          const float ga = s_aw;
          const float gx = in ? static_cast<float>(w) * a * s_dx : 0.f;
          const float gy = in ? static_cast<float>(h) * a * s_dy : 0.f;
          if (d0 == 0) {
            d_aw[idx] = ga;
            d_x[idx] = gx;
            d_y[idx] = gy;
          } else {
            d_aw[idx] += ga;
            d_x[idx] += gx;
            d_y[idx] += gy;
          }
        }
      }
    }
  }
}

extern "C" {

// dtype: 0 = float32 value/grad_out, 1 = bfloat16 value/grad_out.
// Returns the cudaError_t of the launch (0 on success).
int msda_cm_bwd(const void* value, const void* x_cm, const void* y_cm,
                const void* aw_cm, const void* grad_out, void* d_value,
                void* d_x, void* d_y, void* d_aw, const int* level_h,
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
    msda_cm_bwd_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(x_cm),
        static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
        static_cast<const float*>(grad_out), static_cast<float*>(d_value),
        static_cast<float*>(d_x), static_cast<float*>(d_y), static_cast<float*>(d_aw),
        levels, n_batch, s_total, n_heads, dim, n_levels, n_points, lq);
  } else if (dtype == 1) {
    msda_cm_bwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(x_cm),
        static_cast<const float*>(y_cm), static_cast<const float*>(aw_cm),
        static_cast<const __nv_bfloat16*>(grad_out), static_cast<float*>(d_value),
        static_cast<float*>(d_x), static_cast<float*>(d_y), static_cast<float*>(d_aw),
        levels, n_batch, s_total, n_heads, dim, n_levels, n_points, lq);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
