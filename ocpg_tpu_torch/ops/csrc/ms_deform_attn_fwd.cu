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
// 64-byte rows through L1/L2.  The value (13 MB) stays in the 50 MB L2, so
// the real limit is L1/L2 gather throughput, in bytes and in load
// instructions, rather than HBM.
//
// Design.  A thread owns 16 bytes of channels (8 bf16 or 4 float32) of one
// (n, m, q): a corner row of D = 32 is 4 threads (bf16) or 8 (float32)
// wide, and a warp covers 8 (or 4) consecutive queries of one (n, m).  Each
// gather is one 16-byte load per thread, 512 bytes of 8 distinct rows per
// warp instruction, and the output is written with 16-byte stores into the
// contiguous (N, Lq, M * D) row.  A block of up to 256 threads takes
// q_block consecutive queries of one (n, m), sized to Lq by msda_q_block
// (64 at D = 32, bf16, at the encoder calls; one warp for the decoder's
// Lq = 5), and first stages their x, y and aw for all L * P samples in shared memory
// with coalesced loads (in the CM layout, 64 contiguous floats per sample;
// in the standard layout, each query's contiguous L * P * 3 floats).  Per
// sample, a thread then computes the bilinear weights, issues its four
// corner loads together (predicated, no branch between them) and sums them
// in (l, p, corner) order.  Gathers in flight come from occupancy: at most
// 40 registers a thread let 6 blocks (48 warps) share an SM; timed on the
// card, that beat issuing the 16 loads of four points together with the
// registers that takes (2 blocks per SM).  D must be a multiple of 8
// (bf16) or 4 (float32) and the value 16-byte aligned (the wrappers check).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrappers are
// ocpg_tpu_torch/ops/ms_deform_attn.py::ms_deform_attn_cm (CM) and
// ::ms_deform_attn_fast (standard).

#include <stdint.h>

#include "msda_common.cuh"

#define MSDA_FWD_THREADS 256
#define MSDA_FWD_MIN_BLOCKS 6    // per SM: 48 warps, at most 40 registers a thread

template <typename scalar_t, typename Layout>
__global__ void __launch_bounds__(MSDA_FWD_THREADS, MSDA_FWD_MIN_BLOCKS)
msda_fwd_kernel(const scalar_t* __restrict__ value, const float* __restrict__ x_ptr,
                const float* __restrict__ y_ptr, const float* __restrict__ aw_ptr,
                scalar_t* __restrict__ out, Levels levels, int s_total, int n_heads,
                int dim, int n_levels, int n_points, int lq, int q_block, int q_tiles) {
  using V = Vec16<scalar_t>;
  // x, y, aw: (L * P, q_block) each, row stride q_block + 1 so that the
  // standard layout's staging (threads over samples) is free of bank conflicts
  extern __shared__ float sparam[];
  const int lp = n_levels * n_points;
  const int ld = q_block + 1;
  float* sx = sparam;
  float* sy = sx + lp * ld;
  float* sa = sy + lp * ld;

  const int nm = blockIdx.x / q_tiles;            // n * M + m
  const int q0 = (blockIdx.x - nm * q_tiles) * q_block;
  const int m = nm % n_heads;
  const int n = nm / n_heads;
  for_each_slot<Layout>(n, m, q0, q_block, n_heads, lp, lq, [&](int slot, long long idx) {
    sx[slot] = __ldg(x_ptr + idx * Layout::kXY);
    sy[slot] = __ldg(y_ptr + idx * Layout::kXY);
    sa[slot] = __ldg(aw_ptr + idx);
  });
  __syncthreads();

  const int chunks = dim / V::kN;                 // 16-byte chunks per head row
  const int qi = threadIdx.x / chunks;
  const int q = q0 + qi;
  if (qi >= q_block || q >= lq) return;
  const int ch = (threadIdx.x - qi * chunks) * V::kN;
  const long long row_stride = static_cast<long long>(n_heads) * dim;  // one s step
  const scalar_t* v_nm = value + static_cast<long long>(n) * s_total * row_stride +
                         static_cast<long long>(m) * dim + ch;

  float acc[V::kN];
#pragma unroll
  for (int i = 0; i < V::kN; ++i) acc[i] = 0.f;
  for (int l = 0; l < n_levels; ++l) {
    const int h = levels.h[l];
    const int w = levels.w[l];
    const scalar_t* v_l = v_nm + static_cast<long long>(levels.start[l]) * row_stride;
    for (int p = 0; p < n_points; ++p) {
      const int sq = (l * n_points + p) * ld + qi;
      const float a = sa[sq];
      const float xp = __fsub_rn(__fmul_rn(sx[sq], static_cast<float>(w)), 0.5f);
      const float yp = __fsub_rn(__fmul_rn(sy[sq], static_cast<float>(h)), 0.5f);
      // samples wholly outside the map (or NaN) contribute nothing; this
      // also keeps the float -> int casts below in range
      const bool valid = xp > -1.f && yp > -1.f && xp < w && yp < h;
      const float xf = valid ? floorf(xp) : 0.f;
      const float yf = valid ? floorf(yp) : 0.f;
      const float dx = xp - xf;
      const float dy = yp - yf;
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      const float wts[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                            (1.f - dx) * dy, dx * dy};
      // the four corner rows (-1: outside the map), loaded together
      int row[4];
      uint4 raw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0 + (c & 1);
        const int cy = y0 + (c >> 1);
        row[c] = valid && cx >= 0 && cx <= w - 1 && cy >= 0 && cy <= h - 1 ? cy * w + cx : -1;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        raw[c] = row[c] >= 0 ? __ldg(reinterpret_cast<const uint4*>(v_l + row[c] * row_stride))
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row[c] < 0) continue;
        float v[V::kN];
        V::unpack(raw[c], v);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) acc[i] += a * wts[c] * v[i];
      }
    }
  }
  *reinterpret_cast<uint4*>(out + (static_cast<long long>(n) * lq + q) * row_stride +
                            static_cast<long long>(m) * dim + ch) = V::pack(acc);
}

template <typename scalar_t, typename Layout>
static int launch_typed(const void* value, const float* x, const float* y, const float* aw,
                        void* out, const Levels& levels, int n_batch, int s_total,
                        int n_heads, int dim, int n_levels, int n_points, int lq,
                        cudaStream_t s) {
  constexpr int vec = Vec16<scalar_t>::kN;
  if (dim % vec != 0 || dim / vec > MSDA_FWD_THREADS ||
      (reinterpret_cast<uintptr_t>(value) & 15u) != 0)
    return cudaErrorInvalidValue;
  const int chunks = dim / vec;
  const int lp = n_levels * n_points;
  const int q_block = msda_q_block(lq, chunks, MSDA_FWD_THREADS, lp, 3);
  const size_t smem = msda_smem_bytes(q_block, lp, 3);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int q_tiles = (lq + q_block - 1) / q_block;
  const long long blocks = static_cast<long long>(n_batch) * n_heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  msda_fwd_kernel<scalar_t, Layout><<<static_cast<unsigned>(blocks), q_block * chunks, smem,
                                      s>>>(
      static_cast<const scalar_t*>(value), x, y, aw, static_cast<scalar_t*>(out), levels,
      s_total, n_heads, dim, n_levels, n_points, lq, q_block, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename Layout>
static int launch_fwd(const void* value, const float* x, const float* y,
                      const float* aw, void* out, const int* level_h,
                      const int* level_w, int n_batch, int s_total, int n_heads,
                      int dim, int n_levels, int n_points, int lq, int dtype,
                      void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  if (static_cast<long long>(n_batch) * n_heads * lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float, Layout>(value, x, y, aw, out, levels, n_batch, s_total,
                                       n_heads, dim, n_levels, n_points, lq, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, Layout>(value, x, y, aw, out, levels, n_batch,
                                               s_total, n_heads, dim, n_levels, n_points,
                                               lq, s);
  return cudaErrorInvalidValue;
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
