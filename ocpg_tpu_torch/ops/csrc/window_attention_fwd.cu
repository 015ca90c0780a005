// Swin (shifted-)window attention forward.
//
// Replaces ocpg_tpu/ops/window_attention_pallas.py::window_attention_fused
// (kernel body _wattn_kernel).  For every window b and head h:
//
//   out[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h,:] + bias[h,i,j]
//                                     + mask[b % n_mask, i, j]) * v[b, j, h, :]
//
// with q pre-scaled by dh^-0.5, the logits, the softmax and the P.V sums in
// float32, and the output in the input's type.  bias and mask come in the
// input's type (the wrapper casts them, as the plain version does); the
// SW-MSA mask's 0 and -100 are exact in bf16.
//
// Layouts: q, k, v (bw, n, heads, dh) with any batch and token strides and
// the (heads, dh) part packed, so k and v may be the slices of the
// (bw, n, 3, heads, dh) qkv projection; bias (heads, n, n) and mask
// (n_mask, n, n) contiguous, the window index varying fastest within bw;
// out (bw, n, heads, dh) contiguous.
//
// What bounds it on an H100.  At the Swin-B serving call of stage 0
// (bw = 322, n = 245, heads = 4, dh = 32, bf16) the function reads q, k, v
// and writes out, 81 MB, plus 39 MB of bf16 mask: about 36 us at 3.35 TB/s.
// Its 9.9 GFLOP take 10 us at the bf16 tensor-core rate, so the bound is
// bytes.  The TPU kernel's point, keeping the (bw, heads, n, n) logits out
// of device memory, holds here too: they are 310 MB in float32.
//
// Design (simple and right first; tensor cores and TMA are later work).  One
// block of 8 warps per (window, head).  The block stages that head's K (row
// stride dh + 1, so lanes that run over keys hit distinct banks) and V in
// shared memory as float32: 2 x 245 x 32 x 4 B = 63 KB at n = 245, 100 KB at
// the largest window n = 392.  Each warp takes query rows in turn: its q row
// goes to shared memory, lanes run over keys for the logits, which stay in a
// per-warp row of n floats in shared memory; the row max and the sum of
// exponentials are warp-shuffle reductions; lanes then run over dh for P.V.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/window_attention.py::window_attention.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define WATTN_MAX_N 392
#define WATTN_MAX_DH 64
#define WATTN_WARPS 8

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WATTN_WARPS * 32)
wattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 const T* __restrict__ mask, T* __restrict__ out, int n, int heads,
                 int dh, int n_mask, long long q_sb, long long q_sn, long long k_sb,
                 long long k_sn, long long v_sb, long long v_sn) {
  extern __shared__ float smem[];
  const int kld = dh + 1;
  float* ks = smem;                        // n x (dh + 1)
  float* vs = ks + n * kld;                // n x dh
  float* qs = vs + n * dh;                 // WATTN_WARPS x dh
  float* ps = qs + WATTN_WARPS * dh;       // WATTN_WARPS x n

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const T* kb = k + b * k_sb + static_cast<long long>(h) * dh;
  const T* vb = v + b * v_sb + static_cast<long long>(h) * dh;
  for (int idx = threadIdx.x; idx < n * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    ks[j * kld + d] = to_float(kb[j * k_sn + d]);
    vs[idx] = to_float(vb[j * v_sn + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * dh;
  float* pw = ps + warp * n;
  const T* bias_h = bias + static_cast<long long>(h) * n * n;
  const T* mask_w = mask == nullptr ? nullptr
                                    : mask + static_cast<long long>(b % n_mask) * n * n;
  T* ob = out + static_cast<long long>(b) * n * heads * dh + static_cast<long long>(h) * dh;

  for (int i = warp; i < n; i += WATTN_WARPS) {
    const T* qrow = q + b * q_sb + i * q_sn + static_cast<long long>(h) * dh;
    for (int d = lane; d < dh; d += 32) qw[d] = to_float(qrow[d]);
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * kld;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qw[d], kr[d], s);
      s += to_float(bias_h[i * n + j]);
      if (mask_w != nullptr) s += to_float(mask_w[i * n + j]);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();

    const float inv = 1.f / sum;
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(pw[j], vs[j * dh + d], acc);
      store(ob + static_cast<long long>(i) * heads * dh + d, acc * inv);
    }
    __syncwarp();   // qw and pw are rewritten by the next row
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, void* out, int bw, int n, int heads, int dh,
                  int n_mask, long long q_sb, long long q_sn, long long k_sb,
                  long long k_sn, long long v_sb, long long v_sn, cudaStream_t s) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(n) * (2 * dh + 1) + WATTN_WARPS * (static_cast<size_t>(dh) + n));
  // above 48 KB a block's shared memory must be asked for (on the current
  // device, so on every launch)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wattn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wattn_fwd_kernel<T><<<bw * heads, WATTN_WARPS * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<T*>(out), n,
      heads, dh, n_mask, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, mask and out alike).
// mask may be null (no SW-MSA mask; n_mask is then ignored).  Strides are in
// elements.  Returns the cudaError_t of the launch (0 on success).
int wattn_fwd(const void* q, const void* k, const void* v, const void* bias,
              const void* mask, void* out, int bw, int n, int heads, int dh, int n_mask,
              long long q_sb, long long q_sn, long long k_sb, long long k_sn,
              long long v_sb, long long v_sn, int dtype, void* stream) {
  if (n < 1 || n > WATTN_MAX_N || dh < 1 || dh > WATTN_MAX_DH || heads < 1 || bw < 0)
    return cudaErrorInvalidValue;
  if (mask != nullptr && (n_mask < 1 || bw % n_mask != 0)) return cudaErrorInvalidValue;
  if (static_cast<long long>(bw) * heads > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (bw == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                         k_sb, k_sn, v_sb, v_sn, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb,
                                 q_sn, k_sb, k_sn, v_sb, v_sn, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
