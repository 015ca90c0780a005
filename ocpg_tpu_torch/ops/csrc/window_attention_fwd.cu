// Swin (shifted-)window attention forward.
//
// Replaces ocpg_tpu/ops/window_attention_pallas.py::window_attention_fused
// (kernel body _wattn_kernel).  For every window b and head h:
//
//   out[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h,:] + bias[h,i,j]
//                                     + mask[b % n_mask, i, j]) * v[b, j, h, :]
//
// with q pre-scaled by dh^-0.5, the softmax in float32 and the output in the
// input's type.  bias and mask come in the input's type (the wrapper casts
// them, as the plain version does); the SW-MSA mask's 0 and -100 are exact
// in bf16.
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
// Its 9.9 GFLOP take 10 us at the bf16 tensor-core rate.  The TPU kernel's
// point, keeping the (bw, heads, n, n) logits out of device memory, holds
// here too: they are 310 MB in float32.  Inside the kernel the floor is the
// bias and mask: every (window, head) reads its n x n of each, 309 MB at
// stage 0, from L2 (the bias is shared by the windows, the mask by the
// heads), plus one exponential per logit.
//
// Two bodies:
//
// * bfloat16 (wattn_fwd_tc_kernel), on the tensor cores, as flash attention
//   does it.  One block of 4 warps per (window, head), the head innermost
//   in blockIdx, so that the heads of one window run together and share its
//   mask in L2; when there are few windows, blockIdx.y splits the query
//   tiles of one (window, head) over several blocks.  The block stages the
//   head's K and V rows in shared memory as bf16 with 16-byte loads, n
//   zero-padded to a multiple of 16 and dh to a multiple of 16, rows padded
//   by 16 bytes so that ldmatrix is free of bank conflicts (20 KB each at
//   n = 245, dh = 32).  Each warp takes 16-row query tiles in turn; its Q
//   fragments come once per tile through a per-warp slab.  For each chunk
//   of 32 keys the accumulators start from bias + mask, read as bf16 from
//   global memory (L2) in the accumulator's own layout, the next chunk's
//   loads issued before this chunk's softmax so that they are in flight
//   during it; S = Q K^T by mma.sync m16n8k16; padded keys get -inf; an
//   online softmax keeps the row max and sum (quad shuffles); P is rounded
//   to bf16 straight from the accumulators into A fragments (the rounding
//   the TPU kernel makes), and O += P V with V fragments from
//   ldmatrix.trans.  No logit leaves the registers.  Chunks of 32 keys
//   rather than 64 keep the loads, the logits and O within 128 registers
//   (4 blocks, 16 warps per SM) without spilling.  The output is normalised at the end and stored with
//   16-byte stores through the slab.  Takes dh a multiple of 8 and 16-byte
//   aligned q, k, v rows (the wrapper checks).
// * float32 (wattn_fwd_f32_kernel), exact float32 throughout: one block of
//   8 warps per (window, head) stages K (row stride dh + 1) and V in shared
//   memory as float32 (63 KB at n = 245, 100 KB at n = 392); each warp
//   takes query rows in turn, lanes over keys for the logits (kept in a
//   per-warp row of shared memory), warp-shuffle max and sum, lanes over dh
//   for P.V.  It serves the float32 models, which are held to tight bounds.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/window_attention.py::window_attention.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tensor_core.cuh"

#define WATTN_MAX_N 392
#define WATTN_MAX_DH 64
#define WATTN_WARPS 8          // float32 body
#define WATTN_TC_WARPS 4       // bfloat16 body
#define WATTN_KEY_CHUNK 32     // keys per online-softmax step

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

// ------------------------------------------------------------ float32 body --
__global__ void __launch_bounds__(WATTN_WARPS * 32)
wattn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out, int n,
                     int heads, int dh, int n_mask, long long q_sb, long long q_sn,
                     long long k_sb, long long k_sn, long long v_sb, long long v_sn) {
  extern __shared__ float smem[];
  const int kld = dh + 1;
  float* ks = smem;                        // n x (dh + 1)
  float* vs = ks + n * kld;                // n x dh
  float* qs = vs + n * dh;                 // WATTN_WARPS x dh
  float* ps = qs + WATTN_WARPS * dh;       // WATTN_WARPS x n

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const float* kb = k + b * k_sb + static_cast<long long>(h) * dh;
  const float* vb = v + b * v_sb + static_cast<long long>(h) * dh;
  for (int idx = threadIdx.x; idx < n * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    ks[j * kld + d] = kb[j * k_sn + d];
    vs[idx] = vb[j * v_sn + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * dh;
  float* pw = ps + warp * n;
  const float* bias_h = bias + static_cast<long long>(h) * n * n;
  const float* mask_w = mask == nullptr ? nullptr
                                        : mask + static_cast<long long>(b % n_mask) * n * n;
  float* ob = out + static_cast<long long>(b) * n * heads * dh + static_cast<long long>(h) * dh;

  for (int i = warp; i < n; i += WATTN_WARPS) {
    const float* qrow = q + b * q_sb + i * q_sn + static_cast<long long>(h) * dh;
    for (int d = lane; d < dh; d += 32) qw[d] = qrow[d];
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * kld;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qw[d], kr[d], s);
      s += bias_h[i * n + j];
      if (mask_w != nullptr) s += mask_w[i * n + j];
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
      ob[static_cast<long long>(i) * heads * dh + d] = acc * inv;
    }
    __syncwarp();   // qw and pw are rewritten by the next row
  }
}

// ----------------------------------------------------------- bfloat16 body --
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// DH: dh rounded up to a multiple of 16 (the products' depth); MASKED: a
// SW-MSA mask is given.
template <int DH, bool MASKED>
__global__ void __launch_bounds__(WATTN_TC_WARPS * 32, 4)
wattn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ bias,
                    const bf16* __restrict__ mask, bf16* __restrict__ out, int n, int heads,
                    int dh, int n_mask, long long q_sb, long long q_sn, long long k_sb,
                    long long k_sn, long long v_sb, long long v_sn) {
  constexpr int LD = DH + 8;      // row stride in shared memory (bf16): +16 bytes
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int NT = WATTN_KEY_CHUNK / 8;   // 8-key n-tiles per chunk
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n16 = (n + 15) & ~15;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);     // n16 x LD
  bf16* vs = ks + n16 * LD;                          // n16 x LD
  bf16* slabs = vs + n16 * LD;                       // WATTN_TC_WARPS x 16 x LD

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const bf16* kb = k + b * k_sb + static_cast<long long>(h) * dh;
  const bf16* vb = v + b * v_sb + static_cast<long long>(h) * dh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < n16 * CH; idx += blockDim.x) {
    const int j = idx / CH;
    const int c = idx - j * CH;
    const bool in = j < n && c * 8 < dh;
    *reinterpret_cast<uint4*>(ks + j * LD + c * 8) = in ? load16(kb + j * k_sn + c * 8) : zero;
    *reinterpret_cast<uint4*>(vs + j * LD + c * 8) = in ? load16(vb + j * v_sn + c * 8) : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  bf16* slab = slabs + warp * 16 * LD;
  const bf16* qb = q + b * q_sb + static_cast<long long>(h) * dh;
  const bf16* bias_h = bias + static_cast<long long>(h) * n * n;
  const bf16* mask_w = MASKED ? mask + static_cast<long long>(b % n_mask) * n * n : nullptr;
  bf16* ob = out + static_cast<long long>(b) * n * heads * dh + static_cast<long long>(h) * dh;
  const long long o_sn = static_cast<long long>(heads) * dh;

  for (int tile = blockIdx.y * WATTN_TC_WARPS + warp; tile * 16 < n16;
       tile += gridDim.y * WATTN_TC_WARPS) {
    const int i0 = tile * 16;
    // the tile's 16 query rows through the slab into A fragments
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      const bool in = i0 + r < n && c * 8 < dh;
      *reinterpret_cast<uint4*>(slab + r * LD + c * 8) =
          in ? load16(qb + (i0 + r) * q_sn + c * 8) : zero;
    }
    __syncwarp();
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldmatrix_x4(qa[kk], slab + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

    // rows g and g + 8 of the tile: their bias and mask rows (a padded row
    // reads the last one: it is never stored), running max and sum of
    // exponentials
    const long long i_lo = min(i0 + g, n - 1);
    const long long i_hi = min(i0 + g + 8, n - 1);
    const bf16* brow[2] = {bias_h + i_lo * n, bias_h + i_hi * n};
    const bf16* mrow[2] = {mask_w + i_lo * n, mask_w + i_hi * n};
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};
    float o[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

    // the chunk's bias and mask rows as loaded.  The loads carry no
    // condition (a padded key reads the last column and is set to -inf
    // below), so that they are all in flight together.
    bf16 braw[NT][4], mraw[NT][4];
    const auto load_bias_mask = [&](int c0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = min(c0 + nt * 8 + 2 * t + (e & 1), n - 1);
          braw[nt][e] = __ldg(brow[e >> 1] + j);
          if (MASKED) mraw[nt][e] = __ldg(mrow[e >> 1] + j);
        }
      }
    };
    load_bias_mask(0);

    for (int c0 = 0; c0 < n16; c0 += WATTN_KEY_CHUNK) {
      // S starts from bias + mask in float32
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = __bfloat162float(braw[nt][e]);
          if (MASKED) s[nt][e] += __bfloat162float(mraw[nt][e]);
        }
      }
      // S += Q K^T, 16 keys (two n-tiles) at a time
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (c0 + np * 16 >= n16) break;
        const bf16* krow = ks + (c0 + np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD +
                           ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, krow + kk * 16);
          mma_bf16_16816(s[2 * np], qa[kk], kf[0], kf[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kk], kf[2], kf[3]);
        }
      }
      // the next chunk's bias and mask, in flight during this one's softmax
      if (c0 + WATTN_KEY_CHUNK < n16) load_bias_mask(c0 + WATTN_KEY_CHUNK);
      // padded keys take no weight
      if (c0 + WATTN_KEY_CHUNK > n) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + nt * 8 + 2 * t + (e & 1) >= n) s[nt][e] = -INFINITY;
        }
      }
      // online softmax: the new row max (over the quad that holds the row),
      // the old sums rescaled
      float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float mx_log2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f((row_max[r] - mx[r]) * LOG2E);
        row_max[r] = mx[r];
        row_sum[r] *= alpha;
        mx_log2[r] = mx[r] * LOG2E;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
      }
      // P = exp(S - max), rounded to bf16 into A fragments; O += P V
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (c0 + np * 16 >= n16) break;
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = (e >> 1) & 1;
          p[e] = exp2f(fmaf(s[2 * np + (e >> 2)][e & 3], LOG2E, -mx_log2[r]));
          row_sum[r] += p[e];
        }
        const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
        const bf16* vrow = vs + (c0 + np * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + dp * 16);
          mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }

    // normalise, then out through the slab with 16-byte stores
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = row_sum[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.f / sum;
    }
    __syncwarp();   // every lane's Q fragments are loaded
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(slab + g * LD + dt * 8 + 2 * t) =
          pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(slab + (g + 8) * LD + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      if (i0 + r < n && c * 8 < dh)
        *reinterpret_cast<uint4*>(ob + (i0 + r) * o_sn + c * 8) =
            *reinterpret_cast<const uint4*>(slab + r * LD + c * 8);
    }
    __syncwarp();   // the slab is rewritten by the next tile
  }
}

// ---------------------------------------------------------------- launches --
// Above 48 KB a block's shared memory must be asked for (on the current
// device, so on every launch).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

static int launch_f32(const void* q, const void* k, const void* v, const void* bias,
                      const void* mask, void* out, int bw, int n, int heads, int dh,
                      int n_mask, long long q_sb, long long q_sn, long long k_sb,
                      long long k_sn, long long v_sb, long long v_sn, cudaStream_t s) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(n) * (2 * dh + 1) + WATTN_WARPS * (static_cast<size_t>(dh) + n));
  const cudaError_t err = allow_smem(wattn_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wattn_fwd_f32_kernel<<<bw * heads, WATTN_WARPS * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), n, heads, dh, n_mask,
      q_sb, q_sn, k_sb, k_sn, v_sb, v_sn);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, asked once per device.
static int sm_count() {
  static int counts[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 132;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return counts[device];
}

template <int DH, bool MASKED>
static int launch_tc(const void* q, const void* k, const void* v, const void* bias,
                     const void* mask, void* out, int bw, int n, int heads, int dh,
                     int n_mask, long long q_sb, long long q_sn, long long k_sb,
                     long long k_sn, long long v_sb, long long v_sn, cudaStream_t s) {
  const int n16 = (n + 15) & ~15;
  const size_t smem = sizeof(bf16) * (DH + 8) *
                      (2 * static_cast<size_t>(n16) + WATTN_TC_WARPS * 16);
  cudaError_t err = allow_smem(wattn_fwd_tc_kernel<DH, MASKED>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // split the query tiles of each (window, head) over blockIdx.y until
  // there are about eight blocks per SM: the later Swin stages have few
  // windows, and smaller blocks leave a shorter last wave
  const long long units = static_cast<long long>(bw) * heads;
  const int tiles = n16 / 16;
  int split = 1;
  while (2 * split * WATTN_TC_WARPS <= tiles && units * split < 8LL * sm_count()) split *= 2;
  wattn_fwd_tc_kernel<DH, MASKED><<<dim3(static_cast<unsigned>(units), split),
                                    WATTN_TC_WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(mask), static_cast<bf16*>(out),
      n, heads, dh, n_mask, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
static int launch_tc(const void* q, const void* k, const void* v, const void* bias,
                     const void* mask, void* out, int bw, int n, int heads, int dh,
                     int n_mask, long long q_sb, long long q_sn, long long k_sb,
                     long long k_sn, long long v_sb, long long v_sn, cudaStream_t s) {
  if (mask != nullptr)
    return launch_tc<DH, true>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb,
                               q_sn, k_sb, k_sn, v_sb, v_sn, s);
  return launch_tc<DH, false>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                              k_sb, k_sn, v_sb, v_sn, s);
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, mask and out alike).
// mask may be null (no SW-MSA mask; n_mask is then ignored).  Strides are in
// elements.  bfloat16 takes dh a multiple of 8, q, k, v 16-byte aligned and
// their strides multiples of 8.  Returns the cudaError_t of the launch (0 on
// success).
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
    return launch_f32(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn, k_sb,
                      k_sn, v_sb, v_sn, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (dh % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      ((q_sb | q_sn | k_sb | k_sn | v_sb | v_sn) & 7) != 0)
    return cudaErrorMisalignedAddress;
  switch ((dh + 15) / 16) {
    case 1:
      return launch_tc<16>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                           k_sb, k_sn, v_sb, v_sn, s);
    case 2:
      return launch_tc<32>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                           k_sb, k_sn, v_sb, v_sn, s);
    case 3:
      return launch_tc<48>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                           k_sb, k_sn, v_sb, v_sn, s);
    default:
      return launch_tc<64>(q, k, v, bias, mask, out, bw, n, heads, dh, n_mask, q_sb, q_sn,
                           k_sb, k_sn, v_sb, v_sn, s);
  }
}

}  // extern "C"
