// Multi-scale deformable attention forward as dense sampling rows on the
// tensor cores, channel-major query parameters; Hopper (sm_90a): wgmma fed
// by TMA.
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
// M is summed over the points in float32 and rounded once; the value is bf16
// (the wrapper rounds a float32 value before the launch, as the JAX wrapper
// does).  Accumulation is float32; the output is in the caller's type.  A
// sample whose pixel coordinate lies wholly outside the map, or is not
// finite (a wholly padded frame has NaN reference points), contributes
// nothing, as in K1 and the plain gather version (the interpreted TPU kernel
// returns NaN there instead).
//
// Layouts: value (N, S, M, D) bf16, S = sum_l H_l * W_l; x, y, aw
// (N, M, L, P, Lq) float32; out (N, Lq, M * D).  D in {8, 16, 32, 64}, P up
// to 8.
//
// What bounds it on an H100.  The function is K1's: at the serving encoder
// call (N=5, S=Lq=5100, M=8, D=32, L=P=4, bf16) about 65 MB to move, 19.5 us
// at 3.35 TB/s.  The formulation executes 2 * 256 * 64 * D tensor-core FLOPs
// for every (n, m, 256-query tile, level, 64-key chunk) that a corner of the
// tile lands in (ms_deform_attn_variants.py::r4_mma_flops): 67.1 GFLOP on
// uniform samples at that call (>= 0.068 ms at 989 TFLOP/s), 21.5 GFLOP on
// clustered ones, almost all of it on zeros (each M row has at most 16
// non-zeros per level).
//
// Design.  One block per (n, m) and tile of 256 queries: two consumer
// warpgroups of 128 query rows (two m64 wgmma row tiles each) and one
// producer warp.
//   * First the block marks which 64-key chunks of which level any corner of
//     its queries lands in (one byte per chunk).  Producer and consumers walk
//     the marked chunks in the same order; the others are skipped, with no
//     copy and no product.
//   * The producer warp streams each marked chunk's 64 value rows (64 x D
//     bf16, a box of a 2-D tensor map over the value as (N * S, M * D), with
//     the swizzle of a D-wide row) by TMA (cp.async.bulk.tensor) into a ring
//     of 6 stages with full and empty mbarriers (an empty stage takes one
//     arrival per consumer warp), so the next chunks are in flight while
//     this one multiplies.  The rows arrive as [key][d], wgmma's MN-major B
//     layout: no transpose.
//   * Per level, each consumer thread owns one query row: it computes the
//     row's 4 * P corners (flat key h * W + w, weight aw * w_c), sorts them
//     by key in registers (a bitonic network), sums corners that share a key
//     in float32, and files each as one packed entry (row, key % 64, bf16
//     weight) into its warpgroup's per-chunk buckets (a counting sort:
//     shared-memory counts, one warp's scan, fill cursors).  The corners are
//     walked once per level, not once per chunk.
//   * Per chunk, the warpgroup's 128 threads write the chunk's bucket into
//     the warpgroup's M tile (128 x 64 bf16, 32-byte swizzled K-major, two
//     buffers), multiply it by the chunk with 8 wgmma.mma_async m64nDk16
//     (A and B from shared memory by descriptor) into float32 accumulators
//     kept in registers over every chunk and level, wait for them, free the
//     ring stage, and clear the entries they wrote.
// Shared memory at D = 32, P <= 4: 24 KB ring, 64 KB M tiles, 16 KB
// buckets; two blocks per SM, which caps a thread at 96 registers.
//
// Measured on an H100 80GB HBM3 (700 W), bf16, at the serving encoder call:
// 0.43 ms on uniform samples (155 TFLOP/s of executed products), 0.30 ms
// on clustered ones, against 1.90 / 0.72 ms for the mma.sync kernel it
// replaces and 0.14 ms for K1 (ocpg_tpu_torch/scripts/time_kernels.py,
// chip_smoke.py).  Built without its products it reads 0.33 ms, without
// writing its M entries 0.39 ms (ocpg_tpu_torch/scripts/bench_msda_dense.py):
// the per-chunk skeleton (barrier, ring waits, a wgmma group's latency) sets
// the time, not the tensor cores.  Tried and dropped (scratch builds, read
// slower): each row thread walking its sorted corners chunk by chunk; 64
// query rows per warpgroup; a deeper ring (one block per SM); three blocks
// per SM (spills); one product group left in flight across chunks (ptxas
// then serializes the wgmma, C7515).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn_variants.py::ms_deform_attn_cm_r4.

#include <limits.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kRows = 256;           // queries per block
constexpr int kWgRows = 128;         // query rows per consumer warpgroup: two m64 sub-tiles
constexpr int kChunk = 64;           // keys per product
constexpr int kStages = 6;           // TMA ring depth
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kMaxPoints = 8;
constexpr int kMTile = kWgRows * kChunk * 2;   // bytes of one bf16 M tile
constexpr int kSub = kWgRows / 64;             // wgmma row tiles per warpgroup

template <int D>
__host__ __device__ constexpr int v_stage_bytes() { return kChunk * D * 2; }

// Dynamic shared memory, offsets from a 1024-byte aligned base: the value
// ring, two M tiles per warpgroup, per warpgroup the level's corner entries
// bucketed by chunk and the buckets' offsets, one byte per chunk of every
// level, the ring's mbarriers.
template <int D, int NC>
struct Smem {
  static constexpr int kV = 0;
  static constexpr int kM = kV + kStages * v_stage_bytes<D>();
  static constexpr int kEnt = kM + 2 * 2 * kMTile;            // [wg][64 * NC]
  static constexpr int kOff = kEnt + 2 * NC * kWgRows * 4;    // [wg][offsets, cursors]
  __host__ __device__ static int hit(int level_chunks_max) {
    return kOff + 2 * 2 * ((level_chunks_max + 4) & ~3) * 4;
  }
  __host__ __device__ static int bars(int level_chunks_max, int total_chunks) {
    return hit(level_chunks_max) + ((total_chunks + 15) & ~15);
  }
  __host__ __device__ static int bytes(int level_chunks_max, int total_chunks) {
    return bars(level_chunks_max, total_chunks) + 2 * kStages * 8 + 1024;
  }
};

// The four bilinear corners of one sample: flat key and weight aw * w_c,
// key INT_MAX where the corner is outside the map or the sample is not
// finite.
__device__ __forceinline__ void sample_corners(float xn, float yn, float a, int h, int w,
                                               int* key, float* wt) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    key[c] = INT_MAX;
    wt[c] = 0.f;
  }
  const float xp = xn * w - 0.5f;
  const float yp = yn * h - 0.5f;
  if (!(xp > -1.f && yp > -1.f && xp < w && yp < h)) return;   // also NaN / inf
  const float xf = floorf(xp);
  const float yf = floorf(yp);
  const float dx = xp - xf;
  const float dy = yp - yf;
  const int x0 = static_cast<int>(xf);
  const int y0 = static_cast<int>(yf);
  const float cw[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy), (1.f - dx) * dy, dx * dy};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cx = x0 + (c & 1);
    const int cy = y0 + (c >> 1);
    if (cx < 0 || cx > w - 1 || cy < 0 || cy > h - 1) continue;
    key[c] = cy * w + cx;
    wt[c] = a * cw[c];
  }
}

// Ascending sort of NC (key, weight) pairs in registers (bitonic network).
template <int NC>
__device__ __forceinline__ void sort_corners(int (&k)[NC], float (&w)[NC]) {
#pragma unroll
  for (int size = 2; size <= NC; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const bool swap = up ? k[i] > k[j] : k[i] < k[j];
          const int ki = k[i], kj = k[j];
          const float wi = w[i], wj = w[j];
          k[i] = swap ? kj : ki;
          k[j] = swap ? ki : kj;
          w[i] = swap ? wj : wi;
          w[j] = swap ? wi : wj;
        }
      }
    }
  }
}

__device__ __forceinline__ int level_chunks(int hw) { return (hw + kChunk - 1) / kChunk; }

// Byte offset of M element (row r, key k) in a 32-byte swizzled K-major
// tile of 128 rows: one 4 KB region per 16 keys.
__device__ __forceinline__ uint32_t m_offset(int r, int k) {
  return static_cast<uint32_t>((k >> 4) * (kWgRows * 32)) + sw32_offset(r, k & 15);
}

template <typename OutT, int D, int NC>
__global__ void __launch_bounds__(kThreads, 2)
msda_r4_kernel(const __grid_constant__ CUtensorMap vmap, const float* __restrict__ x_cm,
               const float* __restrict__ y_cm, const float* __restrict__ aw_cm,
               OutT* __restrict__ out, Levels levels, int s_total, int n_heads, int n_levels,
               int n_points, int lq, int level_chunks_max, int total_chunks) {
  using S = Smem<D, NC>;
  constexpr int kAcc = D / 2;   // float32 accumulators per thread (64 x D per warpgroup)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* hit = smem + S::hit(level_chunks_max);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars(level_chunks_max, total_chunks));
  uint64_t* empty = full + kStages;

  const int n_qtiles = (lq + kRows - 1) / kRows;
  const long long nm = blockIdx.x / n_qtiles;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kRows;
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    fence_mbarrier_init();
  }
  for (int i = tid; i < total_chunks; i += kThreads) hit[i] = 0;
  for (int i = tid; i < 4 * kMTile / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem + S::kM)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // Mark the chunks that a corner of the tile's queries lands in.
  for (int task = tid; task < kRows * n_levels * n_points; task += kThreads) {
    const int r = task % kRows;
    const int lp = task / kRows;
    const int l = lp / n_points;
    const int q = q0 + r;
    if (q >= lq) continue;
    int base = 0;
    for (int i = 0; i < l; ++i) base += level_chunks(levels.h[i] * levels.w[i]);
    const long long idx = (nm * n_levels * n_points + lp) * lq + q;
    int key[4];
    float wt[4];
    sample_corners(__ldg(x_cm + idx), __ldg(y_cm + idx), __ldg(aw_cm + idx), levels.h[l],
                   levels.w[l], key, wt);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (key[c] != INT_MAX) hit[base + key[c] / kChunk] = 1;
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warp: one thread streams the marked chunks' value rows.
    if (tid == kConsumers) {
      int i = 0, base = 0;
      for (int l = 0; l < n_levels; ++l) {
        const int nc = level_chunks(levels.h[l] * levels.w[l]);
        const int row0 = n * s_total + levels.start[l];
        for (int c = 0; c < nc; ++c) {
          if (!hit[base + c]) continue;
          const int st = i % kStages;
          if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
          mbar_arrive_expect_tx(&full[st], v_stage_bytes<D>());
          tma_load_2d(smem + S::kV + st * v_stage_bytes<D>(), &vmap, &full[st], m * D,
                      row0 + c * kChunk);
          ++i;
        }
        base += nc;
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const int row = wt;   // one thread per query row computes its corners
  uint32_t* ent = reinterpret_cast<uint32_t*>(smem + S::kEnt) + wg * NC * kWgRows;
  const int ld_off = (level_chunks_max + 4) & ~3;
  int* off = reinterpret_cast<int*>(smem + S::kOff) + wg * 2 * ld_off;   // bucket offsets
  int* cur = off + ld_off;                                               // fill cursors
  unsigned char* m_wg = smem + S::kM + wg * 2 * kMTile;
  const int q_row = q0 + wg * kWgRows + row;

  float acc[kSub][kAcc];
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[u][j] = 0.f;
  }
  int i = 0, base = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = levels.h[l];
    const int w = levels.w[l];
    const int nc = level_chunks(h * w);
    // The warpgroup's corner entries of this level, bucketed by chunk:
    // entry (row << 22 | key % 64 << 16 | bf16 weight), the weights of a
    // row's corners that share a key summed in float32 first.  Each thread
    // owns one query row: its 4 * P corners, sorted by key in registers.
    named_barrier(1 + wg, 128);   // the previous level's entries are read
    for (int c = wt; c <= nc; c += 128) off[c] = 0;
    named_barrier(1 + wg, 128);
    int key[NC];
    float wts[NC];
#pragma unroll
    for (int p = 0; p < NC / 4; ++p) {
      if (p < n_points && q_row < lq) {
        const long long idx = ((nm * n_levels + l) * n_points + p) * lq + q_row;
        sample_corners(__ldg(x_cm + idx), __ldg(y_cm + idx), __ldg(aw_cm + idx), h, w,
                       &key[4 * p], &wts[4 * p]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          key[4 * p + c] = INT_MAX;
          wts[4 * p + c] = 0.f;
        }
      }
    }
    sort_corners<NC>(key, wts);
#pragma unroll
    for (int c = NC - 1; c > 0; --c) {
      if (key[c] != INT_MAX && key[c] == key[c - 1]) {
        wts[c - 1] += wts[c];
        key[c] = INT_MAX;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)   // bucket sizes
      if (key[c] != INT_MAX) atomicAdd(&off[key[c] / kChunk], 1);
    named_barrier(1 + wg, 128);
    if (wt < 32) {   // exclusive scan of the bucket sizes: offsets and fill cursors
      int carry = 0;
      for (int c0 = 0; c0 < nc; c0 += 32) {
        const int own = c0 + lane < nc ? off[c0 + lane] : 0;
        int v = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        if (c0 + lane < nc) off[c0 + lane] = cur[c0 + lane] = carry + v - own;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (lane == 0) off[nc] = carry;
    }
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (key[c] == INT_MAX) continue;
      ent[atomicAdd(&cur[key[c] / kChunk], 1)] =
          (static_cast<uint32_t>(row) << 22) | (static_cast<uint32_t>(key[c] % kChunk) << 16) |
          static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(wts[c])));
    }
    named_barrier(1 + wg, 128);

    for (int c = 0; c < nc; ++c) {
      if (!hit[base + c]) continue;
      unsigned char* mb = m_wg + (i & 1) * kMTile;
      for (int e = off[c] + wt; e < off[c + 1]; e += 128) {
        const uint32_t v = ent[e];
        *reinterpret_cast<unsigned short*>(mb + m_offset(v >> 22, (v >> 16) & 63)) =
            static_cast<unsigned short>(v & 0xffffu);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);   // the warpgroup's M tile is written

      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint32_t a0 = smem_u32(mb);
      const uint32_t b0 = smem_u32(smem + S::kV + st * v_stage_bytes<D>());
#pragma unroll
      for (int u = 0; u < kSub; ++u) wgmma_fence_regs(acc[u]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < kSub; ++u)
          Wgmma<D>::mma(acc[u], wgmma_desc_a_sw32(a0 + kk * kWgRows * 32 + u * 64 * 32),
                        wgmma_desc_b_mn<D>(b0 + kk * 16 * D * 2), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int u = 0; u < kSub; ++u) wgmma_fence_regs(acc[u]);
      if (lane == 0) mbar_arrive(&empty[st]);
      // clear this chunk's entries for the tile's next chunk (whose barrier
      // orders the stores)
      for (int e = off[c] + wt; e < off[c + 1]; e += 128) {
        const uint32_t v = ent[e];
        *reinterpret_cast<unsigned short*>(mb + m_offset(v >> 22, (v >> 16) & 63)) = 0;
      }
      ++i;
    }
    base += nc;
  }

  const long long row_stride = static_cast<long long>(n_heads) * D;
  OutT* o = out + static_cast<long long>(n) * lq * row_stride + static_cast<long long>(m) * D;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + wg * kWgRows + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = r0 + 64 * u + 8 * half;
      if (q >= lq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store(o + static_cast<long long>(q) * row_stride + 8 * j + 2 * t + e,
                acc[u][4 * j + 2 * half + e]);
      }
    }
  }
}

template <typename OutT, int D, int NC>
int launch(const void* value, const void* x_cm, const void* y_cm, const void* aw_cm, void* out,
           const Levels& levels, int n_batch, long long blocks, int s_total, int n_heads,
           int n_levels, int n_points, int lq, int level_chunks_max, int total_chunks,
           cudaStream_t s) {
  CUtensorMap vmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_heads) * D,
                              static_cast<cuuint64_t>(n_batch) * s_total};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n_heads) * D * 2};
  const cuuint32_t box[2] = {D, kChunk};
  int err = encode_tensor_map_bf16(&vmap, value, 2, dims, strides, box, swizzle_for_row(D));
  if (err != 0) return err;
  const int smem = Smem<D, NC>::bytes(level_chunks_max, total_chunks);
  if (smem > max_dynamic_smem()) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(msda_r4_kernel<OutT, D, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  msda_r4_kernel<OutT, D, NC><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      vmap, static_cast<const float*>(x_cm), static_cast<const float*>(y_cm),
      static_cast<const float*>(aw_cm), static_cast<OutT*>(out), levels, s_total, n_heads,
      n_levels, n_points, lq, level_chunks_max, total_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int NC>
int launch_dim(int dim, const void* value, const void* x_cm, const void* y_cm,
               const void* aw_cm, void* out, const Levels& levels, int n_batch,
               long long blocks, int s_total, int n_heads, int n_levels, int n_points, int lq,
               int level_chunks_max, int total_chunks, cudaStream_t s) {
#define MSDA_R4_CASE(D_)                                                                 \
  case D_:                                                                               \
    return launch<OutT, D_, NC>(value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks,  \
                                s_total, n_heads, n_levels, n_points, lq, level_chunks_max, \
                                total_chunks, s);
  switch (dim) {
    MSDA_R4_CASE(8) MSDA_R4_CASE(16) MSDA_R4_CASE(32) MSDA_R4_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef MSDA_R4_CASE
}

template <typename OutT>
int launch_points(int dim, const void* value, const void* x_cm, const void* y_cm,
                  const void* aw_cm, void* out, const Levels& levels, int n_batch,
                  long long blocks, int s_total, int n_heads, int n_levels, int n_points,
                  int lq, int level_chunks_max, int total_chunks, cudaStream_t s) {
  if (n_points <= 4)
    return launch_dim<OutT, 16>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks,
                                s_total, n_heads, n_levels, n_points, lq, level_chunks_max,
                                total_chunks, s);
  return launch_dim<OutT, 32>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks,
                              s_total, n_heads, n_levels, n_points, lq, level_chunks_max,
                              total_chunks, s);
}

}  // namespace

extern "C" {

// value is bf16; dtype is the output's: 0 = float32, 1 = bfloat16.  The
// value must start on 16 bytes (TMA).  Returns the cudaError_t of the
// launch (0 on success).
int msda_cm_r4_fwd(const void* value, const void* x_cm, const void* y_cm,
                   const void* aw_cm, void* out, const int* level_h, const int* level_w,
                   int n_batch, int s_total, int n_heads, int dim, int n_levels,
                   int n_points, int lq, int dtype, void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  if ((dim != 8 && dim != 16 && dim != 32 && dim != 64) || n_points < 1 ||
      n_points > kMaxPoints || reinterpret_cast<uintptr_t>(value) % 16 != 0)
    return cudaErrorInvalidValue;
  int total_chunks = 0, level_chunks_max = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int nc = (level_h[l] * level_w[l] + kChunk - 1) / kChunk;
    total_chunks += nc;
    if (nc > level_chunks_max) level_chunks_max = nc;
  }
  const long long blocks = static_cast<long long>(n_batch) * n_heads *
                           ((lq + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_points<float>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks,
                                s_total, n_heads, n_levels, n_points, lq, level_chunks_max,
                                total_chunks, s);
  if (dtype == 1)
    return launch_points<__nv_bfloat16>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch,
                                        blocks, s_total, n_heads, n_levels, n_points, lq,
                                        level_chunks_max, total_chunks, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
