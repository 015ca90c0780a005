// Multi-scale deformable attention forward as separable hat-row products
// with the levels fused on the contraction axis, on the tensor cores;
// channel-major query parameters; Hopper (sm_90a): wgmma fed by TMA.
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
// (cx_all, and V', which the wrapper rounds from a float32 value before the
// launch as the JAX wrapper does); A stays float32 in registers, the ry * aw
// weights are float32, the output is in the caller's type.  A sample whose
// pixel coordinate lies wholly outside the map, or is not finite,
// contributes nothing, as in K1 and the plain gather version (the
// interpreted TPU kernel returns NaN there instead).
//
// Layouts: value (N, S, M, D) bf16, S = sum_l H_l * W_l; x, y, aw
// (N, M, L, P, Lq) float32; out (N, Lq, M * D).  D in {8, 16, 32, 64};
// sum_l W_l up to 160 (the shared-memory plan below).
//
// The structurally zero blocks of blockdiag(V'_l) are skipped at the
// granularity of 16-deep K steps: the columns of level l are multiplied only
// over the K steps that overlap rows [sum_{l'<l} W_l', + W_l) of cx_all; a
// step that straddles two levels multiplies the other level's hat entries by
// zeros (TMA fills the box outside the level with them).  A block of 64 A
// columns (64 / D rows h) is multiplied for a point and warpgroup only if
// ry of some query row of the warpgroup is non-zero on one of its rows h.
//
// What bounds it on an H100.  The function is K1's: at the serving encoder
// call about 65 MB to move, 19.5 us at 3.35 TB/s.  The formulation executes
// 2 * 64 * 64 * 16 tensor-core FLOPs per (n, m, 64 query rows, point, level,
// block of 64 A columns, K step) it multiplies
// (ms_deform_attn_variants.py::fk_mma_flops): 280.4 GFLOP on uniform samples
// at that call (>= 0.28 ms at 989 TFLOP/s), 69.9 GFLOP on clustered ones.
//
// Design.  One block per (n, m) and tile of 128 queries: two consumer
// warpgroups of 64 query rows each and one producer warp, whose code path
// never rejoins the consumers' (the block meets at named barriers).  Points
// go in groups of 2, whose cx_all rows stay in shared memory (2 x 128 x K
// bf16, 32-byte swizzled K-major, one 4 KB region per K step).  For a group
// the consumers zero them, write each row's two x-corner weights per level
// and point, and mark which (point, column block, warpgroup) products have a
// non-zero ry weight.  The loop order is then level -> column block -> point:
//   * the producer warp streams each needed slice V'_l[:, column block] once
//     per group (a 5-D box (d, m, w, h, n) of a per-level tensor map over the
//     value, w from the level's first K step, with the swizzle of a D-wide
//     row) by TMA into a ring of stages with full and empty mbarriers (as
//     many stages, 2 to 8, as leave room for two blocks per SM; 2 at the
//     serving level set); the slice arrives as [h][w][d], per h wgmma's
//     MN-major B layout;
//   * each consumer warpgroup, per point that needs it, runs wgmma m64nDk16
//     over the level's K steps for each of the block's 64 / D rows h into
//     float32 accumulators, then weights each accumulator by its row's ry_l[h]
//     * aw (per level, each warp keeps its 16 rows' y corner and two weights in
//     shared memory) and adds it into output accumulators that stay in
//     registers over points, levels and column blocks.
// Shared memory at K = 160, D = 32: 80 KB cx_all, 2 x 10 KB ring at the
// serving level set, 3 KB of ry tables; two blocks per SM.  Two points per
// group instead of all four: the slices are staged twice, but two blocks fit
// an SM and hide each other's latencies.
//
// Measured on an H100 80GB HBM3 (700 W), bf16, at the serving encoder call:
// 1.30 ms on uniform samples (216 TFLOP/s of executed products), 0.54 ms on
// clustered ones, against 5.88 ms for the mma.sync kernel it replaces and
// 0.14 ms for K1 (ocpg_tpu_torch/scripts/time_kernels.py, chip_smoke.py).
// Built without its products it reads 0.55 ms
// (ocpg_tpu_torch/scripts/bench_msda_dense.py): the products take the rest,
// and ptxas serializes them (C7520, a compiler-inserted warpgroup arrive in
// a divergent path).  Tried and dropped (scratch builds): all four points
// resident (one block per SM, read slower); a deeper ring; straight-line
// wgmma groups per K-step count (spills, slower); warp-uniform skip flags
// and accumulators defined outside the loops (no change to the
// serialization).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (ocpg_tpu_torch/ops/_build.py); the wrapper is
// ocpg_tpu_torch/ops/ms_deform_attn_variants.py::ms_deform_attn_cm_fk.

#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kRows = 128;           // queries per block
constexpr int kWgRows = 64;          // query rows per consumer warpgroup
constexpr int kCols = 64;            // A columns per block of V'
constexpr int kGroup = 2;            // points whose cx_all rows stay resident
constexpr int kMaxStages = 8;        // TMA ring depth: 2 to 8, as shared memory allows
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kBarConsumers = 1;   // named barriers: the consumer warps
constexpr int kBarBlock = 2;       // and the whole block
constexpr int kMaxK = 160;           // sum_l W_l rounded up to 16

struct LevelMaps {
  CUtensorMap map[MSDA_MAX_LEVELS];
};

// Per level: K offset of its cx_all rows, first K step, K steps, column
// blocks and the index of its first column block.
struct FkLevels {
  int koff[MSDA_MAX_LEVELS];
  int ks_lo[MSDA_MAX_LEVELS];
  int ksteps[MSDA_MAX_LEVELS];
  int cblocks[MSDA_MAX_LEVELS];
  int cb_base[MSDA_MAX_LEVELS];
};

// Dynamic shared memory, offsets from a 1024-byte aligned base.
struct FkSmem {
  int cx, ring, stage, ry_y0, ry_w0, ry_w1, need, any, bars, bytes;
  __host__ __device__ FkSmem(int kpad, int kw_max, int cb_total, int stages) {
    cx = 0;
    ring = cx + kGroup * kpad * kRows * 2;
    stage = kw_max * kCols * 2;
    ry_y0 = ring + stages * stage;
    ry_w0 = ry_y0 + kGroup * kRows * 4;
    ry_w1 = ry_w0 + kGroup * kRows * 4;
    need = ry_w1 + kGroup * kRows * 4;              // [point][column block][warpgroup]
    any = need + ((kGroup * cb_total * 2 + 15) & ~15);   // [column block]
    bars = any + ((cb_total + 15) & ~15);
    bytes = bars + 2 * kMaxStages * 8 + 1024;
  }
};

template <typename OutT, int D>
__global__ void __launch_bounds__(kThreads, 2)
msda_fk_kernel(const __grid_constant__ LevelMaps maps, const float* __restrict__ x_cm,
               const float* __restrict__ y_cm, const float* __restrict__ aw_cm,
               OutT* __restrict__ out, Levels levels, FkLevels fk, int n_heads, int n_levels,
               int n_points, int lq, int kpad, int kw_max, int cb_total, int stages) {
  constexpr int HB = kCols / D;    // rows h per column block
  constexpr int kAcc = D / 2;      // float32 accumulators per thread per row h
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FkSmem L(kpad, kw_max, cb_total, stages);
  int* ry_y0 = reinterpret_cast<int*>(smem + L.ry_y0);     // [point][row]
  float* ry_w0 = reinterpret_cast<float*>(smem + L.ry_w0);
  float* ry_w1 = reinterpret_cast<float*>(smem + L.ry_w1);
  unsigned char* need = smem + L.need;
  unsigned char* any = smem + L.any;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;

  const int n_qtiles = (lq + kRows - 1) / kRows;
  const long long nm = blockIdx.x / n_qtiles;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kRows;
  const int m = static_cast<int>(nm % n_heads);
  const int n = static_cast<int>(nm / n_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;         // consumer warpgroup (0, 1); 2 is the producer warp
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = wg * kWgRows + 16 * (warp & 3) + g;   // this thread's two rows r0, r0 + 8

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    fence_mbarrier_init();
  }

  int it = 0;   // slices staged so far (ring position)
  if (warp == kConsumers / 32) {
    // Producer warp: per group of points, once the consumers have written
    // the group's marks, one thread streams the needed slices of V'.
    for (int p0 = 0; p0 < n_points; p0 += kGroup) {
      named_barrier(kBarBlock, kThreads);   // the previous group is done with the marks
      named_barrier(kBarBlock, kThreads);   // this group's marks are written
      if (lane == 0) {
        for (int l = 0; l < n_levels; ++l) {
          const int kw = fk.ksteps[l] * 16;
          for (int cb = 0; cb < fk.cblocks[l]; ++cb) {
            if (!any[fk.cb_base[l] + cb]) continue;
            const int st = it % stages;
            if (it >= stages) mbar_wait(&empty[st], ((it / stages) - 1) & 1);
            mbar_arrive_expect_tx(&full[st], kw * kCols * 2);
            tma_load_5d(smem + L.ring + st * L.stage, &maps.map[l], &full[st], 0, m,
                        fk.ks_lo[l] * 16 - fk.koff[l], cb * HB, n);
            ++it;
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  float o_acc[2][kAcc / 2];
#pragma unroll
  for (int i = 0; i < kAcc / 2; ++i) o_acc[0][i] = o_acc[1][i] = 0.f;
  // stage-1 accumulators, defined here once: in the loops only wgmma writes them
  float acc[HB][kAcc];
#pragma unroll
  for (int j = 0; j < HB; ++j) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[j][e] = 0.f;
  }

  for (int p0 = 0; p0 < n_points; p0 += kGroup) {
    const int pg = min(kGroup, n_points - p0);
    named_barrier(kBarBlock, kThreads);   // the previous group is done with cx_all and the marks
    for (int i = tid; i < kGroup * kpad * kRows * 2 / 16; i += kConsumers)
      reinterpret_cast<uint4*>(smem + L.cx)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kGroup * cb_total * 2; i += kConsumers) need[i] = 0;
    for (int i = tid; i < cb_total; i += kConsumers) any[i] = 0;
    named_barrier(kBarConsumers, kConsumers);
    for (int task = tid; task < kRows * pg * n_levels; task += kConsumers) {
      const int r = task % kRows;
      const int pl = task / kRows;
      const int l = pl % n_levels;
      const int pi = pl / n_levels;
      const int q = q0 + r;
      if (q >= lq) continue;
      const int h = levels.h[l];
      const int w = levels.w[l];
      const long long idx = ((nm * n_levels + l) * n_points + p0 + pi) * lq + q;
      const float xp = __ldg(x_cm + idx) * w - 0.5f;
      const float yp = __ldg(y_cm + idx) * h - 0.5f;
      if (!(xp > -1.f && yp > -1.f && xp < w && yp < h)) continue;   // also NaN / inf
      const float xf = floorf(xp);
      const float dx = xp - xf;
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(floorf(yp));
      unsigned char* cx = smem + L.cx + pi * kpad * kRows * 2;
      const int k = fk.koff[l] + x0;
      if (x0 >= 0)
        *reinterpret_cast<__nv_bfloat16*>(cx + (k >> 4) * (kRows * 32) + sw32_offset(r, k & 15)) =
            __float2bfloat16(1.f - dx);
      if (x0 + 1 <= w - 1)
        *reinterpret_cast<__nv_bfloat16*>(cx + ((k + 1) >> 4) * (kRows * 32) +
                                          sw32_offset(r, (k + 1) & 15)) = __float2bfloat16(dx);
      const int rwg = r / kWgRows;
      if (y0 >= 0) {
        const int cb = fk.cb_base[l] + y0 / HB;
        need[(pi * cb_total + cb) * 2 + rwg] = 1;
        any[cb] = 1;
      }
      if (y0 + 1 <= h - 1) {
        const int cb = fk.cb_base[l] + (y0 + 1) / HB;
        need[(pi * cb_total + cb) * 2 + rwg] = 1;
        any[cb] = 1;
      }
    }
    fence_proxy_async();
    named_barrier(kBarBlock, kThreads);   // cx_all and the marks are written

    for (int l = 0; l < n_levels; ++l) {
      // this warp's 16 rows: y corner and the two ry * aw weights per point
      const int h = levels.h[l];
      const int w = levels.w[l];
      for (int e = lane; e < 16 * pg; e += 32) {
        const int r = wg * kWgRows + 16 * (warp & 3) + (e & 15);
        const int pi = e >> 4;
        const int q = q0 + r;
        int y0 = -2;                 // matches no row
        float w0 = 0.f, w1 = 0.f;
        if (q < lq) {
          const long long idx = ((nm * n_levels + l) * n_points + p0 + pi) * lq + q;
          const float a = __ldg(aw_cm + idx);
          const float xp = __ldg(x_cm + idx) * w - 0.5f;
          const float yp = __ldg(y_cm + idx) * h - 0.5f;
          if (xp > -1.f && yp > -1.f && xp < w && yp < h) {
            const float yf = floorf(yp);
            const float dy = yp - yf;
            y0 = static_cast<int>(yf);
            if (y0 >= 0) w0 = (1.f - dy) * a;
            if (y0 + 1 <= h - 1) w1 = dy * a;
          }
        }
        ry_y0[pi * kRows + r] = y0;
        ry_w0[pi * kRows + r] = w0;
        ry_w1[pi * kRows + r] = w1;
      }
      __syncwarp();

      const int kw = fk.ksteps[l] * 16;
      for (int cb = 0; cb < fk.cblocks[l]; ++cb) {
        if (!any[fk.cb_base[l] + cb]) continue;
        const int st = it % stages;
        mbar_wait(&full[st], (it / stages) & 1);
        const uint32_t b0 = smem_u32(smem + L.ring + st * L.stage);
        for (int pi = 0; pi < pg; ++pi) {
          if (!need[(pi * cb_total + fk.cb_base[l] + cb) * 2 + wg]) continue;
          const uint32_t a0 = smem_u32(smem + L.cx + pi * kpad * kRows * 2) + wg * kWgRows * 32;
#pragma unroll
          for (int j = 0; j < HB; ++j) wgmma_fence_regs(acc[j]);
          wgmma_fence();
          for (int s = 0; s < fk.ksteps[l]; ++s) {
            const uint32_t a = a0 + (fk.ks_lo[l] + s) * (kRows * 32);
#pragma unroll
            for (int j = 0; j < HB; ++j)
              Wgmma<D>::mma(acc[j], wgmma_desc_a_sw32(a),
                            wgmma_desc_b_mn<D>(b0 + (j * kw + s * 16) * D * 2), s > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int j = 0; j < HB; ++j) wgmma_fence_regs(acc[j]);
          const int ya = ry_y0[pi * kRows + r0], yb = ry_y0[pi * kRows + r0 + 8];
          const float wa0 = ry_w0[pi * kRows + r0], wa1 = ry_w1[pi * kRows + r0];
          const float wb0 = ry_w0[pi * kRows + r0 + 8], wb1 = ry_w1[pi * kRows + r0 + 8];
#pragma unroll
          for (int j = 0; j < HB; ++j) {
            const int hrow = cb * HB + j;
            const float wa = (hrow == ya ? wa0 : 0.f) + (hrow == ya + 1 ? wa1 : 0.f);
            const float wb = (hrow == yb ? wb0 : 0.f) + (hrow == yb + 1 ? wb1 : 0.f);
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
              o_acc[0][2 * i] += wa * acc[j][4 * i];
              o_acc[0][2 * i + 1] += wa * acc[j][4 * i + 1];
              o_acc[1][2 * i] += wb * acc[j][4 * i + 2];
              o_acc[1][2 * i + 1] += wb * acc[j][4 * i + 3];
            }
          }
        }
        if (lane == 0) mbar_arrive(&empty[st]);   // every consumer warp frees the stage
        ++it;
      }
      __syncwarp();   // this warp's reads of the level's ry tables are done
    }
  }

  const long long row_stride = static_cast<long long>(n_heads) * D;
  OutT* o = out + static_cast<long long>(n) * lq * row_stride + static_cast<long long>(m) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + r0 + 8 * half;
    if (q >= lq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      store(o + static_cast<long long>(q) * row_stride + 8 * i + 2 * t, o_acc[half][2 * i]);
      store(o + static_cast<long long>(q) * row_stride + 8 * i + 2 * t + 1,
            o_acc[half][2 * i + 1]);
    }
  }
}

template <typename OutT, int D>
int launch(const void* value, const void* x_cm, const void* y_cm, const void* aw_cm, void* out,
           const Levels& levels, int n_batch, long long blocks, int s_total, int n_heads,
           int n_levels, int n_points, int lq, cudaStream_t s) {
  constexpr int HB = kCols / D;
  FkLevels fk;
  LevelMaps maps;
  int koff = 0, cb_total = 0, kw_max = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = levels.h[l], w = levels.w[l];
    fk.koff[l] = koff;
    fk.ks_lo[l] = koff / 16;
    fk.ksteps[l] = (koff + w + 15) / 16 - koff / 16;
    fk.cblocks[l] = (h + HB - 1) / HB;
    fk.cb_base[l] = cb_total;
    cb_total += fk.cblocks[l];
    if (fk.ksteps[l] * 16 > kw_max) kw_max = fk.ksteps[l] * 16;
    // V'_l as (d, m, w, h, n); a box is D x 1 x (the level's K steps) x HB x 1
    const cuuint64_t dims[5] = {D, static_cast<cuuint64_t>(n_heads), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n_batch)};
    const cuuint64_t row = static_cast<cuuint64_t>(n_heads) * D * 2;
    const cuuint64_t strides[4] = {D * 2, row, row * w, row * s_total};
    const cuuint32_t box[5] = {D, 1, static_cast<cuuint32_t>(fk.ksteps[l] * 16), HB, 1};
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(value) +
                                static_cast<long long>(levels.start[l]) * n_heads * D;
    const int err = encode_tensor_map_bf16(&maps.map[l], base, 5, dims, strides, box,
                                           swizzle_for_row(D));
    if (err != 0) return err;
    koff += w;
  }
  const int kpad = (koff + 15) & ~15;
  // as many ring stages as leave room for two blocks per SM (else one block)
  const FkSmem two(kpad, kw_max, cb_total, 2);
  const int smem_max = max_dynamic_smem();
  if (two.bytes > smem_max) return cudaErrorInvalidValue;
  const int two_blocks = smem_per_sm() / 2 - smem_reserved_per_block();
  int stages = 2 + ((two.bytes <= two_blocks ? two_blocks : smem_max) - two.bytes) / two.stage;
  if (stages > kMaxStages) stages = kMaxStages;
  const FkSmem L(kpad, kw_max, cb_total, stages);
  cudaError_t err = cudaFuncSetAttribute(msda_fk_kernel<OutT, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  msda_fk_kernel<OutT, D><<<static_cast<unsigned>(blocks), kThreads, L.bytes, s>>>(
      maps, static_cast<const float*>(x_cm), static_cast<const float*>(y_cm),
      static_cast<const float*>(aw_cm), static_cast<OutT*>(out), levels, fk, n_heads, n_levels,
      n_points, lq, kpad, kw_max, cb_total, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_dim(int dim, const void* value, const void* x_cm, const void* y_cm,
               const void* aw_cm, void* out, const Levels& levels, int n_batch,
               long long blocks, int s_total, int n_heads, int n_levels, int n_points, int lq,
               cudaStream_t s) {
#define MSDA_FK_CASE(D_)                                                                     \
  case D_:                                                                                   \
    return launch<OutT, D_>(value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks, s_total, \
                            n_heads, n_levels, n_points, lq, s);
  switch (dim) {
    MSDA_FK_CASE(8) MSDA_FK_CASE(16) MSDA_FK_CASE(32) MSDA_FK_CASE(64)
    default: return cudaErrorInvalidValue;
  }
#undef MSDA_FK_CASE
}

}  // namespace

extern "C" {

// value is bf16; dtype is the output's: 0 = float32, 1 = bfloat16.  The
// value must start on 16 bytes (TMA).  Returns the cudaError_t of the
// launch (0 on success).
int msda_cm_fk_fwd(const void* value, const void* x_cm, const void* y_cm,
                   const void* aw_cm, void* out, const int* level_h, const int* level_w,
                   int n_batch, int s_total, int n_heads, int dim, int n_levels,
                   int n_points, int lq, int dtype, void* stream) {
  Levels levels;
  if (!make_levels(&levels, level_h, level_w, n_levels, s_total)) return cudaErrorInvalidValue;
  int w_sum = 0;
  for (int l = 0; l < n_levels; ++l) w_sum += level_w[l];
  if (((w_sum + 15) & ~15) > kMaxK || n_points < 1 ||
      reinterpret_cast<uintptr_t>(value) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(n_batch) * n_heads *
                           ((lq + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch, blocks,
                             s_total, n_heads, n_levels, n_points, lq, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(dim, value, x_cm, y_cm, aw_cm, out, levels, n_batch,
                                     blocks, s_total, n_heads, n_levels, n_points, lq, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
