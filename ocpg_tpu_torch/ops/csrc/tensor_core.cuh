// Tensor-core building blocks shared by the port's kernels (the MSDA
// kernels through msda_common.cuh, and window_attention_fwd.cu): bf16
// packing, the m16n8k16 bf16 product of mma.sync, and ldmatrix; and for
// Hopper (sm_90a) the asynchronous pieces of the dense-row (K5) and fused-K
// (K6) kernels: mbarriers, TMA tile loads and the tensor maps they read,
// wgmma shared-memory matrix descriptors, and wgmma itself with its
// fence / commit / wait.

#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Two floats as a bf16 pair in one 32-bit register, lo in the low half: the
// operand format of mma.sync's bf16 fragments.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B on the tensor cores, one warp: A 16x16 bf16 (row-major
// fragment), B 16x8 bf16 (column fragment), D 16x8 float32.  With g = lane / 4
// and t = lane % 4 the fragments hold
//   a[0]: A[g][2t, 2t+1]    a[1]: A[g+8][2t, 2t+1]
//   a[2]: A[g][2t+8, +9]    a[3]: A[g+8][2t+8, +9]
//   b[0]: B[2t, 2t+1][g]    b[1]: B[2t+8, 2t+9][g]
//   d[0], d[1]: D[g][2t, 2t+1]    d[2], d[3]: D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one warp: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned), and
// r[i] receives matrix i's row g, elements 2t and 2t+1.  With .trans each
// matrix arrives transposed: r[i] holds its elements (2t, g) and (2t+1, g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---------------------------------------------------------------- Hopper --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier: init (one thread, then fence_mbarrier_init and a block barrier),
// arrive, arrive that also expects `bytes` of asynchronous copies, and a
// wait for the completion of the phase of the given parity (phase k of a
// barrier has parity k & 1; a fresh barrier counts phase -1, parity 1, as
// complete).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one thread copies a box of a tensor map (a __grid_constant__ kernel
// parameter) to shared memory; the mbarrier counts its bytes.  Coordinates
// are in elements, innermost first; a box that reaches outside the tensor is
// filled with zeros there.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Writes by threads to shared memory, made visible to the asynchronous proxy
// (wgmma's operand reads); then a barrier among the writers and readers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (0 none, 1 128-byte swizzle, 2 64-byte,
// 3 32-byte).  Tiles start on 1024 bytes, so the base offset is 0.
//   A, K-major, 32-byte swizzle: each 16-deep K step is its own region of
//     rows x 32 bytes, element (r, k) at r * 32 + (((k >> 3) ^ ((r >> 2) & 1))
//     << 4) + (k & 7) * 2 (sw32_offset); stride offset 8 rows = 256 bytes,
//     leading offset unused.
//   B, MN-major (the N index contiguous): rows of N = 8, 16, 32 or 64 bf16
//     (16, 32, 64 or 128 bytes) as TMA writes them with no swizzle or the
//     swizzle of the row's width; one swizzle atom spans N, so only the
//     offset between groups of 8 K rows matters, and both offsets carry it.
enum : uint32_t { kSwizzleNone = 0, kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes, uint32_t layout) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ uint32_t sw32_offset(int r, int k) {
  return static_cast<uint32_t>(r * 32 + ((((k >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (k & 7) * 2);
}

// The B descriptor of a K x N bf16 tile stored as K rows of N (MN-major).
template <int N>
__device__ __forceinline__ uint64_t wgmma_desc_b_mn(uint32_t smem_addr) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "B rows of 16 to 128 bytes");
  constexpr uint32_t layout = N == 8 ? kSwizzleNone : N == 16 ? kSwizzle32
                              : N == 32 ? kSwizzle64 : kSwizzle128;
  constexpr uint32_t group = 8 * N * 2;   // bytes of 8 K rows
  return wgmma_desc(smem_addr, group, group, layout);
}

__device__ __forceinline__ uint64_t wgmma_desc_a_sw32(uint32_t smem_addr) {
  return wgmma_desc(smem_addr, 16, 256, kSwizzle32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until every committed wgmma group of the warpgroup is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, registers) = A (64 x 16 bf16, K-major descriptor)
// * B (16 x N bf16, MN-major descriptor) + (accumulate ? D : 0), one
// warpgroup.  Warp w of the group holds rows 16w..16w+15 as mma.sync's D
// fragments do, for each 8 columns j: d[4j], d[4j+1] at row 16w + g,
// columns 8j + 2t, +1; d[4j+2], d[4j+3] at row 16w + g + 8 (g = lane / 4,
// t = lane % 4).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static void mma(float (&d)[4], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<16> {
  __device__ static void mma(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  __device__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// Host: a tiled bf16 tensor map (dims and box innermost first, strides in
// bytes of dims 1..rank-1) through the driver's cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint so the library needs no -lcuda.
// Returns a cudaError_t code.
static inline int encode_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                         const cuuint64_t* dims, const cuuint64_t* strides,
                                         const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                            const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The most dynamic shared memory a block of the current device may take.
static inline int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Shared memory of one SM, and what the runtime keeps of it for each block.
static inline int smem_per_sm() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return bytes;
}

static inline int smem_reserved_per_block() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return bytes;
}

// The TMA swizzle that matches wgmma_desc_b_mn<N> for rows of N bf16.
static inline CUtensorMapSwizzle swizzle_for_row(int n) {
  return n == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE : n == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
         : n == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}
