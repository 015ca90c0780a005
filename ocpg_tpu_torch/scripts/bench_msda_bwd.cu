// Scatter-add rates on Hopper, for the MSDA backward's d_value (K2, K4):
// float32 rows of 32 channels (128 bytes) added at random rows, four threads
// a row (8 channels each, as K2 at bfloat16), three ways:
//   * global:  16-byte vector reductions (atomicAdd on a float4, sm_90) into
//              a scratch in device memory, as K2 adds every corner row;
//   * cluster: scalar atomics into the distributed shared memory of a
//              cluster of 8 CTAs that holds a map's rows interleaved over
//              its ranks (row s at rank s % 8), the design a cluster body of
//              K2 would use;
//   * shared:  the same scalar atomics into the CTA's own shared memory.
// Built by ocpg_tpu_torch/scripts/bench_msda_bwd.py with nvcc into a shared
// library with a plain C interface.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CLUSTER 8
#define ROW_FLOATS 32
#define ROW_STRIDE 33    // shared rows padded over the banks

__device__ __forceinline__ unsigned next_random(unsigned& s) {
  s = s * 1664525u + 1013904223u;
  return s;
}

__global__ void scatter_global(float* rows, int n_rows, int iters, unsigned seed) {
  unsigned st = seed ^ (blockIdx.x * 0x9E3779B9u + threadIdx.x * 7919u);
  const int part = threadIdx.x & 3;
  for (int it = 0; it < iters; ++it) {
    const unsigned r = __shfl_sync(0xffffffffu, next_random(st), threadIdx.x & ~3);
    float* row = rows + static_cast<long long>((r >> 4) % n_rows) * ROW_FLOATS;
    atomicAdd(reinterpret_cast<float4*>(row + 4 * part), make_float4(1.f, 1.f, 1.f, 1.f));
    atomicAdd(reinterpret_cast<float4*>(row + 4 * (4 + part)), make_float4(1.f, 1.f, 1.f, 1.f));
  }
}

template <bool kRemote>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
scatter_cluster(float* out, int n_rows, int iters, unsigned seed) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int local_rows = (n_rows + CLUSTER - 1) / CLUSTER;
  for (int i = threadIdx.x; i < local_rows * ROW_STRIDE; i += blockDim.x) acc[i] = 0.f;
  cluster.sync();
  unsigned st = seed ^ (blockIdx.x * 0x9E3779B9u + threadIdx.x * 7919u);
  const int part = threadIdx.x & 3;
  const unsigned own = cluster.block_rank();
  for (int it = 0; it < iters; ++it) {
    const unsigned r = __shfl_sync(0xffffffffu, next_random(st), threadIdx.x & ~3);
    const int row = (r >> 4) % n_rows;
    float* dst = cluster.map_shared_rank(acc, kRemote ? row % CLUSTER : own) +
                 (row / CLUSTER) * ROW_STRIDE;
#pragma unroll
    for (int i = 0; i < 8; ++i) atomicAdd(dst + 4 * i + part, 1.f);
  }
  cluster.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc[0];
}

static size_t cluster_smem(int n_rows) {
  return sizeof(float) * ((n_rows + CLUSTER - 1) / CLUSTER) * ROW_STRIDE;
}

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int scatter_global_run(float* rows, int n_rows, int blocks, int threads, int iters,
                       void* stream) {
  scatter_global<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(rows, n_rows,
                                                                             iters, 12345u);
  return static_cast<int>(cudaGetLastError());
}

int scatter_cluster_run(float* out, int n_rows, int clusters, int threads, int iters,
                        int remote, void* stream) {
  const size_t smem = cluster_smem(n_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (remote) {
    err = cudaFuncSetAttribute(scatter_cluster<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    scatter_cluster<true><<<clusters * CLUSTER, threads, smem, s>>>(out, n_rows, iters, 777u);
  } else {
    err = cudaFuncSetAttribute(scatter_cluster<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    scatter_cluster<false><<<clusters * CLUSTER, threads, smem, s>>>(out, n_rows, iters, 777u);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of CLUSTER CTAs of `threads` threads, each holding its
// share of n_rows rows, the card runs at once.
int scatter_cluster_max_active(int n_rows, int threads, int* n_clusters) {
  const size_t smem = cluster_smem(n_rows);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_cluster<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n_clusters, scatter_cluster<true>, &cfg));
}

}  // extern "C"
