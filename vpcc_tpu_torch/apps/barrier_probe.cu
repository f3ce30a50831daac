// Empty barriers, timed by apps/profile_entries.py --barriers: the floor of
// a level-synchronous kernel is its levels times one barrier.
//
// * probe_grid: one cooperative launch of `blocks` x `threads` that passes
//   `iters` grid barriers (cooperative_groups grid.sync()) and does nothing
//   else;
// * probe_cluster: one launch of a single cluster of `cluster` CTAs of
//   `threads` that passes `iters` cluster barriers (barrier.cluster arrive +
//   wait, cooperative_groups cluster.sync()); a cluster above 8 CTAs needs
//   the non-portable size, which the function allows;
// * probe_block: one block of `threads` passing `iters` __syncthreads().
// A thread writes one word after its last barrier, so that the loop is kept.
// Time a call with iters = n and iters = 0: the difference over n is one
// barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void grid_kernel(int iters, int* sink) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) *sink = iters;
}

__global__ void cluster_kernel(int iters, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) *sink = iters;
}

__global__ void block_kernel(int iters, int* sink) {
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) *sink = iters;
}

}  // namespace

extern "C" int probe_grid(int blocks, int threads, int iters, int* sink, void* stream) {
  void* args[] = {&iters, &sink};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_kernel),
                                                      dim3(blocks), dim3(threads), args, 0,
                                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int probe_cluster(int cluster, int threads, int iters, int* sink, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(cluster_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_kernel, iters, sink));
}

extern "C" int probe_block(int threads, int iters, int* sink, void* stream) {
  block_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(iters, sink);
  return static_cast<int>(cudaGetLastError());
}

// The largest cluster of `threads`-thread CTAs the card can place (0 where
// it can place none), from cudaOccupancyMaxPotentialClusterSize.
extern "C" int probe_max_cluster(int threads) {
  cudaError_t err = cudaFuncSetAttribute(cluster_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(threads);
  int size = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&size, cluster_kernel, &cfg);
  return err == cudaSuccess ? size : -static_cast<int>(err);
}
