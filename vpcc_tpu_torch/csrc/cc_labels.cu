// Kernel G: connected components of the same-partition k-NN graph (K5).
//
// Replaces the XLA program vpcc_tpu/ops/cc.py `cc_labels_device`
// (cc.py:30-92): label = the minimum active index of each component of the
// undirected graph whose edges are the k-NN pairs (i, nn_idx[i, k]) with
// nn_valid, both endpoints active and equal partitions; inactive points get
// the sentinel.  The label is unique, so this union-find gives the
// reference's scatter-min result exactly.
//
// Union-find with min-id hooking (ECL-CC style), three launches a call:
//   init      parent[i] = i for active i, else the sentinel;
//   hook      one thread per edge slot: filter as cc.py:51-56, then link
//             the larger of the two roots under the smaller with atomicCAS
//             (parent[x] <= x always holds, so every root is the minimum
//             of its tree and the final root is the component minimum);
//   finalize  one thread per point: follow parents to the root.
// The reference runs a data-dependent `while` of scatter-min rounds with
// 10 pointer jumps each; this is a fixed number of launches.
//
// Bound: bytes.  The hook reads the (V, K) edge table once plus random
// 4-byte gathers of partition/active/parent per edge; the atomics contend
// only along component boundaries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int find_root(volatile int32_t* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int gp = parent[p];
    if (gp != p) parent[x] = gp;  // path halving; benign race, keeps p >= gp
    x = p;
    p = gp;
  }
  return x;
}

__global__ void cc_init_kernel(const uint8_t* __restrict__ active, int V,
                               int32_t sentinel, int32_t* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  parent[i] = active[i] ? i : sentinel;
}

__global__ void cc_hook_kernel(const int32_t* __restrict__ nn_idx,
                               const uint8_t* __restrict__ nn_valid,
                               const int32_t* __restrict__ partition,
                               const uint8_t* __restrict__ active, int V, int K,
                               int32_t* parent) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(V) * K) return;
  const int i = static_cast<int>(e / K);
  if (!nn_valid[e] || !active[i]) return;
  const int j = nn_idx[e];
  if (j == i || !active[j] || partition[i] != partition[j]) return;
  volatile int32_t* par = parent;
  int a = find_root(par, i);
  int b = find_root(par, j);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // link root b under the smaller root a; if b stopped being a root, climb
    const int old = atomicCAS(parent + b, b, a);
    if (old == b) break;
    b = find_root(par, old);
    a = find_root(par, a);
  }
}

__global__ void cc_finalize_kernel(const uint8_t* __restrict__ active, int V,
                                   int32_t sentinel, const int32_t* parent,
                                   int32_t* __restrict__ labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  if (!active[i]) {
    labels[i] = sentinel;
    return;
  }
  int x = i;
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  labels[i] = x;
}

}  // namespace

// nn_idx (V, K) int32, nn_valid (V, K) bool, partition (V,) int32, active
// (V,) bool; parent (V,) int32 scratch; labels (V,) int32 out (sentinel for
// inactive points).  Three launches.
extern "C" int cc_labels(const int32_t* nn_idx, const uint8_t* nn_valid,
                         const int32_t* partition, const uint8_t* active, int V,
                         int K, int32_t sentinel, int32_t* parent,
                         int32_t* labels, void* stream) {
  if (V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (V + threads - 1) / threads;
  cc_init_kernel<<<blocks, threads, 0, st>>>(active, V, sentinel, parent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long edges = static_cast<long long>(V) * K;
  if (edges > 0) {
    const int eblocks = static_cast<int>((edges + threads - 1) / threads);
    cc_hook_kernel<<<eblocks, threads, 0, st>>>(nn_idx, nn_valid, partition, active, V,
                                                K, parent);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cc_finalize_kernel<<<blocks, threads, 0, st>>>(active, V, sentinel, parent, labels);
  return static_cast<int>(cudaGetLastError());
}
