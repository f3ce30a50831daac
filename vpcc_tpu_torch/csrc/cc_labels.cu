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
//   hook      a group of 16 lanes a vertex, one lane a slot of its k-NN row
//             (rows wider than 16 in chunks of 16), the groups of one full
//             residency (8 blocks of 256 an SM) striding over the vertices
//             in index order: the group reads active[i] (one request) and
//             moves on at once from an inactive vertex, so the sparse later
//             patch rounds cost one byte a vertex; each lane filters its
//             slot as cc.py:51-56 does and finds the root of its
//             neighbour, lane 0 alone the root of i.  A group minimum
//             (__reduce_min_sync) gives m, the smallest of those roots;
//             every other root r links under m with atomicCAS(parent + r,
//             r, m), and on failure climbs from the value the CAS read and
//             tries again;
//   finalize  one thread a vertex follows the parents to the root, halving
//             the path as it goes.
// Chosen by timing variants on the captured calls of the bench frame and
// of a vox11 frame (H100): the hook's walks only read `parent` (halving
// them was slower: each store evicts the line from L1 for every other walk
// through it), lanes that share a root all try the CAS (deduplicating them
// with __match_any_sync was slower), 16 lanes beat 8 with two slots each
// (two rounds of the group minimum), and seeding the parents with each
// vertex's smallest neighbour (ECL-CC's init), a first pass over one or two
// slots with a compression pass (Afforest), compressing the endpoints to m
// with atomicMin, and taking the vertices from the highest index down were
// all slower; a group launched for every vertex was slower than the
// striding groups, most in the sparse rounds.  The launches stay three:
// init and finalize take ~3.5 us of a call.
// parent[x] <= x always holds (a link puts a root under a smaller root),
// so every root is the minimum of its tree and the final root of a
// component is its minimum active index.
//
// The root walks read `parent` with plain loads (through L1; walking
// through L2 with ld.cg was slower).  A stale value is still an
// ancestor of the vertex or the vertex itself, since a parent only ever
// moves to a vertex higher in the same tree, so a walk stops at a root or
// at a former root of the same tree: two walks that meet prove the two
// vertices joined, and a link to a former root is refused by the CAS
// (which reads L2), whose returned value moves the walk strictly down.
// Finalize runs in its own launch and sees every link; its path halving
// writes only to non-roots and only vertices of the same tree.
// No tensor core: pointer chasing and compare-and-swap have no product to
// give one.
//
// Bound: bytes.  The hook reads the (V, K) edge table of the active
// vertices once (only `active` elsewhere) plus random 4-byte gathers of
// partition/active/parent per edge; the atomics contend only along
// component boundaries.  The walks' dependent loads, not the bytes, set
// the time.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;   // lanes a vertex in the hook
constexpr int kHookThreads = 256;
constexpr int kHookBlocksPerSM = 2048 / kHookThreads;   // one full residency

// the root of x (or a former root of its tree), reading only
__device__ __forceinline__ int find_root(const int32_t* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// the root of x, halving the path (finalize: no link runs beside it)
__device__ __forceinline__ int find_root_halving(int32_t* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int gp = parent[p];
    if (gp != p) parent[x] = gp;  // path halving; benign race, keeps p >= gp
    x = p;
    p = gp;
  }
  return x;
}

// join the trees of a and b: link the larger root under the smaller one;
// a failed CAS read the new parent of b, from which b climbs again
__device__ __forceinline__ void link(int32_t* parent, int a, int b) {
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(parent + b, b, a);
    if (old == b) return;
    b = find_root(parent, old);
    a = find_root(parent, a);
  }
}

__global__ void cc_init_kernel(const uint8_t* __restrict__ active, int V,
                               int32_t sentinel, int32_t* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  parent[i] = active[i] ? i : sentinel;
}

// the hook of vertex i's k-NN row by its group of 16 lanes
__device__ __forceinline__ void hook_vertex(const int32_t* __restrict__ nn_idx,
                                            const uint8_t* __restrict__ nn_valid,
                                            const int32_t* __restrict__ partition,
                                            const uint8_t* __restrict__ active, int i, int K,
                                            int lane, unsigned gmask, int32_t* parent) {
  const int pi = partition[i];
  for (int base = 0; base < K; base += kLanes) {
    const int s = base + lane;
    int j = -1;
    if (s < K) {
      const long long e = static_cast<long long>(i) * K + s;
      if (nn_valid[e]) {
        const int c = nn_idx[e];
        if (c != i && active[c] && partition[c] == pi) j = c;
      }
    }
    if (!__any_sync(gmask, j >= 0)) continue;
    const int r = j >= 0 ? find_root(parent, j) : INT_MAX;
    int ri = lane == 0 ? find_root(parent, i) : 0;
    ri = __shfl_sync(gmask, ri, 0, kLanes);
    const int m = min(ri, __reduce_min_sync(gmask, r));
    if (r != INT_MAX && r != m && r != ri) link(parent, m, r);
    if (lane == 0 && ri != m) link(parent, m, ri);
  }
}

__global__ void __launch_bounds__(kHookThreads)
cc_hook_kernel(const int32_t* __restrict__ nn_idx, const uint8_t* __restrict__ nn_valid,
               const int32_t* __restrict__ partition, const uint8_t* __restrict__ active,
               int V, int K, int32_t* parent) {
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = 0xffffu << (threadIdx.x & 16);
  const int groups = gridDim.x * (kHookThreads / kLanes);
  for (int i = (blockIdx.x * kHookThreads + threadIdx.x) / kLanes; i < V; i += groups) {
    if (!active[i]) continue;   // the whole group moves on
    hook_vertex(nn_idx, nn_valid, partition, active, i, K, lane, gmask, parent);
  }
}

__global__ void cc_finalize_kernel(const uint8_t* __restrict__ active, int V,
                                   int32_t sentinel, int32_t* parent,
                                   int32_t* __restrict__ labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  labels[i] = active[i] ? find_root_halving(parent, i) : sentinel;
}

}  // namespace

// nn_idx (V, K) int32, nn_valid (V, K) bool, partition (V,) int32, active
// (V,) bool; parent (V,) int32 scratch; labels (V,) int32 out (sentinel for
// inactive points).  Three launches (two when K = 0).
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
  if (K > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long lanes = static_cast<long long>(V) * kLanes;
    const long long need = (lanes + kHookThreads - 1) / kHookThreads;
    const int hblocks = static_cast<int>(
        need < static_cast<long long>(sms) * kHookBlocksPerSM ? need : sms * kHookBlocksPerSM);
    cc_hook_kernel<<<hblocks, kHookThreads, 0, st>>>(nn_idx, nn_valid, partition, active, V,
                                                     K, parent);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cc_finalize_kernel<<<blocks, threads, 0, st>>>(active, V, sentinel, parent, labels);
  return static_cast<int>(cudaGetLastError());
}
