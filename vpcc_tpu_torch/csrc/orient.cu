// Kernel X: normal orientation toward a viewpoint and by the spanning-tree
// flood (K10, normalOrientation 2 and 4).
//
// Replaces the XLA programs vpcc_tpu/ops/normals.py
// `orient_normals_viewpoint` (:146) and `orient_normals_spanning_tree`
// (:158).  Entry points:
//   orient_viewpoint  a thread a voxel: the sign of dot(n, viewpoint -
//                     position), +1 at 0, times n (one launch);
//   flood             the flood in three launches.  The reference's sweep t
//                     gives every unsigned valid row whose vote
//                     sum_k dot(n[nn[k]], n) * sign[nn[k]] (valid k, in order
//                     from 0) exceeds 1e-6 in magnitude the vote's sign; a
//                     row's vote changes only in the sweep after one of its
//                     neighbours is signed, so only those rows are looked at.
//     1. flood_prep, one cooperative launch, phases behind grid barriers:
//        the reverse adjacency ("rows whose list holds j", over the valid
//        edges of valid rows) as a CSR by a counting sort (degrees by
//        atomics, an exclusive scan of them, a scatter); the seed, the first
//        row of the largest int32 key z * 2^22 + y * 2^11 + x (wrapping, as
//        the reference computes it without 64-bit integers; 0 for invalid
//        rows; a warp max, then one 64-bit atomicMax a warp), none where
//        `pad_rows` and the key is negative (the reference's padded rows
//        win), signed +1 or -1 by its normal's z; the radial centroid (exact
//        int64 sums, rounded once to float32, over the float32 count, as
//        kernel F's orientation launch forms it); the seed's reverse list
//        queued for sweep 1;
//     2. flood_levels, one cluster of kCluster CTAs on neighbouring SMs,
//        persistent: sweep t takes its list (list i of a sweep to CTA i %
//        kCluster), a thread a row still unsigned, and votes as the
//        reference does, every term in order from k = 0, a neighbour's sign
//        read as 0 where its stamp is t or later.  st[i] = (sweep << 1) |
//        negative is each row's stamp (INT_MAX unsigned), so a sweep runs in
//        place; for K = 16 a row's lists are read as 16-byte words and all
//        its neighbours' stamps and normals, and its reverse list's first
//        kChunk rows, in one round trip.  A row signed lists the rows of its
//        reverse list that are neither signed nor listed yet for t + 1, each
//        once a sweep: atomicMax of the row's "queued" stamp to t + 1 (INT_MAX
//        once signed) tells both, its kChunk atomics in flight at once.  (A
//        bitmap of the two in the cluster's distributed shared memory was
//        slower: 5.2 against 3.5 us a sweep for this step.)  A row whose vote
//        cancels stays unset and is listed again only when another neighbour
//        is signed, which is exactly when its vote can change.  A cluster barrier ends the
//        sweep; a sweep that signs nothing, an empty list or the cap (256)
//        ends the walk, read on the device;
//     3. flood_finish, a thread a row: rows still unsigned take the radial
//        sign about the centroid; times n.
//   The sweeps that signed a row land in the scratch's header.
//
// Float32 in the reference's operation order: the 3-term dot products are
// XLA's fma(a2, b2, fma(a1, b1, a0 * b0)) and the vote sums over k in order
// from 0, both found with crafted inputs against the reference
// (tests/test_torch_orientation.py).  This file is compiled with
// --fmad=false, so only the explicit __fmaf_rn calls fuse.
//
// Bound: operations (the votes the sweeps compute, K dot products each) or
// bytes (the neighbour table, normals and positions read once, the oriented
// normals written once).  The floor of the flood is its chain of sweeps,
// each a cluster barrier (0.48 us for 16 CTAs of 256 threads on an H100)
// behind a few dependent memory round trips.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnset = INT_MAX;
constexpr int kPrepThreads = 512;
constexpr int kMaxPrepBlocks = 2048;
constexpr int kCluster = 16;          // CTAs of the sweep walk (one GPC)
constexpr int kLevelThreads = 256;    // threads a CTA of the sweep walk (up to 255 registers)
constexpr int kChunk = 32;            // reverse-list entries a thread queues at once
// header words of the scratch: [0, 3) rotating list counters, [3, 6)
// rotating "a row was signed" flags, 6 the sweeps that signed, 7 the seed
// (-1: none), [8, 11) the centroid (float bits), [12, 14) the packed seed key
// (uint64), [16, 24) the centroid's int64 sums (x, y, z, count)
constexpr int kHeader = 24;

__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// XLA's a0*b0 + a1*b1 + a2*b2 as a reduce: fma(a2, b2, fma(a1, b1, a0*b0)).
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fma_(a[2], b[2], fma_(a[1], b[1], mul(a[0], b[0])));
}

__global__ void viewpoint_kernel(const float* __restrict__ normals,
                                 const int32_t* __restrict__ pos, int V, float vx,
                                 float vy, float vz, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const long long r = 3 * static_cast<long long>(i);
  const float t[3] = {sub(vx, static_cast<float>(pos[r])),
                      sub(vy, static_cast<float>(pos[r + 1])),
                      sub(vz, static_cast<float>(pos[r + 2]))};
  const float* n = normals + r;
  const float s = dot3(n, t) < 0.f ? -1.f : 1.f;
  for (int c = 0; c < 3; ++c) out[r + c] = mul(n[c], s);
}

// (key biased to unsigned) << 32 | (0xFFFFFFFF - row): the largest packed
// value is the first row of the largest key.
__device__ __forceinline__ unsigned long long pack_key(int32_t key, int i) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

struct Flood {
  const int32_t* pos;
  const float* nrm;
  const int32_t* nn_idx;
  const uint8_t* nn_valid;
  const uint8_t* valid;
  int32_t* hdr;       // kHeader words
  int32_t* btot;      // kMaxPrepBlocks: the degrees' block totals
  int32_t* st;        // V: the rows' stamps
  int32_t* queued;    // V: the sweep a row is listed for (INT_MAX once signed)
  int32_t* off;       // V + 1: the reverse lists' offsets
  int32_t* cursor;    // V: degrees, then the scatter's cursors
  int32_t* list[2];   // V each: sweep t's list is list[t & 1]
  int32_t* rev;       // V * K: the reverse lists
  int V, K, pad_rows, max_sweeps;
};

// sum of v over the block (every thread gets it)
__device__ __forceinline__ long long block_sum(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < kPrepThreads / 32; ++w) t += sh[w];
  __syncthreads();
  return t;
}

// exclusive scan of v over the block; *total receives the block's sum
__device__ __forceinline__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, s, d);
    if (lane >= d) s += t;
  }
  if (lane == 31) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kPrepThreads / 32 ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < kPrepThreads / 32) sh[lane] = w;   // inclusive warp sums
  }
  __syncthreads();
  *total = sh[kPrepThreads / 32 - 1];
  const int before = warp ? sh[warp - 1] : 0;
  __syncthreads();   // read by all before a next scan writes sh
  return before + s - v;
}

__global__ void __launch_bounds__(kPrepThreads) flood_prep(const __grid_constant__ Flood a) {
  __shared__ long long sh_sum[kPrepThreads / 32];
  __shared__ int sh_scan[kPrepThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int V = a.V, K = a.K;
  const long long E = static_cast<long long>(V) * K;
  const int lane = threadIdx.x & 31;
  const long long gtid = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kPrepThreads;
  unsigned long long* best = reinterpret_cast<unsigned long long*>(a.hdr + 12);
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(a.hdr + 16);

  // 0. stamps, queued stamps, degrees and the header zeroed
  for (long long i = gtid; i < V; i += gstride) {
    a.st[i] = kUnset;
    a.queued[i] = 0;
    a.cursor[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x < kHeader) a.hdr[threadIdx.x] = 0;
  grid.sync();

  // 1. the degrees of the reverse lists; the seed key; the centroid's sums
  for (long long e = gtid; e < E; e += gstride)
    if (a.nn_valid[e] && a.valid[e / K]) atomicAdd(a.cursor + a.nn_idx[e], 1);
  const long long rows = (V + gstride - 1) / gstride * gstride;   // whole warps
  for (long long i = gtid; i < rows; i += gstride) {
    unsigned long long v = 0ull;
    long long acc[4] = {0, 0, 0, 0};
    if (i < V) {
      const int32_t* p = a.pos + 3 * i;
      // int32 arithmetic that wraps, as XLA's
      const uint32_t k = static_cast<uint32_t>(p[2]) * (1u << 22) +
                         static_cast<uint32_t>(p[1]) * (1u << 11) + static_cast<uint32_t>(p[0]);
      const bool ok = a.valid[i] != 0;
      v = pack_key(ok ? static_cast<int32_t>(k) : 0, static_cast<int>(i));
      if (ok) {
        acc[0] = p[0];
        acc[1] = p[1];
        acc[2] = p[2];
        acc[3] = 1;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_down_sync(0xFFFFFFFFu, v, o);
      v = w > v ? w : v;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += __shfl_down_sync(0xFFFFFFFFu, acc[c], o);
    }
    if (lane == 0) {
      if (v) atomicMax(best, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (acc[c]) atomicAdd(sums + c, static_cast<unsigned long long>(acc[c]));
    }
  }
  grid.sync();

  // 2. each block's total of its chunk of the degrees
  const int chunk = (V + gridDim.x - 1) / gridDim.x;
  const int lo = min(V, static_cast<int>(blockIdx.x) * chunk), hi = min(V, lo + chunk);
  long long mine = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kPrepThreads) mine += __ldcg(a.cursor + i);
  mine = block_sum(mine, sh_sum);
  if (threadIdx.x == 0) a.btot[blockIdx.x] = static_cast<int>(mine);
  grid.sync();

  // 3. the offsets (an exclusive scan), the cursors at them; the seed and
  // the centroid
  long long before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kPrepThreads)
    before += __ldcg(a.btot + b);
  int base = static_cast<int>(block_sum(before, sh_sum));
  for (int t0 = lo; t0 < hi; t0 += kPrepThreads) {
    const int i = t0 + threadIdx.x;
    const int d = i < hi ? __ldcg(a.cursor + i) : 0;
    int total;
    const int ex = block_scan(d, sh_scan, &total);
    if (i < hi) a.off[i] = a.cursor[i] = base + ex;
    base += total;
  }
  if (hi == V && threadIdx.x == 0) a.off[V] = base;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long b = __ldcg(best);
    const int32_t key = static_cast<int32_t>(static_cast<uint32_t>(b >> 32) ^ 0x80000000u);
    const long long seed = 0xFFFFFFFFll - static_cast<long long>(b & 0xFFFFFFFFull);
    // the reference's padded rows (key 0) win only over all-negative keys
    const bool none = a.pad_rows && key < 0;
    a.hdr[7] = none ? -1 : static_cast<int>(seed);
    if (!none) {
      a.st[seed] = a.nrm[3 * seed + 2] < 0.f ? 1 : 0;
      a.queued[seed] = kUnset;
    }
    const long long s[4] = {static_cast<long long>(__ldcg(sums)),
                            static_cast<long long>(__ldcg(sums + 1)),
                            static_cast<long long>(__ldcg(sums + 2)),
                            static_cast<long long>(__ldcg(sums + 3))};
    const float cnt = __ll2float_rn(max(s[3], 1LL));
    for (int c = 0; c < 3; ++c) a.hdr[8 + c] = __float_as_int(__fdiv_rn(__ll2float_rn(s[c]), cnt));
  }
  grid.sync();

  // 4. the reverse lists
  for (long long e = gtid; e < E; e += gstride) {
    if (!a.nn_valid[e]) continue;
    const int i = static_cast<int>(e / K);
    if (a.valid[i]) a.rev[atomicAdd(a.cursor + a.nn_idx[e], 1)] = i;
  }
  grid.sync();

  // 5. the seed's reverse list, queued for sweep 1
  const int seed = __ldcg(a.hdr + 7);
  if (blockIdx.x == 0 && seed >= 0 && a.max_sweeps >= 1) {
    for (int e = a.off[seed] + threadIdx.x; e < a.off[seed + 1]; e += kPrepThreads) {
      const int r = __ldcg(a.rev + e);
      if (atomicMax(a.queued + r, 1) < 1) a.list[1][atomicAdd(a.hdr + 1, 1)] = r;
    }
  }
}

// The vote of unsigned row r in the sweep whose stamps start at `below`:
// sum over k in order of dot3(n[nn[k]], n[r]) * sign[nn[k]] over its valid
// k, a neighbour stamped at `below` or later reading 0.  KT = 16 loads the
// row's lists as vectors and every neighbour's stamp and normal at once.
template <int KT>
__device__ __forceinline__ float vote_of(const Flood& a, int r, int below, const float nr[3]) {
  const int K = KT ? KT : a.K;
  const long long row = static_cast<long long>(r) * K;
  float vote = 0.f;
  if constexpr (KT == 16) {
    int j[16];
    const int4* ji = reinterpret_cast<const int4*>(a.nn_idx + row);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(ji + q);
      j[4 * q] = v.x;
      j[4 * q + 1] = v.y;
      j[4 * q + 2] = v.z;
      j[4 * q + 3] = v.w;
    }
    const uint4 okw = __ldg(reinterpret_cast<const uint4*>(a.nn_valid + row));
    const uint32_t ok4[4] = {okw.x, okw.y, okw.z, okw.w};
    int sj[16];
    float nj[16][3];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool ok = (ok4[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      const float* n = a.nrm + 3 * static_cast<long long>(j[k]);
      sj[k] = ok ? __ldcg(a.st + j[k]) : kUnset;
      nj[k][0] = ok ? __ldg(n) : 0.f;
      nj[k][1] = ok ? __ldg(n + 1) : 0.f;
      nj[k][2] = ok ? __ldg(n + 2) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (!((ok4[k >> 2] >> (8 * (k & 3))) & 0xFFu)) continue;   // a masked term adds a zero
      const float s = sj[k] < below ? ((sj[k] & 1) ? -1.f : 1.f) : 0.f;
      vote = add(vote, mul(dot3(nj[k], nr), s));
    }
  } else {
    for (int k = 0; k < K; ++k) {
      if (!__ldg(a.nn_valid + row + k)) continue;   // a masked term adds a zero
      const int j = __ldg(a.nn_idx + row + k);
      const int sj = __ldcg(a.st + j);
      const float s = sj < below ? ((sj & 1) ? -1.f : 1.f) : 0.f;
      vote = add(vote, mul(dot3(a.nrm + 3 * static_cast<long long>(j), nr), s));
    }
  }
  return vote;
}

// The sweep walk (one cluster).
template <int KT>
__global__ void __launch_bounds__(kLevelThreads, 1) flood_levels(const __grid_constant__ Flood a) {
  cg::cluster_group cluster = cg::this_cluster();
  // item i of a list goes to CTA i % gridDim.x: a short list still spreads
  // over every SM of the walk
  const int vid = threadIdx.x * gridDim.x + blockIdx.x;
  const int stride = gridDim.x * kLevelThreads;
  const int lane = threadIdx.x & 31;
  int sweeps = 0;
  for (int t = 1; t <= a.max_sweeps; ++t) {
    // this thread's first item read with the count (whatever lies there
    // when the list is shorter is not used)
    const int first = vid < a.V ? __ldcg(a.list[t & 1] + vid) : 0;
    const int n = __ldcg(a.hdr + t % 3);
    if (n == 0) break;
    if (vid == 0) {   // each read last in sweep t - 1 (counter) or t - 2 (flag)
      a.hdr[(t + 2) % 3] = 0;
      a.hdr[3 + (t + 1) % 3] = 0;
    }
    const int32_t* cur = a.list[t & 1];
    int32_t* nxt = a.list[(t + 1) & 1];
    const int below = t << 1;   // stamps below this are signed before sweep t
    const bool queue = t < a.max_sweeps;
    for (int i0 = 0; i0 < n; i0 += stride) {   // the same trips for every lane
      const int i = i0 + vid;
      int beg = 0, end = 0;   // the reverse list of a row this thread signs
      int q[kChunk];          // its first kChunk entries, read with the vote's loads
      if (i < n) {
        const int r = i0 == 0 ? first : __ldcg(cur + i);
        const int sr = __ldcg(a.st + r);
        const float* b = a.nrm + 3 * static_cast<long long>(r);
        const float nr[3] = {__ldg(b), __ldg(b + 1), __ldg(b + 2)};
        const int b0 = __ldg(a.off + r), b1 = __ldg(a.off + r + 1);
        if (sr == kUnset) {
          if (queue) {
#pragma unroll
            for (int u = 0; u < kChunk; ++u) q[u] = b0 + u < b1 ? __ldg(a.rev + b0 + u) : -1;
          }
          const float vote = vote_of<KT>(a, r, below, nr);
          if (fabsf(vote) > 1e-6f) {
            a.st[r] = below | (vote < 0.f ? 1 : 0);
            a.queued[r] = kUnset;
            a.hdr[3 + t % 3] = 1;
            if (queue) {
              beg = b0;
              end = b1;
            }
          }
        }
      }
      // the signed rows' reverse lists, kChunk entries a trip: a row still
      // unsigned and not yet listed for t + 1 is listed (atomicMax on its
      // queued stamp: below t + 1 means neither)
      const int trips = __reduce_max_sync(0xFFFFFFFFu, (end - beg + kChunk - 1) / kChunk);
      for (int c = 0; c < trips; ++c) {
        unsigned take = 0;
        if (c > 0) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int e = beg + c * kChunk + u;
            q[u] = e < end ? __ldg(a.rev + e) : -1;
          }
        } else if (end == beg) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) q[u] = -1;
        }
        // every atomic in flight before the first result is read
        int old[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          old[u] = q[u] >= 0 ? atomicMax(a.queued + q[u], t + 1) : kUnset;
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (old[u] < t + 1) take |= 1u << u;
        const int m = __popc(take);
        int incl = m;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
          if (lane >= off) incl += v;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
        if (total == 0) continue;
        int at = 0;
        if (lane == 31) at = atomicAdd(a.hdr + (t + 1) % 3, total);
        at = __shfl_sync(0xFFFFFFFFu, at, 31) + incl - m;
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if ((take >> u) & 1u) nxt[at++] = q[u];
      }
    }
    cluster.sync();
    if (__ldcg(a.hdr + 3 + t % 3) == 0) break;
    sweeps = t;
  }
  if (vid == 0) a.hdr[6] = sweeps;
}

__global__ void flood_finish(const __grid_constant__ Flood a, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.V) return;
  const long long r = 3 * static_cast<long long>(i);
  const float* n = a.nrm + r;
  const int st = a.st[i];
  float s;
  if (st == kUnset) {   // never reached: the radial sign
    const float o[3] = {sub(static_cast<float>(a.pos[r]), __int_as_float(a.hdr[8])),
                        sub(static_cast<float>(a.pos[r + 1]), __int_as_float(a.hdr[9])),
                        sub(static_cast<float>(a.pos[r + 2]), __int_as_float(a.hdr[10]))};
    s = dot3(n, o) < 0.f ? -1.f : 1.f;
  } else {
    s = (st & 1) ? -1.f : 1.f;
  }
  for (int c = 0; c < 3; ++c) out[r + c] = mul(n[c], s);
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

// The sweep walk `kernel` (one argument, *arg) as one cluster of kCluster
// CTAs; an error where the card cannot place it.
cudaError_t launch_walk(const void* kernel, void* arg, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  void* args[] = {arg};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kLevelThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

}  // namespace

// normals (V, 3) float32, pos (V, 3) int32 -> out (V, 3).  One launch.
extern "C" int orient_viewpoint(const float* normals, const int32_t* pos, int V, float vx,
                                float vy, float vz, float* out, void* stream) {
  if (V == 0) return 0;
  viewpoint_kernel<<<blocks_for(V, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      normals, pos, V, vx, vy, vz, out);
  return static_cast<int>(cudaGetLastError());
}

// The words of scratch the flood needs for V rows of K neighbours.
extern "C" long long flood_scratch_words(int V, int K) {
  return kHeader + kMaxPrepBlocks + 6LL * V + 1 + static_cast<long long>(V) * K;
}

// pos (V, 3) int32, normals (V, 3) float32, nn_idx (V, K) int32, nn_valid
// (V, K) and valid (V,) uint8; scratch: flood_scratch_words(V, K) int32
// words (no state kept between calls); out (V, 3) float32.  The sweeps that
// signed a row land in scratch[6].  Three launches (`*launched`); the
// prep's grid is cooperative and the sweeps one cluster: where the card
// cannot place either, the error is returned.
extern "C" int flood(const int32_t* pos, const float* normals, const int32_t* nn_idx,
                     const uint8_t* nn_valid, const uint8_t* valid, int V, int K, int pad_rows,
                     int max_sweeps, int32_t* scratch, float* out, void* stream, int* launched) {
  *launched = 0;
  if (V == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int sms = 0, fit = 0;
  if (!sms) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, flood_prep, kPrepThreads, 0);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  Flood a;
  a.pos = pos;
  a.nrm = normals;
  a.nn_idx = nn_idx;
  a.nn_valid = nn_valid;
  a.valid = valid;
  a.hdr = scratch;
  a.btot = scratch + kHeader;
  a.st = a.btot + kMaxPrepBlocks;
  a.queued = a.st + V;
  a.off = a.queued + V;
  a.cursor = a.off + V + 1;
  a.list[0] = a.cursor + V;
  a.list[1] = a.list[0] + V;
  a.rev = a.list[1] + V;
  a.V = V;
  a.K = K;
  a.pad_rows = pad_rows;
  a.max_sweeps = max_sweeps;
  const long long need = (static_cast<long long>(V) * (K > 0 ? K : 1) + kPrepThreads - 1) /
                         kPrepThreads;
  long long blocks = static_cast<long long>(sms) * fit;
  if (blocks > kMaxPrepBlocks) blocks = kMaxPrepBlocks;
  if (need < blocks) blocks = need;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(flood_prep),
                                                dim3(static_cast<unsigned>(blocks)),
                                                dim3(kPrepThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  // the vectorised vote reads a row's 16 slots as 16-byte words
  const bool vec = K == 16 && reinterpret_cast<uintptr_t>(nn_idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(nn_valid) % 16 == 0;
  err = launch_walk(vec ? reinterpret_cast<const void*>(flood_levels<16>)
                        : reinterpret_cast<const void*>(flood_levels<0>), &a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  flood_finish<<<blocks_for(V, 256), 256, 0, st>>>(a, out);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
