// Kernel E: grid k-nearest-neighbour query (K4).
//
// Replaces the query half of the XLA program vpcc_tpu/ops/neighbors.py:
// `_window_candidates` (neighbors.py:117-158) and `_knn_chunk` (:161-175).
// The grid build (stable cell sort, per-cell start offsets, sorted
// coordinates: `_build`, :86-106) stays plain PyTorch in ops/neighbors.py.
//
// Two table layouts, one entry each (the kernel is templated on the
// layout; everything else is shared):
// * `grid_knn`: (N,) int32 words packing x, y, z at `grid_bits` bits each
//   (`_build`'s grid_bits <= 10 branch, :96-103).  The entry refuses
//   grid_bits > 10, where three coordinates no longer fit one word.
// * `grid_knn_xyz`: (N, 3) int32 rows of x, y, z (`_build`'s unpacked
//   branch, :104-105, read at :145-148).  The entry accepts grid_bits up
//   to 11 (2047^2 * 3 < 2^31, so the int32 squared distance cannot
//   overflow; the dense starts table is (2^(grid_bits - cell_bits))^3 + 1).
//
// `grid_knn_batch` queries B packed grids in one launch (the level-batched
// GOF path, reference vpcc_tpu/parallel/gof.py `_knn_fwd_batch` and
// `_nearest_bwd_batch`: a grid build and a k-NN vmapped over the level's
// frames): grid row blockIdx.y is the frame, whose starts, table, order and
// queries sit at frame * (their per-frame size) in (B, ...) arrays, so each
// query reads only its own frame's grid.  Rows padded out of the grid
// (-2^20) sort to the end of their frame, outside every cell window.
//
// The candidates of a query are the reference's: the 9 xy windows of
// _OFFSETS9 (dx-major), each a run of up to 3 contiguous z-cells, and
// inside window w the first cnt_w = min(e - s, win) slots from starts[clo]
// (the bucket truncation at neighbors.py:136; at 11 bits a cell holds 8^3
// voxels, so the truncation bites there far more often).  Candidate
// position c = w * win + l.  The plain version selects the k smallest keys
// d2 * 9win + c (`_knn_chunk_plain`), which are unique, so any exact
// selection of the k smallest (d2, c) in ascending order is bit-identical
// to `lax.top_k(-d2, k)`'s lower-index-first ties (and to `argmin` for
// k = 1).  Slots the reference pads with MAX_DIST2 (missing neighbours,
// queries outside the grid) come out as idx 0, d2 MAX_DIST2.
//
// Design (Hopper).  A group of G lanes serves one query (8 query groups of
// a warp at G = 8 ... one at G = 32), one launch a call:
// * lanes w, w + G, ... probe the starts table for window w (two loads
//   each), and the group keeps each window's start and the prefix sums of
//   cnt_w in shared memory (each sum from independent loads), so the
//   candidates are numbered 0 .. T - 1 without the empty slots of short
//   windows;
// * lane j evaluates candidates j, j + G, ...: neighbouring lanes read
//   neighbouring table slots (coalesced) and each keeps its candidates'
//   keys 1 + d2 * 9win + c in registers (a fixed-size array indexed only by
//   unrolled loops: no local memory);
// * k rounds of a group-wide minimum: each lane takes its smallest key
//   above the last one chosen (one subtract and one unsigned min a key: the
//   keys chosen so far wrap above the others; its scan stops at the lane's
//   last candidate), a butterfly of log2 G shuffles takes the group's, and
//   lane 0 files it in shared memory; the lanes then decode the k keys (d2,
//   window, slot) and write idx and d2 coalesced.
// The rounds cost ~9 k win / G compares a lane (the instruction count
// falls with G, the latency of a query rises), so k <= 16 over windows of
// up to 18 slots (bucket 6: segmentation k=16, recolor k=8, the level path)
// takes G = 8, at most 21 keys a lane; k = 64 (pre-smoothing), the wider
// windows (bucket 8, the metrics' bucket 12, bucket 16) and k up to 64
// take a warp, at most 14 keys a lane (win <= 48).  k = 1 (`nearest`)
// needs no list: one thread a query streams over the windows keeping the
// smallest key and its slot (on the H100 one lane a query beat 2, 4 and 8:
// every lane of a group probes the windows again).  Larger windows, and
// cells so coarse that 1 + d2 * 9win + c might not fit 32 bits (|dx| < 2
// cells an axis: d2 <= 3 (2^(cell_bits+1) - 1)^2), take a warp with 64-bit
// keys that recomputes its candidates each round instead of keeping them
// (no caller of the port does either).
//
// Bound: bytes on paper (the starts entries probed, the table and the
// query rows read once, idx/d2 written), but the accesses are two levels of
// dependent gathers (starts, then table runs) and the selection is k
// rounds of compares and shuffles: latency and instruction issue bound it.
// There is no product to put on a tensor core.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;
constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNearestLanes = 1;  // lanes a query of the k = 1 kernel

template <typename Key>
__device__ __forceinline__ Key sentinel() {
  return static_cast<Key>(~static_cast<Key>(0));
}

template <bool PACKED>
__device__ __forceinline__ int dist2(const int32_t* table, int slot, int b, int mask, int qx,
                                     int qy, int qz) {
  int dx, dy, dz;
  if (PACKED) {
    const int pk = table[slot];
    dx = (pk >> (2 * b)) - qx;
    dy = ((pk >> b) & mask) - qy;
    dz = (pk & mask) - qz;
  } else {
    const int32_t* row = table + 3 * static_cast<long long>(slot);
    dx = row[0] - qx;
    dy = row[1] - qy;
    dz = row[2] - qz;
  }
  return dx * dx + dy * dy + dz * dz;
}

// The key of candidate t (0 <= t < T) of a query: 1 + d2 * nc + c.
// `w` is the window of the previous candidate the lane looked at (t only
// grows), advanced here.
template <bool PACKED, typename Key>
__device__ __forceinline__ Key cand_key(const int32_t* table, const int* wstart,
                                        const int* wpre, int t, int& w, int win, int nc,
                                        int b, int mask, int qx, int qy, int qz) {
  while (t >= wpre[w + 1]) ++w;
  const int l = t - wpre[w];
  const int d2 = dist2<PACKED>(table, wstart[w] + l, b, mask, qx, qy, qz);
  return static_cast<Key>(d2) * static_cast<Key>(nc) + static_cast<Key>(w * win + l + 1);
}

// G lanes a query.  CAP > 0: each lane keeps its up-to-CAP candidates'
// keys in registers (T <= G * CAP, checked on the host); CAP == 0: each
// round recomputes them.
template <int G, int CAP, bool PACKED, typename Key>
__global__ void __launch_bounds__(kThreads)
grid_knn_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ table,
                const int32_t* __restrict__ order, const int32_t* __restrict__ queries,
                int M, int grid_bits, int cell_bits, int win, int k,
                int32_t* __restrict__ out_idx, int32_t* __restrict__ out_d2,
                long long n_rows, long long n_starts) {
  constexpr int NG = kThreads / G;  // query groups a block
  __shared__ int wstart[NG][9];     // window w's first slot
  __shared__ int wcnt[NG][9];       // its candidates
  __shared__ int wpre[NG][10];      // candidates before window w
  __shared__ Key chosen[NG][kMaxK];
  const int grp = threadIdx.x / G;
  const int j = threadIdx.x % G;
  const long long i = static_cast<long long>(blockIdx.x) * NG + grp;
  const bool active = i < M;
  // frame f = blockIdx.y of a batch (0 for the single-grid entries)
  const long long f = blockIdx.y;
  starts += f * n_starts;
  table += f * n_rows * (PACKED ? 1 : 3);
  order += f * n_rows;
  queries += f * 3LL * M;
  out_idx += f * static_cast<long long>(M) * k;
  out_d2 += f * static_cast<long long>(M) * k;
  const int g = 1 << (grid_bits - cell_bits);
  const int b = grid_bits;
  const int mask = (1 << b) - 1;
  int qx = 0, qy = 0, qz = 0, cz = -1;
  if (active) {
    qx = queries[3 * i];
    qy = queries[3 * i + 1];
    qz = queries[3 * i + 2];
    cz = qz >> cell_bits;
  }
  const int cx = qx >> cell_bits, cy = qy >> cell_bits;
  const bool zok = active && cz >= 0 && cz < g;
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g - 1);
  for (int w = j; w < 9; w += G) {
    const int ncx = cx + (w / 3) - 1;
    const int ncy = cy + (w % 3) - 1;
    int s = 0, cnt = 0;
    if (zok && ncx >= 0 && ncx < g && ncy >= 0 && ncy < g) {
      const int base = (ncx * g + ncy) * g;
      s = starts[base + zlo];
      cnt = min(max(starts[base + zhi + 1] - s, 0), win);
    }
    wstart[grp][w] = s;
    wcnt[grp][w] = cnt;
  }
  __syncwarp();
  for (int w = j; w < 10; w += G) {  // prefix sums, each from independent loads
    int pre = 0;
    for (int q = 0; q < w; ++q) pre += wcnt[grp][q];
    wpre[grp][w] = pre;
  }
  __syncwarp();
  const int* ws = wstart[grp];
  const int* wp = wpre[grp];
  const int T = wp[9];
  const int nc = 9 * win;
  const Key none = sentinel<Key>();

  Key kv[CAP > 0 ? CAP : 1];
  if constexpr (CAP > 0) {
    int w = 0;
#pragma unroll
    for (int c = 0; c < CAP; ++c) {
      const int t = j + c * G;
      kv[c] = t < T ? cand_key<PACKED, Key>(table, ws, wp, t, w, win, nc, b, mask, qx, qy, qz)
                    : none;
    }
  }
  // k rounds: the smallest key above the last one chosen (keys are >= 1).
  // In the cached path, min over key - prev - 1 (wrapping): the keys chosen
  // so far wrap above every other, `none` maps to none - prev - 1.
  Key prev = 0;
  for (int r = 0; r < k; ++r) {
    Key m = none;
    if constexpr (CAP > 0) {
      const Key p1 = prev + 1;
      Key dm = none - p1;
#pragma unroll
      for (int c = 0; c < CAP; ++c) {
        if (c * G >= T) break;
        dm = min(dm, static_cast<Key>(kv[c] - p1));
      }
      m = prev == none ? none : dm + p1;  // (once all are chosen, p1 wraps to 0)
    } else {
      int w = 0;
      for (int t = j; t < T; t += G) {
        const Key key =
            cand_key<PACKED, Key>(table, ws, wp, t, w, win, nc, b, mask, qx, qy, qz);
        if (key > prev && key < m) m = key;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const Key v = __shfl_xor_sync(kFull, m, o, G);
      m = v < m ? v : m;
    }
    if (j == 0) chosen[grp][r] = m;
    prev = m;
  }
  __syncwarp();
  if (!active) return;
  for (int r = j; r < k; r += G) {
    const Key m = chosen[grp][r];
    int idx = 0, d2 = kMaxDist2;
    if (m != none) {
      const Key v = m - 1;
      d2 = static_cast<int>(v / static_cast<Key>(nc));
      const int c = static_cast<int>(v - static_cast<Key>(d2) * static_cast<Key>(nc));
      const int w = c / win;
      idx = order[ws[w] + c - w * win];
    }
    out_idx[i * k + r] = idx;
    out_d2[i * k + r] = d2;
  }
}

// k = 1: G lanes a query (kNearestLanes) stream over each window's slots
// l = j, j + G, ... keeping the smallest key and its slot (no list, no
// shared memory), then a butterfly of log2 G shuffles; 32-bit keys.
template <int G, bool PACKED>
__global__ void __launch_bounds__(kThreads)
grid_nearest_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ table,
                    const int32_t* __restrict__ order, const int32_t* __restrict__ queries,
                    int M, int grid_bits, int cell_bits, int win,
                    int32_t* __restrict__ out_idx, int32_t* __restrict__ out_d2,
                    long long n_rows, long long n_starts) {
  constexpr int NG = kThreads / G;
  const int j = threadIdx.x % G;
  const long long i = static_cast<long long>(blockIdx.x) * NG + threadIdx.x / G;
  const bool active = i < M;
  const long long f = blockIdx.y;
  starts += f * n_starts;
  table += f * n_rows * (PACKED ? 1 : 3);
  order += f * n_rows;
  queries += f * 3LL * M;
  out_idx += f * static_cast<long long>(M);
  out_d2 += f * static_cast<long long>(M);
  const int g = 1 << (grid_bits - cell_bits);
  const int b = grid_bits;
  const int mask = (1 << b) - 1;
  int qx = 0, qy = 0, qz = 0, cz = -1;
  if (active) {
    qx = queries[3 * i];
    qy = queries[3 * i + 1];
    qz = queries[3 * i + 2];
    cz = qz >> cell_bits;
  }
  const int cx = qx >> cell_bits, cy = qy >> cell_bits;
  const bool zok = active && cz >= 0 && cz < g;
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g - 1);
  const unsigned nc = 9u * win;
  unsigned best = sentinel<unsigned>();
  int bslot = 0;
  for (int w = 0; w < 9; ++w) {
    const int ncx = cx + (w / 3) - 1;
    const int ncy = cy + (w % 3) - 1;
    if (!(zok && ncx >= 0 && ncx < g && ncy >= 0 && ncy < g)) continue;
    const int base = (ncx * g + ncy) * g;
    const int s = starts[base + zlo];
    const int cnt = min(max(starts[base + zhi + 1] - s, 0), win);
    for (int l = j; l < cnt; l += G) {
      const unsigned key = static_cast<unsigned>(dist2<PACKED>(table, s + l, b, mask, qx, qy,
                                                               qz)) * nc + (w * win + l + 1);
      if (key < best) {
        best = key;
        bslot = s + l;
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const unsigned v = __shfl_xor_sync(kFull, best, o, G);
    const int vs = __shfl_xor_sync(kFull, bslot, o, G);
    if (v < best) {
      best = v;
      bslot = vs;
    }
  }
  if (active && j == 0) {
    const bool found = best != sentinel<unsigned>();
    out_idx[i] = found ? order[bslot] : 0;
    out_d2[i] = found ? static_cast<int>((best - 1) / nc) : kMaxDist2;
  }
}

template <int G, int CAP, bool PACKED, typename Key>
void launch_one(dim3 blocks, cudaStream_t st, const int32_t* starts, const int32_t* table,
                const int32_t* order, const int32_t* queries, int M, int grid_bits,
                int cell_bits, int win, int k, int32_t* out_idx, int32_t* out_d2,
                long long n_rows, long long n_starts) {
  grid_knn_kernel<G, CAP, PACKED, Key><<<blocks, kThreads, 0, st>>>(
      starts, table, order, queries, M, grid_bits, cell_bits, win, k, out_idx, out_d2, n_rows,
      n_starts);
}

// B frames of M queries each over grids of n_rows points and n_starts
// start offsets (unused when B == 1).
template <bool PACKED>
int launch(const int32_t* starts, const int32_t* table, const int32_t* order,
           const int32_t* queries, int M, int grid_bits, int cell_bits, int win, int k,
           int32_t* out_idx, int32_t* out_d2, void* stream, int B = 1,
           long long n_rows = 0, long long n_starts = 0) {
  if (M == 0 || B == 0) return 0;
  if (B > 65535 || win < 1 || cell_bits < 0 || cell_bits > grid_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the largest key 1 + d2 * 9win + c over candidates within one cell an
  // axis of the query's cell (|dx| <= 2^(cell_bits+1) - 1)
  const unsigned long long span = (2ULL << cell_bits) - 1;
  const unsigned long long nc = 9ULL * static_cast<unsigned long long>(win);
  const bool key32 = (3 * span * span + 1) * nc < 0xFFFFFFFFULL;
  if (key32 && k == 1) {
    constexpr int G = kNearestLanes;
    const dim3 blocks((M + kThreads / G - 1) / (kThreads / G), B);
    grid_nearest_kernel<G, PACKED><<<blocks, kThreads, 0, st>>>(
        starts, table, order, queries, M, grid_bits, cell_bits, win, out_idx, out_d2, n_rows,
        n_starts);
  } else if (key32 && k <= 16 && win <= 18) {
    constexpr int G = 8, CAP = 21;  // ceil(9 * 18 / 8)
    const dim3 blocks((M + kThreads / G - 1) / (kThreads / G), B);
    launch_one<G, CAP, PACKED, unsigned>(blocks, st, starts, table, order, queries, M,
                                         grid_bits, cell_bits, win, k, out_idx, out_d2,
                                         n_rows, n_starts);
  } else if (key32 && win <= 48) {
    constexpr int G = 32, CAP = 14;  // ceil(9 * 48 / 32)
    const dim3 blocks((M + kThreads / G - 1) / (kThreads / G), B);
    launch_one<G, CAP, PACKED, unsigned>(blocks, st, starts, table, order, queries, M,
                                         grid_bits, cell_bits, win, k, out_idx, out_d2,
                                         n_rows, n_starts);
  } else {
    constexpr int G = 32;
    const dim3 blocks((M + kThreads / G - 1) / (kThreads / G), B);
    launch_one<G, 0, PACKED, unsigned long long>(blocks, st, starts, table, order, queries,
                                                 M, grid_bits, cell_bits, win, k, out_idx,
                                                 out_d2, n_rows, n_starts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// starts (g^3 + 1,) int32, table (N,) int32 packed sorted coordinates,
// order (N,) int32, queries (M, 3) int32; out idx, d2 (M, k) int32.
// 1 <= k <= 64, grid_bits <= 10.  One launch.
extern "C" int grid_knn(const int32_t* starts, const int32_t* table,
                        const int32_t* order, const int32_t* queries, int M,
                        int grid_bits, int cell_bits, int win, int k,
                        int32_t* out_idx, int32_t* out_d2, void* stream) {
  if (k < 1 || k > kMaxK || grid_bits > 10) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(starts, table, order, queries, M, grid_bits, cell_bits, win, k,
                      out_idx, out_d2, stream);
}

// As `grid_knn` with table (N, 3) int32 sorted coordinates (unpacked);
// 1 <= k <= 64, grid_bits <= 11.  One launch.
extern "C" int grid_knn_xyz(const int32_t* starts, const int32_t* table,
                            const int32_t* order, const int32_t* queries, int M,
                            int grid_bits, int cell_bits, int win, int k,
                            int32_t* out_idx, int32_t* out_d2, void* stream) {
  if (k < 1 || k > kMaxK || grid_bits > 11) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(starts, table, order, queries, M, grid_bits, cell_bits, win, k,
                       out_idx, out_d2, stream);
}

// B packed grids in one launch: starts (B, S), table and order (B, N),
// queries (B, M, 3), out idx, d2 (B, M, k); frame b's order holds indices
// within the frame.  1 <= k <= 64, grid_bits <= 10.
extern "C" int grid_knn_batch(const int32_t* starts, const int32_t* table,
                              const int32_t* order, const int32_t* queries, int B, int M,
                              int N, int S, int grid_bits, int cell_bits, int win, int k,
                              int32_t* out_idx, int32_t* out_d2, void* stream) {
  if (k < 1 || k > kMaxK || grid_bits > 10) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(starts, table, order, queries, M, grid_bits, cell_bits, win, k,
                      out_idx, out_d2, stream, B, N, S);
}
