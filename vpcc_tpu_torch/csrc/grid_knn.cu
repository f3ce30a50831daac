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
// One thread per query.  It walks the candidates in exactly the reference's
// order: the 9 xy windows of _OFFSETS9 (dx-major), each a run of up to 3
// contiguous z-cells, and inside a window the first min(e - s, win) slots
// from starts[clo] (the bucket truncation at neighbors.py:136; at 11 bits a
// cell holds 8^3 voxels, so the truncation bites there far more often).
// Candidate position c = window * win + lane.  The thread keeps the k best
// in a list sorted by (d2, c) and inserts only on a strict `<`, so among
// equal d2 the earlier candidate wins, as `lax.top_k(-d2, k)` (and `argmin`
// for k = 1) do.  Slots the reference pads with MAX_DIST2 (missing
// neighbours, queries outside the grid) come out as idx 0, d2 MAX_DIST2.
//
// Bound: bytes on paper (the starts table, the table and the query rows
// are read, idx/d2 written), but the accesses are data-dependent gathers:
// 2 x 9 probes of the starts table and up to 9 x win table words (packed)
// or rows of three words (unpacked) per query, so the kernel is
// latency-bound on those gathers.  The design keeps the k-list in
// registers/local memory (no (M, 9*win) candidate buffer in device memory,
// which the reference materialises) and reads each candidate once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;

template <int KMAX, bool PACKED>
__global__ void grid_knn_kernel(const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ table,
                                const int32_t* __restrict__ order,
                                const int32_t* __restrict__ queries, int M,
                                int grid_bits, int cell_bits, int win, int k,
                                int32_t* __restrict__ out_idx,
                                int32_t* __restrict__ out_d2, long long n_rows,
                                long long n_starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
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
  const int qx = queries[3 * i], qy = queries[3 * i + 1], qz = queries[3 * i + 2];
  const int cx = qx >> cell_bits, cy = qy >> cell_bits, cz = qz >> cell_bits;
  const int zlo = max(cz - 1, 0);
  const int zhi = min(cz + 1, g - 1);
  const bool zok = cz >= 0 && cz < g;

  int bd[KMAX];   // d2 of the kept candidates, ascending
  int bs[KMAX];   // their slots in the sorted table
  for (int j = 0; j < k; ++j) {
    bd[j] = kMaxDist2;
    bs[j] = -1;
  }
  for (int w = 0; w < 9; ++w) {
    const int ncx = cx + (w / 3) - 1;
    const int ncy = cy + (w % 3) - 1;
    const bool ok = zok && ncx >= 0 && ncx < g && ncy >= 0 && ncy < g;
    if (!ok) continue;
    const int base = (ncx * g + ncy) * g;
    const int s = starts[base + zlo];
    const int e = starts[base + zhi + 1];
    const int cnt = min(max(e - s, 0), win);
    for (int l = 0; l < cnt; ++l) {
      int dx, dy, dz;
      if (PACKED) {
        const int pk = table[s + l];
        dx = (pk >> (2 * b)) - qx;
        dy = ((pk >> b) & mask) - qy;
        dz = (pk & mask) - qz;
      } else {
        const int32_t* row = table + 3 * static_cast<long long>(s + l);
        dx = row[0] - qx;
        dy = row[1] - qy;
        dz = row[2] - qz;
      }
      const int d2 = dx * dx + dy * dy + dz * dz;
      if (d2 >= bd[k - 1]) continue;
      int j = k - 1;
      while (j > 0 && bd[j - 1] > d2) {
        bd[j] = bd[j - 1];
        bs[j] = bs[j - 1];
        --j;
      }
      bd[j] = d2;
      bs[j] = s + l;
    }
  }
  for (int j = 0; j < k; ++j) {
    const bool found = bd[j] < kMaxDist2;
    out_idx[static_cast<long long>(i) * k + j] = found ? order[bs[j]] : 0;
    out_d2[static_cast<long long>(i) * k + j] = bd[j];
  }
}

// B frames of M queries each over grids of n_rows points and n_starts
// start offsets (unused when B == 1).
template <bool PACKED>
int launch(const int32_t* starts, const int32_t* table, const int32_t* order,
           const int32_t* queries, int M, int grid_bits, int cell_bits, int win,
           int k, int32_t* out_idx, int32_t* out_d2, void* stream, int B = 1,
           long long n_rows = 0, long long n_starts = 0) {
  if (M == 0 || B == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const dim3 blocks((M + threads - 1) / threads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 16) {
    grid_knn_kernel<16, PACKED><<<blocks, threads, 0, st>>>(
        starts, table, order, queries, M, grid_bits, cell_bits, win, k, out_idx, out_d2,
        n_rows, n_starts);
  } else {
    grid_knn_kernel<64, PACKED><<<blocks, threads, 0, st>>>(
        starts, table, order, queries, M, grid_bits, cell_bits, win, k, out_idx, out_d2,
        n_rows, n_starts);
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
  if (k < 1 || k > 64 || grid_bits > 10) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(starts, table, order, queries, M, grid_bits, cell_bits, win, k,
                      out_idx, out_d2, stream);
}

// As `grid_knn` with table (N, 3) int32 sorted coordinates (unpacked);
// 1 <= k <= 64, grid_bits <= 11.  One launch.
extern "C" int grid_knn_xyz(const int32_t* starts, const int32_t* table,
                            const int32_t* order, const int32_t* queries, int M,
                            int grid_bits, int cell_bits, int win, int k,
                            int32_t* out_idx, int32_t* out_d2, void* stream) {
  if (k < 1 || k > 64 || grid_bits > 11) return static_cast<int>(cudaErrorInvalidValue);
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
  if (k < 1 || k > 64 || grid_bits > 10) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(starts, table, order, queries, M, grid_bits, cell_bits, win, k,
                      out_idx, out_d2, stream, B, N, S);
}
