// Kernel S: the colors of the EOM rows of a reconstruction.
//
// Replaces the XLA programs vpcc_tpu/pipeline.py `extract_eom_colors`
// (pipeline.py:279), `count_eom_rows` (:291) and `inject_eom_colors`
// (:296).  The EOM rows are the rows with layer tag 2 (the reconstruction
// holds only valid rows, so the reference's `valid &` is implicit); their
// rank is their index among the tag-2 rows, in row order, which encoder and
// decoder share.  Two operations:
// * extract: the tag-2 rows' (3,) int32 colors, compacted in row order (the
//   aux attribute samples the encoder codes);
// * inject: every tag-2 row takes aux[min(rank, n_aux - 1)] (uint8), the
//   other rows keep their color (the decoded aux samples put back).
//
// Design: a hand-written two-level scan, three launches.
// 1. count_kernel: each block takes a tile of kTile rows and writes how
//    many are tag 2 (warp ballots and popcounts, summed in shared memory).
//    This pass is the count.
// 2. scan_kernel: one block turns the tile counts into exclusive offsets (a
//    loop over chunks of kThreads with a running carry; within a chunk, a
//    warp scan by shuffles and a scan of the warp totals) and writes the
//    total.
// 3. write_kernel: each block ranks its tile's tag-2 rows again, in row
//    order (step k of a tile covers rows k*kThreads .. k*kThreads +
//    kThreads - 1, so ranks follow the rows), adds the tile's offset and
//    extracts or injects.
// Integer only: deterministic.
//
// Bound: bytes.  Extract reads the layer tags twice and the tag-2 rows'
// colors, writes their compacted colors; inject reads the tags twice and
// every color and writes every color (the aux samples are a few KB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// Rank of this thread's flag among the flags of the block's step (row
// order = thread order), and the step's total.
__device__ __forceinline__ int block_rank(bool flag, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    sum += warp_tot[w];
  }
  __syncthreads();  // warp_tot is reused by the next step
  *total = sum;
  return before + lane_rank;
}

__global__ void count_kernel(const int32_t* __restrict__ layer, int n,
                             int32_t* __restrict__ tile_counts) {
  __shared__ int warp_tot[kWarps];
  const int base = blockIdx.x * kTile;
  int count = 0;
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    int step;
    block_rank(i < n && layer[i] == 2, warp_tot, &step);
    count += step;
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = count;
}

// Exclusive scan of the tile counts in place; *total = their sum.
__global__ void scan_kernel(int32_t* __restrict__ tile_counts, int tiles,
                            int32_t* __restrict__ total) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c = 0; c < tiles; c += kThreads) {
    const int i = c + threadIdx.x;
    const int v = i < tiles ? tile_counts[i] : 0;
    int incl = v;  // inclusive warp scan
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      chunk += warp_sum[w];
    }
    if (i < tiles) tile_counts[i] = carry + before + incl - v;
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void write_kernel(const int32_t* __restrict__ layer, const int32_t* __restrict__ col,
                             const uint8_t* __restrict__ aux, int n_aux,
                             const int32_t* __restrict__ tile_offsets, int n,
                             int32_t* __restrict__ out) {
  __shared__ int warp_tot[kWarps];
  const int base = blockIdx.x * kTile;
  int running = tile_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    const bool eom = i < n && layer[i] == 2;
    int step;
    const int r = running + block_rank(eom, warp_tot, &step);
    running += step;
    if (i >= n) continue;
    const int64_t src = 3 * static_cast<int64_t>(i);
    if (aux == nullptr) {  // extract
      if (!eom) continue;
      const int64_t dst = 3 * static_cast<int64_t>(r);
      for (int c = 0; c < 3; ++c) out[dst + c] = col[src + c];
    } else {  // inject
      const int64_t a = 3 * static_cast<int64_t>(r < n_aux - 1 ? r : n_aux - 1);
      for (int c = 0; c < 3; ++c) out[src + c] = eom ? static_cast<int32_t>(aux[a + c]) : col[src + c];
    }
  }
}

}  // namespace

// Pass 1 and 2: tile_counts (tiles = ceil(n / eom_tile_rows())) becomes the
// tiles' exclusive offsets and *total the number of tag-2 rows.  layer (n,)
// int32.  Two launches.
extern "C" int eom_count(const int32_t* layer, int n, int32_t* tile_counts, int32_t* total,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) count_kernel<<<tiles, kThreads, 0, s>>>(layer, n, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kThreads, 0, s>>>(tile_counts, tiles, total);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3 on eom_count's offsets.  col (n, 3) int32.  aux == nullptr:
// extract, out (total, 3) int32.  Else inject of aux (n_aux >= 1, 3) uint8,
// out (n, 3) int32.  One launch.
extern "C" int eom_write(const int32_t* layer, const int32_t* col, const uint8_t* aux, int n_aux,
                         const int32_t* tile_offsets, int n, int32_t* out, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles == 0) return 0;
  if (aux != nullptr && n_aux < 1) return static_cast<int>(cudaErrorInvalidValue);
  write_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      layer, col, aux, n_aux, tile_offsets, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eom_tile_rows() { return kTile; }
