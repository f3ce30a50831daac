// Kernel R: the per-point error reductions of both directions of the
// quality metrics (D1, D2, color PSNR, Hausdorff), in one launch.
//
// Replaces the XLA device work of vpcc_tpu/ops/metrics.py `_directional`
// (:57), run twice by `compute_metrics` (:147): for every A row below n,
// with B gathered at its nearest index (kernel E, plus the host KD search
// for the rows it missed):
//   d2                                 -> int64 maximum (Hausdorff)
//   d2 as float32, padded with zeros to the shape bucket -> the float32 sum
//     in XLA's CPU order (:87; ROADMAP F7): windows of xla_windows(cap)[k]
//     consecutive elements, each summed sequentially from 0, level by level
//   proj = (e0 n0 + e1 n1) + e2 n2, e = float(a - b), n = n_b   -> sum proj^2
//   (yuv(a) - yuv(b))^2 per channel, BT.709 in [0, 1]            -> 3 sums
// with yuv: y = ((0.2126 r + 0.7152 g) + 0.0722 b) / 255,
//           u = ((-0.1146 r - 0.3854 g) + 0.5 b) / 255 + 0.5,
//           v = ((0.5 r - 0.4542 g) - 0.0458 b) / 255 + 0.5.
// The reference runs `_directional` op by op, so each float32 operation
// rounds on its own (no fused multiply-adds, true divisions): this file is
// compiled with --fmad=false and spells every operation with its _rn
// intrinsic.  The point-to-plane and color sums are float64 here (float32
// in the reference, which a tolerance covers).
//
// Design.  One launch for both directions: a block a tile of kTile
// level-0 windows of 32 rows (ops/metrics.py R_TILE_WINDOWS), the second
// direction's blocks after the first's.  A thread
// a row, in a fixed strided order, keeps the maximum and the float64 sums;
// the row body has no branch (a row past n is read clamped and adds
// zeros; one specialisation each for normals and colors present or not),
// so that the compiler overlaps one row's dependent loads (its nearest
// index, then B's row) with the next rows'.  The block reduces the sums
// along a fixed tree.  The rows' d2 go through shared memory (a window a
// row, an odd stride: no bank conflicts), so that each window is summed
// sequentially from 0 by one thread, and the block goes on with every
// further level whose windows lie wholly inside its tile (the bench's
// 786,432-row bucket at 64 windows a tile: levels 32 and 32 in the block,
// 2 partials a block).  The last block to finish (a ticket taken after
// __threadfence) reduces the blocks' partials in block order along a fixed
// tree, runs the remaining levels on the blocks' partials (zeros past the
// last block, as the pad rows; staged in shared memory where they fit),
// and writes [maximum d2, D1 sum, point-to-plane, Y, U, V] per direction
// as float64 (the maximum and the float32 sum exactly) into one result
// buffer; it resets the ticket for the next call.  Which block is last
// changes no bit, and no float atomics: repeated runs give the same bits.
//
// Bound: bytes.  Per A row: position (12 B), color (3), nearest index and
// d2 (8), and the gathered B position (12), color (3) and normal (12);
// each cloud's position, color and normals are the A side of one direction
// and the B side of the other.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// level-0 windows a tile (ops/metrics.py R_TILE_WINDOWS): 64 ran fastest
// of 32, 64 and 128 on the bench frame
constexpr int kTile = 64;
constexpr int kMaxLevels = 16;
// the level-0 window: 32 rows at every shape bucket (a multiple of 8,192),
// staged at a stride of 33 floats (no bank conflicts)
constexpr int kW0 = 32;
constexpr int kStride = kW0 + 1;
// the level-0 staging tile (kTile * kStride floats), which the last block
// reuses, twice as long, for the D1 sum's remaining levels
constexpr int kTailFloats = 2 * kTile * kStride;
// plan ints a direction: n, blocks, first block, levels, levels done in a
// block, partials written, 2 unused; widths
// [kMaxLevels]; element counts of levels 0..levels; float offsets of the
// level regions (levels fold..levels)
constexpr int kPlanInts = 8 + kMaxLevels + 2 * (kMaxLevels + 1);

struct Dir {
  const int32_t* pos_a;
  const uint8_t* col_a;   // null: no color sums
  const int32_t* pos_b;
  const uint8_t* col_b;
  const float* nrm_b;     // null: no point-to-plane sum
  const int32_t* idx;
  const int32_t* d2;
  int n, blocks, first_block, levels, fold, written;
  int width[kMaxLevels];
  int count[kMaxLevels + 1];
  int off[kMaxLevels + 1];
};

struct Params {
  Dir dir[2];
  unsigned* ticket;
  long long* part_i;   // (blocks,) maximum d2 a block
  double* part_f;      // (blocks, 4) float64 sums a block
  float* lvl;          // level partials
  double* result;      // (2, 6)
};

struct Sums {
  long long dmax;
  double f[4];  // c2p, y, u, v
};

__device__ __forceinline__ void yuv(const uint8_t* c, float* out) {
  const float r = static_cast<float>(c[0]);
  const float g = static_cast<float>(c[1]);
  const float b = static_cast<float>(c[2]);
  out[0] = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                               __fmul_rn(0.0722f, b)), 255.0f);
  out[1] = __fadd_rn(
      __fdiv_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.1146f, r), __fmul_rn(0.3854f, g)),
                          __fmul_rn(0.5f, b)), 255.0f), 0.5f);
  out[2] = __fadd_rn(
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.4542f, g)),
                          __fmul_rn(0.0458f, b)), 255.0f), 0.5f);
}

// s of every thread reduced along a fixed tree into sh[0]
__device__ void block_reduce(const Sums& s, Sums* sh) {
  const int t = threadIdx.x;
  sh[t] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      Sums& a = sh[t];
      const Sums& b = sh[t + h];
      a.dmax = a.dmax > b.dmax ? a.dmax : b.dmax;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.f[k] += b.f[k];
    }
    __syncthreads();
  }
}

// Row r's terms (row rc read in its place: r clamped to the last row, so
// that every load is valid and the body has no branch; a row at or past n
// adds zeros, which change no float64 sum of non-negative terms).  NRM /
// COL: direction D has normals / colors.
template <bool NRM, bool COL>
__device__ __forceinline__ void add_row(const Dir& D, long long r, Sums& s, float& v) {
  const bool ok = r < D.n;
  const long long rc = ok ? r : D.n - 1;
  const int dd = D.d2[rc];
  const long long j = D.idx[rc];
  v = ok ? static_cast<float>(dd) : 0.0f;
  s.dmax = ok && dd > s.dmax ? dd : s.dmax;
  if (NRM) {
    float p = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float e = static_cast<float>(D.pos_a[3 * rc + a] - D.pos_b[3 * j + a]);
      const float m = __fmul_rn(e, D.nrm_b[3 * j + a]);
      p = a == 0 ? m : __fadd_rn(p, m);
    }
    s.f[0] += ok ? static_cast<double>(__fmul_rn(p, p)) : 0.0;
  }
  if (COL) {
    float ya[3], yb[3];
    yuv(D.col_a + 3 * rc, ya);
    yuv(D.col_b + 3 * j, yb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float e = __fsub_rn(ya[c], yb[c]);
      s.f[1 + c] += ok ? static_cast<double>(__fmul_rn(e, e)) : 0.0;
    }
  }
}

// The rows of a tile (a thread every kThreads-th, in order), each row's
// d2 staged into the tile's window layout.
template <bool NRM, bool COL>
__device__ __forceinline__ void tile_rows(const Dir& D, long long r0, int rows, float* tile,
                                          Sums& s) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    float v;
    add_row<NRM, COL>(D, r0 + i, s, v);
    tile[(i / kW0) * kStride + i % kW0] = v;
  }
}

// The last block's levels of direction D's D1 sum, from the blocks'
// partials of level `fold` (zeros past the `written` ones) to the one
// value, which every thread returns.  Where they fit, the partials are
// staged once into `buf` (every thread's loads in flight) and the levels
// alternate between its front and the space after their input; else each
// level goes through its scratch region.
__device__ float tail_sum(const Params& p, const Dir& D, float* buf) {
  const int m = D.count[D.fold];
  const float* part = p.lvl + D.off[D.fold];
  if (D.fold < D.levels && m + m / 2 <= kTailFloats) {
    for (int i = threadIdx.x; i < m; i += kThreads)
      buf[i] = i < D.written ? __ldcg(part + i) : 0.0f;
    __syncthreads();
    int src = 0, cnt = m;
    for (int k = D.fold; k < D.levels; ++k) {
      const int w = D.width[k], dst = src ? 0 : cnt;
      for (int i = threadIdx.x; i < cnt / w; i += kThreads) {
        float a = 0.0f;
        for (int j = 0; j < w; ++j) a = __fadd_rn(a, buf[src + i * w + j]);
        buf[dst + i] = a;
      }
      __syncthreads();
      src = dst;
      cnt /= w;
    }
    return buf[src];
  }
  for (int k = D.fold; k < D.levels; ++k) {
    const int w = D.width[k];
    const int lim = k == D.fold ? D.written : D.count[k];
    const float* src = p.lvl + D.off[k];
    float* dst = p.lvl + D.off[k + 1];
    for (int i = threadIdx.x; i < D.count[k + 1]; i += kThreads) {
      float a = 0.0f;
      for (int x = i * w; x < i * w + w; ++x)
        a = __fadd_rn(a, x < lim ? __ldcg(src + x) : 0.0f);
      dst[i] = a;
    }
    __syncthreads();
  }
  return __ldcg(p.lvl + D.off[D.levels]);
}

// The last block, direction D: the blocks' partials in block order, the
// remaining XLA levels, the result row `out`.
__device__ void finish_dir(const Params& p, const Dir& D, Sums* red, float* buf,
                           double* out) {
  Sums s = {0, {0.0, 0.0, 0.0, 0.0}};
  for (int b = threadIdx.x; b < D.blocks; b += kThreads) {
    const int g = D.first_block + b;
    const long long dm = __ldcg(p.part_i + g);
    s.dmax = s.dmax > dm ? s.dmax : dm;
#pragma unroll
    for (int k = 0; k < 4; ++k) s.f[k] += __ldcg(p.part_f + 4 * g + k);
  }
  block_reduce(s, red);
  const float d1 = tail_sum(p, D, buf);
  if (threadIdx.x == 0) {
    out[0] = static_cast<double>(red[0].dmax);
    out[1] = static_cast<double>(d1);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[2 + k] = red[0].f[k];
  }
  __syncthreads();
}

// One block's tile of direction D (its lb-th block): the rows' maximum and
// float64 sums, reduced into red[0], and the tile's level partials, both
// written to the scratch.
__device__ __forceinline__ void tile_pass(const Params& p, const Dir& D, int lb, Sums* red,
                                          float* tile, float (*lv)[kTile]) {
  constexpr int rows = kTile * kW0;
  const long long r0 = static_cast<long long>(lb) * rows;
  Sums s = {0, {0.0, 0.0, 0.0, 0.0}};
  if (r0 >= D.n) {   // a tile past the rows (a direction of none): zeros
    for (int i = threadIdx.x; i < rows; i += kThreads) tile[(i / kW0) * kStride + i % kW0] = 0.0f;
  } else if (D.nrm_b != nullptr && D.col_a != nullptr) {
    tile_rows<true, true>(D, r0, rows, tile, s);
  } else if (D.nrm_b != nullptr) {
    tile_rows<true, false>(D, r0, rows, tile, s);
  } else if (D.col_a != nullptr) {
    tile_rows<false, true>(D, r0, rows, tile, s);
  } else {
    tile_rows<false, false>(D, r0, rows, tile, s);
  }
  __syncthreads();
  // level 0: a thread a window, sequentially from 0
  if (threadIdx.x < kTile) {
    const float* x = tile + threadIdx.x * kStride;
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < kW0; ++j) a = __fadd_rn(a, x[j]);
    lv[0][threadIdx.x] = a;
  }
  block_reduce(s, red);   // its barriers also publish lv[0]
  // the further levels whose windows lie inside the tile
  int cnt = kTile, cur = 0;
  for (int k = 1; k < D.fold; ++k) {
    const int w = D.width[k];
    cnt /= w;
    if (threadIdx.x < cnt) {
      float a = 0.0f;
      for (int j = 0; j < w; ++j) a = __fadd_rn(a, lv[cur][threadIdx.x * w + j]);
      lv[cur ^ 1][threadIdx.x] = a;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (threadIdx.x < cnt) p.lvl[D.off[D.fold] + lb * cnt + threadIdx.x] = lv[cur][threadIdx.x];
  if (threadIdx.x == 0) {
    p.part_i[blockIdx.x] = red[0].dmax;
#pragma unroll
    for (int k = 0; k < 4; ++k) p.part_f[4 * blockIdx.x + k] = red[0].f[k];
  }
}

// Each direction is named by a constant index (no copy of the parameters to
// local memory).
__global__ void __launch_bounds__(kThreads) metrics_kernel(const Params p) {
  __shared__ float tile[kTailFloats];
  __shared__ float lv[2][kTile];
  __shared__ Sums red[kThreads];
  __shared__ bool last;
  if (static_cast<int>(blockIdx.x) >= p.dir[1].first_block)
    tile_pass(p, p.dir[1], blockIdx.x - p.dir[1].first_block, red, tile, lv);
  else
    tile_pass(p, p.dir[0], blockIdx.x, red, tile, lv);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_dir(p, p.dir[0], red, tile, p.result);
  finish_dir(p, p.dir[1], red, tile, p.result + 6);
  if (threadIdx.x == 0) *p.ticket = 0;
}

}  // namespace

// ptrs: per direction (two) pos_a, col_a, pos_b, col_b, nrm_b, idx, d2
// (col_a and col_b null: no color sums; nrm_b null: no point-to-plane
// sum); plan: per direction kPlanInts ints (ops/metrics.py
// `metrics_plan`); blocks: both directions' blocks; scratch: the ticket
// (zero between calls), the blocks' partials and the level regions, as
// the plan lays them out; result (2, 6) float64.  One launch.
extern "C" int metrics_reduce(const void* const* ptrs, const int* plan, int blocks,
                              void* scratch, long long part_off, long long lvl_off,
                              void* result, void* stream) {
  if (blocks < 2) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  char* base = static_cast<char*>(scratch);
  p.ticket = reinterpret_cast<unsigned*>(base);
  p.part_i = reinterpret_cast<long long*>(base + part_off);
  p.part_f = reinterpret_cast<double*>(base + part_off + 8LL * blocks);
  p.lvl = reinterpret_cast<float*>(base + lvl_off);
  p.result = static_cast<double*>(result);
  for (int d = 0; d < 2; ++d) {
    const void* const* q = ptrs + 7 * d;
    const int* pl = plan + kPlanInts * d;
    Dir& D = p.dir[d];
    D.pos_a = static_cast<const int32_t*>(q[0]);
    D.col_a = static_cast<const uint8_t*>(q[1]);
    D.pos_b = static_cast<const int32_t*>(q[2]);
    D.col_b = static_cast<const uint8_t*>(q[3]);
    D.nrm_b = static_cast<const float*>(q[4]);
    D.idx = static_cast<const int32_t*>(q[5]);
    D.d2 = static_cast<const int32_t*>(q[6]);
    D.n = pl[0];
    D.blocks = pl[1];
    D.first_block = pl[2];
    D.levels = pl[3];
    D.fold = pl[4];
    D.written = pl[5];
    if (D.levels < 1 || D.levels > kMaxLevels || D.fold < 1 || D.fold > D.levels ||
        D.blocks < 1 || pl[8] != kW0)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < kMaxLevels; ++k) D.width[k] = pl[8 + k];
    for (int k = 0; k <= kMaxLevels; ++k) {
      D.count[k] = pl[8 + kMaxLevels + k];
      D.off[k] = pl[8 + 2 * kMaxLevels + 1 + k];
    }
  }
  metrics_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
