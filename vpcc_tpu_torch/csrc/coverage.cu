// Kernel H: patch coverage against a cropped bit volume (K6).
//
// Replaces the XLA program vpcc_tpu/ops/coverage.py `covered_radius_slab`
// (coverage.py:97-153) with its `_dilate` (:59-83) and `_shift_z` (:45-56):
// is each source point within sqrt(r2_sel) / sqrt(r2_det) of a resampled
// patch point?
//
// One cooperative launch a call, five phases behind grid barriers:
// 1. the box: each block reduces the extent of its resampled points (x
//    relative to the slab origin x0 and clipped to the slab as the
//    reference clips it, y, and z's 32-bit word) into a partial of its own;
// 2. every block reduces all partials to the same box (no atomics, nothing
//    to reset), and the grid zeroes the box's words of the scratch volume
//    V (nw x nx x ny uint32 words, y-minor: a z word's plane) and nothing
//    else;
// 3. one atomicOr per resampled point, one per distinct word of a warp (OR
//    is idempotent, so the reference's sort-and-dedup before its
//    scatter-add is not needed);
// 4. the dilation, as the reference's, over the box padded by r in x and
//    y and by one word in z: a block a tile of kTx x kTy xy columns sweeps
//    the z words, a step of one or two at a time; it widens its source
//    window (the tile padded by r) at those words by each k <= r in z into
//    shared memory (the neighbouring words carry the bits across), and a
//    thread an output column ORs, for each column (dx, dy) of each ball
//    (`_ball_columns`, from the table the wrapper builds), the window's
//    word widened by the column's z half-extent: D_det and D_sel, stored
//    with consecutive threads on consecutive y;
// 5. a thread a query reads its bit of D.
// The queries come in no spatial order, so a query that probed the ball's
// columns itself would read 29 scattered words; the dilation reads V in
// whole runs and the ball from shared memory, and a query reads two
// words.  A column outside the box holds no bit, and a position outside
// the padded box is covered by none: the answer is the reference's bit for
// bit.  Slab semantics kept: a query outside [x0, x0 + sx) is not covered,
// nor a PAD_COORD row; the query's y and z are clipped to [0, G - 1]; no
// wrap at the y or z edges (the reference's shifts pad with zeros); packed
// -1 entries are padding.
//
// Bound: bytes of res_packed, the queries and the two flags (V and D are
// scratch, over the resampled points' box only, not the slab's
// sx x G x G/32 words).

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxR = 7;           // ops/coverage.py MAX_R2 = 63
constexpr int kMaxColumns = 256;   // a ball of r2 <= 63: 197 columns
constexpr int kPart = 8;           // ints of a block's partial box
constexpr int kPad = 0x3FFFFFFF;   // PAD_COORD
constexpr int kTx = 8, kTy = 64;   // a dilation tile's output columns (kTx * kTy = kThreads)
// z words a dilation step widens and ORs: two up to r = 3, one above
// (fewer registers for the larger source window)
__host__ __device__ constexpr int step(int r) { return r <= 3 ? 2 : 1; }

struct Args {
  const int32_t* res_packed;
  const int32_t* queries;
  uint32_t* parts;   // kPart ints a block
  uint32_t* vol;     // V, then D
  uint8_t* sel;
  uint8_t* det;
  int R, N, x0, sx, bits, ndet, nsel;   // each ball's columns, a prefix of the table
  // per ball (0 det, 1 sel) and column, the offset of the column's word,
  // widened by its wz, in a dilation tile's source window (step 4)
  int off[2][kMaxColumns];
};

// a dilation tile's source window: the tile padded by r, its y extent and
// its columns
__host__ __device__ constexpr int window_y(int r) { return kTy + 2 * r; }
__host__ __device__ constexpr int window(int r) { return (kTx + 2 * r) * window_y(r); }

// min over the block of six values (maxima enter negated); the result is
// in sh[0..5] after the call
__device__ void block_min6(int v[6], int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = __reduce_min_sync(0xFFFFFFFFu, v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sh[8 + k * 32 + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int x = lane < kThreads / 32 ? sh[8 + k * 32 + lane] : INT_MAX;
      const int m = __reduce_min_sync(0xFFFFFFFFu, x);
      if (lane == 0) sh[k] = m;
    }
  }
  __syncthreads();
}

// a word's bits widened by k in z (|dz| <= k), with the bits of its
// neighbouring words that cross into it
__device__ __forceinline__ uint32_t widen(uint32_t prev, uint32_t cur, uint32_t next, int k) {
  uint32_t out = cur;
  for (int s = 1; s <= k; ++s)
    out |= (cur << s) | (prev >> (32 - s)) | (cur >> s) | (next << (32 - s));
  return out;
}

// two blocks an SM up to r = 3 (the CTC's balls); one above, where the
// dilation's rolling words need more registers
template <int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 3 ? 2 : 1)
    coverage_kernel(const __grid_constant__ Args a) {
  __shared__ int sh[8 + 6 * 32];
  constexpr int kSy = window_y(RMAX), kSw = window(RMAX);   // the source window
  constexpr int kStep = step(RMAX);
  cg::grid_group grid = cg::this_grid();
  const int G = 1 << a.bits, mask = G - 1, W = G >= 32 ? G / 32 : 1;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;

  // 1. this block's share of the box
  int v[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  for (long long i = gtid; i < a.R; i += gstride) {
    const int pk = a.res_packed[i];
    if (pk < 0) continue;
    const int xs = min(max(((pk >> 20) & mask) - a.x0, 0), a.sx - 1);
    const int y = (pk >> 10) & mask, w = (pk & mask) >> 5;
    v[0] = min(v[0], xs);
    v[1] = min(v[1], -xs);
    v[2] = min(v[2], y);
    v[3] = min(v[3], -y);
    v[4] = min(v[4], w);
    v[5] = min(v[5], -w);
  }
  block_min6(v, sh);
  if (threadIdx.x < 6) a.parts[blockIdx.x * kPart + threadIdx.x] = sh[threadIdx.x];
  grid.sync();

  // 2. the box from all partials (every block alike), and its words zeroed
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = INT_MAX;
  for (int blk = threadIdx.x; blk < gridDim.x; blk += kThreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v[k] = min(v[k], static_cast<int>(__ldcg(a.parts + blk * kPart + k)));
  }
  block_min6(v, sh);
  const bool empty = sh[0] == INT_MAX;
  const int xlo = sh[0], ylo = sh[2], wlo = sh[4];
  const int nx = empty ? 0 : -sh[1] - xlo + 1, ny = empty ? 0 : -sh[3] - ylo + 1;
  const int nw = empty ? 0 : -sh[5] - wlo + 1;
  const long long plane = static_cast<long long>(nx) * ny;
  uint32_t* vol = a.vol;
  for (long long i = gtid; i < plane * nw; i += gstride) vol[i] = 0u;
  grid.sync();

  // 3. the resampled points' bits, one atomic per distinct word of a warp
  for (long long base = blockIdx.x * static_cast<long long>(kThreads); base < a.R;
       base += gstride) {
    const long long i = base + threadIdx.x;
    const int pk = i < a.R ? a.res_packed[i] : -1;
    const int vx = min(max(((pk >> 20) & mask) - a.x0, 0), a.sx - 1) - xlo;
    const long long word = pk < 0 ? -1
        : (((pk & mask) >> 5) - wlo) * plane + static_cast<long long>(vx) * ny
          + ((pk >> 10) & mask) - ylo;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, word);
    const uint32_t bits = __reduce_or_sync(peers, pk < 0 ? 0u : 1u << (pk & 31));
    if (pk >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicOr(vol + word, bits);
  }
  grid.sync();

  // 4. the dilation over the padded box, a tile of kTx x kTy columns at a
  // time a block, swept over z: the tile's source window (the tile padded
  // by RMAX) widened in z by each k <= RMAX into shared memory, then a
  // thread an output column ORs the window's words of each ball's columns
  const int pxlo = max(xlo - RMAX, 0), pylo = max(ylo - RMAX, 0), pwlo = max(wlo - 1, 0);
  const int pnx = empty ? 0 : min(xlo + nx - 1 + RMAX, a.sx - 1) - pxlo + 1;
  const int pny = empty ? 0 : min(ylo + ny - 1 + RMAX, G - 1) - pylo + 1;
  const int pnw = empty ? 0 : min(wlo + nw, W - 1) - pwlo + 1;
  const long long pplane = static_cast<long long>(pnx) * pny;
  uint32_t* dil = vol + plane * nw;   // the det planes, then the sel planes
  const long long dwords = pplane * pnw;
  constexpr int kSrc = (kSw + kThreads - 1) / kThreads;   // window columns a thread
  // [RMAX + 1][kSw][kStep]: the window widened by k, a step's words side by side
  extern __shared__ uint32_t s_z[];
  const int tnx = (pnx + kTx - 1) / kTx, tny = (pny + kTy - 1) / kTy;
  const int tx = threadIdx.x / kTy, ty = threadIdx.x % kTy;
  for (int tile = blockIdx.x; tile < tnx * tny; tile += gridDim.x) {
    const int x0t = pxlo + (tile / tny) * kTx, y0t = pylo + (tile % tny) * kTy;
    // this thread's source columns: box-relative (x, y), or -1 outside the box
    int at[kSrc];
#pragma unroll
    for (int s = 0; s < kSrc; ++s) {
      const int src = threadIdx.x + s * kThreads;
      const int vx = x0t - RMAX + src / kSy - xlo, vy = y0t - RMAX + src % kSy - ylo;
      at[s] = src < kSw && vx >= 0 && vx < nx && vy >= 0 && vy < ny ? vx * ny + vy : -1;
    }
    // this step's words w0 - 1 .. w0 + kStep, and the next step's new
    // words, loaded a step ahead
    uint32_t win[kSrc][kStep + 2], nxt[kSrc][kStep];
    const auto word = [&](int s, int w) {
      const int wi = w - wlo;
      return at[s] >= 0 && wi >= 0 && wi < nw ? vol[wi * plane + at[s]] : 0u;
    };
#pragma unroll
    for (int s = 0; s < kSrc; ++s) {
#pragma unroll
      for (int i = 0; i < kStep + 2; ++i) win[s][i] = word(s, pwlo - 1 + i);
#pragma unroll
      for (int i = 0; i < kStep; ++i) nxt[s][i] = word(s, pwlo + kStep + 1 + i);
    }
    for (int w0 = pwlo; w0 < pwlo + pnw; w0 += kStep) {
      // the window's words w0 .. w0 + kStep - 1 widened by k = 0..RMAX
#pragma unroll
      for (int s = 0; s < kSrc; ++s) {
        const int src = threadIdx.x + s * kThreads;
        if (src >= kSw) break;
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          const uint32_t m = win[s][i], c = win[s][i + 1], n = win[s][i + 2];
          uint32_t z = c;
          s_z[src * kStep + i] = z;
#pragma unroll
          for (int k = 1; k <= RMAX; ++k) {
            z |= (c << k) | (m >> (32 - k)) | (c >> k) | (n << (32 - k));
            s_z[(k * kSw + src) * kStep + i] = z;
          }
        }
      }
      __syncthreads();
      const int x = x0t + tx, y = y0t + ty;
      if (x < pxlo + pnx && y < pylo + pny) {
        uint32_t det[kStep], sel[kStep];
#pragma unroll
        for (int i = 0; i < kStep; ++i) det[i] = sel[i] = 0u;
        const uint32_t* sz = s_z + ((tx + RMAX) * kSy + ty + RMAX) * kStep;
        // a column's words of the step, in one load where they are two
        if constexpr (kStep == 2) {
          for (int j = 0; j < a.ndet; ++j) {
            const uint2 v = *reinterpret_cast<const uint2*>(sz + a.off[0][j]);
            det[0] |= v.x;
            det[1] |= v.y;
          }
          for (int j = 0; j < a.nsel; ++j) {
            const uint2 v = *reinterpret_cast<const uint2*>(sz + a.off[1][j]);
            sel[0] |= v.x;
            sel[1] |= v.y;
          }
        } else {
          for (int j = 0; j < a.ndet; ++j) det[0] |= sz[a.off[0][j]];
          for (int j = 0; j < a.nsel; ++j) sel[0] |= sz[a.off[1][j]];
        }
        const long long o = (w0 - pwlo) * pplane + static_cast<long long>(x - pxlo) * pny + y - pylo;
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          if (w0 + i < pwlo + pnw) {
            dil[o + i * pplane] = det[i];
            dil[dwords + o + i * pplane] = sel[i];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSrc; ++s) {
        win[s][0] = win[s][kStep];
        win[s][1] = win[s][kStep + 1];
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          win[s][i + 2] = nxt[s][i];
          nxt[s][i] = word(s, w0 + 2 * kStep + 1 + i);
        }
      }
    }
  }
  grid.sync();

  // 5. the queries
  for (long long i = gtid; i < a.N; i += gstride) {
    const int qx = a.queries[3 * i];
    const int vx = qx - a.x0 - pxlo;
    bool sel = false, det = false;
    if (!empty && qx != kPad && qx - a.x0 >= 0 && qx - a.x0 < a.sx && vx >= 0 && vx < pnx) {
      const int vy = min(max(a.queries[3 * i + 1], 0), G - 1) - pylo;
      const int qz = min(max(a.queries[3 * i + 2], 0), G - 1);
      const int vw = (qz >> 5) - pwlo;
      if (vy >= 0 && vy < pny && vw >= 0 && vw < pnw) {
        const long long at = vw * pplane + static_cast<long long>(vx) * pny + vy;
        det = (dil[at] >> (qz & 31)) & 1u;
        sel = (dil[dwords + at] >> (qz & 31)) & 1u;
      }
    }
    a.sel[i] = sel;
    a.det[i] = det;
  }
}

// dynamic shared memory of coverage_kernel<RMAX>: its source window at
// kStep z words, each widened by k = 0..RMAX
template <int RMAX>
constexpr int smem() {
  return step(RMAX) * (RMAX + 1) * window(RMAX) * 4;
}

// cols: the table, (dx, dy, wz_det, wz_sel) signed bytes a column
template <int RMAX>
cudaError_t launch(Args& a, const signed char* cols, int ncols, cudaStream_t stream) {
  a.ndet = a.nsel = 0;
  for (int j = 0; j < ncols; ++j) {
    const signed char* c = cols + 4 * j;
    const int at = -c[0] * window_y(RMAX) - c[1];
    if (c[2] >= 0) a.off[0][a.ndet++] = (c[2] * window(RMAX) + at) * step(RMAX);
    if (c[3] >= 0) a.off[1][a.nsel++] = (c[3] * window(RMAX) + at) * step(RMAX);
  }
  static int sms = 0, fit = 0;
  if (!sms) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(coverage_kernel<RMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem<RMAX>());
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, coverage_kernel<RMAX>, kThreads,
                                                          smem<RMAX>());
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const long long need = (static_cast<long long>(a.N > a.R ? a.N : a.R) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < static_cast<long long>(sms) * fit ? need : sms * fit);
  if (blocks < 1 || blocks * kPart > 8192) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(coverage_kernel<RMAX>),
                                     dim3(blocks), dim3(kThreads), args, smem<RMAX>(), stream);
}

}  // namespace

// res_packed (R,) int32 (x<<20 | y<<10 | z, -1 = padding), queries (N, 3)
// int32; cols: `ncols` (dx, dy, wz_det, wz_sel) signed bytes a column in
// host memory, in order of dx^2 + dy^2 (ops/coverage.py `column_table`:
// the larger ball, -1 outside the other); r = floor(sqrt(max(r2_sel,
// r2_det))) <= kMaxR; scratch: kPart ints a block (at most 8192), then at
// least 3 * sx * G * max(G / 32, 1) words (V, then D_det, D_sel); out cov_sel,
// cov_det (N,) bool.  One cooperative launch.
extern "C" int coverage(const int32_t* res_packed, int R, const int32_t* queries, int N,
                        int x0, int sx, int bits, int r, const int32_t* cols, int ncols,
                        uint32_t* scratch, uint8_t* cov_sel, uint8_t* cov_det, void* stream) {
  if (N == 0) return 0;
  if (ncols < 1 || ncols > kMaxColumns || r < 0 || r > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.res_packed = res_packed;
  a.queries = queries;
  a.parts = scratch;
  a.vol = scratch + 8192;
  a.sel = cov_sel;
  a.det = cov_det;
  a.R = R;
  a.N = N;
  a.x0 = x0;
  a.sx = sx;
  a.bits = bits;
  const signed char* c = reinterpret_cast<const signed char*>(cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (r) {
    case 0: err = launch<0>(a, c, ncols, st); break;
    case 1: err = launch<1>(a, c, ncols, st); break;
    case 2: err = launch<2>(a, c, ncols, st); break;
    case 3: err = launch<3>(a, c, ncols, st); break;
    case 4: err = launch<4>(a, c, ncols, st); break;
    case 5: err = launch<5>(a, c, ncols, st); break;
    case 6: err = launch<6>(a, c, ncols, st); break;
    default: err = launch<7>(a, c, ncols, st); break;
  }
  return static_cast<int>(err);
}
