// Kernel J: per-CU motion search (integer full search + half-pel refinement).
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_motion_search_half`
// (hevc.py:471) with `_motion_search` (hevc.py:315), `_sad_sub` (hevc.py:441)
// and `_apply_motion_half_sub` (hevc.py:454), run on every motion-coded
// plane.
//
// Bound: operations.  289 integer candidates x bs^2 absolute differences per
// CU; everything else (the staging, the argmin, the half-pel refinement's
// 5 x (bs/2)^2 filtered samples) is a few per cent on top.
//
// Design: one block of 9 warps per (tile plane, CU), four blocks an SM, so
// that one block's latency-bound phases (staging, argmin, refinement)
// overlap the others' searches.
// * Staging.  The block stages the CU's source samples and the reference
//   window [y0 - 12, y0 + bs + 12) x [x0 - 12, x0 + bs + 12) in shared
//   memory as floats, each coordinate clamped to the tile (the reference
//   edge-pads each tile).  The margin of 12 is the search range (8) plus the
//   half-pel filter's reach (4), so the refinement reads shared memory too.
//   Row strides are 4 x an odd number of floats, so that the 16-byte loads
//   of 8 lanes on 8 rows hit distinct banks.
// * Integer SAD, register-tiled.  Warp w scores candidate rows w and w + 9; lane
//   y scores source row y (bs = 32: all 32 columns; bs = 16: rows y & 15,
//   columns 8 * (y >> 4) .. +8).  A lane streams its source row and the
//   window row y + iy through registers, four columns at a time (a rolling
//   window of 20 floats), so that each source and window sample loaded from
//   shared memory feeds all 17 candidates ix of the row.  The absolute
//   differences are summed as float32: the samples are integers below 2^16
//   and a lane sums at most 32 x 17 of them per candidate, all below 2^24,
//   so every partial sum is exact.  The lanes' partial SADs of one candidate
//   are integers and are reduced in any order (__reduce_add_sync).
// * Argmin.  Lane ix of the warp of row iy holds the cost fma(lam,
//   bits[iy] + bits[ix], sad), as the reference computes it.  The reference's per-row
//   first argmin followed by a strict < across rows is the minimum of the
//   pair (cost, iy * 17 + ix) in lexicographic order; costs are finite, so
//   that minimum does not depend on the order of the reduction: warp
//   shuffles per row, then one warp over the 17 row minima.
// * Half-pel refinement.  The integer vector and its four plus-shaped
//   half-pel neighbours are scored on the even-pixel lattice (bs/2)^2.  A
//   neighbour is half-pel along one axis only, so each sample is one 8-tap
//   HEVC filter (kernel B's taps, rounding and clip) over the staged window,
//   in integer-valued float32 (exact below 2^24: no conversions).
//   Both clamps of the reference's per-tile half planes are kept: the
//   lattice position plus mv >> 1 is clamped to the tile first, then each
//   tap.  The five SADs are integers (warp reductions, then one warp over
//   the warps' sums, in any order); lane 0 takes the candidates in the
//   reference's order with a strict <, and writes the vector and its rate.
//
// The source and window stay resident in shared memory (18 KB at bs = 32).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;              // search range (MV_RANGE)
constexpr int NW = 2 * R + 1;     // candidates per axis
constexpr int kWarps = 9;         // a warp per candidate row iy and iy + 9
constexpr int kThreads = 32 * kWarps;
constexpr int kHalo = R + 4;      // search range + the half-pel filter's reach
constexpr unsigned kFull = 0xffffffffu;

__constant__ float kTapsF[8] = {-1.f, 4.f, -11.f, 40.f, 40.f, -11.f, 4.f, -1.f};  // kernel B's

template <int BS>
struct Geo {
  static constexpr int WIN = BS + 2 * kHalo;   // staged window side
  static constexpr int WST = WIN + 4;          // window row stride (floats)
  static constexpr int SST = BS + 4;           // source row stride (floats)
  static constexpr int XC = BS == 32 ? 32 : 8; // columns a lane scores
  static constexpr int HH = (BS / 2) * (BS / 2);
  static_assert(WST % 8 == 4 && SST % 8 == 4, "strides of 4 x an odd number");
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the half-pel refinement's candidates: 0 the integer vector, 1..4 its
// plus-shaped neighbours (-y, +y, -x, +x), in the reference's order
__device__ __forceinline__ int cand_dy(int c) { return c == 1 ? -1 : (c == 2 ? 1 : 0); }
__device__ __forceinline__ int cand_dx(int c) { return c == 3 ? -1 : (c == 4 ? 1 : 0); }

// the lexicographic minimum of (cost, index) pairs over a warp
__device__ __forceinline__ void argmin_warp(float& c, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(kFull, c, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (oc < c || (oc == c && oi < i)) {
      c = oc;
      i = oi;
    }
  }
}

template <int BS>
__global__ void __launch_bounds__(kThreads, 4)
motion_search_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ ref,
                     const float* __restrict__ lam, const int32_t* __restrict__ maxv,
                     const float* __restrict__ bits, int32_t* __restrict__ mv_out,
                     float* __restrict__ cost_out, int H, int W) {
  using G = Geo<BS>;
  __shared__ __align__(16) float s_src[BS * G::SST];
  __shared__ __align__(16) float s_win[G::WIN * G::WST];
  __shared__ float s_wcost[NW];
  __shared__ int s_widx[NW];
  __shared__ unsigned s_hsad[kWarps][5];
  __shared__ int s_best;
  const int p = blockIdx.y;
  const int nbx = W / BS;
  const int y0 = (blockIdx.x / nbx) * BS, x0 = (blockIdx.x % nbx) * BS;
  const size_t plane = static_cast<size_t>(p) * H * W;
  const int32_t* s = src + plane;
  const int32_t* r = ref + plane;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int oy = y0 - kHalo, ox = x0 - kHalo;   // the window's tile origin

  {
    // every load of the staging in flight before the first store
    constexpr int NS = (BS * BS + kThreads - 1) / kThreads;
    constexpr int NWN = (G::WIN * G::WIN + kThreads - 1) / kThreads;
    int vs[NS], vw[NWN];
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      const int i = t + u * kThreads;
      vs[u] = i < BS * BS ? s[(y0 + i / BS) * W + x0 + i % BS] : 0;
    }
#pragma unroll
    for (int u = 0; u < NWN; ++u) {
      const int i = t + u * kThreads;
      const int yy = clampi(oy + i / G::WIN, 0, H - 1);
      const int xx = clampi(ox + i % G::WIN, 0, W - 1);
      vw[u] = i < G::WIN * G::WIN ? r[yy * W + xx] : 0;
    }
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      const int i = t + u * kThreads;
      if (i < BS * BS) s_src[(i / BS) * G::SST + i % BS] = static_cast<float>(vs[u]);
    }
#pragma unroll
    for (int u = 0; u < NWN; ++u) {
      const int i = t + u * kThreads;
      if (i < G::WIN * G::WIN) s_win[(i / G::WIN) * G::WST + i % G::WIN] = static_cast<float>(vw[u]);
    }
  }
  __syncthreads();
  const float l = lam[p];

  // integer SAD: warp = candidate rows iy and iy + 9, lane = (source row,
  // column slice); each row's minimum to s_wcost / s_widx
  for (int iy = warp; iy < NW; iy += kWarps) {
    const int y = BS == 32 ? lane : (lane & 15);
    const int xs = BS == 32 ? 0 : (lane >> 4) * 8;
    const float4* sp = reinterpret_cast<const float4*>(s_src + y * G::SST + xs);
    const float4* wp = reinterpret_cast<const float4*>(
        s_win + (y + iy + kHalo - R) * G::WST + kHalo - R + xs);
    float acc[NW];
#pragma unroll
    for (int ix = 0; ix < NW; ++ix) acc[ix] = 0.f;
    float4 w0 = wp[0], w1 = wp[1], w2 = wp[2], w3 = wp[3];
#pragma unroll 2   // (fully unrolled, the 32-px loop spills)
    for (int c = 0; c < G::XC / 4; ++c) {
      const float4 w4 = wp[c + 4];
      const float4 sv4 = sp[c];
      const float w[20] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w,
                           w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, w3.z, w3.w,
                           w4.x, w4.y, w4.z, w4.w};
      const float sv[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int ix = 0; ix < NW; ++ix) acc[ix] = __fadd_rn(acc[ix], fabsf(__fsub_rn(sv[q], w[q + ix])));
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = w4;
    }
    unsigned sad = 0;
#pragma unroll
    for (int ix = 0; ix < NW; ++ix) {
      const unsigned v = __reduce_add_sync(kFull, static_cast<unsigned>(acc[ix]));
      if (lane == ix) sad = v;
    }
    float cost = INFINITY;
    int idx = INT_MAX;
    if (lane < NW) {
      cost = __fmaf_rn(l, __fadd_rn(bits[iy], bits[lane]), __uint2float_rn(sad));
      idx = iy * NW + lane;
    }
    argmin_warp(cost, idx);
    if (lane == 0) {
      s_wcost[iy] = cost;
      s_widx[iy] = idx;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float bc = lane < NW ? s_wcost[lane] : INFINITY;
    int bidx = lane < NW ? s_widx[lane] : INT_MAX;
    argmin_warp(bc, bidx);
    if (lane == 0) s_best = bidx;
  }
  __syncthreads();
  const int bi = s_best;
  const int mvy_i = bi / NW - R, mvx_i = bi % NW - R;

  // half-pel refinement on the even-pixel lattice: candidate 0 is the
  // integer vector, 1..4 its plus-shaped half-pel neighbours
  const int h = BS / 2;
  const float mx = static_cast<float>(maxv[p]);
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int it = t; it < 5 * G::HH; it += kThreads) {
    const int c = it / G::HH, i = it % G::HH;
    const int ly = 2 * (i / h), lx = 2 * (i % h);
    const int mvy = 2 * mvy_i + cand_dy(c), mvx = 2 * mvx_i + cand_dx(c);
    // the lattice position plus the integer part, clamped to the tile
    const int cy = clampi(y0 + ly + (mvy >> 1), 0, H - 1);
    const int cx = clampi(x0 + lx + (mvx >> 1), 0, W - 1);
    float pv;
    if ((mvy | mvx) & 1) {
      // one 8-tap filter down the column (vertical half-pel) or along the
      // row, each tap clamped to the tile; integer-valued floats below
      // 2^24, so every product and sum is exact, and floor((acc + 32) / 64)
      // is the reference's (acc + 32) >> 6
      const bool vert = mvy & 1;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int a = vert ? (clampi(cy + k - 3, 0, H - 1) - oy) * G::WST + cx - ox
                           : (cy - oy) * G::WST + clampi(cx + k - 3, 0, W - 1) - ox;
        acc = __fmaf_rn(kTapsF[k], s_win[a], acc);
      }
      pv = fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(acc, 32.f), 0.015625f)), 0.f), mx);
    } else {
      pv = s_win[(cy - oy) * G::WST + cx - ox];
    }
    const float d = fabsf(__fsub_rn(s_src[ly * G::SST + lx], pv));
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (c == k) part[k] = __fadd_rn(part[k], d);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const unsigned v = __reduce_add_sync(kFull, static_cast<unsigned>(part[k]));
    if (lane == 0) s_hsad[warp][k] = v;
  }
  __syncthreads();
  if (warp != 0) return;
  unsigned sad5[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    sad5[k] = __reduce_add_sync(kFull, lane < kWarps ? s_hsad[lane][k] : 0u);
  if (lane != 0) return;
  float best = static_cast<float>(sad5[0]);
  int bmy = 2 * mvy_i, bmx = 2 * mvx_i;
  const float half_bit = __fmul_rn(l, 0.5f);
  for (int c = 1; c < 5; ++c) {
    const float sad = __fadd_rn(static_cast<float>(sad5[c]), half_bit);
    if (sad < best) {
      best = sad;
      bmy = 2 * mvy_i + cand_dy(c);
      bmx = 2 * mvx_i + cand_dx(c);
    }
  }
  float rate = __fmul_rn(l, __fadd_rn(bits[bi / NW], bits[bi % NW]));
  const float frac = ((bmy & 1) || (bmx & 1)) ? __fmul_rn(l, 2.0f) : 0.0f;
  rate = __fadd_rn(rate, frac);
  const size_t cu = static_cast<size_t>(p) * gridDim.x + blockIdx.x;
  mv_out[cu * 2] = bmy;
  mv_out[cu * 2 + 1] = bmx;
  cost_out[cu] = rate;
}

}  // namespace

// src/ref: (P, H, W) int32 tile planes, samples in [0, 2^16); lam (P,)
// float32; maxv (P,) int32; bits (2R+1,) float32 MV bins per component
// value; mv_out (P, nb, 2) int32 half-pel (dy, dx); cost_out (P, nb) float32
// MV rate.  bs is 16 or 32.  One launch.
extern "C" int motion_search(const int32_t* src, const int32_t* ref,
                             const float* lam, const int32_t* maxv,
                             const float* bits, int32_t* mv_out, float* cost_out,
                             int P, int H, int W, int bs, void* stream) {
  if (bs != 16 && bs != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((H / bs) * (W / bs), P);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs == 32)
    motion_search_kernel<32><<<grid, kThreads, 0, st>>>(src, ref, lam, maxv, bits, mv_out,
                                                        cost_out, H, W);
  else
    motion_search_kernel<16><<<grid, kThreads, 0, st>>>(src, ref, lam, maxv, bits, mv_out,
                                                        cost_out, H, W);
  return static_cast<int>(cudaGetLastError());
}
