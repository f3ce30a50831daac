// Kernel J: per-CU motion search (integer full search + half-pel refinement).
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_motion_search_half`
// (hevc.py:471) with `_motion_search` (hevc.py:315), `_sad_sub` (hevc.py:441)
// and `_apply_motion_half_sub` (hevc.py:454), run on every motion-coded
// geometry plane.
//
// Design: one block per (tile plane, CU).  The block stages the CU's source
// samples and the (bs + 2R)^2 reference window (edge-replicated at the tile
// border, as the reference pads each tile) in shared memory; one thread per
// integer candidate (289 for R = 8) sums its SAD over the CU (integer,
// exact), and its cost is fma(lam, bins(dy) + bins(dx), sad).  Thread 0
// takes the first minimum in row-major candidate order (the reference's
// per-row argmin with a strict < across rows).  The plus-shaped half-pel
// refinement then scores the integer vector and its four half-pel
// neighbours on the even-pixel lattice: each thread takes one lattice pixel,
// computes the candidates' samples with the 8-tap HEVC half-pel filter as
// kernel B does (H, V, and V of the clipped H samples), and the SADs are
// reduced in shared memory; candidates are taken in the reference's order
// with a strict <.
//
// Bound: operations.  289 candidates x bs^2 absolute differences per CU;
// the staged window keeps the reads in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;              // search range (MV_RANGE)
constexpr int NW = 2 * R + 1;     // candidates per axis
constexpr int NC = NW * NW;       // integer candidates
constexpr int kThreads = 320;
constexpr int kMaxBs = 32;
constexpr int kWin = kMaxBs + 2 * R;

__constant__ int kTaps[8] = {-1, 4, -11, 40, 40, -11, 4, -1};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ int hfilt(const int32_t* r, int W, int y, int x, int mx) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += kTaps[k] * r[y * W + clampi(x + k - 3, 0, W - 1)];
  return clampi((acc + 32) >> 6, 0, mx);
}

// reference sample at (y, x) + half-pel vector (mvy, mvx), clamped to the tile
__device__ int half_sample(const int32_t* r, int H, int W, int y, int x, int mvy,
                           int mvx, int mx) {
  const int fy = mvy & 1, fx = mvx & 1;
  const int cy = clampi(y + (mvy >> 1), 0, H - 1);
  const int cx = clampi(x + (mvx >> 1), 0, W - 1);
  if (!fy && !fx) return r[cy * W + cx];
  if (!fy) return hfilt(r, W, cy, cx, mx);
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int yy = clampi(cy + k - 3, 0, H - 1);
    acc += kTaps[k] * (fx ? hfilt(r, W, yy, cx, mx) : r[yy * W + cx]);
  }
  return clampi((acc + 32) >> 6, 0, mx);
}

__global__ void __launch_bounds__(kThreads)
motion_search_kernel(const int32_t* src, const int32_t* ref, const float* lam,
                     const int32_t* maxv, const float* bits, int32_t* mv_out,
                     float* cost_out, int H, int W, int bs) {
  __shared__ int s_src[kMaxBs * kMaxBs];
  __shared__ int s_win[kWin * kWin];
  __shared__ float s_cost[NC];
  __shared__ int s_sad[5];
  __shared__ int s_best;
  const int p = blockIdx.y;
  const int nbx = W / bs;
  const int by = blockIdx.x / nbx, bx = blockIdx.x % nbx;
  const int y0 = by * bs, x0 = bx * bs;
  const size_t plane = static_cast<size_t>(p) * H * W;
  const int32_t* s = src + plane;
  const int32_t* r = ref + plane;
  const int t = threadIdx.x;
  const int win = bs + 2 * R;
  for (int i = t; i < bs * bs; i += kThreads)
    s_src[i] = s[(y0 + i / bs) * W + x0 + i % bs];
  for (int i = t; i < win * win; i += kThreads) {
    const int yy = clampi(y0 - R + i / win, 0, H - 1);
    const int xx = clampi(x0 - R + i % win, 0, W - 1);
    s_win[i] = r[yy * W + xx];
  }
  if (t < 5) s_sad[t] = 0;
  __syncthreads();
  const float l = lam[p];
  if (t < NC) {
    const int iy = t / NW, ix = t % NW;
    int sad = 0;
    for (int y = 0; y < bs; ++y) {
      const int* a = s_src + y * bs;
      const int* b = s_win + (y + iy) * win + ix;
      for (int x = 0; x < bs; ++x) sad += abs(a[x] - b[x]);
    }
    s_cost[t] = __fmaf_rn(l, __fadd_rn(bits[iy], bits[ix]), static_cast<float>(sad));
  }
  __syncthreads();
  if (t == 0) {
    int bi = 0;
    for (int c = 1; c < NC; ++c)
      if (s_cost[c] < s_cost[bi]) bi = c;
    s_best = bi;
  }
  __syncthreads();
  const int bi = s_best;
  const int mvy_i = bi / NW - R, mvx_i = bi % NW - R;
  // half-pel refinement on the even-pixel lattice: candidate 0 is the
  // integer vector, 1..4 its plus-shaped half-pel neighbours
  const int cdy[5] = {0, -1, 1, 0, 0};
  const int cdx[5] = {0, 0, 0, -1, 1};
  const int h = bs / 2;
  const int mx = maxv[p];
  int part[5] = {0, 0, 0, 0, 0};
  for (int i = t; i < h * h; i += kThreads) {
    const int yy = y0 + 2 * (i / h), xx = x0 + 2 * (i % h);
    const int sv = s_src[(yy - y0) * bs + (xx - x0)];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int pv = half_sample(r, H, W, yy, xx, 2 * mvy_i + cdy[c],
                                 2 * mvx_i + cdx[c], mx);
      part[c] += abs(sv - pv);
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c)
    if (part[c]) atomicAdd(&s_sad[c], part[c]);
  __syncthreads();
  if (t != 0) return;
  float best = static_cast<float>(s_sad[0]);
  int bmy = 2 * mvy_i, bmx = 2 * mvx_i;
  const float half_bit = __fmul_rn(l, 0.5f);
  for (int c = 1; c < 5; ++c) {
    const float sad = __fadd_rn(static_cast<float>(s_sad[c]), half_bit);
    if (sad < best) {
      best = sad;
      bmy = 2 * mvy_i + cdy[c];
      bmx = 2 * mvx_i + cdx[c];
    }
  }
  float cost = __fmul_rn(l, __fadd_rn(bits[bi / NW], bits[bi % NW]));
  const float frac = ((bmy & 1) || (bmx & 1)) ? __fmul_rn(l, 2.0f) : 0.0f;
  cost = __fadd_rn(cost, frac);
  const size_t cu = static_cast<size_t>(p) * gridDim.x + blockIdx.x;
  mv_out[cu * 2] = bmy;
  mv_out[cu * 2 + 1] = bmx;
  cost_out[cu] = cost;
}

}  // namespace

// src/ref: (P, H, W) int32 tile planes; lam (P,) float32; maxv (P,) int32;
// bits (2R+1,) float32 MV bins per component value; mv_out (P, nb, 2) int32
// half-pel (dy, dx); cost_out (P, nb) float32 MV rate.  bs is 16 or 32.
extern "C" int motion_search(const int32_t* src, const int32_t* ref,
                             const float* lam, const int32_t* maxv,
                             const float* bits, int32_t* mv_out, float* cost_out,
                             int P, int H, int W, int bs, void* stream) {
  if (bs > kMaxBs || bs % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || H == 0 || W == 0) return 0;
  dim3 grid((H / bs) * (W / bs), P);
  motion_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, ref, lam, maxv, bits, mv_out, cost_out, H, W, bs);
  return static_cast<int>(cudaGetLastError());
}
