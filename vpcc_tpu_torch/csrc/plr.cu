// Kernel V: PLR (point local reconstruction), the code plane and the RDO.
//
// Replaces the XLA programs vpcc_tpu/ops/plr.py `interp_deltas` (plr.py:61),
// `mode_planes` (:102) and `rdo` (:119-206).
//
// plr_code, one thread per pixel: the masked maxima of the depth deltas in
// [1, 4] over the 3x3 and then the 5x5 window of the edge-clamped decoded
// D0, each minus one and clamped at 0; the pixel's mode from the block mode
// map (clamped into the table); dmag = max(interpolate ? (neighbor == 2 ?
// d2 : d1) : 0, minD1) and the fill flag; the code's bit j - 1 is set where
// dmag == j or (fill and dmag > j), j = 1..3.  Kernel C's EOM entry reads
// the code as three EOM bits: the layer at D0 + j, tag 2.
//
// plr_rdo, the RDO in two launches and no host wait (the caller reads one
// packed result):
// 1. rdo_blocks_kernel, a thread block per occupancy block, a thread a
//    pixel: the block's (res + 4)^2 window of decoded D0 staged in shared
//    memory for the deltas; every occupied pixel's forward error per mode
//    (each true depth to its nearest generated lane, at most 2^20 where a
//    lane is not generated, as the reference's; D1 only where it differs
//    from D0), backward error (each generated lane to its nearest
//    true depth), generated count, and its source count, summed exactly by
//    warp reductions (__reduce_add_sync on 16-bit parts) and across warps
//    in shared memory: integers, so any order.  The reference sums these
//    integers in float32, which equals the exact sum while it stays below
//    2^24; blocks reaching 2^24 are flagged and counted in the result.  The
//    block's mode is the first minimum of max(fwd / src, bwd / gen) (IEEE
//    divisions);
// 2. rdo_patches_kernel, a thread block per patch index (0 = no patch:
//    its blocks get mode 0): a scan of the block map 4,096 blocks at a
//    time (4 consecutive a thread, warp shuffles and the warps' counts in
//    shared memory) lists the step's blocks of the patch in raster order
//    (each writes its own mode); its pools are summed in float32 along the
//    lists (XLA's scatter-add order, never a tree), a thread a (mode,
//    quantity) column over values staged in shared memory; then the
//    patch's mode, its level flag (at most block_threshold blocks) and,
//    with the flag, its mode written to its blocks.  Shared memory does not
//    grow with the block count.
//
// Bound: bytes for the code plane (the D0 plane read, the code written);
// operations for the RDO (per pixel and mode ~40 integer operations).  The
// parent's RDO spent its time in shared 64-bit atomics (three a pixel and
// mode) and in a warp a patch reading every block's patch index twice and
// the patch's values one dependent load after another.

#include <cstdint>
#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

constexpr int kThreshold = 4;
constexpr int kLayers = 3;
constexpr int kMaxModes = 16;
constexpr unsigned long long kExact = 1ull << 24;
constexpr long long kFar = 1ll << 20;   // the reference's `big`: a lane not generated
constexpr int kSmall = 4000;            // depth differences a warp sums in 32 bits

__device__ __forceinline__ void interp_deltas(const int32_t* g, int H, int W, int y, int x,
                                              int& d1, int& d2) {
  const int c = g[y * W + x];
  int raw1 = 0, raw2 = 0;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int ny = min(max(y + dy, 0), H - 1), nx = min(max(x + dx, 0), W - 1);
      const int d = g[ny * W + nx] - c;
      const int v = (d >= 1 && d <= kThreshold) ? d : 0;
      if (max(abs(dy), abs(dx)) == 1) raw1 = max(raw1, v);
      else raw2 = max(raw2, v);
    }
  }
  raw2 = max(raw2, raw1);
  d1 = max(raw1 - 1, 0);
  d2 = max(raw2 - 1, 0);
}

__device__ __forceinline__ int dmag_of(const int32_t* t, int d1, int d2) {
  const int base = t[0] == 1 ? (t[3] == 2 ? d2 : d1) : 0;
  return max(base, t[2]);
}

__global__ void code_kernel(const int32_t* geo, const int32_t* bm, const int32_t* tbl, int M,
                            int H, int W, int res, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i - (i / W) * W;
  int d1, d2;
  interp_deltas(geo, H, W, y, x, d1, d2);
  const int m = min(max(bm[(y / res) * (W / res) + x / res], 0), M - 1);
  const int32_t* t = tbl + m * 4;
  const int dmag = dmag_of(t, d1, d2);
  const bool fill = t[1] == 1;
  int code = 0;
  for (int j = 1; j <= kLayers; ++j)
    if (dmag == j || (fill && dmag > j)) code |= 1 << (j - 1);
  out[i] = code;
}

// the RDO's per-call arrays and its packed result
struct Rdo {
  const int32_t* g0d;  // (H, W) decoded D0
  const int32_t* g0t;  // (H, W) true D0
  const int32_t* g1t;  // (H, W) true D1
  const uint8_t* occ;  // (H, W) decoded occupancy
  const int32_t* btp;  // (nb,) block-to-patch (0: no patch)
  const int32_t* tbl;  // (M, 4) mode table
  float* bfwd;         // (nb, M) the blocks' float32 sums
  float* bbwd;
  float* bgen;
  float* bsrc;         // (nb,)
  int32_t* barg;       // (nb,) the block's own mode
  int32_t* bbig;       // (nb,) 1 where the block's exact sums reach 2^24
  // [inexact, block modes (nb), patch levels (p_max), patch modes (p_max)]
  int32_t* packed;
  int M, H, W, res, nb, p_max, block_threshold;
};

constexpr int kRdoMaxWarps = 32;      // res * res <= 1024 pixels a block
constexpr int kPatchThreads = 1024;
constexpr int kStage = 512;           // a patch's blocks staged at a time
constexpr int kScan = 4;              // blocks a thread a step of the btp scan
constexpr int kStep = kScan * kPatchThreads;   // blocks a step of the scan
constexpr int kKeep = 1024;           // a patch's first blocks kept for its level

// a warp's sum of v (< 2^43) in 64 bits: its 16-bit low parts and the rest
// added apart, each sum below 2^32
__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
  const unsigned lo = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(v & 0xFFFFu));
  const unsigned hi = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(v >> 16));
  return lo + (static_cast<unsigned long long>(hi) << 16);
}

// A pixel's squared distances to the lanes D0 + k, k = 1..3, that any mode
// may generate, and to D0 itself, in T: int where every depth difference is
// below kSmall (squares below 2^24, a warp's sums below 2^32), else long
// long.  They do not depend on the mode.
template <typename T>
struct Lanes {
  T f0, f1;            // the true depths' squared distances to D0
  T q0[kLayers], q1[kLayers], qm[kLayers];   // to D0 + k; their minimum
  __device__ __forceinline__ Lanes(int t0, int t1, int gd) {
    f0 = static_cast<T>(t0 - gd) * (t0 - gd);
    f1 = static_cast<T>(t1 - gd) * (t1 - gd);
#pragma unroll
    for (int k = 0; k < kLayers; ++k) {
      const T e0 = t0 - (gd + k + 1), e1 = t1 - (gd + k + 1);
      q0[k] = e0 * e0;
      q1[k] = e1 * e1;
      qm[k] = min(q0[k], q1[k]);
    }
  }
  // one mode's forward error (each true depth to its nearest generated
  // lane, at most 2^20 where a lane is not generated), backward error (each
  // generated lane to its nearest true depth) and generated count
  __device__ __forceinline__ void terms(bool has_d1, int dmag, bool fill, T& fw, T& bw,
                                        unsigned& ng) const {
    T g0 = f0, g1 = f1;
    bw = 0;
    ng = 1;
#pragma unroll
    for (int k = 0; k < kLayers; ++k) {   // branch-free: dmag differs from pixel to pixel
      const bool lane = k + 1 == dmag || (fill && k + 1 < dmag);
      g0 = lane ? min(g0, q0[k]) : g0;
      g1 = lane ? min(g1, q1[k]) : g1;
      bw += lane ? qm[k] : static_cast<T>(0);
      ng += lane;
    }
    if (ng < 1 + kLayers) {
      g0 = min(g0, static_cast<T>(kFar));
      g1 = min(g1, static_cast<T>(kFar));
    }
    fw = g0 + (has_d1 ? g1 : static_cast<T>(0));
  }
};

// the lanes a mode generates above D0: max(interpolate ? (neighbour 2 ? d2
// : d1) : 0, minD1), from a mode's code (s_mode) and minD1
__device__ __forceinline__ int mode_dmag(int code, int mind, int d1, int d2) {
  const int interp = code & 3;
  return max(interp == 0 ? 0 : interp == 1 ? d1 : d2, mind);
}

// A block a occupancy block, a thread a pixel (blockDim: res * res rounded
// up to a warp): the (res + 4)^2 window of decoded D0 staged for the
// deltas; per mode the pixel's forward, backward and generated counts, each
// summed exactly by the warp's reductions and across warps through shared
// memory (integers: any order); then the block's float32 sums, its mode
// (the first minimum of max(fwd / src, bwd / gen)) and whether its exact
// sums reach 2^24.
// (two blocks of up to 1024 threads an SM: 32 registers, so that eight
// blocks of the usual 256 fit)
__global__ void __launch_bounds__(1024, 2) rdo_blocks_kernel(const __grid_constant__ Rdo a) {
  extern __shared__ int32_t win[];
  __shared__ unsigned long long s_fwd[kRdoMaxWarps][kMaxModes], s_bwd[kRdoMaxWarps][kMaxModes];
  __shared__ int s_gen[kRdoMaxWarps][kMaxModes], s_src[kRdoMaxWarps];
  __shared__ float s_cost[kMaxModes];
  __shared__ int s_big[kMaxModes];
  __shared__ int s_mode[kMaxModes], s_mind[kMaxModes];
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x == 0) a.packed[0] = 0;   // the patches' launch counts into it
  if (b >= a.nb) return;
  const int res = a.res, ws = res + 4, M = a.M;
  const int nbw = a.W / res;
  const int by = b / nbw, bx = b - by * nbw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly = threadIdx.x / res, lx = threadIdx.x - ly * res;
  bool on = threadIdx.x < res * res;
  // the pixel's own values, their loads in flight with the window's
  int gd = 0, t0 = 0, t1 = 0, d1 = 0, d2 = 0;
  if (on) {
    const int i = (by * res + ly) * a.W + bx * res + lx;
    on = a.occ[i] != 0;
    t0 = a.g0t[i];
    t1 = a.g1t[i];
  }
  // a block with no occupied pixel (most of an atlas): every sum 0, so the
  // float sums 0, the counts max(0, 1), the costs 0 and the mode 0
  if (!__syncthreads_or(on)) {
    if (threadIdx.x < M) {
      a.bfwd[b * M + threadIdx.x] = 0.0f;
      a.bbwd[b * M + threadIdx.x] = 0.0f;
      a.bgen[b * M + threadIdx.x] = 1.0f;
    }
    if (threadIdx.x == 0) {
      a.bsrc[b] = 1.0f;
      a.barg[b] = 0;
      a.bbig[b] = 0;
    }
    return;
  }
  // a mode row as a code, interpolation 0 (none), 1 (d1), 2 (d2) and
  // filling at bit 2, and its minD1
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t* t = a.tbl + m * 4;
    s_mode[m] = (t[0] == 1 ? (t[3] == 2 ? 2 : 1) : 0) | (t[1] == 1) << 2;
    s_mind[m] = t[2];
  }
  for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) {
    const int wy = i / ws;
    const int y = min(max(by * res - 2 + wy, 0), a.H - 1);
    const int x = min(max(bx * res - 2 + i - wy * ws, 0), a.W - 1);
    win[i] = a.g0d[y * a.W + x];
  }
  __syncthreads();
  if (threadIdx.x < res * res) {
    gd = win[(ly + 2) * ws + lx + 2];
    int raw1 = 0, raw2 = 0;
    for (int dy = -2; dy <= 2; ++dy) {
      for (int dx = -2; dx <= 2; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int d = win[(ly + 2 + dy) * ws + lx + 2 + dx] - gd;
        const int v = (d >= 1 && d <= kThreshold) ? d : 0;
        if (max(abs(dy), abs(dx)) == 1) raw1 = max(raw1, v);
        else raw2 = max(raw2, v);
      }
    }
    raw2 = max(raw2, raw1);
    d1 = max(raw1 - 1, 0);
    d2 = max(raw2 - 1, 0);
  }
  const bool has_d1 = t1 != t0;
  const unsigned src = __reduce_add_sync(0xFFFFFFFFu, on ? (has_d1 ? 2u : 1u) : 0u);
  if (lane == 0) s_src[warp] = static_cast<int>(src);
  // a warp whose depth differences all stay below kSmall sums in 32 bits
  const bool small = __all_sync(0xFFFFFFFFu, !on || (abs(t0 - gd) < kSmall && abs(t1 - gd) < kSmall));
  if (small) {
    const Lanes<int> ln(t0, t1, gd);
    for (int m = 0; m < M; ++m) {
      const int code = s_mode[m];
      int f = 0, b2 = 0;
      unsigned ng = 0;
      if (on) ln.terms(has_d1, mode_dmag(code, s_mind[m], d1, d2), code >> 2, f, b2, ng);
      f = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(f)));
      const unsigned bs = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(b2));
      ng = __reduce_add_sync(0xFFFFFFFFu, ng);
      if (lane == 0) {
        s_fwd[warp][m] = static_cast<unsigned>(f);
        s_bwd[warp][m] = bs;
        s_gen[warp][m] = static_cast<int>(ng);
      }
    }
  } else {
    const Lanes<long long> ln(t0, t1, gd);
    for (int m = 0; m < M; ++m) {
      const int code = s_mode[m];
      long long f = 0, b2 = 0;
      unsigned ng = 0;
      if (on) ln.terms(has_d1, mode_dmag(code, s_mind[m], d1, d2), code >> 2, f, b2, ng);
      const unsigned long long fs = warp_sum64(static_cast<unsigned long long>(f));
      const unsigned long long bs = warp_sum64(static_cast<unsigned long long>(b2));
      ng = __reduce_add_sync(0xFFFFFFFFu, ng);
      if (lane == 0) {
        s_fwd[warp][m] = fs;
        s_bwd[warp][m] = bs;
        s_gen[warp][m] = static_cast<int>(ng);
      }
    }
  }
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  if (threadIdx.x < M) {
    const int m = threadIdx.x;
    unsigned long long F = 0, B = 0;
    int G = 0, S = 0;
    for (int w = 0; w < nw; ++w) {
      F += s_fwd[w][m];
      B += s_bwd[w][m];
      G += s_gen[w][m];
      S += s_src[w];
    }
    const float fs = fmaxf(static_cast<float>(S), 1.f);
    const float ff = __ull2float_rn(F), fb = __ull2float_rn(B);
    const float fg = fmaxf(static_cast<float>(G), 1.f);
    a.bfwd[b * M + m] = ff;
    a.bbwd[b * M + m] = fb;
    a.bgen[b * M + m] = fg;
    if (m == 0) a.bsrc[b] = fs;
    s_cost[m] = fmaxf(__fdiv_rn(ff, fs), __fdiv_rn(fb, fg));
    s_big[m] = F >= kExact || B >= kExact;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = 0;
    bool big = false;
    for (int m = 0; m < M; ++m) {
      if (s_cost[m] < s_cost[best]) best = m;
      big = big || s_big[m];
    }
    a.barg[b] = best;
    a.bbig[b] = big;
  }
}

// A block a patch index q (0 = no patch: its blocks get mode 0).  The
// block scans btp kStep blocks at a time (kScan consecutive a thread, the
// next step's loads in flight), a warp scan of the threads' counts and the
// warps' totals through shared memory, and lists the step's blocks of the
// patch in raster order; each writes its own mode (patch 0: mode 0).  The
// patch's float32 pools are summed sequentially along each step's list
// (XLA's scatter-add order), a thread a (mode, quantity) column over the
// blocks' values staged kStage blocks at a time.  Thread 0 then takes the
// patch's mode and level; a patch with the level flag (at most
// block_threshold blocks) writes its mode to its blocks, kept from the scan
// (the first kKeep) or, past them, found by a second scan.  The blocks' and
// the small patches' sums past 2^24 are added to the packed count.
__global__ void __launch_bounds__(kPatchThreads) rdo_patches_kernel(const __grid_constant__ Rdo a) {
  extern __shared__ int32_t dyn[];
  const int M = a.M, cols = 3 * M + 1;
  float* stage = reinterpret_cast<float*>(dyn);   // kStage x cols
  int32_t* list = dyn + kStage * cols;             // a step's blocks of the patch
  __shared__ int s_keep[kKeep];
  __shared__ int s_warp[kPatchThreads / 32];
  __shared__ float s_pool[3 * kMaxModes + 1];
  __shared__ int s_best, s_level, s_big;
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = threadIdx.x;
  int cnt = 0, big_blocks = 0;
  float acc = 0.0f;   // thread j < cols: the pool of column j
  // raster order is thread order, then order in the thread
  int nxt[kScan];
#pragma unroll
  for (int k = 0; k < kScan; ++k) {
    const int bi = threadIdx.x * kScan + k;
    nxt[k] = bi < a.nb ? a.btp[bi] : -1;
  }
  for (int base = 0; base < a.nb; base += kStep) {
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int bi = base + threadIdx.x * kScan + k;
      if (bi < a.nb && nxt[k] == q) mine |= 1u << k;
      const int ahead = bi + kStep;
      nxt[k] = ahead < a.nb ? a.btp[ahead] : -1;
    }
    const int m = __popc(mine);
    int incl = m;   // the warp's inclusive scan of the counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = incl - m, total = 0;
    for (int w = 0; w < kPatchThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      if (!((mine >> k) & 1u)) continue;
      const int bi = base + threadIdx.x * kScan + k;
      big_blocks += a.bbig[bi];
      if (q == 0) {
        a.packed[1 + bi] = 0;
      } else {
        a.packed[1 + bi] = a.barg[bi];   // a patch with the level flag rewrites it
        if (cnt + before < kKeep) s_keep[cnt + before] = bi;
        list[before++] = bi;
      }
    }
    __syncthreads();   // the list written, s_warp read
    if (q > 0) {
      for (int i0 = 0; i0 < total; i0 += kStage) {
        const int k = min(kStage, total - i0);
#pragma unroll 8
        for (int e = threadIdx.x; e < k * cols; e += kPatchThreads) {
          const int r = e / cols, c = e - r * cols;
          const int bl = list[i0 + r];
          stage[e] = c < M       ? a.bfwd[bl * M + c]
                     : c < 2 * M ? a.bbwd[bl * M + c - M]
                     : c < 3 * M ? a.bgen[bl * M + c - 2 * M]
                                 : a.bsrc[bl];
        }
        __syncthreads();
        if (j < cols) {
#pragma unroll 8
          for (int r = 0; r < k; ++r) acc = __fadd_rn(acc, stage[r * cols + j]);
        }
        __syncthreads();
      }
    }
    cnt += total;
  }
  if (q > 0) {
    if (j < cols) s_pool[j] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      const bool level = cnt <= a.block_threshold;
      const float ps = fmaxf(s_pool[3 * M], 1.f);
      int best = 0;
      float best_cost = 0.f;
      bool big = false;
      for (int m = 0; m < M; ++m) {
        const float pf = s_pool[m], pb = s_pool[M + m], pg = s_pool[2 * M + m];
        const float cost = fmaxf(__fdiv_rn(pf, ps), __fdiv_rn(pb, fmaxf(pg, 1.f)));
        big = big || pf >= 16777216.f || pb >= 16777216.f;
        if (m == 0 || cost < best_cost) {
          best = m;
          best_cost = cost;
        }
      }
      a.packed[1 + a.nb + q - 1] = level ? 1 : 0;
      a.packed[1 + a.nb + a.p_max + q - 1] = best;
      s_best = best;
      s_level = level;
      s_big = level && big;
    }
    __syncthreads();
    if (s_level && cnt <= kKeep) {
      for (int i = threadIdx.x; i < cnt; i += kPatchThreads) a.packed[1 + s_keep[i]] = s_best;
    } else if (s_level) {
      for (int bi = threadIdx.x; bi < a.nb; bi += kPatchThreads)
        if (a.btp[bi] == q) a.packed[1 + bi] = s_best;
    }
  }
  big_blocks = __reduce_add_sync(0xFFFFFFFFu, big_blocks);
  if (lane == 0 && big_blocks) atomicAdd(a.packed, big_blocks);
  if (threadIdx.x == 0 && q > 0 && s_big) atomicAdd(a.packed, 1);
}

}  // namespace

// geo (H, W) int32 decoded D0, bm (H/res, W/res) int32 block modes, tbl (M, 4)
// int32 mode table -> out (H, W) int32 codes.
extern "C" int plr_code(const int32_t* geo, const int32_t* bm, const int32_t* tbl, int M,
                        int H, int W, int res, int32_t* out, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  code_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(geo, bm, tbl, M,
                                                                             H, W, res, out);
  return static_cast<int>(cudaGetLastError());
}

// The RDO of one frame in two launches, no host wait.  g0d, g0t, g1t (H, W)
// int32, occ (H, W) uint8, btp (H/res, W/res) int32, tbl (M, 4) int32, M <=
// 16, res * res <= 1024; scratch: nb * (3 M + 3) int32 words;
// packed (1 + nb + 2 p_max) int32: [inexact, block modes (nb), patch levels
// (p_max), patch modes (p_max)].  Depth differences below 2^20.
extern "C" int plr_rdo(const int32_t* g0d, const int32_t* g0t, const int32_t* g1t,
                       const uint8_t* occ, const int32_t* btp, const int32_t* tbl, int M, int H,
                       int W, int res, int block_threshold, int p_max, int32_t* scratch,
                       int32_t* packed, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (M < 1 || M > kMaxModes || res < 1 || res * res > 1024 || p_max < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Rdo a{};
  a.nb = (H / res) * (W / res);
  a.g0d = g0d;
  a.g0t = g0t;
  a.g1t = g1t;
  a.occ = occ;
  a.btp = btp;
  a.tbl = tbl;
  float* f = reinterpret_cast<float*>(scratch);
  a.bfwd = f;
  a.bbwd = f + static_cast<size_t>(a.nb) * M;
  a.bgen = a.bbwd + static_cast<size_t>(a.nb) * M;
  a.bsrc = a.bgen + static_cast<size_t>(a.nb) * M;
  a.barg = scratch + static_cast<size_t>(a.nb) * (3 * M + 1);
  a.bbig = a.barg + a.nb;
  a.packed = packed;
  a.M = M;
  a.H = H;
  a.W = W;
  a.res = res;
  a.p_max = p_max;
  a.block_threshold = block_threshold;
  const int threads = (res * res + 31) / 32 * 32;
  const size_t win = static_cast<size_t>(res + 4) * (res + 4) * sizeof(int32_t);
  rdo_blocks_kernel<<<a.nb > 0 ? a.nb : 1, threads, win, st>>>(a);
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (kStage * (3 * M + 1) + kStep) * static_cast<int>(sizeof(int32_t));
  if ((err = smem_attribute(reinterpret_cast<const void*>(rdo_patches_kernel), smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  rdo_patches_kernel<<<p_max + 1, kPatchThreads, smem, st>>>(a);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
