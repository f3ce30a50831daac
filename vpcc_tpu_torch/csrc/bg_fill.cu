// Kernel W: the dilation, harmonic and smoothed background fills of a stack
// of attribute planes that share one occupancy.
//
// Replaces the XLA programs vpcc_tpu/ops/padding.py `dilate_fill`
// (padding.py:78), `harmonic_fill` (:109, its pyramid included) and
// `smooth_fill` (:58), as `fill_rgb` (:176) runs them on the attribute
// images under attributeBGFill 0 and 2.  Every stencil wraps around the
// plane, as the reference's jnp.roll.  Entry points:
// * bg_dilate: the whole dilation in three launches, a frontier walked level
//   by level.  The reference's pass k fills every empty pixel with a filled
//   4-neighbour; that is exactly the ring of pixels at 4-connected distance
//   k (on the torus) from the occupied set (on the bench frame a median of
//   2,560 of the plane's 1.6 M pixels).  pass_of (H, W) is each pixel's
//   level stamp: 0 occupied, k once claimed for level k, INT_MAX never
//   reached.  A pixel's values live in 32-byte records (kGroup planes each)
//   during the walk, so that a neighbour's planes are two 16-byte loads.
//   1. dilate_seed, a thread a pixel: pass_of; each empty pixel with an
//      occupied neighbour claimed for level 1 and listed (one atomic a warp);
//      each occupied pixel with an empty neighbour (the seed frontier)
//      writes its record, image * 1;
//   2. dilate_levels, one cluster of kCluster CTAs on neighbouring SMs,
//      persistent: level k takes its list (item i to CTA i % kCluster), a
//      thread a pixel, and computes what the reference's pass k computes
//      there, every plane in one thread: the neighbours up, down, left,
//      right, f = pass_of < k, wsum summed from f[0], v = ((up + down) +
//      left) + right over the filled ones' values, rint(v / max(wsum, 1)).
//      A neighbour claimed meanwhile for level k + 1 reads k + 1, not below
//      k: the level runs in place and still sees the state before it.  The
//      stamps come back from the claims, atomicCAS of each neighbour's stamp
//      from INT_MAX to k + 1 (a pixel listed once) while k + 1 <= max_iters,
//      issued after the loads of every neighbour's record (used where
//      filled), so that a level is three dependent round trips (the list,
//      the records and claims, the next list's counter) and a cluster
//      barrier.  The claimed pixels are listed (one atomic a warp).  An
//      empty list ends the walk, read on the device.  Every listed pixel
//      fills, so the levels run are the passes that filled a pixel;
//   3. dilate_finish, a thread a pixel: occupied pixels the image, filled
//      ones their record, unreached ones image * 0 (the reference's x); into
//      x, or rounded half to even and clipped into an int32 output.
//   The lists ping-pong in scratch; their counters rotate over three words,
//   each zeroed a level before it counts, and all three left at 0 for the
//   next call.
// * bg_harmonic: the harmonic fill (levels while both sides are even and
//   above 2, a pull and n_smooth = 8 Jacobi steps a level, the pixels with
//   weight held at value / weight), or with min_side 1 and no steps above
//   level 0 the smoothed push-pull, with no host wait, in 6 launches on
//   1280 x 1280 planes (the parent took 91):
//   1. harmonic_push: a block a 32 x 32 region of level 0 (a thread a 2 x 2
//      block), the weights once, then up to 8 planes together (every load
//      in flight, a barrier a level for all of them): levels 1..t (t =
//      min(L, 5)) of the region in shared memory, every level's value and
//      weight sums written to scratch, ((a + b) + c) + d, the value sums
//      reaching 2^24 counted (XLA's order of this push was not probed);
//   2. harmonic_coarse: a block of 1024 threads a plane pushes levels
//      t+1..L from level t, then pulls and relaxes every level of at most
//      80 x 80 pixels (c..L) whole in shared memory (two ping-pong buffers
//      and a byte of held flag a pixel), a pixel a thread with explicit
//      modular neighbours (a 5 x 5 level wraps several times), a
//      __syncthreads() a step; level c's fill to scratch.  No launch where
//      there is nothing to push and no such level;
//   3. harmonic_tile, one launch a level l = c-1..0 (where the coarsest
//      level is larger than 80 x 80 pixels, c = L + 1 and level L is the
//      first, pulled from its sums alone): a block a (64 x 64 tile, plane)
//      pulls the tile and a halo of 8 pixels (wrapped, as often as the
//      plane is small) from the parent's fill straight into 5 x 5
//      micro-tiles in registers, a thread each, then runs the steps: a step
//      reads the 20 values around the micro-tile and writes its 16 edge
//      values to the other buffer (1.44 shared words a pixel-step), one
//      __syncthreads(); a pixel k in from the tile's staged edge is exact
//      after k steps, so the tile is exact after 8.  A level of more steps
//      takes a launch for each 8 of them, the later ones restaged from the
//      level's state in scratch.  Level 0 reads the image and occupancy
//      (value image * occupancy, weight occupancy) and writes the selection
//      (the image where occupied: what a held pixel holds where its
//      occupancy is 1, else reread) as floats and / or rounded half to even
//      and clipped: one finish, not two.
// Float operations are single IEEE roundings (built with --fmad=false), in the
// order of the reference's XLA CPU program: the stencil ((up + down) + left)
// + right times 0.25, a held pixel value / max(weight, 1) by a division.
//
// Bound: bytes.  The dilation reads the planes and the occupancy once and
// writes the filled planes once; its floor is its chain of levels, each a
// cluster barrier (0.48 us for 16 CTAs of 256 threads on an H100) behind
// three dependent memory round trips.  The harmonic fill's floor is the
// same bytes (80 MB for six 1280 x 1280 planes); its tile levels also read
// each staged halo (1.56x the tile) and its steps are shared-memory and
// instruction bound.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kEmpty = INT_MAX;
constexpr int kSeedThreads = 256;
constexpr int kCluster = 16;           // CTAs of the level walk (one GPC)
constexpr int kLevelThreads = 256;     // threads a CTA of the level walk
constexpr int kGroup = 8;              // planes a value record holds (32 bytes)
// scratch words: three rotating list counters and the passes run (the
// header, kHeader words, padded to 16), the value records (groups x hw x
// kGroup floats), pass_of (hw) and the two lists (hw each)
constexpr int kHeader = 4;
constexpr int kRecords = 16;

struct Dilate {
  const int32_t* img;
  float* x;
  float* rec;         // a pixel's values, kGroup planes a record, groups x hw records
  int32_t* cnt;       // kHeader words
  int32_t* pass_of;
  int32_t* list[2];   // level k's list is list[k & 1]
  int C, H, W, max_iters, groups;
};

// a 16-byte load through L2, as volatile asm: the compiler keeps it where it
// stands, ahead of the claims' atomics, so that both round trips overlap
__device__ __forceinline__ float4 load_early(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// the two 16-byte halves of pixel p's record of group g
__device__ __forceinline__ float4* record(const Dilate& a, int g, int p) {
  return reinterpret_cast<float4*>(a.rec + (static_cast<int64_t>(g) * a.H * a.W + p) * kGroup);
}

__device__ __forceinline__ void neighbours(int p, int H, int W, int nb[4]) {
  const int y = p / W, xx = p - y * W;
  nb[0] = (y == 0 ? H - 1 : y - 1) * W + xx;   // up (roll +1 on rows)
  nb[1] = (y == H - 1 ? 0 : y + 1) * W + xx;   // down
  nb[2] = y * W + (xx == 0 ? W - 1 : xx - 1);  // left
  nb[3] = y * W + (xx == W - 1 ? 0 : xx + 1);  // right
}

// Appends this lane's entries q[j] for the bits j of `take` to list at
// *count (one atomic a warp); every lane of the warp calls it.
__device__ __forceinline__ void warp_append(unsigned take, const int q[4], int32_t* count,
                                            int32_t* list) {
  const int lane = threadIdx.x & 31;
  const int m = __popc(take);
  int incl = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (total == 0) return;
  int base = 0;
  if (lane == 31) base = atomicAdd(count, total);
  base = __shfl_sync(0xFFFFFFFFu, base, 31) + incl - m;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((take >> j) & 1u) list[base++] = q[j];
}

__global__ void __launch_bounds__(kSeedThreads) dilate_seed(const uint8_t* __restrict__ occ,
                                                            Dilate a) {
  const int hw = a.H * a.W;
  const int p = blockIdx.x * kSeedThreads + threadIdx.x;
  const int q[4] = {p, 0, 0, 0};
  unsigned take = 0;
  if (p < hw) {
    int nb[4];
    neighbours(p, a.H, a.W, nb);
    const bool o = occ[p] != 0;
    const int around = occ[nb[0]] + occ[nb[1]] + occ[nb[2]] + occ[nb[3]];
    int lv = kEmpty;
    if (o) {
      lv = 0;
      if (around < 4 && a.max_iters >= 1)   // the seed frontier: its record, image * 1
        for (int g = 0; g < a.groups; ++g) {
          float v[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int c = g * kGroup + u;
            v[u] = c < a.C ? static_cast<float>(a.img[static_cast<int64_t>(c) * hw + p]) : 0.0f;
          }
          float4* r = record(a, g, p);
          r[0] = make_float4(v[0], v[1], v[2], v[3]);
          r[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    } else if (a.max_iters >= 1 && around != 0) {
      lv = 1;
    }
    a.pass_of[p] = lv;
    take = lv == 1;
  }
  warp_append(take, q, a.cnt + 1, a.list[1]);
}

__global__ void __launch_bounds__(kLevelThreads, 1) dilate_levels(const __grid_constant__ Dilate a) {
  const int hw = a.H * a.W;
  // item i of a list goes to CTA i % gridDim.x: a short list still spreads
  // over every SM of the walk (their load pipes, not the latency, bound a
  // level whose items sit on a few SMs)
  const int vid = threadIdx.x * gridDim.x + blockIdx.x;
  const int stride = gridDim.x * kLevelThreads;
  const int cap = hw;   // a list's capacity
  int k = 1;
  for (;; ++k) {
    // this thread's first item read with the count (whatever lies there
    // when the list is shorter is not used)
    const int first = vid < cap ? __ldcg(a.list[k & 1] + vid) : 0;
    const int n = __ldcg(a.cnt + k % 3);
    if (n == 0) break;
    if (vid == 0) a.cnt[(k + 2) % 3] = 0;   // counts level k + 2; read last at level k - 1
    const int32_t* cur = a.list[k & 1];
    int32_t* nxt = a.list[(k + 1) & 1];
    const bool claim = k + 1 <= a.max_iters;
    for (int i0 = 0; i0 < n; i0 += stride) {   // the same trips for every lane
      const int i = i0 + vid;
      int nb[4] = {0, 0, 0, 0};
      unsigned take = 0;   // the neighbours this pixel claims
      if (i < n) {
        const int p = i0 == 0 ? first : __ldcg(cur + i);
        neighbours(p, a.H, a.W, nb);
        // one round trip: every neighbour's record of group 0 (used where
        // filled), then its stamp, which comes back from the claim
        // (atomicCAS returns the stamp it found: INT_MAX where it claimed)
        float4 t[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4* r = record(a, 0, nb[j]);
          t[j][0] = load_early(r);
          t[j][1] = load_early(r + 1);
        }
        int pf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[j] = claim ? atomicCAS(a.pass_of + nb[j], kEmpty, k + 1) : __ldcg(a.pass_of + nb[j]);
        bool f[4];
        float wsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[j] = pf[j] < k;
          wsum = j == 0 ? (f[0] ? 1.0f : 0.0f) : __fadd_rn(wsum, f[j] ? 1.0f : 0.0f);
        }
        const float den = fmaxf(wsum, 1.0f);
        for (int g = 0; g < a.groups; ++g) {
          if (g > 0) {   // planes beyond the first kGroup: another round trip
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4* r = record(a, g, nb[j]);
              t[j][0] = __ldcg(r);
              t[j][1] = __ldcg(r + 1);
            }
          }
          float v[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const float e[4] = {(&t[0][u >> 2].x)[u & 3], (&t[1][u >> 2].x)[u & 3],
                                (&t[2][u >> 2].x)[u & 3], (&t[3][u >> 2].x)[u & 3]};
            float s = f[0] ? e[0] : 0.0f;
#pragma unroll
            for (int j = 1; j < 4; ++j) s = __fadd_rn(s, f[j] ? e[j] : 0.0f);
            v[u] = rintf(__fdiv_rn(s, den));
          }
          float4* r = record(a, g, p);
          r[0] = make_float4(v[0], v[1], v[2], v[3]);
          r[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        if (claim) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (pf[j] == kEmpty) take |= 1u << j;
        }
      }
      warp_append(take, nb, a.cnt + (k + 1) % 3, nxt);
    }
    cg::this_cluster().sync();
  }
  if (vid == 0) {   // every counter read for the last time: leave them at 0
    a.cnt[0] = a.cnt[1] = a.cnt[2] = 0;
    a.cnt[3] = k - 1;
  }
}

__global__ void dilate_finish(const uint8_t* __restrict__ occ, Dilate a,
                              int32_t* __restrict__ out, int lo, int hi) {
  const int hw = a.H * a.W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int pf = a.pass_of[p];
  for (int c = 0; c < a.C; ++c) {
    const int64_t at = static_cast<int64_t>(c) * hw + p;
    const float im = static_cast<float>(a.img[at]);
    const float v = pf == 0         ? im
                    : pf == kEmpty ? __fmul_rn(im, 0.0f)
                                   : a.rec[(static_cast<int64_t>(c / kGroup) * hw + p) * kGroup +
                                           c % kGroup];
    if (out != nullptr) {
      out[at] = static_cast<int32_t>(fminf(fmaxf(rintf(v), static_cast<float>(lo)),
                                           static_cast<float>(hi)));
    } else {
      a.x[at] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// the harmonic (and smoothed push-pull) fill

constexpr float kExactLimit = 16777216.0f;  // 2^24
constexpr int kMaxLevels = 32;
// the push: a block a region of 2^5 x 2^5 pixels of level 0, a thread a 2x2
// block of it, levels 1..5 of the region in shared memory
constexpr int kPushLog = 5;
constexpr int kPushSide = 1 << kPushLog;
constexpr int kPushThreads = kPushSide * kPushSide / 4;
constexpr int kPushFloats = (kPushSide * kPushSide - 1) / 3;  // levels 1..5 of a region
constexpr int kPushPlanes = 8;   // planes a push block reduces together
// the coarse levels: one block a plane, a level's fill ping-ponged between
// two buffers of kCoarseCap floats, its held flags in kCoarseCap bytes
constexpr int kCoarseThreads = 1024;
constexpr int kCoarseCap = 80 * 80;
constexpr int kCoarseSmem = kCoarseCap * (2 * 4 + 1);
constexpr int kUnroll = 8;   // pixels of a coarse pull a thread loads at once
// a tile level: a block a (kOut x kOut tile, plane) with a halo of kHalo
// pixels (the most steps a tile level runs) staged once, kBuf x kBuf; a
// thread a kMicro x kMicro micro-tile in registers
constexpr int kHalo = 8;
constexpr int kMicro = 5;
constexpr int kTileSide = 16;                     // threads along a side
constexpr int kBuf = kMicro * kTileSide;          // 80
constexpr int kOut = kBuf - 2 * kHalo;            // 64
constexpr int kTileThreads = kTileSide * kTileSide;
constexpr int kTileSmem = kBuf * kBuf * 2 * 4;

struct Harmonic {
  const int32_t* img;  // (C, H, W)
  const uint8_t* occ;  // (H, W)
  float* fill;         // (C, H, W) float32 result, or null
  int32_t* out;        // (C, H, W) rounded and clipped result, or null
  float* s;            // scratch: every level's sums and the tile levels' fills
  int* inexact;
  int C, L, t, c;      // levels 1..L; the push builds 1..t; the coarse launch c..L
  int steps, steps0, hold_img, lo, hi;
  int h[kMaxLevels], w[kMaxLevels];
  // float offsets in s of level l's value sums (C, h, w), weight sums ((h,
  // w) for l <= t, one copy a plane above) and fill (C, h, w; l = 1..c),
  // and of two (C, H, W) states of a tile level between its launches (where
  // a level runs more than kHalo steps)
  long long vals[kMaxLevels], wts[kMaxLevels], fills[kMaxLevels], tmp;
};

// One launch of a tile level l: `steps` (at most kHalo) steps after staging
// from src, the parent's fill (first: the level's pull; the top level reads
// none) or the level's own state after the launches before; the result to
// dst (a state for the next launch) or, last, to the level's fill (level 0:
// the selection).
struct Pass {
  const float* src;
  float* dst;
  int l, steps, first, last;
};

__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ void count_inexact(float v, int* inexact) {
  if (v >= kExactLimit) atomicAdd(inexact, 1);
}

__device__ __forceinline__ float stencil(float up, float dn, float lf, float rt) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt), 0.25f);
}

// v mod n in 0..n-1 (v may lie below 0 or above n by several n)
__device__ __forceinline__ int wrap(int v, int n) {
  if (v >= 0 && v < n) return v;
  v %= n;
  return v < 0 ? v + n : v;
}

// offset of level l (>= 1) in a push region's pyramid: levels 1..l-1 first
__device__ __forceinline__ int push_off(int l) {
  return (kPushSide * kPushSide - (kPushSide >> (l - 1)) * (kPushSide >> (l - 1))) / 3;
}

// Levels 1..t: a block a region (clipped to the plane: its sides stay
// multiples of 2^t), the weights once, then the planes kPushPlanes at a
// time (their loads all in flight, a barrier a level for all of them);
// every level's sums written to scratch.
__global__ void __launch_bounds__(kPushThreads) harmonic_push(const __grid_constant__ Harmonic a) {
  __shared__ float sv[kPushPlanes][kPushFloats];
  __shared__ float sw[kPushFloats];
  const int H = a.h[0], W = a.w[0];
  const int nrx = (W + kPushSide - 1) / kPushSide;
  const int ry = blockIdx.x / nrx;
  const int y0 = ry * kPushSide, x0 = (blockIdx.x - ry * nrx) * kPushSide;
  const int RH = min(kPushSide, H - y0), RW = min(kPushSide, W - x0);
  constexpr int half = kPushSide / 2;
  const int uy = threadIdx.x / half, ux = threadIdx.x - uy * half;
  const bool act = 2 * uy < RH && 2 * ux < RW;
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t pix = static_cast<size_t>(y0 + 2 * uy) * W + x0 + 2 * ux;
  const int i1 = uy * half + ux;
  const size_t n1 = static_cast<size_t>(a.h[1]) * a.w[1];
  const size_t g1 = static_cast<size_t>(y0 / 2 + uy) * a.w[1] + x0 / 2 + ux;
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (act) {
    o[0] = a.occ[pix];
    o[1] = a.occ[pix + 1];
    o[2] = a.occ[pix + W];
    o[3] = a.occ[pix + W + 1];
    const float wv = sum4(o[0], o[1], o[2], o[3]);
    sw[i1] = wv;
    a.s[a.wts[1] + g1] = wv;
  }
  for (int p0 = 0; p0 < a.C; p0 += kPushPlanes) {
    const int np = min(kPushPlanes, a.C - p0);
    // level 1 of the chunk's planes, every plane's loads issued first
    int im[kPushPlanes][4];
#pragma unroll
    for (int k = 0; k < kPushPlanes; ++k) {
      if (act && k < np) {
        const int32_t* q = a.img + (p0 + k) * HW + pix;
        im[k][0] = q[0];
        im[k][1] = q[1];
        im[k][2] = q[W];
        im[k][3] = q[W + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < kPushPlanes; ++k) {
      if (act && k < np) {
        const float v = sum4(__fmul_rn(static_cast<float>(im[k][0]), o[0]),
                             __fmul_rn(static_cast<float>(im[k][1]), o[1]),
                             __fmul_rn(static_cast<float>(im[k][2]), o[2]),
                             __fmul_rn(static_cast<float>(im[k][3]), o[3]));
        sv[k][i1] = v;
        count_inexact(v, a.inexact);
        a.s[a.vals[1] + (p0 + k) * n1 + g1] = v;
      }
    }
    __syncthreads();
    // levels 2..t, a barrier a level for all the chunk's planes
    for (int l = 2; l <= a.t; ++l) {
      const int s = kPushSide >> l, ps = 2 * s;
      const int off = push_off(l), poff = push_off(l - 1);
      const int h = RH >> l, w = RW >> l, hw = h * w;
      const int gw = a.w[l];
      const size_t n = static_cast<size_t>(a.h[l]) * gw;
      for (int e = threadIdx.x; e < np * hw; e += kPushThreads) {
        const int k = e / hw, i = e - k * hw;
        const int y = i / w, x = i - y * w;
        const int q = poff + 2 * y * ps + 2 * x;
        const float v = sum4(sv[k][q], sv[k][q + 1], sv[k][q + ps], sv[k][q + ps + 1]);
        sv[k][off + y * s + x] = v;
        count_inexact(v, a.inexact);
        a.s[a.vals[l] + (p0 + k) * n + static_cast<size_t>((y0 >> l) + y) * gw + (x0 >> l) + x] =
            v;
      }
      if (p0 == 0) {
        for (int i = threadIdx.x; i < hw; i += kPushThreads) {
          const int y = i / w, x = i - y * w;
          const int q = poff + 2 * y * ps + 2 * x;
          const float wv = sum4(sw[q], sw[q + 1], sw[q + ps], sw[q + ps + 1]);
          sw[off + y * s + x] = wv;
          a.s[a.wts[l] + static_cast<size_t>((y0 >> l) + y) * gw + (x0 >> l) + x] = wv;
        }
      }
      __syncthreads();
    }
  }
}

// Levels t+1..L pushed (from level t in scratch), then levels L..c (if c
// <= L) pulled and relaxed whole in shared memory, a block a plane, a pixel
// a thread with explicit modular neighbours (a 5 x 5 level wraps several
// times), a __syncthreads() a step.  Level c's fill goes to scratch for the
// tile levels.
__global__ void __launch_bounds__(kCoarseThreads, 1)
    harmonic_coarse(const __grid_constant__ Harmonic a) {
  extern __shared__ float dsm[];
  // buffer k at dsm + k * kCoarseCap (an array of the two would live on the
  // stack: its index is not known at compile time)
  const int p = blockIdx.x;
  float* S = a.s;
  for (int l = a.t + 1; l <= a.L; ++l) {
    const int w = a.w[l], pw = a.w[l - 1];
    const int n = a.h[l] * w, pn = a.h[l - 1] * pw;
    const float* pv = S + a.vals[l - 1] + static_cast<size_t>(p) * pn;
    const float* pwt = S + a.wts[l - 1] + (l - 1 > a.t ? static_cast<size_t>(p) * pn : 0);
    float* V = S + a.vals[l] + static_cast<size_t>(p) * n;
    float* Wt = S + a.wts[l] + static_cast<size_t>(p) * n;
    for (int i = threadIdx.x; i < n; i += kCoarseThreads) {
      const int y = i / w, x = i - y * w;
      const int q = 2 * y * pw + 2 * x;
      const float v = sum4(__ldcg(pv + q), __ldcg(pv + q + 1), __ldcg(pv + q + pw),
                           __ldcg(pv + q + pw + 1));
      V[i] = v;
      count_inexact(v, a.inexact);
      Wt[i] = sum4(__ldcg(pwt + q), __ldcg(pwt + q + 1), __ldcg(pwt + q + pw),
                   __ldcg(pwt + q + pw + 1));
    }
    __syncthreads();   // this block's writes, read back below
  }
  if (a.c > a.L) return;
  uint8_t* hold = reinterpret_cast<uint8_t*>(dsm + 2 * kCoarseCap);
  int cur = 0;   // the buffer that holds the level above's fill
  for (int l = a.L; l >= a.c; --l) {
    const int h = a.h[l], w = a.w[l], n = h * w;
    const bool top = l == a.L;
    const float* V = S + a.vals[l] + static_cast<size_t>(p) * n;
    const float* Wt = S + a.wts[l] + (l > a.t ? static_cast<size_t>(p) * n : 0);
    const float* par = dsm + cur * kCoarseCap;
    const int ppw = w >> 1;
    float* dst = dsm + (cur ^ 1) * kCoarseCap;
    // the pull, kUnroll pixels a thread at a time, their loads issued together
    for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kCoarseThreads) {
      float wv[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kCoarseThreads;
        wv[u] = i < n ? __ldcg(Wt + i) : 0.0f;
        vv[u] = i < n ? __ldcg(V + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kCoarseThreads;
        if (i >= n) break;
        const int y = i / w, x = i - y * w;
        const bool held = wv[u] > 0.0f;
        dst[i] = top || held ? __fdiv_rn(vv[u], fmaxf(wv[u], 1.0f))
                             : par[(y >> 1) * ppw + (x >> 1)];
        hold[i] = held;
      }
    }
    __syncthreads();
    cur ^= 1;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    for (int st = 0; st < a.steps; ++st) {
      const float* src = dsm + cur * kCoarseCap;
      float* nxt = dsm + (cur ^ 1) * kCoarseCap;
      for (int y = ty; y < h; y += 32) {
        const float* row = src + y * w;
        const float* rup = src + (y == 0 ? h - 1 : y - 1) * w;
        const float* rdn = src + (y == h - 1 ? 0 : y + 1) * w;
        for (int x = tx; x < w; x += 32) {
          nxt[y * w + x] = hold[y * w + x]
                               ? row[x]
                               : stencil(rup[x], rdn[x], row[x == 0 ? w - 1 : x - 1],
                                         row[x == w - 1 ? 0 : x + 1]);
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  float* F = S + a.fills[a.c] + static_cast<size_t>(p) * a.h[a.c] * a.w[a.c];
  const float* res = dsm + cur * kCoarseCap;
  for (int i = threadIdx.x; i < a.h[a.c] * a.w[a.c]; i += kCoarseThreads) F[i] = res[i];
}

// One launch of a tile level l < c (Pass): the pull of a kOut x kOut tile
// and its halo from the parent's fill (level 0: from the image and
// occupancy) or the level's state, the steps in shared memory (each step's
// exact region shrinks by a pixel a side), then the tile written: a state
// for the level's next launch, or levels above 0 their fill, level 0 the
// selection (the image where occupied) as floats and / or rounded half to
// even and clipped.
template <bool LEVEL0>
__global__ void __launch_bounds__(kTileThreads, 3)
    harmonic_tile(const __grid_constant__ Harmonic a, const __grid_constant__ Pass ps) {
  // buffer k at tsm + k * kBuf * kBuf
  extern __shared__ float tsm[];
  const int l = ps.l;
  const int h = a.h[l], w = a.w[l];
  const size_t n = static_cast<size_t>(h) * w;
  const int p = blockIdx.y;
  const int ntx = (w + kOut - 1) / kOut;
  const int tyi = blockIdx.x / ntx;
  const int ty0 = tyi * kOut, tx0 = (blockIdx.x - tyi * ntx) * kOut;
  // the top level's first launch pulls from its sums alone (src not read)
  const bool top = l == a.L && ps.first;
  // src: the parent's fill (a pixel for 2 x 2 of the level) or the level's
  // own state (a pixel each)
  const int sh = ps.first ? 1 : 0;
  const float* par = top ? ps.src : ps.src + p * (n >> (2 * sh));
  const int pw = w >> sh;
  const int my = threadIdx.x / kTileSide, mx = threadIdx.x - my * kTileSide;
  const int y0 = my * kMicro, x0 = mx * kMicro;
  // the pull, straight into the thread's micro-tile: a row's loads all
  // issued before any is used
  int gx[kMicro];
#pragma unroll
  for (int c = 0; c < kMicro; ++c) gx[c] = wrap(tx0 - kHalo + x0 + c, w);
  float v[kMicro][kMicro];
  unsigned hm = 0;
  // level 0: a held pixel whose occupancy is not 1 holds (image * o) / o,
  // which need not be the image: then the tile rereads the image to select
  bool reread = false;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int gy = wrap(ty0 - kHalo + y0 + r, h);
    const size_t row = static_cast<size_t>(gy) * w;
    const float* prow = par + static_cast<size_t>(gy >> sh) * pw;
    float wv[kMicro], vv[kMicro], pv[kMicro];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      if constexpr (LEVEL0) {
        wv[c] = a.occ[row + gx[c]];
        vv[c] = static_cast<float>(a.img[p * n + row + gx[c]]);
      } else {
        wv[c] = __ldg(a.s + a.wts[l] + (l > a.t ? p * n : 0) + row + gx[c]);
        vv[c] = __ldg(a.s + a.vals[l] + p * n + row + gx[c]);
      }
      pv[c] = top ? 0.0f : __ldg(prow + (gx[c] >> sh));
    }
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const bool held = wv[c] > 0.0f;
      float f;
      if constexpr (LEVEL0) {
        // level 0: value image * occupancy, weight occupancy (an
        // occupancy of 1 divides nothing: (image * 1) / 1 is the image)
        f = held ? (a.hold_img || wv[c] == 1.0f
                        ? vv[c]
                        : __fdiv_rn(__fmul_rn(vv[c], wv[c]), fmaxf(wv[c], 1.0f)))
            : top ? __fmul_rn(vv[c], wv[c])
                  : pv[c];
      } else {
        f = held || top ? __fdiv_rn(vv[c], fmaxf(wv[c], 1.0f)) : pv[c];
      }
      v[r][c] = f;
      if (held) hm |= 1u << (r * kMicro + c);
      if (LEVEL0 && held && wv[c] != 1.0f && !a.hold_img) reread = true;
    }
  }
  // the micro-tile's edge into buffer 0 for the first step's neighbours
#pragma unroll
  for (int c = 0; c < kMicro; ++c) {
    tsm[y0 * kBuf + x0 + c] = v[0][c];
    tsm[(y0 + kMicro - 1) * kBuf + x0 + c] = v[kMicro - 1][c];
  }
#pragma unroll
  for (int r = 1; r + 1 < kMicro; ++r) {
    tsm[(y0 + r) * kBuf + x0] = v[r][0];
    tsm[(y0 + r) * kBuf + x0 + kMicro - 1] = v[r][kMicro - 1];
  }
  reread = __syncthreads_or(reread);
  // the neighbours beyond the buffer's edge read clamped (wrong) values:
  // they reach a pixel k steps in after k steps, outside the tile
  const int yu = max(y0 - 1, 0), yd = min(y0 + kMicro, kBuf - 1);
  const int xl = max(x0 - 1, 0), xr = min(x0 + kMicro, kBuf - 1);
  int cur = 0;
  for (int k = 0; k < ps.steps; ++k) {
    const float* src = tsm + cur * kBuf * kBuf;
    float* nxt = tsm + (cur ^ 1) * kBuf * kBuf;
    float up[kMicro], dn[kMicro], lf[kMicro], rt[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      up[j] = src[yu * kBuf + x0 + j];
      dn[j] = src[yd * kBuf + x0 + j];
      lf[j] = src[(y0 + j) * kBuf + xl];
      rt[j] = src[(y0 + j) * kBuf + xr];
    }
    float prev[kMicro];   // the row above before this step
#pragma unroll
    for (int c = 0; c < kMicro; ++c) prev[c] = up[c];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      float row[kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const float d = r + 1 < kMicro ? v[r + 1][c] : dn[c];
        const float lv = c > 0 ? v[r][c - 1] : lf[r];
        const float rv = c + 1 < kMicro ? v[r][c + 1] : rt[r];
        row[c] = (hm >> (r * kMicro + c)) & 1u ? v[r][c] : stencil(prev[c], d, lv, rv);
      }
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        prev[c] = v[r][c];
        v[r][c] = row[c];
      }
    }
    // the micro-tile's edge, all its neighbours read
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      nxt[y0 * kBuf + x0 + c] = v[0][c];
      nxt[(y0 + kMicro - 1) * kBuf + x0 + c] = v[kMicro - 1][c];
    }
#pragma unroll
    for (int r = 1; r + 1 < kMicro; ++r) {
      nxt[(y0 + r) * kBuf + x0] = v[r][0];
      nxt[(y0 + r) * kBuf + x0 + kMicro - 1] = v[r][kMicro - 1];
    }
    __syncthreads();
    cur ^= 1;
  }
  // the whole micro-tile into the buffer the last step read (or, with no
  // step, the one nobody read), then the tile written in rows
  float* fin = tsm + (cur ^ 1) * kBuf * kBuf;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
#pragma unroll
    for (int c = 0; c < kMicro; ++c) fin[(y0 + r) * kBuf + x0 + c] = v[r][c];
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < kOut * kOut; i += kTileThreads) {
    const int oy = i / kOut, ox = i - oy * kOut;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (gy >= h || gx >= w) continue;
    const size_t gi = static_cast<size_t>(gy) * w + gx;
    float f = fin[(oy + kHalo) * kBuf + ox + kHalo];
    if (!ps.last) {
      ps.dst[p * n + gi] = f;
    } else if constexpr (LEVEL0) {
      if (reread && a.occ[gi] != 0) f = static_cast<float>(a.img[p * n + gi]);
      if (a.fill != nullptr) a.fill[p * n + gi] = f;
      if (a.out != nullptr)
        a.out[p * n + gi] = static_cast<int32_t>(fminf(fmaxf(rintf(f), static_cast<float>(a.lo)),
                                                       static_cast<float>(a.hi)));
    } else {
      a.s[a.fills[l] + p * n + gi] = f;
    }
  }
}

// The plan of one call: levels, the split between push, coarse and tile
// levels, the scratch offsets.  Returns the scratch floats.
long long plan_harmonic(Harmonic& a, int C, int H, int W, int min_side, int steps, int steps0) {
  a.C = C;
  a.L = 0;
  a.h[0] = H;
  a.w[0] = W;
  while (a.h[a.L] > min_side && a.w[a.L] > min_side && a.h[a.L] % 2 == 0 &&
         a.w[a.L] % 2 == 0 && a.L + 1 < kMaxLevels) {
    a.h[a.L + 1] = a.h[a.L] / 2;
    a.w[a.L + 1] = a.w[a.L] / 2;
    ++a.L;
  }
  a.t = a.L < kPushLog ? a.L : kPushLog;
  // the coarse launch relaxes levels c..L, each of at most kCoarseCap
  // pixels; c = L + 1 where even level L is larger
  a.c = a.L + 1;
  while (a.c > 1 && static_cast<long long>(a.h[a.c - 1]) * a.w[a.c - 1] <= kCoarseCap) --a.c;
  long long off = 0;
  for (int l = 1; l <= a.L; ++l) {
    const long long n = static_cast<long long>(a.h[l]) * a.w[l];
    a.vals[l] = off;
    off += C * n;
    a.wts[l] = off;
    off += l <= a.t ? n : C * n;
    a.fills[l] = off;
    if (l <= a.c) off += C * n;
  }
  a.tmp = off;
  if (steps0 > kHalo || (a.c > 1 && steps > kHalo)) off += 2LL * C * H * W;
  return off;
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// The level walk `kernel` (one argument, *arg) as one cluster of kCluster
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

// The int32 words of scratch bg_dilate takes for C planes of hw pixels.
extern "C" long long bg_dilate_scratch_words(int C, long long hw) {
  return kRecords + (static_cast<long long>(C) + kGroup - 1) / kGroup * kGroup * hw + 3 * hw;
}

// img (C, H, W) int32; occ (H, W) uint8; x (C, H, W) float32; scratch:
// bg_dilate_scratch_words(C, H * W) int32 words, 16-byte aligned, its first
// three zero (each call leaves them so); out (C, H, W) int32 or null.  The dilation of up to
// max_iters passes: with out, rint(fill) clipped to lo..hi into out; without,
// the float fill in x.  The passes that filled a pixel land in scratch[3].
// Three launches (`*launched`); H * W below 2^31.
extern "C" int bg_dilate(const int32_t* img, const uint8_t* occ, float* x, int32_t* scratch,
                         int32_t* out, int C, int H, int W, int max_iters, int lo, int hi,
                         void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int64_t hw64 = static_cast<int64_t>(H) * W;
  if (hw64 == 0 || C == 0) return 0;
  if (hw64 >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int hw = static_cast<int>(hw64);
  Dilate a;
  a.img = img;
  a.x = x;
  a.groups = (C + kGroup - 1) / kGroup;
  a.cnt = scratch;
  a.rec = reinterpret_cast<float*>(scratch + kRecords);
  a.pass_of = scratch + kRecords + static_cast<int64_t>(a.groups) * hw * kGroup;
  a.list[0] = a.pass_of + hw;
  a.list[1] = a.list[0] + hw;
  a.C = C;
  a.H = H;
  a.W = W;
  a.max_iters = max_iters;
  dilate_seed<<<blocks_for(hw, kSeedThreads), kSeedThreads, 0, st>>>(occ, a);
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_walk(reinterpret_cast<const void*>(dilate_levels), &a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  dilate_finish<<<blocks_for(hw, 256), 256, 0, st>>>(occ, a, out, lo, hi);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// The float32 scratch bg_harmonic takes for C planes of H x W (its levels
// while both sides are even and above min_side).
extern "C" long long bg_harmonic_scratch_floats(int C, int H, int W, int min_side, int steps,
                                               int steps0) {
  Harmonic a{};
  return plan_harmonic(a, C, H, W, min_side, steps, steps0);
}

// img (C, H, W) int32; occ (H, W) uint8; scratch: bg_harmonic_scratch_floats
// floats; fill (C, H, W) float32 or null; out (C, H, W) int32 or null.  The
// pyramid of levels while both sides are even and above min_side (2: the
// harmonic fill, 1: the smoothed push-pull's), summed ((a + b) + c) + d,
// every value sum reaching 2^24 counted in *inexact; pulled from the
// coarsest level down, the pixels with weight held at value / weight, with
// `steps` Jacobi steps a level above 0 and steps0 at level 0 (hold_img: the
// held pixels of level 0 take the image, as after the push-pull's
// selection); the occupied pixels then take the image.  The result as floats
// into fill, and / or rounded half to even and clipped to lo..hi into out.
// Launches (*launched): the push, the coarse levels (where there are levels
// to push or to relax whole) and one for each kHalo steps (at least one) of
// a tile level: 6 on 1280 x 1280 planes; 1 where a side is odd (level 0
// alone).
extern "C" int bg_harmonic(const int32_t* img, const uint8_t* occ, float* scratch, float* fill,
                           int32_t* out, int C, int H, int W, int min_side, int steps,
                           int steps0, int hold_img, int lo, int hi, int* inexact, void* stream,
                           int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (static_cast<long long>(C) * H * W == 0) return 0;
  if (C > 65535 || static_cast<long long>(H) * W >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Harmonic a{};
  plan_harmonic(a, C, H, W, min_side, steps, steps0);
  a.img = img;
  a.occ = occ;
  a.fill = fill;
  a.out = out;
  a.s = scratch;
  a.inexact = inexact;
  a.steps = steps;
  a.steps0 = steps0;
  a.hold_img = hold_img;
  a.lo = lo;
  a.hi = hi;
  cudaError_t err;
  if (a.L >= 1) {
    const int regions = ((H + kPushSide - 1) / kPushSide) * ((W + kPushSide - 1) / kPushSide);
    harmonic_push<<<regions, kPushThreads, 0, st>>>(a);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (a.L > a.t || a.c <= a.L) {
    if ((err = smem_attribute(reinterpret_cast<const void*>(harmonic_coarse), kCoarseSmem)) !=
        cudaSuccess)
      return static_cast<int>(err);
    harmonic_coarse<<<C, kCoarseThreads, kCoarseSmem, st>>>(a);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  for (int l = a.c - 1; l >= 0; --l) {
    const int total = l == 0 ? steps0 : steps;
    const int passes = total > kHalo ? (total + kHalo - 1) / kHalo : 1;
    const dim3 grid(((a.h[l] + kOut - 1) / kOut) * ((a.w[l] + kOut - 1) / kOut), C);
    const void* k = l == 0 ? reinterpret_cast<const void*>(harmonic_tile<true>)
                           : reinterpret_cast<const void*>(harmonic_tile<false>);
    if ((err = smem_attribute(k, kTileSmem)) != cudaSuccess) return static_cast<int>(err);
    const size_t state = static_cast<size_t>(C) * H * W;
    for (int i = 0; i < passes; ++i) {
      Pass ps;
      ps.l = l;
      ps.first = i == 0;
      ps.last = i == passes - 1;
      ps.steps = total - i * kHalo < kHalo ? total - i * kHalo : kHalo;
      ps.src = i > 0 ? scratch + a.tmp + ((i - 1) & 1) * state
               : l == a.L ? scratch   // the top level's pull reads no parent
                          : scratch + a.fills[l + 1];
      ps.dst = ps.last ? nullptr : scratch + a.tmp + (i & 1) * state;
      if (l == 0) {
        harmonic_tile<true><<<grid, kTileThreads, kTileSmem, st>>>(a, ps);
      } else {
        harmonic_tile<false><<<grid, kTileThreads, kTileSmem, st>>>(a, ps);
      }
      ++*launched;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
