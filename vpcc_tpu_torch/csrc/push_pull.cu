// Kernel L: push-pull background fill of a stack of video planes, rounded
// to int32.
//
// Replaces the XLA program vpcc_tpu/ops/padding.py `push_pull_fill`
// (padding.py:23) as vpcc_tpu/video/hevc.py `_round_int_plane` (hevc.py:1380)
// runs it on every geometry plane (vmapped over the planes of one call, each
// under its own occupancy in the level-batched GOF path): unoccupied pixels
// take a mip-pyramid interpolation of the occupied ones, then the plane is
// rounded half to even.  (The pyramids of `harmonic_fill` and `smooth_fill`
// are kernel W's own push, bg_fill.cu.)
//
// The function.  Push (levels 1..L, while both sides of the level below are
// even and above 1): a coarse pixel's value and weight sums of its 2x2
// children (0,0), (0,1), (1,0), (1,1) = a, b, c, d in the order XLA's CPU
// program uses at that level: ((a + b) + c) + d, or (a + b) + (c + d) where
// bit l-1 of `pair_mask` is set (the caller's table,
// data/push_order_xla.json); level 1 reads the image and occupancy (value =
// image * occupancy).  At the levels whose order the caller does not know
// (bit l-1 of `count_mask`) each value sum that reaches 2^24 (where the
// orders can differ) adds one to a device counter.  Pull (levels L..0): a
// pixel with weight takes value / weight, one without its parent's fill;
// the coarsest level has no parent.  Level 0 writes the image where
// occupied, else the fill, rounded half to even (rintf) to int32.  Float
// operations are single IEEE roundings (built with --fmad=false), as the
// plain version computes them.
//
// Design: at most three launches a call, no host wait.  A level exists
// only while both sides are even, so 2^L divides H and W, and the levels a
// 2^T x 2^T tile of level 0 can finish alone (T = kTileLog = 5; t =
// min(L, T)) stay inside one block:
// 1. tile push: a block takes a region of 2^T x 2^T pixels, a thread a 2 x 4
//    unit read with 16-byte loads (image) and 4-byte loads (occupancy),
//    builds levels 1..t of the value and weight sums in shared memory, counts
//    the sums past 2^24, and writes level t's sums (one pixel a tile).  Under
//    one occupancy shared by the P planes the block builds the weight pyramid
//    once and loops over the planes, each plane's image read while the one
//    before it is reduced;
// 2. top: a block a plane pushes levels t+1..L from level t's plane (40 x 40
//    at 1280 x 1280) in shared memory (in global scratch where they do not
//    fit) and pulls back down to level t's fill;
// 3. tile pull: a block takes its region again, reads the top's fill of its
//    level-t pixel first, rebuilds levels 1..t-1 from the image and
//    occupancy (which it reads for level 0 anyway: an L2 hit after phase 1)
//    without counting, pulls down to level 0 and writes the int32 result
//    with 16-byte stores.  (Reading levels 1..t-1 back from phase 1 instead
//    would move more bytes than the rebuild's adds cost.)
// Where L <= T, one launch does it all (phase 1, "value / weight" at level
// L, phase 3); where L = 0 (an odd side) one launch writes the image where
// occupied, else 0.
//
// Bound: bytes.  The image and occupancy read once and the output written
// once; the level-t planes and the second read of the image (phase 3) stay
// in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;

constexpr float kExactLimit = 16777216.0f;  // 2^24

constexpr int kTopThreads = 512;

// T: the side of a tile block's region is 2^T (1,024 pixels, 128 threads;
// 2^6-pixel regions ran slower on every captured call)
constexpr int kTileLog = 5;

__device__ __forceinline__ float sum4(float a, float b, float c, float d, bool pair) {
  return pair ? __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d))
              : __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ void count_inexact(float v, int* inexact) {
  if (inexact != nullptr && v >= kExactLimit) atomicAdd(inexact, 1);
}

__device__ __forceinline__ float avg(float v, float w) {
  return __fdiv_rn(v, fmaxf(w, 1.0f));
}

// tile push; tile pull after the top kernel; both where L <= T
enum Mode { kPush = 0, kPull = 1, kWhole = 2 };

struct TileArgs {
  const int32_t* img;  // (P, H, W)
  const uint8_t* occ;  // (P, H, W) when occ_planar, else (H, W)
  int32_t* out;        // (P, H, W)
  float* vt;           // level t's value sums, (P, H >> t, W >> t)
  float* wt;           // level t's weight sums, one plane each or one for all
  const float* ft;     // level t's fill (the top's), (P, H >> t, W >> t)
  int* inexact;
  int P, occ_planar, H, W, L, t, pair_mask, count_mask, nrx;
};

// offset of level l (>= 1) in a region's pyramid of side S: the levels
// 1..l-1 before it, (S >> k)^2 pixels each
template <int S>
__device__ __forceinline__ int level_off(int l) {
  return (S * S - (S >> (l - 1)) * (S >> (l - 1))) / 3;
}

template <int UW, bool VEC>
__device__ __forceinline__ void load_unit(const int32_t* p, int W, int (&v)[2][UW],
                                          const uint8_t* q, float (&o)[2][UW], bool with_occ) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (VEC) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p + static_cast<size_t>(r) * W));
      v[r][0] = a.x;
      v[r][1] = a.y;
      v[r][2] = a.z;
      v[r][3] = a.w;
      if (with_occ) {
        const uint32_t b =
            __ldg(reinterpret_cast<const unsigned int*>(q + static_cast<size_t>(r) * W));
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = static_cast<float>((b >> (8 * c)) & 0xFFu);
      }
    } else {
#pragma unroll
      for (int c = 0; c < UW; ++c) {
        v[r][c] = p[static_cast<size_t>(r) * W + c];
        if (with_occ) o[r][c] = static_cast<float>(q[static_cast<size_t>(r) * W + c]);
      }
    }
  }
}

// Phases 1 and 3 (both: kWhole): a block a region of 2^T x 2^T pixels
// (clipped to the plane where L < T: its sides stay multiples of 2^t) of
// plane blockIdx.y, or of every plane under a shared occupancy; a thread a
// 2 x UW unit of it.
template <int T, int UW, bool VEC, int MODE>
__global__ void __launch_bounds__((1 << T) * (1 << T) / (2 * UW))
    tile_kernel(TileArgs a) {
  constexpr int S = 1 << T;
  constexpr int NT = S * S / (2 * UW);
  constexpr int UPR = S / UW;             // units a region row
  constexpr int NS = (S * S - 1) / 3;     // pixels of levels 1..T
  __shared__ float sv[NS];                // value sums, then fills
  __shared__ float sw[NS];                // weight sums
  const int t = a.t;
  const int ry = blockIdx.x / a.nrx;
  const int y0 = ry * S, x0 = (blockIdx.x - ry * a.nrx) * S;
  const int RH = min(S, a.H - y0), RW = min(S, a.W - x0);
  const int uy = threadIdx.x / UPR, ux = threadIdx.x - uy * UPR;
  const bool act = 2 * uy < RH && UW * ux < RW;
  const size_t HW = static_cast<size_t>(a.H) * a.W;
  const size_t pix = static_cast<size_t>(y0 + 2 * uy) * a.W + x0 + UW * ux;
  const int p0 = a.occ_planar ? blockIdx.y : 0;
  const int p1 = a.occ_planar ? p0 + 1 : a.P;
  constexpr bool pull = MODE == kPull;
  constexpr bool count = !pull;
  // the levels built in shared memory (the pull takes level t's fill from
  // the top)
  const int rebuilt = pull ? t - 1 : t;
  const int wt_w = a.W >> t;
  const size_t nt = static_cast<size_t>(a.H >> t) * wt_w;
  const size_t gt0 = static_cast<size_t>(y0 >> t) * wt_w + (x0 >> t);
  const int st = S >> t, ht = RH >> t, wtr = RW >> t;
  const int toff = level_off<S>(t);
  float o[2][UW];
  int im[2][UW];
  if (act) {
    load_unit<UW, VEC>(a.img + p0 * HW + pix, a.W, im,
                       a.occ + (a.occ_planar ? p0 * HW : 0) + pix, o, true);
  }
  for (int p = p0; p < p1; ++p) {
    const bool first = p == p0;
    // the pull's level-t fill (one pixel a region: L > T), read ahead
    float fill_t = 0.0f;
    if (pull && threadIdx.x == 0) fill_t = a.ft[p * nt + gt0];
    int nx[2][UW];  // the next plane's image, read ahead of this plane's levels
    if (act && p + 1 < p1) {
      load_unit<UW, VEC>(a.img + (p + 1) * HW + pix, a.W, nx, a.occ, o, false);
    }
    if (act) {
      const bool pair = a.pair_mask & 1;
      int* cnt = count && (a.count_mask & 1) ? a.inexact : nullptr;
#pragma unroll
      for (int k = 0; k < UW / 2; ++k) {
        const int c = 2 * k;
        const float v = sum4(__fmul_rn(static_cast<float>(im[0][c]), o[0][c]),
                             __fmul_rn(static_cast<float>(im[0][c + 1]), o[0][c + 1]),
                             __fmul_rn(static_cast<float>(im[1][c]), o[1][c]),
                             __fmul_rn(static_cast<float>(im[1][c + 1]), o[1][c + 1]), pair);
        const int i = uy * (S / 2) + (UW / 2) * ux + k;
        sv[i] = v;
        count_inexact(v, cnt);
        if (first) sw[i] = sum4(o[0][c], o[0][c + 1], o[1][c], o[1][c + 1], pair);
      }
    }
    __syncthreads();
    // levels 2..t in shared memory (the weights with the first plane only)
    for (int l = 2; l <= rebuilt; ++l) {
      const int s = S >> l, ps = 2 * s;
      const int off = level_off<S>(l), poff = level_off<S>(l - 1);
      const int h = RH >> l, w = RW >> l;
      const bool pair = (a.pair_mask >> (l - 1)) & 1;
      int* cnt = count && ((a.count_mask >> (l - 1)) & 1) ? a.inexact : nullptr;
      for (int i = threadIdx.x; i < h * w; i += NT) {
        const int y = i / w, x = i - y * w;
        const int q = poff + 2 * y * ps + 2 * x;
        const float v = sum4(sv[q], sv[q + 1], sv[q + ps], sv[q + ps + 1], pair);
        sv[off + y * s + x] = v;
        count_inexact(v, cnt);
        if (first) sw[off + y * s + x] = sum4(sw[q], sw[q + 1], sw[q + ps], sw[q + ps + 1], pair);
      }
      __syncthreads();
    }
    if constexpr (MODE == kPush) {
      for (int i = threadIdx.x; i < ht * wtr; i += NT) {
        const int y = i / wtr, x = i - y * wtr;
        const size_t g = gt0 + static_cast<size_t>(y) * wt_w + x;
        a.vt[p * nt + g] = sv[toff + y * st + x];
        if (first) a.wt[(a.occ_planar ? p : 0) * nt + g] = sw[toff + y * st + x];
      }
      __syncthreads();  // the next plane rewrites sv
#pragma unroll
      for (int y = 0; y < 2; ++y) {
#pragma unroll
        for (int c = 0; c < UW; ++c) im[y][c] = nx[y][c];
      }
      continue;
    }
    // pull: level t's fill over its value sums, then levels t-1..1
    if constexpr (pull) {
      if (threadIdx.x == 0) sv[toff] = fill_t;
    } else {
      for (int i = threadIdx.x; i < ht * wtr; i += NT) {
        const int j = toff + (i / wtr) * st + i % wtr;
        sv[j] = avg(sv[j], sw[j]);
      }
    }
    __syncthreads();
    for (int l = t - 1; l >= 1; --l) {
      const int s = S >> l, off = level_off<S>(l), poff = level_off<S>(l + 1);
      const int h = RH >> l, w = RW >> l;
      for (int i = threadIdx.x; i < h * w; i += NT) {
        const int y = i / w, x = i - y * w;
        const int j = off + y * s + x;
        const float wv = sw[j];
        sv[j] = wv > 0.0f ? avg(sv[j], wv) : sv[poff + (y >> 1) * (s >> 1) + (x >> 1)];
      }
      __syncthreads();
    }
    if (act) {
      int r[2][UW];
#pragma unroll
      for (int y = 0; y < 2; ++y) {
#pragma unroll
        for (int c = 0; c < UW; ++c) {
          const float f = o[y][c] > 0.0f ? static_cast<float>(im[y][c])
                                         : sv[uy * (S / 2) + (UW * ux + c) / 2];
          r[y][c] = static_cast<int32_t>(rintf(f));
        }
      }
      int32_t* q = a.out + p * HW + pix;
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        if constexpr (VEC) {
          *reinterpret_cast<int4*>(q + static_cast<size_t>(y) * a.W) =
              make_int4(r[y][0], r[y][1], r[y][2], r[y][3]);
        } else {
#pragma unroll
          for (int c = 0; c < UW; ++c) q[static_cast<size_t>(y) * a.W + c] = r[y][c];
        }
      }
    }
    __syncthreads();  // the next plane rewrites sv
#pragma unroll
    for (int y = 0; y < 2; ++y) {
#pragma unroll
      for (int c = 0; c < UW; ++c) im[y][c] = nx[y][c];
    }
  }
}

struct TopArgs {
  const float* vt;
  const float* wt;
  float* ft;
  float* gbuf;  // the levels above t in global memory (null: in shared memory)
  int* inexact;
  long long top_floats;  // floats of the levels above t, a plane
  int H, W, L, t, occ_planar, pair_mask, count_mask;
};

// The top: a block a plane.  Levels t+1..L (values, then weights, each
// level after the one below it) in `buf`; the fill overwrites the values.
__global__ void __launch_bounds__(kTopThreads) top_kernel(TopArgs a) {
  extern __shared__ float dsm[];
  const int p = blockIdx.x;
  float* buf = a.gbuf != nullptr ? a.gbuf + p * a.top_floats : dsm;
  const int wt_w = a.W >> a.t;
  const size_t nt = static_cast<size_t>(a.H >> a.t) * wt_w;
  const float* vt = a.vt + p * nt;
  const float* wt = a.wt + (a.occ_planar ? p : 0) * nt;
  const float* pv = vt;
  const float* pw = wt;
  int pwid = wt_w;
  size_t off = 0;
  for (int l = a.t + 1; l <= a.L; ++l) {
    const int w = a.W >> l;
    const int n = (a.H >> l) * w;
    float* V = buf + off;
    float* Wt = V + n;
    const bool pair = (a.pair_mask >> (l - 1)) & 1;
    int* cnt = (a.count_mask >> (l - 1)) & 1 ? a.inexact : nullptr;
    for (int i = threadIdx.x; i < n; i += kTopThreads) {
      const int y = i / w, x = i - y * w;
      const size_t q = static_cast<size_t>(2 * y) * pwid + 2 * x;
      const float v = sum4(pv[q], pv[q + 1], pv[q + pwid], pv[q + pwid + 1], pair);
      V[i] = v;
      count_inexact(v, cnt);
      Wt[i] = sum4(pw[q], pw[q + 1], pw[q + pwid], pw[q + pwid + 1], pair);
    }
    __syncthreads();
    pv = V;
    pw = Wt;
    pwid = w;
    off += 2 * static_cast<size_t>(n);
  }
  for (int l = a.L; l > a.t; --l) {
    const int w = a.W >> l;
    const int n = (a.H >> l) * w;
    off -= 2 * static_cast<size_t>(n);
    float* V = buf + off;
    const float* Wt = V + n;
    const float* par = V + 2 * n;  // level l + 1's fill
    for (int i = threadIdx.x; i < n; i += kTopThreads) {
      const int y = i / w, x = i - y * w;
      const float wv = Wt[i];
      V[i] = l == a.L || wv > 0.0f ? avg(V[i], wv) : par[(y >> 1) * (w >> 1) + (x >> 1)];
    }
    __syncthreads();
  }
  const int pw1 = a.W >> (a.t + 1);
  for (int i = threadIdx.x; i < static_cast<int>(nt); i += kTopThreads) {
    const int y = i / wt_w, x = i - y * wt_w;
    const float wv = wt[i];
    a.ft[p * nt + i] = wv > 0.0f ? avg(vt[i], wv) : buf[(y >> 1) * pw1 + (x >> 1)];
  }
}

// L = 0 (a side odd or 1): the image where occupied, else 0 / max(0, 1)
__global__ void copy_kernel(const int32_t* img, const uint8_t* occ, int occ_planar,
                            int32_t* out, long long HW, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float o = static_cast<float>(occ[occ_planar ? i : i % HW]);
    out[i] = o > 0.0f ? static_cast<int32_t>(rintf(static_cast<float>(img[i]))) : 0;
  }
}

// the launch plan of one call: levels, t, and the scratch floats (level t's
// values, weights and fill; the top's levels where they exceed top_smem
// bytes of shared memory)
struct Plan {
  int L, t, launches;
  long long nt, top_floats, scratch;
  bool global_top;
};

Plan make_plan(int P, int H, int W, int occ_planar, int top_smem) {
  Plan pl{};
  int h = H, w = W;
  while (h > 1 && w > 1 && h % 2 == 0 && w % 2 == 0 && pl.L + 1 < kMaxLevels) {
    h /= 2;
    w /= 2;
    ++pl.L;
  }
  pl.t = pl.L < kTileLog ? pl.L : kTileLog;
  pl.launches = 1;
  if (pl.L <= kTileLog) return pl;
  pl.launches = 3;
  pl.nt = static_cast<long long>(H >> pl.t) * (W >> pl.t);
  for (int l = pl.t + 1; l <= pl.L; ++l) pl.top_floats += 2LL * (H >> l) * (W >> l);
  pl.global_top = pl.top_floats * 4 > top_smem;
  pl.scratch = (2LL * P + (occ_planar ? P : 1)) * pl.nt + (pl.global_top ? P * pl.top_floats : 0);
  return pl;
}

template <int T, int UW, bool VEC, int MODE>
void launch_tile(const TileArgs& a, cudaStream_t st) {
  constexpr int S = 1 << T;
  const dim3 grid(a.nrx * ((a.H + S - 1) / S), a.occ_planar ? a.P : 1);
  tile_kernel<T, UW, VEC, MODE><<<grid, S * S / (2 * UW), 0, st>>>(a);
}

template <int T, int MODE>
void launch_tile(const TileArgs& a, bool vec, cudaStream_t st) {
  if (a.W % 4 != 0) {
    launch_tile<T, 2, false, MODE>(a, st);  // L = 1
  } else if (vec) {
    launch_tile<T, 4, true, MODE>(a, st);
  } else {
    launch_tile<T, 4, false, MODE>(a, st);
  }
}

}  // namespace

// Floats of scratch `push_pull` needs for this call (0 where L <= T), and
// its launches.
extern "C" int push_pull_scratch_floats(int P, int H, int W, int occ_planar, int top_smem) {
  return static_cast<int>(make_plan(P, H, W, occ_planar, top_smem).scratch);
}

extern "C" int push_pull_launches(int P, int H, int W, int occ_planar, int top_smem) {
  return make_plan(P, H, W, occ_planar, top_smem).launches;
}

// img/out: (P, H, W) int32; occ: (P, H, W) uint8 when occ_planar, else one
// (H, W) plane for all; scratch: float32, push_pull_scratch_floats of this
// call.  Bit l-1 of pair_mask: level l sums (a + b) + (c + d).  inexact:
// device int32 counter of the value sums reaching 2^24 at the levels of
// count_mask (null when count_mask is 0).  top_smem: the bytes of shared
// memory the top phase may take (above, its levels go to scratch).
// Launches: 1 where L <= T, else 3.
extern "C" int push_pull(const int32_t* img, const uint8_t* occ, float* scratch,
                         int32_t* out, int P, int occ_planar, int H, int W,
                         int pair_mask, int count_mask, int top_smem, int* inexact,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(P) * H * W == 0) return 0;
  if (P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(P, H, W, occ_planar, top_smem);
  if (pl.L == 0) {
    const long long n = static_cast<long long>(P) * H * W;
    const long long blocks = (n + 255) / 256;
    copy_kernel<<<static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20)), 256, 0, st>>>(
        img, occ, occ_planar, out, static_cast<long long>(H) * W, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int S = 1 << kTileLog;
  TileArgs a{img, occ, out, scratch, nullptr, nullptr, inexact, P, occ_planar, H, W, pl.L,
             pl.t, pair_mask, count_mask, (W + S - 1) / S};
  const bool vec = reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(occ) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (pl.L <= kTileLog) {
    launch_tile<kTileLog, kWhole>(a, vec, st);
    return static_cast<int>(cudaGetLastError());
  }
  a.wt = scratch + P * pl.nt;
  float* ft = a.wt + (occ_planar ? P : 1) * pl.nt;
  a.ft = ft;
  launch_tile<kTileLog, kPush>(a, vec, st);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  TopArgs ta{a.vt, a.wt, ft, pl.global_top ? ft + P * pl.nt : nullptr, inexact,
             pl.top_floats, H, W, pl.L, pl.t, occ_planar, pair_mask, count_mask};
  const size_t smem = pl.global_top ? 0 : static_cast<size_t>(pl.top_floats) * 4;
  if (smem > 48 * 1024) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (rc != 0) return rc;
  }
  top_kernel<<<P, kTopThreads, smem, st>>>(ta);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  launch_tile<kTileLog, kPull>(a, vec, st);
  return static_cast<int>(cudaGetLastError());
}
