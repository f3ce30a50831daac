// Kernel K: sample-adaptive offset (edge offset per 32x32 region; 16x16 in
// the two-level codec): search, apply, and both in one launch.
//
// Replaces the XLA programs vpcc_tpu/video/hevc.py `_sao_search_apply`
// (hevc.py:216, run on every encoded plane: the entry `sao_search_apply`)
// and `_sao_apply` (hevc.py:275, run on every decoded plane: `sao_apply`).
// The category of a sample under EO class (dy, dx) is sign(rec - a) +
// sign(rec - b) + 2 against its two neighbours along the class's axis,
// edge-replicated at the tile-plane border; 2 is flat.
//
// One block per (tile plane, region), R*R/4 threads, each a run of 4
// samples of one row (16-byte loads and stores: the wrapper requires
// 16-byte aligned planes whose width is a multiple of R):
//   stage     the region of `rec` with a 1-sample halo in shared memory,
//             the halo's coordinates clamped to the plane as the plain
//             version's edge padding is; each thread then holds the 3 x 6
//             samples around its run in registers;
//   count     (search) per class and non-flat category the weighted
//             samples n and their weighted error sum s = src - rec, in
//             int32 registers selected by unrolled compares (no array is
//             indexed at run time: n packed 8 bits a category, at most 128
//             a warp); one __reduce_add_sync per value and warp, the warps'
//             partials summed through shared memory.  |s| <= 1024 * 2047
//             < 2^31, and integer sums are exact in any order;
//   decide    (search) four threads, one a class, compute the offsets
//             o = clip(rint(s / max(n, 1)), -7, 7), the gain
//             (gain + (n*o)*o) - (2*o)*s and the cost fma(lam, 19, gain)
//             with the plain version's float operations in its order
//             (built with --fmad=false); every thread then scans the four
//             costs in class order with a strict < against the best so far
//             (0 = off), so the lower class wins a tie as in the plain
//             version;
//   apply     (apply, search_apply) the region's class and offsets on the
//             run, clipped to [0, maxval], one 16-byte store; a region
//             whose class is off skips the staging (decoder).
// No tensor core: the work is comparisons and integer counting, with no
// product to give one.
//
// Bound: bytes.  src, rec and the weights are read once and the output
// plane written once; the halo re-reads 4R+4 samples a region (13 % at
// R = 32) and the parameters are 5 bytes a region.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOffMax = 7;
enum Mode { kSearch = 0, kSearchApply = 1, kApply = 2 };

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// the category of sample k (0..3) of a thread's run under class C, from the
// rows above (up), at (mid) and below (dn) the run: index j holds column
// x_first - 1 + j
template <int C>
__device__ __forceinline__ int category(const int (&up)[6], const int (&mid)[6],
                                        const int (&dn)[6], int k) {
  const int v = mid[k + 1];
  int a, b;
  if (C == 0) {          // (0, 1)
    a = mid[k + 2];
    b = mid[k];
  } else if (C == 1) {   // (1, 0)
    a = dn[k + 1];
    b = up[k + 1];
  } else if (C == 2) {   // (1, 1)
    a = dn[k + 2];
    b = up[k];
  } else {               // (1, -1)
    a = dn[k];
    b = up[k + 2];
  }
  return sgn(v - a) + sgn(v - b) + 2;
}

// the offset of category `cat` from the region's four offsets (0 if flat)
__device__ __forceinline__ int offset_of(int cat, int o0, int o1, int o2, int o3) {
  return cat == 0 ? o0 : cat == 1 ? o1 : cat == 3 ? o2 : cat == 4 ? o3 : 0;
}

template <int C>
__device__ __forceinline__ void apply_run(const int (&up)[6], const int (&mid)[6],
                                          const int (&dn)[6], int o0, int o1, int o2,
                                          int o3, int mx, int4& res) {
  res.x = min(max(mid[1] + offset_of(category<C>(up, mid, dn, 0), o0, o1, o2, o3), 0), mx);
  res.y = min(max(mid[2] + offset_of(category<C>(up, mid, dn, 1), o0, o1, o2, o3), 0), mx);
  res.z = min(max(mid[3] + offset_of(category<C>(up, mid, dn, 2), o0, o1, o2, o3), 0), mx);
  res.w = min(max(mid[4] + offset_of(category<C>(up, mid, dn, 3), o0, o1, o2, o3), 0), mx);
}

// per class C: the run's counts (packed, 8 bits a slot) and error sums
template <int C>
__device__ __forceinline__ void count_class(const int (&up)[6], const int (&mid)[6],
                                            const int (&dn)[6], const int (&dw)[4],
                                            const bool (&on)[4], int& npk, int& s0, int& s1,
                                            int& s2, int& s3) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cat = category<C>(up, mid, dn, k);
    const bool use = on[k] && cat != 2;
    npk += use ? 1 << (8 * (cat - (cat > 2))) : 0;
    s0 += (use && cat == 0) ? dw[k] : 0;
    s1 += (use && cat == 1) ? dw[k] : 0;
    s2 += (use && cat == 3) ? dw[k] : 0;
    s3 += (use && cat == 4) ? dw[k] : 0;
  }
}

template <int R, int MODE>
__global__ void __launch_bounds__(R * R / 4)
sao_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ rec,
           const int32_t* __restrict__ wts, const float* __restrict__ lam,
           const int32_t* __restrict__ maxv, const int8_t* __restrict__ cls_in,
           const int8_t* __restrict__ off_in, int8_t* __restrict__ cls_out,
           int8_t* __restrict__ off_out, int32_t* __restrict__ out, int H, int W) {
  constexpr int T = R * R / 4;       // threads: a run of 4 samples each
  constexpr int NW = T / 32;         // warps
  constexpr int RUNS = R / 4;        // runs a row
  __shared__ int tile[R + 2][R + 2];
  __shared__ int part[NW][32];
  __shared__ int tot[32];
  __shared__ float cost_s[4];
  __shared__ int offs_s[4][4];

  const int rx_n = W / R;
  const int ry = blockIdx.x / rx_n, rx = blockIdx.x % rx_n;
  const int p = blockIdx.y;
  const size_t plane = static_cast<size_t>(p) * H * W;
  const size_t reg = (static_cast<size_t>(p) * (H / R) + ry) * rx_n + rx;
  const int t = threadIdx.x;
  const int ly = t / RUNS, lx = 4 * (t % RUNS);
  const int y0 = ry * R, x0 = rx * R;
  const size_t q = plane + static_cast<size_t>(y0 + ly) * W + x0 + lx;
  const int4 v4 = *reinterpret_cast<const int4*>(rec + q);

  int cls = 0, o0 = 0, o1 = 0, o2 = 0, o3 = 0;
  if (MODE == kApply) {
    cls = cls_in[reg];
    if (cls == 0) {   // off: the plain version still clips to [0, maxval]
      const int mx = maxv[p];
      *reinterpret_cast<int4*>(out + q) = make_int4(
          min(max(v4.x, 0), mx), min(max(v4.y, 0), mx), min(max(v4.z, 0), mx),
          min(max(v4.w, 0), mx));
      return;
    }
    o0 = off_in[reg * 4];
    o1 = off_in[reg * 4 + 1];
    o2 = off_in[reg * 4 + 2];
    o3 = off_in[reg * 4 + 3];
  }

  // stage: the interior from the runs, then the halo ring, clamped
  tile[ly + 1][lx + 1] = v4.x;
  tile[ly + 1][lx + 2] = v4.y;
  tile[ly + 1][lx + 3] = v4.z;
  tile[ly + 1][lx + 4] = v4.w;
  const int32_t* r = rec + plane;
  for (int h = t; h < 4 * R + 4; h += T) {
    int ty, tx;
    if (h < R + 2) {
      ty = 0;
      tx = h;
    } else if (h < 2 * (R + 2)) {
      ty = R + 1;
      tx = h - (R + 2);
    } else {
      const int h2 = h - 2 * (R + 2);
      ty = 1 + (h2 >> 1);
      tx = (h2 & 1) ? R + 1 : 0;
    }
    const int gy = min(max(y0 - 1 + ty, 0), H - 1);
    const int gx = min(max(x0 - 1 + tx, 0), W - 1);
    tile[ty][tx] = r[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
  int up[6], mid[6], dn[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    up[j] = tile[ly][lx + j];
    mid[j] = tile[ly + 1][lx + j];
    dn[j] = tile[ly + 2][lx + j];
  }

  if (MODE != kApply) {
    const int4 s4 = *reinterpret_cast<const int4*>(src + q);
    const int4 w4 = *reinterpret_cast<const int4*>(wts + q);
    const bool on[4] = {w4.x != 0, w4.y != 0, w4.z != 0, w4.w != 0};
    const int dw[4] = {on[0] ? s4.x - v4.x : 0, on[1] ? s4.y - v4.y : 0,
                       on[2] ? s4.z - v4.z : 0, on[3] ? s4.w - v4.w : 0};
    int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
    int s00 = 0, s01 = 0, s02 = 0, s03 = 0, s10 = 0, s11 = 0, s12 = 0, s13 = 0;
    int s20 = 0, s21 = 0, s22 = 0, s23 = 0, s30 = 0, s31 = 0, s32 = 0, s33 = 0;
    count_class<0>(up, mid, dn, dw, on, n0, s00, s01, s02, s03);
    count_class<1>(up, mid, dn, dw, on, n1, s10, s11, s12, s13);
    count_class<2>(up, mid, dn, dw, on, n2, s20, s21, s22, s23);
    count_class<3>(up, mid, dn, dw, on, n3, s30, s31, s32, s33);
    const unsigned full = 0xffffffffu;
#define SAO_RED(x) x = __reduce_add_sync(full, x)
    SAO_RED(n0); SAO_RED(n1); SAO_RED(n2); SAO_RED(n3);
    SAO_RED(s00); SAO_RED(s01); SAO_RED(s02); SAO_RED(s03);
    SAO_RED(s10); SAO_RED(s11); SAO_RED(s12); SAO_RED(s13);
    SAO_RED(s20); SAO_RED(s21); SAO_RED(s22); SAO_RED(s23);
    SAO_RED(s30); SAO_RED(s31); SAO_RED(s32); SAO_RED(s33);
#undef SAO_RED
    if ((t & 31) == 0) {
      int* pw = part[t >> 5];
      const int np[4] = {n0, n1, n2, n3};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) pw[c * 4 + k] = (np[c] >> (8 * k)) & 255;
      }
      const int sv[16] = {s00, s01, s02, s03, s10, s11, s12, s13,
                          s20, s21, s22, s23, s30, s31, s32, s33};
#pragma unroll
      for (int k = 0; k < 16; ++k) pw[16 + k] = sv[k];
    }
    __syncthreads();
    if (t < 32) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc += part[w][t];
      tot[t] = acc;
    }
    __syncthreads();
    if (t < 4) {   // class t: offsets, gain and cost, float ops as the plain version
      float gain = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float n = static_cast<float>(tot[t * 4 + k]);
        const float s = static_cast<float>(tot[16 + t * 4 + k]);
        float o = rintf(__fdiv_rn(s, fmaxf(n, 1.0f)));
        o = fminf(fmaxf(o, -static_cast<float>(kOffMax)), static_cast<float>(kOffMax));
        gain = __fsub_rn(__fadd_rn(gain, __fmul_rn(__fmul_rn(n, o), o)),
                         __fmul_rn(__fmul_rn(2.0f, o), s));
        offs_s[t][k] = static_cast<int>(o);
      }
      cost_s[t] = __fmaf_rn(lam[p], 19.0f, gain);
    }
    __syncthreads();
    // the plain version's scan: the first class strictly below the best
    float best = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (cost_s[c] < best) {
        best = cost_s[c];
        cls = c + 1;
      }
    }
    if (cls > 0) {
      o0 = offs_s[cls - 1][0];
      o1 = offs_s[cls - 1][1];
      o2 = offs_s[cls - 1][2];
      o3 = offs_s[cls - 1][3];
    }
    if (t == 0) {
      cls_out[reg] = static_cast<int8_t>(cls);
      off_out[reg * 4] = static_cast<int8_t>(o0);
      off_out[reg * 4 + 1] = static_cast<int8_t>(o1);
      off_out[reg * 4 + 2] = static_cast<int8_t>(o2);
      off_out[reg * 4 + 3] = static_cast<int8_t>(o3);
    }
  }

  if (MODE != kSearch) {
    const int mx = maxv[p];
    int4 res;
    switch (cls) {
      case 1: apply_run<0>(up, mid, dn, o0, o1, o2, o3, mx, res); break;
      case 2: apply_run<1>(up, mid, dn, o0, o1, o2, o3, mx, res); break;
      case 3: apply_run<2>(up, mid, dn, o0, o1, o2, o3, mx, res); break;
      case 4: apply_run<3>(up, mid, dn, o0, o1, o2, o3, mx, res); break;
      default:
        res = make_int4(min(max(v4.x, 0), mx), min(max(v4.y, 0), mx),
                        min(max(v4.z, 0), mx), min(max(v4.w, 0), mx));
    }
    *reinterpret_cast<int4*>(out + q) = res;
  }
}

template <int MODE>
int launch(const int32_t* src, const int32_t* rec, const int32_t* wts, const float* lam,
           const int32_t* maxv, const int8_t* cls_in, const int8_t* off_in,
           int8_t* cls_out, int8_t* off_out, int32_t* out, int P, int H, int W,
           int region, void* stream) {
  if (P == 0 || H == 0 || W == 0) return 0;
  if (H % region || W % region) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H / region) * (W / region), P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (region == 32) {
    sao_kernel<32, MODE><<<grid, 256, 0, st>>>(src, rec, wts, lam, maxv, cls_in, off_in,
                                               cls_out, off_out, out, H, W);
  } else if (region == 16) {
    sao_kernel<16, MODE><<<grid, 64, 0, st>>>(src, rec, wts, lam, maxv, cls_in, off_in,
                                              cls_out, off_out, out, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src/rec/wts: (P, H, W) int32 (wts 0/1); lam: (P,) float32; cls_out
// (P, H/region, W/region) int8; off_out (P, H/region, W/region, 4) int8.
// region 16 or 32; planes 16-byte aligned.
extern "C" int sao_search(const int32_t* src, const int32_t* rec,
                          const int32_t* wts, const float* lam, int8_t* cls_out,
                          int8_t* off_out, int P, int H, int W, int region,
                          void* stream) {
  return launch<kSearch>(src, rec, wts, lam, nullptr, nullptr, nullptr, cls_out, off_out,
                         nullptr, P, H, W, region, stream);
}

// rec/out: (P, H, W) int32; cls/off as sao_search writes them; maxv (P,).
extern "C" int sao_apply(const int32_t* rec, const int8_t* cls, const int8_t* off,
                         const int32_t* maxv, int32_t* out, int P, int H, int W,
                         int region, void* stream) {
  return launch<kApply>(nullptr, rec, nullptr, nullptr, maxv, cls, off, nullptr, nullptr,
                        out, P, H, W, region, stream);
}

// sao_search and sao_apply in one launch: the parameters and the applied
// planes `out` (P, H, W) int32.
extern "C" int sao_search_apply(const int32_t* src, const int32_t* rec,
                                const int32_t* wts, const float* lam,
                                const int32_t* maxv, int32_t* out, int8_t* cls_out,
                                int8_t* off_out, int P, int H, int W, int region,
                                void* stream) {
  return launch<kSearchApply>(src, rec, wts, lam, maxv, nullptr, nullptr, cls_out, off_out,
                              out, P, H, W, region, stream);
}
