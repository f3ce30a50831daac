// Kernel I: wavefront rate-distortion encode of the three-level (32/16/8)
// CU quadtree, and (entry `wavefront_encode16`) of the two-level (16/8) one.
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_build_encode32.run`
// (hevc.py:933-1114, with `_code_cu16` 745, `_rd_choose` 125,
// `_predict_all` 94, `_int_recon` 113): for every 32x32 CU choose, by
// transform-domain RD cost over the 36 prediction modes (35 intra + inter),
// between the whole 32x32 block and four 16x16 quadrants, each whole or as
// four 8x8 blocks; emit the syntax and the int32 reconstruction.  The
// two-level entry replaces `_build_encode.run` (hevc.py:792-929, the codec
// of planes whose maxval is above 1023): the same 16x16-or-four-8x8 step on
// a wavefront of 16x16 CUs, whose diagonals count 16x16 CUs (the device
// functions below take the CU size as a template argument).  The reference
// compiles `_code_cu16` into that program anew; see video/hevc.py's
// section comment for the float order found there.
//
// Design.  As kernel A (wavefront_decode32.cu): CUs on a wavefront diagonal
// d = 2*by + bx are independent, so the host launches one grid per
// diagonal, one block per (tile plane, CU), 1024 threads; the CU's samples
// live in shared memory and the quadtree is walked in z-order.  Reference
// samples are the natural neighbours (inside the CU: the samples coded so
// far, else the init value; outside: the plane where that CU lies on an
// earlier diagonal, else the init value); bottom-left samples are the init
// value except for the first two 8x8 blocks of a quadrant.  The 8x8 blocks
// of a quadrant are coded in place in the CU buffer; if the whole 16x16
// block wins, its reconstruction overwrites them.
//
// Mode evaluation.  A block of n x n takes 1024 / (n*n) modes at a time,
// one thread per (mode, sample): prediction (planar/DC by formula, angular
// from the 2-tap tables, inter from the motion-compensated plane; equal to
// the reference's prediction matrix), residual, the orthonormal DCT in the
// order of XLA's CPU dots (u[i,k] = sum_j Cf[i,j] r[j,k], then c[i,l] =
// sum_k u[i,k] Cf[l,k]; each sum as two (n = 32) or four (n <= 16)
// interleaved fma chains, `dct_dot`), lv = min(floor(fma(|c|, 1/qstep,
// 0.33)), 32767),
// the distortion term d*d with d = fma(-lv, qstep, |c|), the rate term of
// lv from the table of the reference's values, their sums in the order of
// XLA's vectorized CPU reduce loops (32x32: row by row, an 8-lane vector
// [running sum, 0 x 7] takes the row's four vectors, then lanes 0-3 + 4-7,
// 0-1 + 2-3, 0 + 1; 16x16 and 8x8: eight lanes over the rows, lane k takes
// rows k, k + 8, ... column by column, then the same tree; d*d as fused
// multiply-adds) and the max scan position of a nonzero level (a tree).
// These orders were read off the reference's CPU program by probing it
// with crafted inputs (tests/test_torch_video_encode.py holds a 32x32 tie
// that only this order resolves as the reference does).
// cost = fma(lam, fma(0.12, last + 1, bits) + mode_bits, w * dist) (+ the
// inter penalty): XLA's CPU program contracts the rate product, not the
// distortion product, into the fused multiply-add (found on a 32x32 CU of
// the bench GOF whose two angular modes tie under the other contraction).  The first minimum over ascending modes wins (strict <).
// The winner's levels are recomputed for the syntax and the integer
// reconstruction, which runs in wrapping 32-bit arithmetic as kernel A's.
// The plain version (hevc.py `wavefront_encode32_plain`) evaluates the
// same float operations in the same order; built with --fmad=false so that
// no other contraction happens.
//
// Bound: operations.  Per CU and mode level the two DCT stages cost 2n
// multiply-adds per sample for each of the 36 modes, at 32, 16 and 8: about
// 36 * 2 * 1024 * (32 + 16 + 8) multiply-adds per CU (two-level: 36 * 2 *
// 256 * (16 + 8) per 16x16 CU).  The wavefront's sequential diagonals (22
// at 8 x 8 CUs per tile; two-level: 46 at 16 x 16) leave most SMs idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// int blob (hevc.py `_tables`): T32 T16 T8 | izz32 izz16 izz8 | taps | zz
constexpr int OFF_T32 = 0;
constexpr int OFF_T16 = OFF_T32 + 32 * 32;
constexpr int OFF_T8 = OFF_T16 + 16 * 16;
constexpr int OFF_ZZ32 = OFF_T8 + 8 * 8;          // inverse zigzags
constexpr int OFF_ZZ16 = OFF_ZZ32 + 32 * 32;
constexpr int OFF_ZZ8 = OFF_ZZ16 + 16 * 16;
constexpr int OFF_A32 = OFF_ZZ8 + 8 * 8;
constexpr int OFF_A16 = OFF_A32 + 33 * 32 * 32 * 4;
constexpr int OFF_A8 = OFF_A16 + 33 * 16 * 16 * 4;
constexpr int OFF_FZ32 = OFF_A8 + 33 * 8 * 8 * 4;  // forward zigzags
constexpr int OFF_FZ16 = OFF_FZ32 + 32 * 32;
constexpr int OFF_FZ8 = OFF_FZ16 + 16 * 16;
// float blob: Cf32 Cf16 Cf8 | mode bits (36) | rate term per level
constexpr int FOFF_CF32 = 0;
constexpr int FOFF_CF16 = 1024;
constexpr int FOFF_CF8 = 1280;
constexpr int FOFF_MB = 1344;
constexpr int FOFF_BITS = FOFF_MB + 36;
constexpr int N_MODES = 36;
constexpr int MODE_INTER = 35;
constexpr float LEVEL_MAX = 32767.0f;

struct Ctx {
  const int32_t* rec;  // this tile plane's reconstruction (earlier diagonals)
  const int32_t* ref;  // this tile plane's inter prediction samples
  const int32_t* itab;
  const float* ftab;
  int Wt, nbx, nby, d, by, bx, y0, x0, init, maxv, dq;
  float qstep, inv_q, lam;
};

struct Smem {
  int cur[1024];     // the CU's samples coded so far (init elsewhere)
  int src[1024];     // the CU's source samples
  int refv[4 * 32 + 1];
  float R[1024];     // residuals; integer scratch of the reconstruction
  float T1[1024];    // first DCT stage; integer scratch of the reconstruction
  float D[1024];     // distortion terms
  float Bt[1024];    // rate terms
  int Lz[1024];      // scan position of nonzero levels
  int lev[1024];     // the chosen mode's raster levels
  int pred[1024];    // the chosen mode's prediction
  int c8[256];       // a quadrant's four 8x8 zigzag level blocks
  float cf[1344];    // Cf32 Cf16 Cf8
  float cost[16];
  int m8[4];
  int best_mode;
  float best_cost;
};

// sample at (yy, xx) relative to the origin of a CU of CUS x CUS samples,
// as the reference sees it: inside the CU the samples coded so far (init
// elsewhere); outside, the plane where that CU lies on an earlier wavefront
// diagonal of CUS-sized CUs, else the init value
template <int CUS>
__device__ __forceinline__ int fetch(const Ctx& c, const int* cur, int yy, int xx) {
  constexpr int SH = CUS == 32 ? 5 : 4;
  if (yy >= 0 && yy < CUS && xx >= 0 && xx < CUS) return cur[yy * CUS + xx];
  const int cy = c.by + (yy >> SH);
  const int cx = c.bx + (xx >> SH);
  if (cy < 0 || cx < 0 || cx >= c.nbx || cy >= c.nby || 2 * cy + cx >= c.d)
    return c.init;
  return c.rec[(c.y0 + yy) * c.Wt + (c.x0 + xx)];
}

__device__ __forceinline__ int predict(const Ctx& c, const int* refv,
                                       const int32_t* taps, int n, int log2n,
                                       int mode, int y, int x, int oy, int ox) {
  if (mode == 0) {  // planar
    return ((n - 1 - x) * refv[2 * n + 1 + y] + (x + 1) * refv[n + 1] +
            (n - 1 - y) * refv[1 + x] + (y + 1) * refv[3 * n + 1] + n) >>
           (log2n + 1);
  }
  if (mode == 1) {  // DC over the n top and n left samples
    int s = 0;
    for (int q = 0; q < n; ++q) s += refv[1 + q] + refv[2 * n + 1 + q];
    return (s + n) >> (log2n + 1);
  }
  if (mode == MODE_INTER) return c.ref[(c.y0 + oy + y) * c.Wt + (c.x0 + ox + x)];
  const int32_t* a = taps + ((mode - 2) * n * n + y * n + x) * 4;
  return (a[2] * refv[a[0]] + a[3] * refv[a[1]] + 16) >> 5;
}

__device__ __forceinline__ const int32_t* taps_of(const Ctx& c, int n) {
  return c.itab + (n == 32 ? OFF_A32 : n == 16 ? OFF_A16 : OFF_A8);
}

__device__ __forceinline__ const float* cf_of(const Smem& s, int n) {
  return s.cf + (n == 32 ? FOFF_CF32 : n == 16 ? FOFF_CF16 : FOFF_CF8);
}

// reference vector of the n x n block at (oy, ox) (all threads call)
template <int CUS>
__device__ void load_refs(const Ctx& c, Smem& s, int n, int oy, int ox, bool bl_init) {
  const int t = threadIdx.x;
  if (t < 4 * n + 1) {
    int v;
    if (t == 0) v = fetch<CUS>(c, s.cur, oy - 1, ox - 1);
    else if (t <= 2 * n) v = fetch<CUS>(c, s.cur, oy - 1, ox + t - 1);
    else if (t <= 3 * n || !bl_init) v = fetch<CUS>(c, s.cur, oy + t - 2 * n - 1, ox - 1);
    else v = c.init;
    s.refv[t] = v;
  }
  __syncthreads();
}

// sum_j a[j * sa] * b[j * sb] over n terms in the order of XLA's CPU dot:
// for n = 32 two interleaved fused multiply-add chains (even and odd j),
// then even + odd; for n <= 16 four (j mod 4), then (0 + 1) + (2 + 3).  The
// first term of each chain is a plain product (an fma with 0).
__device__ __forceinline__ float dct_dot(const float* a, int sa, const float* b, int sb,
                                         int n) {
  if (n == 32) {
    float e = __fmul_rn(a[0], b[0]);
    float o = __fmul_rn(a[sa], b[sb]);
    for (int j = 2; j < 32; j += 2) {
      e = __fmaf_rn(a[j * sa], b[j * sb], e);
      o = __fmaf_rn(a[(j + 1) * sa], b[(j + 1) * sb], o);
    }
    return __fadd_rn(e, o);
  }
  float q[4];
  for (int j = 0; j < 4; ++j) q[j] = __fmul_rn(a[j * sa], b[j * sb]);
  for (int j = 4; j < n; ++j) q[j & 3] = __fmaf_rn(a[j * sa], b[j * sb], q[j & 3]);
  return __fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3]));
}

// forward DCT of the residual in s.R (segment g of nn samples): returns c
// for thread (g, p).  XLA contracts the row index first: u[i, k] = sum_j
// Cf[i, j] r[j, k], then c[i, l] = sum_k u[i, k] Cf[l, k].  All threads
// call.
__device__ float dct_coef(Smem& s, int n, int g, int p, bool active) {
  const int nn = n * n;
  const float* Cf = cf_of(s, n);
  const int t = threadIdx.x;
  if (active) {
    const int i = p / n, k = p % n;
    s.T1[t] = dct_dot(Cf + i * n, 1, s.R + g * nn + k, n, n);
  }
  __syncthreads();
  float acc = 0.0f;
  if (active) {
    const int i = p / n, l = p % n;
    acc = dct_dot(s.T1 + g * nn + i * n, 1, Cf + l * n, 1, n);
  }
  return acc;
}

__device__ __forceinline__ float quant(const Ctx& c, float ca) {
  return fminf(floorf(__fmaf_rn(ca, c.inv_q, 0.33f)), LEVEL_MAX);
}

// RD search over the 36 modes of the n x n block at (oy, ox); refs loaded.
// Leaves the first minimum in s.best_mode / s.best_cost.  All threads call.
template <int CUS>
__device__ void eval_modes(const Ctx& c, Smem& s, int n, int log2n, int oy, int ox,
                           float w, float pen) {
  const int nn = n * n;
  const int G = 1024 / nn;
  const int t = threadIdx.x;
  const int g = t / nn, p = t % nn;
  const int32_t* taps = taps_of(c, n);
  const int32_t* izz = c.itab + (n == 32 ? OFF_ZZ32 : n == 16 ? OFF_ZZ16 : OFF_ZZ8);
  const float* bits_tab = c.ftab + FOFF_BITS;
  if (t == 0) {
    s.best_mode = 0;
    s.best_cost = __int_as_float(0x7f800000);  // +inf
  }
  for (int m0 = 0; m0 < N_MODES; m0 += G) {
    const int m = m0 + g;
    const bool active = m < N_MODES;
    if (active) {
      const int y = p / n, x = p % n;
      const int pr = predict(c, s.refv, taps, n, log2n, m, y, x, oy, ox);
      s.R[t] = static_cast<float>(s.src[(oy + y) * CUS + ox + x] - pr);
    }
    __syncthreads();
    const float cv = dct_coef(s, n, g, p, active);
    if (active) {
      const float ca = fabsf(cv);
      const float lv = quant(c, ca);
      s.D[t] = __fmaf_rn(-lv, c.qstep, ca);  // d; the sum takes d*d
      s.Bt[t] = bits_tab[static_cast<int>(lv)];
      s.Lz[t] = lv > 0.0f ? izz[p] : -1;
    }
    __syncthreads();
    for (int h = nn / 2; h >= 1; h >>= 1) {
      if (active && p < h) s.Lz[t] = max(s.Lz[t], s.Lz[t + h]);
      __syncthreads();
    }
    // the distortion and rate sums in the order of XLA's reduce loops (see
    // the header), into R / T1 (free after the transform) and then one
    // thread per mode
    const int nv = n / 8;
    float dist = 0.0f, bsum = 0.0f;
    if (n == 32) {
      // per row an 8-lane vector [running sum, 0 x 7] takes the row's four
      // vectors, then lanes 0-3 + 4-7, 0-1 + 2-3, 0 + 1: lanes 1-7 of every
      // row first, one thread per (row, lane); lane 0 and the trees down the
      // rows on one thread
      if (t < n * 8) {
        const int r = t >> 3, k = t & 7;
        float ld = 0.0f, lb = 0.0f;
        if (k != 0 && active) {
          const int base = r * n + k;
          for (int u = 0; u < nv; ++u) {
            const float e = s.D[base + 8 * u];
            ld = __fmaf_rn(e, e, ld);
            lb = __fadd_rn(lb, s.Bt[base + 8 * u]);
          }
        }
        s.R[t] = ld;
        s.T1[t] = lb;
      }
      __syncthreads();
      if (t == 0 && active) {
        for (int r = 0; r < n; ++r) {
          for (int u = 0; u < nv; ++u) {
            const float e = s.D[r * n + 8 * u];
            dist = __fmaf_rn(e, e, dist);
            bsum = __fadd_rn(bsum, s.Bt[r * n + 8 * u]);
          }
          const float* l = s.R + r * 8;
          const float* lb = s.T1 + r * 8;
          dist = __fadd_rn(__fadd_rn(__fadd_rn(dist, l[4]), __fadd_rn(l[2], l[6])),
                           __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
          bsum = __fadd_rn(__fadd_rn(__fadd_rn(bsum, lb[4]), __fadd_rn(lb[2], lb[6])),
                           __fadd_rn(__fadd_rn(lb[1], lb[5]), __fadd_rn(lb[3], lb[7])));
        }
      }
    } else {
      // eight lanes over the rows (lane k takes rows k, k + 8, ..., each
      // column by column), one thread per (mode, lane); then the tree
      if (t < G * 8) {
        const int gg = t >> 3, k = t & 7;
        float ld = 0.0f, lb = 0.0f;
        if (m0 + gg < N_MODES) {
          for (int i0 = 0; i0 < nv; ++i0) {
            const int base = gg * nn + (i0 * 8 + k) * n;
            for (int col = 0; col < n; ++col) {
              const float e = s.D[base + col];
              ld = __fmaf_rn(e, e, ld);
              lb = __fadd_rn(lb, s.Bt[base + col]);
            }
          }
        }
        s.R[t] = ld;
        s.T1[t] = lb;
      }
      __syncthreads();
      if (t < G && m0 + t < N_MODES) {
        const float* l = s.R + t * 8;
        const float* lb = s.T1 + t * 8;
        dist = __fadd_rn(__fadd_rn(__fadd_rn(l[0], l[4]), __fadd_rn(l[2], l[6])),
                         __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
        bsum = __fadd_rn(__fadd_rn(__fadd_rn(lb[0], lb[4]), __fadd_rn(lb[2], lb[6])),
                         __fadd_rn(__fadd_rn(lb[1], lb[5]), __fadd_rn(lb[3], lb[7])));
      }
    }
    // thread gm holds mode m0 + gm's sums (n = 32: thread 0, G = 1)
    if (t < G && m0 + t < N_MODES) {
      const int mm = m0 + t;
      const float bits = __fmaf_rn(0.12f, static_cast<float>(s.Lz[t * nn] + 1), bsum);
      const float wd = __fmul_rn(w, dist);
      float cost = __fmaf_rn(c.lam, __fadd_rn(bits, c.ftab[FOFF_MB + mm]), wd);
      if (mm == MODE_INTER) cost = __fadd_rn(cost, pen);
      s.cost[t] = cost;
    }
    __syncthreads();
    if (t == 0) {
      for (int q = 0; q < G && m0 + q < N_MODES; ++q) {
        if (s.cost[q] < s.best_cost) {
          s.best_cost = s.cost[q];
          s.best_mode = m0 + q;
        }
      }
    }
    __syncthreads();
  }
}

// raster levels and prediction of `mode` for the n x n block at (oy, ox)
// into s.lev / s.pred; refs loaded.  All threads call.
template <int CUS>
__device__ void mode_levels(const Ctx& c, Smem& s, int n, int log2n, int oy, int ox,
                            int mode) {
  const int nn = n * n;
  const int t = threadIdx.x;
  const bool active = t < nn;
  if (active) {
    const int y = t / n, x = t % n;
    const int pr = predict(c, s.refv, taps_of(c, n), n, log2n, mode, y, x, oy, ox);
    s.pred[t] = pr;
    s.R[t] = static_cast<float>(s.src[(oy + y) * CUS + ox + x] - pr);
  }
  __syncthreads();
  const float cv = dct_coef(s, n, 0, t, active);
  if (active) {
    const float lv = quant(c, fabsf(cv));
    const float sg = cv > 0.0f ? 1.0f : (cv < 0.0f ? -1.0f : 0.0f);
    s.lev[t] = static_cast<int>(sg * lv);
  }
  __syncthreads();
}

// integer reconstruction of s.lev / s.pred into the CU buffer at (oy, ox):
// dequantise, inverse transform in wrapping 32-bit arithmetic, add the
// prediction, clip.  All threads call.
template <int CUS>
__device__ void reconstruct(const Ctx& c, Smem& s, int n, int log2n, int oy, int ox) {
  const int nn = n * n;
  const int t = threadIdx.x;
  const int* T = c.itab + (n == 32 ? OFF_T32 : n == 16 ? OFF_T16 : OFF_T8);
  int* coef = reinterpret_cast<int*>(s.R);
  int* tmp = reinterpret_cast<int*>(s.T1);
  if (t < nn) {
    const int dv = s.lev[t] * c.dq;
    coef[t] = min(max(dv, -(1 << 19)), (1 << 19) - 1);
  }
  __syncthreads();
  const int i = t / n, k = t % n;
  if (t < nn) {
    uint32_t acc = 0;
    for (int j = 0; j < n; ++j)
      acc += static_cast<uint32_t>(T[j * n + i]) * static_cast<uint32_t>(coef[j * n + k]);
    acc += 1u << 10;
    tmp[t] = static_cast<int32_t>(acc) >> 11;
  }
  __syncthreads();
  if (t < nn) {
    const int s2 = 7 + log2n;
    uint32_t acc = 0;
    for (int j = 0; j < n; ++j)
      acc += static_cast<uint32_t>(tmp[i * n + j]) * static_cast<uint32_t>(T[j * n + k]);
    acc += 1u << (s2 - 1);
    const int r = static_cast<int32_t>(acc) >> s2;
    s.cur[(oy + i) * CUS + ox + k] = min(max(s.pred[t] + r, 0), c.maxv);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
wavefront_encode32_kernel(const int32_t* src, const int32_t* ref, const float* w32,
                          const float* w16, const float* w8, const float* mvc,
                          const float* qstep, const float* inv_q, const float* lam,
                          const float* pen, const int32_t* dq, const int32_t* maxv,
                          const int32_t* itab, const float* ftab, int8_t* s32_o,
                          int8_t* m32_o, int16_t* c32_o, int8_t* s16_o,
                          int8_t* modes_o, int16_t* c16_o, int32_t* rec, int nby,
                          int nbx, int d, int by_min) {
  __shared__ Smem s;
  const int p = blockIdx.y;
  const int by = by_min + blockIdx.x;
  const int bx = d - 2 * by;
  if (by >= nby || bx < 0 || bx >= nbx) return;  // uniform per block
  const int Ht = nby * 32, Wt = nbx * 32;
  const size_t plane = static_cast<size_t>(p) * Ht * Wt;
  Ctx c;
  c.rec = rec + plane;
  c.ref = ref + plane;
  c.itab = itab;
  c.ftab = ftab;
  c.Wt = Wt;
  c.nbx = nbx;
  c.nby = nby;
  c.d = d;
  c.by = by;
  c.bx = bx;
  c.y0 = by * 32;
  c.x0 = bx * 32;
  c.maxv = maxv[p];
  c.init = (c.maxv + 1) / 2;
  c.dq = dq[p];
  c.qstep = qstep[p];
  c.inv_q = inv_q[p];
  c.lam = lam[p];
  const int t = threadIdx.x;
  const size_t cu = static_cast<size_t>(p) * nby * nbx + by * nbx + bx;
  s.cur[t] = c.init;
  s.src[t] = src[plane + (c.y0 + t / 32) * Wt + c.x0 + t % 32];
  for (int i = t; i < 1344; i += 1024) s.cf[i] = ftab[FOFF_CF32 + i];
  __syncthreads();
  const float pen32 = __fadd_rn(pen[p], mvc[cu]);
  const float mvc16 = __fmul_rn(0.25f, mvc[cu]);
  const float pen16 = __fadd_rn(pen[p], mvc16);
  const float pen8 = __fadd_rn(pen[p], __fmul_rn(0.25f, mvc16));
  const int32_t* fz16 = itab + OFF_FZ16;
  const int32_t* fz8 = itab + OFF_FZ8;

  // ---- whole-32 candidate
  load_refs<32>(c, s, 32, 0, 0, true);
  eval_modes<32>(c, s, 32, 5, 0, 0, w32[cu], pen32);
  const int m32 = s.best_mode;
  const float cost32 = s.best_cost;
  float cs32 = c.lam;

  // ---- four 16-quadrants
  for (int q = 0; q < 4; ++q) {
    const int qy = (q >> 1) * 16, qx = (q & 1) * 16;
    const size_t cq = cu * 4 + q;
    load_refs<32>(c, s, 16, qy, qx, true);
    eval_modes<32>(c, s, 16, 4, qy, qx, w16[cq], pen16);
    const int m16 = s.best_mode;
    const float cost16 = s.best_cost;
    float cs16 = c.lam;
    for (int sb = 0; sb < 4; ++sb) {
      const int oy = qy + (sb >> 1) * 8, ox = qx + (sb & 1) * 8;
      load_refs<32>(c, s, 8, oy, ox, sb >= 2);
      eval_modes<32>(c, s, 8, 3, oy, ox, w8[cq * 4 + sb], pen8);
      const int m8 = s.best_mode;
      cs16 = __fadd_rn(cs16, s.best_cost);
      mode_levels<32>(c, s, 8, 3, oy, ox, m8);
      if (t < 64) s.c8[sb * 64 + t] = s.lev[fz8[t]];
      if (t == 0) s.m8[sb] = m8;
      reconstruct<32>(c, s, 8, 3, oy, ox);
    }
    const bool split16 = cs16 < cost16;
    cs32 = __fadd_rn(__fadd_rn(cs32, fminf(cost16, cs16)), c.lam);
    if (split16) {
      if (t < 256) c16_o[cq * 256 + t] = static_cast<int16_t>(s.c8[t]);
      if (t < 4) modes_o[cq * 4 + t] = static_cast<int8_t>(s.m8[t]);
    } else {
      load_refs<32>(c, s, 16, qy, qx, true);
      mode_levels<32>(c, s, 16, 4, qy, qx, m16);
      if (t < 256) c16_o[cq * 256 + t] = static_cast<int16_t>(s.lev[fz16[t]]);
      if (t < 4) modes_o[cq * 4 + t] = static_cast<int8_t>(t == 0 ? m16 : 0);
      reconstruct<32>(c, s, 16, 4, qy, qx);
    }
    if (t == 0) s16_o[cq] = split16 ? 1 : 0;
  }

  // ---- the whole-32 syntax, and its reconstruction when it wins
  const bool split32 = cs32 < cost32;
  load_refs<32>(c, s, 32, 0, 0, true);
  mode_levels<32>(c, s, 32, 5, 0, 0, m32);
  c32_o[cu * 1024 + t] = static_cast<int16_t>(s.lev[itab[OFF_FZ32 + t]]);
  if (t == 0) {
    s32_o[cu] = split32 ? 1 : 0;
    m32_o[cu] = static_cast<int8_t>(m32);
  }
  if (!split32) reconstruct<32>(c, s, 32, 5, 0, 0);
  rec[plane + (c.y0 + t / 32) * Wt + c.x0 + t % 32] = s.cur[t];
}

// The two-level (16/8) encoder of the planes above 10 bits: one block per
// (tile plane, 16x16 CU) of the wavefront diagonal d = 2*by + bx over
// 16x16 CUs; the whole 16x16 block against four 8x8 blocks in z-order,
// exactly the quadrant step of the kernel above with the CU's own MV rate
// (reference `_build_encode.run`, hevc.py:811-930).
__global__ void __launch_bounds__(1024)
wavefront_encode16_kernel(const int32_t* src, const int32_t* ref, const float* w16,
                          const float* w8, const float* mvc, const float* qstep,
                          const float* inv_q, const float* lam, const float* pen,
                          const int32_t* dq, const int32_t* maxv, const int32_t* itab,
                          const float* ftab, int8_t* split_o, int8_t* modes_o,
                          int16_t* coeff_o, int32_t* rec, int nby, int nbx, int d,
                          int by_min) {
  __shared__ Smem s;
  const int p = blockIdx.y;
  const int by = by_min + blockIdx.x;
  const int bx = d - 2 * by;
  if (by >= nby || bx < 0 || bx >= nbx) return;  // uniform per block
  const int Ht = nby * 16, Wt = nbx * 16;
  const size_t plane = static_cast<size_t>(p) * Ht * Wt;
  Ctx c;
  c.rec = rec + plane;
  c.ref = ref + plane;
  c.itab = itab;
  c.ftab = ftab;
  c.Wt = Wt;
  c.nbx = nbx;
  c.nby = nby;
  c.d = d;
  c.by = by;
  c.bx = bx;
  c.y0 = by * 16;
  c.x0 = bx * 16;
  c.maxv = maxv[p];
  c.init = (c.maxv + 1) / 2;
  c.dq = dq[p];
  c.qstep = qstep[p];
  c.inv_q = inv_q[p];
  c.lam = lam[p];
  const int t = threadIdx.x;
  const size_t cu = static_cast<size_t>(p) * nby * nbx + by * nbx + bx;
  if (t < 256) {
    s.cur[t] = c.init;
    s.src[t] = src[plane + (c.y0 + t / 16) * Wt + c.x0 + t % 16];
  }
  for (int i = t; i < 1344; i += 1024) s.cf[i] = ftab[FOFF_CF32 + i];
  __syncthreads();
  const float pen16 = __fadd_rn(pen[p], mvc[cu]);
  const float pen8 = __fadd_rn(pen[p], __fmul_rn(0.25f, mvc[cu]));

  load_refs<16>(c, s, 16, 0, 0, true);
  eval_modes<16>(c, s, 16, 4, 0, 0, w16[cu], pen16);
  const int m16 = s.best_mode;
  const float cost16 = s.best_cost;
  float cs = c.lam;
  for (int sb = 0; sb < 4; ++sb) {
    const int oy = (sb >> 1) * 8, ox = (sb & 1) * 8;
    load_refs<16>(c, s, 8, oy, ox, sb >= 2);
    eval_modes<16>(c, s, 8, 3, oy, ox, w8[cu * 4 + sb], pen8);
    const int m8 = s.best_mode;
    cs = __fadd_rn(cs, s.best_cost);
    mode_levels<16>(c, s, 8, 3, oy, ox, m8);
    if (t < 64) s.c8[sb * 64 + t] = s.lev[itab[OFF_FZ8 + t]];
    if (t == 0) s.m8[sb] = m8;
    reconstruct<16>(c, s, 8, 3, oy, ox);
  }
  const bool split = cs < cost16;
  if (split) {
    if (t < 256) coeff_o[cu * 256 + t] = static_cast<int16_t>(s.c8[t]);
    if (t < 4) modes_o[cu * 4 + t] = static_cast<int8_t>(s.m8[t]);
  } else {
    load_refs<16>(c, s, 16, 0, 0, true);
    mode_levels<16>(c, s, 16, 4, 0, 0, m16);
    if (t < 256) coeff_o[cu * 256 + t] = static_cast<int16_t>(s.lev[itab[OFF_FZ16 + t]]);
    if (t < 4) modes_o[cu * 4 + t] = static_cast<int8_t>(t == 0 ? m16 : 0);
    reconstruct<16>(c, s, 16, 4, 0, 0);
  }
  if (t == 0) split_o[cu] = split ? 1 : 0;
  if (t < 256) rec[plane + (c.y0 + t / 16) * Wt + c.x0 + t % 16] = s.cur[t];
}

}  // namespace

// One launch per wavefront diagonal, all on `stream`.  src/ref/rec: (PT,
// nby*32, nbx*32) int32; w32 (PT, nb), w16 (PT, nb, 4), w8 (PT, nb, 4, 4),
// mvc (PT, nb) float32; qstep, inv_q, lam, pen (PT,) float32; dq, maxv
// (PT,) int32; itab/ftab: hevc.py `_tables` blobs.  Outputs: s32/m32 (PT,
// nb) int8, c32 (PT, nb, 1024) int16 zigzag, s16 (PT, nb, 4) int8, modes
// (PT, nb, 4, 4) int8, c16 (PT, nb, 4, 256) int16 zigzag.  *launched (host
// memory) receives the number of grids launched.
extern "C" int wavefront_encode32(
    const int32_t* src, const int32_t* ref, const float* w32, const float* w16,
    const float* w8, const float* mvc, const float* qstep, const float* inv_q,
    const float* lam, const float* pen, const int32_t* dq, const int32_t* maxv,
    const int32_t* itab, const float* ftab, int8_t* s32, int8_t* m32,
    int16_t* c32, int8_t* s16, int8_t* modes, int16_t* c16, int32_t* rec,
    int PT, int nby, int nbx, void* stream, int* launched) {
  const int nd = 2 * (nby - 1) + nbx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  for (int d = 0; d < nd; ++d) {
    const int by_min = d - (nbx - 1) > 0 ? (d - (nbx - 1) + 1) / 2 : 0;
    const int by_max = min(nby - 1, d / 2);
    if (by_max < by_min) continue;
    dim3 grid(by_max - by_min + 1, PT);
    wavefront_encode32_kernel<<<grid, 1024, 0, st>>>(
        src, ref, w32, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxv, itab, ftab,
        s32, m32, c32, s16, modes, c16, rec, nby, nbx, d, by_min);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two-level (16/8) entry: one launch per wavefront diagonal of 16x16
// CUs, all on `stream`.  src/ref/rec: (PT, nby*16, nbx*16) int32; w16 (PT,
// nb), w8 (PT, nb, 4), mvc (PT, nb) float32; qstep, inv_q, lam, pen, dq,
// maxv as above.  Outputs: split (PT, nb) int8, modes (PT, nb, 4) int8
// ([m16, 0, 0, 0] for a whole block), coeffs (PT, nb, 256) int16 zigzag
// (four 64-level 8x8 blocks when split).  *launched receives the number of
// grids launched.
extern "C" int wavefront_encode16(
    const int32_t* src, const int32_t* ref, const float* w16, const float* w8,
    const float* mvc, const float* qstep, const float* inv_q, const float* lam,
    const float* pen, const int32_t* dq, const int32_t* maxv, const int32_t* itab,
    const float* ftab, int8_t* split, int8_t* modes, int16_t* coeffs, int32_t* rec,
    int PT, int nby, int nbx, void* stream, int* launched) {
  const int nd = 2 * (nby - 1) + nbx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  for (int d = 0; d < nd; ++d) {
    const int by_min = d - (nbx - 1) > 0 ? (d - (nbx - 1) + 1) / 2 : 0;
    const int by_max = min(nby - 1, d / 2);
    if (by_max < by_min) continue;
    dim3 grid(by_max - by_min + 1, PT);
    wavefront_encode16_kernel<<<grid, 1024, 0, st>>>(
        src, ref, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxv, itab, ftab, split,
        modes, coeffs, rec, nby, nbx, d, by_min);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
