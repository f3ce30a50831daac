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
// a wavefront of 16x16 CUs (the device functions below take the CU size as
// a template argument).  The reference compiles `_code_cu16` into that
// program anew; see video/hevc.py's section comment for the float order
// found there.
//
// Float order.  Per mode: prediction (planar/DC by formula, angular by the
// two-tap interpolation of hevc_tables.py `angular_taps`, inter from the
// motion-compensated plane), residual, the orthonormal DCT in the
// order of XLA's CPU dots (u[i,k] = sum_j Cf[i,j] r[j,k], then c[i,l] =
// sum_k u[i,k] Cf[l,k]; each sum as two (n = 32) or four (n <= 16)
// interleaved fma chains), lv = min(floor(fma(|c|, 1/qstep, 0.33)),
// 32767), d = fma(-lv, qstep, |c|), the rate term of lv from the table of
// the reference's values, the sums of d*d (fused) and of the rate terms in
// the order of XLA's vectorized CPU reduce loops (32x32: row by row, an
// 8-lane vector [running sum, 0 x 7] takes the row's four vectors, then
// lanes 0-3 + 4-7, 0-1 + 2-3, 0 + 1; 16x16 and 8x8: eight lanes over the
// rows, lane k takes rows k, k + 8, ... column by column, then the same
// tree) and the max scan position of a nonzero level.  cost = fma(lam,
// fma(0.12, last + 1, bits) + mode_bits, w * dist) (+ the inter penalty).
// The first minimum over ascending modes wins (strict <).  The integer
// reconstruction runs in wrapping 32-bit arithmetic as kernel A's.  These
// orders were read off the reference's CPU program (tests/
// test_torch_video_encode.py holds a 32x32 tie only this order resolves as
// the reference does); the plain version (hevc.py
// `wavefront_encode32_plain`) evaluates the same operations in the same
// order.  Built with --fmad=false so that no other contraction happens.
// Tensor cores are not used: wgmma/mma round fp32 inputs to TF32 or add in
// an unspecified order, which would change the decisions.
//
// Design (Hopper).  One launch a call.  The grid holds one block per
// (tile plane, CU); each block takes a ticket from an atomic counter and
// codes the CU that ticket names, CUs handed out in wavefront-diagonal
// order (d = 2*by + bx) over all planes, so no block waits on a CU that has
// not started (no deadlock).  A CU waits on acquire loads of the ready
// flags of its left, top-left, top and top-right neighbours (the only CUs
// whose samples it reads), copies their border samples into shared memory
// once, and releases its own flag after writing its reconstruction.  The
// wrapper zeroes the flags and the counter; the kernel allocates nothing.
// The critical path is one CU a diagonal, with no launch or grid-wide wait
// between diagonals.
//
// Inside a CU the RD search runs in rounds of several modes (32x32: 8 modes
// a round, 5 rounds; 16x16 and 8x8: all 36 at once), 25 rounds a 32x32 CU,
// each of four barriers:
// * residuals of the round's modes: the block's reference vector and the 33
//   angular modes' main references (HEVC's refMain, built once a block with
//   the reference vector) make an angular sample two loads and a two-tap
//   interpolation; the inter samples of the CU sit in shared memory;
// * the first transform stage, a thread per (mode, column, 8 or 4 rows),
//   reading its rows of Cf^T as float4 broadcasts and storing u transposed
//   (row groups XOR-swizzled: conflict-free float4 stores);
// * the second stage the same way per (mode, row block, column), which also
//   quantises and stores d and the signed level;
// * the RD sums.  32x32: a thread per (mode, row, lane) forms lanes 1-7 and
//   the pair sums (l2 + l6), (l1 + l5) + (l3 + l7) by shuffles within 8
//   lanes, so that the one serial chain left, per mode on its own thread,
//   is per row 4 fma and 3 adds on values stored as float4 (one more
//   barrier); 16x16 and 8x8: a thread per (mode, lane) runs its lane, the
//   tree by shuffles.  The same lanes max-reduce the scan position of a
//   nonzero level.  Residuals, d and levels lie at row and mode pitches
//   (`Lvl::RP`, `Lvl::MP`) under which a warp's lanes read 32 banks.  The
//   rate terms of levels below 256 come from shared memory.
// Each mode's cost goes into a shared 64-bit atomicMin of (cost bits << 32
// | mode slot): costs are >= 0, so the minimum is the round's first
// minimum, read by every thread after the barrier.  The winner's signed
// levels are kept (a new best's levels copied aside), its prediction formed
// once (an 8x8 winner's inside its reconstruction): no transform is run
// again for the syntax or the reconstruction.  The forward and integer
// transforms and the inverse scans of each level are copied into shared
// memory at the start, while the neighbours finish.
//
// Occupancy.  The 32/16/8 entry runs 1024 threads a block, one CU an SM
// (135 KB of dynamic shared memory; 64 registers a thread, a few words
// spilled): the captured
// plane stacks hold at most ~100 CUs on a diagonal, fewer than the 132 SMs,
// so the latency of one CU is what counts.  The two-level entry runs 512
// threads and ~108 KB, two CUs an SM (the largest carveout): its planes
// hold several hundred 16x16 CUs on a diagonal, so throughput counts.  A
// cluster would not help: CUs share nothing but their borders.
//
// Bound: operations.  Per CU and mode level the two DCT stages cost 2n
// multiply-adds per sample for each of the 36 modes, at 32, 16 and 8: about
// 36 * 2 * 1024 * (32 + 16 + 8) multiply-adds per CU (two-level: 36 * 2 *
// 256 * (16 + 8) per 16x16 CU).  What is left above that bound is the
// wavefront's critical path (22 CUs at 8 x 8 CUs a tile), the 16 dependent
// 8x8 blocks of a CU and the barriers of each round; the 8x8 blocks' rounds
// are too small to fill 1024 threads.

#include <climits>
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
constexpr unsigned FULL = 0xffffffffu;

constexpr int BITS_CACHED = 256;  // rate terms of levels 0..255 kept in shared memory

// HEVC's intraPredAngle of modes 0..34 (0 and 1 unused), and the inverse
// angle of each negative angle a at index -a (hevc_tables.py `_ANGLES`,
// `_INV_ANGLE`): the angular taps of hevc_tables.py `angular_taps`
__constant__ int c_angle[35] = {0,   0,   32,  26,  21,  17,  13,  9,   5,  2,  0,  -2,
                                -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                                -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
__constant__ int c_inv_angle[33] = {0, 0, 4096, 0,   0, 1638, 0, 0, 0,   910, 0,
                                    0, 0, 630,  0,   0, 0,    482, 0, 0, 0, 390,
                                    0, 0, 0,    0,   315, 0, 0,   0, 0, 0, 256};

constexpr int THREADS32 = 1024;  // the 32/16/8 entry: one CU an SM
constexpr int THREADS16 = 512;   // the two-level entry: two CUs an SM

// per mode level n: rows of a transform task, interleaved chains of a dot,
// modes a round, the span of an angular mode's main reference (positions
// -n + 1 .. 2n + 1), and the row and mode pitches of a round's residuals,
// terms d and levels: the sum lanes of a warp (n = 32: 4 rows x 8 lanes of
// a mode; n <= 16: 4 modes x 8 lanes) then read 32 distinct banks
template <int N>
struct Lvl {
  static constexpr int NN = N * N;
  static constexpr int LOG2 = N == 32 ? 5 : N == 16 ? 4 : 3;
  static constexpr int RB = N == 32 ? 8 : 4;
  static constexpr int WAYS = N == 32 ? 2 : 4;
  static constexpr int G = N == 32 ? 8 : N_MODES;
  static constexpr int ROUNDS = (N_MODES + G - 1) / G;
  static constexpr int MAIN = 3 * N + 1;
  static constexpr int RP = N == 32 ? 40 : N == 16 ? 17 : 9;
  static constexpr int MP = N == 32 ? 32 * 40 : N == 16 ? 280 : 72;
};

// offset in a mode's transposed first stage of row k's float4 group gi: the
// groups of a row XOR-swizzled by k, so that the lanes of a quarter warp
// (consecutive k) store to distinct banks
template <int N>
__device__ __forceinline__ int ut_off(int k, int gi) {
  return k * N + 4 * (gi ^ ((k / (32 / N)) & (N / 4 - 1)));
}

// offset of level n's tables in a CU's shared copy (CUS = 32: n = 32, 16,
// 8; CUS = 16: n = 16, 8)
template <int CUS, int N>
struct TabOff {
  static constexpr int V = CUS == 32 ? (N == 32 ? 0 : N == 16 ? 1024 : 1280) : (N == 16 ? 0 : 256);
};

// the transposed first stage, then the 32x32 row sums, sized for the largest
// round of any level
constexpr int SIZE_B = 36 * 256;   // >= 8 * 1024, 36 * 64, 8 * RS_MP
constexpr int RS_MP = 32 * 16 + 4;  // mode pitch of the 32x32 row sums
constexpr int MAX_ROUNDS = 5;

template <int CUS>
struct __align__(16) Smem {
  static constexpr int TABN = CUS == 32 ? 1344 : 320;
  static constexpr int SIZE_A = CUS == 32 ? 8 * Lvl<32>::MP : 36 * Lvl<16>::MP;
  float A[SIZE_A];          // a round's residuals, then its terms d (Lvl::RP, MP)
  float B[SIZE_B];
  float cft[TABN];          // Cf^T of each level: cft[j * n + i] = Cf[i, j]
  int16_t tq[TABN];         // the integer transforms
  int16_t izz[TABN];        // inverse zigzags (raster -> scan position)
  int cur[CUS * CUS];       // the CU's samples coded so far (init elsewhere)
  int src[CUS * CUS];       // the CU's source samples
  int refb[CUS * CUS];      // the CU's inter prediction samples
  int predw[CUS * CUS];     // the whole CU's winning prediction
  int pred16[CUS == 32 ? 256 : 4];  // a 16x16 quadrant's winning prediction
  int pred8[64];
  unsigned long long key[MAX_ROUNDS];  // a round's min of (cost bits << 32 | mode slot)
  int16_t L[SIZE_A];        // signed levels, laid out as A
  int16_t levw[CUS * CUS];  // the whole CU's winning levels
  int16_t lev16[CUS == 32 ? 256 : 4];
  int16_t c8[256];          // a 16x16 block's four 8x8 zigzag level blocks
  float bits[BITS_CACHED];  // the rate terms of the smallest levels
  int refv[4 * CUS + 1];
  int16_t mref[33 * Lvl<CUS>::MAIN];  // the 33 angular modes' main references
  int top[2 * CUS + 1];     // row -1, columns -1 .. 2 * CUS - 1
  int left[CUS];            // column -1, rows 0 .. CUS - 1
  int m8[4];
  int tk_p, tk_by, tk_bx;
};

struct Ctx {
  const int32_t* itab;
  const float* ftab;
  int Wt, y0, x0, init, maxv, dq;
  float qstep, inv_q, lam;
};

struct Best {
  int mode, g;  // the winning mode, its slot in its round
  float cost;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the ticket's CU: tickets run over the wavefront diagonals in order, within
// a diagonal plane by plane, within a plane by row
__device__ void claim(int* counter, int PT, int nby, int nbx, int* p, int* by, int* bx) {
  int tk = atomicAdd(counter, 1);
  for (int d = 0;; ++d) {
    const int lo = d - (nbx - 1) > 0 ? (d - (nbx - 1) + 1) / 2 : 0;
    const int hi = min(nby - 1, d / 2);
    const int cnt = hi >= lo ? hi - lo + 1 : 0;
    if (tk < cnt * PT) {
      *p = tk / cnt;
      *by = lo + tk % cnt;
      *bx = d - 2 * *by;
      return;
    }
    tk -= cnt * PT;
  }
}

// sample (yy, xx) of the plane around a CU of CUS x CUS samples as the
// reference sees it: the plane where that CU lies on an earlier wavefront
// diagonal, else the init value (read through L2: the plane is written by
// other blocks of this launch)
template <int CUS>
__device__ __forceinline__ int fetch_plane(const int32_t* rec, int Wt, int nbx, int nby,
                                           int by, int bx, int y0, int x0, int init, int yy,
                                           int xx) {
  constexpr int SH = CUS == 32 ? 5 : 4;
  const int cy = by + (yy >> SH);
  const int cx = bx + (xx >> SH);
  if (cy < 0 || cx < 0 || cx >= nbx || cy >= nby || 2 * cy + cx >= 2 * by + bx) return init;
  return __ldcg(rec + (y0 + yy) * Wt + (x0 + xx));
}

// sample at (yy, xx) relative to the CU origin: inside the CU the samples
// coded so far (init elsewhere); outside, the border copied at the start
// (row -1 and column -1 are the only samples outside a CU that can lie on
// an earlier diagonal), else the init value
template <int CUS>
__device__ __forceinline__ int fetch(const Smem<CUS>& s, int init, int yy, int xx) {
  if (yy >= 0 && yy < CUS && xx >= 0 && xx < CUS) return s.cur[yy * CUS + xx];
  if (yy == -1 && xx < 2 * CUS) return s.top[xx + 1];
  if (xx == -1 && yy >= 0 && yy < CUS) return s.left[yy];
  return init;
}

// index into the (4N + 1) reference vector of main-reference position k
// (negative: projected from the side array by the inverse angle)
template <int N>
__device__ __forceinline__ int ref_index(int k, bool vertical, int a) {
  if (k >= 0) {
    if (k == 0) return 0;
    k = min(k, 2 * N);  // 2N + 1 only with tap weight 0
    return vertical ? k : 2 * N + k;
  }
  int j = (128 + (-k) * c_inv_angle[-a]) >> 8;
  j = min(j, 2 * N);
  if (j == 0) return 0;
  return vertical ? 2 * N + j : j;
}

// prediction of `mode` at (y, x) of the N x N block at (oy, ox), refs loaded
template <int CUS, int N>
__device__ __forceinline__ int predict(const Smem<CUS>& s, int mode, int y, int x, int oy,
                                       int ox) {
  constexpr int LOG2 = Lvl<N>::LOG2;
  const int* refv = s.refv;
  if (mode == 0) {  // planar
    return ((N - 1 - x) * refv[2 * N + 1 + y] + (x + 1) * refv[N + 1] +
            (N - 1 - y) * refv[1 + x] + (y + 1) * refv[3 * N + 1] + N) >>
           (LOG2 + 1);
  }
  if (mode == 1) {  // DC over the N top and N left samples
    int sum = 0;
#pragma unroll
    for (int q = 0; q < N; ++q) sum += refv[1 + q] + refv[2 * N + 1 + q];
    return (sum + N) >> (LOG2 + 1);
  }
  if (mode == MODE_INTER) return s.refb[(oy + y) * CUS + ox + x];
  // angular: the two-tap interpolation ((32 - f) * a + f * b + 16) >> 5
  // along the mode's main reference
  const int a = c_angle[mode];
  const bool vertical = mode >= 18;
  const int u = vertical ? y : x, v = vertical ? x : y;
  const int tt = (v + 1) * a;
  const int f = tt & 31;
  const int16_t* m = s.mref + (mode - 2) * Lvl<N>::MAIN + N - 1 + u + (tt >> 5) + 1;
  return ((32 - f) * m[0] + f * m[1] + 16) >> 5;
}

// entry t of the reference vector of the N x N block at (oy, ox): corner,
// 2N above, 2N left
template <int CUS, int N>
__device__ __forceinline__ int ref_at(const Ctx& c, const Smem<CUS>& s, int oy, int ox,
                                      bool bl_init, int t) {
  if (t == 0) return fetch<CUS>(s, c.init, oy - 1, ox - 1);
  if (t <= 2 * N) return fetch<CUS>(s, c.init, oy - 1, ox + t - 1);
  if (t <= 3 * N || !bl_init) return fetch<CUS>(s, c.init, oy + t - 2 * N - 1, ox - 1);
  return c.init;
}

// reference vector of the N x N block at (oy, ox) and each angular mode's
// main reference drawn from it, then a sync (the last reader of the
// previous ones synced before)
template <int CUS, int NT, int N>
__device__ void load_refs(const Ctx& c, Smem<CUS>& s, int oy, int ox, bool bl_init) {
  constexpr int M = Lvl<N>::MAIN;
  for (int t = threadIdx.x; t < 4 * N + 1 + 33 * M; t += NT) {
    if (t < 4 * N + 1) {
      s.refv[t] = ref_at<CUS, N>(c, s, oy, ox, bl_init, t);
      continue;
    }
    const int e = t - (4 * N + 1), mode = 2 + e / M, k = e % M - N + 1;
    const int a = c_angle[mode];
    const int idx = k < 0 && a >= 0 ? 0 : ref_index<N>(k, mode >= 18, a);  // (unused if so)
    s.mref[e] = ref_at<CUS, N>(c, s, oy, ox, bl_init, idx);
  }
  __syncthreads();
}

__device__ __forceinline__ float quant(const Ctx& c, float ca) {
  return fminf(floorf(__fmaf_rn(ca, c.inv_q, 0.33f)), LEVEL_MAX);
}

template <int W>
__device__ __forceinline__ float chains(const float* q) {
  if (W == 2) return __fadd_rn(q[0], q[1]);
  return __fadd_rn(__fadd_rn(q[0], q[1]), __fadd_rn(q[2], q[3]));
}

// the RD cost, and its key: costs are >= 0, so their float bits order as
// integers; the slot breaks ties toward the lower mode (the first minimum)
__device__ __forceinline__ unsigned long long rd_key(const Ctx& c, float dist, float bsum,
                                                     int lz, float w, float pen, int mode,
                                                     int slot) {
  const float bits = __fmaf_rn(0.12f, static_cast<float>(lz + 1), bsum);
  const float wd = __fmul_rn(w, dist);
  float cost = __fmaf_rn(c.lam, __fadd_rn(bits, c.ftab[FOFF_MB + mode]), wd);
  if (mode == MODE_INTER) cost = __fadd_rn(cost, pen);
  return static_cast<unsigned long long>(__float_as_uint(cost)) << 32 |
         static_cast<unsigned>(slot);
}

// the rate term of a level: the smallest from shared memory
template <int CUS>
__device__ __forceinline__ float bits_of(const Smem<CUS>& s, const float* bits_tab,
                                         int16_t lev) {
  const int a = abs(static_cast<int>(lev));
  return a < BITS_CACHED ? s.bits[a] : __ldg(bits_tab + a);
}

// One round of the RD search: modes m0 .. m0 + G - 1 of the N x N block at
// (oy, ox), refs loaded.  Leaves the signed level of mode m0 + g at (row,
// col) in s.L[g * MP + row * RP + col]; returns the round's min key (its
// first minimum).  All threads call.
template <int CUS, int NT, int N>
__device__ unsigned long long eval_round(const Ctx& c, Smem<CUS>& s, int oy, int ox, int m0,
                                         int G, float w, float pen, int rnd) {
  using V = Lvl<N>;
  constexpr int NN = V::NN, RB = V::RB, W = V::WAYS, NB = N / RB, RP = V::RP, MP = V::MP;
  constexpr int TO = TabOff<CUS, N>::V;
  const int t = threadIdx.x;
  const int16_t* izz = s.izz + TO;
  const float* bits_tab = c.ftab + FOFF_BITS;
  const float* cft = s.cft + TO;

  // residuals
  for (int i = t; i < G * NN; i += NT) {
    const int g = i / NN, p = i % NN, y = p / N, x = p % N;
    const int pr = predict<CUS, N>(s, m0 + g, y, x, oy, ox);
    s.A[g * MP + y * RP + x] = static_cast<float>(s.src[(oy + y) * CUS + ox + x] - pr);
  }
  __syncthreads();

  // first stage, u[i, k] = sum_j Cf[i, j] r[j, k]: a task is RB rows of one
  // column; stored transposed, B[g][k][i] (swizzled, `ut_off`)
  for (int task = t; task < G * NB * N; task += NT) {
    const int k = task % N, ib = (task / N) % NB, g = task / (NB * N);
    const float* a = s.A + g * MP + k;
    const float* cf = cft + ib * RB;
    float acc[RB][W];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float av = a[j * RP];
      float cv[RB];
#pragma unroll
      for (int r4 = 0; r4 < RB / 4; ++r4) {
        const float4 q = *reinterpret_cast<const float4*>(cf + j * N + 4 * r4);
        cv[4 * r4] = q.x;
        cv[4 * r4 + 1] = q.y;
        cv[4 * r4 + 2] = q.z;
        cv[4 * r4 + 3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r][j % W] = j < W ? __fmul_rn(cv[r], av) : __fmaf_rn(cv[r], av, acc[r][j % W]);
    }
    float* out = s.B + g * NN;
#pragma unroll
    for (int r4 = 0; r4 < RB / 4; ++r4) {
      float4 q;
      q.x = chains<W>(acc[4 * r4]);
      q.y = chains<W>(acc[4 * r4 + 1]);
      q.z = chains<W>(acc[4 * r4 + 2]);
      q.w = chains<W>(acc[4 * r4 + 3]);
      *reinterpret_cast<float4*>(out + ut_off<N>(k, ib * RB / 4 + r4)) = q;
    }
  }
  __syncthreads();

  // second stage, c[i, l] = sum_k u[i, k] Cf[l, k]: a task is RB rows of one
  // column; quantise, store d and the signed level
  for (int task = t; task < G * NB * N; task += NT) {
    const int l = task % N, ib = (task / N) % NB, g = task / (NB * N);
    const float* ut = s.B + g * NN;
    const float* cf = cft + l;
    float acc[RB][W];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float cv = cf[k * N];
      float uv[RB];
#pragma unroll
      for (int r4 = 0; r4 < RB / 4; ++r4) {
        const float4 q =
            *reinterpret_cast<const float4*>(ut + ut_off<N>(k, ib * RB / 4 + r4));
        uv[4 * r4] = q.x;
        uv[4 * r4 + 1] = q.y;
        uv[4 * r4 + 2] = q.z;
        uv[4 * r4 + 3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r][k % W] = k < W ? __fmul_rn(uv[r], cv) : __fmaf_rn(uv[r], cv, acc[r][k % W]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float cval = chains<W>(acc[r]);
      const int o = g * MP + (ib * RB + r) * RP + l;
      const float ca = fabsf(cval);
      const float lv = quant(c, ca);
      s.A[o] = __fmaf_rn(-lv, c.qstep, ca);  // d; the sum takes d*d
      const float sg = cval > 0.0f ? 1.0f : (cval < 0.0f ? -1.0f : 0.0f);
      s.L[o] = static_cast<int16_t>(static_cast<int>(sg * lv));
    }
  }
  __syncthreads();

  // the distortion and rate sums in the order of XLA's reduce loops, the max
  // scan position of a nonzero level, each mode's cost into the round's key
  if constexpr (N == 32) {
    // a task per (mode, row, lane): lanes 1-7 over the row's four vectors,
    // then (l2 + l6) and (l1 + l5) + (l3 + l7) by shuffles; lane 0 stores
    // the row's chain operands, 16 floats: d of columns 0, 8, 16, 24 | l4,
    // l2 + l6, (l1 + l5) + (l3 + l7), the row's max scan position | the
    // same for the rate terms
    float* rs = s.B;
    const int tasks = G * 256;
    for (int base = 0; base < tasks; base += NT) {
      const int task = base + t;
      const bool act = task < tasks;
      const int k8 = task & 7, i = (task >> 3) & 31, g = task >> 8;
      const int o = g * MP + i * RP;
      float ld = 0.0f, lb = 0.0f;
      int lz = -1;
      if (act) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int16_t lev = s.L[o + k8 + 8 * u];
          if (lev != 0) lz = max(lz, static_cast<int>(izz[i * 32 + k8 + 8 * u]));
          if (k8 != 0) {
            const float e = s.A[o + k8 + 8 * u];
            ld = __fmaf_rn(e, e, ld);
            lb = __fadd_rn(lb, bits_of(s, bits_tab, lev));
          }
        }
      }
      lz = max(lz, __shfl_down_sync(FULL, lz, 4, 8));
      lz = max(lz, __shfl_down_sync(FULL, lz, 2, 8));
      lz = max(lz, __shfl_down_sync(FULL, lz, 1, 8));
      const float d4 = __shfl_down_sync(FULL, ld, 4, 8);
      const float b4 = __shfl_down_sync(FULL, lb, 4, 8);
      const float sd = __fadd_rn(ld, d4), sb = __fadd_rn(lb, b4);   // lane k: l_k + l_(k+4)
      const float wd = __shfl_down_sync(FULL, sd, 2, 8);
      const float wb = __shfl_down_sync(FULL, sb, 2, 8);
      const float qd = __fadd_rn(sd, wd), qb = __fadd_rn(sb, wb);   // lane 1: the q terms
      const float qd1 = __shfl_down_sync(FULL, qd, 1, 8);
      const float qb1 = __shfl_down_sync(FULL, qb, 1, 8);
      if (act && k8 == 0) {
        float* r = rs + g * RS_MP + i * 16;
        *reinterpret_cast<float4*>(r) =
            make_float4(s.A[o], s.A[o + 8], s.A[o + 16], s.A[o + 24]);
        *reinterpret_cast<float4*>(r + 4) = make_float4(d4, wd, qd1, __int_as_float(lz));
        *reinterpret_cast<float4*>(r + 8) =
            make_float4(bits_of(s, bits_tab, s.L[o]), bits_of(s, bits_tab, s.L[o + 8]),
                        bits_of(s, bits_tab, s.L[o + 16]), bits_of(s, bits_tab, s.L[o + 24]));
        *reinterpret_cast<float4*>(r + 12) = make_float4(b4, wb, qb1, 0.0f);
      }
    }
    __syncthreads();
    // the chain down the rows, a thread per mode
    if (t < G) {
      float dist = 0.0f, bsum = 0.0f;
      int lz = -1;
      const float* r = rs + t * RS_MP;
#pragma unroll 4
      for (int i = 0; i < 32; ++i, r += 16) {
        const float4 e = *reinterpret_cast<const float4*>(r);
        const float4 dl = *reinterpret_cast<const float4*>(r + 4);
        const float4 b = *reinterpret_cast<const float4*>(r + 8);
        const float4 bl = *reinterpret_cast<const float4*>(r + 12);
        dist = __fmaf_rn(e.x, e.x, dist);
        bsum = __fadd_rn(bsum, b.x);
        dist = __fmaf_rn(e.y, e.y, dist);
        bsum = __fadd_rn(bsum, b.y);
        dist = __fmaf_rn(e.z, e.z, dist);
        bsum = __fadd_rn(bsum, b.z);
        dist = __fmaf_rn(e.w, e.w, dist);
        bsum = __fadd_rn(bsum, b.w);
        dist = __fadd_rn(__fadd_rn(__fadd_rn(dist, dl.x), dl.y), dl.z);
        bsum = __fadd_rn(__fadd_rn(__fadd_rn(bsum, bl.x), bl.y), bl.z);
        lz = max(lz, __float_as_int(dl.w));
      }
      atomicMin(&s.key[rnd], rd_key(c, dist, bsum, lz, w, pen, m0 + t, t));
    }
  } else {
    // a task per (mode, lane): lane k takes rows k, k + 8, ..., each column
    // by column; then lanes 0-3 + 4-7, 0-1 + 2-3, 0 + 1 by shuffles
    const int tasks = G * 8;
    for (int base = 0; base < tasks; base += NT) {
      const int task = base + t;
      const bool act = task < tasks;
      const int k = task & 7, g = task >> 3;
      float ld = 0.0f, lb = 0.0f;
      int lz = -1;
      if (act) {
#pragma unroll
        for (int i0 = 0; i0 < N / 8; ++i0) {
          const int o = g * MP + (i0 * 8 + k) * RP, oz = (i0 * 8 + k) * N;
#pragma unroll
          for (int col = 0; col < N; ++col) {
            const float e = s.A[o + col];
            const int16_t lev = s.L[o + col];
            ld = __fmaf_rn(e, e, ld);
            lb = __fadd_rn(lb, bits_of(s, bits_tab, lev));
            if (lev != 0) lz = max(lz, static_cast<int>(izz[oz + col]));
          }
        }
      }
      const float sd = __fadd_rn(ld, __shfl_down_sync(FULL, ld, 4, 8));
      const float sb = __fadd_rn(lb, __shfl_down_sync(FULL, lb, 4, 8));
      const float ad = __fadd_rn(sd, __shfl_down_sync(FULL, sd, 2, 8));
      const float ab = __fadd_rn(sb, __shfl_down_sync(FULL, sb, 2, 8));
      const float td = __fadd_rn(ad, __shfl_down_sync(FULL, ad, 1, 8));
      const float tb = __fadd_rn(ab, __shfl_down_sync(FULL, ab, 1, 8));
      lz = max(lz, __shfl_down_sync(FULL, lz, 4, 8));
      lz = max(lz, __shfl_down_sync(FULL, lz, 2, 8));
      lz = max(lz, __shfl_down_sync(FULL, lz, 1, 8));
      if (act && k == 0) atomicMin(&s.key[rnd], rd_key(c, td, tb, lz, w, pen, m0 + g, g));
    }
  }
  __syncthreads();
  return s.key[rnd];
}

// RD search over the 36 modes of the N x N block at (oy, ox); refs loaded.
// Returns the first minimum; where `keep` is given the winner's signed
// levels are copied there, raster order (else they stay in s.L at
// best.g * MP, row pitch RP).  All threads call.
template <int CUS, int NT, int N>
__device__ Best eval_block(const Ctx& c, Smem<CUS>& s, int oy, int ox, float w, float pen,
                           int16_t* keep) {
  constexpr int NN = N * N;
  if (threadIdx.x < MAX_ROUNDS) s.key[threadIdx.x] = ~0ull;
  Best b{0, 0, __int_as_float(0x7f800000)};  // +inf
  for (int rnd = 0; rnd < Lvl<N>::ROUNDS; ++rnd) {
    const int m0 = rnd * Lvl<N>::G;
    const unsigned long long k =
        eval_round<CUS, NT, N>(c, s, oy, ox, m0, min(Lvl<N>::G, N_MODES - m0), w, pen, rnd);
    const float bc = __uint_as_float(static_cast<unsigned>(k >> 32));
    if (bc < b.cost) {  // strict: an earlier round keeps a tie
      b.cost = bc;
      b.g = static_cast<int>(k & 0xffffffffu);
      b.mode = m0 + b.g;
      if (keep != nullptr) {
        const int16_t* lv = s.L + b.g * Lvl<N>::MP;
        for (int i = threadIdx.x; i < NN; i += NT) keep[i] = lv[i / N * Lvl<N>::RP + i % N];
      }
    }
  }
  return b;
}

// the winner's prediction (refs of its block still loaded), then a sync
template <int CUS, int NT, int N>
__device__ void winner_pred(const Ctx& c, Smem<CUS>& s, int oy, int ox, int mode, int* pred) {
  for (int p = threadIdx.x; p < N * N; p += NT)
    pred[p] = predict<CUS, N>(s, mode, p / N, p % N, oy, ox);
  __syncthreads();
}

// integer reconstruction of (lev, pred) into the CU buffer at (oy, ox):
// dequantise, inverse transform in wrapping 32-bit arithmetic, add the
// prediction, clip.  `lev` has row pitch lp.  With mode >= 0 the
// prediction of that mode is formed into `pred` on the way (refs of the
// block still loaded).  All threads call.
template <int CUS, int NT, int N>
__device__ void reconstruct(const Ctx& c, Smem<CUS>& s, int oy, int ox, const int16_t* lev,
                            int lp, int* pred, int mode = -1) {
  constexpr int NN = N * N;
  const int t = threadIdx.x;
  const int16_t* T = s.tq + TabOff<CUS, N>::V;
  int* tmp = reinterpret_cast<int*>(s.A);
  for (int p = t; p < NN; p += NT) {
    const int i = p / N, k = p % N;
    if (mode >= 0) pred[p] = predict<CUS, N>(s, mode, i, k, oy, ox);
    uint32_t acc = 0;
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const int dv = static_cast<int>(lev[j * lp + k]) * c.dq;
      const int coef = min(max(dv, -(1 << 19)), (1 << 19) - 1);
      acc += static_cast<uint32_t>(T[j * N + i]) * static_cast<uint32_t>(coef);
    }
    acc += 1u << 10;
    tmp[p] = static_cast<int32_t>(acc) >> 11;
  }
  __syncthreads();
  constexpr int S2 = 7 + Lvl<N>::LOG2;
  for (int p = t; p < NN; p += NT) {
    const int i = p / N, k = p % N;
    uint32_t acc = 0;
#pragma unroll 8
    for (int j = 0; j < N; ++j)
      acc += static_cast<uint32_t>(tmp[i * N + j]) * static_cast<uint32_t>(T[j * N + k]);
    acc += 1u << (S2 - 1);
    const int r = static_cast<int32_t>(acc) >> S2;
    s.cur[(oy + i) * CUS + ox + k] = min(max(pred[p] + r, 0), c.maxv);
  }
  __syncthreads();
}

// the four 8x8 blocks of the 16x16 block at (qy, qx) in z-order, each
// coded in place in the CU buffer.  Returns lam + their costs; leaves their
// zigzag levels in s.c8 and modes in s.m8.
template <int CUS, int NT>
__device__ float code_subs(const Ctx& c, Smem<CUS>& s, int qy, int qx, const float* w8,
                           float pen8) {
  const int32_t* fz8 = c.itab + OFF_FZ8;
  float cs = c.lam;
  for (int sb = 0; sb < 4; ++sb) {
    const int oy = qy + (sb >> 1) * 8, ox = qx + (sb & 1) * 8;
    load_refs<CUS, NT, 8>(c, s, oy, ox, sb >= 2);
    const Best b = eval_block<CUS, NT, 8>(c, s, oy, ox, w8[sb], pen8, nullptr);
    cs = __fadd_rn(cs, b.cost);
    constexpr int RP = Lvl<8>::RP;
    const int16_t* lev8 = s.L + b.g * Lvl<8>::MP;
    for (int i = threadIdx.x; i < 64; i += NT) {
      const int p = fz8[i];
      s.c8[sb * 64 + i] = lev8[p / 8 * RP + p % 8];
    }
    if (threadIdx.x == 0) s.m8[sb] = b.mode;
    reconstruct<CUS, NT, 8>(c, s, oy, ox, lev8, RP, s.pred8, b.mode);
  }
  return cs;
}

// Start of a CU: take a ticket, set up the context, load the source, the
// inter samples and the tables, wait for the neighbours, copy the border.
// Returns the CU's index among the plane stack's CUs.
template <int CUS, int NT>
__device__ size_t begin_cu(Smem<CUS>& s, Ctx& c, const int32_t* src, const int32_t* ref,
                           const float* qstep, const float* inv_q, const float* lam,
                           const int32_t* dq, const int32_t* maxv, const int32_t* itab,
                           const float* ftab, const int32_t* rec, int* flags, int PT,
                           int nby, int nbx, int** flag_o) {
  const int t = threadIdx.x;
  const int nb = nby * nbx;
  if (t == 0) claim(flags + static_cast<size_t>(PT) * nb, PT, nby, nbx, &s.tk_p, &s.tk_by,
                    &s.tk_bx);
  __syncthreads();
  const int p = s.tk_p, by = s.tk_by, bx = s.tk_bx;
  const int Wt = nbx * CUS;
  const size_t plane = static_cast<size_t>(p) * nby * CUS * Wt;
  c.itab = itab;
  c.ftab = ftab;
  c.Wt = Wt;
  c.y0 = by * CUS;
  c.x0 = bx * CUS;
  c.maxv = maxv[p];
  c.init = (c.maxv + 1) / 2;
  c.dq = dq[p];
  c.qstep = qstep[p];
  c.inv_q = inv_q[p];
  c.lam = lam[p];
  for (int i = t; i < CUS * CUS; i += NT) {
    const size_t o = plane + (c.y0 + i / CUS) * Wt + c.x0 + i % CUS;
    s.cur[i] = c.init;
    s.src[i] = src[o];
    s.refb[i] = ref[o];
  }
  for (int i = t; i < Smem<CUS>::TABN; i += NT) {  // the tables of each level
    int n, o;
    if (CUS == 32 && i < 1024) n = 32, o = i;
    else if (i < (CUS == 32 ? 1280 : 256)) n = 16, o = i - (CUS == 32 ? 1024 : 0);
    else n = 8, o = i - (CUS == 32 ? 1280 : 256);
    s.cft[i] = ftab[(n == 32 ? FOFF_CF32 : n == 16 ? FOFF_CF16 : FOFF_CF8) + (o % n) * n + o / n];
    s.tq[i] = itab[(n == 32 ? OFF_T32 : n == 16 ? OFF_T16 : OFF_T8) + o];
    s.izz[i] = itab[(n == 32 ? OFF_ZZ32 : n == 16 ? OFF_ZZ16 : OFF_ZZ8) + o];
  }
  for (int i = t; i < BITS_CACHED; i += NT) s.bits[i] = ftab[FOFF_BITS + i];
  int* fl = flags + static_cast<size_t>(p) * nb;
  if (t == 0) {  // left, top-left, top, top-right
    const int ny[4] = {by, by - 1, by - 1, by - 1};
    const int nx[4] = {bx - 1, bx - 1, bx, bx + 1};
    for (int q = 0; q < 4; ++q) {
      if (ny[q] < 0 || nx[q] < 0 || nx[q] >= nbx) continue;
      while (ld_acquire(fl + ny[q] * nbx + nx[q]) == 0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
  const int32_t* rp = rec + plane;
  for (int i = t; i < 2 * CUS + 1; i += NT)
    s.top[i] = fetch_plane<CUS>(rp, Wt, nbx, nby, by, bx, c.y0, c.x0, c.init, -1, i - 1);
  for (int i = t; i < CUS; i += NT)
    s.left[i] = fetch_plane<CUS>(rp, Wt, nbx, nby, by, bx, c.y0, c.x0, c.init, i, -1);
  __syncthreads();
  *flag_o = fl + by * nbx + bx;
  return static_cast<size_t>(p) * nb + by * nbx + bx;
}

// End of a CU: write its reconstruction, then release its flag.
template <int CUS, int NT>
__device__ void end_cu(const Smem<CUS>& s, const Ctx& c, int32_t* rec, int nby, int p,
                       int* flag) {
  const size_t plane = static_cast<size_t>(p) * nby * CUS * c.Wt;
  for (int i = threadIdx.x; i < CUS * CUS; i += NT)
    rec[plane + (c.y0 + i / CUS) * c.Wt + c.x0 + i % CUS] = s.cur[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, 1);
  }
}

__global__ void __launch_bounds__(THREADS32, 1)
wavefront_encode32_kernel(const int32_t* src, const int32_t* ref, const float* w32,
                          const float* w16, const float* w8, const float* mvc,
                          const float* qstep, const float* inv_q, const float* lam,
                          const float* pen, const int32_t* dq, const int32_t* maxv,
                          const int32_t* itab, const float* ftab, int8_t* s32_o,
                          int8_t* m32_o, int16_t* c32_o, int8_t* s16_o, int8_t* modes_o,
                          int16_t* c16_o, int32_t* rec, int* flags, int PT, int nby,
                          int nbx) {
  constexpr int NT = THREADS32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<32>& s = *reinterpret_cast<Smem<32>*>(smem_raw);
  Ctx c;
  int* flag;
  const size_t cu = begin_cu<32, NT>(s, c, src, ref, qstep, inv_q, lam, dq, maxv, itab, ftab,
                                     rec, flags, PT, nby, nbx, &flag);
  const int p = s.tk_p;
  const int t = threadIdx.x;
  const float pen32 = __fadd_rn(pen[p], mvc[cu]);
  const float mvc16 = __fmul_rn(0.25f, mvc[cu]);
  const float pen16 = __fadd_rn(pen[p], mvc16);
  const float pen8 = __fadd_rn(pen[p], __fmul_rn(0.25f, mvc16));
  const int32_t* fz16 = itab + OFF_FZ16;

  // ---- whole-32 candidate (its references lie outside the CU)
  load_refs<32, NT, 32>(c, s, 0, 0, true);
  const Best b32 = eval_block<32, NT, 32>(c, s, 0, 0, w32[cu], pen32, s.levw);
  winner_pred<32, NT, 32>(c, s, 0, 0, b32.mode, s.predw);
  float cs32 = c.lam;

  // ---- four 16-quadrants
  for (int q = 0; q < 4; ++q) {
    const int qy = (q >> 1) * 16, qx = (q & 1) * 16;
    const size_t cq = cu * 4 + q;
    load_refs<32, NT, 16>(c, s, qy, qx, true);
    const Best b16 = eval_block<32, NT, 16>(c, s, qy, qx, w16[cq], pen16, s.lev16);
    winner_pred<32, NT, 16>(c, s, qy, qx, b16.mode, s.pred16);
    const float cs16 = code_subs<32, NT>(c, s, qy, qx, w8 + cq * 4, pen8);
    const bool split16 = cs16 < b16.cost;
    cs32 = __fadd_rn(__fadd_rn(cs32, fminf(b16.cost, cs16)), c.lam);
    if (split16) {
      for (int i = t; i < 256; i += NT) c16_o[cq * 256 + i] = s.c8[i];
      if (t < 4) modes_o[cq * 4 + t] = static_cast<int8_t>(s.m8[t]);
    } else {
      for (int i = t; i < 256; i += NT) c16_o[cq * 256 + i] = s.lev16[fz16[i]];
      if (t < 4) modes_o[cq * 4 + t] = static_cast<int8_t>(t == 0 ? b16.mode : 0);
      reconstruct<32, NT, 16>(c, s, qy, qx, s.lev16, 16, s.pred16);
    }
    if (t == 0) s16_o[cq] = split16 ? 1 : 0;
  }

  // ---- the whole-32 syntax, and its reconstruction when it wins
  const bool split32 = cs32 < b32.cost;
  for (int i = t; i < 1024; i += NT) c32_o[cu * 1024 + i] = s.levw[itab[OFF_FZ32 + i]];
  if (t == 0) {
    s32_o[cu] = split32 ? 1 : 0;
    m32_o[cu] = static_cast<int8_t>(b32.mode);
  }
  if (!split32) reconstruct<32, NT, 32>(c, s, 0, 0, s.levw, 32, s.predw);
  end_cu<32, NT>(s, c, rec, nby, p, flag);
}

// The two-level (16/8) encoder of the planes above 10 bits: a 16x16 CU per
// ticket; the whole 16x16 block against four 8x8 blocks in z-order, exactly
// the quadrant step of the kernel above with the CU's own MV rate
// (reference `_build_encode.run`, hevc.py:811-930).
__global__ void __launch_bounds__(THREADS16, 2)
wavefront_encode16_kernel(const int32_t* src, const int32_t* ref, const float* w16,
                          const float* w8, const float* mvc, const float* qstep,
                          const float* inv_q, const float* lam, const float* pen,
                          const int32_t* dq, const int32_t* maxv, const int32_t* itab,
                          const float* ftab, int8_t* split_o, int8_t* modes_o,
                          int16_t* coeff_o, int32_t* rec, int* flags, int PT, int nby,
                          int nbx) {
  constexpr int NT = THREADS16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<16>& s = *reinterpret_cast<Smem<16>*>(smem_raw);
  Ctx c;
  int* flag;
  const size_t cu = begin_cu<16, NT>(s, c, src, ref, qstep, inv_q, lam, dq, maxv, itab, ftab,
                                     rec, flags, PT, nby, nbx, &flag);
  const int p = s.tk_p;
  const int t = threadIdx.x;
  const float pen16 = __fadd_rn(pen[p], mvc[cu]);
  const float pen8 = __fadd_rn(pen[p], __fmul_rn(0.25f, mvc[cu]));

  load_refs<16, NT, 16>(c, s, 0, 0, true);
  const Best b16 = eval_block<16, NT, 16>(c, s, 0, 0, w16[cu], pen16, s.levw);
  winner_pred<16, NT, 16>(c, s, 0, 0, b16.mode, s.predw);
  const float cs = code_subs<16, NT>(c, s, 0, 0, w8 + cu * 4, pen8);
  const bool split = cs < b16.cost;
  if (split) {
    for (int i = t; i < 256; i += NT) coeff_o[cu * 256 + i] = s.c8[i];
    if (t < 4) modes_o[cu * 4 + t] = static_cast<int8_t>(s.m8[t]);
  } else {
    for (int i = t; i < 256; i += NT) coeff_o[cu * 256 + i] = s.levw[itab[OFF_FZ16 + i]];
    if (t < 4) modes_o[cu * 4 + t] = static_cast<int8_t>(t == 0 ? b16.mode : 0);
    reconstruct<16, NT, 16>(c, s, 0, 0, s.levw, 16, s.predw);
  }
  if (t == 0) split_o[cu] = split ? 1 : 0;
  end_cu<16, NT>(s, c, rec, nby, p, flag);
}

// the dynamic shared memory a block takes; with `two_per_sm` the largest
// carveout, so that two blocks fit an SM (else CUDA's own choice leaves
// the rest to L1)
template <typename K>
cudaError_t prepare(K kernel, size_t smem, bool two_per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess || !two_per_sm) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// One launch, on `stream`.  src/ref/rec: (PT, nby*32, nbx*32) int32; w32
// (PT, nb), w16 (PT, nb, 4), w8 (PT, nb, 4, 4), mvc (PT, nb) float32;
// qstep, inv_q, lam, pen (PT,) float32; dq, maxv (PT,) int32; itab/ftab:
// hevc.py `_tables` blobs; flags: (PT * nb + 1,) int32 zeros (the CUs'
// ready flags, then the ticket counter).  Outputs: s32/m32 (PT, nb) int8,
// c32 (PT, nb, 1024) int16 zigzag, s16 (PT, nb, 4) int8, modes (PT, nb, 4,
// 4) int8, c16 (PT, nb, 4, 256) int16 zigzag.  *launched (host memory)
// receives the number of grids launched.
extern "C" int wavefront_encode32(
    const int32_t* src, const int32_t* ref, const float* w32, const float* w16,
    const float* w8, const float* mvc, const float* qstep, const float* inv_q,
    const float* lam, const float* pen, const int32_t* dq, const int32_t* maxv,
    const int32_t* itab, const float* ftab, int8_t* s32, int8_t* m32,
    int16_t* c32, int8_t* s16, int8_t* modes, int16_t* c16, int32_t* rec, int32_t* flags,
    int PT, int nby, int nbx, void* stream, int* launched) {
  *launched = 0;
  const long long total = static_cast<long long>(PT) * nby * nbx;
  if (total == 0) return 0;
  cudaError_t e = prepare(wavefront_encode32_kernel, sizeof(Smem<32>), false);
  if (e != cudaSuccess) return static_cast<int>(e);
  wavefront_encode32_kernel<<<static_cast<unsigned>(total), THREADS32, sizeof(Smem<32>),
                              static_cast<cudaStream_t>(stream)>>>(
      src, ref, w32, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxv, itab, ftab, s32, m32,
      c32, s16, modes, c16, rec, flags, PT, nby, nbx);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// The two-level (16/8) entry: one launch, on `stream`.  src/ref/rec: (PT,
// nby*16, nbx*16) int32; w16 (PT, nb), w8 (PT, nb, 4), mvc (PT, nb)
// float32; qstep, inv_q, lam, pen, dq, maxv, flags as above.  Outputs:
// split (PT, nb) int8, modes (PT, nb, 4) int8 ([m16, 0, 0, 0] for a whole
// block), coeffs (PT, nb, 256) int16 zigzag (four 64-level 8x8 blocks when
// split).  *launched receives the number of grids launched.
extern "C" int wavefront_encode16(
    const int32_t* src, const int32_t* ref, const float* w16, const float* w8,
    const float* mvc, const float* qstep, const float* inv_q, const float* lam,
    const float* pen, const int32_t* dq, const int32_t* maxv, const int32_t* itab,
    const float* ftab, int8_t* split, int8_t* modes, int16_t* coeffs, int32_t* rec,
    int32_t* flags, int PT, int nby, int nbx, void* stream, int* launched) {
  *launched = 0;
  const long long total = static_cast<long long>(PT) * nby * nbx;
  if (total == 0) return 0;
  cudaError_t e = prepare(wavefront_encode16_kernel, sizeof(Smem<16>), true);
  if (e != cudaSuccess) return static_cast<int>(e);
  wavefront_encode16_kernel<<<static_cast<unsigned>(total), THREADS16, sizeof(Smem<16>),
                              static_cast<cudaStream_t>(stream)>>>(
      src, ref, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxv, itab, ftab, split, modes,
      coeffs, rec, flags, PT, nby, nbx);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a block of each entry takes (bytes), for reports.
extern "C" int wavefront_encode_smem(int two_level) {
  return static_cast<int>(two_level ? sizeof(Smem<16>) : sizeof(Smem<32>));
}
