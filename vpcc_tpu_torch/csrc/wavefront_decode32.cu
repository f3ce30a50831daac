// Kernel A: wavefront decode of the three-level (32/16/8) CU syntax, and
// (entry `wavefront_decode16`) of the two-level (16/8) one.
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_build_decode32.run`
// (hevc.py:1167-1251, with `_decode_cu16` 1117, `_predict_all` 94 and
// `_int_recon` 113): reconstruct int32 sample planes from split flags,
// intra/inter modes and zigzag coefficient levels, bit-exactly.  The
// two-level entry replaces `_build_decode.run` (hevc.py:1263-1346, planes
// whose maxval is above 1023): the same blocks on a wavefront of 16x16
// CUs (the device functions take the CU size as a template argument).
//
// What is decoded.  A CU's quadtree in z-order: the whole 32x32 block, or
// four 16x16 quadrants, each whole or as four 8x8 sub-blocks (two-level:
// the whole 16x16 block or four 8x8 ones).  Each block is predicted in its
// decoded mode (planar and DC by formula, angular by HEVC's two-tap
// interpolation along the mode's main reference, built from the block's
// reference vector with intraPredAngle and invAngle: the same taps as
// hevc_tables.py `angular_taps`; inter from the motion-compensated plane)
// and gets the inverse transform of its dequantised levels added, clipped
// to [0, maxval].  Reference samples are the natural neighbours of the
// block: inside the CU the samples decoded so far (init elsewhere), outside
// it the plane's samples where that CU lies on an earlier diagonal
// d = 2*by + bx, else the init value (maxval+1)/2; bottom-left references
// are the init value except for the first two 8x8 sub-blocks of a
// quadrant, as the JAX reference builds them.  The JAX program predicts all
// 36 modes and selects one: the result is the same.
//
// Integer exactness.  Levels are clipped to 20 bits after dequantisation,
// the first stage (T^T d + 2^10) >> 11 and the second (e T + 2^(s2-1)) >>
// s2, s2 = 7 + log2 n, run in wrapping 32-bit arithmetic (unsigned
// accumulation, as XLA's int32 dots wrap): exact in any order of the
// additions, so threads and blocks may split the work freely; the three
// rounding points stay where they are.  An all-zero block's residual is 0
// (0 + 2^10 >> 11 = 0, then 0 + 2^(s2-1) >> s2 = 0): its transform is
// skipped.
//
// Design (Hopper).  One launch a call.  The grid holds one block per (tile
// plane, CU); each block takes a ticket from an atomic counter and decodes
// the CU that ticket names, CUs handed out in wavefront-diagonal order over
// all planes (plane by plane within a diagonal, row by row within a plane),
// so no block waits on a CU that has not started.  A block first does all
// the work that needs no neighbour: it loads the CU's syntax, levels and
// inter samples and the transform and scan tables into shared memory,
// dequantises, and runs the inverse transforms of every block of the CU's
// tree at once (a thread per sample and stage, n multiply-adds each; the
// transform of the whole CU skipped when `__syncthreads_or` finds no
// nonzero level, that of an all-zero block skipped by its flag).  Only
// then does it wait on acquire loads of the ready flags of its left,
// top-left, top and top-right neighbours (four threads, one flag each),
// copy their border samples into shared memory, run the z-order chain of
// predictions (two barriers a block; each sample goes to the plane as it
// is predicted) and release its flag (`st.release` after the last block's
// barrier: no other fence).  Only that
// chain, the border copy and the flag hand-over lie on the critical path
// (one warp running a split CU's chain alone was slower: it exposes the
// latency of each prediction).  The wrapper zeroes the flags
// and the counter; the kernel allocates nothing.  The availability rule is
// the reference's: a sample outside the CU is read only from a CU on an
// earlier diagonal (`fetch_plane`); the flags only make sure those samples
// are written (a CU that happens to be finished on the same or a later
// diagonal stays unavailable).
//
// Occupancy.  256 threads a 32x32 CU (~25 KB of shared memory), 128 a
// 16x16 CU of the two-level entry (~6 KB), so several CUs share an SM: the
// blocks ahead of the wavefront run their transforms while the front
// advances, and a 28,160-CU two-level plane keeps the card busy.
//
// Bound: one pass over the syntax (int8 flags and modes, int16 levels) and
// the reference plane at inter samples, one write of the plane; the
// integer work is 2n multiply-adds per sample of a coded n-block.  Both
// are microseconds; what is left is the wavefront's critical path (one CU
// a diagonal: 22 diagonals at 8x8 CUs a tile, 52 at the two-level
// entry's 22x16) and, inside a CU, the chain of up to 16 dependent 8x8
// predictions.  No tensor core is used: the dequantised levels are up to
// 20-bit, too wide for int8 MMA, and the products are too few to matter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// int blob (hevc.py `_tables`): T32 T16 T8 | izz32 izz16 izz8 | ...
constexpr int OFF_T32 = 0;
constexpr int OFF_T16 = OFF_T32 + 32 * 32;
constexpr int OFF_T8 = OFF_T16 + 16 * 16;
constexpr int OFF_ZZ32 = OFF_T8 + 8 * 8;  // inverse zigzags (raster -> scan)
constexpr int OFF_ZZ16 = OFF_ZZ32 + 32 * 32;
constexpr int OFF_ZZ8 = OFF_ZZ16 + 16 * 16;
constexpr int MODE_INTER = 35;

constexpr int THREADS32 = 256;  // the 32/16/8 entry
constexpr int THREADS16 = 128;  // the two-level entry

// HEVC's intraPredAngle of modes 0..34 (0 and 1 unused), and the inverse
// angle of each negative angle a at index -a (hevc_tables.py `_ANGLES`,
// `_INV_ANGLE`)
__constant__ int c_angle[35] = {0,   0,   32,  26,  21,  17,  13,  9,   5,  2,  0,  -2,
                                -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                                -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
__constant__ int c_inv_angle[33] = {0, 0, 4096, 0,   0, 1638, 0, 0, 0,   910, 0,
                                    0, 0, 630,  0,   0, 0,    482, 0, 0, 0, 390,
                                    0, 0, 0,    0,   315, 0, 0,   0, 0, 0, 256};

// blocks of a CU's tree: CUS = 32: 0 the whole CU, 1 + q the 16x16
// quadrant q, 5 + 4q + s its 8x8 sub-block s; CUS = 16: 0 the whole CU,
// 1 + s the 8x8 sub-block s
template <int CUS>
struct __align__(16) Smem {
  static constexpr int NN = CUS * CUS;
  static constexpr int TABN = CUS == 32 ? 1344 : 320;  // T and izz of each level
  static constexpr int NBLK = CUS == 32 ? 21 : 5;
  int cur[NN];        // the CU's samples decoded so far (init elsewhere)
  int res[NN];        // dequantised levels (raster), then the residual
  int tmp[NN];        // the first transform stage
  int refb[NN];       // inter prediction samples of the inter blocks
  int16_t lev[NN];    // the CU's levels as coded (scan order per block)
  int16_t tq[TABN];   // the integer transforms of each level
  int16_t izz[TABN];  // inverse zigzags of each level
  int refv[4 * CUS + 1];
  int mref[3 * CUS + 1];  // the block's angular main reference
  int top[2 * CUS + 1];   // row -1, columns -1 .. 2 * CUS - 1
  int left[CUS];          // column -1, rows 0 .. CUS - 1
  int nz[NBLK];           // a block holds a nonzero level
  int mode[NBLK];
  int split, split16[4];
  int tk_p, tk_by, tk_bx;
};

// offset of level n's tables in the shared copy
template <int CUS>
__device__ __forceinline__ int tab_off(int n) {
  return CUS == 32 ? (n == 32 ? 0 : n == 16 ? 1024 : 1280) : (n == 16 ? 0 : 256);
}

struct Ctx {
  int32_t* out;  // the CU's origin in the decoded plane
  int Wt, y0, x0, init, maxv, dq;
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

// the block of the CU's tree that holds sample (y, x): its size, origin,
// index and first level in `lev`
template <int CUS>
__device__ __forceinline__ void block_of(const Smem<CUS>& s, int y, int x, int& n, int& oy,
                                         int& ox, int& blk, int& base) {
  if (!s.split) {
    n = CUS, oy = 0, ox = 0, blk = 0, base = 0;
  } else if (CUS == 16) {
    const int sub = (y >> 3) * 2 + (x >> 3);
    n = 8, oy = y & ~7, ox = x & ~7, blk = 1 + sub, base = sub * 64;
  } else {
    const int q = (y >> 4) * 2 + (x >> 4);
    if (!s.split16[q]) {
      n = 16, oy = y & ~15, ox = x & ~15, blk = 1 + q, base = q * 256;
    } else {
      const int sub = ((y >> 3) & 1) * 2 + ((x >> 3) & 1);
      n = 8, oy = y & ~7, ox = x & ~7, blk = 5 + 4 * q + sub, base = q * 256 + sub * 64;
    }
  }
}

// first stage at row i, column k of an N-block at (oy, ox):
// (sum_j T[j][i] d[j][k] + 2^10) >> 11, wrapping
template <int CUS, int N>
__device__ __forceinline__ int stage1(const Smem<CUS>& s, int oy, int ox, int i, int k) {
  const int16_t* T = s.tq + tab_off<CUS>(N);
  const int* d = s.res + oy * CUS + ox + k;
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc += static_cast<uint32_t>(static_cast<int>(T[j * N + i])) *
           static_cast<uint32_t>(d[j * CUS]);
  acc += 1u << 10;
  return static_cast<int32_t>(acc) >> 11;
}

// second stage: (sum_j e[i][j] T[j][k] + 2^(s2-1)) >> s2, wrapping
template <int CUS, int N>
__device__ __forceinline__ int stage2(const Smem<CUS>& s, int oy, int ox, int i, int k) {
  constexpr int S2 = 7 + (N == 32 ? 5 : N == 16 ? 4 : 3);
  const int16_t* T = s.tq + tab_off<CUS>(N);
  const int* e = s.tmp + (oy + i) * CUS + ox;
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc += static_cast<uint32_t>(e[j]) * static_cast<uint32_t>(static_cast<int>(T[j * N + k]));
  acc += 1u << (S2 - 1);
  return static_cast<int32_t>(acc) >> S2;
}

// sample (yy, xx) relative to the CU origin in the plane, as the reference
// sees it: only CUs on earlier diagonals are available
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

// sample (yy, xx) relative to the CU origin: inside the CU the samples
// decoded so far; outside, the border copied after the neighbours finished
// (row -1 and column -1 are the only samples outside a CU that can lie on
// an earlier diagonal), else the init value
template <int CUS>
__device__ __forceinline__ int fetch(const Smem<CUS>& s, int init, int yy, int xx) {
  if (yy >= 0 && yy < CUS && xx >= 0 && xx < CUS) return s.cur[yy * CUS + xx];
  if (yy == -1 && xx < 2 * CUS) return s.top[xx + 1];
  if (xx == -1 && yy >= 0 && yy < CUS) return s.left[yy];
  return init;
}

// entry t of the reference vector of the N x N block at (oy, ox): corner,
// 2N above, 2N left
template <int CUS, int N>
__device__ __forceinline__ int ref_at(const Smem<CUS>& s, int init, int oy, int ox,
                                      bool bl_init, int t) {
  if (t == 0) return fetch<CUS>(s, init, oy - 1, ox - 1);
  if (t <= 2 * N) return fetch<CUS>(s, init, oy - 1, ox + t - 1);
  if (t <= 3 * N || !bl_init) return fetch<CUS>(s, init, oy + t - 2 * N - 1, ox - 1);
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
__device__ __forceinline__ int predict(const Smem<CUS>& s, int mode, int dc, int y, int x,
                                       int oy, int ox) {
  constexpr int LOG2 = N == 32 ? 5 : N == 16 ? 4 : 3;
  const int* refv = s.refv;
  if (mode == 0) {  // planar
    return ((N - 1 - x) * refv[2 * N + 1 + y] + (x + 1) * refv[N + 1] +
            (N - 1 - y) * refv[1 + x] + (y + 1) * refv[3 * N + 1] + N) >>
           (LOG2 + 1);
  }
  if (mode == 1) return dc;
  if (mode == MODE_INTER) return s.refb[(oy + y) * CUS + ox + x];
  // angular: ((32 - f) * a + f * b + 16) >> 5 along the main reference
  const int a = c_angle[mode];
  const bool vertical = mode >= 18;
  const int u = vertical ? y : x, v = vertical ? x : y;
  const int tt = (v + 1) * a;
  const int f = tt & 31;
  const int* m = s.mref + N - 1 + u + (tt >> 5) + 1;
  return ((32 - f) * m[0] + f * m[1] + 16) >> 5;
}

// Predict the N x N block at (oy, ox) in `mode` and add its residual into
// `cur` (all threads call; two barriers).
template <int CUS, int NT, int N>
__device__ void predict_block(Smem<CUS>& s, const Ctx& c, int oy, int ox, bool bl_init,
                              int mode) {
  constexpr int M = 3 * N + 1;
  const bool angular = mode >= 2 && mode < MODE_INTER;
  const int a = angular ? c_angle[mode] : 0;
  for (int t = threadIdx.x; t < 4 * N + 1 + (angular ? M : 0); t += NT) {
    if (t < 4 * N + 1) {
      s.refv[t] = ref_at<CUS, N>(s, c.init, oy, ox, bl_init, t);
    } else {
      const int e = t - (4 * N + 1), k = e - N + 1;
      const int idx = k < 0 && a >= 0 ? 0 : ref_index<N>(k, mode >= 18, a);  // (unused if so)
      s.mref[e] = ref_at<CUS, N>(s, c.init, oy, ox, bl_init, idx);
    }
  }
  __syncthreads();
  int dc = 0;
  if (mode == 1) {  // DC over the N top and N left samples
    constexpr int LOG2 = N == 32 ? 5 : N == 16 ? 4 : 3;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < N; ++q) sum += s.refv[1 + q] + s.refv[2 * N + 1 + q];
    dc = (sum + N) >> (LOG2 + 1);
  }
  for (int t = threadIdx.x; t < N * N; t += NT) {
    const int y = t / N, x = t % N;
    const int o = (oy + y) * CUS + ox + x;
    const int v = min(max(predict<CUS, N>(s, mode, dc, y, x, oy, ox) + s.res[o], 0), c.maxv);
    s.cur[o] = v;
    c.out[(oy + y) * c.Wt + ox + x] = v;  // the plane takes each sample as it is final
  }
  __syncthreads();
}

// Decode the CU this block's ticket names.  CUS = 32: s32/m32 (PT, nb),
// c32 (PT, nb, 1024), s16 (PT, nb, 4), modes (PT, nb, 4, 4), c16 (PT, nb,
// 4, 256); CUS = 16: s32 = split (PT, nb), modes (PT, nb, 4), c32 = coeffs
// (PT, nb, 256), m32, s16 and c16 unused.
template <int CUS, int NT>
__device__ void decode_cu(int32_t* rec, const int32_t* ref, const int8_t* s32,
                          const int8_t* m32, const int16_t* c32, const int8_t* s16,
                          const int8_t* modes, const int16_t* c16, const int32_t* dq,
                          const int32_t* maxv, const int32_t* tables, int* flags, int PT,
                          int nby, int nbx) {
  constexpr int NN = CUS * CUS;
  __shared__ Smem<CUS> s;
  const int t = threadIdx.x;
  const int nb = nby * nbx;
  if (t == 0) claim(flags + static_cast<size_t>(PT) * nb, PT, nby, nbx, &s.tk_p, &s.tk_by,
                    &s.tk_bx);
  __syncthreads();
  const int p = s.tk_p, by = s.tk_by, bx = s.tk_bx;
  const size_t cu = static_cast<size_t>(p) * nb + by * nbx + bx;
  Ctx c;
  c.Wt = nbx * CUS;
  c.y0 = by * CUS;
  c.x0 = bx * CUS;
  c.maxv = maxv[p];
  c.init = (c.maxv + 1) / 2;
  c.dq = dq[p];
  const size_t plane = static_cast<size_t>(p) * nby * CUS * c.Wt;
  c.out = rec + plane + static_cast<size_t>(c.y0) * c.Wt + c.x0;

  // 1. syntax, tables; the CU's samples start at the init value
  if (t == 0) s.split = s32[cu];
  if (CUS == 32) {
    if (t < 4) s.split16[t] = s16[cu * 4 + t];
    if (t == 4) s.mode[0] = m32[cu];
    if (t >= 5 && t < 21) {  // quadrant q's 16x16 mode, then its four 8x8 modes
      const int q = (t - 5) / 4, sub = (t - 5) % 4;
      s.mode[t] = modes[(cu * 4 + q) * 4 + sub];
      if (sub == 0) s.mode[1 + q] = modes[(cu * 4 + q) * 4];
    }
  } else if (t < 4) {
    s.mode[1 + t] = modes[cu * 4 + t];
    if (t == 0) s.mode[0] = modes[cu * 4];
  }
  if (t < Smem<CUS>::NBLK) s.nz[t] = 0;
  for (int i = t; i < Smem<CUS>::TABN; i += NT) {
    int n, o;
    if (CUS == 32 && i < 1024) n = 32, o = i;
    else if (i < (CUS == 32 ? 1280 : 256)) n = 16, o = i - (CUS == 32 ? 1024 : 0);
    else n = 8, o = i - (CUS == 32 ? 1280 : 256);
    s.tq[i] = static_cast<int16_t>(tables[(n == 32 ? OFF_T32 : n == 16 ? OFF_T16 : OFF_T8) + o]);
    s.izz[i] =
        static_cast<int16_t>(tables[(n == 32 ? OFF_ZZ32 : n == 16 ? OFF_ZZ16 : OFF_ZZ8) + o]);
  }
  for (int i = t; i < NN; i += NT) s.cur[i] = c.init;
  __syncthreads();
  if (t < Smem<CUS>::NBLK) s.mode[t] = min(max(s.mode[t], 0), MODE_INTER);

  // 2. the levels as coded; the inter samples of inter blocks
  if (CUS == 16 || !s.split) {
    const int16_t* src = c32 + cu * NN;
    for (int i = t; i < NN; i += NT) s.lev[i] = src[i];
  } else {
    const int16_t* src = c16 + cu * 4 * 256;
    for (int i = t; i < NN; i += NT) s.lev[i] = src[i];
  }
  __syncthreads();
  // 3. dequantise into raster order, clipped to 20 bits; inter samples
  bool any = false;
  for (int i = t; i < NN; i += NT) {
    const int y = i / CUS, x = i % CUS;
    int n, oy, ox, blk, base;
    block_of<CUS>(s, y, x, n, oy, ox, blk, base);
    const int lv = s.lev[base + s.izz[tab_off<CUS>(n) + (y - oy) * n + (x - ox)]];
    const int dv = lv * c.dq;
    s.res[i] = min(max(dv, -(1 << 19)), (1 << 19) - 1);
    if (lv != 0) {
      any = true;
      s.nz[blk] = 1;
    }
    if (s.mode[blk] == MODE_INTER) s.refb[i] = ref[plane + (c.y0 + y) * c.Wt + c.x0 + x];
  }
  // 4. the inverse transforms of every coded block of the tree at once
  if (__syncthreads_or(any)) {
    for (int i = t; i < NN; i += NT) {
      const int y = i / CUS, x = i % CUS;
      int n, oy, ox, blk, base;
      block_of<CUS>(s, y, x, n, oy, ox, blk, base);
      if (!s.nz[blk]) continue;
      if (n == 8) s.tmp[i] = stage1<CUS, 8>(s, oy, ox, y - oy, x - ox);
      else if (n == 16) s.tmp[i] = stage1<CUS, 16>(s, oy, ox, y - oy, x - ox);
      else s.tmp[i] = stage1<CUS, CUS>(s, oy, ox, y - oy, x - ox);
    }
    __syncthreads();
    for (int i = t; i < NN; i += NT) {
      const int y = i / CUS, x = i % CUS;
      int n, oy, ox, blk, base;
      block_of<CUS>(s, y, x, n, oy, ox, blk, base);
      if (!s.nz[blk]) continue;  // its dequantised levels are all 0 already
      if (n == 8) s.res[i] = stage2<CUS, 8>(s, oy, ox, y - oy, x - ox);
      else if (n == 16) s.res[i] = stage2<CUS, 16>(s, oy, ox, y - oy, x - ox);
      else s.res[i] = stage2<CUS, CUS>(s, oy, ox, y - oy, x - ox);
    }
  }

  // 5. wait for the left, top-left, top and top-right CUs (a thread each);
  // copy the border
  int* fl = flags + static_cast<size_t>(p) * nb;
  if (t < 4) {
    const int ny = t == 0 ? by : by - 1;
    const int nx = bx + (t == 0 ? -1 : t - 2);
    if (ny >= 0 && nx >= 0 && nx < nbx) {
      while (ld_acquire(fl + ny * nbx + nx) == 0) __nanosleep(32);
    }
  }
  __syncthreads();
  const int32_t* rp = rec + plane;
  for (int i = t; i < 3 * CUS + 1; i += NT) {
    if (i < 2 * CUS + 1)
      s.top[i] = fetch_plane<CUS>(rp, c.Wt, nbx, nby, by, bx, c.y0, c.x0, c.init, -1, i - 1);
    else
      s.left[i - 2 * CUS - 1] = fetch_plane<CUS>(rp, c.Wt, nbx, nby, by, bx, c.y0, c.x0,
                                                 c.init, i - 2 * CUS - 1, -1);
  }
  __syncthreads();

  // 6. the predictions in z-order
  if (!s.split) {
    predict_block<CUS, NT, CUS>(s, c, 0, 0, true, s.mode[0]);
  } else if (CUS == 16) {
    for (int sub = 0; sub < 4; ++sub)
      predict_block<CUS, NT, 8>(s, c, (sub >> 1) * 8, (sub & 1) * 8, sub >= 2, s.mode[1 + sub]);
  } else {
    for (int q = 0; q < 4; ++q) {
      const int qy = (q >> 1) * 16, qx = (q & 1) * 16;
      if (!s.split16[q]) {
        predict_block<CUS, NT, 16>(s, c, qy, qx, true, s.mode[1 + q]);
      } else {
        for (int sub = 0; sub < 4; ++sub)
          predict_block<CUS, NT, 8>(s, c, qy + (sub >> 1) * 8, qx + (sub & 1) * 8, sub >= 2,
                                    s.mode[5 + 4 * q + sub]);
      }
    }
  }

  // 7. release the flag (the last block's barrier ordered every thread's
  // writes of the CU before it)
  if (t == 0) st_release(fl + by * nbx + bx, 1);
}

__global__ void __launch_bounds__(THREADS32)
wavefront_decode32_kernel(int32_t* rec, const int32_t* ref, const int8_t* s32,
                          const int8_t* m32, const int16_t* c32, const int8_t* s16,
                          const int8_t* modes, const int16_t* c16, const int32_t* dq,
                          const int32_t* maxv, const int32_t* tables, int* flags, int PT,
                          int nby, int nbx) {
  decode_cu<32, THREADS32>(rec, ref, s32, m32, c32, s16, modes, c16, dq, maxv, tables, flags,
                           PT, nby, nbx);
}

__global__ void __launch_bounds__(THREADS16)
wavefront_decode16_kernel(int32_t* rec, const int32_t* ref, const int8_t* split,
                          const int8_t* modes, const int16_t* coeffs, const int32_t* dq,
                          const int32_t* maxv, const int32_t* tables, int* flags, int PT,
                          int nby, int nbx) {
  decode_cu<16, THREADS16>(rec, ref, split, nullptr, coeffs, nullptr, modes, nullptr, dq, maxv,
                           tables, flags, PT, nby, nbx);
}

}  // namespace

// One launch, on `stream`.  rec/ref: (PT, nby*32, nbx*32) int32; s32/m32
// (PT, nb) int8; c32 (PT, nb, 1024) int16 zigzag; s16 (PT, nb, 4) int8;
// modes (PT, nb, 4, 4) int8; c16 (PT, nb, 4, 256) int16 zigzag; dq/maxv
// (PT,) int32; tables: see hevc.py `_tables`; flags (PT * nb + 1) int32,
// zeroed by the caller (the CUs' ready flags, then the ticket counter).
// *launched (host memory) receives the number of grids launched (1, or 0
// for an empty stack).
extern "C" int wavefront_decode32(int32_t* rec, const int32_t* ref,
                                  const int8_t* s32, const int8_t* m32,
                                  const int16_t* c32, const int8_t* s16,
                                  const int8_t* modes, const int16_t* c16,
                                  const int32_t* dq, const int32_t* maxv,
                                  const int32_t* tables, int* flags, int PT, int nby,
                                  int nbx, void* stream, int* launched) {
  *launched = 0;
  const long long blocks = static_cast<long long>(PT) * nby * nbx;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  wavefront_decode32_kernel<<<static_cast<unsigned>(blocks), THREADS32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      rec, ref, s32, m32, c32, s16, modes, c16, dq, maxv, tables, flags, PT, nby, nbx);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// The two-level (16/8) entry: one launch, on `stream`.  rec/ref: (PT,
// nby*16, nbx*16) int32; split (PT, nb) int8; modes (PT, nb, 4) int8 ([m16,
// 0, 0, 0] for a whole block); coeffs (PT, nb, 256) int16 zigzag (four
// 64-level 8x8 blocks when split); dq/maxv (PT,) int32; flags (PT * nb + 1)
// int32, zeroed by the caller.  *launched receives the number of grids
// launched.
extern "C" int wavefront_decode16(int32_t* rec, const int32_t* ref, const int8_t* split,
                                  const int8_t* modes, const int16_t* coeffs,
                                  const int32_t* dq, const int32_t* maxv,
                                  const int32_t* tables, int* flags, int PT, int nby,
                                  int nbx, void* stream, int* launched) {
  *launched = 0;
  const long long blocks = static_cast<long long>(PT) * nby * nbx;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  wavefront_decode16_kernel<<<static_cast<unsigned>(blocks), THREADS16, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      rec, ref, split, modes, coeffs, dq, maxv, tables, flags, PT, nby, nbx);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}
