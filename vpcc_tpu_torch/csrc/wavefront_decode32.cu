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
// Design.  CUs on one wavefront diagonal d = 2*by + bx are independent
// (their up, up-left, up-right and left neighbours lie on diagonals d-1..d-3),
// so the host loop launches one grid per diagonal: one block per (tile
// plane, 32x32 CU) on the diagonal, 1024 threads = one per pixel.  The block
// keeps the CU's samples in shared memory and decodes the quadtree in
// z-order: the whole 32x32 block, or four 16x16 quadrants, each whole or
// as four 8x8 sub-blocks.  Reference samples are the natural neighbours of
// the block: inside the CU from shared memory (not yet decoded = the init
// value), outside it from the plane when that CU lies on an earlier
// diagonal, else the init value (maxval+1)/2.  Bottom-left references are
// the init value except for the first two 8x8 sub-blocks of a quadrant,
// exactly as the JAX reference builds them.  Only the decoded mode is
// predicted (planar and DC by formula, angular from the 2-tap tables, inter
// from the motion-compensated reference plane); the JAX program predicts
// all 36 modes and selects one — the result is the same.  The inverse
// transform runs in 32-bit two's-complement arithmetic (unsigned
// accumulation), so it wraps exactly like XLA's int32 dot products.
//
// Bound: one pass over the syntax (int8 flags and modes, int16 levels) and
// the reference plane, one write of the plane; the integer work is
// 2*n MACs per pixel for the two transform stages.  The wavefront's
// sequential diagonals and the 16/8 z-order dependencies inside a CU keep
// most of the card idle at these plane sizes: latency, not bytes, bounds it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OFF_T32 = 0;
constexpr int OFF_T16 = OFF_T32 + 32 * 32;
constexpr int OFF_T8 = OFF_T16 + 16 * 16;
constexpr int OFF_ZZ32 = OFF_T8 + 8 * 8;
constexpr int OFF_ZZ16 = OFF_ZZ32 + 32 * 32;
constexpr int OFF_ZZ8 = OFF_ZZ16 + 16 * 16;
constexpr int OFF_A32 = OFF_ZZ8 + 8 * 8;
constexpr int OFF_A16 = OFF_A32 + 33 * 32 * 32 * 4;
constexpr int OFF_A8 = OFF_A16 + 33 * 16 * 16 * 4;
constexpr int MODE_INTER = 35;

struct CuCtx {
  const int32_t* rec;   // this tile plane's decoded samples (earlier diagonals)
  const int32_t* ref;   // this tile plane's inter prediction samples
  int Wt, nbx, nby, d, by, bx, y0, x0, init, maxv, dq;
};

// sample at (yy, xx) relative to the origin of a CUS x CUS CU, as the
// reference sees it (diagonals count CUs of that size)
template <int CUS>
__device__ __forceinline__ int fetch(const CuCtx& c, const int* cur, int yy, int xx) {
  constexpr int SH = CUS == 32 ? 5 : 4;
  if (yy >= 0 && yy < CUS && xx >= 0 && xx < CUS) return cur[yy * CUS + xx];
  const int cy = c.by + (yy >> SH);
  const int cx = c.bx + (xx >> SH);
  if (cy < 0 || cx < 0 || cx >= c.nbx || cy >= c.nby || 2 * cy + cx >= c.d)
    return c.init;
  return c.rec[(c.y0 + yy) * c.Wt + (c.x0 + xx)];
}

__device__ __forceinline__ int predict(const CuCtx& c, const int* refv,
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

// Decode one n x n block at (oy, ox) of the CU into `cur` (all threads call).
template <int CUS>
__device__ void decode_block(const CuCtx& c, int* cur, int* refv, int* coef,
                             int* tmp, const int32_t* tables, int n, int log2n,
                             int oy, int ox, bool bl_init, int mode,
                             const int16_t* zz) {
  const int t = threadIdx.x;
  const int nn = n * n;
  const int* T = tables + (n == 32 ? OFF_T32 : n == 16 ? OFF_T16 : OFF_T8);
  const int* izz = tables + (n == 32 ? OFF_ZZ32 : n == 16 ? OFF_ZZ16 : OFF_ZZ8);
  const int32_t* taps = tables + (n == 32 ? OFF_A32 : n == 16 ? OFF_A16 : OFF_A8);
  mode = min(max(mode, 0), MODE_INTER);
  // reference vector: corner, 2n top (incl. top-right), n left, n bottom-left
  if (t < 4 * n + 1) {
    int v;
    if (t == 0) v = fetch<CUS>(c, cur, oy - 1, ox - 1);
    else if (t <= 2 * n) v = fetch<CUS>(c, cur, oy - 1, ox + t - 1);
    else if (t <= 3 * n || !bl_init) v = fetch<CUS>(c, cur, oy + t - 2 * n - 1, ox - 1);
    else v = c.init;
    refv[t] = v;
  }
  // dequantise into raster order, clipped to 20 bits
  if (t < nn) {
    int dv = static_cast<int>(zz[izz[t]]) * c.dq;
    coef[t] = min(max(dv, -(1 << 19)), (1 << 19) - 1);
  }
  __syncthreads();
  const int i = t / n;  // row
  const int k = t % n;  // column
  // first stage: e = (T^T d + 2^10) >> 11, in wrapping 32-bit arithmetic
  if (t < nn) {
    uint32_t acc = 0;
    for (int j = 0; j < n; ++j)
      acc += static_cast<uint32_t>(T[j * n + i]) * static_cast<uint32_t>(coef[j * n + k]);
    acc += 1u << 10;
    tmp[t] = static_cast<int32_t>(acc) >> 11;
  }
  __syncthreads();
  // second stage: r = (e T + 2^(s2-1)) >> s2, then prediction + clip
  if (t < nn) {
    const int s2 = 7 + log2n;
    uint32_t acc = 0;
    for (int j = 0; j < n; ++j)
      acc += static_cast<uint32_t>(tmp[i * n + j]) * static_cast<uint32_t>(T[j * n + k]);
    acc += 1u << (s2 - 1);
    const int r = static_cast<int32_t>(acc) >> s2;
    const int p = predict(c, refv, taps, n, log2n, mode, i, k, oy, ox);
    cur[(oy + i) * CUS + ox + k] = min(max(p + r, 0), c.maxv);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
wavefront_decode32_kernel(int32_t* rec, const int32_t* ref, const int8_t* s32,
                          const int8_t* m32, const int16_t* c32,
                          const int8_t* s16, const int8_t* modes,
                          const int16_t* c16, const int32_t* dq,
                          const int32_t* maxv, const int32_t* tables, int nby,
                          int nbx, int d, int by_min) {
  __shared__ int cur[1024];
  __shared__ int refv[4 * 32 + 1];
  __shared__ int coef[1024];
  __shared__ int tmp[1024];
  const int p = blockIdx.y;
  const int by = by_min + blockIdx.x;
  const int bx = d - 2 * by;
  if (by >= nby || bx < 0 || bx >= nbx) return;  // uniform per block
  const int Ht = nby * 32, Wt = nbx * 32;
  const size_t plane = static_cast<size_t>(p) * Ht * Wt;
  CuCtx c;
  c.rec = rec + plane;
  c.ref = ref + plane;
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
  const int t = threadIdx.x;
  const size_t cu = static_cast<size_t>(p) * nby * nbx + by * nbx + bx;
  cur[t] = c.init;
  __syncthreads();
  if (s32[cu] == 0) {
    decode_block<32>(c, cur, refv, coef, tmp, tables, 32, 5, 0, 0, true, m32[cu],
                 c32 + cu * 1024);
  } else {
    for (int q = 0; q < 4; ++q) {
      const int qy = (q >> 1) * 16, qx = (q & 1) * 16;
      const size_t cq = cu * 4 + q;
      if (s16[cq] == 0) {
        decode_block<32>(c, cur, refv, coef, tmp, tables, 16, 4, qy, qx, true,
                     modes[cq * 4], c16 + cq * 256);
      } else {
        for (int s = 0; s < 4; ++s) {
          decode_block<32>(c, cur, refv, coef, tmp, tables, 8, 3,
                       qy + (s >> 1) * 8, qx + (s & 1) * 8, s >= 2,
                       modes[cq * 4 + s], c16 + cq * 256 + s * 64);
        }
      }
    }
  }
  rec[plane + (c.y0 + t / 32) * Wt + c.x0 + t % 32] = cur[t];
}

// The two-level (16/8) decoder: one block per (tile plane, 16x16 CU) of the
// diagonal, 256 threads; the whole 16x16 block or four 8x8 blocks in
// z-order (reference `_build_decode.run`, hevc.py:1281-1345).
__global__ void __launch_bounds__(256)
wavefront_decode16_kernel(int32_t* rec, const int32_t* ref, const int8_t* split,
                          const int8_t* modes, const int16_t* coeffs, const int32_t* dq,
                          const int32_t* maxv, const int32_t* tables, int nby, int nbx,
                          int d, int by_min) {
  __shared__ int cur[256];
  __shared__ int refv[4 * 16 + 1];
  __shared__ int coef[256];
  __shared__ int tmp[256];
  const int p = blockIdx.y;
  const int by = by_min + blockIdx.x;
  const int bx = d - 2 * by;
  if (by >= nby || bx < 0 || bx >= nbx) return;  // uniform per block
  const int Ht = nby * 16, Wt = nbx * 16;
  const size_t plane = static_cast<size_t>(p) * Ht * Wt;
  CuCtx c;
  c.rec = rec + plane;
  c.ref = ref + plane;
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
  const int t = threadIdx.x;
  const size_t cu = static_cast<size_t>(p) * nby * nbx + by * nbx + bx;
  cur[t] = c.init;
  __syncthreads();
  if (split[cu] == 0) {
    decode_block<16>(c, cur, refv, coef, tmp, tables, 16, 4, 0, 0, true, modes[cu * 4],
                     coeffs + cu * 256);
  } else {
    for (int s = 0; s < 4; ++s) {
      decode_block<16>(c, cur, refv, coef, tmp, tables, 8, 3, (s >> 1) * 8, (s & 1) * 8,
                       s >= 2, modes[cu * 4 + s], coeffs + cu * 256 + s * 64);
    }
  }
  rec[plane + (c.y0 + t / 16) * Wt + c.x0 + t % 16] = cur[t];
}

}  // namespace

// One launch per wavefront diagonal, all on `stream`.  rec/ref: (PT, nby*32,
// nbx*32) int32; s32/m32 (PT, nb) int8; c32 (PT, nb, 1024) int16 zigzag;
// s16 (PT, nb, 4) int8; modes (PT, nb, 4, 4) int8; c16 (PT, nb, 4, 256)
// int16 zigzag; dq/maxv (PT,) int32; tables: see hevc.py `_tables`.
// *launched (host memory) receives the number of grids launched: diagonals
// that hold no CU are skipped.
extern "C" int wavefront_decode32(int32_t* rec, const int32_t* ref,
                                  const int8_t* s32, const int8_t* m32,
                                  const int16_t* c32, const int8_t* s16,
                                  const int8_t* modes, const int16_t* c16,
                                  const int32_t* dq, const int32_t* maxv,
                                  const int32_t* tables, int PT, int nby,
                                  int nbx, void* stream, int* launched) {
  const int nd = 2 * (nby - 1) + nbx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  for (int d = 0; d < nd; ++d) {
    const int by_min = d - (nbx - 1) > 0 ? (d - (nbx - 1) + 1) / 2 : 0;
    const int by_max = min(nby - 1, d / 2);
    if (by_max < by_min) continue;
    dim3 grid(by_max - by_min + 1, PT);
    wavefront_decode32_kernel<<<grid, 1024, 0, st>>>(
        rec, ref, s32, m32, c32, s16, modes, c16, dq, maxv, tables, nby, nbx,
        d, by_min);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two-level (16/8) entry: one launch per wavefront diagonal of 16x16
// CUs, all on `stream`.  rec/ref: (PT, nby*16, nbx*16) int32; split (PT,
// nb) int8; modes (PT, nb, 4) int8 ([m16, 0, 0, 0] for a whole block);
// coeffs (PT, nb, 256) int16 zigzag (four 64-level 8x8 blocks when split);
// dq/maxv (PT,) int32.  *launched receives the number of grids launched.
extern "C" int wavefront_decode16(int32_t* rec, const int32_t* ref, const int8_t* split,
                                  const int8_t* modes, const int16_t* coeffs,
                                  const int32_t* dq, const int32_t* maxv,
                                  const int32_t* tables, int PT, int nby, int nbx,
                                  void* stream, int* launched) {
  const int nd = 2 * (nby - 1) + nbx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  for (int d = 0; d < nd; ++d) {
    const int by_min = d - (nbx - 1) > 0 ? (d - (nbx - 1) + 1) / 2 : 0;
    const int by_max = min(nby - 1, d / 2);
    if (by_max < by_min) continue;
    dim3 grid(by_max - by_min + 1, PT);
    wavefront_decode16_kernel<<<grid, 256, 0, st>>>(rec, ref, split, modes, coeffs, dq, maxv,
                                                    tables, nby, nbx, d, by_min);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
