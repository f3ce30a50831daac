// Kernel T: grid color smoothing.
//
// Replaces the XLA program vpcc_tpu/ops/smoothing.py `color_smoothing_grid`
// (smoothing.py:135-189), which zero-fills dense per-cell tables of
// (2^bits / cgridSize)^3 + 1 cells (eight arrays, ~0.5 GB a vox10 frame).
//
// Per cgridSize^3 cell: the count, the RGB sums, the luma and luma^2 sums and
// the min/max patch index.  A boundary point of a multi-patch cell holding
// more than one point, whose luma variance is below variation_limit^2, takes
// the cell's rounded (half to even) mean color when its own luma lies within
// `threshold` of the cell's mean luma (`dev < threshold`).
//
// Design, O(M) memory and no dense table: `color_smooth_keys` writes each
// row's cell id; the wrapper sorts the keys stably (so a cell's rows stay in
// row order); `color_smooth_cells` gives each cell one thread (the thread at
// the cell's first sorted position), which sums the cell's rows in row
// order, then writes every row's color.  The integer sums are order-free;
// the luma and luma^2 sums are float32 sums of non-integers, and XLA's CPU
// scatter-add adds them in row order from 0, which the sequential loop
// reproduces.  Float order as the reference's program computes it: luma =
// fma(0.0722, b, fma(0.2126, r, 0.7152 g)); variance = fma(-mean, mean,
// l2sum / count) clamped at 0; divisions by the count are IEEE divisions.
// Compiled with --fmad=false: only the explicit __fmaf_rn calls fuse.
//
// Bound: bytes — the points, colors, patch ids and flags read once, the
// keys written and read back with the sort's permutation, the colors
// written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float luma_of(const int32_t* c) {
  const float r = static_cast<float>(c[0]), g = static_cast<float>(c[1]),
              b = static_cast<float>(c[2]);
  return __fmaf_rn(0.0722f, b, __fmaf_rn(0.2126f, r, __fmul_rn(0.7152f, g)));
}

__global__ void keys_kernel(const int32_t* pos, int M, int gs, int gw, int32_t* keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int c[3];
  for (int k = 0; k < 3; ++k) c[k] = min(max(floordiv(pos[i * 3 + k], gs), 0), gw - 1);
  keys[i] = (c[2] * gw + c[1]) * gw + c[0];
}

__global__ void cells_kernel(const int32_t* skeys, const int32_t* perm, const int32_t* col,
                             const int32_t* pid, const uint8_t* bnd, int32_t* out, int M,
                             float thr, float lim) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int key = skeys[i];
  if (i > 0 && skeys[i - 1] == key) return;  // not the cell's first row
  int end = i;
  int n = 0, cs[3] = {0, 0, 0}, pmin = 1 << 30, pmax = -1;
  float lsum = 0.f, l2sum = 0.f;
  while (end < M && skeys[end] == key) {
    const int r = perm[end];
    const int32_t* c = col + r * 3;
    const float l = luma_of(c);
    lsum = __fadd_rn(lsum, l);
    l2sum = __fadd_rn(l2sum, __fmul_rn(l, l));
    for (int k = 0; k < 3; ++k) cs[k] += c[k];
    pmin = min(pmin, pid[r]);
    pmax = max(pmax, pid[r]);
    ++n;
    ++end;
  }
  const float cnt = static_cast<float>(n);
  const float mean_l = __fdiv_rn(lsum, cnt);
  const float var = fmaxf(__fmaf_rn(-mean_l, mean_l, __fdiv_rn(l2sum, cnt)), 0.f);
  const bool cell_ok = pmin != pmax && n > 1 && var < __fmul_rn(lim, lim);
  float mean_c[3];
  for (int k = 0; k < 3; ++k)
    mean_c[k] = fminf(fmaxf(rintf(__fdiv_rn(static_cast<float>(cs[k]), cnt)), 0.f), 255.f);
  for (int j = i; j < end; ++j) {
    const int r = perm[j];
    const int32_t* c = col + r * 3;
    const bool smooth = cell_ok && bnd[r] != 0 && fabsf(__fsub_rn(luma_of(c), mean_l)) < thr;
    for (int k = 0; k < 3; ++k)
      out[r * 3 + k] = smooth ? static_cast<int32_t>(mean_c[k]) : min(max(c[k], 0), 255);
  }
}

}  // namespace

// keys (M,) int32: each row's cell id (z * gw + y) * gw + x of pos (M, 3).
extern "C" int color_smooth_keys(const int32_t* pos, int M, int gs, int gw, int32_t* keys,
                                 void* stream) {
  if (M == 0) return 0;
  keys_kernel<<<(M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(pos, M, gs, gw,
                                                                              keys);
  return static_cast<int>(cudaGetLastError());
}

// skeys (M,) the keys sorted stably, perm (M,) int32 the rows in that order;
// col (M, 3) int32, pid (M,) int32, bnd (M,) bool; out (M, 3) int32.
extern "C" int color_smooth_cells(const int32_t* skeys, const int32_t* perm,
                                  const int32_t* col, const int32_t* pid, const uint8_t* bnd,
                                  int32_t* out, int M, float thr, float lim, void* stream) {
  if (M == 0) return 0;
  cells_kernel<<<(M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      skeys, perm, col, pid, bnd, out, M, thr, lim);
  return static_cast<int>(cudaGetLastError());
}
