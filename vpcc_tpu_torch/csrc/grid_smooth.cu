// Kernel D: grid geometry smoothing.
//
// Replaces the XLA program vpcc_tpu/ops/smoothing.py
// `smooth_point_cloud_grid` (smoothing.py:51-131).
//
// Pass 1 (one thread per point): bin the point into its gridSize^3 cell and
// accumulate the cell's count, position sum and min/max patch id with
// integer atomics — deterministic, and equal to the reference's float32
// scatter-add, which holds these integer sums (< 2^24) exactly.
// Pass 2 (one thread per point): the trilinear centroid over the 2x2x2
// cells around the point, in float32 and in the reference's order: for
// dz, dy, dx the weight (wx*wy)*wz, the centroid and weight-count
// accumulated as fused multiply-adds (XLA's CPU backend fuses them; the
// centroid's first add, of the first two corners' products, fuses the
// first product and rounds the second: found on 11-bit grids, where
// coordinates near 2047 expose the difference), the
// division by 8*gridSize^3, the floor of the count, then the squared
// distance as a fused multiply-add chain and the move test against
// max(threshold, count) * 2.  This file is compiled with --fmad=false, so
// only the explicit __fmaf_rn calls fuse; divisions are IEEE.
//
// Bound: bytes.  Pass 1 reads the points (24 bytes each with id and flag)
// and scatters into a 2.1M-cell table (6 int32 a cell, memset per frame);
// pass 2 gathers 8 cells a point and writes 12 bytes a point.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void grid_bin_kernel(const int32_t* pos, const int32_t* pid, int M,
                                int gs, int gw, int32_t* count, int32_t* csum,
                                int32_t* pmin, int32_t* pmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int c[3];
  for (int k = 0; k < 3; ++k) c[k] = min(max(floordiv(pos[i * 3 + k], gs), 0), gw - 1);
  const long long cid = (static_cast<long long>(c[2]) * gw + c[1]) * gw + c[0];
  atomicAdd(&count[cid], 1);
  for (int k = 0; k < 3; ++k) atomicAdd(&csum[cid * 3 + k], pos[i * 3 + k]);
  atomicMin(&pmin[cid], pid[i]);
  atomicMax(&pmax[cid], pid[i]);
}

__global__ void grid_move_kernel(const int32_t* pos, const uint8_t* bnd, int M,
                                 float thr, int gs, int gw,
                                 const int32_t* count, const int32_t* csum,
                                 const int32_t* pmin, const int32_t* pmax,
                                 int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int half = gs / 2;
  int p[3], s[3], w[3], q[3];
  float cur[3];
  for (int k = 0; k < 3; ++k) {
    p[k] = pos[i * 3 + k];
    const int p2 = floordiv(p[k], gs);
    const int p3 = p[k] - p2 * gs;
    s[k] = p2 + (p3 < half ? -1 : 0);
    w[k] = (p[k] - s[k] * gs - half) * 2 + 1;
    q[k] = 2 * gs - w[k];
    cur[k] = static_cast<float>(p[k]);
  }
  const long long sentinel = static_cast<long long>(gw) * gw * gw;
  bool any_smooth = false;
  float c4[3] = {0.f, 0.f, 0.f};
  float cent0[3] = {0.f, 0.f, 0.f};
  float wgt0 = 0.f;
  float wcount = 0.f;
  for (int dz = 0; dz < 2; ++dz) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int nx = s[0] + dx, ny = s[1] + dy, nz = s[2] + dz;
        const bool ok = nx >= 0 && nx < gw && ny >= 0 && ny < gw && nz >= 0 && nz < gw;
        const long long ncid =
            ok ? (static_cast<long long>(nz) * gw + ny) * gw + nx : sentinel;
        const int cc = count[ncid];
        any_smooth = any_smooth || (cc > 0 && pmin[ncid] != pmax[ncid]);
        const float ccf = static_cast<float>(max(cc, 1));
        const float wx = static_cast<float>(dx == 0 ? q[0] : w[0]);
        const float wy = static_cast<float>(dy == 0 ? q[1] : w[1]);
        const float wz = static_cast<float>(dz == 0 ? q[2] : w[2]);
        const float wgt = __fmul_rn(__fmul_rn(wx, wy), wz);
        const int corner = (dz * 2 + dy) * 2 + dx;
        for (int k = 0; k < 3; ++k) {
          const float cent =
              cc > 0 ? __fdiv_rn(static_cast<float>(csum[ncid * 3 + k]), ccf) : cur[k];
          if (corner == 0) {
            cent0[k] = cent;  // XLA fuses the first product into the first add
          } else if (corner == 1) {
            c4[k] = __fmaf_rn(cent0[k], wgt0, __fmul_rn(cent, wgt));
          } else {
            c4[k] = __fmaf_rn(cent, wgt, c4[k]);
          }
        }
        if (corner == 0) wgt0 = wgt;
        wcount = __fmaf_rn(wgt, static_cast<float>(cc), wcount);
      }
    }
  }
  const float denom = static_cast<float>(8 * gs * gs * gs);
  for (int k = 0; k < 3; ++k) c4[k] = __fdiv_rn(c4[k], denom);
  const float cnt = floorf(__fdiv_rn(wcount, denom));
  const int disth = max(gs / 2, 1);
  const int th = gs * gw;
  bool inb = true;
  for (int k = 0; k < 3; ++k) inb = inb && p[k] >= disth && p[k] + disth < th;
  bool move = false;
  if (bnd[i] && any_smooth && inb && cnt > 0.f) {
    float diff[3];
    for (int k = 0; k < 3; ++k)
      diff[k] = __fsub_rn(__fmul_rn(cur[k], cnt), __fmul_rn(c4[k], cnt));
    float ss = __fmul_rn(diff[0], diff[0]);
    ss = __fmaf_rn(diff[1], diff[1], ss);
    ss = __fmaf_rn(diff[2], diff[2], ss);
    const float dist2 = __fadd_rn(__fdiv_rn(ss, fmaxf(cnt, 1.f)), 0.5f);
    move = dist2 >= __fmul_rn(fmaxf(thr, cnt), 2.f);
  }
  for (int k = 0; k < 3; ++k)
    out[i * 3 + k] = move ? static_cast<int>(floorf(__fadd_rn(c4[k], 0.5f))) : p[k];
}

}  // namespace

// pos (M, 3) int32, pid (M,) int32, bnd (M,) bool; cell tables of
// gw^3 + 1 entries (count, csum x3 zeroed; pmin = 2^30, pmax = -1); out
// (M, 3) int32.  Two launches.
extern "C" int grid_smooth(const int32_t* pos, const int32_t* pid,
                           const uint8_t* bnd, int M, float thr, int gs,
                           int gw, int32_t* count, int32_t* csum,
                           int32_t* pmin, int32_t* pmax, int32_t* out,
                           void* stream) {
  if (M == 0) return 0;
  const int threads = 256;
  const int blocks = (M + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  grid_bin_kernel<<<blocks, threads, 0, st>>>(pos, pid, M, gs, gw, count, csum,
                                              pmin, pmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_move_kernel<<<blocks, threads, 0, st>>>(pos, bnd, M, thr, gs, gw, count,
                                               csum, pmin, pmax, out);
  return static_cast<int>(cudaGetLastError());
}
