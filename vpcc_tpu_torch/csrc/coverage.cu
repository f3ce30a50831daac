// Kernel H: patch coverage against a bit volume (K6).
//
// Replaces the XLA program vpcc_tpu/ops/coverage.py `covered_radius_slab`
// (coverage.py:97-153) with its `_dilate` (:59-83) and `_shift_z` (:45-56):
// is each source point within sqrt(r2_sel) / sqrt(r2_det) of a resampled
// patch point?
//
// Launch 1 (one thread per resampled point): set the point's bit in the
// slab volume (sx x G x W uint32 words, W = G / 32; x relative to the slab
// origin x0 and clipped to the slab as the reference clips it) with
// atomicOr.  OR is idempotent, so the reference's sort-and-dedup before
// its scatter-add is not needed.
// Launch 2 (one thread per query): test the Euclidean ball as xy columns
// (`_ball_columns`): for each (dx, dy) with dx^2 + dy^2 <= r2 the column
// covers |dz| <= floor(sqrt(r2 - dx^2 - dy^2)), a z bit-range of at most
// two words.  Both flags come from one pass over the r2_det columns.  This
// is the membership the reference's dilation computes, without its
// volume-sized shift-OR passes.  Slab semantics kept: a query outside
// [x0, x0 + sx) is not covered; no wrap at the y or z edges (the
// reference's shifts pad with zeros); packed -1 entries are padding.
//
// Bound: bytes.  Launch 1 writes one word per point into a volume that the
// wrapper zeroes; launch 2 reads the query rows and up to 2 x 29 volume
// words per query, gathered around the query (L2-resident neighbourhoods).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int isqrt_floor(int v) {
  int r = 0;
  while ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

__global__ void coverage_scatter_kernel(const int32_t* __restrict__ res_packed, int R,
                                        int x0, int sx, int bits,
                                        uint32_t* __restrict__ vol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int pk = res_packed[i];
  if (pk < 0) return;
  const int G = 1 << bits;
  const int W = G >= 32 ? G / 32 : 1;
  const int mask = G - 1;
  const int x = (pk >> 20) & mask, y = (pk >> 10) & mask, z = pk & mask;
  const int xs = min(max(x - x0, 0), sx - 1);
  const long long w = (static_cast<long long>(xs) * G + y) * W + (z >> 5);
  atomicOr(vol + w, 1u << (z & 31));
}

// any bit of z in [zlo, zhi] set in the column's words
__device__ __forceinline__ bool any_bits(const uint32_t* col, int zlo, int zhi) {
  for (int wd = zlo >> 5; wd <= (zhi >> 5); ++wd) {
    const int lo = max(zlo - wd * 32, 0);
    const int hi = min(zhi - wd * 32, 31);
    const uint32_t m = (hi == 31 ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u)) & ~((1u << lo) - 1u);
    if (col[wd] & m) return true;
  }
  return false;
}

__global__ void coverage_query_kernel(const uint32_t* __restrict__ vol,
                                      const int32_t* __restrict__ queries, int N,
                                      int x0, int sx, int bits, int r2_sel, int r2_det,
                                      uint8_t* __restrict__ cov_sel,
                                      uint8_t* __restrict__ cov_det) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int G = 1 << bits;
  const int W = G >= 32 ? G / 32 : 1;
  const int qx0 = queries[3 * i];
  const int qxs = qx0 - x0;
  bool sel = false, det = false;
  if (qx0 != 0x3FFFFFFF && qxs >= 0 && qxs < sx) {
    const int qy = min(max(queries[3 * i + 1], 0), G - 1);
    const int qz = min(max(queries[3 * i + 2], 0), G - 1);
    const int r2 = max(r2_sel, r2_det);
    const int r = isqrt_floor(r2);
    for (int dx = -r; dx <= r; ++dx) {
      const int vx = qxs - dx;
      if (vx < 0 || vx >= sx) continue;
      for (int dy = -r; dy <= r; ++dy) {
        const int vy = qy - dy;
        const int d2 = dx * dx + dy * dy;
        if (vy < 0 || vy >= G || d2 > r2) continue;
        const uint32_t* col = vol + (static_cast<long long>(vx) * G + vy) * W;
        if (!det && d2 <= r2_det) {
          const int wz = isqrt_floor(r2_det - d2);
          det = any_bits(col, max(qz - wz, 0), min(qz + wz, G - 1));
        }
        if (!sel && d2 <= r2_sel) {
          const int wz = isqrt_floor(r2_sel - d2);
          sel = any_bits(col, max(qz - wz, 0), min(qz + wz, G - 1));
        }
      }
    }
  }
  cov_sel[i] = sel;
  cov_det[i] = det;
}

}  // namespace

// res_packed (R,) int32 (x<<20 | y<<10 | z, -1 = padding), queries (N, 3)
// int32, vol (sx * G * W,) uint32 zeroed by the caller; out cov_sel,
// cov_det (N,) bool.  Two launches.
extern "C" int coverage(const int32_t* res_packed, int R, const int32_t* queries,
                        int N, int x0, int sx, int bits, int r2_sel, int r2_det,
                        uint32_t* vol, uint8_t* cov_sel, uint8_t* cov_det,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (R > 0) {
    coverage_scatter_kernel<<<(R + threads - 1) / threads, threads, 0, st>>>(
        res_packed, R, x0, sx, bits, vol);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N > 0) {
    coverage_query_kernel<<<(N + threads - 1) / threads, threads, 0, st>>>(
        vol, queries, N, x0, sx, bits, r2_sel, r2_det, cov_sel, cov_det);
  }
  return static_cast<int>(cudaGetLastError());
}
