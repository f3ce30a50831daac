// Kernel O: HEVC-style deblocking of the 8-aligned block edges of a stack of
// int32 planes.
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_deblock` (hevc.py:161),
// which the wavefront codec applies to every deblocked plane (the attribute
// planes, encoder and decoder side) after the CU reconstruction and before
// SAO.  Integer only.  Per plane, tc = TC_TAB[clamp(qp + 2, 0, 53)] *
// max((maxval + 1) / 256, 1); across each edge (p1 p0 | q0 q1),
// delta = (9 (q0 - p0) - 3 (q1 - p1) + 8) >> 4, and where |delta| < 10 tc
// the two samples next to the edge move by clamp(delta, -tc, tc), clamped
// to 0..maxval.
//
// Design.  Two launches, in the reference's order: pass 1 filters every
// vertical edge (x = 8, 16, ...) of the input into `out`, one thread per
// sample (a sample is next to at most one vertical edge, and every value
// read is the input's); pass 2 filters every horizontal edge of `out` in
// place, one thread per (edge, column), which reads rows 8e-2 .. 8e+1 and
// writes rows 8e-1 and 8e: no two threads touch the same sample.
//
// Bound: bytes.  Pass 1 reads and writes every sample; pass 2 reads half
// of the rows' neighbours and rewrites a quarter of the samples.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int edge_delta(int p1, int p0, int q0, int q1) {
  return (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int plane_tc(const int32_t* qps, const int32_t* maxvals,
                                        const int32_t* tc_tab, int p) {
  const int tc8 = tc_tab[clampi(qps[p] + 2, 0, 53)];
  const int scale = (maxvals[p] + 1) / 256;
  return tc8 * (scale > 1 ? scale : 1);
}

__global__ void vertical_edges(const int32_t* in, const int32_t* qps,
                               const int32_t* maxvals, const int32_t* tc_tab,
                               int32_t* out, int P, int H, int W) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(P) * H * W) return;
  const int x = static_cast<int>(i % W);
  const int p = static_cast<int>(i / (static_cast<int64_t>(H) * W));
  const int32_t* row = in + (i - x);
  int v = row[x];
  const int r = x & 7;
  if ((r == 7 && x + 1 < W) || (r == 0 && x > 0)) {
    const int e = r == 7 ? x + 1 : x;   // first column right of the edge
    const int tc = plane_tc(qps, maxvals, tc_tab, p);
    const int dlt = edge_delta(row[e - 2], row[e - 1], row[e], row[e + 1]);
    if (abs(dlt) < 10 * tc) {
      const int d = clampi(dlt, -tc, tc);
      v = r == 7 ? clampi(v + d, 0, maxvals[p]) : clampi(v - d, 0, maxvals[p]);
    }
  }
  out[i] = v;
}

__global__ void horizontal_edges(int32_t* buf, const int32_t* qps,
                                 const int32_t* maxvals, const int32_t* tc_tab,
                                 int P, int H, int W) {
  const int ne = H / 8 - 1;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ne <= 0 || i >= static_cast<int64_t>(P) * ne * W) return;
  const int x = static_cast<int>(i % W);
  const int e = 1 + static_cast<int>((i / W) % ne);
  const int p = static_cast<int>(i / (static_cast<int64_t>(ne) * W));
  int32_t* col = buf + static_cast<int64_t>(p) * H * W + x;
  const int y = 8 * e;   // first row below the edge
  const int p1 = col[(y - 2) * W], p0 = col[(y - 1) * W], q0 = col[y * W],
            q1 = col[(y + 1) * W];
  const int tc = plane_tc(qps, maxvals, tc_tab, p);
  const int dlt = edge_delta(p1, p0, q0, q1);
  if (abs(dlt) < 10 * tc) {
    const int d = clampi(dlt, -tc, tc);
    col[(y - 1) * W] = clampi(p0 + d, 0, maxvals[p]);
    col[y * W] = clampi(q0 - d, 0, maxvals[p]);
  }
}

}  // namespace

extern "C" int deblock(const int32_t* in, const int32_t* qps, const int32_t* maxvals,
                       const int32_t* tc_tab, int32_t* out, int P, int H, int W,
                       void* stream) {
  const int64_t n = static_cast<int64_t>(P) * H * W;
  if (n == 0) return 0;
  if (H % 8 || W % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  vertical_edges<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, st>>>(
      in, qps, maxvals, tc_tab, out, P, H, W);
  const int64_t m = static_cast<int64_t>(P) * (H / 8 - 1) * W;
  if (m > 0)
    horizontal_edges<<<static_cast<unsigned>((m + threads - 1) / threads), threads, 0, st>>>(
        out, qps, maxvals, tc_tab, P, H, W);
  return static_cast<int>(cudaGetLastError());
}
