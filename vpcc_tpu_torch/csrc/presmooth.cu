// Kernel N: color pre-smoothing vote of the boundary points.
//
// Replaces the XLA program vpcc_tpu/ops/smoothing.py `_presmooth_vote`
// (smoothing.py:193), as `presmooth_colors` (:227) runs it on the boundary
// points of the reconstructed cloud before the attribute video (reference
// presmoothPointCloudColor, PCCEncoder.cpp:6593-6656).  Per query, over its
// k = 64 nearest points (kernel E): the slots within radius2 vote; their
// integer color centroid (csum + n/2) / n; the entropy of their 8-bit luma;
// the query takes the centroid when its L1 distance to it is at least
// thr_dist and the entropy is below thr_entropy.
//
// Design.  One warp per query, two slots per lane.  The reference's
// (M, k, k) luma-equality tensor becomes a 256-bin histogram per warp in
// shared memory (shared atomics), read back at each slot's luma.  Float
// order as XLA's CPU program: luma = trunc(fma(0.0722, b, fma(0.2126, r,
// 0.7152 g))); a valid slot's entropy term is read from a table of XLA's
// own -log2(max(cnt / n, 1e-12)) values (XLA's log2 is not correctly
// rounded), zero elsewhere; the 64 terms are summed as two sequential runs
// of 32 from 0 (lanes 0 and 1), then added and divided by n.  Built with
// --fmad=false: the only fused multiply-adds are the explicit ones.
//
// Bound: bytes.  Per query: 64 index/distance pairs, 64 neighbor colors
// (gathered, mostly cached), its own color in and out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;
constexpr int kK = 64;
constexpr int kWarps = 8;

__global__ void presmooth_kernel(const int32_t* colors, const int32_t* nidx,
                                 const int32_t* nd2, const int32_t* q_col,
                                 const float* ent_tab, int m, float radius2,
                                 float thr_dist, float thr_entropy, int32_t* out) {
  __shared__ int hist[kWarps][256];
  __shared__ float terms[kWarps][kK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= m) return;   // whole warps exit together
  int* h = hist[warp];
  for (int b = lane; b < 256; b += 32) h[b] = 0;
  int y[2], cs[3] = {0, 0, 0};
  bool valid[2];
  for (int s = 0; s < 2; ++s) {
    const int j = lane + 32 * s;
    const int64_t o = static_cast<int64_t>(q) * kK + j;
    const int32_t d = nd2[o];
    valid[s] = d < kMaxDist2 && static_cast<float>(d) <= radius2;
    const int32_t* c = colors + 3 * static_cast<int64_t>(nidx[o]);
    const float r = static_cast<float>(c[0]), g = static_cast<float>(c[1]),
                b = static_cast<float>(c[2]);
    y[s] = static_cast<int>(__fmaf_rn(0.0722f, b, __fmaf_rn(0.2126f, r, __fmul_rn(0.7152f, g))));
    if (valid[s]) {
      cs[0] += c[0];
      cs[1] += c[1];
      cs[2] += c[2];
    }
  }
  __syncwarp();
  for (int s = 0; s < 2; ++s)
    if (valid[s]) atomicAdd(&h[y[s] & 255], 1);
  const int nv = __popc(__ballot_sync(0xFFFFFFFFu, valid[0])) +
                 __popc(__ballot_sync(0xFFFFFFFFu, valid[1]));
  const int n = nv > 1 ? nv : 1;
  __syncwarp();
  for (int s = 0; s < 2; ++s)
    terms[warp][lane + 32 * s] = valid[s] ? ent_tab[n * 65 + h[y[s] & 255]] : 0.0f;
  for (int off = 16; off > 0; off >>= 1)
    for (int c = 0; c < 3; ++c) cs[c] += __shfl_xor_sync(0xFFFFFFFFu, cs[c], off);
  __syncwarp();
  float part = 0.0f;
  if (lane < 2) {
    const float* t = terms[warp] + 32 * lane;
    for (int j = 0; j < 32; ++j) part = __fadd_rn(part, t[j]);
  }
  const float s1 = __shfl_sync(0xFFFFFFFFu, part, 1);
  if (lane != 0) return;
  const float H = __fdiv_rn(__fadd_rn(part, s1), static_cast<float>(n));
  int cen[3], l1 = 0;
  const int32_t* qc = q_col + 3 * static_cast<int64_t>(q);
  for (int c = 0; c < 3; ++c) {
    cen[c] = (cs[c] + n / 2) / n;
    const int e = cen[c] - qc[c];
    l1 += e < 0 ? -e : e;
  }
  const bool replace = nv > 0 && static_cast<float>(l1) >= thr_dist && H < thr_entropy;
  for (int c = 0; c < 3; ++c) out[3 * static_cast<int64_t>(q) + c] = replace ? cen[c] : qc[c];
}

}  // namespace

extern "C" int presmooth_vote(const int32_t* colors, const int32_t* nidx,
                              const int32_t* nd2, const int32_t* q_col,
                              const float* ent_tab, int m, int k, float radius2,
                              float thr_dist, float thr_entropy, int32_t* out,
                              void* stream) {
  if (m == 0) return 0;
  if (k != kK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  presmooth_kernel<<<(m + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
      colors, nidx, nd2, q_col, ent_tab, m, radius2, thr_dist, thr_entropy, out);
  return static_cast<int>(cudaGetLastError());
}
