// Kernel N: color pre-smoothing vote of the boundary points.
//
// Replaces the XLA program vpcc_tpu/ops/smoothing.py `_presmooth_vote`
// (smoothing.py:193), as `presmooth_colors` (:227) runs it on the boundary
// points of the reconstructed cloud before the attribute video (reference
// presmoothPointCloudColor, PCCEncoder.cpp:6593-6656), together with the
// caller's gather of the queries' colors and its scatter of the result:
// query q reads its color at row bidx[q] and writes its new color to row
// bidx[q] of `out`.  Per query, over its k = 64 nearest points (kernel E):
// the slots within radius2 vote; their integer color centroid
// (csum + n/2) / n; the entropy of their 8-bit luma; the query takes the
// centroid when its L1 distance to it is at least thr_dist and the entropy
// is below thr_entropy.
//
// Design.  One warp per query, lane l holds slots 2l and 2l + 1 (8-byte
// loads of the index and distance rows); the query's own color is read
// first, so that its loads overlap the neighbours'.  The valid slots'
// count and color sums are ballots and warp reductions
// (`__reduce_add_sync`), which give the centroid and its L1 distance.  The
// vote is a conjunction, so the entropy is formed only for a query that
// passes the distance test (a quarter of the bench frame's); the rest
// write their own color.  There, the reference's (M, k, k) luma-equality
// tensor becomes bit planes: one ballot of each of the 8 luma bits per slot
// register; a slot's count of equal lumas among the valid slots is the
// popcount of the lanes whose 8 bits all agree with it (XNORs), over both
// registers.  No shared memory, no atomics.  Float order as XLA's CPU
// program: luma = trunc(fma(0.0722, b, fma(0.2126, r, 0.7152 g))); a valid
// slot's entropy term is read from a table of XLA's own -log2(max(cnt / n,
// 1e-12)) values (XLA's log2 is not correctly rounded), zero elsewhere; H
// is the 64 terms summed as two sequential runs of 32 from 0, then added
// and divided by n: lanes 0 and 16 take their run's 32 terms by shuffles
// and add them in slot order.  Built with --fmad=false: the only fused
// multiply-adds are the explicit ones.  k is a parameter; the entry takes k = 64 only, the one
// whose entropy order is probed.
//
// Bound: bytes.  Per query: 64 index/distance pairs, the neighbors' colors
// (gathered, mostly cached), its row index, its own color in and out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;
constexpr int kK = 64;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

// H < thr_entropy for the terms t of this lane's two slots, H as XLA's
// program takes it: two sequential runs of 32 from 0, added, divided by n.
// Run 0: slots 0..31 (lanes 0..15), run 1: slots 32..63 (lanes 16..31);
// lanes 0 and 16 take their run's terms by shuffles and add them in slot
// order.  Warp-uniform.
__device__ __forceinline__ bool entropy_below(const float* t, int n, float thr, int lane) {
  const int base = lane & 16;
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = __shfl_sync(kFull, t[0], base + i);
    const float b = __shfl_sync(kFull, t[1], base + i);
    run = __fadd_rn(__fadd_rn(run, a), b);
  }
  const float s1 = __shfl_sync(kFull, run, 16);
  // lane 0's: (run 0 + run 1) / n
  return __shfl_sync(kFull, __fdiv_rn(__fadd_rn(run, s1), static_cast<float>(n)), 0) < thr;
}

__global__ void __launch_bounds__(32 * kWarps)
presmooth_kernel(const int32_t* __restrict__ colors, const int32_t* __restrict__ nidx,
                 const int32_t* __restrict__ nd2, const int64_t* __restrict__ bidx,
                 const float* __restrict__ ent_tab, int m, int k, float radius2,
                 float thr_dist, float thr_entropy, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= m) return;   // whole warps exit together
  const int64_t row = 3 * bidx[q];
  const int ch = lane < 3 ? lane : 0;
  const int qc = __ldg(colors + row + ch);
  const int64_t o = static_cast<int64_t>(q) * k + 2 * lane;
  const int2 d = *reinterpret_cast<const int2*>(nd2 + o);
  const int2 j = *reinterpret_cast<const int2*>(nidx + o);
  const int dd[2] = {d.x, d.y}, jj[2] = {j.x, j.y};
  int y[2], cs[3] = {0, 0, 0};
  bool valid[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    valid[s] = dd[s] < kMaxDist2 && static_cast<float>(dd[s]) <= radius2;
    y[s] = 0;
    if (valid[s]) {
      const int32_t* c = colors + 3 * static_cast<int64_t>(jj[s]);
      const int cr = __ldg(c), cg = __ldg(c + 1), cb = __ldg(c + 2);
      const float r = static_cast<float>(cr), g = static_cast<float>(cg),
                  b = static_cast<float>(cb);
      y[s] = static_cast<int>(
          __fmaf_rn(0.0722f, b, __fmaf_rn(0.2126f, r, __fmul_rn(0.7152f, g))));
      cs[0] += cr;
      cs[1] += cg;
      cs[2] += cb;
    }
  }
  const unsigned v0 = __ballot_sync(kFull, valid[0]), v1 = __ballot_sync(kFull, valid[1]);
  const int nv = __popc(v0) + __popc(v1);
  const int n = nv > 1 ? nv : 1;
  int sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[c] = __reduce_add_sync(kFull, cs[c]);
  // lanes 0..2: one channel each
  const int cen = (sum[ch] + n / 2) / n;
  const int e = lane < 3 ? cen - qc : 0;
  const int l1 = __reduce_add_sync(kFull, e < 0 ? -e : e);
  bool replace = false;
  if (nv > 0 && static_cast<float>(l1) >= thr_dist) {   // warp-uniform
    // same[s][r]: the lanes whose slot r has the 8-bit luma of this lane's
    // slot s, bit plane by bit plane (XNOR of each luma bit's ballot)
    unsigned same[2][2] = {{kFull, kFull}, {kFull, kFull}};
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned plane[2] = {__ballot_sync(kFull, (y[0] >> b) & 1),
                                 __ballot_sync(kFull, (y[1] >> b) & 1)};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const unsigned mine = 0u - ((y[s] >> b) & 1u);
#pragma unroll
        for (int r = 0; r < 2; ++r) same[s][r] &= ~(plane[r] ^ mine);
      }
    }
    float t[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int cnt = __popc(same[s][0] & v0) + __popc(same[s][1] & v1);
      t[s] = valid[s] ? __ldg(ent_tab + n * 65 + cnt) : 0.0f;
    }
    replace = entropy_below(t, n, thr_entropy, lane);
  }
  if (lane < 3) out[row + ch] = replace ? cen : qc;
}

}  // namespace

// colors (N, 3) int32 (read only), nidx / nd2 (m, k) int32 rows of kernel E
// (8-byte aligned), bidx (m,) int64 the queries' rows, ent_tab the (65 * 65)
// entropy table; out (N, 3) int32, another tensor than colors: rows bidx are
// written, the others left as they are.  One launch.
extern "C" int presmooth_vote(const int32_t* colors, const int32_t* nidx,
                              const int32_t* nd2, const int64_t* bidx,
                              const float* ent_tab, int m, int k, float radius2,
                              float thr_dist, float thr_entropy, int32_t* out,
                              void* stream) {
  if (m == 0) return 0;
  if (k != kK || (reinterpret_cast<uintptr_t>(nidx) | reinterpret_cast<uintptr_t>(nd2)) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  presmooth_kernel<<<(m + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
      colors, nidx, nd2, bidx, ent_tab, m, k, radius2, thr_dist, thr_entropy, out);
  return static_cast<int>(cudaGetLastError());
}
