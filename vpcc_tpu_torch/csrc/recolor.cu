// Kernel M: color transfer from the source cloud to the reconstructed points.
//
// Replaces the XLA programs of vpcc_tpu/ops/recolor.py that
// `transfer_colors_compact` runs for grids of at most 10 bits:
// `exact_matches_device` / `_exact_and_counts` (recolor.py:43, 113),
// `_fwd_blend` (:147) and `_bwd_and_merge_compact` (:163).  The k-NN sweeps
// between them are kernel E's; the compaction is torch `nonzero`.
//
// Three entry points:
// * recolor_exact: one thread per target binary-searches its packed key
//   (x << 2b | y << b | z, -1 outside the grid) in the stably sorted source
//   keys, taking the left insertion point as `jnp.searchsorted` does; a hit
//   keeps that source (`order[loc]`), flags it matched, and the two
//   remainders (inexact targets, unmatched sources) are counted with
//   atomics (a source counts as matched on its first flag only).
// * recolor_fwd_blend: one thread per inexact target over its k nearest
//   sources: distance and color gates, weight = valid / max(d2 + offset,
//   1e-8) (a correctly rounded division), the weight sum in slot order from
//   0, the color numerator as a chain of fused multiply-adds in slot order
//   from 0, then numerator / max(sum, 1e-8).  That is the order of XLA's CPU
//   program; the source is built with --fmad=false so that no other
//   multiply-add is contracted.
// * recolor_splat_merge: (1) each unmatched source whose nearest target is
//   within the gate adds its color and a count to that target with integer
//   atomics (the reference's float32 scatter-add only sums integers of at
//   most 255, so it is exact in any order); (2) the forward colors are
//   scattered to their targets; (3) one thread per target merges: the exact
//   color, else the forward color, averaged 0.5 * (fwd + bwd) with the
//   splat where one landed, rounded half to even (rintf), clamped to 0..255.
//
// Above 10 bits (vox11) the reference runs `transfer_colors` (recolor.py:70)
// instead: host exact matching, k-NN sweeps over ALL targets and ALL
// sources, then the one XLA program `_blend` (:291).  No new entry serves
// it, because `_blend`'s optimized HLO on the CPU has the float order that
// recolor_fwd_blend and recolor_splat_merge already reproduce:
// * the weights are one loop fusion `maximum_divide_fusion` with the same
//   operands as `_fwd_blend`'s (valid / max(d2f + offset, 1e-8), a true
//   division), and the weight sum is the same separate `wrapped_reduce`
//   (slot order from 0);
// * the numerator is `reduce(multiply(cols, w), dims={1})` inside the
//   final loop fusion, the same reduce as `_fwd_blend`'s
//   `broadcast_divide_fusion` (the CPU backend contracts it to a slot-order
//   FMA chain), followed by the same `divide(num, max(wsum, 1e-8))`;
// * the merge is `_bwd_and_merge_compact`'s: select(exact, src color,
//   fwd), divide(acc, max(cnt, 1)), multiply(add(out, bwd), 0.5),
//   round-nearest-even, clamp(0, 255); acc and cnt are float32
//   scatter-adds of integers (exact in any order).
// So ops/recolor.py `transfer_colors` drives recolor_fwd_blend over every
// target (the exact ones are replaced in the merge) and recolor_splat_merge
// over every source, a matched source's distance set to MAX_DIST2 so that
// the gate drops it as `_blend`'s `~matched_src` does.  The tests hold the
// result against `transfer_colors` of the JAX package bit for bit.
//
// The level-batched GOF path (reference vpcc_tpu/parallel/gof.py
// `_exact_batch` and `_blend_batch`: `exact_matches_device` and `_blend`
// vmapped over the B frames of a hierarchy level, on clouds padded to common
// sizes) has two entries more, each one launch per step for all B frames:
// * recolor_exact_batch: the exact match over (B, Ns) sorted keys, where the
//   caller gave the padded sources (rows at or past a frame's source count)
//   the key 0x7FFFFFFF, as `exact_matches_device` does, so that they sort
//   last and match no target (a target key is at most 2^30 - 1);
// * recolor_blend_batch: the forward blend over every (frame, target), then
//   the splat of every (frame, source) whose distance the caller set to
//   MAX_DIST2 where the source is matched or padded (`_blend`'s
//   `~matched_src` and `arange < src_count`), the forward colors, and the
//   merge per (frame, target): `_blend`'s order, as the single-frame entries
//   reproduce it (above).
// A thread's frame is its flat index / the per-frame count; its sources'
// colors sit at frame * Ns, its targets' accumulators at frame * Nt.
//
// Bound: bytes.  The exact match reads each target once and ~log2(Ns)
// sorted keys per target (cached); the blend reads k index/distance pairs
// and k colors per inexact target; the merge reads and writes (Nt, 3).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;

__global__ void exact_kernel(const int32_t* order, const int32_t* sk,
                             const int32_t* tgt, int ns, int nt, int bits,
                             int32_t* eidx, bool* has, int32_t* matched,
                             int32_t* counts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nt) return;
  // frame f = blockIdx.y of a batch: its sorted keys, order and matched
  // flags at f * ns, its targets and outputs at f * nt
  const long long f = blockIdx.y;
  order += f * ns;
  sk += f * ns;
  matched += f * ns;
  tgt += f * 3LL * nt;
  eidx += f * nt;
  has += f * nt;
  const int x = tgt[3 * t], y = tgt[3 * t + 1], z = tgt[3 * t + 2];
  const int lim = 1 << bits;
  const bool in_grid = x >= 0 && x < lim && y >= 0 && y < lim && z >= 0 && z < lim;
  const int32_t kt = in_grid ? ((x << (2 * bits)) | (y << bits) | z) : -1;
  // left insertion point of kt in sk[0, ns)
  int lo = 0, hi = ns;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] < kt) lo = mid + 1; else hi = mid;
  }
  const int loc = lo < ns - 1 ? lo : (ns > 0 ? ns - 1 : 0);
  const bool hit = ns > 0 && sk[loc] == kt && kt >= 0;
  const int32_t e = ns > 0 ? order[loc] : 0;
  eidx[t] = e;
  has[t] = hit;
  if (hit) {
    // the first flag of a source makes one more matched source
    if (atomicExch(&matched[e], 1) == 0 && counts != nullptr) atomicSub(&counts[1], 1);
  } else if (counts != nullptr) {
    atomicAdd(&counts[0], 1);
  }
}

// m rows in all; rows_per_frame rows read the colors of one frame (col +
// frame * 3 * ns); one frame when rows_per_frame == m
__global__ void fwd_blend_kernel(const uint8_t* col, const int32_t* idx,
                                 const int32_t* d2, int m, int k, float gd2,
                                 float cd2, float doff, float* out, int rows_per_frame,
                                 int ns) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  col += static_cast<long long>(q / rows_per_frame) * 3 * ns;
  const int32_t* qi = idx + static_cast<int64_t>(q) * k;
  const int32_t* qd = d2 + static_cast<int64_t>(q) * k;
  const float c0r = col[3 * qi[0]], c0g = col[3 * qi[0] + 1], c0b = col[3 * qi[0] + 2];
  float wsum = 0.0f, nr = 0.0f, ng = 0.0f, nb = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int32_t dj = qd[j];
    const float df = static_cast<float>(dj);
    const float r = col[3 * qi[j]], g = col[3 * qi[j] + 1], b = col[3 * qi[j] + 2];
    bool valid;
    if (j == 0) {
      valid = dj < kMaxDist2;
    } else {
      const float er = __fsub_rn(r, c0r), eg = __fsub_rn(g, c0g), eb = __fsub_rn(b, c0b);
      // integers below 2^24: exact in any order
      const float cdist = __fadd_rn(__fadd_rn(__fmul_rn(er, er), __fmul_rn(eg, eg)),
                                    __fmul_rn(eb, eb));
      valid = dj < kMaxDist2 && df <= gd2 && cdist <= cd2;
    }
    const float w = __fdiv_rn(valid ? 1.0f : 0.0f, fmaxf(__fadd_rn(df, doff), 1e-8f));
    wsum = __fadd_rn(wsum, w);
    nr = __fmaf_rn(r, w, nr);
    ng = __fmaf_rn(g, w, ng);
    nb = __fmaf_rn(b, w, nb);
  }
  const float ws = fmaxf(wsum, 1e-8f);
  out[3 * q] = __fdiv_rn(nr, ws);
  out[3 * q + 1] = __fdiv_rn(ng, ws);
  out[3 * q + 2] = __fdiv_rn(nb, ws);
}

// uidx null: source i itself (the batch: i = frame * ns + row); a source's
// frame's colors at frame * 3 * ns, its targets' accumulators at frame * nt
__global__ void splat_kernel(const uint8_t* col, const int32_t* uidx,
                             const int32_t* tidx, const int32_t* td2, int mu,
                             float gd2, int32_t* acc, int ns, int nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mu) return;
  const int32_t d = td2[i];
  if (!(d < kMaxDist2 && static_cast<float>(d) <= gd2)) return;
  const long long f = uidx == nullptr ? i / ns : 0;
  const int s = uidx == nullptr ? static_cast<int>(i - f * ns) : uidx[i];
  col += f * 3 * ns;
  int32_t* a = acc + 4 * (f * nt + static_cast<int64_t>(tidx[i]));
  atomicAdd(a, static_cast<int32_t>(col[3 * s]));
  atomicAdd(a + 1, static_cast<int32_t>(col[3 * s + 1]));
  atomicAdd(a + 2, static_cast<int32_t>(col[3 * s + 2]));
  atomicAdd(a + 3, 1);
}

__global__ void scatter_fwd_kernel(const int32_t* iidx, const float* fwd, int mi,
                                   float* fwd_full) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mi) return;
  float* f = fwd_full + 3 * static_cast<int64_t>(iidx[i]);
  f[0] = fwd[3 * i];
  f[1] = fwd[3 * i + 1];
  f[2] = fwd[3 * i + 2];
}

// nt (frame, target) rows in all, tpf of them a frame (col + frame * 3 * ns)
__global__ void merge_kernel(const uint8_t* col, const int32_t* eidx,
                             const bool* has, const float* fwd_full,
                             const int32_t* acc, int nt, int32_t* out, int tpf, int ns) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nt) return;
  col += static_cast<long long>(t / tpf) * 3 * ns;
  const bool ex = has[t];
  const int32_t* a = acc + 4 * static_cast<int64_t>(t);
  const int32_t cnt = a[3];
  const float cf = fmaxf(static_cast<float>(cnt), 1.0f);
  for (int c = 0; c < 3; ++c) {
    float v = ex ? static_cast<float>(col[3 * eidx[t] + c]) : fwd_full[3 * t + c];
    if (cnt > 0 && !ex) {
      const float bwd = __fdiv_rn(static_cast<float>(a[c]), cf);
      v = __fmul_rn(0.5f, __fadd_rn(v, bwd));
    }
    v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    out[3 * t + c] = static_cast<int32_t>(v);
  }
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// matched (Ns,) int32 zeroed by the caller; counts = {0, Ns} on entry, then
// {inexact targets, unmatched sources}.
extern "C" int recolor_exact(const int32_t* order, const int32_t* sk,
                             const int32_t* tgt, int ns, int nt, int bits,
                             int32_t* eidx, bool* has, int32_t* matched,
                             int32_t* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt == 0) return 0;
  const int threads = 256;
  exact_kernel<<<blocks_for(nt, threads), threads, 0, st>>>(
      order, sk, tgt, ns, nt, bits, eidx, has, matched, counts);
  return static_cast<int>(cudaGetLastError());
}

// B frames: order, sk, matched (B, Ns) (matched zeroed by the caller, the
// padded sources' keys 0x7FFFFFFF); tgt (B, Nt, 3); eidx, has (B, Nt).
extern "C" int recolor_exact_batch(const int32_t* order, const int32_t* sk,
                                   const int32_t* tgt, int B, int ns, int nt, int bits,
                                   int32_t* eidx, bool* has, int32_t* matched, void* stream) {
  if (nt == 0 || B == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  exact_kernel<<<dim3(blocks_for(nt, threads), B), threads, 0, st>>>(
      order, sk, tgt, ns, nt, bits, eidx, has, matched, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int recolor_fwd_blend(const uint8_t* col, const int32_t* idx,
                                 const int32_t* d2, int m, int k, float gd2,
                                 float cd2, float doff, float* out, void* stream) {
  if (m == 0) return 0;
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  fwd_blend_kernel<<<blocks_for(m, threads), threads, 0, st>>>(col, idx, d2, m, k, gd2,
                                                              cd2, doff, out, m, 0);
  return static_cast<int>(cudaGetLastError());
}

// acc (Nt, 4) int32 and fwd_full (Nt, 3) float32 zeroed by the caller.
extern "C" int recolor_splat_merge(const uint8_t* col, const int32_t* uidx,
                                   const int32_t* tidx, const int32_t* td2,
                                   const int32_t* eidx, const bool* has,
                                   const int32_t* iidx, const float* fwd, int nt,
                                   int mu, int mi, float gd2, int32_t* acc,
                                   float* fwd_full, int32_t* out, void* stream,
                                   int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  *launched = 0;
  if (mu > 0) {
    splat_kernel<<<blocks_for(mu, threads), threads, 0, st>>>(col, uidx, tidx, td2, mu,
                                                               gd2, acc, 0, 0);
    ++*launched;
  }
  if (mi > 0) {
    scatter_fwd_kernel<<<blocks_for(mi, threads), threads, 0, st>>>(iidx, fwd, mi,
                                                                     fwd_full);
    ++*launched;
  }
  if (nt > 0) {
    merge_kernel<<<blocks_for(nt, threads), threads, 0, st>>>(col, eidx, has, fwd_full,
                                                               acc, nt, out, nt, 0);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// B frames, uncompacted: col (B, Ns, 3); idx, d2 (B, Nt, k) the forward
// k-NN; tidx, td2 (B, Ns) each source's nearest target, td2 MAX_DIST2 where
// the source is matched or padded; eidx, has (B, Nt).  acc (B, Nt, 4) int32
// zeroed by the caller; fwd (B, Nt, 3) float32 scratch; out (B, Nt, 3).
extern "C" int recolor_blend_batch(const uint8_t* col, const int32_t* idx, const int32_t* d2,
                                   const int32_t* tidx, const int32_t* td2,
                                   const int32_t* eidx, const bool* has, int B, int ns,
                                   int nt, int k, float gd2_fwd, float cd2, float doff,
                                   float gd2_bwd, int32_t* acc, float* fwd, int32_t* out,
                                   void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (B == 0 || nt == 0) return 0;
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = B * nt, ms = B * ns;
  fwd_blend_kernel<<<blocks_for(mt, 128), 128, 0, st>>>(col, idx, d2, mt, k, gd2_fwd, cd2,
                                                        doff, fwd, nt, ns);
  ++*launched;
  if (ms > 0) {
    splat_kernel<<<blocks_for(ms, 256), 256, 0, st>>>(col, nullptr, tidx, td2, ms, gd2_bwd,
                                                      acc, ns, nt);
    ++*launched;
  }
  merge_kernel<<<blocks_for(mt, 256), 256, 0, st>>>(col, eidx, has, fwd, acc, mt, out, nt,
                                                    ns);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}
