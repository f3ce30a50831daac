// Kernel M: color transfer from the source cloud to the reconstructed points.
//
// Replaces the XLA programs of vpcc_tpu/ops/recolor.py that
// `transfer_colors_compact` runs for grids of at most 10 bits:
// `exact_matches_device` / `_exact_and_counts` (recolor.py:43, 113),
// `_compact_gather` (:127), `_fwd_blend` (:147) and `_bwd_and_merge_compact`
// (:163).  The k-NN sweeps between them are kernel E's.
//
// Two entry points, each one cooperative launch (persistent blocks,
// grid-stride loops, phases behind grid barriers):
// * recolor_exact_compact:
//   0. zero the per-source matched flags; copy every stride-th sorted key
//      (at most kSamples a frame) to a sample table;
//   1. a thread a target: its packed key (x << 2b | y << b | z, -1 outside
//      the grid) looked up in the stably sorted source keys, the left
//      insertion point as `jnp.searchsorted` takes it: first among the
//      samples staged in shared memory, then in the window of at most
//      `stride` keys between two samples; a hit keeps that source
//      (`order[loc]`) and sets its matched flag (a plain byte store: every
//      writer stores 1);
//   2. (compaction) each block counts the unmatched sources of its chunk;
//   3. (compaction) each block sums the counts of the blocks before it and
//      writes, in index order as `torch.nonzero` and the reference's
//      `_compact_gather` list them, the inexact targets of its chunk and the
//      unmatched sources of its chunk (block scans), each beside its
//      position (the queries of kernel E's two sweeps), and block 0 the two
//      counts.  The wrapper reads the counts: the call's one host wait,
//      where the reference has its own (`int(n_in_d)`, recolor.py:229).
//   Each block takes a contiguous chunk of targets and of sources, so that
//   its counts are of whole index ranges.  Without compaction the same
//   launch matches B frames (the level path): a frame's blocks are
//   gridDim / B consecutive ones.
// * recolor_blend_merge:
//   0. zero the accumulators of the inexact targets (only they read one)
//      and, where matched sources are to be dropped here, the flags;
//      (uncompacted single frame) then flag every exact target's source;
//   1. the splat: each unmatched source whose nearest target is within the
//      gate and not an exact target adds its color and a count to that
//      target with integer atomics (the reference's float32 scatter-add
//      only sums integers of at most 255, so it is exact in any order);
//   2. a thread a target: an exact target takes its source's color; an
//      inexact one runs the forward blend over its row of the k-NN output
//      (16-byte loads where the row is aligned) and merges it with the
//      splat.
//   The forward blend keeps XLA's CPU float order: for each slot the
//   distance and color gates, the weight valid / max(d2 + offset, 1e-8) (a
//   correctly rounded division), the weight sum in slot order from 0, the
//   color numerator as a chain of fused multiply-adds in slot order from 0;
//   then numerator / max(sum, 1e-8).  The merge: the splat's mean (a
//   division), 0.5 * (forward + mean) where a splat landed, rounded half to
//   even (rintf), clamped to 0..255.  The source is built with
//   --fmad=false, so no other multiply-add is contracted.
//
// Above 10 bits (vox11) the reference runs `transfer_colors` (recolor.py:70)
// instead: host exact matching, k-NN sweeps over ALL targets and ALL
// sources, then the one XLA program `_blend` (:291).  `_blend`'s optimized
// HLO on the CPU has the float order above: the weights are one loop fusion
// with `_fwd_blend`'s operands, the weight sum the same separate reduce (slot
// order from 0), the numerator the same slot-order FMA chain, then the same
// division and `_bwd_and_merge_compact`'s merge; its acc and cnt are float32
// scatter-adds of integers.  So recolor_blend_merge serves it uncompacted:
// every target's row of the k-NN output, every source, a source flagged as
// matched in phase 0 dropped from the splat as `_blend`'s `~matched_src`
// does.
//
// The level-batched GOF path (reference vpcc_tpu/parallel/gof.py
// `_exact_batch` and `_blend_batch`: `exact_matches_device` and `_blend`
// vmapped over the B frames of a hierarchy level, on clouds padded to common
// sizes) runs both entries over B frames at once: recolor_exact_compact
// without compaction, where the caller gave the padded sources (rows at or
// past a frame's count) the key 0x7FFFFFFF, as `exact_matches_device` does,
// so that they sort last and match no target (a target key is at most
// 2^30 - 1); recolor_blend_merge uncompacted, where the caller set the
// distance of a matched or padded source to MAX_DIST2.  A row's frame is its
// flat index / the per-frame count; its sources' colors sit at frame * Ns,
// its targets' accumulators at frame * Nt.
//
// Bound: bytes.  The exact match reads each target once and about log2(Ns)
// sorted keys a target (L2, a window of a few hundred bytes after the
// shared samples); the compaction writes the two lists with their
// positions; the blend reads k index/distance pairs and k colors a row of
// the k-NN output, the merge writes (Nt, 3).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kMaxDist2 = 0x7FFFFFF0;
constexpr int kThreads = 512;
constexpr int kSamples = 4096;     // sorted keys a frame staged in shared memory
constexpr int kMaxBlocks = 2048;   // per-block counts of the scratch

// exclusive scan of v over the block; *total receives the block's sum
__device__ __forceinline__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, s, d);
    if (lane >= d) s += t;
  }
  if (lane == 31) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < kThreads / 32) sh[lane] = w;   // inclusive warp sums
  }
  __syncthreads();
  *total = sh[kThreads / 32 - 1];
  const int before = warp ? sh[warp - 1] : 0;
  __syncthreads();   // read by all before a next scan writes sh
  return before + s - v;
}

__device__ __forceinline__ int block_sum(int v, int* sh) {
  int total;
  block_scan(v, sh, &total);
  return total;
}

struct ExactArgs {
  const int32_t* order;   // (B, ns)
  const int32_t* sk;      // (B, ns)
  const int32_t* tgt;     // (B, nt, 3)
  const int32_t* src;     // (ns, 3) or null: no positions beside the lists
  int B, ns, nt, bits;
  int stride, nsamp;      // a sample every `stride` sorted keys, nsamp a frame
  int32_t* eidx;          // (B, nt)
  uint8_t* has;           // (B, nt)
  uint8_t* matched;       // (B, ns)
  bool compact;           // list the inexact targets and unmatched sources
  int32_t* iidx;          // (nt,)
  int32_t* tq;            // (nt, 3) or null: no positions
  int32_t* uidx;          // (ns,)
  int32_t* sq;            // (ns, 3) or null: no positions
  int32_t* counts;        // (2,)
  int32_t* parts;         // 2 * kMaxBlocks ints
  int32_t* samples;       // B * kSamples ints
};

// the left insertion point of kt in the frame's sorted keys sk[0, ns):
// first among the samples s[j] = sk[j * stride], then between two samples
__device__ __forceinline__ int lower_bound(const int32_t* sk, int ns, const int* samp,
                                           int nsamp, int stride, int32_t kt) {
  int lo = 0, hi = nsamp;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (samp[mid] < kt) lo = mid + 1; else hi = mid;
  }
  // samp[lo - 1] < kt <= samp[lo]: the point lies in ((lo - 1) * stride, lo * stride]
  int a = lo == 0 ? 0 : (lo - 1) * stride + 1;
  int b = lo == nsamp ? ns : lo * stride;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(sk + mid) < kt) a = mid + 1; else b = mid;
  }
  return a;
}

// a block's rows [r0, r1) whose flag keep(i) holds, in index order from
// position `first` on: idx[pos] = i and, given pos3, pos3[pos] = rows3[i]
template <typename Keep>
__device__ __forceinline__ void list_rows(int r0, int r1, int first, Keep keep, int32_t* idx,
                                          const int32_t* rows3, int32_t* pos3, int* sh) {
  for (int base = r0; base < r1; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool in = i < r1 && keep(i);
    int total;
    const int r = first + block_scan(in, sh, &total);
    if (in) {
      idx[r] = i;
      if (pos3 != nullptr) {
        pos3[3 * r] = rows3[3 * i];
        pos3[3 * r + 1] = rows3[3 * i + 1];
        pos3[3 * r + 2] = rows3[3 * i + 2];
      }
    }
    first += total;
  }
}

// the sum over the blocks before this one (and over all) of parts[0, gridDim)
__device__ __forceinline__ int blocks_before(const int32_t* parts, int* all, int* sh) {
  int before = 0, every = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const int c = __ldcg(parts + b);
    every += c;
    if (b < static_cast<int>(blockIdx.x)) before += c;
  }
  before = block_sum(before, sh);
  *all = block_sum(every, sh);
  return before;
}

__global__ void __launch_bounds__(kThreads) exact_kernel(const __grid_constant__ ExactArgs a) {
  __shared__ int s_samp[kSamples];
  __shared__ int sh[32];
  cg::grid_group grid = cg::this_grid();
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;

  // 0. the flags zeroed, the samples copied
  {
    // bytes up to a 4-byte boundary, then words, then the tail's bytes
    const long long nflag = static_cast<long long>(a.B) * a.ns;
    const long long head = min(nflag, static_cast<long long>(
        (4 - (reinterpret_cast<uintptr_t>(a.matched) & 3)) & 3));
    const long long words = (nflag - head) / 4;
    uint32_t* w = reinterpret_cast<uint32_t*>(a.matched + head);
    for (long long i = gtid; i < words; i += gstride) w[i] = 0u;
    for (long long i = gtid; i < head; i += gstride) a.matched[i] = 0;
    for (long long i = head + 4 * words + gtid; i < nflag; i += gstride) a.matched[i] = 0;
    for (long long i = gtid; i < static_cast<long long>(a.B) * a.nsamp; i += gstride) {
      const long long f = i / a.nsamp, j = i - f * a.nsamp;
      a.samples[f * kSamples + j] = a.sk[f * a.ns + j * a.stride];
    }
  }
  grid.sync();

  // 1. a thread a target of the block's chunk of its frame
  const int bpf = gridDim.x / a.B;   // blocks a frame
  const int f = blockIdx.x / bpf, lb = blockIdx.x - f * bpf;
  const int tchunk = (a.nt + bpf - 1) / bpf;
  const int t0 = min(lb * tchunk, a.nt), t1 = min(t0 + tchunk, a.nt);
  for (int j = threadIdx.x; j < a.nsamp; j += kThreads) s_samp[j] = a.samples[f * kSamples + j];
  __syncthreads();
  const int32_t* sk = a.sk + static_cast<long long>(f) * a.ns;
  const int32_t* order = a.order + static_cast<long long>(f) * a.ns;
  uint8_t* matched = a.matched + static_cast<long long>(f) * a.ns;
  const long long tb = static_cast<long long>(f) * a.nt;
  const int lim = 1 << a.bits;
  int n_inexact = 0;
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const int32_t* p = a.tgt + 3 * (tb + t);
    const int x = p[0], y = p[1], z = p[2];
    const bool in_grid = x >= 0 && x < lim && y >= 0 && y < lim && z >= 0 && z < lim;
    const int32_t kt = in_grid ? ((x << (2 * a.bits)) | (y << a.bits) | z) : -1;
    const int lo = lower_bound(sk, a.ns, s_samp, a.nsamp, a.stride, kt);
    const int loc = lo < a.ns - 1 ? lo : (a.ns > 0 ? a.ns - 1 : 0);
    const bool hit = a.ns > 0 && sk[loc] == kt && kt >= 0;
    const int32_t e = a.ns > 0 ? order[loc] : 0;
    a.eidx[tb + t] = e;
    a.has[tb + t] = hit;
    if (hit) matched[e] = 1;
    n_inexact += !hit;
  }
  if (!a.compact) return;   // no grid barrier follows: every block leaves alike
  n_inexact = block_sum(n_inexact, sh);
  if (threadIdx.x == 0) a.parts[blockIdx.x] = n_inexact;
  grid.sync();

  // 2. the unmatched sources of the block's chunk, counted
  const int schunk = (a.ns + gridDim.x - 1) / gridDim.x;
  const int s0 = min(static_cast<int>(blockIdx.x) * schunk, a.ns), s1 = min(s0 + schunk, a.ns);
  int n_unmatched = 0;
  for (int s = s0 + threadIdx.x; s < s1; s += kThreads) n_unmatched += !a.matched[s];
  n_unmatched = block_sum(n_unmatched, sh);
  if (threadIdx.x == 0) a.parts[kMaxBlocks + blockIdx.x] = n_unmatched;
  grid.sync();

  // 3. both lists in index order, from the counts of the blocks before
  int all_t = 0, all_s = 0;
  const int before_t = blocks_before(a.parts, &all_t, sh);
  const int before_s = blocks_before(a.parts + kMaxBlocks, &all_s, sh);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.counts[0] = all_t;
    a.counts[1] = all_s;
  }
  list_rows(t0, t1, before_t, [&](int t) { return !a.has[t]; }, a.iidx, a.tgt, a.tq, sh);
  list_rows(s0, s1, before_s, [&](int s) { return !a.matched[s]; }, a.uidx, a.src, a.sq, sh);
}

struct BlendArgs {
  const uint8_t* col;     // (B, ns, 3)
  const int32_t* eidx;    // (B, nt)
  const uint8_t* has;     // (B, nt)
  const int32_t* iidx;    // (mi,) the targets of the k-NN rows (every inexact one)
  const int32_t* idx;     // (rows, k)
  const int32_t* d2;      // (rows, k)
  const int32_t* uidx;    // (mu,) the sources of the splat
  const int32_t* tidx;    // (mu,) or (B, ns)
  const int32_t* td2;
  bool listed_rows;       // iidx given; else row = target
  bool listed_srcs;       // uidx given; else every source
  int B, ns, nt, k, mi, mu;
  float gd2f, cd2, doff, gd2b;
  bool mark;              // drop the sources of exact targets from the splat
  bool vec;               // the k-NN rows aligned for 16-byte loads
  int4* acc;              // (B * nt) r, g, b, count
  uint8_t* flags;         // (B * ns) matched sources, when mark
  int32_t* out;           // (B, nt, 3)
};

// the forward blend of k-NN row r (target t) and its merge with the splat
__device__ __forceinline__ void blend_row(const BlendArgs& a, long long r, long long t) {
  const uint8_t* col = a.col + (t / a.nt) * 3LL * a.ns;
  const int32_t* qi = a.idx + r * a.k;
  const int32_t* qd = a.d2 + r * a.k;
  float wsum = 0.0f, nr = 0.0f, ng = 0.0f, nb = 0.0f, c0r = 0.0f, c0g = 0.0f, c0b = 0.0f;
  const auto slot = [&](int j, int32_t id, int32_t dj) {
    const float df = static_cast<float>(dj);
    const float cr = col[3 * id], cg_ = col[3 * id + 1], cb = col[3 * id + 2];
    bool valid;
    if (j == 0) {
      c0r = cr;
      c0g = cg_;
      c0b = cb;
      valid = dj < kMaxDist2;
    } else {
      const float er = __fsub_rn(cr, c0r), eg = __fsub_rn(cg_, c0g), eb = __fsub_rn(cb, c0b);
      // integers below 2^24: exact in any order
      const float cdist = __fadd_rn(__fadd_rn(__fmul_rn(er, er), __fmul_rn(eg, eg)),
                                    __fmul_rn(eb, eb));
      valid = dj < kMaxDist2 && df <= a.gd2f && cdist <= a.cd2;
    }
    const float w = __fdiv_rn(valid ? 1.0f : 0.0f, fmaxf(__fadd_rn(df, a.doff), 1e-8f));
    wsum = __fadd_rn(wsum, w);
    nr = __fmaf_rn(cr, w, nr);
    ng = __fmaf_rn(cg_, w, ng);
    nb = __fmaf_rn(cb, w, nb);
  };
  if (a.vec) {
    for (int j = 0; j < a.k; j += 4) {
      const int4 i4 = *reinterpret_cast<const int4*>(qi + j);
      const int4 d4 = *reinterpret_cast<const int4*>(qd + j);
      slot(j, i4.x, d4.x);
      slot(j + 1, i4.y, d4.y);
      slot(j + 2, i4.z, d4.z);
      slot(j + 3, i4.w, d4.w);
    }
  } else {
    for (int j = 0; j < a.k; ++j) slot(j, qi[j], qd[j]);
  }
  const float ws = fmaxf(wsum, 1e-8f);
  float v[3] = {__fdiv_rn(nr, ws), __fdiv_rn(ng, ws), __fdiv_rn(nb, ws)};
  const int4 s = a.mu > 0 ? a.acc[t] : make_int4(0, 0, 0, 0);
  const float cf = fmaxf(static_cast<float>(s.w), 1.0f);
  const int sum[3] = {s.x, s.y, s.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (s.w > 0) {
      const float bwd = __fdiv_rn(static_cast<float>(sum[c]), cf);
      v[c] = __fmul_rn(0.5f, __fadd_rn(v[c], bwd));
    }
    a.out[3 * t + c] = static_cast<int32_t>(fminf(fmaxf(rintf(v[c]), 0.0f), 255.0f));
  }
}

// three blocks an SM (40 registers; two at the 48 it takes unbounded)
__global__ void __launch_bounds__(kThreads, 3)
    blend_kernel(const __grid_constant__ BlendArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  const long long nt = static_cast<long long>(a.B) * a.nt, ns = static_cast<long long>(a.B) * a.ns;

  // 0. the inexact targets' accumulators (and the flags) zeroed
  if (a.mu > 0) {
    for (long long r = gtid; r < a.mi; r += gstride) {
      const long long t = a.listed_rows ? a.iidx[r] : r;
      if (a.listed_rows || !a.has[t]) a.acc[t] = make_int4(0, 0, 0, 0);
    }
  }
  if (a.mark) {
    for (long long i = gtid; i < ns; i += gstride) a.flags[i] = 0;
    grid.sync();
    for (long long t = gtid; t < nt; t += gstride)
      if (a.has[t]) a.flags[(t / a.nt) * a.ns + a.eidx[t]] = 1;
  }
  if (a.mu > 0 || a.mark) grid.sync();

  // 1. the splat
  if (a.mu > 0) {
    for (long long i = gtid; i < a.mu; i += gstride) {
      const int32_t d = a.td2[i];
      if (!(d < kMaxDist2 && static_cast<float>(d) <= a.gd2b)) continue;
      const long long f = a.listed_srcs ? 0 : i / a.ns;
      const long long s = a.listed_srcs ? a.uidx[i] : i - f * a.ns;
      if (a.mark && a.flags[f * a.ns + s]) continue;
      const long long t = f * a.nt + a.tidx[i];
      if (a.has[t]) continue;   // an exact target keeps its color
      const uint8_t* c = a.col + 3 * (f * a.ns + s);
      int* p = reinterpret_cast<int*>(a.acc + t);
      atomicAdd(p, static_cast<int>(c[0]));
      atomicAdd(p + 1, static_cast<int>(c[1]));
      atomicAdd(p + 2, static_cast<int>(c[2]));
      atomicAdd(p + 3, 1);
    }
    grid.sync();
  }

  // 2. a thread a target: the exact color, or the blend and the merge
  for (long long t = gtid; t < nt; t += gstride) {
    if (a.has[t]) {
      const uint8_t* c = a.col + 3 * ((t / a.nt) * a.ns + a.eidx[t]);
      a.out[3 * t] = c[0];
      a.out[3 * t + 1] = c[1];
      a.out[3 * t + 2] = c[2];
    } else if (!a.listed_rows) {
      blend_row(a, t, t);
    }
  }
  if (a.listed_rows)
    for (long long r = gtid; r < a.mi; r += gstride) blend_row(a, r, a.iidx[r]);
}

// the grid of a cooperative launch of `kernel` for `work` items: as many
// blocks as fit on the card at once (`*most`, found on the first call), at
// most one a kThreads items and at most kMaxBlocks, a multiple of `multiple`
cudaError_t grid_for(const void* kernel, long long work, int multiple, int* most_cache,
                     int* blocks) {
  if (*most_cache == 0) {
    int device = 0, sms = 0, fit = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    *most_cache = sms * fit;
  }
  long long most = *most_cache;
  if (most > kMaxBlocks) most = kMaxBlocks;
  long long want = (work + kThreads - 1) / kThreads;
  if (want < multiple) want = multiple;
  if (want > most) want = most;
  *blocks = static_cast<int>(want / multiple * multiple);
  return *blocks >= multiple && multiple > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// B frames: order, sk (B, Ns) (the padded sources' keys 0x7FFFFFFF), tgt
// (B, Nt, 3); out eidx (B, Nt) int32, has (B, Nt) bool, matched (B, Ns)
// bool.  With compact (B = 1 only): iidx (Nt,), uidx (Ns,) int32 lists of
// the inexact targets and unmatched sources in index order, counts (2,)
// int32 = their lengths, and, given tq / sq ((Nt, 3), (Ns, 3) int32; src
// the (Ns, 3) source positions), their positions.  scratch: 2 * 2048 +
// B * 4096 int32.  One cooperative launch.
extern "C" int recolor_exact_compact(const int32_t* order, const int32_t* sk, const int32_t* tgt,
                                     const int32_t* src, int B, int ns, int nt, int bits,
                                     int32_t* eidx, bool* has, bool* matched, int compact,
                                     int32_t* iidx, int32_t* tq, int32_t* uidx, int32_t* sq,
                                     int32_t* counts, int32_t* scratch, void* stream) {
  static int most = 0;
  if (B == 0 || (nt == 0 && !compact)) return 0;
  if (B < 0 || bits > 10 || (compact && (B != 1 || counts == nullptr))
      || (sq != nullptr && src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ExactArgs a;
  a.order = order;
  a.sk = sk;
  a.tgt = tgt;
  a.src = src;
  a.B = B;
  a.ns = ns;
  a.nt = nt;
  a.bits = bits;
  a.stride = ns > kSamples ? (ns + kSamples - 1) / kSamples : 1;
  a.nsamp = (ns + a.stride - 1) / a.stride;
  a.eidx = eidx;
  a.has = reinterpret_cast<uint8_t*>(has);
  a.matched = reinterpret_cast<uint8_t*>(matched);
  a.compact = compact != 0;
  a.iidx = iidx;
  a.tq = tq;
  a.uidx = uidx;
  a.sq = sq;
  a.counts = counts;
  a.parts = scratch;
  a.samples = scratch + 2 * kMaxBlocks;
  const long long work = static_cast<long long>(B) * (nt > ns ? nt : ns);
  int blocks = 0;
  cudaError_t err = grid_for(reinterpret_cast<const void*>(exact_kernel), work, B, &most,
                             &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(exact_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// B frames: col (B, Ns, 3) uint8; eidx, has (B, Nt); the k-NN rows idx, d2
// (mi, k) of the targets iidx (mi,) (B = 1; every inexact target), or with
// mi < 0 (B * Nt, k), a row a target; the splat's sources uidx (mu,)
// (B = 1) with their nearest targets tidx, td2 (mu,), or with mu < 0 every
// source, tidx, td2 (B, Ns); mark (mu < 0): drop the sources of exact
// targets.  scratch: B * Nt * 4 int32, then B * Ns bytes.  out (B, Nt, 3)
// int32.  One cooperative launch.
extern "C" int recolor_blend_merge(const uint8_t* col, const int32_t* eidx, const bool* has,
                                   const int32_t* iidx, int mi, const int32_t* idx,
                                   const int32_t* d2, int k, const int32_t* uidx, int mu,
                                   const int32_t* tidx, const int32_t* td2, int B, int ns, int nt,
                                   float gd2f, float cd2, float doff, float gd2b, int mark,
                                   int32_t* scratch, int32_t* out, void* stream) {
  static int most = 0;
  if (B == 0 || nt == 0) return 0;
  if (B < 0 || k < 1 || k > 64 || ((mi >= 0 || mu >= 0) && B != 1) || (mark && mu >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BlendArgs a;
  a.col = col;
  a.eidx = eidx;
  a.has = reinterpret_cast<const uint8_t*>(has);
  a.iidx = iidx;
  a.idx = idx;
  a.d2 = d2;
  a.uidx = uidx;
  a.tidx = tidx;
  a.td2 = td2;
  a.B = B;
  a.ns = ns;
  a.nt = nt;
  a.k = k;
  a.listed_rows = mi >= 0;
  a.listed_srcs = mu >= 0;
  a.mi = mi >= 0 ? mi : B * nt;
  a.mu = mu >= 0 ? mu : B * ns;
  a.gd2f = gd2f;
  a.cd2 = cd2;
  a.doff = doff;
  a.gd2b = gd2b;
  a.mark = mark != 0;
  a.vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0
          && (reinterpret_cast<uintptr_t>(d2) & 15) == 0;
  a.acc = reinterpret_cast<int4*>(scratch);
  a.flags = reinterpret_cast<uint8_t*>(scratch + 4LL * B * nt);
  a.out = out;
  const long long work = static_cast<long long>(B) * (nt > ns ? nt : ns);
  int blocks = 0;
  cudaError_t err = grid_for(reinterpret_cast<const void*>(blend_kernel), work, 1, &most,
                             &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(blend_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
