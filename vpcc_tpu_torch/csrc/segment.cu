// Kernel F: normals and projection-plane segmentation (K10).
//
// Replaces the XLA programs vpcc_tpu/ops/normals.py `pca_normals` (:72-91)
// with `_smallest_eigenvector_sym3` (:27-68), `orient_normals` (:95-119),
// and vpcc_tpu/ops/segmentation.py `initial_segmentation` (:113-124) and
// `refine_segmentation` (:146-169), and `high_gradient_aux` (:128-143).
// Four entry points:
//   pca_normals     gather the k neighbours, mean, 3x3 covariance, closed-form
//                   smallest eigenvector (one launch);
//   orient_normals  the centroid of the valid rows, the radial sign and the
//                   ORIENT_ITERATIONS sign-consensus sweeps (one cooperative
//                   launch);
//   segment_partition  the initial segmentation (argmax over the J
//                   orientations) or a given partition, then the refinement
//                   sweeps (one cooperative launch; with no sweeps it needs
//                   no neighbour table);
//   high_gradient_aux  per voxel the first argmax of the J scores with the
//                   assigned orientation's lowered by 1e9 (alt), and whether
//                   the assigned score is <= 0.577 (weak); one launch, for
//                   highGradientSeparation.
//
// Float32 in the reference's operation order, with a fused multiply-add
// exactly where XLA's CPU backend contracts one (found by comparing with
// the reference bit for bit): the covariance sums over k, the eigen-solver
// terms below, the 3-term dot products and the refine score
// base + (lambda/k) * votes.  This file is compiled with --fmad=false, so
// only the explicit __fmaf_rn calls fuse.  `acosf`/`cosf` are CUDA's, not
// XLA's: normals agree with the reference to a tolerance, not bit for bit.
//
// Bound: the neighbour table (V x k int32 + bool) and the per-neighbour
// gathers of every sweep; a few hundred flops per voxel.  Every step waits
// on loads more than it moves bytes, so the design cuts round trips:
// * PCA: a warp takes 32 consecutive voxels; its lanes walk the 32 x k
//   table slots in order (coalesced reads, kBatch slots a lane in flight),
//   gather the neighbours' positions into shared memory (rows of K | 1
//   float4: no bank conflicts), and each voxel's lane runs the sums and the
//   covariance FMA chain in k order, as the plain version does.
// * The sweeps run a thread per voxel; for k = 16 a row is four 16-byte
//   loads of indices and one of flags, and every gather of the row is
//   issued before the first is used.  k = 16 is a template constant.
// * No launch per sweep and no host wait.  The orientation and the
//   partition run as cooperative launches (two blocks of 640 threads an SM,
//   a thread per voxel on the bench frames; each block a contiguous chunk
//   of voxels, the same in every phase, its k-NN rows cached in shared
//   memory) with a grid barrier between sweeps; the two ping-pong buffers live in device
//   memory.  The orientation's centroid is summed on the device: int64
//   sums reduced by warps and blocks, each block's partial summed again by
//   every block after the barrier (exact in any order), each sum rounded
//   once to float32 (__ll2float_rn, as np.float32(int64)) and divided by
//   the float32 count (__fdiv_rn).  The per-sweep flags are zeroed inside
//   the launch, so nothing else runs on the stream.
// * The orientation's per-slot dot products do not change between sweeps
//   (only the signs do, and IEEE rounding is symmetric), so they are
//   computed once and a sweep gathers one state byte a neighbour; the votes
//   keep the plain version's float sum in k order.  The refinement keeps
//   its partitions as bytes and counts its votes bytewise in four words
//   (integer counts, exact in any order).
// * Exact skip.  A sweep's result for a voxel is a function of its inputs
//   (the neighbours' states, and for the orientation its own), so a voxel
//   none of whose inputs changed in the last sweep keeps its state without
//   the arithmetic; a bit of each state byte says whether it changed.
// * Exact early exit.  A sweep is a pure function of the previous sweep's
//   state, so once a sweep changes no sign (no partition), every later one
//   returns the same state.  Each sweep has its own "changed" flag (none is
//   reset between barriers); every block reads it after the barrier and
//   stops with the same result as the full count.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxJ = 18;
constexpr int kThreads = 640;           // cooperative kernels: two blocks an SM
constexpr int kBlocksPerSm = 2;
constexpr int kBatch = 8;               // PCA: table slots a lane has in flight at once

__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// XLA's a0*b0 + a1*b1 + a2*b2 as a reduce: fma(a2, b2, fma(a1, b1, a0*b0)).
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fma_(a[2], b[2], fma_(a[1], b[1], mul(a[0], b[0])));
}

// a*b - c*d with the first product fused: fma(a, b, -(c*d)).
__device__ __forceinline__ float msub(float a, float b, float c, float d) {
  return fma_(a, b, -mul(c, d));
}

// shared-memory row strides (4-byte words) of the per-slot terms: odd, so
// that the 32 lanes of a warp reading one slot each of their own rows hit
// 32 distinct banks (float4 rows: 8 lanes a phase, 8 distinct groups)
__host__ __device__ inline int word_stride(int K) { return K | 1; }

// closed-form smallest eigenvector (reference _smallest_eigenvector_sym3);
// XLA rewrites x / 3 and x / 6 as products with the float32 reciprocals
__device__ void smallest_eigenvector(float c00, float c01, float c02, float c11, float c12,
                                     float c22, float* out) {
  const float r3 = 1.f / 3.f, r6 = 1.f / 6.f;
  const float s = add(add(c00, c11), c22);
  const float b00 = fma_(-s, r3, c00), b11 = fma_(-s, r3, c11), b22 = fma_(-s, r3, c22);
  const float p1 = fma_(c12, c12, fma_(c01, c01, mul(c02, c02)));
  const float p2 = fma_(2.f, p1, fma_(b22, b22, fma_(b00, b00, mul(b11, b11))));
  const float p = __fsqrt_rn(fmaxf(mul(p2, r6), 1e-20f));
  const float ip = __fdiv_rn(1.f, p);
  const float d00 = mul(b00, ip), d11 = mul(b11, ip), d22 = mul(b22, ip);
  const float d01 = mul(c01, ip), d02 = mul(c02, ip), d12 = mul(c12, ip);
  const float t1 = msub(d11, d22, d12, d12);
  const float t2 = msub(d01, d22, d12, d02);
  const float t3 = msub(d01, d12, d11, d02);
  const float detb = fma_(d02, t3, fma_(d00, t1, -mul(d01, t2)));
  const float r = fminf(fmaxf(mul(detb, 0.5f), -1.f), 1.f);
  const float arg = fma_(acosf(r), r3, 2.09439516f);   // float32(2 pi / 3)
  const float lam = fma_(s, r3, mul(add(p, p), cosf(arg)));
  const float r0[3] = {sub(c00, lam), c01, c02};
  const float r1[3] = {c01, sub(c11, lam), c12};
  const float r2[3] = {c02, c12, sub(c22, lam)};
  float v[3][3];
  const float* rows[3][2] = {{r0, r1}, {r0, r2}, {r1, r2}};
  float n[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* a = rows[t][0];
    const float* b = rows[t][1];
    v[t][0] = msub(a[1], b[2], a[2], b[1]);
    v[t][1] = msub(a[2], b[0], a[0], b[2]);
    v[t][2] = msub(a[0], b[1], a[1], b[0]);
    n[t] = dot3(v[t], v[t]);
  }
  const bool first01 = n[0] >= n[1];
  const float nb = fmaxf(n[0], n[1]);
  const bool pick01 = nb >= n[2];
  const float vn = fmaxf(__fsqrt_rn(fmaxf(nb, n[2])), 1e-20f);
  if (p2 < 1e-12f) {  // isotropic: any unit vector
    out[0] = 0.f;
    out[1] = 0.f;
    out[2] = 1.f;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = __fdiv_rn(pick01 ? (first01 ? v[0][c] : v[1][c]) : v[2][c], vn);
  }
}

// The k of a launch: the template's constant, or the runtime K where the
// template argument is 0 (the divisions by k of the slot walks fold into
// shifts for the encoder's k = 16).
template <int KT>
__device__ __forceinline__ int kdim(int K) { return KT ? KT : K; }

// One warp per 32 consecutive voxels: the lanes gather the neighbours'
// positions slot by slot (coalesced table reads, kBatch slots a lane in
// flight at once), the voxel's lane then runs the sums in k order.  Dynamic
// shared memory: a float4 row of K | 1 slots per voxel, 32 rows per warp.
template <int KT>
__global__ void pca_normals_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ nn_idx,
                                   const uint8_t* __restrict__ nn_valid, int V,
                                   int K_, float* __restrict__ normals) {
  extern __shared__ float4 s_pts[];
  const int K = kdim<KT>(K_);
  const int lane = threadIdx.x & 31;
  const int S = word_stride(K);
  float4* rows = s_pts + (threadIdx.x >> 5) * 32 * S;
  const long long base = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                          + (threadIdx.x >> 5)) * 32;
  if (base >= V) return;
  const int nv = static_cast<int>(min(32LL, V - base));
  const int total = nv * K;
  const long long sbase = base * K;
  for (int e0 = 0; e0 < total; e0 += 32 * kBatch) {
    int j[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + 32 * u + lane;
      j[u] = e < total ? nn_idx[sbase + e] : 0;
      ok[u] = e < total && nn_valid[sbase + e];
    }
    int q[kBatch][3];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int c = 0; c < 3; ++c) q[u][c] = pos[3 * j[u] + c];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + 32 * u + lane;
      if (e < total)
        rows[(e / K) * S + e % K] = make_float4(static_cast<float>(q[u][0]),
                                                static_cast<float>(q[u][1]),
                                                static_cast<float>(q[u][2]), ok[u] ? 1.f : 0.f);
    }
  }
  __syncwarp();
  if (lane >= nv) return;
  const float4* row = rows + lane * S;
  float cnt = 0.f, sum[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float4 q = row[k];
    cnt = add(cnt, q.w);
    sum[0] = add(sum[0], mul(q.x, q.w));
    sum[1] = add(sum[1], mul(q.y, q.w));
    sum[2] = add(sum[2], mul(q.z, q.w));
  }
  cnt = fmaxf(cnt, 1.f);
  float mean[3];
  for (int c = 0; c < 3; ++c) mean[c] = __fdiv_rn(sum[c], cnt);
  float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float4 q = row[k];
    const float d0 = mul(sub(q.x, mean[0]), q.w);
    const float d1 = mul(sub(q.y, mean[1]), q.w);
    const float d2 = mul(sub(q.z, mean[2]), q.w);
    c00 = fma_(d0, d0, c00);
    c01 = fma_(d0, d1, c01);
    c02 = fma_(d0, d2, c02);
    c11 = fma_(d1, d1, c11);
    c12 = fma_(d1, d2, c12);
    c22 = fma_(d2, d2, c22);
  }
  smallest_eigenvector(c00, c01, c02, c11, c12, c22,
                       normals + 3 * static_cast<long long>(base + lane));
}

// A voxel's k-NN row for k = 16: the neighbours' indices (four 16-byte
// words) and validity flags (one).  A cooperative kernel keeps the rows of
// its first `rc` rounds of voxels in shared memory, copied once with
// coalesced loads (a block's voxels of one round are contiguous), and reads
// a later round's rows from device memory.  A row in shared memory is
// kRowWords int4 words, an odd count, so that the 16-byte loads of 8
// threads on 8 rows hit distinct banks.
struct Row16 {
  int j[16];
  uint8_t ok[16];
};

__device__ __forceinline__ void unpack_idx(const int4* w, int* j) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = w[q];
    j[4 * q] = v.x;
    j[4 * q + 1] = v.y;
    j[4 * q + 2] = v.z;
    j[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void unpack_f(const int4* w, float* d) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = w[q];
    d[4 * q] = __int_as_float(v.x);
    d[4 * q + 1] = __int_as_float(v.y);
    d[4 * q + 2] = __int_as_float(v.z);
    d[4 * q + 3] = __int_as_float(v.w);
  }
}

__device__ __forceinline__ void unpack_ok(int4 f, uint8_t* ok) {
  const unsigned w[4] = {static_cast<unsigned>(f.x), static_cast<unsigned>(f.y),
                         static_cast<unsigned>(f.z), static_cast<unsigned>(f.w)};
#pragma unroll
  for (int k = 0; k < 16; ++k) ok[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
}

// copy the first m rows of a block's chunk (voxels c0 ..) of a (V, 16)
// int32 table (words 0-3) and, given flags, of its (V, 16) bool flags (word
// 4) into rows of row_words int4 words
__device__ void cache_rows(int4* rows, int row_words, const int32_t* __restrict__ nn_idx,
                           const uint8_t* __restrict__ nn_valid, long long c0, int m) {
  const int4* gi = reinterpret_cast<const int4*>(nn_idx) + c0 * 4;
  for (int c = threadIdx.x; c < m * 4; c += kThreads) rows[(c / 4) * row_words + c % 4] = gi[c];
  if (nn_valid)
    for (int l = threadIdx.x; l < m; l += kThreads)
      rows[l * row_words + 4] = reinterpret_cast<const int4*>(nn_valid)[c0 + l];
}

// A cooperative kernel's voxels: block b takes the contiguous chunk
// [c0, c1) of ceil(V / blocks) voxels (the same in every phase), its
// threads stride over the chunk by kThreads.
struct Chunk {
  long long c0, c1;
  __device__ Chunk(int V) {
    const long long C = (V + gridDim.x - 1) / gridDim.x;
    c0 = min(static_cast<long long>(blockIdx.x) * C, static_cast<long long>(V));
    c1 = min(c0 + C, static_cast<long long>(V));
  }
};

// State bytes of the sweeps: the value in bits 0-6, bit 7 set where the
// last sweep changed it (every bit set before the first sweep).  A sweep is
// a pure function of its inputs, so a voxel whose inputs all kept their
// value in the last sweep keeps its own: it skips the arithmetic (exact).
constexpr uint8_t kChanged = 0x80;

// Radial start and sign-consensus sweeps, a thread per voxel.  The vote of
// a sweep is sum_k dot3(n_k * s_k, n_i * s_i) in k order; IEEE rounding is
// symmetric, so each term is dot3(n_k, n_i) with its sign bit flipped where
// s_i != s_k, bit for bit (up to the sign of a zero, which no vote < 0
// decision sees): the dot products are computed once (+0 where invalid; in
// shared memory beside the cached rows, else in `dots`, (V, K) float32) and
// a sweep gathers one state byte a neighbour (bit 0: the sign is negative).
// A voxel's new sign depends on its own and its neighbours' signs only.
// sg0/sg1: (V,) state bytes (ping-pong); partials: 4 int64 (x, y, z,
// count) a block; changed: (iters,) int32 flags, zeroed here before the
// first barrier; centroid: 3 floats written for the caller's checks.
// Dynamic shared memory (k = 16): `rc` rows of 9 int4 words (the indices,
// the dot products, a pad) of the block's chunk.
template <int KT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
orient_kernel(const int32_t* __restrict__ pos, const float* __restrict__ normals,
              const int32_t* __restrict__ nn_idx, const uint8_t* __restrict__ nn_valid,
              const uint8_t* __restrict__ valid, int V, int K_, int iters, int rc,
              uint8_t* sg0, uint8_t* sg1, float* __restrict__ dots,
              long long* partials, int* changed, float* centroid,
              float* __restrict__ out) {
  constexpr int kW = 9;
  extern __shared__ int4 s_orow[];
  __shared__ long long s_part[kThreads / 32][4];
  __shared__ long long s_sum[4];
  cg::grid_group grid = cg::this_grid();
  const int K = kdim<KT>(K_);
  const Chunk ch(V);
  const int n = static_cast<int>(ch.c1 - ch.c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = min(n, rc);
  if constexpr (KT == 16) {
    cache_rows(s_orow, kW, nn_idx, nullptr, ch.c0, m);
    __syncthreads();
  }

  // 1. the centroid's exact integer sums (per warp, then per block into
  // `partials`), and the per-slot dot products
  if (blockIdx.x == 0 && threadIdx.x < iters) changed[threadIdx.x] = 0;
  long long acc[4] = {0, 0, 0, 0};
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const long long i = ch.c0 + l;
    if (valid[i]) {
      acc[0] += pos[3 * i];
      acc[1] += pos[3 * i + 1];
      acc[2] += pos[3 * i + 2];
      acc[3] += 1;
    }
    const float* ni = normals + 3 * i;
    if constexpr (KT == 16) {
      int4* row = s_orow + l * kW;
      Row16 w;
      unpack_idx(l < m ? row : reinterpret_cast<const int4*>(nn_idx) + i * 4, w.j);
      unpack_ok(reinterpret_cast<const int4*>(nn_valid)[i], w.ok);
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = w.ok[k] ? dot3(normals + 3 * static_cast<long long>(w.j[k]), ni) : 0.f;
      float4* dst = l < m ? reinterpret_cast<float4*>(row + 4)
                          : reinterpret_cast<float4*>(dots + i * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
    } else {
      for (int k = 0; k < K; ++k) {
        const long long e = i * K + k;
        dots[e] = nn_valid[e] ? dot3(normals + 3 * static_cast<long long>(nn_idx[e]), ni) : 0.f;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    for (int o = 16; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    if (lane == 0) s_part[warp][c] = acc[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long v = lane < kThreads / 32 ? s_part[lane][c] : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) partials[4 * blockIdx.x + c] = v;
    }
  }
  grid.sync();

  // 2. the radial sign about the centroid: each block sums the blocks'
  // partials (integers, any order)
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long v = 0;
      for (int b = lane; b < gridDim.x; b += 32) v += __ldcg(partials + 4 * b + c);
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) s_sum[c] = v;
    }
  }
  __syncthreads();
  const float cnt = __ll2float_rn(max(s_sum[3], 1LL));
  float cen[3];
  for (int c = 0; c < 3; ++c) cen[c] = __fdiv_rn(__ll2float_rn(s_sum[c]), cnt);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int c = 0; c < 3; ++c) centroid[c] = cen[c];
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const long long i = ch.c0 + l;
    const float o[3] = {sub(static_cast<float>(pos[3 * i]), cen[0]),
                        sub(static_cast<float>(pos[3 * i + 1]), cen[1]),
                        sub(static_cast<float>(pos[3 * i + 2]), cen[2])};
    sg0[i] = kChanged | (dot3(normals + 3 * i, o) < 0.f ? 1 : 0);
  }
  grid.sync();

  // 3. the sweeps
  const uint8_t* cur = sg0;
  for (int t = 0; t < iters; ++t) {
    const uint8_t* in = (t & 1) ? sg1 : sg0;
    uint8_t* nxt = (t & 1) ? sg0 : sg1;
    bool flip = false;
    for (int l = threadIdx.x; l < n; l += kThreads) {
      const long long i = ch.c0 + l;
      const unsigned si = in[i];
      unsigned any = si;
      float vote = 0.f;
      if constexpr (KT == 16) {
        const int4* row = s_orow + l * kW;
        int j[16];
        unpack_idx(l < m ? row : reinterpret_cast<const int4*>(nn_idx) + i * 4, j);
        uint8_t sk[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) sk[k] = in[j[k]];
#pragma unroll
        for (int k = 0; k < 16; ++k) any |= sk[k];
        if (any & kChanged) {
          float d[16];
          unpack_f(l < m ? row + 4 : reinterpret_cast<const int4*>(dots) + i * 4, d);
#pragma unroll
          for (int k = 0; k < 16; ++k)
            vote = add(vote, __int_as_float(__float_as_int(d[k]) ^ (((si ^ sk[k]) & 1u) << 31)));
        }
      } else {
        for (int k = 0; k < K; ++k) any |= in[nn_idx[i * K + k]];
        if (any & kChanged)
          for (int k = 0; k < K; ++k) {
            const unsigned sk = in[nn_idx[i * K + k]];
            vote = add(vote, __int_as_float(__float_as_int(dots[i * K + k]) ^ (((si ^ sk) & 1u) << 31)));
          }
      }
      const bool neg = vote < 0.f;   // no input changed: vote +0, the sign stays
      nxt[i] = static_cast<uint8_t>(neg ? (kChanged | ((si & 1u) ^ 1u)) : (si & 1u));
      flip |= neg;
    }
    if (__any_sync(0xffffffffu, flip) && lane == 0) changed[t] = 1;
    grid.sync();
    cur = nxt;
    if (__ldcg(changed + t) == 0) break;   // no sign moved: every later sweep is this one
  }
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const long long i = ch.c0 + l;
    const float s = (cur[i] & 1u) ? -1.f : 1.f;
    for (int c = 0; c < 3; ++c) out[3 * i + c] = mul(normals[3 * i + c], s);
  }
}

// the bytes of four words equal to the byte `b` (pattern b * 0x01010101):
// a zero byte of x = w ^ pattern has bit 7 clear in (x & 0x7f..) + 0x7f..
// and in x; counts are exact
__device__ __forceinline__ int count_bytes(const uint32_t* w, uint32_t pattern) {
  int n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t x = w[q] ^ pattern;
    n += __popc(~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu));
  }
  return n;
}

__device__ __forceinline__ int initial_arg(const float* nrm, const float* orients,
                                           const float* weights, int J) {
  // orientation 0 is unweighted (the reference's tie-break quirk,
  // segmentation.py:120-123)
  float best = dot3(nrm, orients);
  int arg = 0;
  for (int j = 1; j < J; ++j) {
    const float sc = mul(dot3(nrm, orients + 3 * j), weights[j]);
    if (sc > best) {
      best = sc;
      arg = j;
    }
  }
  return arg;
}

// The initial segmentation (part_in == nullptr; written to initial) or a
// given partition, then the refinement sweeps, a thread per voxel.  A
// voxel's new partition depends on its neighbours' partitions only.  p0/p1:
// (V,) state bytes (ping-pong); changed: (iters,) int32 flags, zeroed here
// before the first barrier.  Dynamic shared memory (k = 16): `rc` rows of
// 5 int4 words (the indices, the flags) of the block's chunk.
template <int KT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
partition_kernel(const float* __restrict__ normals, const float* __restrict__ orients,
                 const float* __restrict__ weights, const int32_t* __restrict__ nn_idx,
                 const uint8_t* __restrict__ nn_valid, int V, int K_, int J, float lambda,
                 int iters, int rc, const int32_t* __restrict__ part_in,
                 int32_t* __restrict__ initial, uint8_t* p0, uint8_t* p1, int* changed,
                 int32_t* __restrict__ refined) {
  constexpr int kW = 5;
  extern __shared__ int4 s_prow[];
  cg::grid_group grid = cg::this_grid();
  const int K = kdim<KT>(K_);
  const Chunk ch(V);
  const int n = static_cast<int>(ch.c1 - ch.c0);
  const int lane = threadIdx.x & 31;
  const int m = min(n, rc);
  if constexpr (KT == 16) cache_rows(s_prow, kW, nn_idx, nn_valid, ch.c0, m);

  if (blockIdx.x == 0 && threadIdx.x < iters) changed[threadIdx.x] = 0;
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const long long i = ch.c0 + l;
    int arg;
    if (part_in) {
      arg = part_in[i];
    } else {
      arg = initial_arg(normals + 3 * i, orients, weights, J);
      initial[i] = arg;
    }
    p0[i] = static_cast<uint8_t>(arg) | kChanged;
  }
  grid.sync();

  const uint8_t* cur = p0;
  for (int t = 0; t < iters; ++t) {
    const uint8_t* in = (t & 1) ? p1 : p0;
    uint8_t* nxt = (t & 1) ? p0 : p1;
    bool moved = false;
    for (int l = threadIdx.x; l < n; l += kThreads) {
      const long long i = ch.c0 + l;
      const int own = in[i] & ~kChanged;
      int arg = own;
      if constexpr (KT == 16) {
        const int4* row = s_prow + l * kW;
        int j[16];
        unpack_idx(l < m ? row : reinterpret_cast<const int4*>(nn_idx) + i * 4, j);
        const int4 f = l < m ? row[4] : reinterpret_cast<const int4*>(nn_valid)[i];
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = in[j[4 * q]] | (in[j[4 * q + 1]] << 8) | (in[j[4 * q + 2]] << 16)
                 | (static_cast<uint32_t>(in[j[4 * q + 3]]) << 24);
        if ((w[0] | w[1] | w[2] | w[3]) & 0x80808080u) {
          // invalid slots become 0xFF (flags are 0 or 1 a byte): no vote
          const uint32_t fl[4] = {static_cast<uint32_t>(f.x), static_cast<uint32_t>(f.y),
                                  static_cast<uint32_t>(f.z), static_cast<uint32_t>(f.w)};
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = (w[q] & 0x7F7F7F7Fu) | ((fl[q] * 0xFFu) ^ 0xFFFFFFFFu);
          const int nvalid = 16 - count_bytes(w, 0xFFFFFFFFu);
          const float lk = __fdiv_rn(lambda, static_cast<float>(max(nvalid, 1)));
          const float* nrm = normals + 3 * i;
          float best = 0.f;
          arg = 0;
#pragma unroll
          for (int jj = 0; jj < kMaxJ; ++jj) {
            if (jj >= J) break;
            const int votes = count_bytes(w, 0x01010101u * jj);
            const float sc = fma_(lk, static_cast<float>(votes), dot3(nrm, orients + 3 * jj));
            if (jj == 0 || sc > best) {
              best = sc;
              arg = jj;
            }
          }
        }
      } else {
        int any = 0;
        for (int k = 0; k < K; ++k) any |= in[nn_idx[i * K + k]];
        if (any & kChanged) {
          int nvalid = 0;
          for (int k = 0; k < K; ++k) nvalid += nn_valid[i * K + k] ? 1 : 0;
          const float lk = __fdiv_rn(lambda, static_cast<float>(max(nvalid, 1)));
          const float* nrm = normals + 3 * i;
          float best = 0.f;
          arg = 0;
          for (int jj = 0; jj < J; ++jj) {
            int votes = 0;
            for (int k = 0; k < K; ++k)
              votes += nn_valid[i * K + k] && (in[nn_idx[i * K + k]] & ~kChanged) == jj;
            const float sc = fma_(lk, static_cast<float>(votes), dot3(nrm, orients + 3 * jj));
            if (jj == 0 || sc > best) {
              best = sc;
              arg = jj;
            }
          }
        }
      }
      nxt[i] = static_cast<uint8_t>(arg) | (arg != own ? kChanged : 0);
      moved |= arg != own;
    }
    if (__any_sync(0xffffffffu, moved) && lane == 0) changed[t] = 1;
    grid.sync();
    cur = nxt;
    if (__ldcg(changed + t) == 0) break;   // no partition moved: every later sweep is this one
  }
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const long long i = ch.c0 + l;
    refined[i] = cur[i] & ~kChanged;
  }
}

__global__ void high_gradient_aux_kernel(const float* __restrict__ normals,
                                         const float* __restrict__ orients,
                                         const int32_t* __restrict__ part, int V, int J,
                                         int32_t* __restrict__ alt,
                                         uint8_t* __restrict__ weak) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const float* nrm = normals + 3 * static_cast<long long>(i);
  const int p = part[i];
  float best = 0.f, org = 0.f;
  int arg = 0;
  for (int j = 0; j < J; ++j) {
    const float sc = dot3(nrm, orients + 3 * j);
    float m = sc;
    if (j == p) {   // score - 1e9 * onehot: only the assigned column moves
      org = sc;
      m = sub(sc, 1e9f);
    }
    if (j == 0 || m > best) {
      best = m;
      arg = j;
    }
  }
  alt[i] = arg;
  weak[i] = org <= 0.577f ? 1 : 0;   // the float32 constant 0.577
}

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// Launch `kernel` cooperatively: kBlocksPerSm blocks of kThreads an SM (no
// more blocks than `max_blocks` or than V needs; fewer a SM where the shared
// memory does not allow them), each caching the k-NN rows of its chunk of
// voxels in shared memory (`row_bytes` a voxel, as many rows as fit; none
// where row_bytes is 0).  The kernel's argument `*rc` is set to the rows
// cached a block.
cudaError_t launch_cooperative(const void* kernel, int V, int max_blocks, size_t row_bytes,
                               int* rc, void** args, cudaStream_t stream) {
  static int sms = 0, optin = 0;
  cudaError_t err = cudaSuccess;
  if (!sms) {
    int device = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err != cudaSuccess) return err;
  }
  for (int per_sm = kBlocksPerSm; per_sm >= 1; --per_sm) {
    const long long blocks = std::max(1LL, std::min<long long>(
        {static_cast<long long>(sms) * per_sm, blocks_for(V, kThreads),
         static_cast<long long>(max_blocks)}));
    const long long chunk = (V + blocks - 1) / blocks;
    // a block's share of the SM's shared memory, less its static arrays
    const size_t spare = static_cast<size_t>(optin) / per_sm - 8192;
    *rc = row_bytes ? static_cast<int>(std::min<long long>(chunk, spare / row_bytes)) : 0;
    const size_t smem = row_bytes * *rc;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int fit = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (fit * sms >= blocks)
      return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                         dim3(kThreads), args, smem, stream);
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// pos (V, 3) int32, nn_idx (V, K) int32, nn_valid (V, K) bool -> normals
// (V, 3) float32.  One launch.
extern "C" int pca_normals(const int32_t* pos, const int32_t* nn_idx,
                           const uint8_t* nn_valid, int V, int K, float* normals,
                           void* stream) {
  if (V == 0) return 0;
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = static_cast<size_t>(32) * word_stride(K) * sizeof(float4);
  const int warps = static_cast<int>(std::max<size_t>(1, std::min<size_t>(4, 48 * 1024 / per_warp)));
  const size_t smem = per_warp * warps;
  const auto kernel = K == 16 ? pca_normals_kernel<16> : pca_normals_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks_for(V, 32 * warps), 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, nn_idx, nn_valid, V, K, normals);
  return static_cast<int>(cudaGetLastError());
}

// The vector rows of k = 16 (KT = 16) where the table is 16-byte aligned.
inline bool rows16(int K, const int32_t* nn_idx, const uint8_t* nn_valid) {
  return K == 16 && reinterpret_cast<uintptr_t>(nn_idx) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(nn_valid) % 16 == 0;
}

// Centroid of the valid rows, radial sign, `iters` consensus sweeps ->
// out (V, 3) float32 oriented normals.  signs (2 V int8), dots (V K
// float32, 16-byte aligned), partials (4 int64 a block, for `max_blocks`
// blocks: the launch uses no more), changed (iters int32) and centroid (3
// float32) are the caller's scratch.  One cooperative launch, nothing else
// on the stream.
extern "C" int orient_normals(const int32_t* pos, const float* normals, const int32_t* nn_idx,
                              const uint8_t* nn_valid, const uint8_t* valid, int V, int K,
                              int iters, uint8_t* signs, float* dots, long long* partials,
                              int max_blocks, int* changed, float* centroid, float* out,
                              void* stream) {
  if (V == 0) return 0;
  if (K < 1 || iters < 0 || iters > kThreads || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* sg0 = signs;
  uint8_t* sg1 = signs + V;
  int rc = 0;
  void* args[] = {&pos, &normals, &nn_idx, &nn_valid, &valid, &V, &K, &iters, &rc, &sg0, &sg1,
                  &dots, &partials, &changed, &centroid, &out};
  const bool r16 = rows16(K, nn_idx, nn_valid);
  const void* kernel = reinterpret_cast<const void*>(r16 ? orient_kernel<16> : orient_kernel<0>);
  return static_cast<int>(launch_cooperative(kernel, V, max_blocks, r16 ? 9 * sizeof(int4) : 0,
                                             &rc, args, static_cast<cudaStream_t>(stream)));
}

// The initial segmentation (part_in null: written to `initial`) or the
// partition `part_in`, then `iters` refinement sweeps -> refined (V,)
// int32.  scratch (2 V bytes) and changed (iters int32) are the caller's.
// With iters 0 the neighbour table is not read: K may be 0 and nn_idx,
// nn_valid null.  One cooperative launch, nothing else on the stream.
extern "C" int segment_partition(const float* normals, const float* orients,
                                 const float* weights, const int32_t* nn_idx,
                                 const uint8_t* nn_valid, int V, int K, int J, float lambda,
                                 int iters, const int32_t* part_in, int32_t* initial,
                                 uint8_t* scratch, int* changed, int32_t* refined,
                                 void* stream) {
  if (V == 0) return 0;
  if (K < (iters > 0 ? 1 : 0) || J < 1 || J > kMaxJ || iters < 0 || iters > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* p0 = scratch;
  uint8_t* p1 = scratch + V;
  int rc = 0;
  void* args[] = {&normals, &orients, &weights, &nn_idx, &nn_valid, &V, &K, &J, &lambda,
                  &iters, &rc, &part_in, &initial, &p0, &p1, &changed, &refined};
  const bool r16 = rows16(K, nn_idx, nn_valid);
  const void* kernel = reinterpret_cast<const void*>(r16 ? partition_kernel<16>
                                                         : partition_kernel<0>);
  return static_cast<int>(launch_cooperative(kernel, V, INT_MAX, r16 ? 5 * sizeof(int4) : 0,
                                             &rc, args, st));
}

// normals (V, 3), orients (J, 3) float32, part (V,) int32 -> alt (V,) int32,
// weak (V,) bool.  One launch.
extern "C" int high_gradient_aux(const float* normals, const float* orients,
                                 const int32_t* part, int V, int J, int32_t* alt,
                                 uint8_t* weak, void* stream) {
  if (V == 0) return 0;
  if (J < 1 || J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  high_gradient_aux_kernel<<<blocks_for(V, 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      normals, orients, part, V, J, alt, weak);
  return static_cast<int>(cudaGetLastError());
}
