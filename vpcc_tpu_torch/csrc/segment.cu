// Kernel F: normals and projection-plane segmentation (K10).
//
// Replaces the XLA programs vpcc_tpu/ops/normals.py `pca_normals` (:72-91)
// with `_smallest_eigenvector_sym3` (:27-68), `orient_normals` (:95-119),
// and vpcc_tpu/ops/segmentation.py `initial_segmentation` (:113-124) and
// `refine_segmentation` (:146-169), and `high_gradient_aux` (:128-143).  Six
// entry points, one thread per voxel each:
//   pca_normals     gather the k neighbours, mean, 3x3 covariance, closed-form
//                   smallest eigenvector (one launch);
//   orient_init     radial sign from the centroid (one launch);
//   orient_step     one sign-consensus sweep (launched 8 times, ping-pong);
//   initial_segmentation  argmax over the J orientations (one launch);
//   refine_step     one smoothness sweep (launched 10 times, ping-pong);
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
// Bound: bytes.  Each launch reads the neighbour table (V x k int32 + bool)
// and gathers per-neighbour rows (positions, normals, signs or partitions)
// that mostly hit L2; a few hundred flops per voxel are far below the
// card's float32 rate.  The refine votes live in registers (J <= 18).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxJ = 18;

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

__global__ void pca_normals_kernel(const int32_t* __restrict__ pos,
                                   const int32_t* __restrict__ nn_idx,
                                   const uint8_t* __restrict__ nn_valid, int V,
                                   int K, float* __restrict__ normals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const int32_t* idx = nn_idx + static_cast<long long>(i) * K;
  const uint8_t* val = nn_valid + static_cast<long long>(i) * K;
  float cnt = 0.f, sum[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float w = val[k] ? 1.f : 0.f;
    cnt = add(cnt, w);
    for (int c = 0; c < 3; ++c)
      sum[c] = add(sum[c], mul(static_cast<float>(pos[3 * idx[k] + c]), w));
  }
  cnt = fmaxf(cnt, 1.f);
  float mean[3];
  for (int c = 0; c < 3; ++c) mean[c] = __fdiv_rn(sum[c], cnt);
  float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float w = val[k] ? 1.f : 0.f;
    float d[3];
    for (int c = 0; c < 3; ++c)
      d[c] = mul(sub(static_cast<float>(pos[3 * idx[k] + c]), mean[c]), w);
    c00 = fma_(d[0], d[0], c00);
    c01 = fma_(d[0], d[1], c01);
    c02 = fma_(d[0], d[2], c02);
    c11 = fma_(d[1], d[1], c11);
    c12 = fma_(d[1], d[2], c12);
    c22 = fma_(d[2], d[2], c22);
  }
  // closed-form smallest eigenvector (reference _smallest_eigenvector_sym3);
  // XLA rewrites x / 3 and x / 6 as products with the float32 reciprocals
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
  for (int t = 0; t < 3; ++t) {
    const float* a = rows[t][0];
    const float* b = rows[t][1];
    v[t][0] = msub(a[1], b[2], a[2], b[1]);
    v[t][1] = msub(a[2], b[0], a[0], b[2]);
    v[t][2] = msub(a[0], b[1], a[1], b[0]);
    n[t] = dot3(v[t], v[t]);
  }
  const int best01 = n[0] >= n[1] ? 0 : 1;
  const float nb = fmaxf(n[0], n[1]);
  const int best = nb >= n[2] ? best01 : 2;
  const float vn = fmaxf(__fsqrt_rn(fmaxf(nb, n[2])), 1e-20f);
  float* out = normals + 3 * static_cast<long long>(i);
  if (p2 < 1e-12f) {  // isotropic: any unit vector
    out[0] = 0.f;
    out[1] = 0.f;
    out[2] = 1.f;
  } else {
    for (int c = 0; c < 3; ++c) out[c] = __fdiv_rn(v[best][c], vn);
  }
}

__global__ void orient_init_kernel(const int32_t* __restrict__ pos,
                                   const float* __restrict__ normals, int V,
                                   float cx, float cy, float cz,
                                   float* __restrict__ sign) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const float o[3] = {sub(static_cast<float>(pos[3 * i]), cx),
                      sub(static_cast<float>(pos[3 * i + 1]), cy),
                      sub(static_cast<float>(pos[3 * i + 2]), cz)};
  sign[i] = dot3(normals + 3 * static_cast<long long>(i), o) < 0.f ? -1.f : 1.f;
}

__global__ void orient_step_kernel(const float* __restrict__ normals,
                                   const int32_t* __restrict__ nn_idx,
                                   const uint8_t* __restrict__ nn_valid, int V,
                                   int K, const float* __restrict__ sign_in,
                                   float* __restrict__ sign_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const float si = sign_in[i];
  const float b[3] = {mul(normals[3 * i], si), mul(normals[3 * i + 1], si),
                      mul(normals[3 * i + 2], si)};
  float vote = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(i) * K + k;
    if (!nn_valid[e]) continue;
    const int j = nn_idx[e];
    const float sj = sign_in[j];
    const float a[3] = {mul(normals[3 * j], sj), mul(normals[3 * j + 1], sj),
                        mul(normals[3 * j + 2], sj)};
    vote = add(vote, dot3(a, b));
  }
  sign_out[i] = vote < 0.f ? -si : si;
}

__global__ void initial_segmentation_kernel(const float* __restrict__ normals,
                                            const float* __restrict__ orients,
                                            const float* __restrict__ weights,
                                            int V, int J,
                                            int32_t* __restrict__ part) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const float* nrm = normals + 3 * static_cast<long long>(i);
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
  part[i] = arg;
}

__global__ void refine_step_kernel(const float* __restrict__ normals,
                                   const int32_t* __restrict__ nn_idx,
                                   const uint8_t* __restrict__ nn_valid, int V,
                                   int K, const float* __restrict__ orients, int J,
                                   float lambda, const int32_t* __restrict__ part_in,
                                   int32_t* __restrict__ part_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  int votes[kMaxJ];
  for (int j = 0; j < kMaxJ; ++j) votes[j] = 0;
  int nvalid = 0;
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(i) * K + k;
    if (!nn_valid[e]) continue;
    ++nvalid;
    const int pj = part_in[nn_idx[e]];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) votes[j] += (pj == j);
  }
  const float lk = __fdiv_rn(lambda, static_cast<float>(max(nvalid, 1)));
  const float* nrm = normals + 3 * static_cast<long long>(i);
  float best = 0.f;
  int arg = 0;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j >= J) break;
    const float sc = fma_(lk, static_cast<float>(votes[j]), dot3(nrm, orients + 3 * j));
    if (j == 0 || sc > best) {
      best = sc;
      arg = j;
    }
  }
  part_out[i] = arg;
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

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// pos (V, 3) int32, nn_idx (V, K) int32, nn_valid (V, K) bool -> normals
// (V, 3) float32.  One launch.
extern "C" int pca_normals(const int32_t* pos, const int32_t* nn_idx,
                           const uint8_t* nn_valid, int V, int K, float* normals,
                           void* stream) {
  if (V == 0) return 0;
  pca_normals_kernel<<<blocks_for(V, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, nn_idx, nn_valid, V, K, normals);
  return static_cast<int>(cudaGetLastError());
}

// Radial sign per voxel from the centroid (cx, cy, cz).  One launch.
extern "C" int orient_init(const int32_t* pos, const float* normals, int V,
                           float cx, float cy, float cz, float* sign,
                           void* stream) {
  if (V == 0) return 0;
  orient_init_kernel<<<blocks_for(V, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, normals, V, cx, cy, cz, sign);
  return static_cast<int>(cudaGetLastError());
}

// One consensus sweep sign_in -> sign_out.  One launch.
extern "C" int orient_step(const float* normals, const int32_t* nn_idx,
                           const uint8_t* nn_valid, int V, int K,
                           const float* sign_in, float* sign_out, void* stream) {
  if (V == 0) return 0;
  orient_step_kernel<<<blocks_for(V, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      normals, nn_idx, nn_valid, V, K, sign_in, sign_out);
  return static_cast<int>(cudaGetLastError());
}

// orients (J, 3), weights (J,) float32 -> part (V,) int32.  One launch.
extern "C" int initial_segmentation(const float* normals, const float* orients,
                                    const float* weights, int V, int J,
                                    int32_t* part, void* stream) {
  if (V == 0) return 0;
  if (J < 1 || J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  initial_segmentation_kernel<<<blocks_for(V, 256), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      normals, orients, weights, V, J, part);
  return static_cast<int>(cudaGetLastError());
}

// One refinement sweep part_in -> part_out.  One launch.
extern "C" int refine_step(const float* normals, const int32_t* nn_idx,
                           const uint8_t* nn_valid, int V, int K,
                           const float* orients, int J, float lambda,
                           const int32_t* part_in, int32_t* part_out,
                           void* stream) {
  if (V == 0) return 0;
  if (J < 1 || J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  refine_step_kernel<<<blocks_for(V, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      normals, nn_idx, nn_valid, V, K, orients, J, lambda, part_in, part_out);
  return static_cast<int>(cudaGetLastError());
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
