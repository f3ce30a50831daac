// Kernel R: the per-point error reduction of one direction of the quality
// metrics (D1, D2, color PSNR).
//
// Replaces the XLA device work of vpcc_tpu/ops/metrics.py `_directional`
// (:57) inside `compute_metrics` (:147): for every A row below cnt_a, with
// B gathered at its nearest index (kernel E, plus the host KD search for
// the rows it missed):
//   d2                                 -> int64 maximum (Hausdorff)
//   proj = (e0 n0 + e1 n1) + e2 n2, e = float(a - b), n = n_b   -> sum proj^2
//   (yuv(a) - yuv(b))^2 per channel, BT.709 in [0, 1]            -> 3 sums
// with yuv: y = ((0.2126 r + 0.7152 g) + 0.0722 b) / 255,
//           u = ((-0.1146 r - 0.3854 g) + 0.5 b) / 255 + 0.5,
//           v = ((0.5 r - 0.4542 g) - 0.0458 b) / 255 + 0.5.
// The reference runs `_directional` op by op, so each float32 operation
// rounds on its own (no fused multiply-adds, true divisions): this file is
// compiled with --fmad=false and spells every operation with its _rn
// intrinsic.  The point-to-plane and color sums are float64 here.  The D1
// sum is the reference's float32 sum in XLA's CPU order (`metrics_d2_f32`,
// below), which rounds once the sum passes 2^24.
//
// Design.  Pass 1: a fixed grid of at most 1024 blocks of 256 threads; each
// thread walks its rows in grid-stride order and keeps its sums in
// registers, then the block reduces them in shared memory along a fixed
// tree and writes one partial per block.  Pass 2: one block of 512
// threads (two partials each) reduces the partials along a fixed tree.  No
// float atomics: repeated runs give the same bits.
//
// Bound: bytes.  Per A row: position (12 B), color (3), nearest index and
// d2 (8), and the gathered B position (12), color (3) and normal (12):
// ~50 B a row, ~30 MB for a bench frame's 607k rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 512;
constexpr int kMaxBlocks = 2 * kReduceThreads;

struct Sums {
  long long dmax;
  double f[4];  // c2p, y, u, v
};

__device__ __forceinline__ void yuv(const uint8_t* c, float* out) {
  const float r = static_cast<float>(c[0]);
  const float g = static_cast<float>(c[1]);
  const float b = static_cast<float>(c[2]);
  out[0] = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                               __fmul_rn(0.0722f, b)), 255.0f);
  out[1] = __fadd_rn(
      __fdiv_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.1146f, r), __fmul_rn(0.3854f, g)),
                          __fmul_rn(0.5f, b)), 255.0f), 0.5f);
  out[2] = __fadd_rn(
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.4542f, g)),
                          __fmul_rn(0.0458f, b)), 255.0f), 0.5f);
}

__device__ void block_reduce(Sums& s, Sums* sh) {
  const int t = threadIdx.x;
  sh[t] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (t < h) {
      Sums& a = sh[t];
      const Sums& b = sh[t + h];
      a.dmax = a.dmax > b.dmax ? a.dmax : b.dmax;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.f[k] += b.f[k];
    }
    __syncthreads();
  }
}

__global__ void rows_kernel(const int32_t* __restrict__ pos_a, const uint8_t* __restrict__ col_a,
                            const int32_t* __restrict__ pos_b, const uint8_t* __restrict__ col_b,
                            const float* __restrict__ nrm_b, const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ d2, int n,
                            long long* __restrict__ part_i, double* __restrict__ part_f) {
  __shared__ Sums sh[kThreads];
  Sums s = {0, {0.0, 0.0, 0.0, 0.0}};
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int j = idx[i];
    const long long dd = d2[i];
    s.dmax = s.dmax > dd ? s.dmax : dd;
    if (nrm_b != nullptr) {
      float p = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float e = static_cast<float>(pos_a[3 * i + a] - pos_b[3 * j + a]);
        const float m = __fmul_rn(e, nrm_b[3 * j + a]);
        p = a == 0 ? m : __fadd_rn(p, m);
      }
      s.f[0] += static_cast<double>(__fmul_rn(p, p));
    }
    if (col_a != nullptr) {
      float ya[3], yb[3];
      yuv(col_a + 3 * static_cast<int64_t>(i), ya);
      yuv(col_b + 3 * static_cast<int64_t>(j), yb);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float e = __fsub_rn(ya[c], yb[c]);
        s.f[1 + c] += static_cast<double>(__fmul_rn(e, e));
      }
    }
  }
  block_reduce(s, sh);
  if (threadIdx.x == 0) {
    part_i[blockIdx.x] = sh[0].dmax;
#pragma unroll
    for (int k = 0; k < 4; ++k) part_f[4 * blockIdx.x + k] = sh[0].f[k];
  }
}

__global__ void partials_kernel(const long long* __restrict__ part_i,
                                const double* __restrict__ part_f, int blocks,
                                long long* __restrict__ out_i, double* __restrict__ out_f) {
  __shared__ Sums sh[kReduceThreads];
  Sums s = {0, {0.0, 0.0, 0.0, 0.0}};
  // thread t takes partials t and t + 512, in that order
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) {
    const long long dm = part_i[b];
    s.dmax = s.dmax > dm ? s.dmax : dm;
#pragma unroll
    for (int k = 0; k < 4; ++k) s.f[k] += part_f[4 * b + k];
  }
  block_reduce(s, sh);
  if (threadIdx.x == 0) {
    out_i[0] = sh[0].dmax;
#pragma unroll
    for (int k = 0; k < 4; ++k) out_f[k] = sh[0].f[k];
  }
}

// One level of XLA's CPU tree reduction of a float32 vector of `m`
// elements: out[i] = the sequential sum, from 0, of elements i*w .. i*w+w-1.
// Level 0 reads the int32 d2 rows (those at or past n are the reference's
// zero-weight pad rows), the others the previous level's partial sums.
__global__ void tree_level_kernel(const int32_t* __restrict__ d2, int n,
                                  const float* __restrict__ in, int m, int w,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m / w) return;
  float s = 0.0f;
  for (int j = i * w; j < i * w + w; ++j)
    s = __fadd_rn(s, in != nullptr ? in[j] : (j < n ? static_cast<float>(d2[j]) : 0.0f));
  out[i] = s;
}

}  // namespace

// The float32 sum of the d2 rows as the reference's eager `jnp.sum` computes
// it on XLA's CPU backend over its shape-bucket length `cap` (rows at or past
// n are its zero-weight pad rows).  XLA rewrites the reduce into windows:
// while more than 32 elements remain, each window of w consecutive elements
// (w = 32 when 32 divides the length, else its largest divisor <= 32) is
// summed sequentially from 0; the last <= 32 are summed sequentially.  This
// order was found by probing the compiled reduce with crafted inputs and
// agrees bit for bit on random vectors at every bucket length from 8192 to
// 2^24 (tests/test_torch_metrics.py).  Scratch holds the partial sums of
// every level but the last (fewer than cap floats); one launch per level,
// counted in *launched.
extern "C" int metrics_d2_f32(const void* d2, int n, int cap, void* scratch, void* out,
                              int* launched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* d = static_cast<const int32_t*>(d2);
  float* buf = static_cast<float*>(scratch);
  const float* in = nullptr;
  int m = cap;
  *launched = 0;
  while (true) {
    int w = m;
    if (m > 32) {
      w = 32;
      while (m % w) --w;
      if (w < 2) return static_cast<int>(cudaErrorInvalidValue);
    }
    float* dst = m > 32 ? buf : static_cast<float*>(out);
    const int mo = m / w;
    tree_level_kernel<<<(mo + kThreads - 1) / kThreads, kThreads, 0, s>>>(d, n, in, m, w, dst);
    ++*launched;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || m <= 32) return static_cast<int>(err);
    in = dst;
    buf += mo;
    m = mo;
  }
}

// col_a / col_b null: no color sums; nrm_b null: no point-to-plane sum.
// `blocks` (1..1024) partials of scratch: part_i (blocks,) int64,
// part_f (blocks, 4) float64.  Out: dmax (the maximum d2), fsums [c2p, y,
// u, v].  Two launches.
extern "C" int metrics_reduce(const void* pos_a, const void* col_a, const void* pos_b,
                              const void* col_b, const void* nrm_b, const void* idx,
                              const void* d2, int n, int blocks, void* part_i, void* part_f,
                              void* dmax, void* fsums, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(pos_a), static_cast<const uint8_t*>(col_a),
      static_cast<const int32_t*>(pos_b), static_cast<const uint8_t*>(col_b),
      static_cast<const float*>(nrm_b), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(d2), n, static_cast<long long*>(part_i),
      static_cast<double*>(part_f));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const long long*>(part_i), static_cast<const double*>(part_f), blocks,
      static_cast<long long*>(dmax), static_cast<double*>(fsums));
  return static_cast<int>(cudaGetLastError());
}
