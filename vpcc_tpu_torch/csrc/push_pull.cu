// Kernel L: push-pull background fill of a stack of video planes, rounded
// to int32, and the push alone over a stack of planes.
//
// Replaces the XLA program vpcc_tpu/ops/padding.py `push_pull_fill`
// (padding.py:23) as vpcc_tpu/video/hevc.py `_round_int_plane` (hevc.py:1380)
// runs it on every geometry plane (vmapped over the planes of one call, each
// under its own occupancy in the level-batched GOF path): unoccupied pixels
// take a mip-pyramid interpolation of the occupied ones, then the plane is
// rounded half to even.  The second entry, `push_levels`, builds the value
// and weight pyramids of `harmonic_fill` (padding.py:109, levels while both
// sides exceed 2) and of `smooth_fill`'s push-pull (:58, sides above 1) for a
// (C, H, W) stack under one occupancy; kernel W (bg_fill.cu) pulls them.
//
// Design.  One launch per pyramid level, a grid row (blockIdx.y) per plane.
// Push (levels 1..L): each thread makes one coarse pixel's value and weight
// sums from its 2x2 children (0,0), (0,1), (1,0), (1,1) = a, b, c, d in the
// order XLA's CPU program uses at that level: ((a + b) + c) + d, or
// (a + b) + (c + d) where bit l-1 of `pair_mask` is set (the caller's table,
// data/push_order_xla.json); level 0 reads the image and occupancy directly
// (value = image * occupancy).  At the levels whose order the caller does
// not know (bit l-1 of `count_mask`) each value sum that reaches 2^24 (where
// the orders can differ) adds one to a device counter.  Pull (levels
// L..0): a pixel with weight takes value / weight, one without its parent's
// fill; the coarsest level has no parent.  The level-0 pull writes the
// result: the image where occupied, else the fill, rounded half to even
// (rintf) to int32.  Float operations are single IEEE roundings (built with
// --fmad=false), as the plain version computes them.
//
// push_levels: one launch per level, a thread per (coarse pixel, plane),
// summed ((a + b) + c) + d (the harmonic fill's order was not probed), value
// sums reaching 2^24 counted; the plane-0 threads also write the weight
// sums, which the stack shares.
//
// Bound: bytes.  The level-0 passes read the image and occupancy and write
// the output; the coarser levels add a third as much again.  At 1280 x 1280
// the 17 short launches (8 push, 9 pull) are latency, not bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;

constexpr float kExactLimit = 16777216.0f;  // 2^24

__device__ __forceinline__ float sum4(float a, float b, float c, float d, bool pair) {
  return pair ? __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d))
              : __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ void count_inexact(float v, int* inexact) {
  if (inexact != nullptr && v >= kExactLimit) atomicAdd(inexact, 1);
}

// plane p = blockIdx.y; occ_planar: the occupancy has a plane of its own
__global__ void push_level0(const int32_t* img, const uint8_t* occ, int occ_planar,
                            float* v1, float* w1, int H, int W, int pair, int* inexact) {
  const int h = H / 2, w = W / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const size_t plane = blockIdx.y;
  img += plane * H * W;
  occ += occ_planar ? plane * H * W : 0;
  const int y = 2 * (i / w), x = 2 * (i % w);
  float a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = (y + (k >> 1)) * W + x + (k & 1);
    const float o = static_cast<float>(occ[p]);
    a[k] = __fmul_rn(static_cast<float>(img[p]), o);
    b[k] = o;
  }
  const float v = sum4(a[0], a[1], a[2], a[3], pair);
  v1[plane * h * w + i] = v;
  w1[plane * h * w + i] = sum4(b[0], b[1], b[2], b[3], pair);
  count_inexact(v, inexact);
}

__global__ void push_level(const float* v0, const float* w0, float* v1, float* w1,
                           int H, int W, int pair, int* inexact) {
  const int h = H / 2, w = W / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const size_t plane = blockIdx.y;
  v0 += plane * H * W;
  w0 += plane * H * W;
  const int y = 2 * (i / w), x = 2 * (i % w);
  const int p = y * W + x;
  const float v = sum4(v0[p], v0[p + 1], v0[p + W], v0[p + W + 1], pair);
  v1[plane * h * w + i] = v;
  w1[plane * h * w + i] = sum4(w0[p], w0[p + 1], w0[p + W], w0[p + W + 1], pair);
  count_inexact(v, inexact);
}

// fill of one level >= 1 from its sums and its parent's fill (none at the top)
__global__ void pull_level(const float* v, const float* wt, const float* parent,
                           float* fill, int H, int W, int top) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const size_t plane = blockIdx.y;
  v += plane * H * W;
  wt += plane * H * W;
  fill += plane * H * W;
  const float avg = __fdiv_rn(v[i], fmaxf(wt[i], 1.0f));
  if (top || wt[i] > 0.0f) {
    fill[i] = avg;
  } else {
    const int y = i / W, x = i % W;
    fill[i] = parent[plane * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
}

__global__ void pull_level0(const int32_t* img, const uint8_t* occ, int occ_planar,
                            const float* parent, int32_t* out, int H, int W, int top) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const size_t plane = blockIdx.y;
  img += plane * H * W;
  out += plane * H * W;
  occ += occ_planar ? plane * H * W : 0;
  const float o = static_cast<float>(occ[i]);
  float r;
  if (o > 0.0f) {
    r = static_cast<float>(img[i]);
  } else if (top) {
    r = 0.0f;  // a single-level plane with no occupied pixel: 0 / max(0, 1)
  } else {
    const int y = i / W, x = i % W;
    r = parent[plane * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
  out[i] = static_cast<int32_t>(rintf(r));
}

__global__ void push_stack0(const int32_t* img, const uint8_t* occ, float* v1, float* w1,
                            int H, int W, int* inexact) {
  const int h = H / 2, w = W / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int c = blockIdx.y;
  const int32_t* im = img + static_cast<size_t>(c) * H * W;
  const int y = 2 * (i / w), x = 2 * (i % w);
  float a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = (y + (k >> 1)) * W + x + (k & 1);
    const float o = static_cast<float>(occ[p]);
    a[k] = __fmul_rn(static_cast<float>(im[p]), o);
    b[k] = o;
  }
  const float v = sum4(a[0], a[1], a[2], a[3], false);
  v1[static_cast<size_t>(c) * h * w + i] = v;
  count_inexact(v, inexact);
  if (c == 0) w1[i] = sum4(b[0], b[1], b[2], b[3], false);
}

__global__ void push_stack(const float* v0, const float* w0, float* v1, float* w1, int H,
                           int W, int* inexact) {
  const int h = H / 2, w = W / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int c = blockIdx.y;
  const int y = 2 * (i / w), x = 2 * (i % w);
  const int p = y * W + x;
  const float* v = v0 + static_cast<size_t>(c) * H * W;
  const float sv = sum4(v[p], v[p + 1], v[p + W], v[p + W + 1], false);
  v1[static_cast<size_t>(c) * h * w + i] = sv;
  count_inexact(sv, inexact);
  if (c == 0) w1[i] = sum4(w0[p], w0[p + 1], w0[p + W], w0[p + W + 1], false);
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// img/out: (P, H, W) int32; occ: (P, H, W) uint8 when occ_planar, else one
// (H, W) plane for all; scratch: float32, at least P * 3 * the sum of the
// level sizes (vpcc_tpu_torch/ops/padding.py scratch_floats).  Bit l-1 of
// pair_mask: level l sums (a + b) + (c + d).  inexact: device int32 counter
// of the value sums reaching 2^24 at the levels of count_mask (null when
// count_mask is 0).  *launched (host memory) receives the number of grids
// launched.
extern "C" int push_pull(const int32_t* img, const uint8_t* occ, float* scratch,
                         int32_t* out, int P, int occ_planar, int H, int W,
                         int pair_mask, int count_mask, int* inexact, void* stream,
                         int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (P <= 0 || P > 65535) return P == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  int hs[kMaxLevels], ws[kMaxLevels];
  int L = 0;
  hs[0] = H;
  ws[0] = W;
  while (hs[L] > 1 && ws[L] > 1 && hs[L] % 2 == 0 && ws[L] % 2 == 0 &&
         L + 1 < kMaxLevels) {
    hs[L + 1] = hs[L] / 2;
    ws[L + 1] = ws[L] / 2;
    ++L;
  }
  // per level l >= 1: value, weight and fill planes of every plane
  float* val[kMaxLevels];
  float* wgt[kMaxLevels];
  float* fil[kMaxLevels];
  float* p = scratch;
  for (int l = 1; l <= L; ++l) {
    const size_t n = static_cast<size_t>(hs[l]) * ws[l] * P;
    val[l] = p;
    wgt[l] = p + n;
    fil[l] = p + 2 * n;
    p += 3 * n;
  }
  const int T = 256;
  for (int l = 1; l <= L; ++l) {
    const long long n = static_cast<long long>(hs[l]) * ws[l];
    const dim3 grid(blocks_for(n, T), P);
    const int pair = (pair_mask >> (l - 1)) & 1;
    int* cnt = ((count_mask >> (l - 1)) & 1) ? inexact : nullptr;
    if (l == 1) {
      push_level0<<<grid, T, 0, st>>>(img, occ, occ_planar, val[1], wgt[1], H, W, pair, cnt);
    } else {
      push_level<<<grid, T, 0, st>>>(val[l - 1], wgt[l - 1], val[l], wgt[l], hs[l - 1],
                                     ws[l - 1], pair, cnt);
    }
    ++*launched;
  }
  for (int l = L; l >= 1; --l) {
    const long long n = static_cast<long long>(hs[l]) * ws[l];
    pull_level<<<dim3(blocks_for(n, T), P), T, 0, st>>>(
        val[l], wgt[l], l < L ? fil[l + 1] : nullptr, fil[l], hs[l], ws[l], l == L);
    ++*launched;
  }
  pull_level0<<<dim3(blocks_for(static_cast<long long>(H) * W, T), P), T, 0, st>>>(
      img, occ, occ_planar, L >= 1 ? fil[1] : nullptr, out, H, W, L == 0);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// img: (C, H, W) int32; occ: (H, W) uint8.  Levels l = 1..L while both sides
// of level l-1 are even and above min_side; vals receives (C, h_l, w_l) per
// level and wts (h_l, w_l) per level, each level after the previous one
// (vpcc_tpu_torch/ops/padding.py push_levels); inexact: device int32 counter
// of value sums reaching 2^24.
extern "C" int push_levels(const int32_t* img, const uint8_t* occ, float* vals, float* wts,
                           int C, int H, int W, int min_side, int* inexact, void* stream,
                           int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = 256;
  *launched = 0;
  int h = H, w = W;
  const float* pv = nullptr;
  const float* pw = nullptr;
  int ph = H, pw_ = W;
  while (h > min_side && w > min_side && h % 2 == 0 && w % 2 == 0) {
    h /= 2;
    w /= 2;
    const long long n = static_cast<long long>(h) * w;
    const dim3 grid(blocks_for(n, T), C);
    if (pv == nullptr) {
      push_stack0<<<grid, T, 0, st>>>(img, occ, vals, wts, ph, pw_, inexact);
    } else {
      push_stack<<<grid, T, 0, st>>>(pv, pw, vals, wts, ph, pw_, inexact);
    }
    ++*launched;
    pv = vals;
    pw = wts;
    vals += static_cast<size_t>(C) * n;
    wts += n;
    ph = h;
    pw_ = w;
  }
  return static_cast<int>(cudaGetLastError());
}
