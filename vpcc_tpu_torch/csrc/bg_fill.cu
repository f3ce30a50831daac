// Kernel W: the dilation, harmonic and smoothed background fills of a stack
// of attribute planes that share one occupancy.
//
// Replaces the XLA programs vpcc_tpu/ops/padding.py `dilate_fill`
// (padding.py:78), `harmonic_fill` (:109; its pyramid comes from kernel L's
// `push_levels`) and `smooth_fill` (:58), as `fill_rgb` (:176) runs them on
// the attribute images under attributeBGFill 0 and 2.  Every stencil wraps
// around the plane, as the reference's jnp.roll.  Entry points:
// * bg_dilate: `count` synchronous dilation passes.  pass_of (H, W) holds the
//   pass that filled each pixel (0 occupied, INT_MAX empty); pass k reads only
//   neighbours with pass_of < k, so it runs in place and still sees the state
//   before the pass.  An empty pixel with a filled 4-neighbour takes
//   rint(vsum / max(wsum, 1)), vsum = ((up + down) + left) + right over the
//   filled neighbours' values, wsum their count; one thread per pixel handles
//   every plane.  A pass that fills a pixel sets flags[k]; the host stops after
//   a pass that filled nothing (later passes would change nothing).  With
//   first == 0 an initial launch sets x = image * occupancy and pass_of.
// * bg_pull: one pyramid level of the pull: (top || weight > 0) ? value /
//   max(weight, 1) : the parent's fill; level 0 reads the image and the
//   occupancy (value = image * occupancy, weight = occupancy).
// * bg_relax: n Jacobi steps, ((up + down) + left) + right times 0.25, the
//   pixels whose mask (the level's weight, or the occupancy) is above 0 held
//   at their value; ping-pong between x and tmp, the result in x.
// * bg_finish: the occupied pixels take the image; optionally the planes are
//   rounded half to even and clipped into an int32 output.
// Float operations are single IEEE roundings (built with --fmad=false), in the
// order of the reference's XLA CPU program.
//
// Bound: bytes.  A dilation pass reads pass_of and the filled neighbours'
// values and writes the pixels it fills; a relaxation step reads and writes
// each plane once.  At 1280 x 1280 each launch is a few microseconds of
// latency: the dilation's ~hundreds of passes and the harmonic fill's 9
// levels x 9 launches are launch-bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = INT_MAX;

__global__ void dilate_init(const int32_t* img, const uint8_t* occ, float* x,
                            int32_t* pass_of, int C, int64_t hw) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const float o = occ[p] != 0 ? 1.0f : 0.0f;
  pass_of[p] = occ[p] != 0 ? 0 : kEmpty;
  for (int c = 0; c < C; ++c)
    x[c * hw + p] = __fmul_rn(static_cast<float>(img[c * hw + p]), o);
}

__global__ void dilate_pass(float* x, int32_t* pass_of, int C, int H, int W, int k,
                            int32_t* flag) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw || pass_of[p] != kEmpty) return;
  const int y = static_cast<int>(p / W), xx = static_cast<int>(p % W);
  const int64_t nb[4] = {
      static_cast<int64_t>(y == 0 ? H - 1 : y - 1) * W + xx,   // up (roll +1 on rows)
      static_cast<int64_t>(y == H - 1 ? 0 : y + 1) * W + xx,   // down
      static_cast<int64_t>(y) * W + (xx == 0 ? W - 1 : xx - 1),  // left
      static_cast<int64_t>(y) * W + (xx == W - 1 ? 0 : xx + 1),  // right
  };
  bool f[4];
  float wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = pass_of[nb[j]] < k;
    wsum = j == 0 ? (f[0] ? 1.0f : 0.0f) : __fadd_rn(wsum, f[j] ? 1.0f : 0.0f);
  }
  if (!(wsum > 0.0f)) return;
  const float den = fmaxf(wsum, 1.0f);
  for (int c = 0; c < C; ++c) {
    const float* xc = x + c * hw;
    float v = f[0] ? xc[nb[0]] : 0.0f;
#pragma unroll
    for (int j = 1; j < 4; ++j) v = __fadd_rn(v, f[j] ? xc[nb[j]] : 0.0f);
    x[c * hw + p] = rintf(__fdiv_rn(v, den));
  }
  pass_of[p] = k;
  flag[k] = 1;
}

__global__ void pull_top_or_level(const float* v, const float* wt, const float* parent,
                                  float* fill, int H, int W, int top) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int c = blockIdx.y;
  const float w = wt[i];
  float r;
  if (top || w > 0.0f) {
    r = __fdiv_rn(v[c * hw + i], fmaxf(w, 1.0f));
  } else {
    const int y = static_cast<int>(i / W), x = static_cast<int>(i % W);
    r = parent[static_cast<int64_t>(c) * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
  fill[c * hw + i] = r;
}

__global__ void pull_level0(const int32_t* img, const uint8_t* occ, const float* parent,
                            float* fill, int H, int W, int top) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int c = blockIdx.y;
  const float o = static_cast<float>(occ[i]);
  float r;
  if (top || o > 0.0f) {
    r = __fdiv_rn(__fmul_rn(static_cast<float>(img[c * hw + i]), o), fmaxf(o, 1.0f));
  } else {
    const int y = static_cast<int>(i / W), x = static_cast<int>(i % W);
    r = parent[static_cast<int64_t>(c) * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
  fill[c * hw + i] = r;
}

template <typename M>
__global__ void relax_step(const float* xin, float* xout, const M* mask, int H, int W) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int c = blockIdx.y;
  const float* a = xin + c * hw;
  float r;
  if (mask[p] > 0) {
    r = a[p];
  } else {
    const int y = static_cast<int>(p / W), x = static_cast<int>(p % W);
    const float up = a[static_cast<int64_t>(y == 0 ? H - 1 : y - 1) * W + x];
    const float dn = a[static_cast<int64_t>(y == H - 1 ? 0 : y + 1) * W + x];
    const float lf = a[static_cast<int64_t>(y) * W + (x == 0 ? W - 1 : x - 1)];
    const float rt = a[static_cast<int64_t>(y) * W + (x == W - 1 ? 0 : x + 1)];
    r = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt), 0.25f);
  }
  xout[c * hw + p] = r;
}

__global__ void finish_kernel(float* fill, const int32_t* img, const uint8_t* occ,
                              int32_t* out, int C, int64_t hw, int lo, int hi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const bool o = occ[p] != 0;
  for (int c = 0; c < C; ++c) {
    float v = fill[c * hw + p];
    if (o) {
      v = static_cast<float>(img[c * hw + p]);
      fill[c * hw + p] = v;
    }
    if (out != nullptr)
      out[c * hw + p] = static_cast<int32_t>(fminf(fmaxf(rintf(v), static_cast<float>(lo)),
                                                   static_cast<float>(hi)));
  }
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// img (C, H, W) int32; occ (H, W) uint8; x (C, H, W) float32 state; pass_of
// (H, W) int32; flags int32 with at least first + count + 1 entries, zeroed
// by the caller.  Runs passes first + 1 .. first + count.
extern "C" int bg_dilate(const int32_t* img, const uint8_t* occ, float* x, int32_t* pass_of,
                         int32_t* flags, int C, int H, int W, int first, int count,
                         void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (hw == 0) return 0;
  const int T = 256;
  if (first == 0) {
    dilate_init<<<blocks_for(hw, T), T, 0, st>>>(img, occ, x, pass_of, C, hw);
    ++*launched;
  }
  for (int k = first + 1; k <= first + count; ++k) {
    dilate_pass<<<blocks_for(hw, T), T, 0, st>>>(x, pass_of, C, H, W, k, flags);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// One pull level of fill (C, H, W): level 0 when img is given (with occ),
// else from v (C, H, W) and w (H, W); parent (C, H/2, W/2) unless top.
extern "C" int bg_pull(const int32_t* img, const uint8_t* occ, const float* v,
                       const float* w, const float* parent, float* fill, int C, int H,
                       int W, int top, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (hw == 0 || C == 0) return 0;
  const dim3 grid(blocks_for(hw, 256), C);
  if (img != nullptr) {
    pull_level0<<<grid, 256, 0, st>>>(img, occ, parent, fill, H, W, top);
  } else {
    pull_top_or_level<<<grid, 256, 0, st>>>(v, w, parent, fill, H, W, top);
  }
  return static_cast<int>(cudaGetLastError());
}

// n Jacobi steps of x (C, H, W) float32 in place (tmp: C * H * W floats);
// mask (H, W): uint8 when mask_u8, else float32.
extern "C" int bg_relax(float* x, float* tmp, const void* mask, int mask_u8, int C, int H,
                        int W, int n, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (hw == 0 || C == 0 || n <= 0) return 0;
  const dim3 grid(blocks_for(hw, 256), C);
  float* bufs[2] = {x, tmp};
  for (int s = 0; s < n; ++s) {
    const float* in = bufs[s & 1];
    float* out = bufs[(s + 1) & 1];
    if (mask_u8) {
      relax_step<uint8_t><<<grid, 256, 0, st>>>(in, out, static_cast<const uint8_t*>(mask),
                                                H, W);
    } else {
      relax_step<float><<<grid, 256, 0, st>>>(in, out, static_cast<const float*>(mask), H, W);
    }
    ++*launched;
  }
  if (n & 1) {
    cudaMemcpyAsync(x, tmp, sizeof(float) * C * hw, cudaMemcpyDeviceToDevice, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// fill (C, H, W) float32: the occupied pixels take img; with out (C, H, W)
// int32, rint(fill) clipped to lo..hi.
extern "C" int bg_finish(float* fill, const int32_t* img, const uint8_t* occ, int32_t* out,
                         int C, int hw, int lo, int hi, void* stream) {
  if (hw == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  finish_kernel<<<blocks_for(hw, 256), 256, 0, st>>>(fill, img, occ, out, C, hw, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
