// Kernel P: the attribute images of the reconstructed points.
//
// Replaces the XLA programs vpcc_tpu/pipeline.py `paint_attribute`
// (pipeline.py:209), `gather_decoded_colors` (:227), `paint_scalar` (:252)
// and `gather_decoded_scalar` (:270), and vpcc_tpu/ops/padding.py
// `group_dilate` (padding.py:149).  Five entry points:
// * attr_paint: the colors of the layer-0 / layer-1 points into two layer
//   images, planar int32 (2, 3, H, W) so that kernel L fills each channel
//   plane directly.  Pass 1, one thread per point: atomicMax of the row
//   index into a per-(layer, pixel) winner (tag 2 never paints), so that of
//   several points on one pixel the highest row wins, as XLA's sequential
//   CPU scatter; pass 2, one thread per pixel: the winners' colors clamped
//   to 0..255, 0 where none, and layer 1 falls back to layer 0's color.
// * attr_group_dilate: one thread per pixel of the filled planes; where the
//   occupancy is 0 both layers take (a + b + 1) >> 1; writes the two
//   interleaved (H, W, 3) int32 images the attribute video codes.
// * attr_gather: one thread per point, its decoded color from the (H, W, 3)
//   uint8 image of its layer (layer 1 reads image 1, any other tag image 0),
//   the pixel clamped into the image as XLA's gather clamps it.
// * attr_paint_scalar / attr_gather_scalar: the same for one int32 sample
//   per point (the 16-bit reflectance): paint's winner pass, then a pixel
//   pass copying the winners' samples into (2, H, W) int32 unclamped; the
//   gather from two (H, W) int32 images.
//
// Bound: bytes.  Paint reads the points and writes 2 x 3 planes (plus the
// winner planes); dilation reads 2 x 3 planes and the occupancy and writes
// two images; the gather reads 3 bytes per point from each image.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void paint_winners(const int32_t* pix, const int32_t* layer, int n, int H,
                              int W, int32_t* win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ly = layer[i];
  const int x = pix[2 * i], y = pix[2 * i + 1];
  if ((ly != 0 && ly != 1) || x < 0 || x >= W || y < 0 || y >= H) return;
  atomicMax(&win[static_cast<int64_t>(ly) * H * W + static_cast<int64_t>(y) * W + x], i);
}

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

__global__ void paint_pixels(const int32_t* col, const int32_t* win, int H, int W,
                             int32_t* out) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int w0 = win[p], w1 = win[hw + p];
  for (int c = 0; c < 3; ++c) {
    const int c0 = w0 >= 0 ? clamp255(col[3 * static_cast<int64_t>(w0) + c]) : 0;
    const int c1 = w1 >= 0 ? clamp255(col[3 * static_cast<int64_t>(w1) + c]) : c0;
    out[c * hw + p] = c0;
    out[(3 + c) * hw + p] = c1;
  }
}

__global__ void group_dilate_kernel(const int32_t* planes, const uint8_t* occ, int H,
                                    int W, int32_t* img0, int32_t* img1) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const bool bg = occ[p] == 0;
  for (int c = 0; c < 3; ++c) {
    int a = planes[c * hw + p], b = planes[(3 + c) * hw + p];
    if (bg) a = b = (a + b + 1) >> 1;
    img0[3 * p + c] = a;
    img1[3 * p + c] = b;
  }
}

__global__ void gather_kernel(const int32_t* pix, const int32_t* layer,
                              const uint8_t* a0, const uint8_t* a1, int n, int H, int W,
                              int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = min(max(pix[2 * i], 0), W - 1), y = min(max(pix[2 * i + 1], 0), H - 1);
  const int64_t o = 3 * (static_cast<int64_t>(y) * W + x);
  const uint8_t* a = layer[i] == 1 ? a1 : a0;
  out[3 * i] = a[o];
  out[3 * i + 1] = a[o + 1];
  out[3 * i + 2] = a[o + 2];
}

__global__ void paint_pixels_scalar(const int32_t* val, const int32_t* win, int64_t hw,
                                    int32_t* out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int w0 = win[p], w1 = win[hw + p];
  const int v0 = w0 >= 0 ? val[w0] : 0;
  out[p] = v0;
  out[hw + p] = w1 >= 0 ? val[w1] : v0;
}

__global__ void gather_scalar_kernel(const int32_t* pix, const int32_t* layer,
                                     const int32_t* a0, const int32_t* a1, int n, int H,
                                     int W, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = min(max(pix[2 * i], 0), W - 1), y = min(max(pix[2 * i + 1], 0), H - 1);
  const int64_t o = static_cast<int64_t>(y) * W + x;
  out[i] = layer[i] == 1 ? a1[o] : a0[o];
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// win (2, H, W) int32 filled with -1 by the caller.
extern "C" int attr_paint(const int32_t* pix, const int32_t* layer, const int32_t* col,
                          int n, int H, int W, int32_t* win, int32_t* out, void* stream,
                          int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  *launched = 0;
  if (n > 0) {
    paint_winners<<<blocks_for(n, threads), threads, 0, st>>>(pix, layer, n, H, W, win);
    ++*launched;
  }
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (hw > 0) {
    paint_pixels<<<blocks_for(hw, threads), threads, 0, st>>>(col, win, H, W, out);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attr_group_dilate(const int32_t* planes, const uint8_t* occ, int H, int W,
                                 int32_t* img0, int32_t* img1, void* stream) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (hw == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  group_dilate_kernel<<<blocks_for(hw, 256), 256, 0, st>>>(planes, occ, H, W, img0, img1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attr_gather(const int32_t* pix, const int32_t* layer, const uint8_t* a0,
                           const uint8_t* a1, int n, int H, int W, int32_t* out,
                           void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_kernel<<<blocks_for(n, 256), 256, 0, st>>>(pix, layer, a0, a1, n, H, W, out);
  return static_cast<int>(cudaGetLastError());
}

// val (n,) int32; win (2, H, W) int32 filled with -1 by the caller; out
// (2, H, W) int32.
extern "C" int attr_paint_scalar(const int32_t* pix, const int32_t* layer, const int32_t* val,
                                 int n, int H, int W, int32_t* win, int32_t* out,
                                 void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  *launched = 0;
  if (n > 0) {
    paint_winners<<<blocks_for(n, threads), threads, 0, st>>>(pix, layer, n, H, W, win);
    ++*launched;
  }
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (hw > 0) {
    paint_pixels_scalar<<<blocks_for(hw, threads), threads, 0, st>>>(val, win, hw, out);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attr_gather_scalar(const int32_t* pix, const int32_t* layer, const int32_t* a0,
                                  const int32_t* a1, int n, int H, int W, int32_t* out,
                                  void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_scalar_kernel<<<blocks_for(n, 256), 256, 0, st>>>(pix, layer, a0, a1, n, H, W, out);
  return static_cast<int>(cudaGetLastError());
}
