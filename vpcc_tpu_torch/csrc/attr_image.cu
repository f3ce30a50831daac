// Kernel P: the attribute images of the reconstructed points.
//
// Replaces the XLA programs vpcc_tpu/pipeline.py `paint_attribute`
// (pipeline.py:209), `gather_decoded_colors` (:227), `paint_scalar` (:252)
// and `gather_decoded_scalar` (:270), and vpcc_tpu/ops/padding.py
// `group_dilate` (padding.py:149).  Five entry points:
// * attr_paint: the colors of the layer-0 / layer-1 points into two layer
//   images, planar int32 (2, 3, H, W) so that kernel L fills each channel
//   plane directly.  The entry sets the per-(layer, pixel) winners to -1
//   (a memset of 0xFF bytes); pass 1, one thread per point: atomicMax of the
//   row index into the winner (tag 2, any tag but 0 and 1, and pixels
//   outside the image never paint), so that of several points on one pixel
//   the highest row wins, as XLA's sequential CPU scatter; pass 2, four
//   pixels a thread: the winners' colors clamped to 0..255, 0 where none,
//   and layer 1 falls back to layer 0's color.
// * attr_group_dilate: four pixels a thread of the filled planes; where the
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
// two images; the gather reads 3 bytes per point from each image.  The
// design moves them in 16-byte words where the layout allows: the pixel
// passes take four pixels a thread (int4 loads and stores of each plane,
// uchar4 of the occupancy; the dilation's interleaved images leave a warp
// as contiguous int4 runs through shared memory), a point's pixel pair is
// one int2 load.  The pixel passes need H * W a multiple of 4 and the
// planes on 16 bytes (the atlas is whole occupancy blocks, so H * W is a
// multiple of 4 whenever occupancyResolution >= 2); the entries refuse
// other planes with cudaErrorInvalidValue, and the wrappers before them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

__global__ void paint_winners(const int2* pix, const int32_t* layer, int n, int H, int W,
                              int32_t* win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ly = layer[i];
  const int2 q = pix[i];
  if ((ly != 0 && ly != 1) || q.x < 0 || q.x >= W || q.y < 0 || q.y >= H) return;
  atomicMax(&win[static_cast<int64_t>(ly) * H * W + static_cast<int64_t>(q.y) * W + q.x], i);
}

// the colors of pixel p: c0 (layer 0, 0 where no winner), c1 (layer 1,
// layer 0's where no winner)
__device__ __forceinline__ void pixel_colors(const int32_t* col, int w0, int w1, int* c0,
                                             int* c1) {
  if (w0 >= 0) {
    const int32_t* r = col + 3 * static_cast<int64_t>(w0);
    c0[0] = clamp255(r[0]);
    c0[1] = clamp255(r[1]);
    c0[2] = clamp255(r[2]);
  } else {
    c0[0] = c0[1] = c0[2] = 0;
  }
  if (w1 >= 0) {
    const int32_t* r = col + 3 * static_cast<int64_t>(w1);
    c1[0] = clamp255(r[0]);
    c1[1] = clamp255(r[1]);
    c1[2] = clamp255(r[2]);
  } else {
    c1[0] = c0[0];
    c1[1] = c0[1];
    c1[2] = c0[2];
  }
}

// four pixels a thread (hw a multiple of 4: every plane starts on 16 bytes)
__global__ void paint_pixels4(const int32_t* col, const int4* win, int64_t hw4, int4* out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= hw4) return;
  const int4 w0 = win[q], w1 = win[hw4 + q];
  const int a0[4] = {w0.x, w0.y, w0.z, w0.w};
  const int a1[4] = {w1.x, w1.y, w1.z, w1.w};
  int c[6][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int c0[3], c1[3];
    pixel_colors(col, a0[k], a1[k], c0, c1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c[ch][k] = c0[ch];
      c[3 + ch][k] = c1[ch];
    }
  }
#pragma unroll
  for (int pl = 0; pl < 6; ++pl)
    out[pl * hw4 + q] = make_int4(c[pl][0], c[pl][1], c[pl][2], c[pl][3]);
}

__device__ __forceinline__ int dilated(int a, int b, bool bg, bool first) {
  return bg ? (a + b + 1) >> 1 : (first ? a : b);
}

// four pixels a thread: 6 int4 plane loads, a uchar4 of the occupancy; a
// warp's 128 pixels (384 interleaved values an image) go through shared
// memory, so that each of its three int4 stores an image is one contiguous
// 512-byte run
constexpr int DILATE_THREADS = 256;

__global__ void __launch_bounds__(DILATE_THREADS)
group_dilate4(const int4* planes, const uchar4* occ, int64_t hw4, int4* img0, int4* img1) {
  __shared__ __align__(16) int stage[DILATE_THREADS / 32][2][384];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t q0 = q - lane;  // the warp's first quad
  if (q < hw4) {
    int a[3][4], b[3][4];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int4 va = planes[ch * hw4 + q], vb = planes[(3 + ch) * hw4 + q];
      a[ch][0] = va.x; a[ch][1] = va.y; a[ch][2] = va.z; a[ch][3] = va.w;
      b[ch][0] = vb.x; b[ch][1] = vb.y; b[ch][2] = vb.z; b[ch][3] = vb.w;
    }
    const uchar4 o = occ[q];
    const bool bg[4] = {o.x == 0, o.y == 0, o.z == 0, o.w == 0};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        stage[wp][0][12 * lane + 3 * k + ch] = dilated(a[ch][k], b[ch][k], bg[k], true);
        stage[wp][1][12 * lane + 3 * k + ch] = dilated(a[ch][k], b[ch][k], bg[k], false);
      }
  }
  __syncwarp();
  const int64_t nq = hw4 - q0 < 32 ? hw4 - q0 : 32;  // the warp's quads
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int e = 32 * m + lane;  // int4 index among the warp's 96
    if (e < 3 * nq) {
      img0[3 * q0 + e] = reinterpret_cast<const int4*>(stage[wp][0])[e];
      img1[3 * q0 + e] = reinterpret_cast<const int4*>(stage[wp][1])[e];
    }
  }
}

__global__ void gather_kernel(const int2* pix, const int32_t* layer, const uint8_t* a0,
                              const uint8_t* a1, int n, int H, int W, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int2 q = pix[i];
  const int x = min(max(q.x, 0), W - 1), y = min(max(q.y, 0), H - 1);
  const int64_t o = 3 * (static_cast<int64_t>(y) * W + x);
  const uint8_t* a = layer[i] == 1 ? a1 : a0;
  out[3 * i] = a[o];
  out[3 * i + 1] = a[o + 1];
  out[3 * i + 2] = a[o + 2];
}

__global__ void paint_pixels_scalar4(const int32_t* val, const int4* win, int64_t hw4,
                                     int4* out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= hw4) return;
  const int4 w0 = win[q], w1 = win[hw4 + q];
  const int v0x = w0.x >= 0 ? val[w0.x] : 0, v0y = w0.y >= 0 ? val[w0.y] : 0;
  const int v0z = w0.z >= 0 ? val[w0.z] : 0, v0w = w0.w >= 0 ? val[w0.w] : 0;
  out[q] = make_int4(v0x, v0y, v0z, v0w);
  out[hw4 + q] = make_int4(w1.x >= 0 ? val[w1.x] : v0x, w1.y >= 0 ? val[w1.y] : v0y,
                           w1.z >= 0 ? val[w1.z] : v0z, w1.w >= 0 ? val[w1.w] : v0w);
}

__global__ void gather_scalar_kernel(const int2* pix, const int32_t* layer, const int32_t* a0,
                                     const int32_t* a1, int n, int H, int W, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int2 q = pix[i];
  const int x = min(max(q.x, 0), W - 1), y = min(max(q.y, 0), H - 1);
  const int64_t o = static_cast<int64_t>(y) * W + x;
  out[i] = layer[i] == 1 ? a1[o] : a0[o];
}

constexpr int THREADS = 256;

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// the pixel passes' layout: H * W a multiple of 4 and the planes on 16
// bytes, so that each plane is whole int4 words
inline bool quads(int64_t hw, const void* p) { return hw % 4 == 0 && aligned(p, 16); }

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

// the winners at -1, then the point pass; returns the kernels launched
int paint_common(const int32_t* pix, const int32_t* layer, int n, int H, int W, int32_t* win,
                 cudaStream_t st, int* launched) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (hw == 0) return 0;
  cudaError_t e = cudaMemsetAsync(win, 0xFF, 2 * hw * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    paint_winners<<<blocks_for(n), THREADS, 0, st>>>(reinterpret_cast<const int2*>(pix), layer,
                                                      n, H, W, win);
    ++*launched;
  }
  return 0;
}

}  // namespace

// pix (n, 2) int32 [x, y] (8-byte aligned); layer (n,) int32; col (n, 3)
// int32; win (2, H, W) int32 scratch (set here); out (2, 3, H, W) int32;
// H * W a multiple of 4, win and out on 16 bytes.
extern "C" int attr_paint(const int32_t* pix, const int32_t* layer, const int32_t* col,
                          int n, int H, int W, int32_t* win, int32_t* out, void* stream,
                          int* launched) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (!quads(hw, win) || !quads(hw, out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = paint_common(pix, layer, n, H, W, win, st, launched);
  if (rc != 0 || hw == 0) return rc;
  paint_pixels4<<<blocks_for(hw / 4), THREADS, 0, st>>>(
      col, reinterpret_cast<const int4*>(win), hw / 4, reinterpret_cast<int4*>(out));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// planes (2, 3, H, W) int32, occ (H, W) uint8; img0 / img1 (H, W, 3) int32;
// H * W a multiple of 4, occ on 4 bytes, the others on 16.
extern "C" int attr_group_dilate(const int32_t* planes, const uint8_t* occ, int H, int W,
                                 int32_t* img0, int32_t* img1, void* stream) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (!quads(hw, planes) || !aligned(occ, 4) || !aligned(img0, 16) || !aligned(img1, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hw == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  group_dilate4<<<static_cast<unsigned>((hw / 4 + DILATE_THREADS - 1) / DILATE_THREADS),
                  DILATE_THREADS, 0, st>>>(
      reinterpret_cast<const int4*>(planes), reinterpret_cast<const uchar4*>(occ), hw / 4,
      reinterpret_cast<int4*>(img0), reinterpret_cast<int4*>(img1));
  return static_cast<int>(cudaGetLastError());
}

// a0 / a1 (H, W, 3) uint8; out (n, 3) int32.
extern "C" int attr_gather(const int32_t* pix, const int32_t* layer, const uint8_t* a0,
                           const uint8_t* a1, int n, int H, int W, int32_t* out,
                           void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_kernel<<<blocks_for(n), THREADS, 0, st>>>(reinterpret_cast<const int2*>(pix), layer,
                                                    a0, a1, n, H, W, out);
  return static_cast<int>(cudaGetLastError());
}

// val (n,) int32; win (2, H, W) int32 scratch (set here); out (2, H, W)
// int32; as attr_paint's.
extern "C" int attr_paint_scalar(const int32_t* pix, const int32_t* layer, const int32_t* val,
                                 int n, int H, int W, int32_t* win, int32_t* out,
                                 void* stream, int* launched) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (!quads(hw, win) || !quads(hw, out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = paint_common(pix, layer, n, H, W, win, st, launched);
  if (rc != 0 || hw == 0) return rc;
  paint_pixels_scalar4<<<blocks_for(hw / 4), THREADS, 0, st>>>(
      val, reinterpret_cast<const int4*>(win), hw / 4, reinterpret_cast<int4*>(out));
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// a0 / a1 (H, W) int32; out (n,) int32.
extern "C" int attr_gather_scalar(const int32_t* pix, const int32_t* layer, const int32_t* a0,
                                  const int32_t* a1, int n, int H, int W, int32_t* out,
                                  void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_scalar_kernel<<<blocks_for(n), THREADS, 0, st>>>(reinterpret_cast<const int2*>(pix),
                                                           layer, a0, a1, n, H, W, out);
  return static_cast<int>(cudaGetLastError());
}
