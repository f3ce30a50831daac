// Kernel Q: RGB <-> YCbCr 4:2:0 of the attribute video (full-range BT.709).
//
// Replaces the XLA programs vpcc_tpu/video/color.py `rgb_to_ycbcr` (:21)
// and `ycbcr_to_rgb` (:34) as vpcc_tpu/video/hevc.py runs them inside
// `_rgb_to_int_planes` (:1766, with occ=None) and `_int_planes_to_rgb`
// (:1783): every attribute frame's T0 and T1 go through them on the encoder
// side (`encode_rgb`, `rgb_refs`) and on the decoder side (`decode_rgb`,
// `rgb_refs`).
//
// Float32, rounded as the reference's XLA CPU program rounds: it contracts
// a multiply feeding an add into one fused multiply-add and divides by a
// constant by multiplying with its float32 reciprocal.  So this file is
// compiled with --fmad=false and every fused step is an explicit
// __fmaf_rn; the reciprocals come from the wrapper (float32(1) / float32(k),
// computed once on the host), so both versions multiply by the same value.
//
//   rgb_to_int_planes:  y  = fma(0.0722, b, fma(0.2126, r, 0.7152 * g))
//                       cb = fma(b - y, 1/1.8556, 128), cr = fma(r - y, 1/1.5748, 128)
//                       each rounded half to even (rintf), clipped to 0..255;
//                       chroma = (sum of the 2x2 quad + 2) >> 2.
//   int_planes_to_rgb:  nearest 2x chroma upsample, cb' = cb - 128, cr' = cr - 128,
//                       r = fma(1.5748, cr', y), b = fma(1.8556, cb', y),
//                       g = fma(-0.0722, b, fma(-0.2126, r, y)) * (1/0.7152),
//                       rintf, clipped to 0..255, uint8.
//
// Design.  One thread per 2x2 luma quad, i.e. per chroma sample: the thread
// converts its four pixels and writes (or reads) the quad's one chroma pair,
// so the 4:2:0 mean (and the upsample) needs no second pass and no shared
// memory.  H and W are even.
//
// Bound: bytes.  Per pixel 3 bytes of uint8 RGB (12 of the encoder's int32
// images) and 4 of luma, per quad 8 of chroma: 9 bytes a pixel (18 for
// int32 input), ~14.7 MB for a 1280x1280 decoded frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int to8(float v) {
  const float r = rintf(v);
  return static_cast<int>(fminf(fmaxf(r, 0.0f), 255.0f));
}

template <typename T>
__global__ void rgb_to_planes_kernel(const T* __restrict__ rgb, int H, int W,
                                     float inv_cb, float inv_cr,
                                     int32_t* __restrict__ y_out,
                                     int32_t* __restrict__ cb_out,
                                     int32_t* __restrict__ cr_out) {
  const int Wc = W / 2;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= static_cast<int64_t>(H / 2) * Wc) return;
  const int cy = static_cast<int>(q / Wc), cx = static_cast<int>(q % Wc);
  int sum_cb = 0, sum_cr = 0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int64_t p = static_cast<int64_t>(2 * cy + dy) * W + (2 * cx + dx);
      const float r = static_cast<float>(rgb[3 * p + 0]);
      const float g = static_cast<float>(rgb[3 * p + 1]);
      const float b = static_cast<float>(rgb[3 * p + 2]);
      const float y = __fmaf_rn(0.0722f, b, __fmaf_rn(0.2126f, r, __fmul_rn(0.7152f, g)));
      const float cb = __fmaf_rn(__fsub_rn(b, y), inv_cb, 128.0f);
      const float cr = __fmaf_rn(__fsub_rn(r, y), inv_cr, 128.0f);
      y_out[p] = to8(y);
      sum_cb += to8(cb);
      sum_cr += to8(cr);
    }
  }
  cb_out[q] = (sum_cb + 2) >> 2;
  cr_out[q] = (sum_cr + 2) >> 2;
}

__global__ void planes_to_rgb_kernel(const int32_t* __restrict__ y_in,
                                     const int32_t* __restrict__ cb_in,
                                     const int32_t* __restrict__ cr_in, int H, int W,
                                     float inv_g, uint8_t* __restrict__ rgb) {
  const int Wc = W / 2;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= static_cast<int64_t>(H / 2) * Wc) return;
  const int cy = static_cast<int>(q / Wc), cx = static_cast<int>(q % Wc);
  const float cb = __fsub_rn(static_cast<float>(cb_in[q]), 128.0f);
  const float cr = __fsub_rn(static_cast<float>(cr_in[q]), 128.0f);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int64_t p = static_cast<int64_t>(2 * cy + dy) * W + (2 * cx + dx);
      const float y = static_cast<float>(y_in[p]);
      const float r = __fmaf_rn(1.5748f, cr, y);
      const float b = __fmaf_rn(1.8556f, cb, y);
      const float g = __fmul_rn(__fmaf_rn(-0.0722f, b, __fmaf_rn(-0.2126f, r, y)), inv_g);
      rgb[3 * p + 0] = static_cast<uint8_t>(to8(r));
      rgb[3 * p + 1] = static_cast<uint8_t>(to8(g));
      rgb[3 * p + 2] = static_cast<uint8_t>(to8(b));
    }
  }
}

constexpr int kThreads = 256;

int grid_for(int H, int W) {
  const int64_t n = static_cast<int64_t>(H / 2) * (W / 2);
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// `rgb` holds uint8 (elem_bytes 1: decoded frames) or int32 (elem_bytes 4:
// the encoder's background-filled images, 0..255) samples.
extern "C" int rgb_to_int_planes(const void* rgb, int elem_bytes, int H, int W, float inv_cb,
                                 float inv_cr, void* y, void* cb, void* cr, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    rgb_to_planes_kernel<<<grid_for(H, W), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(rgb), H, W, inv_cb, inv_cr, static_cast<int32_t*>(y),
        static_cast<int32_t*>(cb), static_cast<int32_t*>(cr));
  } else if (elem_bytes == 4) {
    rgb_to_planes_kernel<<<grid_for(H, W), kThreads, 0, s>>>(
        static_cast<const int32_t*>(rgb), H, W, inv_cb, inv_cr, static_cast<int32_t*>(y),
        static_cast<int32_t*>(cb), static_cast<int32_t*>(cr));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int_planes_to_rgb(const void* y, const void* cb, const void* cr, int H, int W,
                                 float inv_g, void* rgb, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  planes_to_rgb_kernel<<<grid_for(H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(y), static_cast<const int32_t*>(cb),
      static_cast<const int32_t*>(cr), H, W, inv_g, static_cast<uint8_t*>(rgb));
  return static_cast<int>(cudaGetLastError());
}
