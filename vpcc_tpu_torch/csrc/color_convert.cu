// Kernel Q: RGB <-> YCbCr 4:2:0 of the attribute video (full-range BT.709).
//
// Replaces the XLA programs vpcc_tpu/video/color.py `rgb_to_ycbcr` (:21)
// and `ycbcr_to_rgb` (:34) as vpcc_tpu/video/hevc.py runs them inside
// `_rgb_to_int_planes` (:1766, with occ=None) and `_int_planes_to_rgb`
// (:1783): every attribute frame's T0 and T1 go through them on the encoder
// side (`encode_rgb`, `rgb_refs`, the level path's batches) and on the
// decoder side (`decode_rgb`, `rgb_refs`).
//
// Float32, rounded as the reference's XLA CPU program rounds: it contracts
// a multiply feeding an add into one fused multiply-add and divides by a
// constant by multiplying with its float32 reciprocal.  So this file is
// compiled with --fmad=false and every fused step is an explicit
// __fmaf_rn; the reciprocals come from the wrapper (float32(1) / float32(k),
// computed once on the host), so both versions multiply by the same value.
//
//   rgb_to_planes:      y  = fma(0.0722, b, fma(0.2126, r, 0.7152 * g))
//                       cb = fma(b - y, 1/1.8556, 128), cr = fma(r - y, 1/1.5748, 128)
//                       each rounded half to even (rintf), clipped to 0..255;
//                       chroma = (sum of the 2x2 quad + 2) >> 2.
//   int_planes_to_rgb:  nearest 2x chroma upsample, cb' = cb - 128, cr' = cr - 128,
//                       r = fma(1.5748, cr', y), b = fma(1.8556, cb', y),
//                       g = fma(-0.0722, b, fma(-0.2126, r, y)) * (1/0.7152),
//                       rintf, clipped to 0..255, uint8.
//
// Bound: bytes.  Per pixel 3 bytes of uint8 RGB (12 of the encoder's int32
// images) and 4 of luma, per 2x2 quad 8 of chroma: 9 bytes a pixel (18 for
// int32 input) each way, ~14.7 MB for a 1280x1280 decoded frame.
//
// Design.  A thread owns a 2 x 4 luma block (two chroma samples along x)
// and moves it in words: to planes, a row's 4 pixels are read as 3 int4
// (int32 RGB) or 3 4-byte words (uint8 RGB), its luma written as one int4
// and the block's cb and cr as one int2 each; to RGB, a row's luma is read
// as one int4, the chroma as int2 and the row's 12 bytes of RGB written as
// 3 4-byte words.  (With 8 pixels a thread, 16-byte words throughout, the
// int32 to-planes kernel ran slower than the quad form it replaces: a
// quarter of the threads, each with twice the dependent work.)  The float
// chain of each pixel is the one above; only the assignment of pixels to
// threads is new, and the 4:2:0 mean is an integer sum.  A plane whose
// width is not a multiple of 4 (or a tensor off its word alignment) takes
// the quad form, a thread per 2x2 quad with scalar loads.  To planes takes
// a batch of images (a pointer each, passed by value) and writes
// y (B, H, W) and one chroma tensor (B, 2, H/2, W/2): cb and cr of an image
// side by side, so the codec's (2, H/2, W/2) chroma stack needs no copy.
// One launch a call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBatch = 64;
constexpr int kThreads = 256;
// pixels along x a thread owns (of two rows) in the word form, both ways
constexpr int kPx = 4;

struct Images {
  const void* p[kMaxBatch];
};

__device__ __forceinline__ int to8(float v) {
  const float r = rintf(v);
  return static_cast<int>(fminf(fmaxf(r, 0.0f), 255.0f));
}

// one pixel to (y, cb, cr), each rounded and clipped to 0..255
__device__ __forceinline__ void pixel_ycc(float r, float g, float b, float inv_cb, float inv_cr,
                                          int& y8, int& cb8, int& cr8) {
  const float y = __fmaf_rn(0.0722f, b, __fmaf_rn(0.2126f, r, __fmul_rn(0.7152f, g)));
  const float cb = __fmaf_rn(__fsub_rn(b, y), inv_cb, 128.0f);
  const float cr = __fmaf_rn(__fsub_rn(r, y), inv_cr, 128.0f);
  y8 = to8(y);
  cb8 = to8(cb);
  cr8 = to8(cr);
}

// one pixel back to RGB from its luma and the quad's centred chroma
__device__ __forceinline__ void pixel_rgb(float y, float cb, float cr, float inv_g, int& r8,
                                          int& g8, int& b8) {
  const float r = __fmaf_rn(1.5748f, cr, y);
  const float b = __fmaf_rn(1.8556f, cb, y);
  const float g = __fmul_rn(__fmaf_rn(-0.0722f, b, __fmaf_rn(-0.2126f, r, y)), inv_g);
  r8 = to8(r);
  g8 = to8(g);
  b8 = to8(b);
}

// the 12 RGB samples of 4 pixels: 3 int4 (int32) or 3 words of 4 bytes
// (uint8), from memory aligned to the word
__device__ __forceinline__ void load4(const int32_t* p, float* v) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int4 w = __ldg(q + i);
    v[4 * i] = static_cast<float>(w.x);
    v[4 * i + 1] = static_cast<float>(w.y);
    v[4 * i + 2] = static_cast<float>(w.z);
    v[4 * i + 3] = static_cast<float>(w.w);
  }
}

__device__ __forceinline__ void load4(const uint8_t* p, float* v) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t w = __ldg(q + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * i + k] = static_cast<float>((w >> (8 * k)) & 0xff);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
to_planes_vec(Images imgs, int B, int H, int W, float inv_cb, float inv_cr,
              int32_t* __restrict__ y_out, int32_t* __restrict__ c_out) {
  const int nk = W / kPx, Hc = H / 2, Wc = W / 2;
  const int64_t per = static_cast<int64_t>(Hc) * nk;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * per) return;
  const int b = static_cast<int>(t / per);
  const int64_t rem = t - b * per;
  const int cy = static_cast<int>(rem / nk), k = static_cast<int>(rem % nk);
  const T* rgb = static_cast<const T*>(imgs.p[b]);
  int scb[2] = {0, 0}, scr[2] = {0, 0};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int64_t px = static_cast<int64_t>(2 * cy + dy) * W + kPx * k;
    float v[3 * kPx];
    load4(rgb + 3 * px, v);
    int y8[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      int cb8, cr8;
      pixel_ycc(v[3 * i], v[3 * i + 1], v[3 * i + 2], inv_cb, inv_cr, y8[i], cb8, cr8);
      scb[i / 2] += cb8;
      scr[i / 2] += cr8;
    }
    *reinterpret_cast<int4*>(y_out + static_cast<int64_t>(b) * H * W + px) =
        make_int4(y8[0], y8[1], y8[2], y8[3]);
  }
  int32_t* co = c_out + (static_cast<int64_t>(2 * b) * Hc + cy) * Wc + 2 * k;
  *reinterpret_cast<int2*>(co) = make_int2((scb[0] + 2) >> 2, (scb[1] + 2) >> 2);
  *reinterpret_cast<int2*>(co + static_cast<int64_t>(Hc) * Wc) =
      make_int2((scr[0] + 2) >> 2, (scr[1] + 2) >> 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
to_planes_quad(Images imgs, int B, int H, int W, float inv_cb, float inv_cr,
               int32_t* __restrict__ y_out, int32_t* __restrict__ c_out) {
  const int Hc = H / 2, Wc = W / 2;
  const int64_t per = static_cast<int64_t>(Hc) * Wc;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * per) return;
  const int b = static_cast<int>(t / per);
  const int64_t q = t - b * per;
  const int cy = static_cast<int>(q / Wc), cx = static_cast<int>(q % Wc);
  const T* rgb = static_cast<const T*>(imgs.p[b]);
  int sum_cb = 0, sum_cr = 0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int64_t px = static_cast<int64_t>(2 * cy + dy) * W + (2 * cx + dx);
      int y8, cb8, cr8;
      pixel_ycc(static_cast<float>(rgb[3 * px]), static_cast<float>(rgb[3 * px + 1]),
                static_cast<float>(rgb[3 * px + 2]), inv_cb, inv_cr, y8, cb8, cr8);
      y_out[static_cast<int64_t>(b) * H * W + px] = y8;
      sum_cb += cb8;
      sum_cr += cr8;
    }
  }
  int32_t* co = c_out + static_cast<int64_t>(2 * b) * per + q;
  co[0] = (sum_cb + 2) >> 2;
  co[per] = (sum_cr + 2) >> 2;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

__global__ void __launch_bounds__(kThreads)
to_rgb_vec(const int32_t* __restrict__ y_in, const int32_t* __restrict__ cb_in,
           const int32_t* __restrict__ cr_in, int H, int W, float inv_g,
           uint8_t* __restrict__ rgb) {
  const int nk = W / kPx, Wc = W / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(H / 2) * nk) return;
  const int cy = static_cast<int>(t / nk), k = static_cast<int>(t % nk);
  const int64_t ci = static_cast<int64_t>(cy) * Wc + 2 * k;
  const int2 cbi = __ldg(reinterpret_cast<const int2*>(cb_in + ci));
  const int2 cri = __ldg(reinterpret_cast<const int2*>(cr_in + ci));
  const float cb[2] = {__fsub_rn(static_cast<float>(cbi.x), 128.0f),
                       __fsub_rn(static_cast<float>(cbi.y), 128.0f)};
  const float cr[2] = {__fsub_rn(static_cast<float>(cri.x), 128.0f),
                       __fsub_rn(static_cast<float>(cri.y), 128.0f)};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int64_t px = static_cast<int64_t>(2 * cy + dy) * W + kPx * k;
    const int4 yw = __ldg(reinterpret_cast<const int4*>(y_in + px));
    const int yv[kPx] = {yw.x, yw.y, yw.z, yw.w};
    int o[3 * kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i)
      pixel_rgb(static_cast<float>(yv[i]), cb[i / 2], cr[i / 2], inv_g, o[3 * i], o[3 * i + 1],
                o[3 * i + 2]);
    uint32_t* dst = reinterpret_cast<uint32_t*>(rgb + 3 * px);
#pragma unroll
    for (int i = 0; i < 3; ++i) dst[i] = pack4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
to_rgb_quad(const int32_t* __restrict__ y_in, const int32_t* __restrict__ cb_in,
            const int32_t* __restrict__ cr_in, int H, int W, float inv_g,
            uint8_t* __restrict__ rgb) {
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
      int r8, g8, b8;
      pixel_rgb(static_cast<float>(y_in[p]), cb, cr, inv_g, r8, g8, b8);
      rgb[3 * p + 0] = static_cast<uint8_t>(r8);
      rgb[3 * p + 1] = static_cast<uint8_t>(g8);
      rgb[3 * p + 2] = static_cast<uint8_t>(b8);
    }
  }
}

bool on(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_to_planes(const Images& imgs, int B, int H, int W, float inv_cb, float inv_cr,
                     int32_t* y, int32_t* c, cudaStream_t s) {
  bool vec = W % kPx == 0 && on(y, 16) && on(c, 8);
  for (int b = 0; b < B; ++b) vec = vec && on(imgs.p[b], sizeof(T) == 1 ? 4 : 16);
  if (vec) {
    to_planes_vec<T><<<grid_for(static_cast<int64_t>(B) * (H / 2) * (W / kPx)), kThreads, 0,
                       s>>>(imgs, B, H, W, inv_cb, inv_cr, y, c);
  } else {
    to_planes_quad<T><<<grid_for(static_cast<int64_t>(B) * (H / 2) * (W / 2)), kThreads, 0, s>>>(
        imgs, B, H, W, inv_cb, inv_cr, y, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images: a host array of B image pointers, each (H, W, 3) uint8
// (elem_bytes 1: decoded frames) or int32 (elem_bytes 4: the encoder's
// background-filled images, 0..255); y: (B, H, W), chroma: (B, 2, H/2,
// W/2) int32.  H and W even.  One launch.
extern "C" int rgb_to_planes(const void* const* images, int B, int elem_bytes, int H, int W,
                             float inv_cb, float inv_cr, void* y, void* chroma, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (B > kMaxBatch || H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  Images imgs{};
  for (int b = 0; b < B; ++b) imgs.p[b] = images[b];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* yp = static_cast<int32_t*>(y);
  int32_t* cp = static_cast<int32_t*>(chroma);
  if (elem_bytes == 1) return launch_to_planes<uint8_t>(imgs, B, H, W, inv_cb, inv_cr, yp, cp, s);
  if (elem_bytes == 4) return launch_to_planes<int32_t>(imgs, B, H, W, inv_cb, inv_cr, yp, cp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: (H, W), cb, cr: (H/2, W/2) int32 -> rgb: (H, W, 3) uint8.  One launch.
extern "C" int int_planes_to_rgb(const void* y, const void* cb, const void* cr, int H, int W,
                                 float inv_g, void* rgb, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* yp = static_cast<const int32_t*>(y);
  const int32_t* cbp = static_cast<const int32_t*>(cb);
  const int32_t* crp = static_cast<const int32_t*>(cr);
  uint8_t* out = static_cast<uint8_t*>(rgb);
  if (W % kPx == 0 && on(y, 16) && on(cb, 8) && on(cr, 8) && on(rgb, 4)) {
    to_rgb_vec<<<grid_for(static_cast<int64_t>(H / 2) * (W / kPx)), kThreads, 0, s>>>(
        yp, cbp, crp, H, W, inv_g, out);
  } else {
    to_rgb_quad<<<grid_for(static_cast<int64_t>(H / 2) * (W / 2)), kThreads, 0, s>>>(
        yp, cbp, crp, H, W, inv_g, out);
  }
  return static_cast<int>(cudaGetLastError());
}
