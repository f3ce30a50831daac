// Kernel K: sample-adaptive offset (edge offset, per 32x32 region), search
// and apply.
//
// Replaces the XLA programs vpcc_tpu/video/hevc.py `_sao_search_apply`
// (hevc.py:216, run on every encoded plane) and `_sao_apply` (hevc.py:275,
// run on every decoded plane).  The category of a pixel under EO class
// (dy, dx) is sign(rec - a) + sign(rec - b) + 2 against its two neighbours
// along the class's axis, edge-replicated at the tile border; 2 is flat.
//
// Search: one block per (tile plane, region).  For each of the four classes
// the block counts, per non-flat category, the weighted pixels n and their
// weighted error sum s (src - rec) as integers (exact, any order), then one
// thread computes offset o = clip(rint(s / max(n, 1)), -7, 7), the gain
// sum(n*o*o - 2*o*s) (products exact below 2^24) and cost fma(lam, 19, gain),
// keeping the first class whose cost is below the best so far (0 = off).
// Apply: one thread per pixel adds its region's offset for its category
// under the region's class and clips to [0, maxval].
//
// Bound: bytes.  The search reads src, rec and weights once (the neighbour
// reads hit L1) and writes 5 bytes per region; the apply reads rec and
// writes the plane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kDirs[4][2] = {{0, 1}, {1, 0}, {1, 1}, {1, -1}};
constexpr int kOffMax = 7;

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int category(const int32_t* r, int H, int W, int y,
                                        int x, int cls) {
  const int dy = kDirs[cls][0], dx = kDirs[cls][1];
  const int v = r[y * W + x];
  const int ya = min(max(y + dy, 0), H - 1), xa = min(max(x + dx, 0), W - 1);
  const int yb = min(max(y - dy, 0), H - 1), xb = min(max(x - dx, 0), W - 1);
  return sgn(v - r[ya * W + xa]) + sgn(v - r[yb * W + xb]) + 2;
}

// category -> offset slot: {0, 1, 3, 4} -> {0, 1, 2, 3}; flat (2) -> -1
__device__ __forceinline__ int slot_of(int cat) {
  return cat == 2 ? -1 : (cat > 2 ? cat - 1 : cat);
}

__global__ void __launch_bounds__(256)
sao_search_kernel(const int32_t* src, const int32_t* rec, const int32_t* wts,
                  const float* lam, int8_t* cls_out, int8_t* off_out, int H,
                  int W, int region) {
  __shared__ long long n_s[4][4];
  __shared__ long long s_s[4][4];
  const int rx_n = W / region;
  const int ry = blockIdx.x / rx_n, rx = blockIdx.x % rx_n;
  const int p = blockIdx.y;
  const size_t plane = static_cast<size_t>(p) * H * W;
  const int32_t* r = rec + plane;
  const int t = threadIdx.x;
  if (t < 16) {
    n_s[t / 4][t % 4] = 0;
    s_s[t / 4][t % 4] = 0;
  }
  __syncthreads();
  int n_loc[4][4] = {};
  long long s_loc[4][4] = {};
  for (int i = t; i < region * region; i += blockDim.x) {
    const int y = ry * region + i / region, x = rx * region + i % region;
    const size_t q = plane + static_cast<size_t>(y) * W + x;
    if (wts[q] == 0) continue;
    const int diff = src[q] - rec[q];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int sl = slot_of(category(r, H, W, y, x, c));
      if (sl >= 0) {
        n_loc[c][sl] += 1;
        s_loc[c][sl] += diff;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n_loc[c][k]) {
        atomicAdd(reinterpret_cast<unsigned long long*>(&n_s[c][k]),
                  static_cast<unsigned long long>(n_loc[c][k]));
        atomicAdd(reinterpret_cast<unsigned long long*>(&s_s[c][k]),
                  static_cast<unsigned long long>(s_loc[c][k]));
      }
    }
  }
  __syncthreads();
  if (t != 0) return;
  const float l = lam[p];
  float best_gain = 0.0f;
  int best_cls = 0;
  int best_off[4] = {0, 0, 0, 0};
  for (int c = 0; c < 4; ++c) {
    float gain = 0.0f;
    int off[4];
    for (int k = 0; k < 4; ++k) {
      const float n = static_cast<float>(n_s[c][k]);
      const float s = static_cast<float>(s_s[c][k]);
      float o = rintf(__fdiv_rn(s, fmaxf(n, 1.0f)));
      o = fminf(fmaxf(o, -static_cast<float>(kOffMax)), static_cast<float>(kOffMax));
      // gain + n*o*o - 2*o*s, each operation rounded once (as the plain
      // version's torch ops)
      gain = __fsub_rn(__fadd_rn(gain, __fmul_rn(__fmul_rn(n, o), o)),
                       __fmul_rn(__fmul_rn(2.0f, o), s));
      off[k] = static_cast<int>(o);
    }
    const float cost = __fmaf_rn(l, 19.0f, gain);
    if (cost < best_gain) {
      best_gain = cost;
      best_cls = c + 1;
      for (int k = 0; k < 4; ++k) best_off[k] = off[k];
    }
  }
  const size_t reg = (static_cast<size_t>(p) * (H / region) + ry) * rx_n + rx;
  cls_out[reg] = static_cast<int8_t>(best_cls);
  for (int k = 0; k < 4; ++k) off_out[reg * 4 + k] = static_cast<int8_t>(best_off[k]);
}

__global__ void sao_apply_kernel(const int32_t* rec, const int8_t* cls,
                                 const int8_t* off, const int32_t* maxv,
                                 int32_t* out, int P, int H, int W, int region) {
  const long long total = static_cast<long long>(P) * H * W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int p = static_cast<int>(idx / (static_cast<long long>(H) * W));
  const int rem = static_cast<int>(idx - static_cast<long long>(p) * H * W);
  const int y = rem / W, x = rem % W;
  const int32_t* r = rec + static_cast<size_t>(p) * H * W;
  const size_t reg = (static_cast<size_t>(p) * (H / region) + y / region) *
                         (W / region) + x / region;
  const int c = cls[reg];
  int v = r[rem];
  if (c > 0) {
    const int sl = slot_of(category(r, H, W, y, x, c - 1));
    if (sl >= 0) v += off[reg * 4 + sl];
  }
  out[idx] = min(max(v, 0), maxv[p]);
}

}  // namespace

// src/rec/wts: (P, H, W) int32 (wts 0/1); lam: (P,) float32; cls_out
// (P, H/region, W/region) int8; off_out (P, H/region, W/region, 4) int8.
extern "C" int sao_search(const int32_t* src, const int32_t* rec,
                          const int32_t* wts, const float* lam, int8_t* cls_out,
                          int8_t* off_out, int P, int H, int W, int region,
                          void* stream) {
  if (P == 0 || H == 0 || W == 0) return 0;
  dim3 grid((H / region) * (W / region), P);
  sao_search_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, rec, wts, lam, cls_out, off_out, H, W, region);
  return static_cast<int>(cudaGetLastError());
}

// rec/out: (P, H, W) int32; cls/off as sao_search writes them; maxv (P,).
extern "C" int sao_apply(const int32_t* rec, const int8_t* cls, const int8_t* off,
                         const int32_t* maxv, int32_t* out, int P, int H, int W,
                         int region, void* stream) {
  const long long total = static_cast<long long>(P) * H * W;
  if (total == 0) return 0;
  const int T = 256;
  sao_apply_kernel<<<static_cast<unsigned>((total + T - 1) / T), T, 0,
                     static_cast<cudaStream_t>(stream)>>>(rec, cls, off, maxv, out,
                                                          P, H, W, region);
  return static_cast<int>(cudaGetLastError());
}
