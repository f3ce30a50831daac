// Kernel B: half-pel motion-compensated prediction.
//
// Replaces the decode side of the XLA programs vpcc_tpu/video/hevc.py
// `_half_planes` (hevc.py:388) and `_apply_motion_half` (hevc.py:418): for
// every pixel of every tile plane, take its CU's motion vector (half-sample
// units), pick the sample at (y + (mvy >> 1), x + (mvx >> 1)) clamped to the
// tile, and interpolate the half-sample phase (mvy & 1, mvx & 1) with the
// 8-tap HEVC half-pel filter: H = clip((sum taps * row + 32) >> 6), V the
// same down a column, HV = V-filter of the clipped H samples.  Edges
// replicate at the tile border, as the reference pads each tile.
//
// Design: one block a (tile plane, CU); every pixel of a CU shares its MV.
// The block reads the MV once and stages the CU's source window in shared
// memory: the clamped centres of the CU's rows run from ay = clamp(y0 + dy)
// to at most ay + bs - 1 (likewise columns), so rows ay-3 .. ay+bs+3 and
// columns ax-3 .. ax+bs+3, each index clamped to the tile, hold every tap
// of every pixel ((bs + 7)^2 int32, 6,084 B at 32 px).  A pixel whose
// centre is clamped reads its taps around the clamped centre, as the
// reference's gather from the edge-padded half-pel planes does; a window
// wholly outside the tile collapses to edge values.  Then by the CU's
// phase: (0, 0) a copy; (0, 1) the horizontal pass; (1, 0) the vertical
// pass on the raw samples; (1, 1) the horizontal pass over the window's
// bs + 7 rows into shared memory (clipped, as the reference clips its H
// plane), then the vertical pass over those clipped samples: 16
// multiply-adds a pixel where a pixel-per-thread kernel made 72.  A thread
// makes 4 adjacent pixels of one row and stores them as one 16-byte word.
// Integer sums are exact in any order; (acc + 32) >> 6 is an arithmetic
// shift, as XLA's.
//
// Bound: bytes.  It reads the reference plane and the MVs and writes one
// int32 per pixel; a window re-reads at most (bs + 7)^2 / bs^2 of its CU's
// samples (L2 hits).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kTaps[8] = {-1, 4, -11, 40, 40, -11, 4, -1};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int round_clip(int acc, int mx) {
  return clampi((acc + 32) >> 6, 0, mx);
}

// one block a CU (blockIdx.x) of a tile plane (blockIdx.y); BS * BS / 4
// threads, each 4 adjacent pixels of one CU row
template <int BS>
__global__ void __launch_bounds__(BS * BS / 4)
    half_pel_mc_kernel(const int32_t* __restrict__ ref, const int32_t* __restrict__ mv,
                       const int32_t* __restrict__ maxv, int32_t* __restrict__ out, int H,
                       int W, int nbx, int vec) {
  constexpr int WN = BS + 7;       // window side
  constexpr int NT = BS * BS / 4;  // threads
  __shared__ int32_t win[WN * WN];
  __shared__ int32_t hpass[WN * BS];  // (1, 1): the clipped H samples of each window row
  const int cu = blockIdx.x;
  const int p = blockIdx.y;
  const int nb = (H / BS) * nbx;
  const int by = cu / nbx;
  const int y0 = by * BS, x0 = (cu - by * nbx) * BS;
  const int32_t* m = mv + (static_cast<size_t>(p) * nb + cu) * 2;
  const int mvy = __ldg(m), mvx = __ldg(m + 1);
  const int fy = mvy & 1, fx = mvx & 1;
  const int dy = mvy >> 1, dx = mvx >> 1;
  const int ay = clampi(y0 + dy, 0, H - 1), ax = clampi(x0 + dx, 0, W - 1);
  const int32_t* r = ref + static_cast<size_t>(p) * H * W;
  const int mx = __ldg(maxv + p);
#pragma unroll  // every load of the thread in flight at once
  for (int k = 0; k < (WN * WN + NT - 1) / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < WN * WN) {
      const int wy = i / WN, wx = i - wy * WN;
      win[i] = __ldg(r + static_cast<size_t>(clampi(ay - 3 + wy, 0, H - 1)) * W +
                     clampi(ax - 3 + wx, 0, W - 1));
    }
  }
  __syncthreads();
  // the thread's row and first column in the CU, and each pixel's offset of
  // its clamped centre from the window's (ay, ax)
  const int ty = threadIdx.x / (BS / 4), tx = (threadIdx.x - ty * (BS / 4)) * 4;
  const int oy = clampi(y0 + dy + ty, 0, H - 1) - ay;
  int ox[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ox[j] = clampi(x0 + dx + tx + j, 0, W - 1) - ax;
  if (fy && fx) {  // the same for the whole block: one MV a CU
    for (int i = threadIdx.x; i < WN * BS; i += NT) {
      const int wy = i / BS, c = i - wy * BS;
      const int* row = win + wy * WN + clampi(x0 + dx + c, 0, W - 1) - ax;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kTaps[k] * row[k];
      hpass[i] = round_clip(acc, mx);
    }
    __syncthreads();
  }
  int v[4];
  if (!fy && !fx) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = win[(oy + 3) * WN + ox[j] + 3];
  } else if (!fy) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int* row = win + (oy + 3) * WN + ox[j];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kTaps[k] * row[k];
      v[j] = round_clip(acc, mx);
    }
  } else if (!fx) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int* col = win + oy * WN + ox[j] + 3;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kTaps[k] * col[k * WN];
      v[j] = round_clip(acc, mx);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int* col = hpass + oy * BS + tx + j;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kTaps[k] * col[k * BS];
      v[j] = round_clip(acc, mx);
    }
  }
  int32_t* o =
      out + static_cast<size_t>(p) * H * W + static_cast<size_t>(y0 + ty) * W + x0 + tx;
  if (vec) {
    *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = v[j];
  }
}

}  // namespace

// ref/out: (P, H, W) int32 tile planes, H and W multiples of bs (16 or 32);
// mv: (P, (H/bs)*nbx, 2) int32 (dy, dx) half-pel MVs; maxv: (P,) int32.
// One launch.
extern "C" int half_pel_mc(const int32_t* ref, const int32_t* mv,
                           const int32_t* maxv, int32_t* out, int P, int H,
                           int W, int bs, int nbx, void* stream) {
  if (static_cast<long long>(P) * H * W == 0) return 0;
  if (P > 65535 || (bs != 16 && bs != 32) || H % bs || W % bs || nbx != W / bs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((H / bs) * nbx, P);
  if (bs == 32) {
    half_pel_mc_kernel<32><<<grid, 32 * 32 / 4, 0, st>>>(ref, mv, maxv, out, H, W, nbx, vec);
  } else {
    half_pel_mc_kernel<16><<<grid, 16 * 16 / 4, 0, st>>>(ref, mv, maxv, out, H, W, nbx, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
