// Kernel O: HEVC-style deblocking of the 8-aligned block edges of a stack of
// int32 planes.
//
// Replaces the XLA program vpcc_tpu/video/hevc.py `_deblock` (hevc.py:161),
// which the wavefront codec applies to every deblocked plane (the attribute
// planes, encoder and decoder side) after the CU reconstruction and before
// SAO.  Integer only.  Per plane, tc = TC_TAB[clamp(qp + 2, 0, 53)] *
// max((maxval + 1) / 256, 1); across each edge (p1 p0 | q0 q1),
// delta = (9 (q0 - p0) - 3 (q1 - p1) + 8) >> 4, and where |delta| < 10 tc
// the two samples next to the edge move by clamp(delta, -tc, tc), clamped
// to 0..maxval.  First every vertical edge (x = 8, 16, ...), then every
// horizontal edge (y = 8, 16, ...) of that result.
//
// Bound: bytes (every sample read and written once).
//
// Design.  One launch a call, one pass over the stack.  A block owns a
// (plane, band, column strip).  Band e holds rows 8e-4 .. 8e+3, centred on
// horizontal edge e (band 0 holds rows 0-3 and the last band rows
// H-4 .. H-1, neither has an edge), so every row lies in exactly one band
// and the whole horizontal stencil (rows 8e-2 .. 8e+1) in its band: bands
// need no row halo.  A strip is kStrip columns (the last one may be
// narrower, a multiple of 8) and is staged with one 16-byte word of halo on
// each side inside the plane (the vertical stencil reads two columns past
// the strip).  The block
//   1. stages its rows x (strip + halo) samples into shared memory with
//      16-byte loads;
//   2. filters its vertical edges in place, a thread per (row, edge).  An
//      edge reads p1 p0 q0 q1 and writes p0 q0 only; the stencils of two
//      edges are disjoint, so there is no race.  An edge on a strip boundary
//      is filtered by both strips from the same input, and each stores only
//      its own side;
//   3. filters the band's horizontal edge in place, a thread per column
//      (rows 8e-2 .. 8e+1 read, 8e-1 and 8e written);
//   4. stores its rows x strip samples with 16-byte stores into a new
//      tensor (in place, a strip would race with its neighbour's halo).
// Traffic: (1 + 8 / kStrip) reads and one write of the stack.  The tc table
// is a __constant__ array (no upload, no host wait); each block derives its
// plane's tc from qps and maxvals on the device.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// hevc_tables.TC_TAB, indexed by clamp(qp + 2, 0, 53); a CPU test holds
// this text equal to the table.
__constant__ int kTcTab[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
    6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

constexpr int kStrip = 128;              // columns a block stores
constexpr int kHalo = 4;                 // columns staged each side (one int4)
constexpr int kPitch = kStrip + 2 * kHalo;
constexpr int kRows = 8;                 // rows of a band, at most
constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the edge p1 p0 | q0 q1 at a[-2], a[-1] | a[0], a[stride]
__device__ __forceinline__ void filter_edge(int32_t* a, int stride, int tc, int mv) {
  const int p1 = a[-2 * stride], p0 = a[-stride], q0 = a[0], q1 = a[stride];
  const int dlt = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
  if (abs(dlt) < 10 * tc) {
    const int d = clampi(dlt, -tc, tc);
    a[-stride] = clampi(p0 + d, 0, mv);
    a[0] = clampi(q0 - d, 0, mv);
  }
}

__global__ void __launch_bounds__(kThreads)
deblock_kernel(const int32_t* __restrict__ in, const int32_t* __restrict__ qps,
               const int32_t* __restrict__ maxvals, int32_t* __restrict__ out, int H, int W,
               int n_bands, int n_strips) {
  __shared__ __align__(16) int32_t tile[kRows][kPitch];
  const int strip = static_cast<int>(blockIdx.x % n_strips);
  const int band = static_cast<int>((blockIdx.x / n_strips) % n_bands);
  const int p = static_cast<int>(blockIdx.x / (static_cast<unsigned>(n_strips) * n_bands));
  const int row0 = max(8 * band - 4, 0);
  const int rows = min(8 * band + 4, H) - row0;
  const int s0 = strip * kStrip;
  const int sw = min(kStrip, W - s0);
  const bool left = s0 > 0, right = s0 + sw < W;
  const int64_t base = (static_cast<int64_t>(p) * H + row0) * W;

  // 1. stage: per row sw / 4 words and a halo word each side inside the plane
  const int words = sw / 4 + 2;
  for (int i = threadIdx.x; i < rows * words; i += kThreads) {
    const int r = i / words, c = i - r * words;
    if ((c == 0 && !left) || (c == words - 1 && !right)) continue;
    const int x = s0 - kHalo + 4 * c;
    *reinterpret_cast<int4*>(&tile[r][4 * c]) =
        __ldg(reinterpret_cast<const int4*>(in + base + static_cast<int64_t>(r) * W + x));
  }
  const int tc8 = kTcTab[clampi(qps[p] + 2, 0, 53)];
  const int mv = maxvals[p];
  const int scale = (mv + 1) / 256;
  const int tc = tc8 * (scale > 1 ? scale : 1);
  __syncthreads();

  // 2. the vertical edges x = s0 + 8j (j = 0 .. sw / 8) inside 0 < x < W
  const int edges = sw / 8 + 1;
  for (int i = threadIdx.x; i < rows * edges; i += kThreads) {
    const int r = i / edges, j = i - r * edges;
    const int x = s0 + 8 * j;
    if (x == 0 || x >= W) continue;
    filter_edge(&tile[r][kHalo + 8 * j], 1, tc, mv);
  }
  __syncthreads();

  // 3. the band's horizontal edge (row 8 * band, local row 4)
  if (band >= 1 && 8 * band < H) {
    for (int c = threadIdx.x; c < sw; c += kThreads)
      filter_edge(&tile[4][kHalo + c], kPitch, tc, mv);
    __syncthreads();
  }

  // 4. store the strip's own columns
  const int own = sw / 4;
  for (int i = threadIdx.x; i < rows * own; i += kThreads) {
    const int r = i / own, c = i - r * own;
    *reinterpret_cast<int4*>(out + base + static_cast<int64_t>(r) * W + s0 + 4 * c) =
        *reinterpret_cast<const int4*>(&tile[r][kHalo + 4 * c]);
  }
}

}  // namespace

// in, out: (P, H, W) int32 on 16 bytes, H % 8 == W % 8 == 0; qps, maxvals:
// (P,) int32.  One launch.
extern "C" int deblock(const int32_t* in, const int32_t* qps, const int32_t* maxvals,
                       int32_t* out, int P, int H, int W, void* stream) {
  if (static_cast<int64_t>(P) * H * W == 0) return 0;
  if (H % 8 || W % 8 || (reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bands = H / 8 + 1;
  const int n_strips = (W + kStrip - 1) / kStrip;
  const int64_t blocks = static_cast<int64_t>(P) * n_bands * n_strips;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  deblock_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, qps, maxvals, out, H, W, n_bands,
                                                        n_strips);
  return static_cast<int>(cudaGetLastError());
}
