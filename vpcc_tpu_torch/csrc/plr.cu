// Kernel V: PLR (point local reconstruction), the code plane and the RDO.
//
// Replaces the XLA programs vpcc_tpu/ops/plr.py `interp_deltas` (plr.py:61),
// `mode_planes` (:102) and `rdo` (:119-206).
//
// plr_code, one thread per pixel: the masked maxima of the depth deltas in
// [1, 4] over the 3x3 and then the 5x5 window of the edge-clamped decoded
// D0, each minus one and clamped at 0; the pixel's mode from the block mode
// map (clamped into the table); dmag = max(interpolate ? (neighbor == 2 ?
// d2 : d1) : 0, minD1) and the fill flag; the code's bit j - 1 is set where
// dmag == j or (fill and dmag > j), j = 1..3.  Kernel C's EOM entry reads
// the code as three EOM bits: the layer at D0 + j, tag 2.
//
// plr_rdo_blocks, one thread block per occupancy block: every occupied
// pixel adds, per mode, the forward error (each true depth to its nearest
// generated lane; D1 only where it differs from D0), the backward error
// (each generated lane to its nearest true depth) and the generated count,
// and its source count, into exact 64-bit sums in shared memory.  The
// reference sums these integers in float32, which equals the exact sum
// while it stays below 2^24; blocks reaching 2^24 are counted in
// `inexact`.  The block's mode is the first minimum of max(fwd / src,
// bwd / gen) (IEEE divisions).
//
// plr_rdo_patches, one warp per patch index (0 = no patch: its blocks get
// mode 0): the warp scans the block map 32 blocks at a time and adds the
// values of the patch's blocks in float32 in block raster order (XLA's
// scatter-add order; every lane keeps the same sums), then the patch's mode,
// its level flag (at most block_threshold blocks), and the final mode of
// each of its blocks.
//
// Bound: bytes for the code plane (the D0 plane read, the code written);
// operations for the RDO (per pixel and mode ~40 integer operations).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreshold = 4;
constexpr int kLayers = 3;
constexpr int kMaxModes = 16;
constexpr unsigned long long kExact = 1ull << 24;

__device__ __forceinline__ void interp_deltas(const int32_t* g, int H, int W, int y, int x,
                                              int& d1, int& d2) {
  const int c = g[y * W + x];
  int raw1 = 0, raw2 = 0;
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int ny = min(max(y + dy, 0), H - 1), nx = min(max(x + dx, 0), W - 1);
      const int d = g[ny * W + nx] - c;
      const int v = (d >= 1 && d <= kThreshold) ? d : 0;
      if (max(abs(dy), abs(dx)) == 1) raw1 = max(raw1, v);
      else raw2 = max(raw2, v);
    }
  }
  raw2 = max(raw2, raw1);
  d1 = max(raw1 - 1, 0);
  d2 = max(raw2 - 1, 0);
}

__device__ __forceinline__ int dmag_of(const int32_t* t, int d1, int d2) {
  const int base = t[0] == 1 ? (t[3] == 2 ? d2 : d1) : 0;
  return max(base, t[2]);
}

__global__ void code_kernel(const int32_t* geo, const int32_t* bm, const int32_t* tbl, int M,
                            int H, int W, int res, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i - (i / W) * W;
  int d1, d2;
  interp_deltas(geo, H, W, y, x, d1, d2);
  const int m = min(max(bm[(y / res) * (W / res) + x / res], 0), M - 1);
  const int32_t* t = tbl + m * 4;
  const int dmag = dmag_of(t, d1, d2);
  const bool fill = t[1] == 1;
  int code = 0;
  for (int j = 1; j <= kLayers; ++j)
    if (dmag == j || (fill && dmag > j)) code |= 1 << (j - 1);
  out[i] = code;
}

__global__ void rdo_blocks_kernel(const int32_t* g0d, const int32_t* g0t, const int32_t* g1t,
                                  const uint8_t* occ, const int32_t* tbl, int M, int H, int W,
                                  int res, float* bfwd, float* bbwd, float* bgen, float* bsrc,
                                  int32_t* block_arg, int32_t* inexact) {
  __shared__ unsigned long long s_fwd[kMaxModes], s_bwd[kMaxModes];
  __shared__ int s_gen[kMaxModes], s_src;
  const int b = blockIdx.x;
  const int nbw = W / res;
  const int by = b / nbw, bx = b - (b / nbw) * nbw;
  if (threadIdx.x < kMaxModes) {
    s_fwd[threadIdx.x] = 0;
    s_bwd[threadIdx.x] = 0;
    s_gen[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) s_src = 0;
  __syncthreads();
  unsigned long long fwd[kMaxModes] = {0}, bwd[kMaxModes] = {0};
  int gen[kMaxModes] = {0};
  int src = 0;
  for (int p = threadIdx.x; p < res * res; p += blockDim.x) {
    const int y = by * res + p / res, x = bx * res + p % res;
    const int i = y * W + x;
    if (occ[i] == 0) continue;
    int d1, d2;
    interp_deltas(g0d, H, W, y, x, d1, d2);
    const int gd = g0d[i], t0 = g0t[i], t1 = g1t[i];
    const bool has_d1 = t1 != t0;
    src += has_d1 ? 2 : 1;
    for (int m = 0; m < M; ++m) {
      const int32_t* t = tbl + m * 4;
      const int dmag = dmag_of(t, d1, d2);
      const bool fill = t[1] == 1;
      int f0 = (t0 - gd) * (t0 - gd), f1 = (t1 - gd) * (t1 - gd);
      int bw = 0, ng = 1;
      for (int k = 1; k <= kLayers; ++k) {
        if (!(k == dmag || (fill && k < dmag))) continue;
        const int gk = gd + k;
        f0 = min(f0, (t0 - gk) * (t0 - gk));
        f1 = min(f1, (t1 - gk) * (t1 - gk));
        bw += min((gk - t0) * (gk - t0), (gk - t1) * (gk - t1));
        ++ng;
      }
      fwd[m] += static_cast<unsigned long long>(f0) + (has_d1 ? f1 : 0);
      bwd[m] += static_cast<unsigned long long>(bw);
      gen[m] += ng;
    }
  }
  for (int m = 0; m < M; ++m) {
    if (fwd[m]) atomicAdd(&s_fwd[m], fwd[m]);
    if (bwd[m]) atomicAdd(&s_bwd[m], bwd[m]);
    if (gen[m]) atomicAdd(&s_gen[m], gen[m]);
  }
  if (src) atomicAdd(&s_src, src);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float fs = fmaxf(static_cast<float>(s_src), 1.f);
  bsrc[b] = fs;
  int best = 0;
  float best_cost = 0.f;
  bool big = false;
  for (int m = 0; m < M; ++m) {
    const float ff = __ull2float_rn(s_fwd[m]), fb = __ull2float_rn(s_bwd[m]);
    const float fg = fmaxf(static_cast<float>(s_gen[m]), 1.f);
    big = big || s_fwd[m] >= kExact || s_bwd[m] >= kExact;
    bfwd[b * M + m] = ff;
    bbwd[b * M + m] = fb;
    bgen[b * M + m] = fg;
    const float cost = fmaxf(__fdiv_rn(ff, fs), __fdiv_rn(fb, fg));
    if (m == 0 || cost < best_cost) {
      best = m;
      best_cost = cost;
    }
  }
  block_arg[b] = best;
  if (big) atomicAdd(inexact, 1);
}

__global__ void rdo_patches_kernel(const int32_t* btp, const float* bfwd, const float* bbwd,
                                   const float* bgen, const float* bsrc,
                                   const int32_t* block_arg, int nb, int M, int p_max,
                                   int block_threshold, int32_t* block_modes,
                                   uint8_t* patch_level, int32_t* patch_modes,
                                   int32_t* inexact) {
  // one warp per patch index q (0 = no patch, whose pool is never read)
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q > p_max) return;  // uniform across the warp
  float pf[kMaxModes] = {0.f}, pb[kMaxModes] = {0.f}, pg[kMaxModes] = {0.f};
  float ps = 0.f;
  int cnt = 0;
  for (int base = 0; base < nb; base += 32) {
    const int b = base + lane;
    const bool mine = b < nb && btp[b] == q;
    unsigned mask = __ballot_sync(0xffffffffu, mine);
    if (q == 0) {
      if (mine) block_modes[b] = 0;
      continue;
    }
    cnt += __popc(mask);
    // the patch's blocks of this chunk in raster order, every lane adding
    // the same values (broadcast loads)
    while (mask) {
      const int bl = base + __ffs(mask) - 1;
      mask &= mask - 1;
      ps = __fadd_rn(ps, bsrc[bl]);
      for (int m = 0; m < M; ++m) {
        pf[m] = __fadd_rn(pf[m], bfwd[bl * M + m]);
        pb[m] = __fadd_rn(pb[m], bbwd[bl * M + m]);
        pg[m] = __fadd_rn(pg[m], bgen[bl * M + m]);
      }
    }
  }
  if (q == 0) return;
  const bool level = cnt <= block_threshold;
  int best = 0;
  float best_cost = 0.f;
  bool big = false;
  for (int m = 0; m < M; ++m) {
    const float cost = fmaxf(__fdiv_rn(pf[m], fmaxf(ps, 1.f)), __fdiv_rn(pb[m], fmaxf(pg[m], 1.f)));
    big = big || pf[m] >= 16777216.f || pb[m] >= 16777216.f;
    if (m == 0 || cost < best_cost) {
      best = m;
      best_cost = cost;
    }
  }
  if (lane == 0) {
    patch_level[q - 1] = level ? 1 : 0;
    patch_modes[q - 1] = best;
    if (level && big) atomicAdd(inexact, 1);
  }
  for (int b = lane; b < nb; b += 32)
    if (btp[b] == q) block_modes[b] = level ? best : block_arg[b];
}

}  // namespace

// geo (H, W) int32 decoded D0, bm (H/res, W/res) int32 block modes, tbl (M, 4)
// int32 mode table -> out (H, W) int32 codes.
extern "C" int plr_code(const int32_t* geo, const int32_t* bm, const int32_t* tbl, int M,
                        int H, int W, int res, int32_t* out, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  code_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(geo, bm, tbl, M,
                                                                             H, W, res, out);
  return static_cast<int>(cudaGetLastError());
}

// per block b and mode m: bfwd, bbwd, bgen (nb, M) float32, bsrc (nb,) float32,
// block_arg (nb,) int32; inexact (1,) int32, zeroed, counts the blocks whose
// exact sums reach 2^24.  M <= 16.
extern "C" int plr_rdo_blocks(const int32_t* g0d, const int32_t* g0t, const int32_t* g1t,
                              const uint8_t* occ, const int32_t* tbl, int M, int H, int W,
                              int res, float* bfwd, float* bbwd, float* bgen, float* bsrc,
                              int32_t* block_arg, int32_t* inexact, void* stream) {
  const int nb = (H / res) * (W / res);
  if (nb == 0) return 0;
  if (M < 1 || M > kMaxModes) return static_cast<int>(cudaErrorInvalidValue);
  rdo_blocks_kernel<<<nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g0d, g0t, g1t, occ, tbl, M, H, W, res, bfwd, bbwd, bgen, bsrc, block_arg, inexact);
  return static_cast<int>(cudaGetLastError());
}

// btp (nb,) int32 block-to-patch (0 = none): block_modes (nb,) int32,
// patch_level (p_max,) bool, patch_modes (p_max,) int32; inexact += the
// small patches whose pooled sums reach 2^24.
extern "C" int plr_rdo_patches(const int32_t* btp, const float* bfwd, const float* bbwd,
                               const float* bgen, const float* bsrc, const int32_t* block_arg,
                               int nb, int M, int p_max, int block_threshold,
                               int32_t* block_modes, uint8_t* patch_level,
                               int32_t* patch_modes, int32_t* inexact, void* stream) {
  if (M < 1 || M > kMaxModes) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = p_max + 1;
  rdo_patches_kernel<<<(warps + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      btp, bfwd, bbwd, bgen, bsrc, block_arg, nb, M, p_max, block_threshold, block_modes,
      patch_level, patch_modes, inexact);
  return static_cast<int>(cudaGetLastError());
}
