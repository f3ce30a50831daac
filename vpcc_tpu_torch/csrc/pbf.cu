// Kernel U: PBF, patch border filtering of the decoded occupancy.
//
// Replaces the XLA programs vpcc_tpu/ops/pbf.py `count_border` (pbf.py:110)
// and `pbf_filter_occupancy` (pbf.py:136-300).
//
// Three entries:
// * pbf_border, one thread per pixel: the pixel's patch from the block map,
//   occupied-in-a-patch, the border test over the 12-cell cross + diagonal
//   neighbourhood (a neighbour counts when it lies in the canvas, is
//   occupied and has the same block-map entry), the border count; with the
//   D0 plane, also the depth map (D0 where occupied, else 0), the pass-0
//   occupancy and the compaction of the border pixels of non-45-degree
//   patches (an atomic slot each: the projections below are order-free, so
//   the list's order does not matter);
// * pbf_project, one thread per (border point, patch) pair: the border
//   pixel's D0 point (no LOD scaling, as the reference), its depth and
//   (u, v) in the other patch, the canvas pixel it lands on; where the
//   reference's tests pass, atomicMin of the integer key
//   (|depth - pixel depth| << 12) | depth: exact and order-free;
// * pbf_pass, one thread per pixel, one launch per filter pass, reading the
//   previous pass's occupancy: a pixel with 4 same-patch 4-neighbours stays,
//   one with none goes; otherwise the 8-neighbourhood byte gives the
//   boundary orientation, and the (2 fs + 1) x (fs / 2 * 2 + 1) window of
//   neighbour projections, in the reference's order, sums float32 square
//   roots of exact integer squared distances to the pixel and to its
//   eroded position (correctly rounded __fsqrt_rn, sequential __fadd_rn:
//   the reference's values bit for bit).  The pixel stays when the window
//   is empty or the eroded sum is at least the pixel's.
// Compiled with --fmad=false.
//
// Bound: bytes — the occupancy, D0 and block map read per pass, the key
// plane written by the projections and read by every pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { U0, V0, SU0, SV0, U1, V1, D1, NA, TA, BA, MODE, ORI, AX45, GBITS, LODX, LODY, NF };

constexpr int kUndef = 1 << 29;
constexpr int kDShift = 12;

__constant__ int8_t g_orientation[256] = {
    0, 0, 6, 0, 0, 0, 0, 6, 4, 0, 0, 5, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 7, 7,
    0, 0, 0, 0, 0, 0, 0, 6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, 5, 0, 0, 0, 5,
    0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0, 5, 2, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 4, 3, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 7, 7, 0, 0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 7,
    0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 3, 0, 0, 0, 4,
    1, 0, 0, 0, 1, 0, 1, 0, 2, 3, 0, 0, 1, 2, 0, 0,
};
__constant__ int8_t g_dilate[8][2] = {{1, 0}, {1, 1}, {0, 1}, {-1, 1},
                                      {-1, 0}, {-1, -1}, {0, -1}, {1, -1}};
__constant__ int8_t offs12[12][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {0, 2}, {0, -2},
                                     {2, 0}, {-2, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
// the 8-neighbourhood byte, bit 7 first (tl t tr l r bl b br)
__constant__ int8_t offs8[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                   {0, 1}, {1, -1}, {1, 0}, {1, 1}};

__device__ __forceinline__ int block_of(const int32_t* btp, int y, int x, int res, int W) {
  return btp[(y / res) * (W / res) + x / res];
}

__global__ void border_kernel(const uint8_t* occ, const int32_t* btp, const int32_t* geo0,
                              int H, int W, int res, int P, const int32_t* tbl,
                              int32_t* counts, int32_t* lst, int32_t* dmap, uint8_t* cur) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i - (i / W) * W;
  const int braw = block_of(btp, y, x, res, W);
  const bool occp = occ[i] != 0 && braw > 0;
  if (geo0 != nullptr) {
    dmap[i] = occp ? geo0[i] : 0;
    cur[i] = occp ? 1 : 0;
  }
  if (!occp) return;
  bool full = true;
  for (int k = 0; k < 12 && full; ++k) {
    const int ny = y + offs12[k][0], nx = x + offs12[k][1];
    full = ny >= 0 && ny < H && nx >= 0 && nx < W && occ[ny * W + nx] != 0 &&
           block_of(btp, ny, nx, res, W) == braw;
  }
  if (full) return;
  atomicAdd(&counts[0], 1);
  if (lst != nullptr && P > 0 && tbl[min(braw - 1, P - 1) * NF + AX45] == 0)
    lst[atomicAdd(&counts[1], 1)] = i;
}

__global__ void project_kernel(const int32_t* lst, const int32_t* geo0, const int32_t* btp,
                               const int32_t* tbl, const int32_t* dmap, int n_pts, int P,
                               int H, int W, int res, int thr, int32_t* nd_key) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_pts) * P) return;
  const int b = static_cast<int>(t / P), p = static_cast<int>(t - static_cast<long long>(b) * P);
  const int i = lst[b];
  const int y = i / W, x = i - (i / W) * W;
  const int pid_raw = block_of(btp, y, x, res, W) - 1;
  if (pid_raw == p) return;
  const int pid = min(pid_raw, P - 1);
  const int32_t* q = tbl + p * NF;
  if (q[SU0] <= 0 || q[AX45] != 0) return;
  // the border pixel's D0 point in its own patch
  const int32_t* s = tbl + pid * NF;
  const int g = geo0[i];
  const int dabs = s[MODE] == 0 ? s[D1] + g : max(s[D1] - g, 0);
  const int lx = x - s[U0] * res, ly = y - s[V0] * res;
  const int su = s[SU0] * res, sv = s[SV0] * res;
  int u = lx, v = ly;
  switch (s[ORI]) {
    case 1: u = ly; v = lx; break;
    case 2: u = ly; v = sv - 1 - lx; break;
    case 3: u = su - 1 - lx; v = sv - 1 - ly; break;
    case 4: u = su - 1 - ly; v = lx; break;
    case 5: u = su - 1 - lx; v = ly; break;
    case 6: u = su - 1 - ly; v = sv - 1 - lx; break;
    case 7: u = lx; v = sv - 1 - ly; break;
    default: break;
  }
  const int vals[3] = {dabs, u + s[U1], v + s[V1]};
  int world[3];
  for (int c = 0; c < 3; ++c)
    world[c] = (s[NA] == c ? vals[0] : 0) + (s[TA] == c ? vals[1] : 0) + (s[BA] == c ? vals[2] : 0);
  // its projection into patch p
  const int d = q[MODE] == 0 ? world[q[NA]] - q[D1] : q[D1] - world[q[NA]];
  const int pu = world[q[TA]] - q[U1], pv = world[q[BA]] - q[V1];
  const int psu = q[SU0] * res, psv = q[SV0] * res;
  if (pu < 0 || pu >= psu || pv < 0 || pv >= psv || d < 0 || d >= (1 << kDShift)) return;
  int cx = pu, cy = pv;
  switch (q[ORI]) {
    case 1: cx = pv; cy = pu; break;
    case 2: cx = psv - 1 - pv; cy = pu; break;
    case 3: cx = psu - 1 - pu; cy = psv - 1 - pv; break;
    case 4: cx = pv; cy = psu - 1 - pu; break;
    case 5: cx = psu - 1 - pu; cy = pv; break;
    case 6: cx = psv - 1 - pv; cy = psu - 1 - pu; break;
    case 7: cx = pu; cy = psv - 1 - pv; break;
    default: break;
  }
  const int px = cx + q[U0] * res, py = cy + q[V0] * res;
  const int pxc = min(max(px, 0), W - 1), pyc = min(max(py, 0), H - 1);
  if (block_of(btp, pyc, pxc, res, W) - 1 != p) return;
  const int diff = abs(d - dmap[pyc * W + pxc]);
  if (diff > thr) return;
  const long long flat = static_cast<long long>(py) * W + px;
  if (flat < 0 || flat >= static_cast<long long>(H) * W) return;
  atomicMin(&nd_key[flat], (diff << kDShift) | d);
}

__global__ void pass_kernel(const uint8_t* cur, const int32_t* btp, const int32_t* dmap,
                            const int32_t* nd_key, uint8_t* nxt, int H, int W, int res,
                            int fs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  if (cur[i] == 0) {
    nxt[i] = 0;
    return;
  }
  const int y = i / W, x = i - (i / W) * W;
  const int braw = block_of(btp, y, x, res, W);
  auto nb = [&](int dy, int dx) {
    const int ny = y + dy, nx = x + dx;
    return ny >= 0 && ny < H && nx >= 0 && nx < W && cur[ny * W + nx] != 0 &&
           block_of(btp, ny, nx, res, W) == braw;
  };
  const int n4 = nb(0, 1) + nb(0, -1) + nb(1, 0) + nb(-1, 0);
  if (n4 == 4 || n4 == 0) {
    nxt[i] = n4 == 4 ? 1 : 0;
    return;
  }
  int pat = 0;
  for (int k = 0; k < 8; ++k) pat |= (nb(offs8[k][0], offs8[k][1]) ? 1 : 0) << (7 - k);
  const int o = g_orientation[pat];
  const int dx0 = g_dilate[o][0], dx1 = g_dilate[o][1];
  const int dy0 = g_dilate[(o + 2) & 7][0], dy1 = g_dilate[(o + 2) & 7][1];
  const float dP = static_cast<float>(dmap[i]);
  const int ex = min(max(x - dx0, 0), W - 1), ey = min(max(y - dx1, 0), H - 1);
  const float dE = static_cast<float>(dmap[ey * W + ex]);
  const int fsv = fs >> 1;
  float sum_p = 0.f, sum_e = 0.f;
  int cnt = 0;
  for (int a = -fs; a <= fs; ++a) {
    for (int b = -fsv; b <= fsv; ++b) {
      const int du = a * dx0 + b * dy0, dv = a * dx1 + b * dy1;
      const int xx = x + du, yy = y + dv;
      if (xx < 0 || xx >= W || yy < 0 || yy >= H) continue;
      const int key = nd_key[yy * W + xx];
      if (key >= kUndef) continue;
      const float vf = static_cast<float>(key & ((1 << kDShift) - 1));
      const float duf = static_cast<float>(du), dvf = static_cast<float>(dv);
      const float tp = __fsub_rn(vf, dP);
      sum_p = __fadd_rn(sum_p, __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(duf, duf), __fmul_rn(dvf, dvf)), __fmul_rn(tp, tp))));
      const float ax = __fadd_rn(duf, static_cast<float>(dx0));
      const float ay = __fadd_rn(dvf, static_cast<float>(dx1));
      const float az = __fsub_rn(vf, dE);
      sum_e = __fadd_rn(sum_e, __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)), __fmul_rn(az, az))));
      ++cnt;
    }
  }
  nxt[i] = (cnt == 0 || sum_e >= sum_p) ? 1 : 0;
}

}  // namespace

// occ (H, W) uint8, btp (H/res, W/res) int32; counts (2,) int32, zeroed:
// [0] border pixels, [1] compacted border points.  With geo0 (H, W) int32
// and tbl (P, 16) int32: lst (H*W,) int32 receives the compacted pixel
// indices, dmap (H, W) int32 the depth map, cur (H, W) uint8 the pass-0
// occupancy.  geo0 == nullptr counts only.
extern "C" int pbf_border(const uint8_t* occ, const int32_t* btp, const int32_t* geo0,
                          int H, int W, int res, int P, const int32_t* tbl, int32_t* counts,
                          int32_t* lst, int32_t* dmap, uint8_t* cur, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  border_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      occ, btp, geo0, H, W, res, P, tbl, counts, lst, dmap, cur);
  return static_cast<int>(cudaGetLastError());
}

// nd_key (H, W) int32, filled with 1 << 29: receives the scatter-min keys of
// the n_pts border points' projections into the P patches.
extern "C" int pbf_project(const int32_t* lst, const int32_t* geo0, const int32_t* btp,
                           const int32_t* tbl, const int32_t* dmap, int n_pts, int P, int H,
                           int W, int res, int thr, int32_t* nd_key, void* stream) {
  const long long n = static_cast<long long>(n_pts) * P;
  if (n == 0) return 0;
  project_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(lst, geo0, btp, tbl, dmap, n_pts, P,
                                                        H, W, res, thr, nd_key);
  return static_cast<int>(cudaGetLastError());
}

// one filter pass: cur (H, W) uint8 -> nxt (H, W) uint8.
extern "C" int pbf_pass(const uint8_t* cur, const int32_t* btp, const int32_t* dmap,
                        const int32_t* nd_key, uint8_t* nxt, int H, int W, int res, int fs,
                        void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  pass_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      cur, btp, dmap, nd_key, nxt, H, W, res, fs);
  return static_cast<int>(cudaGetLastError());
}
