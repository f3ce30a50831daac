// Kernel D: grid geometry smoothing.
//
// Replaces the XLA program vpcc_tpu/ops/smoothing.py
// `smooth_point_cloud_grid` (smoothing.py:51-131).
//
// One cooperative launch a call, four phases behind grid barriers:
// A. the points' cell box: each block reduces the extent of its points'
//    gridSize^3 cells (clamped to the grid, as the binning clamps them) into
//    a partial of its own;
// B. every block reduces all partials to the same box (no atomics, nothing
//    to reset), and the grid sets the box's cell records, and nothing else,
//    to empty (count and position sums 0, min patch id 2^30, max -1);
// C. a thread a point bins it into its cell: count, position sum and
//    min/max patch id with integer atomics, one set of atomics a distinct
//    cell of a warp (`__match_any_sync` on the cell; kernel C emits a
//    patch's points in raster order, so neighbours often share one).
//    Integer sums are order-free and equal to the reference's float32
//    scatter-add, which holds these integers (< 2^24) exactly;
// D. a thread a point: a point that is not a boundary point, or lies
//    within gridSize / 2 of the grid's faces, cannot move and copies its
//    position without reading a cell; any other point reads its 2x2x2
//    cells (a cell outside the box or the grid reads as count 0 with no
//    load, as the reference's sentinel cell) and computes the trilinear
//    centroid in float32 in the reference's order: for dz, dy, dx the
//    weight (wx*wy)*wz, the centroid and weight-count accumulated as fused
//    multiply-adds (XLA's CPU backend fuses them; the centroid's first add,
//    of the first two corners' products, fuses the first product and
//    rounds the second: found on 11-bit grids, where coordinates near 2047
//    expose the difference), the division by 8*gridSize^3, the floor of the
//    count, then the squared distance as a fused multiply-add chain and the
//    move test against max(threshold, count) * 2.  This file is compiled
//    with --fmad=false, so only the explicit __fmaf_rn calls fuse;
//    divisions are IEEE.
// The cell records (24 bytes: count, three sums, min and max patch id) are
// the caller's scratch, sized for the whole grid (a cloud that spans it
// zeroes it all); only the box's are written.
//
// Bound: bytes.  The points (24 bytes each with patch id and flag) read,
// the positions (12 bytes a point) written; the box's records set and
// gathered (scratch, not counted: at most the 2x2x2 cells of the boundary
// points are read).

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPart = 8;            // ints of a block's partial box
constexpr int kMaxBlocks = 1024;    // partials of the scratch
constexpr int kEmptyMin = 1 << 30;  // the reference's initial min patch id

struct Args {
  const int32_t* pos;   // (M, 3)
  const int32_t* pid;   // (M,)
  const uint8_t* bnd;   // (M,)
  int M, gs, gw;
  float thr;
  int32_t* parts;       // kPart ints a block
  int32_t* cells;       // 6 ints a cell of the box
  int32_t* out;         // (M, 3)
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// min over the block of six values (maxima enter negated); the result is
// in sh[0..5] after the call
__device__ void block_min6(int v[6], int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = __reduce_min_sync(0xFFFFFFFFu, v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sh[8 + k * 32 + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int x = lane < kThreads / 32 ? sh[8 + k * 32 + lane] : INT_MAX;
      const int m = __reduce_min_sync(0xFFFFFFFFu, x);
      if (lane == 0) sh[k] = m;
    }
  }
  __syncthreads();
}

// three blocks an SM (40 registers; two at the 60 it takes unbounded)
__global__ void __launch_bounds__(kThreads, 3)
    grid_smooth_kernel(const __grid_constant__ Args a) {
  __shared__ int sh[8 + 6 * 32];
  cg::grid_group grid = cg::this_grid();
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * kThreads;
  const int gs = a.gs, gw = a.gw;

  // A. this block's share of the box
  int v[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  for (long long i = gtid; i < a.M; i += gstride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = min(max(floordiv(a.pos[3 * i + k], gs), 0), gw - 1);
      v[2 * k] = min(v[2 * k], c);
      v[2 * k + 1] = min(v[2 * k + 1], -c);
    }
  }
  block_min6(v, sh);
  if (threadIdx.x < 6) a.parts[blockIdx.x * kPart + threadIdx.x] = sh[threadIdx.x];
  grid.sync();

  // B. the box from all partials (every block alike), its records emptied
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = INT_MAX;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = min(v[k], __ldcg(a.parts + b * kPart + k));
  }
  block_min6(v, sh);
  const int lo[3] = {sh[0], sh[2], sh[4]};
  const int n[3] = {-sh[1] - sh[0] + 1, -sh[3] - sh[2] + 1, -sh[5] - sh[4] + 1};
  const long long ncell = static_cast<long long>(n[0]) * n[1] * n[2];
  int2* rec = reinterpret_cast<int2*>(a.cells);
  for (long long w = gtid; w < 3 * ncell; w += gstride)
    rec[w] = w % 3 == 2 ? make_int2(kEmptyMin, -1) : make_int2(0, 0);
  grid.sync();

  // C. the points binned, one set of atomics a distinct cell of a warp
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < a.M;
       base += gstride) {
    const long long i = base + threadIdx.x;
    const bool live = i < a.M;
    int p[3] = {0, 0, 0}, id = 0;
    unsigned cid = 0xFFFFFFFFu;   // fewer cells than that: 6 ints each fit the scratch
    if (live) {
      cid = 0;
#pragma unroll
      for (int k = 2; k >= 0; --k) {
        p[k] = a.pos[3 * i + k];
        cid = cid * n[k] + min(max(floordiv(p[k], gs), 0), gw - 1) - lo[k];
      }
      id = a.pid[i];
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, cid);
    const int sx = __reduce_add_sync(peers, p[0]);
    const int sy = __reduce_add_sync(peers, p[1]);
    const int sz = __reduce_add_sync(peers, p[2]);
    const int pmin = __reduce_min_sync(peers, id);
    const int pmax = __reduce_max_sync(peers, id);
    if (live && (threadIdx.x & 31) == __ffs(peers) - 1) {
      int32_t* c = a.cells + 6LL * cid;
      atomicAdd(c, __popc(peers));
      atomicAdd(c + 1, sx);
      atomicAdd(c + 2, sy);
      atomicAdd(c + 3, sz);
      atomicMin(c + 4, pmin);
      atomicMax(c + 5, pmax);
    }
  }
  grid.sync();

  // D. a thread a point
  const int half = gs / 2;
  const int disth = max(gs / 2, 1);
  const int th = gs * gw;
  const float denom = static_cast<float>(8 * gs * gs * gs);
  for (long long i = gtid; i < a.M; i += gstride) {
    int p[3];
    bool inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = a.pos[3 * i + k];
      inb = inb && p[k] >= disth && p[k] + disth < th;
    }
    bool move = false;
    float c4[3] = {0.f, 0.f, 0.f};
    if (a.bnd[i] && inb) {
      int s[3], w[3], q[3];
      float cur[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int p2 = floordiv(p[k], gs);
        const int p3 = p[k] - p2 * gs;
        s[k] = p2 + (p3 < half ? -1 : 0);
        w[k] = (p[k] - s[k] * gs - half) * 2 + 1;
        q[k] = 2 * gs - w[k];
        cur[k] = static_cast<float>(p[k]);
      }
      bool any_smooth = false;
      float cent0[3] = {0.f, 0.f, 0.f};
      float wgt0 = 0.f;
      float wcount = 0.f;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int dx = corner & 1, dy = (corner >> 1) & 1, dz = corner >> 2;
        const int rx = s[0] + dx - lo[0], ry = s[1] + dy - lo[1], rz = s[2] + dz - lo[2];
        int cc = 0;
        int sum[3] = {0, 0, 0};
        if (rx >= 0 && rx < n[0] && ry >= 0 && ry < n[1] && rz >= 0 && rz < n[2]) {
          const int2* r = rec + 3 * ((static_cast<long long>(rz) * n[1] + ry) * n[0] + rx);
          const int2 r0 = r[0], r1 = r[1], r2 = r[2];
          cc = r0.x;
          sum[0] = r0.y;
          sum[1] = r1.x;
          sum[2] = r1.y;
          any_smooth = any_smooth || (cc > 0 && r2.x != r2.y);
        }
        const float ccf = static_cast<float>(max(cc, 1));
        const float wx = static_cast<float>(dx == 0 ? q[0] : w[0]);
        const float wy = static_cast<float>(dy == 0 ? q[1] : w[1]);
        const float wz = static_cast<float>(dz == 0 ? q[2] : w[2]);
        const float wgt = __fmul_rn(__fmul_rn(wx, wy), wz);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float cent = cc > 0 ? __fdiv_rn(static_cast<float>(sum[k]), ccf) : cur[k];
          if (corner == 0) {
            cent0[k] = cent;  // XLA fuses the first product into the first add
          } else if (corner == 1) {
            c4[k] = __fmaf_rn(cent0[k], wgt0, __fmul_rn(cent, wgt));
          } else {
            c4[k] = __fmaf_rn(cent, wgt, c4[k]);
          }
        }
        if (corner == 0) wgt0 = wgt;
        wcount = __fmaf_rn(wgt, static_cast<float>(cc), wcount);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) c4[k] = __fdiv_rn(c4[k], denom);
      const float cnt = floorf(__fdiv_rn(wcount, denom));
      if (any_smooth && cnt > 0.f) {
        float diff[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          diff[k] = __fsub_rn(__fmul_rn(cur[k], cnt), __fmul_rn(c4[k], cnt));
        float ss = __fmul_rn(diff[0], diff[0]);
        ss = __fmaf_rn(diff[1], diff[1], ss);
        ss = __fmaf_rn(diff[2], diff[2], ss);
        const float dist2 = __fadd_rn(__fdiv_rn(ss, fmaxf(cnt, 1.f)), 0.5f);
        move = dist2 >= __fmul_rn(fmaxf(a.thr, cnt), 2.f);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a.out[3 * i + k] = move ? static_cast<int>(floorf(__fadd_rn(c4[k], 0.5f))) : p[k];
  }
}

}  // namespace

// pos (M, 3) int32, pid (M,) int32, bnd (M,) bool, out (M, 3) int32;
// scratch: kPart * 1024 int32 of partials, then 6 int32 a cell of the
// whole gw^3 grid (only the points' box is written).  One cooperative
// launch.
extern "C" int grid_smooth(const int32_t* pos, const int32_t* pid, const uint8_t* bnd, int M,
                           float thr, int gs, int gw, int32_t* scratch, int32_t* out,
                           void* stream) {
  static int most = 0;
  if (M == 0) return 0;
  if (gs < 1 || gw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (most == 0) {
    int device = 0, sms = 0, fit = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, grid_smooth_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    most = sms * fit < kMaxBlocks ? sms * fit : kMaxBlocks;
  }
  const long long need = (static_cast<long long>(M) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < most ? need : most);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args a;
  a.pos = pos;
  a.pid = pid;
  a.bnd = bnd;
  a.M = M;
  a.gs = gs;
  a.gw = gw;
  a.thr = thr;
  a.parts = scratch;
  a.cells = scratch + kPart * kMaxBlocks;
  a.out = out;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_smooth_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
