// Kernel W: the dilation, harmonic and smoothed background fills of a stack
// of attribute planes that share one occupancy.
//
// Replaces the XLA programs vpcc_tpu/ops/padding.py `dilate_fill`
// (padding.py:78), `harmonic_fill` (:109; its pyramid comes from kernel L's
// `push_levels`) and `smooth_fill` (:58), as `fill_rgb` (:176) runs them on
// the attribute images under attributeBGFill 0 and 2.  Every stencil wraps
// around the plane, as the reference's jnp.roll.  Entry points:
// * bg_dilate: the whole dilation in three launches, a frontier walked level
//   by level.  The reference's pass k fills every empty pixel with a filled
//   4-neighbour; that is exactly the ring of pixels at 4-connected distance
//   k (on the torus) from the occupied set (on the bench frame a median of
//   2,560 of the plane's 1.6 M pixels).  pass_of (H, W) is each pixel's
//   level stamp: 0 occupied, k once claimed for level k, INT_MAX never
//   reached.  A pixel's values live in 32-byte records (kGroup planes each)
//   during the walk, so that a neighbour's planes are two 16-byte loads.
//   1. dilate_seed, a thread a pixel: pass_of; each empty pixel with an
//      occupied neighbour claimed for level 1 and listed (one atomic a warp);
//      each occupied pixel with an empty neighbour (the seed frontier)
//      writes its record, image * 1;
//   2. dilate_levels, one cluster of kCluster CTAs on neighbouring SMs,
//      persistent: level k takes its list (item i to CTA i % kCluster), a
//      thread a pixel, and computes what the reference's pass k computes
//      there, every plane in one thread: the neighbours up, down, left,
//      right, f = pass_of < k, wsum summed from f[0], v = ((up + down) +
//      left) + right over the filled ones' values, rint(v / max(wsum, 1)).
//      A neighbour claimed meanwhile for level k + 1 reads k + 1, not below
//      k: the level runs in place and still sees the state before it.  The
//      stamps come back from the claims, atomicCAS of each neighbour's stamp
//      from INT_MAX to k + 1 (a pixel listed once) while k + 1 <= max_iters,
//      issued after the loads of every neighbour's record (used where
//      filled), so that a level is three dependent round trips (the list,
//      the records and claims, the next list's counter) and a cluster
//      barrier.  The claimed pixels are listed (one atomic a warp).  An
//      empty list ends the walk, read on the device.  Every listed pixel
//      fills, so the levels run are the passes that filled a pixel;
//   3. dilate_finish, a thread a pixel: occupied pixels the image, filled
//      ones their record, unreached ones image * 0 (the reference's x); into
//      x, or rounded half to even and clipped into an int32 output.
//   The lists ping-pong in scratch; their counters rotate over three words,
//   each zeroed a level before it counts, and all three left at 0 for the
//   next call.
// * bg_pull: one pyramid level of the pull: (top || weight > 0) ? value /
//   max(weight, 1) : the parent's fill; level 0 reads the image and the
//   occupancy (value = image * occupancy, weight = occupancy).
// * bg_relax: n Jacobi steps, ((up + down) + left) + right times 0.25, the
//   pixels whose mask (the level's weight, or the occupancy) is above 0 held
//   at their value; ping-pong between x and tmp, the result in x.
// * bg_finish: the occupied pixels take the image; optionally the planes are
//   rounded half to even and clipped into an int32 output.
// Float operations are single IEEE roundings (built with --fmad=false), in the
// order of the reference's XLA CPU program.
//
// Bound: bytes.  The dilation reads the planes and the occupancy once and
// writes the filled planes once; its floor is its chain of levels, each a
// cluster barrier (0.48 us for 16 CTAs of 256 threads on an H100) behind
// three dependent memory round trips.  The harmonic fill's 9 levels x 9
// launches are launch-bound.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kEmpty = INT_MAX;
constexpr int kSeedThreads = 256;
constexpr int kCluster = 16;           // CTAs of the level walk (one GPC)
constexpr int kLevelThreads = 256;     // threads a CTA of the level walk
constexpr int kGroup = 8;              // planes a value record holds (32 bytes)
// scratch words: three rotating list counters and the passes run (the
// header, kHeader words, padded to 16), the value records (groups x hw x
// kGroup floats), pass_of (hw) and the two lists (hw each)
constexpr int kHeader = 4;
constexpr int kRecords = 16;

struct Dilate {
  const int32_t* img;
  float* x;
  float* rec;         // a pixel's values, kGroup planes a record, groups x hw records
  int32_t* cnt;       // kHeader words
  int32_t* pass_of;
  int32_t* list[2];   // level k's list is list[k & 1]
  int C, H, W, max_iters, groups;
};

// a 16-byte load through L2, as volatile asm: the compiler keeps it where it
// stands, ahead of the claims' atomics, so that both round trips overlap
__device__ __forceinline__ float4 load_early(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// the two 16-byte halves of pixel p's record of group g
__device__ __forceinline__ float4* record(const Dilate& a, int g, int p) {
  return reinterpret_cast<float4*>(a.rec + (static_cast<int64_t>(g) * a.H * a.W + p) * kGroup);
}

__device__ __forceinline__ void neighbours(int p, int H, int W, int nb[4]) {
  const int y = p / W, xx = p - y * W;
  nb[0] = (y == 0 ? H - 1 : y - 1) * W + xx;   // up (roll +1 on rows)
  nb[1] = (y == H - 1 ? 0 : y + 1) * W + xx;   // down
  nb[2] = y * W + (xx == 0 ? W - 1 : xx - 1);  // left
  nb[3] = y * W + (xx == W - 1 ? 0 : xx + 1);  // right
}

// Appends this lane's entries q[j] for the bits j of `take` to list at
// *count (one atomic a warp); every lane of the warp calls it.
__device__ __forceinline__ void warp_append(unsigned take, const int q[4], int32_t* count,
                                            int32_t* list) {
  const int lane = threadIdx.x & 31;
  const int m = __popc(take);
  int incl = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (total == 0) return;
  int base = 0;
  if (lane == 31) base = atomicAdd(count, total);
  base = __shfl_sync(0xFFFFFFFFu, base, 31) + incl - m;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((take >> j) & 1u) list[base++] = q[j];
}

__global__ void __launch_bounds__(kSeedThreads) dilate_seed(const uint8_t* __restrict__ occ,
                                                            Dilate a) {
  const int hw = a.H * a.W;
  const int p = blockIdx.x * kSeedThreads + threadIdx.x;
  const int q[4] = {p, 0, 0, 0};
  unsigned take = 0;
  if (p < hw) {
    int nb[4];
    neighbours(p, a.H, a.W, nb);
    const bool o = occ[p] != 0;
    const int around = occ[nb[0]] + occ[nb[1]] + occ[nb[2]] + occ[nb[3]];
    int lv = kEmpty;
    if (o) {
      lv = 0;
      if (around < 4 && a.max_iters >= 1)   // the seed frontier: its record, image * 1
        for (int g = 0; g < a.groups; ++g) {
          float v[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int c = g * kGroup + u;
            v[u] = c < a.C ? static_cast<float>(a.img[static_cast<int64_t>(c) * hw + p]) : 0.0f;
          }
          float4* r = record(a, g, p);
          r[0] = make_float4(v[0], v[1], v[2], v[3]);
          r[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    } else if (a.max_iters >= 1 && around != 0) {
      lv = 1;
    }
    a.pass_of[p] = lv;
    take = lv == 1;
  }
  warp_append(take, q, a.cnt + 1, a.list[1]);
}

__global__ void __launch_bounds__(kLevelThreads, 1) dilate_levels(const __grid_constant__ Dilate a) {
  const int hw = a.H * a.W;
  // item i of a list goes to CTA i % gridDim.x: a short list still spreads
  // over every SM of the walk (their load pipes, not the latency, bound a
  // level whose items sit on a few SMs)
  const int vid = threadIdx.x * gridDim.x + blockIdx.x;
  const int stride = gridDim.x * kLevelThreads;
  const int cap = hw;   // a list's capacity
  int k = 1;
  for (;; ++k) {
    // this thread's first item read with the count (whatever lies there
    // when the list is shorter is not used)
    const int first = vid < cap ? __ldcg(a.list[k & 1] + vid) : 0;
    const int n = __ldcg(a.cnt + k % 3);
    if (n == 0) break;
    if (vid == 0) a.cnt[(k + 2) % 3] = 0;   // counts level k + 2; read last at level k - 1
    const int32_t* cur = a.list[k & 1];
    int32_t* nxt = a.list[(k + 1) & 1];
    const bool claim = k + 1 <= a.max_iters;
    for (int i0 = 0; i0 < n; i0 += stride) {   // the same trips for every lane
      const int i = i0 + vid;
      int nb[4] = {0, 0, 0, 0};
      unsigned take = 0;   // the neighbours this pixel claims
      if (i < n) {
        const int p = i0 == 0 ? first : __ldcg(cur + i);
        neighbours(p, a.H, a.W, nb);
        // one round trip: every neighbour's record of group 0 (used where
        // filled), then its stamp, which comes back from the claim
        // (atomicCAS returns the stamp it found: INT_MAX where it claimed)
        float4 t[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4* r = record(a, 0, nb[j]);
          t[j][0] = load_early(r);
          t[j][1] = load_early(r + 1);
        }
        int pf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[j] = claim ? atomicCAS(a.pass_of + nb[j], kEmpty, k + 1) : __ldcg(a.pass_of + nb[j]);
        bool f[4];
        float wsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[j] = pf[j] < k;
          wsum = j == 0 ? (f[0] ? 1.0f : 0.0f) : __fadd_rn(wsum, f[j] ? 1.0f : 0.0f);
        }
        const float den = fmaxf(wsum, 1.0f);
        for (int g = 0; g < a.groups; ++g) {
          if (g > 0) {   // planes beyond the first kGroup: another round trip
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4* r = record(a, g, nb[j]);
              t[j][0] = __ldcg(r);
              t[j][1] = __ldcg(r + 1);
            }
          }
          float v[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const float e[4] = {(&t[0][u >> 2].x)[u & 3], (&t[1][u >> 2].x)[u & 3],
                                (&t[2][u >> 2].x)[u & 3], (&t[3][u >> 2].x)[u & 3]};
            float s = f[0] ? e[0] : 0.0f;
#pragma unroll
            for (int j = 1; j < 4; ++j) s = __fadd_rn(s, f[j] ? e[j] : 0.0f);
            v[u] = rintf(__fdiv_rn(s, den));
          }
          float4* r = record(a, g, p);
          r[0] = make_float4(v[0], v[1], v[2], v[3]);
          r[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        if (claim) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (pf[j] == kEmpty) take |= 1u << j;
        }
      }
      warp_append(take, nb, a.cnt + (k + 1) % 3, nxt);
    }
    cg::this_cluster().sync();
  }
  if (vid == 0) {   // every counter read for the last time: leave them at 0
    a.cnt[0] = a.cnt[1] = a.cnt[2] = 0;
    a.cnt[3] = k - 1;
  }
}

__global__ void dilate_finish(const uint8_t* __restrict__ occ, Dilate a,
                              int32_t* __restrict__ out, int lo, int hi) {
  const int hw = a.H * a.W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int pf = a.pass_of[p];
  for (int c = 0; c < a.C; ++c) {
    const int64_t at = static_cast<int64_t>(c) * hw + p;
    const float im = static_cast<float>(a.img[at]);
    const float v = pf == 0         ? im
                    : pf == kEmpty ? __fmul_rn(im, 0.0f)
                                   : a.rec[(static_cast<int64_t>(c / kGroup) * hw + p) * kGroup +
                                           c % kGroup];
    if (out != nullptr) {
      out[at] = static_cast<int32_t>(fminf(fmaxf(rintf(v), static_cast<float>(lo)),
                                           static_cast<float>(hi)));
    } else {
      a.x[at] = v;
    }
  }
}

__global__ void pull_top_or_level(const float* v, const float* wt, const float* parent,
                                  float* fill, int H, int W, int top) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int c = blockIdx.y;
  const float w = wt[i];
  float r;
  if (top || w > 0.0f) {
    r = __fdiv_rn(v[c * hw + i], fmaxf(w, 1.0f));
  } else {
    const int y = static_cast<int>(i / W), x = static_cast<int>(i % W);
    r = parent[static_cast<int64_t>(c) * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
  fill[c * hw + i] = r;
}

__global__ void pull_level0(const int32_t* img, const uint8_t* occ, const float* parent,
                            float* fill, int H, int W, int top) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int c = blockIdx.y;
  const float o = static_cast<float>(occ[i]);
  float r;
  if (top || o > 0.0f) {
    r = __fdiv_rn(__fmul_rn(static_cast<float>(img[c * hw + i]), o), fmaxf(o, 1.0f));
  } else {
    const int y = static_cast<int>(i / W), x = static_cast<int>(i % W);
    r = parent[static_cast<int64_t>(c) * (H / 2) * (W / 2) + (y / 2) * (W / 2) + x / 2];
  }
  fill[c * hw + i] = r;
}

template <typename M>
__global__ void relax_step(const float* xin, float* xout, const M* mask, int H, int W) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int c = blockIdx.y;
  const float* a = xin + c * hw;
  float r;
  if (mask[p] > 0) {
    r = a[p];
  } else {
    const int y = static_cast<int>(p / W), x = static_cast<int>(p % W);
    const float up = a[static_cast<int64_t>(y == 0 ? H - 1 : y - 1) * W + x];
    const float dn = a[static_cast<int64_t>(y == H - 1 ? 0 : y + 1) * W + x];
    const float lf = a[static_cast<int64_t>(y) * W + (x == 0 ? W - 1 : x - 1)];
    const float rt = a[static_cast<int64_t>(y) * W + (x == W - 1 ? 0 : x + 1)];
    r = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt), 0.25f);
  }
  xout[c * hw + p] = r;
}

__global__ void finish_kernel(float* fill, const int32_t* img, const uint8_t* occ,
                              int32_t* out, int C, int64_t hw, int lo, int hi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const bool o = occ[p] != 0;
  for (int c = 0; c < C; ++c) {
    float v = fill[c * hw + p];
    if (o) {
      v = static_cast<float>(img[c * hw + p]);
      fill[c * hw + p] = v;
    }
    if (out != nullptr)
      out[c * hw + p] = static_cast<int32_t>(fminf(fmaxf(rintf(v), static_cast<float>(lo)),
                                                   static_cast<float>(hi)));
  }
}

inline unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// The level walk `kernel` (one argument, *arg) as one cluster of kCluster
// CTAs; an error where the card cannot place it.
cudaError_t launch_walk(const void* kernel, void* arg, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  void* args[] = {arg};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kLevelThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

}  // namespace

// The int32 words of scratch bg_dilate takes for C planes of hw pixels.
extern "C" long long bg_dilate_scratch_words(int C, long long hw) {
  return kRecords + (static_cast<long long>(C) + kGroup - 1) / kGroup * kGroup * hw + 3 * hw;
}

// img (C, H, W) int32; occ (H, W) uint8; x (C, H, W) float32; scratch:
// bg_dilate_scratch_words(C, H * W) int32 words, 16-byte aligned, its first
// three zero (each call leaves them so); out (C, H, W) int32 or null.  The dilation of up to
// max_iters passes: with out, rint(fill) clipped to lo..hi into out; without,
// the float fill in x.  The passes that filled a pixel land in scratch[3].
// Three launches (`*launched`); H * W below 2^31.
extern "C" int bg_dilate(const int32_t* img, const uint8_t* occ, float* x, int32_t* scratch,
                         int32_t* out, int C, int H, int W, int max_iters, int lo, int hi,
                         void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int64_t hw64 = static_cast<int64_t>(H) * W;
  if (hw64 == 0 || C == 0) return 0;
  if (hw64 >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int hw = static_cast<int>(hw64);
  Dilate a;
  a.img = img;
  a.x = x;
  a.groups = (C + kGroup - 1) / kGroup;
  a.cnt = scratch;
  a.rec = reinterpret_cast<float*>(scratch + kRecords);
  a.pass_of = scratch + kRecords + static_cast<int64_t>(a.groups) * hw * kGroup;
  a.list[0] = a.pass_of + hw;
  a.list[1] = a.list[0] + hw;
  a.C = C;
  a.H = H;
  a.W = W;
  a.max_iters = max_iters;
  dilate_seed<<<blocks_for(hw, kSeedThreads), kSeedThreads, 0, st>>>(occ, a);
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_walk(reinterpret_cast<const void*>(dilate_levels), &a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  dilate_finish<<<blocks_for(hw, 256), 256, 0, st>>>(occ, a, out, lo, hi);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// One pull level of fill (C, H, W): level 0 when img is given (with occ),
// else from v (C, H, W) and w (H, W); parent (C, H/2, W/2) unless top.
extern "C" int bg_pull(const int32_t* img, const uint8_t* occ, const float* v,
                       const float* w, const float* parent, float* fill, int C, int H,
                       int W, int top, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (hw == 0 || C == 0) return 0;
  const dim3 grid(blocks_for(hw, 256), C);
  if (img != nullptr) {
    pull_level0<<<grid, 256, 0, st>>>(img, occ, parent, fill, H, W, top);
  } else {
    pull_top_or_level<<<grid, 256, 0, st>>>(v, w, parent, fill, H, W, top);
  }
  return static_cast<int>(cudaGetLastError());
}

// n Jacobi steps of x (C, H, W) float32 in place (tmp: C * H * W floats);
// mask (H, W): uint8 when mask_u8, else float32.
extern "C" int bg_relax(float* x, float* tmp, const void* mask, int mask_u8, int C, int H,
                        int W, int n, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  *launched = 0;
  if (hw == 0 || C == 0 || n <= 0) return 0;
  const dim3 grid(blocks_for(hw, 256), C);
  float* bufs[2] = {x, tmp};
  for (int s = 0; s < n; ++s) {
    const float* in = bufs[s & 1];
    float* out = bufs[(s + 1) & 1];
    if (mask_u8) {
      relax_step<uint8_t><<<grid, 256, 0, st>>>(in, out, static_cast<const uint8_t*>(mask),
                                                H, W);
    } else {
      relax_step<float><<<grid, 256, 0, st>>>(in, out, static_cast<const float*>(mask), H, W);
    }
    ++*launched;
  }
  if (n & 1) {
    cudaMemcpyAsync(x, tmp, sizeof(float) * C * hw, cudaMemcpyDeviceToDevice, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// fill (C, H, W) float32: the occupied pixels take img; with out (C, H, W)
// int32, rint(fill) clipped to lo..hi.
extern "C" int bg_finish(float* fill, const int32_t* img, const uint8_t* occ, int32_t* out,
                         int C, int hw, int lo, int hi, void* stream) {
  if (hw == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  finish_kernel<<<blocks_for(hw, 256), 256, 0, st>>>(fill, img, occ, out, C, hw, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
