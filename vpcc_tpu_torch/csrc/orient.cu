// Kernel X: normal orientation toward a viewpoint and by the spanning-tree
// flood (K10, normalOrientation 2 and 4).
//
// Replaces the XLA programs vpcc_tpu/ops/normals.py
// `orient_normals_viewpoint` (:146) and `orient_normals_spanning_tree`
// (:158).  Entry points, one thread per voxel each:
//   orient_viewpoint  sign of dot(n, viewpoint - position), +1 at 0, times n
//                     (one launch);
//   flood_seed        the seed: the first row of the largest int32 key
//                     z * 2^22 + y * 2^11 + x (wrapping, as the reference
//                     computes it without 64-bit integers; 0 for invalid
//                     rows), a warp max then one 64-bit atomicMax per warp;
//                     then every sign 0 but the seed's, +1 or -1 by the
//                     seed normal's z (two launches);
//   flood_step        one synchronous sweep sign_in -> sign_out: an
//                     unsigned valid row whose vote
//                     sum_k dot(n[nn[k]], n) * sign[nn[k]] (valid k, in
//                     order from 0) exceeds 1e-6 in magnitude takes the
//                     vote's sign and sets flags[it]; a sweep after one that
//                     signed nothing only copies (launched once per sweep,
//                     ping-pong, the host reading the flags every few
//                     sweeps);
//   flood_finish      rows still unsigned take the radial sign about the
//                     centroid; times n (one launch).
//
// Float32 in the reference's operation order: the 3-term dot products are
// XLA's fma(a2, b2, fma(a1, b1, a0 * b0)) and the vote sums over k in order
// from 0, both found with crafted inputs against the reference
// (tests/test_torch_orientation.py).  This file is compiled with
// --fmad=false, so only the explicit __fmaf_rn calls fuse.
//
// Bound: bytes.  A flood sweep reads the neighbour table (V x K int32 +
// bool), gathers the neighbours' normals and signs (mostly from L2) and
// writes the signs: ~16 MB for 168k voxels at K=16.  The viewpoint pass and
// the finish move a few MB: launch-bound.  The sweeps are one launch each
// because a sweep must see only the signs of the one before (the
// reference's update is synchronous).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// XLA's a0*b0 + a1*b1 + a2*b2 as a reduce: fma(a2, b2, fma(a1, b1, a0*b0)).
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fma_(a[2], b[2], fma_(a[1], b[1], mul(a[0], b[0])));
}

__global__ void viewpoint_kernel(const float* __restrict__ normals,
                                 const int32_t* __restrict__ pos, int V, float vx,
                                 float vy, float vz, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const long long r = 3 * static_cast<long long>(i);
  const float t[3] = {sub(vx, static_cast<float>(pos[r])),
                      sub(vy, static_cast<float>(pos[r + 1])),
                      sub(vz, static_cast<float>(pos[r + 2]))};
  const float* n = normals + r;
  const float s = dot3(n, t) < 0.f ? -1.f : 1.f;
  for (int c = 0; c < 3; ++c) out[r + c] = mul(n[c], s);
}

// (key biased to unsigned) << 32 | (0xFFFFFFFF - row): the largest packed
// value is the first row of the largest key.
__device__ __forceinline__ unsigned long long pack_key(int32_t key, int i) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(i));
}

__global__ void seed_max_kernel(const int32_t* __restrict__ pos,
                                const uint8_t* __restrict__ valid, int V,
                                unsigned long long* __restrict__ best) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long v = 0ull;
  if (i < V) {
    const long long r = 3 * static_cast<long long>(i);
    // int32 arithmetic that wraps, as XLA's
    const uint32_t k = static_cast<uint32_t>(pos[r + 2]) * (1u << 22) +
                       static_cast<uint32_t>(pos[r + 1]) * (1u << 11) +
                       static_cast<uint32_t>(pos[r]);
    v = pack_key(valid[i] ? static_cast<int32_t>(k) : 0, i);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, v, off);
    v = o > v ? o : v;
  }
  if ((threadIdx.x & 31) == 0 && v) atomicMax(best, v);
}

__global__ void seed_init_kernel(const float* __restrict__ normals, int V, int pad_rows,
                                 const unsigned long long* __restrict__ best,
                                 float* __restrict__ sign) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const unsigned long long b = *best;
  const int32_t key = static_cast<int32_t>(static_cast<uint32_t>(b >> 32) ^ 0x80000000u);
  const long long seed = 0xFFFFFFFFll - static_cast<long long>(b & 0xFFFFFFFFull);
  // the reference's padded rows (key 0) win only over all-negative keys
  const bool none = pad_rows && key < 0;
  float s = 0.f;
  if (!none && i == seed) s = normals[3 * seed + 2] < 0.f ? -1.f : 1.f;
  sign[i] = s;
}

__global__ void flood_step_kernel(const float* __restrict__ normals,
                                  const int32_t* __restrict__ nn_idx,
                                  const uint8_t* __restrict__ nn_valid,
                                  const uint8_t* __restrict__ valid, int V, int K,
                                  const float* __restrict__ sign_in,
                                  float* __restrict__ sign_out, int32_t* __restrict__ flags,
                                  int it) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const float si = sign_in[i];
  // after a sweep that signed nothing every later sweep is the same: copy
  if ((it > 0 && flags[it - 1] == 0) || si != 0.f || !valid[i]) {
    sign_out[i] = si;
    return;
  }
  const float* b = normals + 3 * static_cast<long long>(i);
  float vote = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(i) * K + k;
    if (!nn_valid[e]) continue;   // a masked term adds a zero: no change
    const int j = nn_idx[e];
    vote = add(vote, mul(dot3(normals + 3 * static_cast<long long>(j), b), sign_in[j]));
  }
  if (fabsf(vote) > 1e-6f) {
    sign_out[i] = vote < 0.f ? -1.f : 1.f;
    flags[it] = 1;
  } else {
    sign_out[i] = 0.f;
  }
}

__global__ void flood_finish_kernel(const int32_t* __restrict__ pos,
                                    const float* __restrict__ normals, int V, float cx,
                                    float cy, float cz, const float* __restrict__ sign,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V) return;
  const long long r = 3 * static_cast<long long>(i);
  const float* n = normals + r;
  float s = sign[i];
  if (s == 0.f) {   // never reached: the radial sign
    const float o[3] = {sub(static_cast<float>(pos[r]), cx),
                        sub(static_cast<float>(pos[r + 1]), cy),
                        sub(static_cast<float>(pos[r + 2]), cz)};
    s = dot3(n, o) < 0.f ? -1.f : 1.f;
  }
  for (int c = 0; c < 3; ++c) out[r + c] = mul(n[c], s);
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// normals (V, 3) float32, pos (V, 3) int32 -> out (V, 3).  One launch.
extern "C" int orient_viewpoint(const float* normals, const int32_t* pos, int V, float vx,
                                float vy, float vz, float* out, void* stream) {
  if (V == 0) return 0;
  viewpoint_kernel<<<blocks_for(V, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      normals, pos, V, vx, vy, vz, out);
  return static_cast<int>(cudaGetLastError());
}

// best: one zeroed uint64; sign (V,) float32 written.  Two launches.
extern "C" int flood_seed(const int32_t* pos, const float* normals, const uint8_t* valid,
                          int V, int pad_rows, unsigned long long* best, float* sign,
                          void* stream) {
  if (V == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seed_max_kernel<<<blocks_for(V, 256), 256, 0, s>>>(pos, valid, V, best);
  seed_init_kernel<<<blocks_for(V, 256), 256, 0, s>>>(normals, V, pad_rows, best, sign);
  return static_cast<int>(cudaGetLastError());
}

// One sweep sign_in -> sign_out; flags (256,) int32 zeroed, flags[it] set
// when the sweep signs a row.  One launch.
extern "C" int flood_step(const float* normals, const int32_t* nn_idx,
                          const uint8_t* nn_valid, int V, int K, const uint8_t* valid,
                          const float* sign_in, float* sign_out, int it, int32_t* flags,
                          void* stream) {
  if (V == 0) return 0;
  flood_step_kernel<<<blocks_for(V, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      normals, nn_idx, nn_valid, valid, V, K, sign_in, sign_out, flags, it);
  return static_cast<int>(cudaGetLastError());
}

// Radial sign for the unsigned rows, about (cx, cy, cz); out (V, 3).  One
// launch.
extern "C" int flood_finish(const int32_t* pos, const float* normals, int V, float cx,
                            float cy, float cz, const float* sign, float* out,
                            void* stream) {
  if (V == 0) return 0;
  flood_finish_kernel<<<blocks_for(V, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, normals, V, cx, cy, cz, sign, out);
  return static_cast<int>(cudaGetLastError());
}
