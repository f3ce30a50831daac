// Kernel C: per-pixel point reconstruction with boundary flags and
// valid-first compaction.
//
// Replaces the XLA programs vpcc_tpu/ops/reconstruct.py
// `generate_point_cloud` (reconstruct.py:61, with its EOM branch :136-143),
// vpcc_tpu/ops/smoothing.py
// `boundary_pixels` (smoothing.py:24) and the cumsum-scatter compaction of
// vpcc_tpu/pipeline.py `_recon_phase2` (pipeline.py:84-97).
//
// Per pixel: the owning patch from block-to-patch, the inverse packing
// orientation to patch (u, v), the D0 point and — where the D1 map differs
// from D0 — the D1 point, with LOD scaling and the 45-degree inverse
// rotations (arithmetic >> 1).  With an EOM plane (enhancedOccupancyMapCode)
// each set bit k < eom_bits of the pixel's code adds an EOM point at
// directed depth D0 + k + 1 (max(., 0) in projection mode 1), layer tag 2
// (vpcc_tpu/pipeline.py:79-82).  The boundary flag looks at the 8
// neighbours with wrap-around at the image edge (the reference uses
// jnp.roll).
//
// Design: tiles of kTile = 2048 consecutive raster pixels, a block of 512
// threads a tile, 4 pixels a thread (the occupancy read as a 4-byte word,
// the int32 planes as int4 where aligned).  Two launches:
// * count_kernel counts each tile's points (v0 + v1 + popcount of the EOM
//   bits) into a per-tile array and adds them to the call's total (one of
//   two, by the parity of the call; block 0 zeroes the other for the next
//   call, so nothing is reset by a launch of its own).  The wrapper reads
//   the total: the call's one host wait, since the outputs are sized by
//   it.
// * emit_kernel sums the counts of the tiles before its own (its first
//   row), recounts its tile, scans the counts inside the block (warp
//   shuffles), takes each valid pixel's boundary flag from a window of
//   neighbour keys (occupied ? block-to-patch entry : -1, raster pixels
//   p0 - W - 1 .. p0 + kTile + W, four a lookup where W and res allow)
//   staged in shared memory (pixels on an image edge, where the
//   neighbourhood wraps, read the planes), and writes its rows from the
//   tile's offset on, layer order D0, D1, EOM bit 0, 1, ...: each thread
//   marks its pixels' rows in a shared row -> pixel table, kStage rows at a
//   time, and then a thread a row computes and stores it, so consecutive
//   threads store consecutive rows of every field (whole runs, with no
//   thread waiting on another's row count).
// Each tile's rows are one contiguous run of the output, so raster order
// y*W + x, layer-minor, holds with no look-back across blocks: exactly the
// reference's stable compaction of its (H*W, 2 + eom_bits) candidates.  No
// per-pixel count array is stored.  eom == nullptr is the two-layer kernel.
//
// Bound: bytes — one read of the occupancy, both geometry maps, the EOM
// plane and the block map, one write of the compacted rows (29 bytes a
// point).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPix = 4;
constexpr int kTile = kThreads * kPix;
constexpr int kStage = 4096;                  // rows of a tile written at a time
constexpr int kWindow = 6144;                 // neighbour keys staged a tile
// the pixel table (two ints a pixel, a uint16 a row of a chunk) in the
// space of the neighbour keys
constexpr int kSmem = (kWindow * 4 > kTile * 8 + kStage * 2) ? kWindow * 4
                                                              : kTile * 8 + kStage * 2;

enum { U0, V0, SU0, SV0, U1, V1, D1, NA, TA, BA, MODE, ORI, AX45, GBITS, LODX, LODY, NF };

struct Planes {
  const uint8_t* occ;
  const int32_t* g0;
  const int32_t* g1;
  const int32_t* btp;
  const int32_t* eom;   // nullptr: no EOM layers
  unsigned emask;       // the low eom_bits
  int H, W, res, bw;
  bool vec;             // planes aligned for 4- and 16-byte loads
  bool quad;            // vec, and W and res multiples of 4: four raster
                        // pixels from a multiple of 4 share a row and a
                        // block column
};

// A thread's 8 pixels from p on: occupancy, both maps, EOM code, block-map
// entry, and its (x, y); pixels at n and beyond are unoccupied.
struct Pixels {
  int a[kPix], b[kPix], braw[kPix];
  unsigned occ, e[kPix];   // occ: bit k = pixel k occupied
  int x, y;
};

__device__ __forceinline__ void load_pixels(const Planes& P, int p, int n, Pixels& px) {
  int o8[kPix];
  if (P.vec && p + kPix <= n) {
#pragma unroll
    for (int q = 0; q < kPix / 4; ++q) {
      const uint32_t o = reinterpret_cast<const uint32_t*>(P.occ + p)[q];
      const int4 a = reinterpret_cast<const int4*>(P.g0 + p)[q];
      const int4 b = reinterpret_cast<const int4*>(P.g1 + p)[q];
      const int4 e = P.eom ? reinterpret_cast<const int4*>(P.eom + p)[q] : make_int4(0, 0, 0, 0);
      const int av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const int ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o8[4 * q + k] = (o >> (8 * k)) & 0xFF;
        px.a[4 * q + k] = av[k];
        px.b[4 * q + k] = bv[k];
        px.e[4 * q + k] = static_cast<unsigned>(ev[k]) & P.emask;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const bool in = p + k < n;
      o8[k] = in ? P.occ[p + k] : 0;
      px.a[k] = in ? P.g0[p + k] : 0;
      px.b[k] = in ? P.g1[p + k] : 0;
      px.e[k] = in && P.eom ? static_cast<unsigned>(P.eom[p + k]) & P.emask : 0u;
    }
  }
  // block-map entries, stepping x (and the block column) along the row
  int y = p / P.W, x = p - y * P.W;
  px.x = x;
  px.y = y;
  int bx = x / P.res, cx = x - bx * P.res;
  const int32_t* brow = P.btp + (y / P.res) * P.bw;
  px.occ = 0u;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    px.braw[k] = p + k < n ? brow[bx] : 0;
    if (o8[k] != 0 && px.braw[k] > 0) px.occ |= 1u << k;
    if (++cx == P.res) {
      cx = 0;
      ++bx;
    }
    if (++x == P.W) {
      x = 0;
      cx = 0;
      bx = 0;
      ++y;
      brow = P.btp + (min(y, P.H - 1) / P.res) * P.bw;
    }
  }
}

// points of pixel k: v0 + v1 + popcount of its EOM bits
__device__ __forceinline__ int pixel_count(const Pixels& px, int k) {
  const bool v0 = (px.occ >> k) & 1u;
  return v0 ? 1 + (px.a[k] != px.b[k]) + __popc(px.e[k]) : 0;
}

// exclusive scan of v over the block; *total receives the block's sum
__device__ __forceinline__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, s, d);
    if (lane >= d) s += t;
  }
  if (lane == 31) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < kThreads / 32) sh[lane] = w;   // inclusive warp sums
  }
  __syncthreads();
  *total = sh[kThreads / 32 - 1];
  const int before = warp ? sh[warp - 1] : 0;
  __syncthreads();   // read by all before a next scan writes sh
  return before + s - v;
}

// scratch (int32): [0], [1] the total of even and odd calls, [2, 2 + nt)
// the tile counts.  A call adds to total[odd] and zeroes the other for the
// next call.
__global__ void __launch_bounds__(kThreads) count_kernel(Planes P, int* scratch, int odd) {
  __shared__ int sh[32];
  Pixels px;
  load_pixels(P, blockIdx.x * kTile + threadIdx.x * kPix, P.H * P.W, px);
  int c = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) c += pixel_count(px, k);
  int total;
  block_scan(c, sh, &total);
  if (threadIdx.x == 0) {
    scratch[2 + blockIdx.x] = total;
    if (total) atomicAdd(scratch + odd, total);
    if (blockIdx.x == 0) scratch[1 - odd] = 0;
  }
}

// the neighbour key of pixel (x, y): its block-map entry if occupied, else -1
__device__ __forceinline__ int key_at(const Planes& P, int x, int y) {
  return P.occ[y * P.W + x] ? P.btp[(y / P.res) * P.bw + x / P.res] : -1;
}

struct Rows {   // the five fields (the outputs, or a chunk's staging)
  int32_t* pos;
  int32_t* pix;
  int32_t* layer;
  int32_t* pid;
  uint8_t* bnd;
};

// row `row` of the output: layer l of pixel (x, y) (D0, D1 where it differs,
// then the EOM bits low to high)
__device__ __forceinline__ void emit_row(const Rows& o, int row, int l, int x, int y, int a,
                                         int b, unsigned ebits, int braw, bool edge,
                                         const int32_t* __restrict__ ptab, int res) {
  const int pid = braw - 1;
  const int32_t* prm = ptab + pid * NF;
  const int lx = x - prm[U0] * res, ly = y - prm[V0] * res;
  const int su = prm[SU0] * res, sv = prm[SV0] * res;
  int u = lx, v = ly;
  switch (prm[ORI]) {
    case 1: u = ly; v = lx; break;
    case 2: u = ly; v = sv - 1 - lx; break;
    case 3: u = su - 1 - lx; v = sv - 1 - ly; break;
    case 4: u = su - 1 - ly; v = lx; break;
    case 5: u = su - 1 - lx; v = ly; break;
    case 6: u = su - 1 - ly; v = sv - 1 - lx; break;
    case 7: u = lx; v = sv - 1 - ly; break;
    default: break;
  }
  int geo, tag;
  if (l == 0) {
    geo = a;
    tag = 0;
  } else if (l == 1 && a != b) {
    geo = b;
    tag = 1;
  } else {   // EOM bit: the (l - v1)-th set bit, 1-based
    geo = a + static_cast<int>(__fns(ebits, 0, l - (a != b))) + 1;
    tag = 2;
  }
  const int d1 = prm[D1];
  const int dabs = prm[MODE] == 0 ? d1 + geo : max(d1 - geo, 0);
  const int tang = u * max(prm[LODX], 1) + prm[U1];
  const int bitang = v * max(prm[LODY], 1) + prm[V1];
  const int na = prm[NA], ta = prm[TA], ba = prm[BA];
  const int p0 = (na == 0 ? dabs : 0) + (ta == 0 ? tang : 0) + (ba == 0 ? bitang : 0);
  const int p1 = (na == 1 ? dabs : 0) + (ta == 1 ? tang : 0) + (ba == 1 ? bitang : 0);
  const int p2 = (na == 2 ? dabs : 0) + (ta == 2 ? tang : 0) + (ba == 2 ? bitang : 0);
  const int ax45 = prm[AX45];
  const int s45 = (1 << prm[GBITS]) - 1;
  int qx = p0, qy = p1, qz = p2;
  if (ax45 == 1) {
    qx = (p0 - p2 + s45) >> 1;
    qz = (p0 + p2 - s45) >> 1;
  } else if (ax45 == 2) {
    qy = (p1 + p2 - s45) >> 1;
    qz = (p2 - p1 + s45) >> 1;
  } else if (ax45 == 3) {
    qx = (p0 + p1 - s45) >> 1;
    qy = (p1 - p0 + s45) >> 1;
  }
  o.pos[3 * row] = qx;
  o.pos[3 * row + 1] = qy;
  o.pos[3 * row + 2] = qz;
  o.pix[2 * row] = x;
  o.pix[2 * row + 1] = y;
  o.layer[row] = tag;
  o.pid[row] = pid;
  o.bnd[row] = edge ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads, 2) emit_kernel(Planes P,
                                                           const int32_t* __restrict__ ptab,
                                                           const int* __restrict__ scratch,
                                                           Rows out) {
  extern __shared__ int4 smem4[];
  __shared__ int sh[32];
  int32_t* s_key = reinterpret_cast<int32_t*>(smem4);
  const int n = P.H * P.W, W = P.W;
  const int* counts = scratch + 2;
  const int rows = counts[blockIdx.x];
  if (rows == 0) return;
  const int p0 = blockIdx.x * kTile;
  // the tile's first row: the rows of the tiles before it
  int before = 0;
  for (int t = threadIdx.x; t < blockIdx.x; t += kThreads) before += counts[t];
  int off;
  block_scan(before, sh, &off);

  // the neighbour keys of raster pixels [kb, ke) (p0 - W - 1 .. p0 +
  // kTile + W, widened to multiples of 4 where four pixels share a key
  // lookup)
  const int wlo = max(p0 - W - 1, 0), whi = min(p0 + kTile + W + 1, n);
  const int kb = P.quad ? wlo & ~3 : wlo, ke = P.quad ? (whi + 3) & ~3 : whi;
  const bool staged = ke - kb <= kWindow;
  if (staged && P.quad) {
    for (int q = kb + 4 * threadIdx.x; q < ke; q += 4 * kThreads) {
      const int y = q / W, x = q - y * W;
      const uint32_t o = *reinterpret_cast<const uint32_t*>(P.occ + q);
      const int b = P.btp[(y / P.res) * P.bw + x / P.res];
      *reinterpret_cast<int4*>(s_key + (q - kb)) =
          make_int4(o & 0xFFu ? b : -1, o & 0xFF00u ? b : -1, o & 0xFF0000u ? b : -1,
                    o & 0xFF000000u ? b : -1);
    }
  } else if (staged) {
    for (int yy = kb / W, ye = (ke - 1) / W; yy <= ye; ++yy) {
      const int c0 = max(kb - yy * W, 0), c1 = min(ke - yy * W, W);
      const uint8_t* orow = P.occ + yy * W;
      const int32_t* brow = P.btp + (yy / P.res) * P.bw;
      int32_t* krow = s_key + yy * W - kb;
      for (int c = c0 + threadIdx.x; c < c1; c += kThreads)
        krow[c] = orow[c] ? brow[c / P.res] : -1;
    }
  }
  const int p = p0 + threadIdx.x * kPix;
  unsigned occ;   // bit k: pixel p + k has points
  int braw[kPix], cnt[kPix], x0, y0, c = 0;
  {
    Pixels px;
    load_pixels(P, p, n, px);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      cnt[k] = pixel_count(px, k);
      c += cnt[k];
      braw[k] = px.braw[k];
    }
    occ = px.occ;
    x0 = px.x;
    y0 = px.y;
  }
  int total;
  int r = block_scan(c, sh, &total);   // its first barrier orders the keys

  // boundary flags of the pixels with points
  unsigned edge = 0u;
  {
    int x = x0, y = y0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if ((occ >> k) & 1u) {
        const int own = braw[k];
        bool e;
        if (staged && x > 0 && x < W - 1 && y > 0 && y < P.H - 1) {
          const int32_t* kc = s_key + (p + k - kb);
          e = kc[-W - 1] != own || kc[-W] != own || kc[-W + 1] != own || kc[-1] != own
              || kc[1] != own || kc[W - 1] != own || kc[W] != own || kc[W + 1] != own;
        } else {   // an image edge (the neighbourhood wraps) or no window
          const int ym = y == 0 ? P.H - 1 : y - 1, yp = y == P.H - 1 ? 0 : y + 1;
          const int xm = x == 0 ? W - 1 : x - 1, xp = x == W - 1 ? 0 : x + 1;
          e = key_at(P, xm, ym) != own || key_at(P, x, ym) != own || key_at(P, xp, ym) != own
              || key_at(P, xm, y) != own || key_at(P, xp, y) != own
              || key_at(P, xm, yp) != own || key_at(P, x, yp) != own
              || key_at(P, xp, yp) != own;
        }
        if (e) edge |= 1u << k;
      }
      if (++x == W) {
        x = 0;
        ++y;
      }
    }
  }
  __syncthreads();   // the keys are read: their space takes the pixel table

  // per pixel of the tile: its first row (tile-relative) << 1 | its flag,
  // and its block-map entry; per row of a chunk: its pixel
  int* s_first = reinterpret_cast<int*>(smem4);
  int* s_braw = s_first + kTile;
  uint16_t* s_pix = reinterpret_cast<uint16_t*>(s_braw + kTile);
  {
    int rr = r;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if ((occ >> k) & 1u) {
        s_first[threadIdx.x * kPix + k] = (rr << 1) | ((edge >> k) & 1u);
        s_braw[threadIdx.x * kPix + k] = braw[k];
        rr += cnt[k];
      }
    }
  }
  // the tile's rows, kStage at a time: each thread marks the rows of its
  // pixels in the chunk, then a thread a row writes it (consecutive threads,
  // consecutive rows: every field is stored in whole runs)
  for (int lo = 0; lo < rows; lo += kStage) {
    const int n_chunk = min(rows - lo, kStage);
    int rr = r - lo;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if ((occ >> k) & 1u) {
        for (int l = max(-rr, 0), le = min(cnt[k], n_chunk - rr); l < le; ++l)
          s_pix[rr + l] = static_cast<uint16_t>(threadIdx.x * kPix + k);
        rr += cnt[k];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n_chunk; t += kThreads) {
      const int li = s_pix[t], info = s_first[li];
      const int q = p0 + li, y = q / W;
      const unsigned e = P.eom ? static_cast<unsigned>(P.eom[q]) & P.emask : 0u;
      emit_row(out, off + lo + t, lo + t - (info >> 1), q - y * W, y, P.g0[q], P.g1[q], e,
               s_braw[li], info & 1, ptab, P.res);
    }
    __syncthreads();
  }
}

Planes planes(const uint8_t* occ, const int32_t* g0, const int32_t* g1, const int32_t* btp,
              const int32_t* eom, int eom_bits, int H, int W, int res) {
  const auto al = [](const void* q, int b) { return (reinterpret_cast<uintptr_t>(q) % b) == 0; };
  Planes P;
  P.occ = occ;
  P.g0 = g0;
  P.g1 = g1;
  P.btp = btp;
  P.eom = eom;
  P.emask = eom_bits >= 32 ? 0xFFFFFFFFu : (1u << eom_bits) - 1u;
  P.H = H;
  P.W = W;
  P.res = res;
  P.bw = W / res;
  P.vec = al(occ, 4) && al(g0, 16) && al(g1, 16) && (eom == nullptr || al(eom, 16));
  P.quad = P.vec && W % 4 == 0 && res % 4 == 0;
  return P;
}

// tiles of an (H, W) call (ops/reconstruct.py _TILE): the scratch holds
// 2 + tiles int32
int tiles_of(int H, int W) {
  return static_cast<int>((static_cast<long long>(H) * W + kTile - 1) / kTile);
}

}  // namespace

// Launch 1: occ (H, W) uint8, g0/g1 (H, W) int32 relative depths, btp
// (H/res, W/res) int32 (0 = none, else patch index + 1), eom (H, W) int32
// EOM codes of which the low eom_bits (0..30) count, or nullptr; scratch
// as count_kernel lays it out, scratch[odd] 0 (the call before zeroed it).
// The total lands in scratch[odd].
extern "C" int generate_points_count(const uint8_t* occ, const int32_t* g0, const int32_t* g1,
                                     const int32_t* btp, const int32_t* eom, int eom_bits,
                                     int H, int W, int res, int* scratch, int odd,
                                     void* stream) {
  const int nt = tiles_of(H, W);
  if (nt == 0) return 0;
  count_kernel<<<nt, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes(occ, g0, g1, btp, eom, eom_bits, H, W, res), scratch, odd);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2 (after launch 1, with the total read): ptab (P, 16) int32 patch
// table; out pos (N, 3), pix (N, 2), layer (N,), pid (N,) int32 and bnd
// (N,) bool.
extern "C" int generate_points_emit(const uint8_t* occ, const int32_t* g0, const int32_t* g1,
                                    const int32_t* btp, const int32_t* eom, int eom_bits, int H,
                                    int W, int res, const int32_t* ptab, const int* scratch,
                                    int32_t* pos, int32_t* pix, int32_t* layer, int32_t* pid,
                                    uint8_t* bnd, void* stream) {
  const int nt = tiles_of(H, W);
  if (nt == 0) return 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  emit_kernel<<<nt, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      planes(occ, g0, g1, btp, eom, eom_bits, H, W, res), ptab, scratch,
      Rows{pos, pix, layer, pid, bnd});
  return static_cast<int>(cudaGetLastError());
}
