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
// Design: two launches of one kernel.  Pass 0 writes each pixel's point
// count (v0 + v1 + popcount of its EOM bits); the wrapper takes an
// inclusive cumsum; pass 1 writes each pixel's points from row incl -
// count on, in layer order (D0, D1, EOM bit 0, 1, ...), which keeps raster
// order y*W + x, layer-minor, exactly as the reference's stable
// compaction of its (H*W, 2 + eom_bits) candidates.  No (H*W, L)
// intermediate is stored.  eom == nullptr is the two-layer kernel.
//
// Bound: bytes — one read of the occupancy, both geometry maps, the EOM
// plane and the block map per pass, one write of the compacted rows (29
// bytes a point).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { U0, V0, SU0, SV0, U1, V1, D1, NA, TA, BA, MODE, ORI, AX45, GBITS, LODX, LODY, NF };

__global__ void generate_points_kernel(
    const uint8_t* occ, const int32_t* g0, const int32_t* g1,
    const int32_t* btp, const int32_t* ptab, int32_t* counts_or_incl, int H,
    int W, int res, int P, int32_t* pos, int32_t* pix, int32_t* layer,
    int32_t* pid_out, uint8_t* bnd, int n_out, const int32_t* eom, int eom_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W, x = i - (i / W) * W;
  const int bw = W / res;
  const int braw = btp[(y / res) * bw + x / res];
  const int pid = braw - 1;
  const bool v0 = occ[i] != 0 && pid >= 0;
  const int a = g0[i], b = g1[i];
  const bool v1 = v0 && a != b;
  const unsigned ebits =
      (v0 && eom != nullptr) ? static_cast<unsigned>(eom[i]) & ((1u << eom_bits) - 1u) : 0u;
  const int cnt = static_cast<int>(v0) + static_cast<int>(v1) + __popc(ebits);
  if (pos == nullptr) {  // pass 0: counts
    counts_or_incl[i] = cnt;
    return;
  }
  if (cnt == 0) return;
  const int row = counts_or_incl[i] - cnt;
  if (row < 0 || row + cnt > n_out) return;

  // boundary: any of the 8 wrapped neighbours unoccupied or in another block id
  bool edge = false;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int ny = (y + dy + H) % H, nx = (x + dx + W) % W;
      const int nraw = btp[(ny / res) * bw + nx / res];
      edge = edge || occ[ny * W + nx] == 0 || nraw != braw;
    }
  }

  const int32_t* prm = ptab + (pid < 0 ? 0 : pid) * NF;
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
  const int mode = prm[MODE], d1 = prm[D1];
  const int tang = u * max(prm[LODX], 1) + prm[U1];
  const int bitang = v * max(prm[LODY], 1) + prm[V1];
  const int ax45 = prm[AX45];
  const int s45 = (1 << prm[GBITS]) - 1;
  const int na = prm[NA], ta = prm[TA], ba = prm[BA];

  // layers in order: D0, D1 (where it differs), then EOM bits low to high
  unsigned rest = ebits;
  for (int l = 0; l < cnt; ++l) {
    int geo, tag;
    if (l == 0) {
      geo = a;
      tag = 0;
    } else if (l == 1 && v1) {
      geo = b;
      tag = 1;
    } else {
      const int k = __ffs(rest) - 1;  // lowest set bit left
      rest &= rest - 1u;
      geo = a + k + 1;
      tag = 2;
    }
    const int dabs = mode == 0 ? d1 + geo : max(d1 - geo, 0);
    int pt[3];
    for (int ch = 0; ch < 3; ++ch)
      pt[ch] = (na == ch ? dabs : 0) + (ta == ch ? tang : 0) + (ba == ch ? bitang : 0);
    int px = pt[0], py = pt[1], pz = pt[2];
    if (ax45 == 1) {
      px = (pt[0] - pt[2] + s45) >> 1;
      pz = (pt[0] + pt[2] - s45) >> 1;
    } else if (ax45 == 2) {
      py = (pt[1] + pt[2] - s45) >> 1;
      pz = (pt[2] - pt[1] + s45) >> 1;
    } else if (ax45 == 3) {
      px = (pt[0] + pt[1] - s45) >> 1;
      py = (pt[1] - pt[0] + s45) >> 1;
    }
    const int r = row + l;
    pos[r * 3 + 0] = px;
    pos[r * 3 + 1] = py;
    pos[r * 3 + 2] = pz;
    pix[r * 2 + 0] = x;
    pix[r * 2 + 1] = y;
    layer[r] = tag;
    pid_out[r] = pid;
    bnd[r] = edge ? 1 : 0;
  }
}

}  // namespace

// pass 0 (pos == nullptr): counts_or_incl receives (H*W,) per-pixel counts.
// pass 1: counts_or_incl holds their inclusive cumsum; writes n_out rows of
// pos (N, 3), pix (N, 2), layer (N,), pid (N,) int32 and bnd (N,) bool.
// eom: (H, W) int32 EOM codes, of which the low eom_bits (0..30) count, or
// nullptr for the two layers alone.
extern "C" int generate_points(const uint8_t* occ, const int32_t* g0,
                               const int32_t* g1, const int32_t* btp,
                               const int32_t* ptab, int32_t* counts_or_incl,
                               int H, int W, int res, int P, int32_t* pos,
                               int32_t* pix, int32_t* layer, int32_t* pid,
                               uint8_t* bnd, int n_out, const int32_t* eom,
                               int eom_bits, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  const int threads = 256;
  generate_points_kernel<<<(n + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      occ, g0, g1, btp, ptab, counts_or_incl, H, W, res, P, pos, pix, layer,
      pid, bnd, n_out, eom, eom_bits);
  return static_cast<int>(cudaGetLastError());
}
