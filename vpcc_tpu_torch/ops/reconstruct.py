"""Inverse projection: atlas videos -> compacted 3D points (kernel C).

Behavioral reference: `PCCCodec::generatePointCloud`
(source/lib/PccLibCommon/source/PCCCodec.cpp:519-980) as the JAX package
computes it: vpcc_tpu/ops/reconstruct.py `generate_point_cloud`,
vpcc_tpu/ops/smoothing.py `boundary_pixels` and the valid-first compaction
of vpcc_tpu/pipeline.py `_recon_phase2`.

Per occupied pixel: look up the owning patch (block-to-patch), invert the
packing orientation to patch (u, v), rebuild the D0 point, where the D1 map
differs the D1 point, and with enhancedOccupancyMapCode one EOM point at
directed depth D0 + k + 1 for each set bit k < eom_bits of the pixel's EOM
code (PCCCodec.cpp:671-804), with the 45-degree inverse rotations.  Rows
come out in raster order y*W + x, layer-minor (D0, D1, EOM bit 0, 1, ...),
valid rows only: duplicate removal keeps the first instance of a position
and the EOM colors travel in row order, so the order decides which color a
point gets.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vpcc_tpu_torch import device as dev

# column indices of the patch table (core/atlas.py PATCH_FIELDS)
(_U0, _V0, _SU0, _SV0, _U1, _V1, _D1, _NA, _TA, _BA, _MODE, _OR,
 _AXIS45, _GBITS, _LODX, _LODY) = range(16)


class Points(NamedTuple):
    """Compacted reconstruction rows (N = number of valid points)."""

    pos: torch.Tensor    # (N, 3) int32 positions
    pix: torch.Tensor    # (N, 2) int32 atlas (x, y)
    layer: torch.Tensor  # (N,) int32 0 = D0 point, 1 = D1 point, 2 = EOM point
    pid: torch.Tensor    # (N,) int32 patch index
    bnd: torch.Tensor    # (N,) bool patch-boundary pixel


def boundary_pixels(occupancy, block_to_patch):
    """(H, W) mask of occupied pixels adjacent (8-neighborhood) to an
    unoccupied pixel or to a pixel of another block-to-patch entry.  The
    neighborhood wraps around the image edge, as `jnp.roll` does in the
    JAX package."""
    occ = occupancy != 0
    h, w = occ.shape
    sy = h // block_to_patch.shape[0]
    sx = w // block_to_patch.shape[1]
    pid = block_to_patch.repeat_interleave(sy, 0).repeat_interleave(sx, 1)
    edge = torch.zeros_like(occ)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nocc = torch.roll(occ, (dy, dx), (0, 1))
            npid = torch.roll(pid, (dy, dx), (0, 1))
            edge = edge | ~nocc | (npid != pid)
    return occ & edge


def _canvas_to_patch_uv(lx, ly, su, sv, orient):
    """Invert patch2Canvas (reference: PCCPatch.cpp:139-186 canvasTo3D)."""
    cases = (
        (lx, ly), (ly, lx), (ly, sv - 1 - lx), (su - 1 - lx, sv - 1 - ly),
        (su - 1 - ly, lx), (su - 1 - lx, ly), (su - 1 - ly, sv - 1 - lx),
        (lx, sv - 1 - ly),
    )
    u, v = lx, ly
    for i, (cu, cv) in enumerate(cases):
        u = torch.where(orient == i, cu, u)
        v = torch.where(orient == i, cv, v)
    return u, v


def generate_point_cloud(occupancy, geometry0, geometry1, block_to_patch,
                         patch_tbl, res: int, eom=None, eom_bits: int = 0):
    """Plain PyTorch counterpart of the JAX `generate_point_cloud` (no
    PLR): returns (points (H*W, L, 3) int32, valid (H*W, L) bool, pixel_xy
    (H*W, 2) int32, patch_of (H*W,) int32), L = 2 + eom_bits (eom_bits 0
    without an EOM plane).  Layer 2 + k is the EOM point at directed depth
    D0 + k + 1 (clamped at 0 in projection mode 1), valid where bit k of
    the (H, W) int32 `eom` code is set."""
    h, w = occupancy.shape
    d = occupancy.device
    ys = torch.arange(h, dtype=torch.int32, device=d)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=d)[None, :].expand(h, w)
    btp_px = block_to_patch.repeat_interleave(res, 0).repeat_interleave(res, 1)
    pid = btp_px - 1
    occ = (occupancy != 0) & (pid >= 0)
    prm = patch_tbl[pid.clamp(min=0).long()]                  # (H, W, 16)
    col = lambda k: prm[..., k]

    lx = xs - col(_U0) * res
    ly = ys - col(_V0) * res
    u, v = _canvas_to_patch_uv(lx, ly, col(_SU0) * res, col(_SV0) * res,
                               col(_OR))
    mode = col(_MODE)
    d1 = col(_D1)
    tang = u * col(_LODX).clamp(min=1) + col(_U1)
    bitang = v * col(_LODY).clamp(min=1) + col(_V1)
    ax45 = col(_AXIS45)
    s45 = torch.bitwise_left_shift(torch.ones_like(ax45), col(_GBITS)) - 1
    axes = (col(_NA), col(_TA), col(_BA))

    def to_xyz(geo):
        dabs = torch.where(mode == 0, d1 + geo, (d1 - geo).clamp(min=0))
        vals = (dabs, tang, bitang)
        x, y, z = (
            sum(torch.where(axes[k] == c, vals[k], torch.zeros_like(dabs))
                for k in range(3))
            for c in range(3)
        )
        r1 = ((x - z + s45) >> 1, y, (x + z - s45) >> 1)
        r2 = (x, (y + z - s45) >> 1, (z - y + s45) >> 1)
        r3 = ((x + y - s45) >> 1, (y - x + s45) >> 1, z)
        out = []
        for c, p in enumerate((x, y, z)):
            for k, r in ((1, r1), (2, r2), (3, r3)):
                p = torch.where(ax45 == k, r[c], p)
            out.append(p)
        return torch.stack(out, -1)

    if eom is None:
        eom_bits = 0
    layers_p = [to_xyz(geometry0), to_xyz(geometry1)]
    layers_v = [occ, occ & (geometry1 != geometry0)]
    for k in range(eom_bits):
        # directed depth D0 + k + 1: d1 + g0 + k + 1, or max(d1 - g0 - k - 1, 0)
        layers_p.append(to_xyz(geometry0 + (k + 1)))
        layers_v.append(occ & (((eom >> k) & 1) != 0))
    L = len(layers_p)
    points = torch.stack(layers_p, 2)
    valid = torch.stack(layers_v, 2)
    pixel_xy = torch.stack([xs, ys], 2).reshape(h * w, 2)
    return (points.reshape(h * w, L, 3), valid.reshape(h * w, L), pixel_xy,
            pid.reshape(h * w))


def generate_points_plain(occupancy, geometry0, geometry1, block_to_patch,
                          patch_tbl, res: int, eom=None, eom_bits: int = 0) -> Points:
    """Plain PyTorch version of kernel C: generate_point_cloud +
    boundary_pixels + the stable valid-first compaction, with the layer
    tags of the reference's `_recon_phase2` (D0 0, D1 1, EOM 2)."""
    pts, valid, pix, pid = generate_point_cloud(
        occupancy, geometry0, geometry1, block_to_patch, patch_tbl, res, eom, eom_bits
    )
    L = valid.shape[1]
    bnd = boundary_pixels(occupancy, block_to_patch).reshape(-1)
    rows = valid.reshape(-1).nonzero()[:, 0]      # raster, layer-minor
    px = rows // L
    return Points(
        pos=pts.reshape(-1, 3)[rows].contiguous(),
        pix=pix[px].contiguous(),
        layer=(rows % L).clamp(max=2).to(torch.int32),
        pid=pid[px].contiguous(),
        bnd=bnd[px].contiguous(),
    )


_PLANE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
_COUNT_ARGS = _PLANE_ARGS + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_EMIT_ARGS = _PLANE_ARGS + [ctypes.c_void_p] * 8
_TILE = 2048    # raster pixels a tile (csrc/generate_points.cu kTile)


class _Scratch:
    """A device's tile scratch: the totals of even and odd calls, then the
    tile counts.  Grown to the tiles a call needs and never shrunk; zeroed
    once when made (a call zeroes the total the next call adds to).  Calls
    run in stream order."""

    def __init__(self, d: torch.device, tiles: int, odd: int = 0):
        self.buf = torch.zeros(2 + tiles, dtype=torch.int32, device=d)
        self.totals = (self.buf[0], self.buf[1])
        self.odd = odd


_scratch = {}   # device -> _Scratch


def _scratch_for(d: torch.device, tiles: int) -> _Scratch:
    sc = _scratch.get(d)
    if sc is None or sc.buf.numel() < 2 + tiles:
        sc = _scratch[d] = _Scratch(d, tiles)
    return sc


def generate_points(occupancy, geometry0, geometry1, block_to_patch,
                    patch_tbl, res: int, eom=None, eom_bits: int = 0,
                    entry: str = "generate_points_eom") -> Points:
    """Kernel C (csrc/generate_points.cu).  occupancy (H, W) uint8;
    geometry0/1 (H, W) int32 relative depths; block_to_patch (H/res, W/res)
    int32 (0 = none, else patch index + 1); patch_tbl (P, 16) int32; eom
    (H, W) int32 EOM codes with eom_bits layers, or None.  Two launches and
    one host read: each tile's point count and their total, the total read
    back to size the outputs, then each tile's rows written from its first
    row on (no second launch when there is no point).  With an EOM plane
    the launches count as `entry`'s: the EOM entry's
    (`generate_points_eom`), or PLR's (`generate_points_plr`), whose three
    layers at D0 + j are the same code plane (ops/plr.py).  The plain
    version runs on the CPU."""
    if occupancy.device.type == "cpu":
        return generate_points_plain(occupancy, geometry0, geometry1,
                                     block_to_patch, patch_tbl, res, eom, eom_bits)
    d = occupancy.device
    H, W = occupancy.shape
    dev.check_tensor(occupancy, "occupancy", torch.uint8, d, 2)
    dev.check_tensor(geometry0, "geometry0", torch.int32, d, 2)
    dev.check_tensor(geometry1, "geometry1", torch.int32, d, 2)
    dev.check_tensor(block_to_patch, "block_to_patch", torch.int32, d, 2)
    dev.check_tensor(patch_tbl, "patch_tbl", torch.int32, d, 2)
    if eom is not None:
        dev.check_tensor(eom, "eom", torch.int32, d, 2)
    else:
        eom_bits = 0
    if (geometry0.shape != (H, W) or geometry1.shape != (H, W)
            or block_to_patch.shape != (H // res, W // res)
            or H % res or W % res or patch_tbl.shape[1] != 16
            or (eom is not None and (eom.shape != (H, W) or not 0 <= eom_bits <= 30))):
        raise ValueError("generate_points: inconsistent shapes")
    if 3 * H * W * (2 + eom_bits) >= 1 << 31:
        raise ValueError(f"generate_points: a ({H}, {W}) atlas with {eom_bits} EOM layers "
                         "may pass 2^31 position words")
    counter = "generate_points" if eom is None else entry
    planes = (dev.ptr(occupancy), dev.ptr(geometry0), dev.ptr(geometry1),
              dev.ptr(block_to_patch), ctypes.c_void_p(None if eom is None else eom.data_ptr()),
              eom_bits, H, W, res)
    tiles = -(-H * W // _TILE)
    sc = _scratch_for(d, tiles)
    stream = dev.stream_handle()
    n = 0
    if tiles:
        odd = sc.odd
        rc = dev.kernel_fn("generate_points", "generate_points_count", _COUNT_ARGS)(
            *planes, dev.ptr(sc.buf), odd, stream)
        dev.count_launch(counter)
        dev.check_launch("generate_points", rc)
        sc.odd = 1 - odd
        n = int(sc.totals[odd])   # the call's one host wait
    out = Points(
        pos=torch.empty((n, 3), dtype=torch.int32, device=d),
        pix=torch.empty((n, 2), dtype=torch.int32, device=d),
        layer=torch.empty(n, dtype=torch.int32, device=d),
        pid=torch.empty(n, dtype=torch.int32, device=d),
        bnd=torch.empty(n, dtype=torch.bool, device=d),
    )
    if n:
        rc = dev.kernel_fn("generate_points", "generate_points_emit", _EMIT_ARGS)(
            *planes, dev.ptr(patch_tbl), dev.ptr(sc.buf), *map(dev.ptr, out), stream)
        dev.count_launch(counter)
        dev.check_launch("generate_points", rc)
    return out
