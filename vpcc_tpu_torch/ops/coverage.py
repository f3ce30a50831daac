"""Patch-coverage test against a bit volume (K6, kernel H).

Behavioral reference: `vpcc_tpu/ops/coverage.py`.  The patch-generation
loop only thresholds the distance from every source point to the resampled
patch cloud (reference `while rawPoints` loop, PCCPatchSegmenter.cpp:
804-1320: maxAllowedDist2RawPointsSelection = 1, ...Detection = 9), which
is membership in the dilation of the resampled cloud by a Euclidean ball.
The resampled points go into a bit-packed voxel slab (x in [x0, x0+sx)).
The plain version tests each query's ball as xy columns of z bit-ranges;
kernel H dilates the points' box by both balls, column by column, and reads
one bit a query.

`pack_coords10` and `slab_params` are host helpers copied from the
reference.  `covered_radius_slab` is kernel H on CUDA and
`covered_radius_slab_plain` on the CPU; `column_table` is the kernel's
ball, built on the host once per (r2_sel, r2_det).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.core.pointcloud import PAD_COORD


@functools.lru_cache(maxsize=None)
def _ball_columns(r2: int):
    """The ball as xy columns: for each (dx, dy) with dx^2 + dy^2 <= r2, the
    z extent is |dz| <= wz = floor(sqrt(r2 - dx^2 - dy^2)).  Returns
    ((dx, dy, wz), ...)."""
    r = int(np.floor(np.sqrt(r2)))
    cols = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            d2 = dx * dx + dy * dy
            if d2 <= r2:
                cols.append((dx, dy, int(np.floor(np.sqrt(r2 - d2)))))
    return tuple(cols)


def pack_coords10(pts: np.ndarray, cap: int) -> np.ndarray:
    """Pack (M, 3) 10-bit coordinates into one int32 each
    ((x<<20)|(y<<10)|z), padded to `cap` with -1."""
    out = np.full(cap, -1, np.int32)
    p = pts.astype(np.int64)
    out[: len(p)] = ((p[:, 0] << 20) | (p[:, 1] << 10) | p[:, 2]).astype(np.int32)
    return out


_SLAB_SIZES = (128, 192, 256, 384, 512, 768, 1024)


def slab_params(res_pts: np.ndarray, bits: int, r: int = 3):
    """(x0, sx) slab covering the resampled points' x extent padded by the
    dilation radius; sx is one of a few widths, as in the reference."""
    G = 1 << bits
    lo = max(int(res_pts[:, 0].min()) - r, 0)
    hi = min(int(res_pts[:, 0].max()) + r, G - 1)
    need = hi - lo + 1
    sx = next((s for s in _SLAB_SIZES if s >= need and s <= G), None)
    if sx is None:
        sx = G
    x0 = max(0, min(lo, G - sx))
    return x0, sx


def _slab_volume_plain(res_packed, x0: int, bits: int, sx: int):
    """(sx * G * W,) int64 volume words (32 bits used) of the resampled
    points, x clipped to the slab as the reference clips it."""
    G = 1 << bits
    W = G // 32 if G >= 32 else 1
    mask = G - 1
    rp = res_packed[res_packed >= 0].long()
    x, y, z = (rp >> 20) & mask, (rp >> 10) & mask, rp & mask
    word = ((x - x0).clamp(0, sx - 1) * G + y) * W + (z >> 5)
    key = torch.unique(word * 32 + (z & 31))   # distinct (word, bit): + == OR
    vol = torch.zeros(sx * G * W, dtype=torch.int64, device=res_packed.device)
    return vol.index_add_(0, key // 32, torch.ones_like(key) << (key % 32))


def covered_radius_slab_plain(res_packed, queries, x0: int, bits: int, r2_sel: int,
                              r2_det: int, sx: int):
    """Plain PyTorch version of kernel H: the same volume and column test."""
    G = 1 << bits
    W = G // 32 if G >= 32 else 1
    vol = _slab_volume_plain(res_packed, x0, bits, sx)
    qx = queries[:, 0].long() - x0
    inside = (qx >= 0) & (qx < sx) & (queries[:, 0] != int(PAD_COORD))
    qy = queries[:, 1].clamp(0, G - 1).long()
    qz = queries[:, 2].clamp(0, G - 1).long()

    def test(r2):
        hit = torch.zeros_like(inside)
        for dx, dy, wz in _ball_columns(r2):
            vx, vy = qx - dx, qy - dy
            ok = inside & (vx >= 0) & (vx < sx) & (vy >= 0) & (vy < G)
            base = (vx.clamp(0, sx - 1) * G + vy.clamp(0, G - 1)) * W
            zlo, zhi = (qz - wz).clamp(min=0), (qz + wz).clamp(max=G - 1)
            for off in range((2 * wz >> 5) + 2):
                wd = (zlo >> 5) + off
                lo = (zlo - wd * 32).clamp(min=0)
                hi = (zhi - wd * 32).clamp(max=31)
                m = ((torch.ones_like(hi) << (hi + 1)) - 1) & ~((torch.ones_like(lo) << lo) - 1)
                w = vol[base + wd.clamp(max=W - 1)]
                hit |= ok & (wd <= zhi >> 5) & ((w & m) != 0)
        return hit

    det = test(r2_det)
    return (det if r2_sel == r2_det else test(r2_sel)), det


# the largest ball kernel H takes: r = 7 (the kernel keeps a word a z
# half-extent in registers; csrc/coverage.cu kMaxR)
MAX_R2 = 63


@functools.lru_cache(maxsize=None)
def column_table(r2_sel: int, r2_det: int) -> tuple:
    """Kernel H's column table: the columns of the larger ball, ordered by
    dx^2 + dy^2 (then dx, dy), as (dx, dy, wz_det, wz_sel) with wz the
    column's z half-extent in that ball (`_ball_columns`) and -1 where the
    column lies outside it.  So each ball is a prefix of the table."""
    wz = {r2: {(dx, dy): w for dx, dy, w in _ball_columns(r2)} for r2 in (r2_sel, r2_det)}
    cols = sorted(_ball_columns(max(r2_sel, r2_det)),
                  key=lambda c: (c[0] * c[0] + c[1] * c[1], c[0], c[1]))
    return tuple((dx, dy, wz[r2_det].get((dx, dy), -1), wz[r2_sel].get((dx, dy), -1))
                 for dx, dy, _ in cols)


@functools.lru_cache(maxsize=None)
def _packed_table(r2_sel: int, r2_det: int):
    """`column_table` as the kernel reads it: one little-endian int32 of
    four signed bytes a column, in host memory (copied into the launch's
    parameters), its address and its length."""
    if max(r2_sel, r2_det) > MAX_R2 or min(r2_sel, r2_det) < 0:
        raise ValueError(f"covered_radius_slab: r2 {r2_sel}, {r2_det}; kernel H takes "
                         f"0..{MAX_R2}")
    tbl = column_table(r2_sel, r2_det)
    packed = np.asarray(tbl, np.int8).view(np.int32).ravel()
    return packed, ctypes.c_void_p(packed.ctypes.data), len(tbl)


_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
# ints of the scratch before the volume: a block's partial box, 8 ints, for
# at most 1024 blocks
_PART_INTS = 8192


def covered_radius_slab(res_packed, queries, x0: int, bits: int, r2_sel: int,
                        r2_det: int, sx: int):
    """res_packed (R,) int32 packed 10-bit coordinates (-1 = padding);
    queries (N, 3) int32; x0, sx the slab.  Returns (covered_sel (N,),
    covered_det (N,)) bool, two rows of one allocation.  Kernel H on CUDA
    (one cooperative launch, no host wait; r2 up to MAX_R2); the plain
    version for a CPU tensor."""
    if queries.device.type == "cpu":
        return covered_radius_slab_plain(res_packed, queries, x0, bits, r2_sel, r2_det, sx)
    d = queries.device
    dev.check_tensor(res_packed, "res_packed", torch.int32, d, 1)
    dev.check_tensor(queries, "queries", torch.int32, d, 2)
    if bits > 10:
        raise ValueError("covered_radius_slab: 10-bit packed coordinates only")
    G = 1 << bits
    N = queries.shape[0]
    _, cols, ncols = _packed_table(int(r2_sel), int(r2_det))
    out = torch.empty((2, N), dtype=torch.bool, device=d)
    # the volume and its two dilations, each at most the slab
    scratch = dev.scratch("coverage", d, _PART_INTS + 3 * int(sx) * G * max(G // 32, 1))
    rc = dev.kernel_fn("coverage", "coverage", _ARGS)(
        dev.ptr(res_packed), res_packed.shape[0], dev.ptr(queries), N, int(x0), int(sx), bits,
        int(np.floor(np.sqrt(max(r2_sel, r2_det)))), cols, ncols,
        dev.ptr(scratch), dev.ptr(out), ctypes.c_void_p(out.data_ptr() + N),
        dev.stream_handle())
    dev.count_launch("coverage", int(N > 0))
    dev.check_launch("coverage", rc)
    return out[0], out[1]
