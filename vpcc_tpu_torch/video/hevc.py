"""HEVC-class wavefront video codec (vpcc_tpu/video/hevc.py): decoder and
encoder of the three-level (32/16/8) CU syntax, and of the two-level (16/8)
syntax that codes planes with samples above 10 bits (maxval 1024..2047,
e.g. geometry at geometryNominal2dBitdepth=11).

Payloads of the port's `encode_planes` and of `vpcc_tpu.video.hevc.
encode_planes` are the same bytes given the same decisions; both decoders
turn either into the same int32 planes.  `ENABLE_CU32` is the reference's
switch: with it off, every plane takes the two-level codec.

Stages of `decode_planes`:
1. host: entropy-decode the per-plane syntax (split flags, modes, zigzag
   coefficients, MVs, SAO parameters) — `parse_planes32`, which hands a
   two-level payload (FLAG_CU32 clear) to `parse_planes16`;
2. device: edge-pad the reference planes and cut them into codec tiles;
3. device, kernel B `half_pel_mc` (motion payloads only): 8-tap half-pel
   interpolation fused with the per-CU motion-compensated gather, per 32x32
   CU (two-level: per 16x16 CU);
4. device, kernel A `wavefront_decode32` (two-level: its entry
   `wavefront_decode16`): the intra/inter reconstruction of 32x32 (16x16)
   CUs in wavefront order, one launch a call;
5. device: deblocking (kernel O `deblock`, when the payload says so) and
   SAO (kernel K `sao_apply`; 16-px regions in a two-level payload that
   carries FLAG_SAO16), per tile; untile and crop.

Stages of `encode_planes`:
1. device, kernel L `push_pull` (ops/padding.py): background fill of the
   unoccupied pixels (one occupancy, or one per plane), rounded to int32;
   edge-pad and tile;
2. device, kernel J `motion_search` (motion planes): per-CU half-pel MVs,
   then kernel B builds the motion-compensated reference;
3. device, kernel I `wavefront_encode32` (two-level: `wavefront_encode16`):
   the RD quadtree decisions, the syntax and the reconstruction, one launch
   a call (CUs in wavefront order behind per-CU ready flags);
4. device, kernel O `deblock` (attribute planes), then kernel K
   `sao_search_apply` (one launch): per-region SAO parameters (32-px
   regions; two-level: 16-px) and the final reconstruction;
5. host: `assemble_payload32` (two-level: `assemble_payload16`), the
   entropy coder.
Stages 1-4 are `encode_planes_dispatch`, which leaves a `Coded` on the
device; its `payload` runs stage 5 for any run of its planes, so one
dispatch can code the planes of several frames (the level-batched GOF
path, `parallel/gof.py`).

`encode_rgb` / `decode_rgb` code an RGB attribute image as a luma plane and
a 4:2:0 chroma pair (chroma QP + 3) on top of these; the color conversion
both ways (and `rgb_refs`) is kernel Q `color_convert` on the device.

Each kernel wrapper runs its plain PyTorch version (`*_plain`, same
arguments, same result) when its input lies on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.ops import padding
from vpcc_tpu_torch.video import color, entropy
from vpcc_tpu_torch.video import hevc_tables as tab

CU = 16                      # mid CU size
SUB = 8                      # split block size
SUB_OFF = ((0, 0), (0, 8), (8, 0), (8, 8))  # z-order
QOFF32 = ((0, 0), (0, 16), (16, 0), (16, 16))  # 16-quadrants of a 32-CU
CU32 = 32
CC = CU * CU
CC32 = CU32 * CU32
MV_RANGE = 8                 # integer-pel motion search window (+-R)
SAO_REGION = 32              # SAO region of the three-level codec (two-level: CU)
ENABLE_CU32 = True           # three-level (32/16/8) quadtree where maxval <= 1023
MAXVAL_LIMIT = 2047          # the prediction is integer-exact up to 11-bit samples

FLAG_INTER = 1
FLAG_DEBLOCK = 2
FLAG_MC = 4  # motion-compensated inter (per-CU MVs follow each plane blob)
FLAG_CU32 = 8  # three-level (32/16/8) quadtree syntax
FLAG_SAO16 = 16  # two-level payload carries 16px-region SAO params

# 8-tap HEVC half-pel interpolation filter (HM luma 1/2-position taps)
_HP_TAPS = (-1, 4, -11, 40, 40, -11, 4, -1)
_SAO_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))  # EO 0/90/135/45 neighbor axes


# ---------------------------------------------------------------------------
# tiling (codec tiles are independent coding regions; see vpcc_tpu hevc.py)

def _padded_dims(H: int, W: int, ty: int, tx: int, cu: int):
    return -(-H // (ty * cu)) * ty * cu, -(-W // (tx * cu)) * tx * cu


def _tiles_of(x, ty, tx):
    """(P, H, W) -> (P*ty*tx, H/ty, W/tx); tile-major within each plane."""
    P, H, W = x.shape
    ht, wt = H // ty, W // tx
    return (
        x.reshape(P, ty, ht, tx, wt).permute(0, 1, 3, 2, 4)
        .reshape(P * ty * tx, ht, wt)
    )


def _untile(x, P, ty, tx):
    _, ht, wt = x.shape
    return (
        x.reshape(P, ty, tx, ht, wt).permute(0, 1, 3, 2, 4)
        .reshape(P, ty * ht, tx * wt)
    )


def _blocks(x, nby: int, nbx: int, n: int):
    """(P, nby*n, nbx*n) -> (P, nby*nbx, n*n): one raster row per n x n CU."""
    P = x.shape[0]
    return (x.reshape(P, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
            .reshape(P, nby * nbx, n * n))


def _unblocks(b, nby: int, nbx: int, n: int):
    """Inverse of `_blocks`."""
    P = b.shape[0]
    return (b.reshape(P, nby, nbx, n, n).permute(0, 1, 3, 2, 4)
            .reshape(P, nby * n, nbx * n))


def _pad_rows(x, fill):
    """Append the init row (nb) and the write-dump row (nb + 1) to (P, nb,
    ...) CU rows; `fill` is a scalar or a tensor that expands to them (the
    per-plane init value (P, 1, 1))."""
    P = x.shape[0]
    extra = (fill.expand((P, 2) + x.shape[2:]) if torch.is_tensor(fill)
             else torch.full((P, 2) + x.shape[2:], fill, dtype=x.dtype, device=x.device))
    return torch.cat([x, extra], 1)


def _edge_pad(x, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of the last two dims (any dtype)."""
    H, W = x.shape[-2:]
    iy = torch.arange(-top, H + bottom, device=x.device).clamp_(0, H - 1)
    ix = torch.arange(-left, W + right, device=x.device).clamp_(0, W - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wrap of it (kept as int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# in-loop filters: deblocking (kernel O) and SAO apply's plain version
# (vpcc_tpu hevc.py _deblock / _sao_apply)

def deblock_planes_plain(rec, qps, maxvals):
    """HEVC-style normal deblocking filter on all 8-aligned block edges of
    (P, H, W) int32 planes (reference `_deblock`, hevc.py:161): first every
    vertical edge, then every horizontal edge of that result; qps/maxvals:
    (P,) int32."""
    P = rec.shape[0]
    tc_tab = torch.as_tensor(tab.TC_TAB, device=rec.device)
    tc8 = tc_tab[(qps + 2).clamp(0, 53).long()]
    scale = torch.div(maxvals + 1, 256, rounding_mode="floor")
    tc = (tc8 * scale.clamp(min=1))[:, None, None]
    mv = maxvals[:, None, None]

    def filter_axis(v):
        _, h, w = v.shape
        a = v.reshape(P, h, w // SUB, SUB).clone()
        p1 = a[:, :, :-1, SUB - 2]
        p0 = a[:, :, :-1, SUB - 1]
        q0 = a[:, :, 1:, 0]
        q1 = a[:, :, 1:, 1]
        dlt = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        on = dlt.abs() < 10 * tc
        d = torch.minimum(torch.maximum(dlt, -tc), tc)
        p0n = torch.where(on, torch.minimum((p0 + d).clamp(min=0), mv), p0)
        q0n = torch.where(on, torch.minimum((q0 - d).clamp(min=0), mv), q0)
        a[:, :, :-1, SUB - 1] = p0n
        a[:, :, 1:, 0] = q0n
        return a.reshape(P, h, w)

    rec = filter_axis(rec)
    rec = filter_axis(rec.transpose(1, 2).contiguous()).transpose(1, 2)
    return rec.contiguous()


_DEBLOCK_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def deblock_planes(rec, qps, maxvals):
    """Kernel O (csrc/deblock.cu): `deblock_planes_plain` on the card, one
    launch a call (a block a (plane, band of 8 rows, column strip), both
    edge directions in shared memory) into a new tensor; the tc table is
    the kernel's own, so the call uploads nothing and never waits on the
    card.  rec: (P, H, W) int32 on 16 bytes."""
    if rec.device.type == "cpu":
        return deblock_planes_plain(rec, qps, maxvals)
    d = rec.device
    dev.check_tensor(rec, "rec", torch.int32, d, 3)
    dev.check_tensor(qps, "qps", torch.int32, d, 1)
    dev.check_tensor(maxvals, "maxvals", torch.int32, d, 1)
    P, H, W = rec.shape
    if H % SUB or W % SUB or qps.shape[0] != P or maxvals.shape[0] != P:
        raise ValueError(f"deblock: planes {tuple(rec.shape)}, qps {tuple(qps.shape)}")
    if rec.data_ptr() % 16:
        raise ValueError("deblock: expected planes on 16 bytes")
    out = torch.empty_like(rec)
    rc = dev.kernel_fn("deblock", "deblock", _DEBLOCK_ARGS)(
        rec.data_ptr(), qps.data_ptr(), maxvals.data_ptr(), out.data_ptr(), P, H, W,
        dev.stream_handle())
    dev.count_launch("deblock", 1 if rec.numel() else 0)
    dev.check_launch("deblock", rc)
    return out


def _sao_categories(rec, dy, dx):
    """(P, H, W) int32 edge-offset category in {0..4} against the (dy, dx)
    neighbor pair, edge-padded (2 = flat)."""
    H, W = rec.shape[1:]
    pad = _edge_pad(rec, 1, 1, 1, 1)
    a = pad[:, 1 + dy: H + 1 + dy, 1 + dx: W + 1 + dx]
    b = pad[:, 1 - dy: H + 1 - dy, 1 - dx: W + 1 - dx]
    return torch.sign(rec - a) + torch.sign(rec - b) + 2


def sao_apply_plain(rec, sao_cls, sao_off, maxvals, region: int = SAO_REGION):
    """Plain version of kernel K's apply (vpcc_tpu hevc.py `_sao_apply`):
    category derivation + per-region offset add.  rec (P, H, W) int32,
    sao_cls (P, Ry, Rx), sao_off (P, Ry, Rx, 4) (any integer type),
    maxvals (P,) int32; regions of region x region samples."""
    cats = torch.stack([_sao_categories(rec, dy, dx) for dy, dx in _SAO_DIRS])
    rep = lambda a: (a.to(torch.int32).repeat_interleave(region, 1)
                     .repeat_interleave(region, 2))
    cls_px = rep(sao_cls)
    cat_sel = torch.gather(cats, 0, (cls_px - 1).clamp(min=0).long()[None])[0]
    off_px = rep(sao_off)
    slot = torch.where(cat_sel > 2, cat_sel - 1, cat_sel).clamp(0, 3)
    o_px = torch.gather(off_px, -1, slot[..., None].long())[..., 0]
    o_px = torch.where((cls_px > 0) & (cat_sel != 2), o_px, torch.zeros_like(o_px))
    return torch.minimum((rec + o_px).clamp(min=0), maxvals[:, None, None])


# ---------------------------------------------------------------------------
# kernel B: half-pel motion compensation

def _half_planes(ref, maxvals):
    """(P, H, W) int32 -> (4, P, H, W) [full, H(half-x), V(half-y), HV]
    planes, each ((sum + 32) >> 6) and clipped; HV filters the clipped H
    plane vertically."""
    mx = maxvals[:, None, None]

    def conv(p, axis):
        n = p.shape[axis]
        pad = _edge_pad(p, 3, 4, 0, 0) if axis == 1 else _edge_pad(p, 0, 0, 3, 4)
        acc = sum(t * pad.narrow(axis, k, n) for k, t in enumerate(_HP_TAPS))
        return torch.minimum(((acc + 32) >> 6).clamp(min=0), mx)

    h = conv(ref, 2)
    return torch.stack([ref, h, conv(ref, 1), conv(h, 1)])


def half_pel_mc_plain(ref, mv, maxvals, bs: int):
    """MC prediction with half-pel MVs: ref (P, H, W) int32 tile planes,
    mv (P, nb, 2) int32 (dy, dx) per bs x bs CU in half-sample units,
    maxvals (P,) int32.  Returns (P, H, W) int32.  As the reference: a
    gather from the four planes edge-padded by the search range."""
    R = MV_RANGE
    P, H, W = ref.shape
    nbx = W // bs
    planes = _half_planes(ref, maxvals)                    # (4, P, H, W)
    padr = _edge_pad(planes, R, R, R, R).transpose(0, 1)   # (P, 4, H+2R, W+2R)
    yy = torch.arange(H, device=ref.device)[:, None]
    xx = torch.arange(W, device=ref.device)[None, :]
    bi = (yy // bs) * nbx + (xx // bs)
    mvy = mv[:, :, 0][:, bi]
    mvx = mv[:, :, 1][:, bi]
    fi = (mvy & 1) * 2 + (mvx & 1)
    iy = (yy[None] + R + (mvy >> 1)).clamp(0, H + 2 * R - 1)
    ix = (xx[None] + R + (mvx >> 1)).clamp(0, W + 2 * R - 1)
    Hp, Wp = H + 2 * R, W + 2 * R
    flat = ((fi * Hp + iy) * Wp + ix).reshape(P, -1).long()
    return torch.gather(padr.reshape(P, -1), 1, flat).reshape(P, H, W)


_MC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def half_pel_mc(ref, mv, maxvals, bs: int):
    """Kernel B (csrc/half_pel_mc.cu): one launch, a block a CU with its
    source window staged once; `half_pel_mc_plain` on the CPU.  The kernel
    clamps each sample position to the tile, which equals the reference's
    gather from the edge-padded planes.  bs is 16 or 32."""
    if ref.device.type == "cpu":
        return half_pel_mc_plain(ref, mv, maxvals, bs)
    P, H, W = ref.shape
    d = ref.device
    dev.check_tensor(ref, "ref", torch.int32, d, 3)
    dev.check_tensor(mv, "mv", torch.int32, d, 3)
    dev.check_tensor(maxvals, "maxvals", torch.int32, d, 1)
    nbx = W // bs
    if bs not in (16, 32) or H % bs or W % bs or mv.shape != (P, (H // bs) * nbx, 2):
        raise ValueError(f"half_pel_mc: shapes {tuple(ref.shape)} / {tuple(mv.shape)}, "
                         f"bs {bs}")
    out = torch.empty_like(ref)
    rc = dev.kernel_fn("half_pel_mc", "half_pel_mc", _MC_ARGS)(
        dev.ptr(ref), dev.ptr(mv), dev.ptr(maxvals), dev.ptr(out), P, H, W, bs, nbx,
        dev.stream_handle())
    dev.count_launch("half_pel_mc", 1 if out.numel() else 0)
    dev.check_launch("half_pel_mc", rc)
    return out


# ---------------------------------------------------------------------------
# kernel A: wavefront decode of the 32/16/8 CU syntax

@functools.lru_cache(maxsize=None)
def _neighbor_schedule(nby: int, nbx: int):
    """Per-diagonal CU ids + neighbor ids (up, up-left, up-right, left);
    out-of-grid / masked entries point at the init row nb."""
    by_tab, bx_tab, valid = tab.wavefront_schedule(nby, nbx)
    nb = nby * nbx

    def nid(by, bx, ok):
        return np.where(ok & (by >= 0) & (bx >= 0) & (bx < nbx), by * nbx + bx, nb)

    bidx = np.where(valid, by_tab * nbx + bx_tab, nb + 1).astype(np.int64)
    nbr = np.stack(
        [
            nid(by_tab - 1, bx_tab, valid),
            nid(by_tab - 1, bx_tab - 1, valid),
            nid(by_tab - 1, bx_tab + 1, valid),
            nid(by_tab, bx_tab - 1, valid),
        ],
        axis=-1,
    ).astype(np.int64)
    return bidx, nbr


@functools.lru_cache(maxsize=None)
def _inv_zigzag(n: int) -> np.ndarray:
    return np.argsort(tab.zigzag(n)).astype(np.int64)


_TABLES: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """Per-device constant tables: transforms, inverse zigzags, angular taps
    (int64 for the plain versions), the packed int32 blob the kernels read
    (layout: T32 T16 T8 | izz32 izz16 izz8 | taps32 taps16 taps8, taps as
    (33, n*n, [idx0, idx1, w0, w1]) | zz32 zz16 zz8) and the encoder's
    float32 blob (`fblob`)."""
    t = _TABLES.get(device)
    if t is not None:
        return t
    t = {}
    blob = []
    for n in (32, 16, 8):
        T = tab.dct_int(n).astype(np.int64)
        t[f"T{n}"] = torch.as_tensor(T, device=device)
        blob.append(T.reshape(-1))
    for n in (32, 16, 8):
        izz = _inv_zigzag(n)
        t[f"izz{n}"] = torch.as_tensor(izz, device=device)
        blob.append(izz)
    for n in (32, 16, 8):
        a = np.stack(tab.angular_taps(n), -1).reshape(33, n * n, 4)
        t[f"ang{n}"] = torch.as_tensor(a.astype(np.int64), device=device)
        blob.append(a.reshape(-1))
    # forward zigzags (scan position -> raster index), read by kernel I
    for n in (32, 16, 8):
        zz = tab.zigzag(n).astype(np.int64)
        t[f"zz{n}"] = torch.as_tensor(zz, device=device)
        blob.append(zz)
    t["blob"] = torch.as_tensor(
        np.concatenate(blob).astype(np.int32), device=device
    )
    # float tables of the encoder's RDO (layout: Cf32 Cf16 Cf8 | mode bits
    # (36) | rate term per level (LEVEL_MAX + 1))
    fblob = []
    for n in (32, 16, 8):
        cf = tab.dct_orthonormal(n).astype(np.float32)
        t[f"Cf{n}"] = torch.as_tensor(cf, device=device)
        fblob.append(cf.reshape(-1))
    t["mode_bits"] = torch.as_tensor(tab.MODE_BITS, device=device)
    t["rd_bits"] = torch.as_tensor(tab.rd_bits_table(), device=device)
    fblob += [tab.MODE_BITS, tab.rd_bits_table()]
    t["fblob"] = torch.as_tensor(np.concatenate(fblob).astype(np.float32),
                                 device=device)
    _TABLES[device] = t
    return t


def _predict(refs, ref_block, mode, n: int, tabs):
    """Prediction of each block's decoded mode.  refs: (P, B, 4n+1) int64
    reference vectors; ref_block: (P, B, n*n) int64 inter prediction;
    mode: (P, B) int64.  Planar and DC as integer formulas, angular from
    the 2-tap tables; equal to the JAX package's 36-lane prediction matrix
    at the decoded lane.  Returns (P, B, n*n) int64."""
    P, B = mode.shape
    sh = n.bit_length()                      # log2(n) + 1
    ar = torch.arange(n, device=refs.device)
    left = refs[..., 2 * n + 1: 3 * n + 1]
    top = refs[..., 1: n + 1]
    tr = refs[..., n + 1, None, None]
    bl = refs[..., 3 * n + 1, None, None]
    x = ar[None, None, None, :]
    y = ar[None, None, :, None]
    planar = (
        (n - 1 - x) * left[..., :, None] + (x + 1) * tr
        + (n - 1 - y) * top[..., None, :] + (y + 1) * bl + n
    ) >> sh
    dc = ((top.sum(-1) + left.sum(-1) + n) >> sh)[..., None]
    am = (mode - 2).clamp(0, 32)
    taps = tabs[f"ang{n}"][am]                # (P, B, n*n, 4)
    g0 = torch.gather(refs, 2, taps[..., 0])
    g1 = torch.gather(refs, 2, taps[..., 1])
    ang = (taps[..., 2] * g0 + taps[..., 3] * g1 + 16) >> 5
    m = mode[..., None]
    pred = torch.where(m == 1, dc, ang)
    pred = torch.where(m == 0, planar.reshape(P, B, n * n), pred)
    return torch.where(m == tab.MODE_INTER, ref_block, pred)


def _int_recon(levels, pred, dq, maxvals, n: int, tabs):
    """dequant -> integer inverse transform (int32 wrap-around exactly as
    the JAX package's int32 einsums) -> add prediction -> clip.
    levels/pred: (P, B, n*n) int64 raster; dq/maxvals: (P,) int64."""
    P, B = levels.shape[:2]
    T = tabs[f"T{n}"]
    s1 = 11
    s2 = 18 + (n.bit_length() - 1) - s1
    d = (levels * dq[:, None, None]).clamp(-(1 << 19), (1 << 19) - 1)
    d = d.reshape(P, B, n, n)
    e = (T.t()[None, None, :, :, None] * d[:, :, None, :, :]).sum(-2)
    e = _wrap32(e + (1 << (s1 - 1))) >> s1
    r = (e[..., :, :, None] * T[None, None, None, :, :]).sum(-2)
    r = _wrap32(r + (1 << (s2 - 1))) >> s2
    rec = pred + r.reshape(P, B, n * n)
    return torch.minimum(rec.clamp(min=0), maxvals[:, None, None])


def _refs_vec(corner, top, lcol):
    return torch.cat([corner, top, lcol], -1)


def _refs16(up, upleft, upright, left, ib):
    """(P, B, 65) reference vector of a 16x16 block from its neighbour
    16-tiles; the bottom-left half reads the init value."""
    return _refs_vec(upleft[:, :, 15, 15:16],
                     torch.cat([up[:, :, 15, :], upright[:, :, 15, :]], -1),
                     torch.cat([left[:, :, :, 15], ib(16)], -1))


def _refs8(s, cur, up, upleft, upright, left, ib):
    """(P, B, 33) reference vector of 8x8 sub-block s of a 16x16 block, from
    the in-flight block `cur` and the neighbour 16-tiles (z-order
    causality; `ib(k)` gives k init samples)."""
    if s == 0:
        corner, top, lcol = (upleft[:, :, 15, 15:16], up[:, :, 15, 0:16],
                             left[:, :, 0:16, 15])
    elif s == 1:
        corner = up[:, :, 15, 7:8]
        top = torch.cat([up[:, :, 15, 8:16], upright[:, :, 15, 0:8]], -1)
        lcol = cur[:, :, 0:16, 7]
    elif s == 2:
        corner, top = left[:, :, 7, 15:16], cur[:, :, 7, 0:16]
        lcol = torch.cat([left[:, :, 8:16, 15], ib(8)], -1)
    else:
        corner = cur[:, :, 7, 7:8]
        top = torch.cat([cur[:, :, 7, 8:16], ib(8)], -1)
        lcol = torch.cat([cur[:, :, 8:16, 7], ib(8)], -1)
    return _refs_vec(corner, top, lcol)


def _refs32(up, upleft, upright, left, ib):
    """(P, B, 129) reference vector of a 32x32 CU from its neighbour
    32-tiles; the bottom-left half reads the init value."""
    return _refs_vec(upleft[:, :, 31, 31:32],
                     torch.cat([up[:, :, 31, :], upright[:, :, 31, :]], -1),
                     torch.cat([left[:, :, :, 31], ib(32)], -1))


def _quad_tiles16(q, cur32, up32, upleft32, upright32, left32, ib):
    """Pseudo neighbor 16-tiles (up, upleft, upright, left) for quadrant q
    of a 32-CU (HEVC z-order availability: quadrant 3's up-right 16-block
    is uncoded -> init tile)."""
    sl = lambda t, y, x: t[:, :, y: y + CU, x: x + CU]
    if q == 0:
        return (sl(up32, 16, 0), sl(upleft32, 16, 16), sl(up32, 16, 16),
                sl(left32, 0, 16))
    if q == 1:
        return (sl(up32, 16, 16), sl(up32, 16, 0), sl(upright32, 16, 0),
                sl(cur32, 0, 0))
    if q == 2:
        return (sl(cur32, 0, 0), sl(left32, 0, 16), sl(cur32, 0, 16),
                sl(left32, 16, 16))
    return (sl(cur32, 0, 16), sl(cur32, 0, 0), ib, sl(cur32, 16, 0))


def _decode_cu16(ref16, up, upleft, upright, left, initc, spl, mode16, lev16,
                 m8b, c8b, dq, maxvals, tabs):
    """Decode a batch of 16x16 CUs from their raster-order syntax; only the
    branch the split flag selects is used.  Returns (P, B, 256) int64."""
    P, B = mode16.shape
    ib = lambda k: initc.expand(P, B, k)
    refs16 = _refs16(up, upleft, upright, left, ib)
    rec16 = _int_recon(lev16, _predict(refs16, ref16, mode16, CU, tabs),
                       dq, maxvals, CU, tabs)
    cur = initc[..., None].expand(P, B, CU, CU).clone()
    for s, (dy, dx) in enumerate(SUB_OFF):
        ref8 = ref16.reshape(P, B, CU, CU)[:, :, dy: dy + SUB, dx: dx + SUB]
        pred8 = _predict(_refs8(s, cur, up, upleft, upright, left, ib),
                         ref8.reshape(P, B, SUB * SUB), m8b[:, :, s], SUB, tabs)
        rec8 = _int_recon(c8b[:, :, s], pred8, dq, maxvals, SUB, tabs)
        cur[:, :, dy: dy + SUB, dx: dx + SUB] = rec8.reshape(P, B, SUB, SUB)
    return torch.where(spl[:, :, None] != 0, cur.reshape(P, B, CC), rec16)


def _wavefront_diagonals(nby: int, nbx: int, device):
    """The wavefront schedule as device tensors: per diagonal the CU rows
    it codes and their (up, up-left, up-right, left) neighbour rows."""
    bidx_tab, nbr_tab = _neighbor_schedule(nby, nbx)
    for bidx_np, nbr_np in zip(bidx_tab, nbr_tab):
        yield torch.as_tensor(bidx_np, device=device), torch.as_tensor(nbr_np, device=device)


def wavefront_decode32_plain(ref, s32, m32, c32, s16, modes, c16, dq,
                             maxvals, nby: int, nbx: int):
    """Plain PyTorch version of kernel A, structured as the JAX scan
    (vpcc_tpu hevc.py `_build_decode32.run`): one batched step per
    wavefront diagonal over (PT, nb+2, 1024) CU rows (row nb = init block,
    row nb+1 = write dump).  Integer math in int64 with explicit int32
    wrap-around.  Arguments as `wavefront_decode32`."""
    PT = ref.shape[0]
    device = ref.device
    nb = nby * nbx
    tabs = _tables(device)
    i64 = lambda a: a.to(torch.int64)
    maxv = i64(maxvals)
    dqv = i64(dq)
    initc = ((maxv + 1) // 2)[:, None, None]                # (PT, 1, 1)

    ref_blk = _pad_rows(_blocks(i64(ref), nby, nbx, CU32), initc)
    blk = initc.expand(PT, nb + 2, CC32).clone()
    s32_p = _pad_rows(i64(s32), 0)
    m32_p = _pad_rows(i64(m32), 0)
    c32_p = _pad_rows(i64(c32)[:, :, tabs["izz32"]], 0)
    s16_p = _pad_rows(i64(s16), 0)
    m_p = _pad_rows(i64(modes), 0)
    c16_p = _pad_rows(i64(c16)[:, :, :, tabs["izz16"]], 0)
    c8_p = _pad_rows(
        i64(c16).reshape(PT, nb, 4, 4, SUB * SUB)[..., tabs["izz8"]], 0
    )
    for bidx, nbr in _wavefront_diagonals(nby, nbx, device):
        B = bidx.shape[0]
        tile4 = lambda ids: blk[:, ids].reshape(PT, B, CU32, CU32)
        up, upleft, upright, left = (tile4(nbr[:, k]) for k in range(4))
        ref32 = ref_blk[:, bidx]
        ib = lambda k: initc.expand(PT, B, k)
        refs32 = _refs32(up, upleft, upright, left, ib)
        rec32 = _int_recon(c32_p[:, bidx],
                           _predict(refs32, ref32, m32_p[:, bidx], CU32, tabs),
                           dqv, maxv, CU32, tabs)
        cur32 = initc[..., None].expand(PT, B, CU32, CU32).clone()
        init16 = initc[..., None].expand(PT, B, CU, CU)
        ref32_t = ref32.reshape(PT, B, CU32, CU32)
        for q, (dy, dx) in enumerate(QOFF32):
            u16, ul16, ur16, l16 = _quad_tiles16(q, cur32, up, upleft, upright,
                                                 left, init16)
            tile_q = _decode_cu16(
                ref32_t[:, :, dy: dy + CU, dx: dx + CU].reshape(PT, B, CC),
                u16, ul16, ur16, l16, initc,
                s16_p[:, bidx, q], m_p[:, bidx, q, 0], c16_p[:, bidx, q],
                m_p[:, bidx, q], c8_p[:, bidx, q], dqv, maxv, tabs,
            )
            cur32[:, :, dy: dy + CU, dx: dx + CU] = tile_q.reshape(PT, B, CU, CU)
        tile = torch.where(s32_p[:, bidx, None] != 0,
                           cur32.reshape(PT, B, CC32), rec32)
        blk[:, bidx] = tile
    return _unblocks(blk[:, :nb], nby, nbx, CU32).to(torch.int32)


_WF_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def wavefront_decode32(ref, s32, m32, c32, s16, modes, c16, dq, maxvals,
                       nby: int, nbx: int):
    """Kernel A (csrc/wavefront_decode32.cu): reconstruct (PT, nby*32,
    nbx*32) int32 tile planes from the 32/16/8 syntax.

    ref (PT, Ht, Wt) int32 inter prediction planes; s32/m32 (PT, nb) int8;
    c32 (PT, nb, 1024) int16 zigzag; s16 (PT, nb, 4) int8; modes
    (PT, nb, 4, 4) int8 ([m16, 0, 0, 0] for an unsplit quadrant); c16
    (PT, nb, 4, 256) int16 zigzag (four 64-coefficient 8x8 blocks when the
    quadrant is split); dq/maxvals (PT,) int32.  One launch a call (CUs in
    wavefront order behind per-CU ready flags).  The plain version runs on
    the CPU."""
    if ref.device.type == "cpu":
        return wavefront_decode32_plain(ref, s32, m32, c32, s16, modes, c16,
                                        dq, maxvals, nby, nbx)
    d = ref.device
    PT = ref.shape[0]
    nb = nby * nbx
    for name, t, dtype, shape in (
        ("ref", ref, torch.int32, (PT, nby * CU32, nbx * CU32)),
        ("s32", s32, torch.int8, (PT, nb)),
        ("m32", m32, torch.int8, (PT, nb)),
        ("c32", c32, torch.int16, (PT, nb, CC32)),
        ("s16", s16, torch.int8, (PT, nb, 4)),
        ("modes", modes, torch.int8, (PT, nb, 4, 4)),
        ("c16", c16, torch.int16, (PT, nb, 4, CC)),
        ("dq", dq, torch.int32, (PT,)),
        ("maxvals", maxvals, torch.int32, (PT,)),
    ):
        dev.check_tensor(t, name, dtype, d)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    rec = torch.empty_like(ref)
    flags = torch.zeros(PT * nb + 1, dtype=torch.int32, device=d)
    fn = dev.load_kernel("wavefront_decode32").wavefront_decode32
    fn.argtypes, fn.restype = _WF_ARGS, ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(rec), dev.ptr(ref), dev.ptr(s32), dev.ptr(m32),
            dev.ptr(c32), dev.ptr(s16), dev.ptr(modes), dev.ptr(c16),
            dev.ptr(dq), dev.ptr(maxvals), dev.ptr(_tables(d)["blob"]), dev.ptr(flags),
            PT, nby, nbx, dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("wavefront_decode32", launched.value)
    dev.check_launch("wavefront_decode32", rc)
    return rec


def wavefront_decode16_plain(ref, split, modes, coeffs, dq, maxvals, nby: int, nbx: int):
    """Plain PyTorch version of kernel A's two-level entry, structured as
    the JAX scan (vpcc_tpu hevc.py `_build_decode.run`): one batched step per
    wavefront diagonal of 16x16 CUs over (PT, nb+2, 256) CU rows, each CU
    decoded by `_decode_cu16`.  Arguments as `wavefront_decode16`."""
    PT = ref.shape[0]
    d = ref.device
    nb = nby * nbx
    tabs = _tables(d)
    i64 = lambda a: a.to(torch.int64)
    maxv, dqv = i64(maxvals), i64(dq)
    initc = ((maxv + 1) // 2)[:, None, None]
    ref_blk = _pad_rows(_blocks(i64(ref), nby, nbx, CU), initc)
    blk = initc.expand(PT, nb + 2, CC).clone()
    split_p = _pad_rows(i64(split), 0)
    m_p = _pad_rows(i64(modes), 0)
    c16_p = _pad_rows(i64(coeffs)[:, :, tabs["izz16"]], 0)
    c8_p = _pad_rows(i64(coeffs).reshape(PT, nb, 4, SUB * SUB)[..., tabs["izz8"]], 0)
    for bidx, nbr in _wavefront_diagonals(nby, nbx, d):
        B = bidx.shape[0]
        up, upleft, upright, left = (blk[:, nbr[:, k]].reshape(PT, B, CU, CU)
                                     for k in range(4))
        blk[:, bidx] = _decode_cu16(ref_blk[:, bidx], up, upleft, upright, left, initc,
                                    split_p[:, bidx], m_p[:, bidx, 0], c16_p[:, bidx],
                                    m_p[:, bidx], c8_p[:, bidx], dqv, maxv, tabs)
    return _unblocks(blk[:, :nb], nby, nbx, CU).to(torch.int32)


_WF16_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def wavefront_decode16(ref, split, modes, coeffs, dq, maxvals, nby: int, nbx: int):
    """Kernel A's two-level entry (csrc/wavefront_decode32.cu
    `wavefront_decode16`): reconstruct (PT, nby*16, nbx*16) int32 tile
    planes from the 16/8 syntax, one launch a call (16x16 CUs in wavefront
    order behind per-CU ready flags).  ref (PT, Ht, Wt) int32 inter
    prediction planes; split (PT, nb) int8; modes (PT, nb, 4) int8 ([m16, 0,
    0, 0] for a whole block); coeffs (PT, nb, 256) int16 zigzag (four
    64-level 8x8 blocks when split); dq/maxvals (PT,) int32.  The plain
    version runs on the CPU."""
    if ref.device.type == "cpu":
        return wavefront_decode16_plain(ref, split, modes, coeffs, dq, maxvals, nby, nbx)
    d = ref.device
    PT = ref.shape[0]
    nb = nby * nbx
    for name, t, dtype, shape in (
        ("ref", ref, torch.int32, (PT, nby * CU, nbx * CU)),
        ("split", split, torch.int8, (PT, nb)),
        ("modes", modes, torch.int8, (PT, nb, 4)),
        ("coeffs", coeffs, torch.int16, (PT, nb, CC)),
        ("dq", dq, torch.int32, (PT,)),
        ("maxvals", maxvals, torch.int32, (PT,)),
    ):
        dev.check_tensor(t, name, dtype, d)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    rec = torch.empty_like(ref)
    flags = torch.zeros(PT * nb + 1, dtype=torch.int32, device=d)
    fn = dev.load_kernel("wavefront_decode32").wavefront_decode16
    fn.argtypes, fn.restype = _WF16_ARGS, ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(rec), dev.ptr(ref), dev.ptr(split), dev.ptr(modes), dev.ptr(coeffs),
            dev.ptr(dq), dev.ptr(maxvals), dev.ptr(_tables(d)["blob"]), dev.ptr(flags), PT,
            nby, nbx, dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("wavefront_decode16", launched.value)
    dev.check_launch("wavefront_decode16", rc)
    return rec


# ---------------------------------------------------------------------------
# plane API

def _inter_flags(split, modes):
    """(nb,) int32: 1 where the 16x16 CU's chosen coding uses the inter
    mode anywhere (its 16x16 mode, or any 8x8 mode when split): the CUs that
    carry an MV.  split (nb,), modes (nb, 4)."""
    any8 = (modes == tab.MODE_INTER).any(axis=1)
    return np.where(split != 0, any8, modes[:, 0] == tab.MODE_INTER).astype(np.int32)


def _inter_flags32(s32, m32, s16, modes):
    """(nb32,) int32: 1 where any chosen mode in the 32-CU's coded tree
    uses the inter lane.  s16 (nb,4), modes (nb,4,4)."""
    q_inter = np.where(
        s16 != 0,
        (modes == tab.MODE_INTER).any(axis=2),
        modes[:, :, 0] == tab.MODE_INTER,
    ).any(axis=1)
    return np.where(s32 != 0, q_inter, m32 == tab.MODE_INTER).astype(np.int32)


def decode_planes(payload: bytes, refs=None, device=None) -> torch.Tensor:
    """Inverse of `encode_planes` (either package's): payload -> (P, H, W)
    int32 on `device` (the refs' device when refs are given)."""
    flags = payload[5]
    if (flags & FLAG_INTER) and refs is None:
        raise ValueError("inter-coded payload requires refs")
    syn = parse_planes32(payload)
    d = refs.device if refs is not None else dev.resolve_device(device)
    if syn["flags"] & FLAG_CU32:
        return _decode_planes32(syn, refs, d)
    return _decode_planes16(syn, refs, d)


def _read_sao(payload: bytes, pos: int, T: int, ry: int, rx: int):
    """The SAO blob of a plane at `pos`: (sao_cls (T, ry, rx), sao_off
    (T, ry, rx, 4)) int8 and the position after it."""
    (sln,) = struct.unpack("<I", payload[pos: pos + 4])
    pos += 4
    n_sao = T * ry * rx * 5
    sao_flat = entropy.decode_coeffs(
        payload[pos: pos + sln], (n_sao + 63) // 64
    ).reshape(-1)[:n_sao].reshape(T, ry, rx, 5)
    return sao_flat[..., 0].astype(np.int8), sao_flat[..., 1:].astype(np.int8), pos + sln


def parse_planes16(payload: bytes) -> dict:
    """Entropy-decode a two-level (16/8) payload (reference `decode_planes`,
    hevc.py:1617-1667) into its host syntax arrays: header fields (H, W, P,
    flags, ty, tx, nby, nbx), per-plane qps and maxvals, and per tile plane
    split (PT, nb), modes (PT, nb, 4) ([m16, 0, 0, 0] for a whole block),
    coeffs (PT, nb, 256) zigzag (the four 8x8 blocks when split), mv
    (PT, nb, 2), sao_cls (PT, Ry, Rx), sao_off (PT, Ry, Rx, 4) over 16-px
    regions (zero without FLAG_SAO16); int8/int16 as the encoder emits
    them."""
    H, W, P, flags, ty, tx = struct.unpack("<HHBBBB", payload[:8])
    motion = bool(flags & FLAG_MC)
    pos = 8
    Hp, Wp = _padded_dims(H, W, ty, tx, CU)
    nby, nbx = Hp // ty // CU, Wp // tx // CU
    nb = nby * nbx
    T = ty * tx
    qps = np.zeros(P, np.int32)
    maxvals = np.zeros(P, np.int32)
    split = np.zeros((P * T, nb), np.int8)
    modes = np.zeros((P * T, nb, 4), np.int8)
    coeffs = np.zeros((P * T, nb, CC), np.int16)
    mv = np.zeros((P * T, nb, 2), np.int8)
    sao_cls = np.zeros((P * T, nby, nbx), np.int8)   # one 16-px region a CU
    sao_off = np.zeros((P * T, nby, nbx, 4), np.int8)
    for p in range(P):
        qps[p], maxvals[p] = struct.unpack("<BH", payload[pos: pos + 3])
        pos += 3
        (ln,) = struct.unpack("<I", payload[pos: pos + 4])
        pos += 4
        s_, m16_, c16_, m8_, c8_ = entropy.decode_hevc_plane(payload[pos: pos + ln], T * nby, nbx)
        pos += ln
        spl = s_ != 0
        m4 = np.where(spl[:, None], m8_,
                      np.concatenate([m16_[:, None], np.zeros((T * nb, 3), np.int32)], 1))
        sl = slice(p * T, (p + 1) * T)
        split[sl] = s_.astype(np.int8).reshape(T, nb)
        modes[sl] = m4.astype(np.int8).reshape(T, nb, 4)
        coeffs[sl] = np.where(spl[:, None], c8_.reshape(T * nb, CC), c16_
                              ).astype(np.int16).reshape(T, nb, CC)
        if motion:
            (mvln,) = struct.unpack("<I", payload[pos: pos + 4])
            pos += 4
            mv[sl] = entropy.decode_mvs(payload[pos: pos + mvln], _inter_flags(s_, m4)
                                        ).astype(np.int8).reshape(T, nb, 2)
            pos += mvln
        if flags & FLAG_SAO16:
            sao_cls[sl], sao_off[sl], pos = _read_sao(payload, pos, T, nby, nbx)
    return dict(H=H, W=W, P=P, flags=flags, ty=ty, tx=tx, nby=nby, nbx=nbx,
                qps=qps, maxvals=maxvals, split=split, modes=modes, coeffs=coeffs, mv=mv,
                sao_cls=sao_cls, sao_off=sao_off)


def _decode_planes16(syn: dict, refs, d):
    """Reconstruct the planes of parsed two-level syntax (`parse_planes16`)
    on d: kernel B at 16-px CUs, kernel A's two-level entry, kernel O,
    kernel K's apply over 16-px regions (FLAG_SAO16)."""
    H, W, P, flags, ty, tx, nby, nbx = (
        syn[k] for k in ("H", "W", "P", "flags", "ty", "tx", "nby", "nbx"))
    qps, maxvals = syn["qps"], syn["maxvals"]
    T = ty * tx
    tt = lambda a: torch.as_tensor(a, device=d)
    ref = _tile_refs(refs if flags & FLAG_INTER else None, P, H, W, ty, tx, CU, d)
    maxv_t = tt(np.repeat(maxvals, T))
    if flags & FLAG_MC:
        ref = half_pel_mc(ref, tt(syn["mv"].astype(np.int32)), maxv_t, CU)
    dq_t = tt(tab.DQ64[np.clip(np.repeat(qps, T), 0, 51)].astype(np.int32))
    rec = wavefront_decode16(ref, tt(syn["split"]), tt(syn["modes"]), tt(syn["coeffs"]), dq_t,
                             maxv_t, nby, nbx)
    if flags & FLAG_DEBLOCK:
        rec = deblock_planes(rec, tt(np.repeat(qps, T)), maxv_t)
    if flags & FLAG_SAO16:
        rec = sao_apply(rec.contiguous(), tt(syn["sao_cls"]), tt(syn["sao_off"]), maxv_t,
                        region=CU)
    return _untile(rec, P, ty, tx)[:, :H, :W].contiguous()


def _tile_refs(refs, P: int, H: int, W: int, ty: int, tx: int, cu: int, d):
    """The decoder's reference planes (zeros without refs), edge-padded to
    the codec tiles of `cu`-sized CUs and cut into them: (P*ty*tx, Ht, Wt)
    int32."""
    if refs is not None:
        ref = refs.to(device=d, dtype=torch.int32)
    else:
        ref = torch.zeros((P, H, W), dtype=torch.int32, device=d)
    Hp, Wp = _padded_dims(H, W, ty, tx, cu)
    if (Hp, Wp) != (H, W):
        ref = _edge_pad(ref, 0, Hp - H, 0, Wp - W)
    return _tiles_of(ref, ty, tx).contiguous()


def parse_planes32(payload: bytes) -> dict:
    """Entropy-decode a three-level payload into its host syntax arrays:
    header fields (H, W, P, flags, ty, tx, nby, nbx), per-plane qps and
    maxvals, and per tile plane s32, m32 (PT, nb), c32 (PT, nb, 1024)
    zigzag, s16 (PT, nb, 4), modes (PT, nb, 4, 4) ([m16, 0, 0, 0] for an
    unsplit quadrant), c16 (PT, nb, 4, 256), mv (PT, nb, 2), sao_cls
    (PT, Ry, Rx), sao_off (PT, Ry, Rx, 4); int8/int16 as the encoder
    emits them.  A two-level payload (FLAG_CU32 clear) is parsed by
    `parse_planes16`, whose arrays it returns."""
    H, W, P, flags, ty, tx = struct.unpack("<HHBBBB", payload[:8])
    if not flags & FLAG_CU32:
        return parse_planes16(payload)
    motion = bool(flags & FLAG_MC)
    pos = 8
    Hp, Wp = _padded_dims(H, W, ty, tx, CU32)
    nby, nbx = Hp // ty // CU32, Wp // tx // CU32
    nb = nby * nbx
    T = ty * tx
    qps = np.zeros(P, np.int32)
    maxvals = np.zeros(P, np.int32)
    s32 = np.zeros((P * T, nb), np.int8)
    m32 = np.zeros((P * T, nb), np.int8)
    c32 = np.zeros((P * T, nb, CC32), np.int16)
    s16 = np.zeros((P * T, nb, 4), np.int8)
    modes = np.zeros((P * T, nb, 4, 4), np.int8)
    c16 = np.zeros((P * T, nb, 4, CC), np.int16)
    mv = np.zeros((P * T, nb, 2), np.int8)
    ry, rx = Hp // ty // SAO_REGION, Wp // tx // SAO_REGION
    sao_cls = np.zeros((P * T, ry, rx), np.int8)
    sao_off = np.zeros((P * T, ry, rx, 4), np.int8)
    for p in range(P):
        qps[p], maxvals[p] = struct.unpack("<BH", payload[pos: pos + 3])
        pos += 3
        (ln,) = struct.unpack("<I", payload[pos: pos + 4])
        pos += 4
        S32, M32, C32v, S16, M16, C16v, M8, C8v = entropy.decode_hevc32_plane(
            payload[pos: pos + ln], T * nby, nbx
        )
        pos += ln
        sl = slice(p * T, (p + 1) * T)
        s32[sl] = S32.astype(np.int8).reshape(T, nb)
        m32[sl] = M32.astype(np.int8).reshape(T, nb)
        c32[sl] = C32v.astype(np.int16).reshape(T, nb, CC32)
        s16[sl] = S16.astype(np.int8).reshape(T, nb, 4)
        m4 = np.where(
            S16[:, :, None] != 0, M8,
            np.concatenate(
                [M16[:, :, None], np.zeros((T * nb, 4, 3), np.int32)], 2
            ),
        )
        modes[sl] = m4.astype(np.int8).reshape(T, nb, 4, 4)
        cq = np.where(S16[:, :, None] != 0, C8v.reshape(T * nb, 4, CC), C16v)
        c16[sl] = cq.astype(np.int16).reshape(T, nb, 4, CC)
        if motion:
            (mvln,) = struct.unpack("<I", payload[pos: pos + 4])
            pos += 4
            inter = _inter_flags32(S32, M32, S16, m4)
            mv[sl] = entropy.decode_mvs(
                payload[pos: pos + mvln], inter
            ).astype(np.int8).reshape(T, nb, 2)
            pos += mvln
        sao_cls[sl], sao_off[sl], pos = _read_sao(payload, pos, T, ry, rx)
    return dict(H=H, W=W, P=P, flags=flags, ty=ty, tx=tx, nby=nby, nbx=nbx,
                qps=qps, maxvals=maxvals, s32=s32, m32=m32, c32=c32, s16=s16,
                modes=modes, c16=c16, mv=mv, sao_cls=sao_cls, sao_off=sao_off)


def _decode_planes32(syn: dict, refs, d):
    """Reconstruct the planes of parsed syntax (`parse_planes32`) on d."""
    H, W, P, flags, ty, tx, nby, nbx = (
        syn[k] for k in ("H", "W", "P", "flags", "ty", "tx", "nby", "nbx"))
    qps, maxvals = syn["qps"], syn["maxvals"]
    s32, m32, c32, s16, modes, c16, mv, sao_cls, sao_off = (
        syn[k] for k in ("s32", "m32", "c32", "s16", "modes", "c16", "mv",
                         "sao_cls", "sao_off"))
    T = ty * tx
    tt = lambda a: torch.as_tensor(a, device=d)
    ref = _tile_refs(refs if flags & FLAG_INTER else None, P, H, W, ty, tx, CU32, d)
    qps_t = tt(np.repeat(qps, T))
    maxv_t = tt(np.repeat(maxvals, T))
    if flags & FLAG_MC:
        ref = half_pel_mc(ref, tt(mv.astype(np.int32)), maxv_t, CU32)
    dq_t = tt(tab.DQ64[np.clip(np.repeat(qps, T), 0, 51)].astype(np.int32))
    rec = wavefront_decode32(ref, tt(s32), tt(m32), tt(c32), tt(s16),
                             tt(modes), tt(c16), dq_t, maxv_t, nby, nbx)
    if flags & FLAG_DEBLOCK:
        rec = deblock_planes(rec, qps_t.to(torch.int32), maxv_t.to(torch.int32))
    rec = sao_apply(rec.contiguous(), tt(sao_cls), tt(sao_off), maxv_t)
    return _untile(rec, P, ty, tx)[:, :H, :W].contiguous()


# ---------------------------------------------------------------------------
# RGB 4:2:0 layer

def _downsample_420_int(plane):
    """Integer-exact 2x2 mean (rounded)."""
    h, w = plane.shape
    return (plane.reshape(h // 2, 2, w // 2, 2).sum((1, 3)) + 2) >> 2


def rgb_to_int_planes_plain(attr):
    """(H, W, 3) uint8 or int32 RGB -> (y (H, W), cb, cr (H/2, W/2)) int32: full-range
    BT.709 in XLA's fused float32 order (`color.rgb_to_ycbcr`), rounded half
    to even, clipped to 0..255, chroma as the integer 2x2 mean.  Plain
    version of kernel Q's `rgb_to_int_planes`."""
    ycc = color.rgb_to_ycbcr(attr)
    to8 = lambda p: torch.round(p).clamp(0, 255).to(torch.int32)
    return (to8(ycc[..., 0]), _downsample_420_int(to8(ycc[..., 1])),
            _downsample_420_int(to8(ycc[..., 2])))


def int_planes_to_rgb_plain(y, cb, cr):
    """(y (H, W), cb, cr (H/2, W/2)) int32 -> (H, W, 3) uint8 RGB: nearest
    2x chroma upsample, then `color.ycbcr_to_rgb`.  Plain version of kernel
    Q's `int_planes_to_rgb`."""
    up = lambda p: p.repeat_interleave(2, 0).repeat_interleave(2, 1)
    ycc = torch.stack([y.float(), up(cb).float(), up(cr).float()], -1)
    return color.ycbcr_to_rgb(ycc)


def rgb_to_planes_plain(attr):
    """`rgb_to_planes` in plain PyTorch: `rgb_to_int_planes_plain` of each
    image, stacked."""
    imgs = attr if isinstance(attr, (list, tuple)) or attr.ndim == 4 else attr[None]
    outs = [rgb_to_int_planes_plain(im) for im in imgs]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([torch.stack(o[1:]) for o in outs]))


_TO_PLANES_ARGS = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 4 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
_TO_RGB_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] \
    + [ctypes.c_void_p] * 2
# images of one `rgb_to_planes` launch, at most (csrc/color_convert.cu kMaxBatch)
TO_PLANES_MAX_BATCH = 64


def rgb_to_planes(attr):
    """Kernel Q (csrc/color_convert.cu) `rgb_to_planes`: the reference's
    `_rgb_to_int_planes(attr, None)` (hevc.py:1766) of a batch of images in
    one launch.  attr: an (H, W, 3) or (B, H, W, 3) uint8 (decoded) or
    int32 (the encoder's 0..255 images) RGB tensor, or a sequence of B such
    (H, W, 3) tensors of one shape and type.  Returns (y (B, H, W), chroma
    (B, 2, H/2, W/2)) int32, cb and cr of each image side by side (B = 1
    for a single image), views of one allocation; `rgb_to_planes_plain` for
    CPU tensors."""
    seq = isinstance(attr, (list, tuple))
    first = attr[0] if seq else attr
    if first.device.type == "cpu":
        return rgb_to_planes_plain(attr)
    d, dt = first.device, first.dtype
    if dt not in (torch.uint8, torch.int32):
        raise TypeError(f"rgb_to_planes: expected uint8 or int32 RGB, got {dt}")
    shape = first.shape[-3:]
    if seq:
        for im in attr:
            dev.check_tensor(im, "attr", dt, d, 3)
            if im.shape != shape:
                raise ValueError(f"rgb_to_planes: images of shapes {tuple(shape)} and "
                                 f"{tuple(im.shape)}")
        ptrs = [im.data_ptr() for im in attr]
    else:
        attr = attr.contiguous()
        if attr.ndim not in (3, 4):
            raise ValueError(f"rgb_to_planes: expected (H, W, 3) or (B, H, W, 3), got "
                             f"{tuple(attr.shape)}")
        step = shape.numel() * attr.element_size()
        ptrs = [attr.data_ptr() + b * step for b in range(attr.numel() // shape.numel())]
    H, W, C = shape
    B = len(ptrs)
    if C != 3 or H % 2 or W % 2:
        raise ValueError(f"rgb_to_planes: expected (even H, even W, 3) images, got "
                         f"{tuple(shape)}")
    if B > TO_PLANES_MAX_BATCH:
        raise ValueError(f"rgb_to_planes: {B} images, at most {TO_PLANES_MAX_BATCH} a call")
    n = B * H * W
    # one allocation; slicing it costs the host less than `split`
    buf = torch.empty(n + n // 2, dtype=torch.int32, device=d)
    y, chroma = buf[:n].view(B, H, W), buf[n:].view(B, 2, H // 2, W // 2)
    rc = dev.kernel_fn("color_convert", "rgb_to_planes", _TO_PLANES_ARGS)(
        (ctypes.c_void_p * B)(*ptrs), B, first.element_size(), H, W, color.INV_CB,
        color.INV_CR, y.data_ptr(), chroma.data_ptr(), dev.stream_handle())
    dev.count_launch("color_convert", 1 if n else 0)
    dev.check_launch("color_convert", rc)
    return y, chroma


def _rgb_to_int_planes(attr):
    """The reference's `_rgb_to_int_planes(attr, None)` (hevc.py:1766) of
    one (H, W, 3) image as (y (H, W), cb, cr (H/2, W/2)): views of
    `rgb_to_planes`'s outputs."""
    y, c = rgb_to_planes(attr)
    return y[0], c[0, 0], c[0, 1]


def _int_planes_to_rgb(y, cb, cr):
    """Kernel Q (csrc/color_convert.cu) `int_planes_to_rgb`: the reference's
    `_int_planes_to_rgb` (hevc.py:1783) in one launch, a thread per 2x4
    luma block (the quad form where W is not a multiple of 4); cb and cr
    may be the two planes of one (2, H/2, W/2) chroma tensor;
    `int_planes_to_rgb_plain` for CPU tensors."""
    if y.device.type == "cpu":
        return int_planes_to_rgb_plain(y, cb, cr)
    d = y.device
    dev.check_tensor(y, "y", torch.int32, d, 2)
    dev.check_tensor(cb, "cb", torch.int32, d, 2)
    dev.check_tensor(cr, "cr", torch.int32, d, 2)
    H, W = y.shape
    if H % 2 or W % 2 or cb.shape != (H // 2, W // 2) or cr.shape != cb.shape:
        raise ValueError(f"int_planes_to_rgb: planes {tuple(y.shape)}, {tuple(cb.shape)}, "
                         f"{tuple(cr.shape)}: expected even luma dims and half-size chroma")
    rgb = torch.empty((H, W, 3), dtype=torch.uint8, device=d)
    rc = dev.kernel_fn("color_convert", "int_planes_to_rgb", _TO_RGB_ARGS)(
        y.data_ptr(), cb.data_ptr(), cr.data_ptr(), H, W, color.INV_G, rgb.data_ptr(),
        dev.stream_handle())
    dev.count_launch("color_convert", 1 if H * W else 0)
    dev.check_launch("color_convert", rc)
    return rgb


def rgb_refs(rgb) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoded RGB -> ((1,H,W) luma, (2,H/2,W/2) chroma) int32 planes: the
    inter-layer prediction references, derived identically on both sides."""
    y, chroma = rgb_to_planes(rgb)
    return y, chroma[0]


def peek_rgb_dims(payload: bytes) -> Tuple[int, int]:
    """(H, W) of the luma plane inside an encode_rgb payload."""
    return struct.unpack("<HH", payload[8:12])


def decode_rgb(payload: bytes, refs=None, device=None):
    """encode_rgb payload -> (RGB (H, W, 3) uint8, (recy, recc) refs)."""
    ly, lc = struct.unpack("<II", payload[:8])
    py = payload[8: 8 + ly]
    pc = payload[8 + ly: 8 + ly + lc]
    ry = rc = None
    if refs is not None:
        ry, rc = refs
    recy = decode_planes(py, refs=ry, device=device)
    recc = decode_planes(pc, refs=rc, device=recy.device)
    return _int_planes_to_rgb(recy[0], recc[0], recc[1]), (recy, recc)


# ===========================================================================
# Encoder (the encode half of vpcc_tpu/video/hevc.py, three-level syntax)
#
# Float32 order.  The RD decisions are float32, and the kernels and their
# plain versions evaluate every float operation in one order, so that they
# agree bit for bit on the card.  The order is that of the reference's XLA
# CPU program, read off it by probing with crafted inputs (it contracts a
# multiply feeding an add into one fused multiply-add, `dev.fma_f32` /
# `__fmaf_rn`, and vectorizes its dots and reduce loops):
# * forward DCT: u[i, k] = sum_j Cf[i, j] r[j, k], then c[i, l] =
#   sum_k u[i, k] Cf[l, k], each sum as interleaved fma chains (`_dct_dot`);
# * lv = min(floor(fma(|c|, 1/qstep, 0.33)), 32767);
# * distortion term d*d with d = fma(-lv, qstep, |c|); the rate term of a
#   level from `hevc_tables.rd_bits_table` (XLA's own log2 values);
# * the n*n-term sums of distortion and rate in the order of XLA's reduce
#   loops (`_rd_sum`: for 32x32 row by row, for 16x16 and 8x8 eight lanes
#   over the rows; d*d as fused multiply-adds);
# * bits = fma(0.12, last + 1, bits); cost = fma(lam, bits + mode_bits,
#   w * dist) (XLA contracts the rate product, not the distortion one);
#   the inter lane adds its penalty afterwards;
# * the mode is the first minimum (strict <, ascending mode).
# Each block size's costs equal those of the reference's `_rd_choose` bit
# for bit on random inputs; on the bench GOF every CU's decision, hence
# every payload, equals the reference's (tests/test_torch_video_encode.py
# holds a crop with a tie that any other order resolves differently).
# The two-level encoder (`_build_encode`, planes above 10 bits) compiles
# `_code_cu16` into another program; its 16x16 and 8x8 reduces and dots
# have `_build_encode32`'s shapes but for the batch extent, and on real
# 11-bit content (the vox11 GOF at geometryNominal2dBitdepth=11) the same
# order is the only one of four that gives its decisions
# (tests/torch_make_rdo_tie_crop16.py; the crop data/rdo_tie_crop16.npz).

RD_LAST_WEIGHT = np.float32(0.12)
RD_ROUND = np.float32(0.33)


def _tile_grid(H: int, W: int, cu: int = CU):
    """(ty, tx) codec-tile split of an (H, W) plane: tiles of ~256 pixels
    per axis (at most 16 per axis)."""
    target_cus = max(256 // cu, 2)

    def split(n):
        cus = -(-n // cu)
        return max(1, min((cus + target_cus - 1) // target_cus, 16))

    return split(H), split(W)


def _mv_bits(R: int) -> np.ndarray:
    """Approximate signed Exp-Golomb bin count per MV component value."""
    v = np.arange(-R, R + 1)
    a = np.abs(v)
    return np.where(v == 0, 1.0, 3.0 + 2.0 * np.floor(np.log2(np.maximum(a, 1)))
                    ).astype(np.float32)


def _row_sum(x: torch.Tensor, n: int, square: bool) -> torch.Tensor:
    """Sum over the last axis of x (..., n*n) float32 (of x*x with
    `square`) in the order of XLA's CPU reduce loop: per row of n, an 8-lane
    accumulator [running sum, 0 x 7] takes the row's n/8 vectors in order
    (fused x*x + lane, or a plain add), then lanes 0-3 + 4-7, 0-1 + 2-3,
    0 + 1 give the new running sum.  Lanes 1-7 do not depend on the running
    sum, so they are computed for every row at once."""
    sh = x.shape[:-1]
    xr = x.reshape(*sh, n, n // 8, 8)
    lanes = torch.zeros((*sh, n, 8), dtype=torch.float32, device=x.device)
    for u in range(n // 8):
        e = xr[..., u, :]
        lanes = dev.fma_f32(e, e, lanes) if square else lanes + e
    t2 = lanes[..., 2] + lanes[..., 6]
    q = (lanes[..., 1] + lanes[..., 5]) + (lanes[..., 3] + lanes[..., 7])
    acc = torch.zeros(sh, dtype=torch.float32, device=x.device)
    for i in range(n):
        for u in range(n // 8):
            e = xr[..., i, u, 0]
            acc = dev.fma_f32(e, e, acc) if square else acc + e
        acc = ((acc + lanes[..., i, 4]) + t2[..., i]) + q[..., i]
    return acc


# ---------------------------------------------------------------------------
# kernel J: motion search (integer full search + half-pel refinement)

def _sample_half_sub(planes_pad, mv, R, nbx, bs):
    """Candidate prediction at even pixels only: planes_pad (P, 4, H+2R,
    W+2R) half-pel planes, mv (P, nb, 2) half-pel units."""
    P = planes_pad.shape[0]
    H = planes_pad.shape[2] - 2 * R
    W = planes_pad.shape[3] - 2 * R
    yy = torch.arange(0, H, 2, device=mv.device)[:, None]
    xx = torch.arange(0, W, 2, device=mv.device)[None, :]
    bi = (yy // bs) * nbx + (xx // bs)
    mvy = mv[:, :, 0][:, bi]
    mvx = mv[:, :, 1][:, bi]
    fi = (mvy & 1) * 2 + (mvx & 1)
    iy = (yy[None] + R + (mvy >> 1)).clamp(0, H + 2 * R - 1)
    ix = (xx[None] + R + (mvx >> 1)).clamp(0, W + 2 * R - 1)
    Hp, Wp = H + 2 * R, W + 2 * R
    flat = ((fi * Hp + iy) * Wp + ix).reshape(P, -1).long()
    return torch.gather(planes_pad.reshape(P, -1), 1, flat).reshape(P, H // 2, W // 2)


def _sad_sub(a, b, nby, nbx, bs):
    P = a.shape[0]
    h = bs // 2
    return ((a.long() - b.long()).abs().reshape(P, nby, h, nbx, h)
            .sum((2, 4)).reshape(P, nby * nbx).to(torch.float32))


def motion_search_plain(src, ref, lam, maxvals, bs: int):
    """Plain version of kernel J (vpcc_tpu hevc.py `_motion_search_half`
    with `_motion_search`, `_sad_sub`, `_apply_motion_half_sub`).

    src/ref (P, H, W) int32 tile planes, lam (P,) float32, maxvals (P,)
    int32, bs the CU size.  Full search over +-MV_RANGE of per-CU SAD +
    lam * MV bins (cost = fma(lam, bins, sad); ties to the smallest linear
    index, row-major), then the plus-shaped half-pel refinement scored on
    the 2x-subsampled lattice.  Returns (mv (P, nb, 2) int32 in half-sample
    units, mvcost (P, nb) float32)."""
    R = MV_RANGE
    P, H, W = src.shape
    nby, nbx = H // bs, W // bs
    nb = nby * nbx
    w = 2 * R + 1
    d = src.device
    padr = _edge_pad(ref, R, R, R, R)
    bits1 = torch.as_tensor(_mv_bits(R), device=d)
    src64 = src.long()
    lam_c = lam[None, :, None]
    best_cost = torch.full((P, nb), float("inf"), dtype=torch.float32, device=d)
    best_i = torch.zeros((P, nb), dtype=torch.int64, device=d)
    for iy in range(w):
        slab = padr[:, iy: iy + H, :]
        sh = torch.stack([slab[:, :, dx: dx + W] for dx in range(w)])  # (w, P, H, W)
        sad = ((src64[None] - sh.long()).abs().reshape(w, P, nby, bs, nbx, bs)
               .sum((3, 5)).reshape(w, P, nb).to(torch.float32))
        bins = (bits1[iy] + bits1)[:, None, None].expand(w, P, nb)
        cost = dev.fma_f32(lam_c.expand(w, P, nb), bins, sad)
        k = torch.argmin(cost, 0)
        row_cost = torch.gather(cost, 0, k[None])[0]
        better = row_cost < best_cost
        best_cost = torch.where(better, row_cost, best_cost)
        best_i = torch.where(better, iy * w + k, best_i)
    mv_i = torch.stack([best_i // w - R, best_i % w - R], -1)
    cost_i = lam[:, None] * (bits1[best_i // w] + bits1[best_i % w])
    src_sub = src[:, ::2, ::2]
    planes = _half_planes(ref, maxvals)                         # (4, P, H, W)
    planes_pad = _edge_pad(planes, R, R, R, R).transpose(0, 1).contiguous()
    best_mv = mv_i * 2
    best = _sad_sub(src_sub, _sample_half_sub(planes_pad, best_mv, R, nbx, bs),
                    nby, nbx, bs)
    half_bit = lam[:, None] * 0.5
    for dy2, dx2 in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        cand = mv_i * 2 + torch.tensor([dy2, dx2], device=d)
        sad = _sad_sub(src_sub, _sample_half_sub(planes_pad, cand, R, nbx, bs),
                       nby, nbx, bs) + half_bit
        better = sad < best
        best = torch.where(better, sad, best)
        best_mv = torch.where(better[:, :, None], cand, best_mv)
    frac = ((best_mv & 1) != 0).any(-1)
    mvcost = cost_i + torch.where(frac, lam[:, None] * 2.0, torch.zeros_like(cost_i))
    return best_mv.to(torch.int32), mvcost


_MS_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MV_BITS: dict = {}   # device -> the (2R+1,) float32 MV bins, uploaded once


def motion_search(src, ref, lam, maxvals, bs: int):
    """Kernel J (csrc/motion_search.cu): one block per (tile plane, CU),
    samples in [0, 2^16); `motion_search_plain` on the CPU.  Arguments and
    result as the plain version."""
    if src.device.type == "cpu":
        return motion_search_plain(src, ref, lam, maxvals, bs)
    d = src.device
    P, H, W = src.shape
    dev.check_tensor(src, "src", torch.int32, d, 3)
    dev.check_tensor(ref, "ref", torch.int32, d, 3)
    dev.check_tensor(lam, "lam", torch.float32, d, 1)
    dev.check_tensor(maxvals, "maxvals", torch.int32, d, 1)
    if ref.shape != src.shape or H % bs or W % bs or bs not in (16, 32) \
            or lam.shape[0] != P or maxvals.shape[0] != P:
        raise ValueError(f"motion_search: shapes {tuple(src.shape)} / {tuple(ref.shape)}, bs {bs}")
    nb = (H // bs) * (W // bs)
    mv = torch.empty((P, nb, 2), dtype=torch.int32, device=d)
    cost = torch.empty((P, nb), dtype=torch.float32, device=d)
    bits = _MV_BITS.get(d)
    if bits is None:
        bits = _MV_BITS[d] = torch.as_tensor(_mv_bits(MV_RANGE), device=d)
    fn = dev.kernel_fn("motion_search", "motion_search", _MS_ARGS)
    rc = fn(dev.ptr(src), dev.ptr(ref), dev.ptr(lam), dev.ptr(maxvals),
            dev.ptr(bits), dev.ptr(mv), dev.ptr(cost), P, H, W, bs,
            dev.stream_handle())
    dev.count_launch("motion_search", 1 if P * nb else 0)
    dev.check_launch("motion_search", rc)
    return mv, cost


# ---------------------------------------------------------------------------
# kernel K: SAO (edge offset per 32x32 region, 16x16 in the two-level
# codec): search and apply

SAO_OFF_MAX = 7
SAO_RATE_BITS = np.float32(19.0)   # ~3 type bits + 4x4-bit offsets


def sao_search_plain(src, rec, lam, weights, region: int = SAO_REGION):
    """Plain version of kernel K's search (vpcc_tpu hevc.py
    `_sao_search_apply`, the choice of parameters).  src/rec/weights
    (P, H, W) int32 (weights 0/1), lam (P,) float32, regions of region x
    region samples (32; the two-level codec's 16).  Per region and EO
    class: count n and weighted error sum s of each non-flat category
    (integers), offset o = clip(round(s / max(n, 1)), -7, 7), gain =
    sum n*o*o - 2*o*s, cost = fma(lam, 19, gain); the first class whose
    cost is below the best so far (starting at 0 = off) wins.  Returns
    (sao_cls (P, Ry, Rx) int8, sao_off (P, Ry, Rx, 4) int8; offsets 0 where
    the class is off)."""
    P, H, W = rec.shape
    ry, rx = H // region, W // region
    wl = (weights != 0).long()
    diff = (src.long() - rec.long()) * wl

    def region_sum(x):
        return x.reshape(P, ry, region, rx, region).sum((2, 4))

    lam_r = lam[:, None, None].expand(P, ry, rx)
    best_gain = torch.zeros((P, ry, rx), dtype=torch.float32, device=rec.device)
    best_cls = torch.zeros((P, ry, rx), dtype=torch.int64, device=rec.device)
    best_off = torch.zeros((P, ry, rx, 4), dtype=torch.int64, device=rec.device)
    for ci, (dy, dx) in enumerate(_SAO_DIRS):
        cat = _sao_categories(rec, dy, dx)
        gain = torch.zeros((P, ry, rx), dtype=torch.float32, device=rec.device)
        offs = []
        for c in (0, 1, 3, 4):
            m = (cat == c).long() * wl
            n = region_sum(m).to(torch.float32)
            sm = region_sum(diff * m).to(torch.float32)
            o = torch.round(sm / n.clamp(min=1.0)).clamp(-SAO_OFF_MAX, SAO_OFF_MAX)
            gain = gain + n * o * o - 2.0 * o * sm
            offs.append(o.long())
        cost = dev.fma_f32(lam_r, float(SAO_RATE_BITS), gain)
        better = cost < best_gain
        best_gain = torch.where(better, cost, best_gain)
        best_cls = torch.where(better, torch.full_like(best_cls, ci + 1), best_cls)
        best_off = torch.where(better[..., None], torch.stack(offs, -1), best_off)
    best_off = torch.where(best_cls[..., None] > 0, best_off, torch.zeros_like(best_off))
    return best_cls.to(torch.int8), best_off.to(torch.int8)


_SAO_SEARCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SAO_APPLY_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SAO_BOTH_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check_sao(what: str, rec, region: int, *others):
    """Kernel K's int32 planes (rec and the named `others`): one shape, a
    multiple of the region, contiguous and 16-byte aligned (the kernel reads
    and writes runs of four samples).  Returns (P, H, W)."""
    P, H, W = rec.shape
    if region not in (CU, CU32) or H % region or W % region:
        raise ValueError(f"{what}: plane {tuple(rec.shape)} is not a multiple of {region}, "
                         f"or the region is neither {CU} nor {CU32}")
    for name, t in (("rec", rec), *others):
        dev.check_tensor(t, name, torch.int32, rec.device, 3)
        if t.shape != rec.shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return P, H, W


def _check_per_plane(what: str, rec, *vectors):
    """Kernel K's per-plane vectors (name, tensor, dtype): one value a plane."""
    for name, t, dtype in vectors:
        dev.check_tensor(t, name, dtype, rec.device, 1)
        if t.shape[0] != rec.shape[0]:
            raise ValueError(f"{what}: {name} has {t.shape[0]} values for {rec.shape[0]} planes")


def _check_sao_params(what: str, rec, sao_cls, sao_off, region: int):
    P, H, W = rec.shape
    dev.check_tensor(sao_cls, "sao_cls", torch.int8, rec.device, 3)
    dev.check_tensor(sao_off, "sao_off", torch.int8, rec.device, 4)
    if sao_cls.shape != (P, H // region, W // region) or \
            sao_off.shape != (P, H // region, W // region, 4):
        raise ValueError(f"{what}: params {tuple(sao_cls.shape)} / {tuple(sao_off.shape)}")


def sao_search(src, rec, lam, weights, region: int = SAO_REGION):
    """Kernel K, search entry (csrc/sao.cu `sao_search`): one block per
    region; `sao_search_plain` on the CPU."""
    if rec.device.type == "cpu":
        return sao_search_plain(src, rec, lam, weights, region)
    d = rec.device
    P, H, W = _check_sao("sao_search", rec, region, ("src", src), ("weights", weights))
    _check_per_plane("sao_search", rec, ("lam", lam, torch.float32))
    ry, rx = H // region, W // region
    cls = torch.empty((P, ry, rx), dtype=torch.int8, device=d)
    off = torch.empty((P, ry, rx, 4), dtype=torch.int8, device=d)
    fn = dev.kernel_fn("sao", "sao_search", _SAO_SEARCH_ARGS)
    rc = fn(src.data_ptr(), rec.data_ptr(), weights.data_ptr(), lam.data_ptr(),
            cls.data_ptr(), off.data_ptr(), P, H, W, region, dev.stream_handle())
    dev.count_launch("sao", 1 if rec.numel() else 0)
    dev.check_launch("sao", rc)
    return cls, off


def sao_apply(rec, sao_cls, sao_off, maxvals, region: int = SAO_REGION):
    """Kernel K, apply entry (csrc/sao.cu `sao_apply`): one block per
    region; `sao_apply_plain` on the CPU.  sao_cls/sao_off int8."""
    if rec.device.type == "cpu":
        return sao_apply_plain(rec, sao_cls, sao_off, maxvals, region)
    P, H, W = _check_sao("sao_apply", rec, region)
    _check_sao_params("sao_apply", rec, sao_cls, sao_off, region)
    _check_per_plane("sao_apply", rec, ("maxvals", maxvals, torch.int32))
    out = torch.empty_like(rec)
    fn = dev.kernel_fn("sao", "sao_apply", _SAO_APPLY_ARGS)
    rc = fn(rec.data_ptr(), sao_cls.data_ptr(), sao_off.data_ptr(), maxvals.data_ptr(),
            out.data_ptr(), P, H, W, region, dev.stream_handle())
    dev.count_launch("sao", 1 if rec.numel() else 0)
    dev.check_launch("sao", rc)
    return out


def sao_search_apply(src, rec, lam, weights, maxvals, region: int = SAO_REGION):
    """Kernel K's search and apply in one launch (csrc/sao.cu
    `sao_search_apply`), as the reference's `_sao_search_apply` computes
    them: returns (rec_sao (P, H, W) int32, sao_cls (P, Ry, Rx) int8,
    sao_off (P, Ry, Rx, 4) int8).  On the CPU, `sao_search_plain` then
    `sao_apply_plain`."""
    if rec.device.type == "cpu":
        cls, off = sao_search_plain(src, rec, lam, weights, region)
        return sao_apply_plain(rec, cls, off, maxvals, region), cls, off
    d = rec.device
    P, H, W = _check_sao("sao_search_apply", rec, region, ("src", src), ("weights", weights))
    _check_per_plane("sao_search_apply", rec, ("lam", lam, torch.float32),
                     ("maxvals", maxvals, torch.int32))
    ry, rx = H // region, W // region
    cls = torch.empty((P, ry, rx), dtype=torch.int8, device=d)
    off = torch.empty((P, ry, rx, 4), dtype=torch.int8, device=d)
    out = torch.empty_like(rec)
    fn = dev.kernel_fn("sao", "sao_search_apply", _SAO_BOTH_ARGS)
    rc = fn(src.data_ptr(), rec.data_ptr(), weights.data_ptr(), lam.data_ptr(),
            maxvals.data_ptr(), out.data_ptr(), cls.data_ptr(), off.data_ptr(), P, H, W, region,
            dev.stream_handle())
    dev.count_launch("sao", 1 if rec.numel() else 0)
    dev.check_launch("sao", rc)
    return out, cls, off


# ---------------------------------------------------------------------------
# kernel I: wavefront RDO encode of the 32/16/8 CU quadtree

def _predict_all(refs, ref_block, n: int, tabs):
    """All 36 mode predictions of each block: refs (P, B, 4n+1), ref_block
    (P, B, n*n) int64 -> (P, B, 36, n*n) int64."""
    P, B, R = refs.shape
    M = tab.N_MODES
    mode = torch.arange(M, device=refs.device).repeat(B)[None].expand(P, B * M)
    pred = _predict(refs[:, :, None].expand(P, B, M, R).reshape(P, B * M, R),
                    ref_block[:, :, None].expand(P, B, M, n * n).reshape(P, B * M, n * n),
                    mode, n, tabs)
    return pred.reshape(P, B, M, n * n)


def _dct_dot(a, b, n: int):
    """sum_j a[..., j] * b[..., j] over the last axis (n terms) in the order
    of XLA's CPU dot for the transform: n/2-way (n = 32: even and odd terms)
    or 4-way (n <= 16: j mod 4) interleaved fused multiply-add chains, then
    acc0 + acc1, or (acc0 + acc1) + (acc2 + acc3)."""
    ways = 2 if n == 32 else 4
    acc = [None] * ways
    for j in range(n):
        x, y = a[..., j], b[..., j]
        q = j % ways
        acc[q] = x * y if acc[q] is None else dev.fma_f32(x, y, acc[q])
    if ways == 2:
        return acc[0] + acc[1]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _rd_sum(x: torch.Tensor, n: int, square: bool) -> torch.Tensor:
    """The n*n-term distortion (x*x, fused multiply-adds) or rate (adds)
    sum of each mode in the order of XLA's CPU reduce loop: `_row_sum` for
    32x32 blocks; for 16x16 and 8x8, eight lanes over the rows (lane k takes
    rows k, k + 8, ..., each column by column), then lanes 0-3 + 4-7, 0-1 +
    2-3, 0 + 1."""
    if n == 32:
        return _row_sum(x, n, square)
    xr = x.reshape(*x.shape[:-1], n // 8, 8, n)
    lanes = None
    for i0 in range(n // 8):
        for col in range(n):
            e = xr[..., i0, :, col]
            if lanes is None:
                lanes = e * e if square else e + 0.0
            else:
                lanes = dev.fma_f32(e, e, lanes) if square else lanes + e
    lanes = lanes[..., :4] + lanes[..., 4:]
    lanes = lanes[..., :2] + lanes[..., 2:]
    return lanes[..., 0] + lanes[..., 1]


def _rd_choose(src_v, allp, wblk, pen, qstep, inv_q, lam, n: int, tabs):
    """Transform-domain RDO over the 36 modes in the float32 order of the
    section comment.  src_v (P, B, n*n), allp (P, B, 36, n*n) int64, wblk
    and pen (P, B) float32 (pen is added to the inter lane), qstep, inv_q,
    lam (P,) float32.  Returns (mode (P, B), raster levels of the chosen
    mode (P, B, n*n) int64, its prediction, cost (P, B) float32)."""
    P, B, M, nn = allp.shape
    Cf = tabs[f"Cf{n}"]
    r = (src_v[:, :, None, :] - allp).to(torch.float32).reshape(P, B, M, n, n)
    # u[i, k] = sum_j Cf[i, j] r[j, k]; c[i, l] = sum_k u[i, k] Cf[l, k]
    u = _dct_dot(Cf[:, None, :], r.transpose(-1, -2)[..., None, :, :], n)
    c = _dct_dot(u[..., :, None, :], Cf[None, :, :], n)
    c = c.reshape(P, B, M, nn)
    ca = c.abs()
    bc = lambda v: v[:, None, None, None].expand_as(ca)
    lv = torch.floor(dev.fma_f32(ca, bc(inv_q), float(RD_ROUND))).clamp(max=tab.LEVEL_MAX)
    dd = dev.fma_f32(-lv, bc(qstep), ca)
    dist = _rd_sum(dd, n, square=True)
    bits = _rd_sum(tabs["rd_bits"][lv.long()], n, square=False)
    izz = tabs[f"izz{n}"]
    last = torch.where(lv > 0, izz.expand_as(lv), torch.full_like(izz, -1).expand_as(lv)
                       ).amax(-1).to(torch.float32)
    bits = dev.fma_f32(torch.full_like(bits, float(RD_LAST_WEIGHT)), last + 1.0, bits)
    wd = wblk[:, :, None] * dist
    cost = dev.fma_f32(lam[:, None, None].expand_as(wd), bits + tabs["mode_bits"], wd)
    cost[:, :, tab.MODE_INTER] = cost[:, :, tab.MODE_INTER] + pen
    mode = torch.argmin(cost, 2)
    sel = mode[:, :, None, None].expand(P, B, 1, nn)
    lev = (torch.sign(c) * lv).long()
    return (mode, torch.gather(lev, 2, sel)[:, :, 0], torch.gather(allp, 2, sel)[:, :, 0],
            torch.gather(cost, 2, mode[:, :, None])[:, :, 0])


def _code_cu16(src16, ref16, up, upleft, upright, left, initc, w16, w8, pen,
               qstep, inv_q, lam, dq, maxv, tabs):
    """The 16x16 candidate against the four-8x8 z-order split of a batch of
    16x16 blocks (vpcc_tpu hevc.py `_code_cu16`).  pen (P, B) is the inter
    lane's penalty at 16x16 (the 8x8 blocks pay a quarter of its MV part,
    passed as `pen8`).  Returns (tile (P, B, 256), split (P, B), m16,
    m8 (P, B, 4), lev16 zigzag (P, B, 256), c8 zigzag (P, B, 256),
    min cost (P, B))."""
    pen16, pen8 = pen
    P, B = src16.shape[:2]
    ib = lambda k: initc.expand(P, B, k)
    allp16 = _predict_all(_refs16(up, upleft, upright, left, ib), ref16, CU, tabs)
    m16, lev16, pred16, cost16 = _rd_choose(src16, allp16, w16, pen16, qstep,
                                            inv_q, lam, CU, tabs)
    cur = initc[..., None].expand(P, B, CU, CU).clone()
    cost_split = lam[:, None].expand(P, B)
    m8s, c8s = [], []
    src_t = src16.reshape(P, B, CU, CU)
    ref_t = ref16.reshape(P, B, CU, CU)
    for s, (dy, dx) in enumerate(SUB_OFF):
        q8 = lambda t: t[:, :, dy: dy + SUB, dx: dx + SUB].reshape(P, B, SUB * SUB)
        allp8 = _predict_all(_refs8(s, cur, up, upleft, upright, left, ib),
                             q8(ref_t), SUB, tabs)
        m8, lev8, pred8, cost8 = _rd_choose(q8(src_t), allp8, w8[:, :, s], pen8,
                                            qstep, inv_q, lam, SUB, tabs)
        rec8 = _int_recon(lev8, pred8, dq, maxv, SUB, tabs)
        cur[:, :, dy: dy + SUB, dx: dx + SUB] = rec8.reshape(P, B, SUB, SUB)
        cost_split = cost_split + cost8
        m8s.append(m8)
        c8s.append(lev8[:, :, tabs["zz8"]])
    split = cost_split < cost16
    rec16 = _int_recon(lev16, pred16, dq, maxv, CU, tabs)
    tile = torch.where(split[:, :, None], cur.reshape(P, B, CC), rec16)
    return (tile, split, m16, torch.stack(m8s, -1), lev16[:, :, tabs["zz16"]],
            torch.cat(c8s, -1), torch.minimum(cost16, cost_split))


def block_weights32(weights, nby: int, nbx: int):
    """Per-32-CU, per-16-quadrant and per-8-sub RD distortion weights: the
    share of point-generating pixels, floored at 0.04 (exact: sums of 0/1
    over powers of two).  weights (P, H, W) int32 0/1 -> (w32 (P, nb),
    w16 (P, nb, 4), w8 (P, nb, 4, 4)) float32, quadrants and subs in
    z-order."""
    wb = _blocks((weights != 0).to(torch.float32), nby, nbx, CU32)
    P, nb, _ = wb.shape
    w32 = (wb.sum(-1) / 1024.0).clamp(min=0.04)
    t = wb.reshape(P, nb, 2, CU, 2, CU)
    w16 = (t.sum((3, 5)) / 256.0).reshape(P, nb, 4).clamp(min=0.04)
    t8 = wb.reshape(P, nb, 2, 2, SUB, 2, 2, SUB)
    w8 = (t8.sum((4, 7)) / 64.0).permute(0, 1, 2, 4, 3, 5).reshape(P, nb, 4, 4)
    return w32, w16, w8.clamp(min=0.04)


def wavefront_encode32_plain(src, ref, w32, w16, w8, mvc, qstep, inv_q, lam,
                             pen, dq, maxvals, nby: int, nbx: int):
    """Plain version of kernel I (vpcc_tpu hevc.py `_build_encode32.run`,
    the scan): one batched step per wavefront diagonal over (PT, nb+2,
    1024) CU rows (row nb = init block, row nb+1 = write dump), all 36
    modes at once at every level.

    src/ref (PT, Ht, Wt) int32 source and inter prediction tile planes;
    w32 (PT, nb), w16 (PT, nb, 4), w8 (PT, nb, 4, 4), mvc (PT, nb) float32
    (MV rate per CU); qstep, inv_q, lam, pen (PT,) float32 (pen 0, or 1e30
    without a reference); dq, maxvals (PT,) int32.  Returns the syntax
    (s32, m32 (PT, nb) int8, c32 (PT, nb, 1024) int16 zigzag, s16
    (PT, nb, 4) int8, modes (PT, nb, 4, 4) int8, c16 (PT, nb, 4, 256)
    int16) and the reconstruction (PT, Ht, Wt) int32."""
    PT = src.shape[0]
    d = src.device
    nb = nby * nbx
    tabs = _tables(d)
    maxv = maxvals.long()
    dqv = dq.long()
    initc = ((maxv + 1) // 2)[:, None, None]

    src_blk = _pad_rows(_blocks(src.long(), nby, nbx, CU32), initc)
    ref_blk = _pad_rows(_blocks(ref.long(), nby, nbx, CU32), initc)
    w32_p, w16_p, w8_p = (_pad_rows(a, 1.0) for a in (w32, w16, w8))
    mvc_p = _pad_rows(mvc, 0.0)
    blk = initc.expand(PT, nb + 2, CC32).clone()
    s32_o = torch.zeros((PT, nb + 2), dtype=torch.int64, device=d)
    m32_o = torch.zeros_like(s32_o)
    c32_o = torch.zeros((PT, nb + 2, CC32), dtype=torch.int64, device=d)
    s16_o = torch.zeros((PT, nb + 2, 4), dtype=torch.int64, device=d)
    m_o = torch.zeros((PT, nb + 2, 4, 4), dtype=torch.int64, device=d)
    c16_o = torch.zeros((PT, nb + 2, 4, CC), dtype=torch.int64, device=d)
    for bidx, nbr in _wavefront_diagonals(nby, nbx, d):
        B = bidx.shape[0]
        tile4 = lambda ids: blk[:, ids].reshape(PT, B, CU32, CU32)
        up, upleft, upright, left = (tile4(nbr[:, k]) for k in range(4))
        src32, ref32 = src_blk[:, bidx], ref_blk[:, bidx]
        mvc32 = mvc_p[:, bidx]
        ib = lambda k: initc.expand(PT, B, k)
        allp32 = _predict_all(_refs32(up, upleft, upright, left, ib), ref32, CU32, tabs)
        m32, lev32, pred32, cost32 = _rd_choose(
            src32, allp32, w32_p[:, bidx], pen[:, None] + mvc32, qstep, inv_q, lam,
            CU32, tabs)
        cur32 = initc[..., None].expand(PT, B, CU32, CU32).clone()
        init16 = initc[..., None].expand(PT, B, CU, CU)
        cost_split = lam[:, None].expand(PT, B)
        mvc16 = 0.25 * mvc32
        pens = (pen[:, None] + mvc16, pen[:, None] + 0.25 * mvc16)
        src_t = src32.reshape(PT, B, CU32, CU32)
        ref_t = ref32.reshape(PT, B, CU32, CU32)
        s16s, m16s, m8s, cqs = [], [], [], []
        for q, (dy, dx) in enumerate(QOFF32):
            qt = lambda t: t[:, :, dy: dy + CU, dx: dx + CU].reshape(PT, B, CC)
            u16, ul16, ur16, l16 = _quad_tiles16(q, cur32, up, upleft, upright, left, init16)
            tile_q, split_q, m16_q, m8_q, lev16zz, c8cat, cost_q = _code_cu16(
                qt(src_t), qt(ref_t), u16, ul16, ur16, l16, initc,
                w16_p[:, bidx, q], w8_p[:, bidx, q], pens, qstep, inv_q, lam,
                dqv, maxv, tabs)
            cur32[:, :, dy: dy + CU, dx: dx + CU] = tile_q.reshape(PT, B, CU, CU)
            cost_split = (cost_split + cost_q) + lam[:, None]
            s16s.append(split_q)
            m16s.append(m16_q)
            m8s.append(m8_q)
            cqs.append(torch.where(split_q[:, :, None], c8cat, lev16zz))
        split32 = cost_split < cost32
        rec32 = _int_recon(lev32, pred32, dqv, maxv, CU32, tabs)
        blk[:, bidx] = torch.where(split32[:, :, None], cur32.reshape(PT, B, CC32), rec32)
        s16v = torch.stack(s16s, -1)
        m16v = torch.stack(m16s, -1)[:, :, :, None]
        m16v = torch.cat([m16v, torch.zeros_like(m16v).expand(PT, B, 4, 3)], -1)
        s32_o[:, bidx] = split32.long()
        m32_o[:, bidx] = m32
        c32_o[:, bidx] = lev32[:, :, tabs["zz32"]]
        s16_o[:, bidx] = s16v.long()
        m_o[:, bidx] = torch.where(s16v[:, :, :, None], torch.stack(m8s, -2), m16v)
        c16_o[:, bidx] = torch.stack(cqs, -2)
    rec = _unblocks(blk[:, :nb], nby, nbx, CU32)
    return (s32_o[:, :nb].to(torch.int8), m32_o[:, :nb].to(torch.int8),
            c32_o[:, :nb].to(torch.int16), s16_o[:, :nb].to(torch.int8),
            m_o[:, :nb].to(torch.int8), c16_o[:, :nb].to(torch.int16),
            rec.to(torch.int32))


_WE_ARGS = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def wavefront_encode32(src, ref, w32, w16, w8, mvc, qstep, inv_q, lam, pen,
                       dq, maxvals, nby: int, nbx: int):
    """Kernel I (csrc/wavefront_encode32.cu): one launch a call, a block per
    (tile plane, 32x32 CU), CUs taken in wavefront order, each waiting on
    its neighbours' ready flags (zeroed here with the ticket counter).
    Arguments and result as `wavefront_encode32_plain`, which runs on the
    CPU."""
    if src.device.type == "cpu":
        return wavefront_encode32_plain(src, ref, w32, w16, w8, mvc, qstep, inv_q,
                                        lam, pen, dq, maxvals, nby, nbx)
    d = src.device
    PT = src.shape[0]
    nb = nby * nbx
    for name, t, dtype, shape in (
        ("src", src, torch.int32, (PT, nby * CU32, nbx * CU32)),
        ("ref", ref, torch.int32, (PT, nby * CU32, nbx * CU32)),
        ("w32", w32, torch.float32, (PT, nb)),
        ("w16", w16, torch.float32, (PT, nb, 4)),
        ("w8", w8, torch.float32, (PT, nb, 4, 4)),
        ("mvc", mvc, torch.float32, (PT, nb)),
        ("qstep", qstep, torch.float32, (PT,)),
        ("inv_q", inv_q, torch.float32, (PT,)),
        ("lam", lam, torch.float32, (PT,)),
        ("pen", pen, torch.float32, (PT,)),
        ("dq", dq, torch.int32, (PT,)),
        ("maxvals", maxvals, torch.int32, (PT,)),
    ):
        dev.check_tensor(t, name, dtype, d)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    s32 = torch.empty((PT, nb), dtype=torch.int8, device=d)
    m32 = torch.empty_like(s32)
    c32 = torch.empty((PT, nb, CC32), dtype=torch.int16, device=d)
    s16 = torch.empty((PT, nb, 4), dtype=torch.int8, device=d)
    modes = torch.empty((PT, nb, 4, 4), dtype=torch.int8, device=d)
    c16 = torch.empty((PT, nb, 4, CC), dtype=torch.int16, device=d)
    rec = torch.empty_like(src)
    flags = torch.zeros(PT * nb + 1, dtype=torch.int32, device=d)
    tabs = _tables(d)
    fn = dev.load_kernel("wavefront_encode32").wavefront_encode32
    fn.argtypes, fn.restype = _WE_ARGS, ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(src), dev.ptr(ref), dev.ptr(w32), dev.ptr(w16), dev.ptr(w8),
            dev.ptr(mvc), dev.ptr(qstep), dev.ptr(inv_q), dev.ptr(lam), dev.ptr(pen),
            dev.ptr(dq), dev.ptr(maxvals), dev.ptr(tabs["blob"]), dev.ptr(tabs["fblob"]),
            dev.ptr(s32), dev.ptr(m32), dev.ptr(c32), dev.ptr(s16), dev.ptr(modes),
            dev.ptr(c16), dev.ptr(rec), dev.ptr(flags), PT, nby, nbx, dev.stream_handle(),
            ctypes.byref(launched))
    dev.count_launch("wavefront_encode32", launched.value)
    dev.check_launch("wavefront_encode32", rc)
    return s32, m32, c32, s16, modes, c16, rec


# ---------------------------------------------------------------------------
# kernel I's two-level entry: wavefront RDO encode of the 16/8 CU quadtree

def block_weights16(weights, nby: int, nbx: int):
    """Per-16-CU and per-8-sub RD distortion weights of the two-level codec
    (reference `_block_weights`, hevc.py:672): the share of point-generating
    pixels, floored at 0.04.  weights (P, H, W) int32 0/1 -> (w16 (P, nb),
    w8 (P, nb, 4)) float32, subs in z-order."""
    wb = _blocks((weights != 0).to(torch.float32), nby, nbx, CU)
    P, nb, _ = wb.shape
    w16 = (wb.sum(-1) / 256.0).clamp(min=0.04)
    w8 = (wb.reshape(P, nb, 2, SUB, 2, SUB).sum((3, 5)) / 64.0).reshape(P, nb, 4)
    return w16, w8.clamp(min=0.04)


def wavefront_encode16_plain(src, ref, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxvals,
                             nby: int, nbx: int):
    """Plain version of kernel I's two-level entry (vpcc_tpu hevc.py
    `_build_encode.run`, the scan): one batched step per wavefront diagonal
    of 16x16 CUs over (PT, nb+2, 256) CU rows, each CU coded by `_code_cu16`
    (the inter lane pays pen + mvc at 16x16, pen + mvc / 4 at 8x8).

    src/ref (PT, Ht, Wt) int32 source and inter prediction tile planes;
    w16 (PT, nb), w8 (PT, nb, 4), mvc (PT, nb) float32; qstep, inv_q, lam,
    pen (PT,) float32; dq, maxvals (PT,) int32.  Returns the syntax (split
    (PT, nb) int8, modes (PT, nb, 4) int8 ([m16, 0, 0, 0] for a whole
    block), coeffs (PT, nb, 256) int16 zigzag (four 64-level 8x8 blocks
    when split)) and the reconstruction (PT, Ht, Wt) int32."""
    PT = src.shape[0]
    d = src.device
    nb = nby * nbx
    tabs = _tables(d)
    maxv, dqv = maxvals.long(), dq.long()
    initc = ((maxv + 1) // 2)[:, None, None]
    src_blk = _pad_rows(_blocks(src.long(), nby, nbx, CU), initc)
    ref_blk = _pad_rows(_blocks(ref.long(), nby, nbx, CU), initc)
    w16_p, w8_p = _pad_rows(w16, 1.0), _pad_rows(w8, 1.0)
    mvc_p = _pad_rows(mvc, 0.0)
    blk = initc.expand(PT, nb + 2, CC).clone()
    split_o = torch.zeros((PT, nb + 2), dtype=torch.int64, device=d)
    modes_o = torch.zeros((PT, nb + 2, 4), dtype=torch.int64, device=d)
    coeff_o = torch.zeros((PT, nb + 2, CC), dtype=torch.int64, device=d)
    for bidx, nbr in _wavefront_diagonals(nby, nbx, d):
        B = bidx.shape[0]
        up, upleft, upright, left = (blk[:, nbr[:, k]].reshape(PT, B, CU, CU)
                                     for k in range(4))
        mvc16 = mvc_p[:, bidx]
        tile, split, m16, m8, lev16zz, c8cat, _ = _code_cu16(
            src_blk[:, bidx], ref_blk[:, bidx], up, upleft, upright, left, initc,
            w16_p[:, bidx], w8_p[:, bidx], (pen[:, None] + mvc16, pen[:, None] + 0.25 * mvc16),
            qstep, inv_q, lam, dqv, maxv, tabs)
        blk[:, bidx] = tile
        m16v = torch.cat([m16[..., None], torch.zeros_like(m8[..., 1:])], -1)
        split_o[:, bidx] = split.long()
        modes_o[:, bidx] = torch.where(split[..., None], m8, m16v)
        coeff_o[:, bidx] = torch.where(split[..., None], c8cat, lev16zz)
    return (split_o[:, :nb].to(torch.int8), modes_o[:, :nb].to(torch.int8),
            coeff_o[:, :nb].to(torch.int16), _unblocks(blk[:, :nb], nby, nbx, CU).to(torch.int32))


_WE16_ARGS = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 3
              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def wavefront_encode16(src, ref, w16, w8, mvc, qstep, inv_q, lam, pen, dq, maxvals,
                       nby: int, nbx: int):
    """Kernel I's two-level entry (csrc/wavefront_encode32.cu
    `wavefront_encode16`): one launch a call, a block per (tile plane, 16x16
    CU), CUs taken in wavefront order behind their neighbours' ready flags.
    Arguments and result as `wavefront_encode16_plain`, which runs on the
    CPU."""
    if src.device.type == "cpu":
        return wavefront_encode16_plain(src, ref, w16, w8, mvc, qstep, inv_q, lam, pen, dq,
                                        maxvals, nby, nbx)
    d = src.device
    PT = src.shape[0]
    nb = nby * nbx
    for name, t, dtype, shape in (
        ("src", src, torch.int32, (PT, nby * CU, nbx * CU)),
        ("ref", ref, torch.int32, (PT, nby * CU, nbx * CU)),
        ("w16", w16, torch.float32, (PT, nb)),
        ("w8", w8, torch.float32, (PT, nb, 4)),
        ("mvc", mvc, torch.float32, (PT, nb)),
        ("qstep", qstep, torch.float32, (PT,)),
        ("inv_q", inv_q, torch.float32, (PT,)),
        ("lam", lam, torch.float32, (PT,)),
        ("pen", pen, torch.float32, (PT,)),
        ("dq", dq, torch.int32, (PT,)),
        ("maxvals", maxvals, torch.int32, (PT,)),
    ):
        dev.check_tensor(t, name, dtype, d)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    split = torch.empty((PT, nb), dtype=torch.int8, device=d)
    modes = torch.empty((PT, nb, 4), dtype=torch.int8, device=d)
    coeffs = torch.empty((PT, nb, CC), dtype=torch.int16, device=d)
    rec = torch.empty_like(src)
    flags = torch.zeros(PT * nb + 1, dtype=torch.int32, device=d)
    tabs = _tables(d)
    fn = dev.load_kernel("wavefront_encode32").wavefront_encode16
    fn.argtypes, fn.restype = _WE16_ARGS, ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(src), dev.ptr(ref), dev.ptr(w16), dev.ptr(w8), dev.ptr(mvc),
            dev.ptr(qstep), dev.ptr(inv_q), dev.ptr(lam), dev.ptr(pen), dev.ptr(dq),
            dev.ptr(maxvals), dev.ptr(tabs["blob"]), dev.ptr(tabs["fblob"]), dev.ptr(split),
            dev.ptr(modes), dev.ptr(coeffs), dev.ptr(rec), dev.ptr(flags), PT, nby, nbx,
            dev.stream_handle(),
            ctypes.byref(launched))
    dev.count_launch("wavefront_encode16", launched.value)
    dev.check_launch("wavefront_encode16", rc)
    return split, modes, coeffs, rec


# ---------------------------------------------------------------------------
# plane API, encode side

def _round_int_planes(planes, occ):
    """Occupancy-aware background fill (kernel L, every plane in one pass)
    + rounding to int32; plain int32 conversion without an occupancy.
    planes (P, H, W), occ (H, W) or one per plane (P, H, W)."""
    if occ is None:
        return planes.to(torch.int32)
    return padding.push_pull_round(planes.to(torch.int32).contiguous(),
                                   occ.to(torch.uint8).contiguous())


def _sao_blob(sao_cls_h, sao_off_h) -> bytes:
    """The SAO parameters of a plane's tiles (class + 4 offsets per region)
    as `encode_coeffs` 64-blocks, flattened (T, Ry, Rx, 5) and zero-padded."""
    flat = np.concatenate([np.asarray(sao_cls_h).astype(np.int32)[..., None],
                           np.asarray(sao_off_h).astype(np.int32)], axis=-1).reshape(-1)
    sao_pad = np.zeros(((flat.size + 63) // 64, 64), np.int32)
    sao_pad.reshape(-1)[: flat.size] = flat
    sb = entropy.encode_coeffs(sao_pad)
    return struct.pack("<I", len(sb)) + sb


def _flags(has_ref, deblock, motion, level_flag) -> int:
    return ((FLAG_INTER if has_ref else 0) | (FLAG_DEBLOCK if deblock else 0)
            | (FLAG_MC if motion else 0) | level_flag)


def assemble_payload32(H, W, P, qps, maxvals, has_ref, deblock, motion, ty, tx,
                       s32_h, m32_h, c32_h, s16_h, modes_h, c16_h, mv_h,
                       sao_cls_h, sao_off_h) -> bytes:
    """Three-level payload from host (numpy) syntax arrays, byte for byte as
    `vpcc_tpu.video.hevc.assemble_payload32`: header, then per plane its
    qp/maxval, the CU syntax blob of its tiles stacked into one (T*nby,
    nbx) grid, the MV blob (motion payloads) and the SAO blob."""
    Hp, Wp = _padded_dims(H, W, ty, tx, CU32)
    s32_h, m32_h, c32_h, s16_h, modes_h, c16_h, mv_h = (
        np.asarray(a).astype(np.int32)
        for a in (s32_h, m32_h, c32_h, s16_h, modes_h, c16_h, mv_h))
    nby, nbx = Hp // ty // CU32, Wp // tx // CU32
    T = ty * tx
    out = bytearray(struct.pack("<HHBBBB", H, W, P,
                                _flags(has_ref, deblock, motion, FLAG_CU32), ty, tx))
    for p in range(P):
        out += struct.pack("<BH", int(qps[p]), int(maxvals[p]))
        sl = slice(p * T, (p + 1) * T)
        blob = entropy.encode_hevc32_plane(
            T * nby, nbx, s32_h[sl].reshape(-1), m32_h[sl].reshape(-1),
            c32_h[sl].reshape(-1, CC32), s16_h[sl].reshape(-1, 4),
            modes_h[sl].reshape(-1, 4, 4)[:, :, 0], c16_h[sl].reshape(-1, 4, CC),
            modes_h[sl].reshape(-1, 4, 4), c16_h[sl].reshape(-1, 4, 4, SUB * SUB),
        )
        out += struct.pack("<I", len(blob)) + blob
        if motion:
            mvblob = entropy.encode_mvs(
                _inter_flags32(s32_h[sl].reshape(-1), m32_h[sl].reshape(-1),
                               s16_h[sl].reshape(-1, 4), modes_h[sl].reshape(-1, 4, 4)),
                mv_h[sl].reshape(-1, 2))
            out += struct.pack("<I", len(mvblob)) + mvblob
        out += _sao_blob(sao_cls_h[sl], sao_off_h[sl])
    return bytes(out)


def assemble_payload16(H, W, P, qps, maxvals, has_ref, deblock, motion, ty, tx,
                       split_h, modes_h, coeff_h, mv_h, sao_cls_h, sao_off_h) -> bytes:
    """Two-level (16/8) payload from host (numpy) syntax arrays, byte for
    byte as the reference's two-level `finalize` (hevc.py:1550-1602):
    header (FLAG_SAO16), then per plane its qp/maxval, one CU syntax blob
    over its tiles stacked into a (T*nby, nbx) grid of 16x16 CUs, the MV
    blob (motion payloads) and the 16-px SAO blob."""
    Hp, Wp = _padded_dims(H, W, ty, tx, CU)
    split_h, modes_h, coeff_h, mv_h = (np.asarray(a).astype(np.int32)
                                       for a in (split_h, modes_h, coeff_h, mv_h))
    nby, nbx = Hp // ty // CU, Wp // tx // CU
    T = ty * tx
    out = bytearray(struct.pack("<HHBBBB", H, W, P,
                                _flags(has_ref, deblock, motion, FLAG_SAO16), ty, tx))
    for p in range(P):
        out += struct.pack("<BH", int(qps[p]), int(maxvals[p]))
        sl = slice(p * T, (p + 1) * T)
        split_cat = split_h[sl].reshape(-1)
        modes_cat = modes_h[sl].reshape(-1, 4)
        coeff_cat = coeff_h[sl].reshape(-1, CC)
        blob = entropy.encode_hevc_plane(T * nby, nbx, split_cat, modes_cat[:, 0], coeff_cat,
                                         modes_cat, coeff_cat.reshape(-1, 4, SUB * SUB))
        out += struct.pack("<I", len(blob)) + blob
        if motion:
            mvblob = entropy.encode_mvs(_inter_flags(split_cat, modes_cat),
                                        mv_h[sl].reshape(-1, 2))
            out += struct.pack("<I", len(mvblob)) + mvblob
        out += _sao_blob(sao_cls_h[sl], sao_off_h[sl])
    return bytes(out)


@dataclasses.dataclass
class Coded:
    """What one `encode_planes_dispatch` call leaves on the device: the
    syntax arrays of its P * ty * tx tiles, in the order the payload writer
    takes them (three-level: s32, m32, c32, s16, modes, c16, mv, sao_cls,
    sao_off; two-level: split, modes, coeffs, mv, sao_cls, sao_off), the
    (P, H, W) int32 reconstruction and the call's parameters.  `payload`
    assembles the bytes of a run of its planes on the host."""

    syntax: Dict[str, torch.Tensor]
    rec: torch.Tensor
    qps: list
    maxvals: list
    has_ref: bool
    deblock: bool
    motion: bool
    ty: int
    tx: int
    _host: Optional[tuple] = None

    @property
    def two_level(self) -> bool:
        return "split" in self.syntax

    def host(self) -> tuple:
        """The syntax arrays on the host (downloaded once)."""
        if self._host is None:
            self._host = tuple(a.cpu().numpy() for a in self.syntax.values())
        return self._host

    def payload(self, first: int = 0, count: Optional[int] = None) -> bytes:
        """The payload of planes first .. first + count - 1 (default: all),
        byte for byte what `encode_planes` writes for them alone."""
        P, H, W = self.rec.shape
        count = P - first if count is None else count
        T = self.ty * self.tx
        sl = slice(first * T, (first + count) * T)
        assemble = assemble_payload16 if self.two_level else assemble_payload32
        return assemble(
            H, W, count, self.qps[first:first + count], self.maxvals[first:first + count],
            self.has_ref, self.deblock, self.motion, self.ty, self.tx,
            *(a[sl] for a in self.host()))


def encode_planes_dispatch(planes, qps, maxvals, refs=None, occ=None, deblock: bool = True,
                           weight=None, motion: bool = False) -> Coded:
    """The device half of `encode_planes` over a (P, H, W) stack sharing
    one shape: kernels L, J, B, I, O, K in one pass each over every plane.
    qps/maxvals: per-plane ints; maxvals up to 1023 take the three-level
    codec (32x32 CUs, 32-px SAO regions), up to 2047 the two-level one
    (16x16 CUs and MV blocks, 16-px SAO regions; every plane when
    `ENABLE_CU32` is off), above 2047 raise ValueError (the reference
    asserts them away).  refs: optional (P, H, W) reference planes.  occ:
    optional (H, W) occupancy, or one per plane (P, H, W), for the
    push-pull background fill.  weight: optional (H, W) or (P, H, W) 0/1
    RD relevance mask.  Runs on the planes' device when they are a tensor,
    else on CUDA."""
    d = planes.device if torch.is_tensor(planes) else dev.resolve_device()
    as_t = lambda a: (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))).to(d)
    planes = as_t(planes)
    if planes.ndim == 2:
        planes = planes[None]
    P, H, W = planes.shape
    if H % SUB or W % SUB:
        raise ValueError(f"encode_planes: plane {H}x{W} is not a multiple of {SUB}")
    top = max(int(m) for m in maxvals)
    if top > MAXVAL_LIMIT:
        raise ValueError(f"encode_planes: maxval {top} is above {MAXVAL_LIMIT}: samples above "
                         "11 bits void the integer-exact prediction (reference hevc.py:1496)")
    two_level = not (ENABLE_CU32 and top <= 1023)
    cu = CU if two_level else CU32
    has_ref = refs is not None
    motion = bool(motion and has_ref)
    planes = _round_int_planes(planes, None if occ is None else as_t(occ))
    ref = (as_t(refs).to(torch.int32) if has_ref
           else torch.zeros((P, H, W), dtype=torch.int32, device=d))
    ty, tx = _tile_grid(H, W, cu=cu)
    Hp, Wp = _padded_dims(H, W, ty, tx, cu)
    # a weight mask is padded with zeros, the default all-ones one covers
    # the padding too (as the reference builds them)
    if weight is not None:
        wgt = torch.nn.functional.pad((as_t(weight) != 0).to(torch.int32).expand(P, H, W),
                                      (0, Wp - W, 0, Hp - H))
    else:
        wgt = torch.ones((P, Hp, Wp), dtype=torch.int32, device=d)
    if (Hp, Wp) != (H, W):
        planes = _edge_pad(planes, 0, Hp - H, 0, Wp - W)
        ref = _edge_pad(ref, 0, Hp - H, 0, Wp - W)
    src = _tiles_of(planes, ty, tx).contiguous()
    ref = _tiles_of(ref, ty, tx).contiguous()
    wgt = _tiles_of(wgt, ty, tx).contiguous()
    T = ty * tx
    PT = P * T
    nby, nbx = Hp // ty // cu, Wp // tx // cu
    qp_c = np.clip(np.repeat(np.asarray(qps, np.int64), T), 0, 51)
    dq_h = tab.DQ64[qp_c].astype(np.int32)
    qstep_h = dq_h.astype(np.float32) / np.float32(64.0)
    tt = lambda a: torch.as_tensor(a, device=d)
    maxv = tt(np.repeat(np.asarray(maxvals, np.int32), T))
    lam = tt(tab.LAMBDA[qp_c])
    qstep = tt(qstep_h)
    inv_q = tt(np.float32(1.0) / qstep_h)
    pen = torch.full((PT,), 0.0 if has_ref else 1e30, dtype=torch.float32, device=d)
    if motion:
        mv, mvcost = motion_search(src, ref, lam, maxv, cu)
        ref = half_pel_mc(ref, mv, maxv, cu)
    else:
        mv = torch.zeros((PT, nby * nbx, 2), dtype=torch.int32, device=d)
        mvcost = torch.zeros((PT, nby * nbx), dtype=torch.float32, device=d)
    if two_level:
        split, modes, coeffs, rec = wavefront_encode16(
            src, ref, *block_weights16(wgt, nby, nbx), mvcost, qstep, inv_q, lam, pen,
            tt(dq_h), maxv, nby, nbx)
        syntax = dict(split=split, modes=modes, coeffs=coeffs)
    else:
        s32, m32, c32, s16, modes, c16, rec = wavefront_encode32(
            src, ref, *block_weights32(wgt, nby, nbx), mvcost, qstep, inv_q,
            lam, pen, tt(dq_h), maxv, nby, nbx)
        syntax = dict(s32=s32, m32=m32, c32=c32, s16=s16, modes=modes, c16=c16)
    if deblock:
        rec = deblock_planes(rec, tt(qp_c.astype(np.int32)), maxv)
    region = CU if two_level else SAO_REGION
    rec, sao_cls, sao_off = sao_search_apply(src, rec, lam, wgt, maxv, region=region)
    rec = _untile(rec, P, ty, tx)[:, :H, :W].contiguous()
    syntax.update(mv=mv.to(torch.int8), sao_cls=sao_cls, sao_off=sao_off)
    return Coded(syntax, rec, [int(q) for q in qps], [int(m) for m in maxvals], has_ref,
                 bool(deblock), motion, ty, tx)


def encode_planes(planes, qps, maxvals, refs=None, occ=None, deblock: bool = True,
                  weight=None, motion: bool = False) -> Tuple[bytes, torch.Tensor]:
    """Encode a (P, H, W) stack of integer planes sharing one shape with the
    three-level (32/16/8) wavefront codec, or the two-level (16/8) one where
    a maxval is above 1023, as `vpcc_tpu.video.hevc.encode_planes` does.  Returns (payload bytes, (P, H, W) int32
    reconstruction on the device), the reconstruction being exactly what
    `decode_planes` makes of the payload.

    `encode_planes_dispatch` (arguments as here) then `Coded.payload`.
    refs: optional (P, H, W) reference planes (enables the inter lane);
    motion=True searches half-pel MVs against them (kernel J).  occ:
    optional (H, W) occupancy for the push-pull background fill (kernel L).
    weight: optional (H, W) 0/1 RD relevance mask.  The reference's `defer`
    has no counterpart: the payload is assembled before returning."""
    coded = encode_planes_dispatch(planes, qps, maxvals, refs=refs, occ=occ, deblock=deblock,
                                   weight=weight, motion=motion)
    return coded.payload(), coded.rec


def encode_rgb(attr, qp: int, refs=None, deblock: bool = True, weight=None,
               motion: bool = False):
    """(H, W, 3) integer RGB (0..255, already background-filled) -> (payload,
    decoded (H, W, 3) uint8 RGB, (recy (1, H, W), recc (2, H/2, W/2)) int32
    reference planes), as `vpcc_tpu.video.hevc.encode_rgb` with occ=None:
    the luma plane at `qp`, the 4:2:0 chroma pair at min(qp + 3, 51).
    `refs` (the decoded planes of a reference frame, or `rgb_refs` of the
    decoded layer 0) enable the inter lane, `motion` its MV search;
    `weight` (H, W) the RD relevance mask (chroma: its 2x2 maximum)."""
    y, chroma = rgb_to_planes(attr)
    cqp = min(qp + 3, 51)
    ry = rc = None
    if refs is not None and tuple(refs[0].shape) == tuple(y.shape):
        ry, rc = refs
    wy = wc = None
    if weight is not None:
        wy = (weight if torch.is_tensor(weight) else torch.as_tensor(np.asarray(weight))).to(
            device=y.device, dtype=torch.int32)
        h, w = wy.shape
        wc = wy.reshape(h // 2, 2, w // 2, 2).amax((1, 3))
    py, recy = encode_planes(y, [qp], [255], refs=ry, deblock=deblock,
                             weight=wy, motion=motion)
    pc, recc = encode_planes(chroma[0], [cqp, cqp], [255, 255], refs=rc,
                             deblock=deblock, weight=wc, motion=motion)
    rgb = _int_planes_to_rgb(recy[0], recc[0], recc[1])
    return struct.pack("<II", len(py), len(pc)) + py + pc, rgb, (recy, recc)
