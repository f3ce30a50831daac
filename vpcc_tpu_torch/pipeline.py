"""Reconstruction seam: decoded atlas -> points -> smoothing -> colors,
and the attribute images the encoder paints from the points.

The port of vpcc_tpu/pipeline.py `reconstruct_frame_device`,
`apply_pbf_occupancy`, `paint_attribute`, `gather_decoded_colors`,
`extract_eom_colors`, `inject_eom_colors`, `apply_color_smoothing_device`,
`apply_color_smoothing`, `paint_scalar`, `gather_decoded_scalar` and
`download_recon`, with the group dilation of vpcc_tpu/ops/padding.py.
Kernel C builds the compacted rows (two depth layers, the EOM layers, or
the PLR layers from kernel V's code plane), kernel D smooths them; kernel
U filters the occupancy's patch borders (PBF) before; kernel P
(csrc/attr_image.cu) paints the colors into the two attribute layers,
group-dilates their filled backgrounds and gathers each point's decoded
color, and paints and gathers the 16-bit reflectance the same way (its
scalar entries); kernel S (csrc/eom_colors.cu) moves the EOM rows' colors
out of and back into the rows; kernel T smooths the decoded colors.
The JAX package's static-shape padding (`shape_bucket`) has no
counterpart: the tensors hold exactly the valid rows, in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.core import atlas as atlas_mod
from vpcc_tpu_torch.core.patch import Patch
from vpcc_tpu_torch.ops import pbf, plr, reconstruct, smoothing
from vpcc_tpu_torch.ops.reconstruct import Points
from vpcc_tpu_torch.utils.config import VPCCConfig


def _as_int32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def _as_uint8(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.uint8).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a, np.uint8), device=device)


def plr_table(cfg: VPCCConfig) -> np.ndarray:
    """The mode table an encoder signals: the first plrlNumberOfModes rows
    of the default table (reference encoder.py:621)."""
    n = max(min(int(cfg.plrlNumberOfModes), len(plr.MODE_TABLE)), 1)
    return plr.MODE_TABLE[:n]


def reconstruct_frame(
    occ_rec,                 # (H, W) uint8 decoded + expanded occupancy (numpy or tensor)
    geo_dec: List,           # decoded geometry maps (tensors or numpy)
    btp: np.ndarray,         # (H/res, W/res) int32 block-to-patch
    patches: List[Patch],
    cfg: VPCCConfig,
    device: torch.device,
    eom=None,                # (H, W) int32 decoded EOM codes, or None
    plr_modes=None,          # (H/res, W/res) int32 PLR block modes, or None
    plr_mode_table=None,     # (M, 4) int32 PLR mode table (default: the cfg prefix)
) -> Points:
    """generatePointCloud + grid smoothing on `device`.  With
    enhancedOccupancyMapCode and an EOM plane, each pixel adds its EOM
    points (eom_bits = surfaceThickness - 1 layers, tag 2).  With PLR block
    modes (single-map geometry), kernel V's code plane adds the layers at
    D0 + 1..3 through kernel C's EOM entry, tag 2, as the reference's PLR
    layers (pipeline.py:76-82)."""
    occ_d = _as_uint8(occ_rec, device)
    g0 = _as_int32(geo_dec[0], device)
    g1 = _as_int32(geo_dec[1], device) if len(geo_dec) > 1 else g0
    eom_d, eom_bits = None, 0
    if eom is not None and cfg.enhancedOccupancyMapCode:
        eom_d = _as_int32(eom, device)
        eom_bits = max(int(cfg.surfaceThickness) - 1, 0)
    plr_entry = {}
    if plr_modes is not None:
        if eom_d is not None:
            raise NotImplementedError(
                "a stream with both EOM and PLR is not ported (ROADMAP queue 1 item 3); "
                "no encoder of the repository writes one")
        tbl = plr_table(cfg) if plr_mode_table is None else plr_mode_table
        eom_d = plr.code_plane(g0, _as_int32(plr_modes, device),
                               _as_int32(np.asarray(tbl), device), cfg.occupancyResolution)
        eom_bits, plr_entry = plr.N_LAYERS, {"entry": "generate_points_plr"}
    rec = reconstruct.generate_points(
        occ_d, g0, g1, _as_int32(btp, device),
        _as_int32(atlas_mod.patch_table(patches), device),
        cfg.occupancyResolution, eom=eom_d, eom_bits=eom_bits, **plr_entry,
    )
    if cfg.flagGeometrySmoothing and cfg.gridSmoothing and rec.pos.shape[0]:
        rec = rec._replace(pos=smoothing.grid_smooth(
            rec.pos, rec.pid, rec.bnd, cfg.thresholdSmoothing,
            grid_size=cfg.gridSize, grid_bits=cfg.geometryBitDepth3D,
        ))
    return rec


def apply_pbf_occupancy(occ_rec, geo_dec0, btp, patches: List[Patch], cfg: VPCCConfig,
                        device: torch.device) -> torch.Tensor:
    """PBF patch-border filtering of the upsampled occupancy (reference
    `apply_pbf_occupancy`, pipeline.py:107-133): kernel U on the decoded
    occupancy, the decoded D0 and the patch table of at least 64 rows (in
    steps of 64, as the reference's).  Returns the (H, W) uint8 occupancy
    the reconstruction reads; encoder and decoder call it with the same
    decoded inputs."""
    p_cap = max(((len(patches) + 63) // 64) * 64, 64)
    out = pbf.pbf_filter_occupancy(
        _as_uint8(occ_rec, device), _as_int32(geo_dec0, device), _as_int32(btp, device),
        _as_int32(atlas_mod.patch_table(patches, capacity=p_cap), device),
        cfg.occupancyResolution, passes=pbf.pbf_passes(cfg),
        filter_size=pbf.pbf_filter_size(cfg), threshold=int(cfg.pbfLog2Threshold) ** 2)
    return out.to(torch.uint8)


def apply_color_smoothing_device(recon: Points, col: torch.Tensor, cfg: VPCCConfig):
    """Grid color smoothing of the reconstruction's (N, 3) int32 colors
    (reference `apply_color_smoothing_device`, pipeline.py:237-248): kernel
    T when flagColorSmoothing is set, else the colors as they are."""
    if not (cfg.flagColorSmoothing and recon.pos.shape[0]):
        return col
    return smoothing.color_smoothing_grid(
        recon.pos, col.contiguous(), recon.pid, recon.bnd,
        float(cfg.thresholdColorSmoothing), float(cfg.thresholdColorVariation),
        grid_size=cfg.cgridSize, grid_bits=cfg.geometryBitDepth3D)


def apply_color_smoothing(pos, col, pid, bnd, cfg: VPCCConfig, device=None) -> np.ndarray:
    """Host-facing color smoothing (reference `apply_color_smoothing`,
    pipeline.py:332-350): numpy positions (N, 3), colors (N, 3), patch ids
    and boundary flags in, (N, 3) uint8 colors out."""
    col = np.asarray(col)
    if not (cfg.flagColorSmoothing and len(pos)):
        return col
    d = dev.resolve_device(device)
    out = smoothing.color_smoothing_grid(
        _as_int32(pos, d), _as_int32(col, d), _as_int32(pid, d),
        torch.as_tensor(np.asarray(bnd, bool), device=d),
        float(cfg.thresholdColorSmoothing), float(cfg.thresholdColorVariation),
        grid_size=cfg.cgridSize, grid_bits=cfg.geometryBitDepth3D)
    return out.cpu().numpy().astype(np.uint8)


# ---------------------------------------------------------------------------
# attribute images (K13 rest; kernel P)
#
# Layout: the painted layers are planar int32, (2 layers, 3 channels, H, W),
# so that kernel L fills each channel plane in place of a transposed copy;
# group dilation writes the two (H, W, 3) int32 images the attribute video
# codes.

def paint_attribute_plain(pix, layer, col, h: int, w: int) -> torch.Tensor:
    """(2, 3, H, W) int32 layer images of per-point colors (reference
    `paint_attribute`, pipeline.py:209): layer-0 points paint layer 0,
    layer-1 points layer 1, tag 2 never paints; a layer-1 pixel without a
    point takes layer 0's color.  Of several points on one (pixel, layer)
    the last row wins, as XLA's CPU scatter; points outside the image are
    dropped, as its scatter mode="drop"."""
    d = col.device
    c = col.clamp(0, 255).to(torch.int32)
    x, y = pix[:, 0].long(), pix[:, 1].long()
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    flat = y * w + x
    rows = torch.arange(col.shape[0], device=d)
    img = torch.zeros((2, 3, h * w), dtype=torch.int32, device=d)
    painted = []
    for ly in (0, 1):
        m = (layer == ly) & inside
        win = torch.full((h * w,), -1, dtype=torch.int64, device=d)
        win.scatter_reduce_(0, flat[m], rows[m], reduce="amax")
        hit = win >= 0
        img[ly][:, hit] = c[win[hit]].T
        painted.append(hit)
    img[1][:, ~painted[1]] = img[0][:, ~painted[1]]
    return img.reshape(2, 3, h, w)


def group_dilate_plain(planes: torch.Tensor, occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group dilation (reference padding.py:149 `group_dilate`) of the
    filled (2, 3, H, W) int32 layers: where the occupancy is 0 both take
    (a + b + 1) >> 1.  Returns the two (H, W, 3) int32 images."""
    a, b = planes[0], planes[1]
    avg = (a + b + 1) >> 1
    bg = (occ == 0)[None]
    return (torch.where(bg, avg, a).permute(1, 2, 0).contiguous(),
            torch.where(bg, avg, b).permute(1, 2, 0).contiguous())


def gather_decoded_colors_plain(pix, layer, attr0, attr1):
    """Per-point decoded colors: the attribute image of the point's layer
    at its pixel (layer 1 reads attr1, every other tag attr0), pixels
    clamped into the image as XLA's gather clamps them.  attr0/attr1
    (H, W, 3) uint8.  Returns (N, 3) int32."""
    h, w, _ = attr0.shape
    x = pix[:, 0].long().clamp(0, w - 1)
    y = pix[:, 1].long().clamp(0, h - 1)
    c0 = attr0[y, x].to(torch.int32)
    c1 = attr1[y, x].to(torch.int32)
    return torch.where((layer == 1)[:, None], c1, c0)


@functools.lru_cache(maxsize=None)
def _attr_fn(name: str, args: tuple):
    fn = getattr(dev.load_kernel("attr_image"), name)
    fn.argtypes, fn.restype = list(args), ctypes.c_int
    return fn


def _check_pix(pix: torch.Tensor) -> None:
    """The kernels load a point's pixel pair as one 8-byte word."""
    if pix.data_ptr() % 8:
        raise ValueError("pix: expected an 8-byte aligned (N, 2) int32 tensor")


def _check_quads(name: str, h: int, w: int, *planes: torch.Tensor) -> None:
    """The pixel passes move four pixels a thread in 16-byte words: H * W a
    multiple of 4 (the atlas is whole occupancy blocks, so it is whenever
    occupancyResolution >= 2) and each given plane stack on 16 bytes."""
    if (h * w) % 4 or any(t.data_ptr() % 16 for t in planes):
        raise ValueError(f"{name}: expected H * W a multiple of 4 and planes on 16 bytes, "
                         f"got {h}x{w}")


_PAINT_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3 + (
    ctypes.POINTER(ctypes.c_int),)
_DILATE_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 3
_GATHER_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2


def paint_attribute(pix, layer, col, h: int, w: int) -> torch.Tensor:
    """Kernel P, paint: `paint_attribute_plain` on the card.  The winning
    row of each (pixel, layer) is the highest, by an atomicMax of the row
    index into winners the entry sets to -1; a second pass, four pixels a
    thread, gathers the colors and the layer-1 fallback."""
    if col.device.type == "cpu":
        return paint_attribute_plain(pix, layer, col, h, w)
    d = col.device
    dev.check_tensor(pix, "pix", torch.int32, d, 2)
    dev.check_tensor(layer, "layer", torch.int32, d, 1)
    dev.check_tensor(col, "col", torch.int32, d, 2)
    n = col.shape[0]
    if pix.shape != (n, 2) or layer.shape != (n,) or col.shape != (n, 3):
        raise ValueError(f"paint_attribute: pix {tuple(pix.shape)}, layer "
                         f"{tuple(layer.shape)}, col {tuple(col.shape)}")
    _check_pix(pix)
    _check_quads("paint_attribute", h, w)
    buf = torch.empty((8, h, w), dtype=torch.int32, device=d)   # winners, then the planes
    win, out = buf[:2], buf[2:].view(2, 3, h, w)
    launched = ctypes.c_int(0)
    rc = _attr_fn("attr_paint", _PAINT_ARGS)(
        dev.ptr(pix), dev.ptr(layer), dev.ptr(col), n, h, w, dev.ptr(win), dev.ptr(out),
        dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("attr_paint", launched.value)
    dev.check_launch("attr_paint", rc)
    return out


def group_dilate(planes: torch.Tensor, occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel P, group dilation: `group_dilate_plain` on the card, four
    pixels a thread writing both interleaved images."""
    if planes.device.type == "cpu":
        return group_dilate_plain(planes, occ)
    d = planes.device
    dev.check_tensor(planes, "planes", torch.int32, d, 4)
    dev.check_tensor(occ, "occ", torch.uint8, d, 2)
    _, _, h, w = planes.shape
    if planes.shape[:2] != (2, 3) or occ.shape != (h, w):
        raise ValueError(f"group_dilate: planes {tuple(planes.shape)}, occ {tuple(occ.shape)}")
    _check_quads("group_dilate", h, w, planes)
    if occ.data_ptr() % 4:
        raise ValueError("group_dilate: expected occ on 4 bytes")
    img0 = torch.empty((h, w, 3), dtype=torch.int32, device=d)
    img1 = torch.empty_like(img0)
    rc = _attr_fn("attr_group_dilate", _DILATE_ARGS)(
        dev.ptr(planes), dev.ptr(occ), h, w, dev.ptr(img0), dev.ptr(img1), dev.stream_handle())
    dev.count_launch("attr_group_dilate", 1 if h * w else 0)
    dev.check_launch("attr_group_dilate", rc)
    return img0, img1


def gather_decoded_colors(pix, layer, attr0, attr1):
    """Kernel P, gather: `gather_decoded_colors_plain` on the card, one
    thread per point."""
    if pix.device.type == "cpu":
        return gather_decoded_colors_plain(pix, layer, attr0, attr1)
    d = pix.device
    dev.check_tensor(pix, "pix", torch.int32, d, 2)
    dev.check_tensor(layer, "layer", torch.int32, d, 1)
    dev.check_tensor(attr0, "attr0", torch.uint8, d, 3)
    dev.check_tensor(attr1, "attr1", torch.uint8, d, 3)
    n = pix.shape[0]
    h, w, _ = attr0.shape
    if pix.shape != (n, 2) or layer.shape != (n,) or attr0.shape != attr1.shape \
            or attr0.shape[2] != 3:
        raise ValueError(f"gather_decoded_colors: pix {tuple(pix.shape)}, layer "
                         f"{tuple(layer.shape)}, images {tuple(attr0.shape)} / {tuple(attr1.shape)}")
    _check_pix(pix)
    out = torch.empty((n, 3), dtype=torch.int32, device=d)
    rc = _attr_fn("attr_gather", _GATHER_ARGS)(
        dev.ptr(pix), dev.ptr(layer), dev.ptr(attr0), dev.ptr(attr1), n, h, w,
        dev.ptr(out), dev.stream_handle())
    dev.count_launch("attr_gather", 1 if n else 0)
    dev.check_launch("attr_gather", rc)
    return out


# ---------------------------------------------------------------------------
# the reflectance attribute's layer images (kernel P's scalar entries)

def paint_scalar_plain(pix, layer, val, h: int, w: int) -> torch.Tensor:
    """(2, H, W) int32 layer images of per-point scalar samples (reference
    `paint_scalar`, pipeline.py:252: 16-bit reflectance, not clamped), with
    `paint_attribute_plain`'s conventions: layer-0 and layer-1 points paint
    their layer, the last row wins, a layer-1 pixel without a point takes
    layer 0's value."""
    d = val.device
    x, y = pix[:, 0].long(), pix[:, 1].long()
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    flat = y * w + x
    rows = torch.arange(val.shape[0], device=d)
    img = torch.zeros((2, h * w), dtype=torch.int32, device=d)
    hit1 = None
    for ly in (0, 1):
        m = (layer == ly) & inside
        win = torch.full((h * w,), -1, dtype=torch.int64, device=d)
        win.scatter_reduce_(0, flat[m], rows[m], reduce="amax")
        hit = win >= 0
        img[ly][hit] = val[win[hit]].to(torch.int32)
        hit1 = hit
    img[1][~hit1] = img[0][~hit1]
    return img.reshape(2, h, w)


def gather_decoded_scalar_plain(pix, layer, img0, img1) -> torch.Tensor:
    """(N,) int32 decoded samples (reference `gather_decoded_scalar`,
    pipeline.py:270): layer 1 reads img1, every other tag img0, pixels
    clamped into the (H, W) int32 images."""
    h, w = img0.shape
    x = pix[:, 0].long().clamp(0, w - 1)
    y = pix[:, 1].long().clamp(0, h - 1)
    return torch.where(layer == 1, img1[y, x], img0[y, x]).to(torch.int32)


def paint_scalar(pix, layer, val, h: int, w: int) -> torch.Tensor:
    """Kernel P, scalar paint: `paint_scalar_plain` on the card (paint's
    winner pass, then a pixel pass that copies the winners' samples
    unclamped)."""
    if val.device.type == "cpu":
        return paint_scalar_plain(pix, layer, val, h, w)
    d = val.device
    dev.check_tensor(pix, "pix", torch.int32, d, 2)
    dev.check_tensor(layer, "layer", torch.int32, d, 1)
    dev.check_tensor(val, "val", torch.int32, d, 1)
    n = val.shape[0]
    if pix.shape != (n, 2) or layer.shape != (n,):
        raise ValueError(f"paint_scalar: pix {tuple(pix.shape)}, layer {tuple(layer.shape)}, "
                         f"val {tuple(val.shape)}")
    _check_pix(pix)
    _check_quads("paint_scalar", h, w)
    buf = torch.empty((4, h, w), dtype=torch.int32, device=d)   # winners, then the planes
    win, out = buf[:2], buf[2:]
    launched = ctypes.c_int(0)
    rc = _attr_fn("attr_paint_scalar", _PAINT_ARGS)(
        dev.ptr(pix), dev.ptr(layer), dev.ptr(val), n, h, w, dev.ptr(win), dev.ptr(out),
        dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("attr_paint_scalar", launched.value)
    dev.check_launch("attr_paint_scalar", rc)
    return out


def gather_decoded_scalar(pix, layer, img0, img1) -> torch.Tensor:
    """Kernel P, scalar gather: `gather_decoded_scalar_plain` on the card,
    one thread per point."""
    if pix.device.type == "cpu":
        return gather_decoded_scalar_plain(pix, layer, img0, img1)
    d = pix.device
    dev.check_tensor(pix, "pix", torch.int32, d, 2)
    dev.check_tensor(layer, "layer", torch.int32, d, 1)
    dev.check_tensor(img0, "img0", torch.int32, d, 2)
    dev.check_tensor(img1, "img1", torch.int32, d, 2)
    n = pix.shape[0]
    h, w = img0.shape
    if pix.shape != (n, 2) or layer.shape != (n,) or img1.shape != img0.shape:
        raise ValueError(f"gather_decoded_scalar: pix {tuple(pix.shape)}, layer "
                         f"{tuple(layer.shape)}, images {tuple(img0.shape)} / {tuple(img1.shape)}")
    _check_pix(pix)
    out = torch.empty(n, dtype=torch.int32, device=d)
    rc = _attr_fn("attr_gather_scalar", _GATHER_ARGS)(
        dev.ptr(pix), dev.ptr(layer), dev.ptr(img0), dev.ptr(img1), n, h, w, dev.ptr(out),
        dev.stream_handle())
    dev.count_launch("attr_gather_scalar", 1 if n else 0)
    dev.check_launch("attr_gather_scalar", rc)
    return out


# ---------------------------------------------------------------------------
# the EOM rows' colors (kernel S)

def extract_eom_colors_plain(layer: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """(M, 3) colors of the tag-2 (EOM) rows in row order (reference
    `extract_eom_colors`, pipeline.py:279)."""
    return col[layer == 2]


def inject_eom_colors_plain(layer: torch.Tensor, col: torch.Tensor,
                            aux: torch.Tensor) -> torch.Tensor:
    """`col` with every tag-2 row's color replaced by aux[rank] (uint8,
    rank = its index among the tag-2 rows, clipped to the last aux row, as
    the reference's `inject_eom_colors`, pipeline.py:296)."""
    m = layer == 2
    idx = (torch.cumsum(m.to(torch.int64), 0) - 1).clamp(0, aux.shape[0] - 1)
    return torch.where(m[:, None], aux[idx].to(col.dtype), col)


_EOM_COUNT_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
_EOM_WRITE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 2


def _eom_offsets(layer: torch.Tensor):
    """Kernel S's count and scan: (the tiles' offsets, number of tag-2 rows
    as a 0-d device tensor)."""
    d = layer.device
    lib = dev.load_kernel("eom_colors")
    lib.eom_tile_rows.restype = ctypes.c_int
    tiles = -(-layer.shape[0] // lib.eom_tile_rows())
    offsets = torch.empty(max(tiles, 1), dtype=torch.int32, device=d)
    total = torch.empty((), dtype=torch.int32, device=d)
    fn = lib.eom_count
    fn.argtypes, fn.restype = _EOM_COUNT_ARGS, ctypes.c_int
    rc = fn(dev.ptr(layer), layer.shape[0], dev.ptr(offsets), dev.ptr(total),
            dev.stream_handle())
    dev.count_launch("eom_colors", 2 if tiles else 1)
    dev.check_launch("eom_colors", rc)
    return offsets, total


def _eom_write(layer, col, aux, offsets, out):
    fn = dev.load_kernel("eom_colors").eom_write
    fn.argtypes, fn.restype = _EOM_WRITE_ARGS, ctypes.c_int
    null = ctypes.c_void_p(0)
    rc = fn(dev.ptr(layer), dev.ptr(col), null if aux is None else dev.ptr(aux),
            0 if aux is None else aux.shape[0], dev.ptr(offsets), layer.shape[0],
            dev.ptr(out), dev.stream_handle())
    dev.count_launch("eom_colors", 1 if layer.shape[0] else 0)
    dev.check_launch("eom_colors", rc)
    return out


def _check_eom_args(layer, col):
    d = layer.device
    dev.check_tensor(layer, "layer", torch.int32, d, 1)
    dev.check_tensor(col, "col", torch.int32, d, 2)
    if col.shape != (layer.shape[0], 3):
        raise ValueError(f"eom colors: layer {tuple(layer.shape)}, col {tuple(col.shape)}")


def extract_eom_colors(layer: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Kernel S, extract: `extract_eom_colors_plain` on the card (count,
    scan, then the compaction; the count decides the output's size, so the
    host reads it)."""
    if layer.device.type == "cpu":
        return extract_eom_colors_plain(layer, col)
    _check_eom_args(layer, col)
    offsets, total = _eom_offsets(layer)
    out = torch.empty((int(total), 3), dtype=torch.int32, device=layer.device)
    return _eom_write(layer, col, None, offsets, out)


def inject_eom_colors(layer: torch.Tensor, col: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Kernel S, inject: `inject_eom_colors_plain` on the card (count, scan,
    then every row written; nothing is read back)."""
    if layer.device.type == "cpu":
        return inject_eom_colors_plain(layer, col, aux)
    _check_eom_args(layer, col)
    dev.check_tensor(aux, "aux", torch.uint8, layer.device, 2)
    if aux.shape[0] < 1 or aux.shape[1] != 3:
        raise ValueError(f"inject_eom_colors: aux {tuple(aux.shape)}")
    offsets, _ = _eom_offsets(layer)
    return _eom_write(layer, col, aux, offsets, torch.empty_like(col))


def first_unique_rows(pos: torch.Tensor) -> torch.Tensor:
    """Ascending indices of the first row of each distinct (x, y, z): the
    rows the JAX package's `PointCloudData.remove_duplicates` keeps (numpy
    unique over rows, first instance), found with three stable sorts on the
    device."""
    perm = torch.arange(pos.shape[0], device=pos.device)
    for c in (2, 1, 0):
        perm = perm[torch.sort(pos[perm, c], stable=True).indices]
    srt = pos[perm]
    first = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    first[1:] = (srt[1:] != srt[:-1]).any(1)
    return torch.sort(perm[first]).values


def download_recon(recon: Points, col, bits: int,
                   remove_duplicates: bool = False, raw=None, refl=None):
    """Final positions (N, 3) int32, colors (N, 3) uint8 and reflectances
    (N,) uint16 (None without `refl`) as numpy, optionally without duplicate
    positions (first instance kept).  For grids of at most 10 bits the JAX
    package moves positions packed into one int32 per point and unpacks them
    on the host; the same packing is applied here so that out-of-range
    coordinates come out identically.  `raw` = (positions (R, 3) int32,
    colors (R, 3) uint8) numpy rows of the raw-points patch, appended after
    the reconstruction and before the duplicate removal, as the reference
    appends them; their reflectance is 0 (the reference zero-fills it,
    ROADMAP F3).  `refl`: the (N,) int32 decoded reflectance of the
    reconstruction's rows, taken modulo 2^16 as the reference's uint16
    cast."""
    col8 = col.clamp(0, 255).to(torch.uint8)
    pos = recon.pos
    if bits <= 10:
        p = pos.long()
        w = (p[:, 0] << (2 * bits)) | (p[:, 1] << bits) | p[:, 2]
        mask = (1 << bits) - 1
        pos = torch.stack([(w >> (2 * bits)) & mask, (w >> bits) & mask,
                           w & mask], 1).to(torch.int32)
    r16 = None if refl is None else (refl.to(torch.int64) & 0xFFFF).to(torch.int32)
    if raw is not None:
        d = pos.device
        pos = torch.cat([pos, torch.as_tensor(np.asarray(raw[0], np.int32), device=d)])
        col8 = torch.cat([col8, torch.as_tensor(np.asarray(raw[1], np.uint8), device=d)])
        if r16 is not None:
            r16 = torch.cat([r16, torch.zeros(len(raw[0]), dtype=torch.int32, device=d)])
    if remove_duplicates and pos.shape[0]:
        keep = first_unique_rows(pos)
        pos, col8 = pos[keep], col8[keep]
        if r16 is not None:
            r16 = r16[keep]
    return (pos.cpu().numpy(), col8.cpu().numpy(),
            None if r16 is None else r16.cpu().numpy().astype(np.uint16))
