"""Patch packing onto the atlas canvas (host numpy/scipy).

A copy of `match_patches`, `pack_flexible`, `pack_tetris` and
`pack_global` from `vpcc_tpu/core/packing.py`.  Behavioral reference:
`PCCEncoder::packFlexible` (source/lib/PccLibEncoder/source/PCCEncoder.cpp:
2306-2450) and the match step of spatialConsistencyPackFlexible (:1183):
sort patches by size, first-fit raster scan over the block grid trying a
preference-ordered list of orientations, growing the canvas when nothing
fits.  Each patch's valid placements come from one 2D correlation of the
canvas block occupancy with the patch rectangle (the same scipy
`fftconvolve` call as the reference, so the same float rounding).
packingStrategy=2 is the skyline ("tetris") packing of
`PCCEncoder::packTetris` (:3258); `pack_global` is the global patch
allocation of a GOF (performDataAdaptiveGPAMethod, :6821).
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Tuple

import numpy as np
from scipy.signal import fftconvolve

from vpcc_tpu_torch.core.patch import (
    ORIENT_DEFAULT,
    ORIENT_HORIZONTAL,
    ORIENT_SWAP,
    ORIENT_VERTICAL,
    Patch,
)
from vpcc_tpu_torch.utils.config import VPCCConfig


def _orient_footprint(block_occ: np.ndarray, orientation: int) -> np.ndarray:
    """Patch block-occupancy footprint as placed on the canvas."""
    if orientation == ORIENT_DEFAULT:
        return block_occ
    if orientation == ORIENT_SWAP:
        return block_occ.T
    if orientation == 2:  # ROT90
        return np.rot90(block_occ, k=-1)
    if orientation == 3:  # ROT180
        return block_occ[::-1, ::-1]
    if orientation == 4:  # ROT270
        return np.rot90(block_occ, k=1)
    if orientation == 5:  # MIRROR
        return block_occ[:, ::-1]
    if orientation == 6:  # MROT90
        return np.rot90(block_occ[:, ::-1], k=-1)
    if orientation == 7:  # MROT180
        return block_occ[::-1, :]
    raise ValueError(orientation)


def _valid_positions(canvas: np.ndarray, fp: np.ndarray) -> np.ndarray:
    """(H-h+1, W-w+1) bool map of placements with zero block overlap."""
    h, w = fp.shape
    H, W = canvas.shape
    if h > H or w > W:
        return np.zeros((0, 0), bool)
    overlap = fftconvolve(canvas.astype(np.float32), fp[::-1, ::-1].astype(np.float32), mode="valid")
    return overlap < 0.5


def match_patches(patches: List[Patch], prev_patches: List[Patch], iou_threshold: float = 0.1) -> int:
    """Temporal patch matching (reference findMatches,
    PCCEncoder.cpp:1183-1290): match by projection plane + tangent-plane
    bounding-box IoU and record the matched patch's placement as the
    preferred one.  Returns the number of matched patches."""
    matched = 0
    used = set()
    for p in patches:
        best, best_iou = None, iou_threshold
        for j, q in enumerate(prev_patches):
            if j in used or q.view_id != p.view_id:
                continue
            x0 = max(p.u1, q.u1)
            x1 = min(p.u1 + p.size_u, q.u1 + q.size_u)
            y0 = max(p.v1, q.v1)
            y1 = min(p.v1 + p.size_v, q.v1 + q.size_v)
            inter = max(0, x1 - x0) * max(0, y1 - y0)
            union = p.size_u * p.size_v + q.size_u * q.size_v - inter
            iou = inter / union if union else 0.0
            if iou > best_iou:
                best, best_iou = j, iou
        if best is not None:
            used.add(best)
            q = prev_patches[best]
            p.pref_u0, p.pref_v0, p.pref_orientation = q.u0, q.v0, q.orientation
            # temporal prediction link for the atlas P-tile syntax
            p.ref_patch_idx = best
            matched += 1
    return matched


def _try_preferred(canvas: np.ndarray, p: Patch, bo: np.ndarray) -> bool:
    """Place the patch at its reference-frame position if its full
    rectangle is free; claim only its occupied blocks."""
    if p.pref_u0 < 0:
        return False
    fp = _orient_footprint(bo, p.pref_orientation)
    h, w = fp.shape
    if p.pref_v0 + h > canvas.shape[0] or p.pref_u0 + w > canvas.shape[1]:
        return False
    region = canvas[p.pref_v0 : p.pref_v0 + h, p.pref_u0 : p.pref_u0 + w]
    if region.any():
        return False
    p.u0, p.v0, p.orientation = p.pref_u0, p.pref_v0, p.pref_orientation
    region |= fp
    return True


def pack_flexible(
    patches: List[Patch],
    cfg: VPCCConfig,
    preset_height: int = 0,
) -> Tuple[int, int]:
    """Assign (u0, v0, orientation) to every patch; `preset_height` is the
    GOF's height ratchet (0: cfg.minimumImageHeight).

    Returns the (width, height) in pixels (height a multiple of 256).
    Mutates the patches in place, in sorted packing order."""
    if cfg.packingStrategy == 2:
        return pack_tetris(patches, cfg, preset_height)
    res = cfg.occupancyResolution
    strategy = cfg.packingStrategy
    if strategy == 0:
        patches.sort(key=lambda p: (-p.size_v, -p.size_u, p.index))
    else:
        patches.sort(
            key=lambda p: (
                -max(p.size_u0, p.size_v0),
                -min(p.size_u0, p.size_v0),
                p.index,
            )
        )

    width_blk = max(cfg.minimumImageWidth, 64) // res
    for p in patches:
        width_blk = max(width_blk, p.size_u0 + 1)
    height_blk = max((p.size_v0 for p in patches), default=1)
    height_blk = max(height_blk, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res)

    canvas = np.zeros((height_blk, width_blk), bool)

    # matched patches first, at their reference-frame positions when free
    patches.sort(key=lambda p: (p.pref_u0 < 0,))
    for p in patches:
        bo = p.block_occupancy()
        if cfg.lowDelayEncoding:
            # precedence mode (reference lowDelayEncoding): claim the FULL
            # bounding rectangle so patch bounding boxes never overlap
            bo = np.ones_like(bo)
        # placement validity tests the full rectangle against the canvas of
        # OCCUPIED blocks, but only occupied blocks are claimed: a later
        # patch's rectangle never covers an earlier patch's occupied block,
        # which keeps the decoder's overwrite-order block-to-patch exact
        if _try_preferred(canvas, p, bo):
            continue
        if strategy == 0:
            orients = [ORIENT_DEFAULT]
        else:
            pref = ORIENT_HORIZONTAL if p.size_u0 > p.size_v0 else ORIENT_VERTICAL
            orients = pref[: (8 if cfg.useEightOrientations else 2)]

        placed = False
        while not placed:
            # valid maps per orientation; combined first-fit in raster order
            valids = []
            rect = np.ones_like(bo)
            for o in orients:
                fp = _orient_footprint(rect, o)
                valids.append((o, _valid_positions(canvas, fp), fp.shape))
            best = None  # (v, u, orient_rank)
            for rank, (o, vmap, shp) in enumerate(valids):
                if vmap.size == 0 or not vmap.any():
                    continue
                flat = np.argmax(vmap)  # first True in raster order
                vv, uu = divmod(int(flat), vmap.shape[1])
                if not vmap[vv, uu]:
                    continue
                if best is None or (vv, uu, rank) < best:
                    best = (vv, uu, rank)
            if best is None:
                canvas = np.concatenate([canvas, np.zeros_like(canvas)], axis=0)
                height_blk = canvas.shape[0]
                continue
            vv, uu, rank = best
            o, vmap, shp = valids[rank]
            p.u0, p.v0, p.orientation = uu, vv, o
            fp = _orient_footprint(bo, o)
            canvas[vv : vv + fp.shape[0], uu : uu + fp.shape[1]] |= fp
            placed = True

    # actual used height, padded to the preset and to a multiple of 256 rows
    used_rows = 0
    for p in patches:
        fw, fh = p.canvas_footprint()
        used_rows = max(used_rows, p.v0 + fh)
    height_blk = max(used_rows, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res)
    width = width_blk * res
    height = ((height_blk * res + 255) // 256) * 256
    return width, height


def pack_tetris(patches: List[Patch], cfg: VPCCConfig, preset_height: int = 0) -> Tuple[int, int]:
    """Skyline ("tetris") packing (reference `pack_tetris`,
    vpcc_tpu/core/packing.py:229-304; PCCEncoder::packTetris,
    PCCEncoder.cpp:3258): patches drop onto a per-column horizon; each
    placement picks the (orientation, column) minimizing the new skyline
    peak, then the trapped waste underneath, then the orientation's rank
    and the column.  A matched patch keeps its reference-frame position
    when its rectangle sits on or above the skyline there
    (spatialConsistencyPackTetris, :1414).  Placements always sit on top
    of the skyline, so a later patch's rectangle never covers an earlier
    patch's occupied blocks."""
    res = cfg.occupancyResolution
    patches.sort(
        key=lambda p: (-max(p.size_u0, p.size_v0), -min(p.size_u0, p.size_v0), p.index)
    )
    # matched patches first: their preferred spots stay reachable
    patches.sort(key=lambda p: (p.pref_u0 < 0,))
    width_blk = max(cfg.minimumImageWidth, 64) // res
    for p in patches:
        width_blk = max(width_blk, p.size_u0 + 1)
    horizon = np.zeros(width_blk, np.int64)

    for p in patches:
        bo = p.block_occupancy()
        if p.pref_u0 >= 0:
            fp = _orient_footprint(bo, p.pref_orientation)
            fh, fw = fp.shape
            x = p.pref_u0
            if x + fw <= width_blk and int(horizon[x : x + fw].max()) <= p.pref_v0:
                p.u0, p.v0, p.orientation = x, p.pref_v0, p.pref_orientation
                horizon[x : x + fw] = p.pref_v0 + fh
                continue
        pref = ORIENT_HORIZONTAL if p.size_u0 > p.size_v0 else ORIENT_VERTICAL
        orients = pref[: (8 if cfg.useEightOrientations else 2)]
        best = None  # (peak, waste, rank, x, o, fp)
        for rank, o in enumerate(orients):
            fp = _orient_footprint(bo, o)
            fh, fw = fp.shape
            if fw > width_blk:
                continue
            cols = np.arange(width_blk - fw + 1)
            # peak(x) = max(horizon[x:x+fw]) and the waste under it
            sw = np.lib.stride_tricks.sliding_window_view(horizon, fw)
            peak = sw.max(axis=1)
            waste = (peak[:, None] - sw).sum(axis=1)
            x = int(np.lexsort((cols, waste, peak))[0])
            cand = (int(peak[x]) + fh, int(waste[x]), rank, x, o, fp)
            if best is None or cand[:3] < best[:3]:
                best = cand
        _, _, _, x, o, fp = best
        fh, fw = fp.shape
        y = int(horizon[x : x + fw].max())
        p.u0, p.v0, p.orientation = x, y, o
        horizon[x : x + fw] = y + fh

    used_rows = int(horizon.max())
    height_blk = max(
        used_rows, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res
    )
    width = width_blk * res
    height = ((height_blk * res + 255) // 256) * 256
    return width, height


def pack_global(frame_patches: List[List[Patch]], cfg: VPCCConfig,
                parents: "List[int] | None" = None,
                preset_height: int = 0) -> Tuple[int, int]:
    """Global patch allocation over a GOF (reference `pack_global`,
    vpcc_tpu/core/packing.py:305-409; PCCEncoder.cpp:6821-7651
    performDataAdaptiveGPAMethod): the patches linked through
    `ref_patch_idx` to their tree parent's (`parents[fi]`, else frame
    fi - 1) form chains; each chain gets one (u0, v0, orientation), placed
    first fit against its union rectangle, largest union first (ties by
    chain id), claiming only the union of its members' block occupancies;
    the canvas doubles in height when nothing fits.  Mutates every patch
    (u0, v0, orientation, gpa_chain); returns the GOF's (width, height),
    the height a multiple of 256 and at least `preset_height`."""
    res = cfg.occupancyResolution
    # chains through the ref links over the coding tree
    chains: List[List[Patch]] = []
    chain_of_frame: List[dict] = []
    for fi, patches in enumerate(frame_patches):
        ref_frame = parents[fi] if parents is not None else fi - 1
        chain_of: dict = {}
        for pi, p in enumerate(patches):
            ref = p.ref_patch_idx
            if fi > 0 and ref >= 0 and 0 <= ref_frame < fi and ref in chain_of_frame[ref_frame]:
                ci = chain_of_frame[ref_frame][ref]
                chains[ci].append(p)
            else:
                ci = len(chains)
                chains.append([p])
            chain_of[pi] = ci
        chain_of_frame.append(chain_of)

    # the union footprint of each chain in the orientation of its first member
    entries = []
    for ci, members in enumerate(chains):
        m0 = members[0]
        pref = ORIENT_HORIZONTAL if m0.size_u0 > m0.size_v0 else ORIENT_VERTICAL
        o = pref[0] if cfg.packingStrategy else ORIENT_DEFAULT
        fps = [_orient_footprint(p.block_occupancy(), o) for p in members]
        fh = max(fp.shape[0] for fp in fps)
        fw = max(fp.shape[1] for fp in fps)
        union = np.zeros((fh, fw), bool)
        for fp in fps:
            union[: fp.shape[0], : fp.shape[1]] |= fp
        entries.append((fh * fw, ci, o, fw, fh, union))
    entries.sort(key=lambda e: (-e[0], e[1]))

    min_h = (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res
    width_blk = max(cfg.minimumImageWidth, 64) // res
    for e in entries:
        width_blk = max(width_blk, e[3] + 1)
    height_blk = max(max((e[4] for e in entries), default=1), min_h)
    canvas = np.zeros((height_blk, width_blk), bool)
    for _, ci, o, fw, fh, union in entries:
        while True:
            vmap = _valid_positions(canvas, np.ones((fh, fw), bool))
            if vmap.size and vmap.any():
                vv, uu = divmod(int(np.argmax(vmap)), vmap.shape[1])
                canvas[vv : vv + fh, uu : uu + fw] |= union
                for p in chains[ci]:
                    p.u0, p.v0, p.orientation = uu, vv, o
                    p.gpa_chain = ci
                break
            canvas = np.concatenate([canvas, np.zeros_like(canvas)], axis=0)

    used_rows = 0
    for patches in frame_patches:
        for p in patches:
            used_rows = max(used_rows, p.v0 + p.canvas_footprint()[1])
    height_blk = max(used_rows, min_h)
    return width_blk * res, ((height_blk * res + 255) // 256) * 256


def placement_digest(frame_patches, size) -> str:
    """md5 of every patch's (u0, v0, orientation, gpa_chain), frame by frame
    in list order, and the GOF's (width, height): a fingerprint of a
    `pack_global` result that either package's patches give alike."""
    rows = [[[int(p.u0), int(p.v0), int(p.orientation), int(getattr(p, "gpa_chain", -1))]
             for p in ps] for ps in frame_patches]
    return hashlib.md5(json.dumps([rows, [int(size[0]), int(size[1])]]).encode()).hexdigest()
