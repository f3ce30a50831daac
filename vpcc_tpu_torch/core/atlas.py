"""Atlas frame synthesis and the atlas helpers both sides run (host).

A copy of `vpcc_tpu/core/atlas.py`: rasterize packed patches into the
occupancy and geometry frames, the occupancy-video down/upsampling, the
patch table and the block-to-patch map.  Behavioral reference: occupancy
map generation (source/lib/PccLibEncoder/source/PCCEncoder.cpp:3740-3874),
intra geometry image generation (:3929-4063), block-to-patch derivation
(source/lib/PccLibCommon/source/PCCCodec.cpp:1619-1776).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from vpcc_tpu_torch.core.patch import Patch
from vpcc_tpu_torch.utils.config import VPCCConfig


@dataclasses.dataclass
class AtlasFrame:
    """One atlas frame's images + metadata (encoder side)."""

    width: int
    height: int
    occupancy: np.ndarray      # (H, W) uint8 {0,1} full-res
    geometry0: np.ndarray      # (H, W) uint16, relative depth D0
    geometry1: np.ndarray      # (H, W) uint16, relative depth D1 (absoluteD1)
    block_to_patch: np.ndarray  # (H/res, W/res) int32, 0 = none else idx+1
    patches: List[Patch]
    eom: "np.ndarray | None" = None  # (H, W) int32 EOM bit codes


def rasterize_frame(patches: List[Patch], width: int, height: int, cfg: VPCCConfig) -> AtlasFrame:
    """Write every patch's occupancy, D0/D1 depths (relative to d1, clipped
    to the 2D bit depth) and, with enhancedOccupancyMapCode, EOM codes at
    its canvas position, in patch order."""
    occ = np.zeros((height, width), np.uint8)
    geo0 = np.zeros((height, width), np.uint16)
    geo1 = np.zeros((height, width), np.uint16)
    eom = np.zeros((height, width), np.int32) if cfg.enhancedOccupancyMapCode else None
    max2d = (1 << cfg.geometryBitDepth2D) - 1
    for p in patches:
        pdt = 1 - 2 * p.projection_mode
        vv, uu = np.nonzero(p.occupancy)
        x, y = p.patch_to_canvas(uu, vv)
        rel0 = (pdt * (p.depth0[vv, uu] - p.d1)).astype(np.int64)
        rel1 = (pdt * (p.depth1[vv, uu] - p.d1)).astype(np.int64)
        occ[y, x] = 1
        geo0[y, x] = np.clip(rel0, 0, max2d).astype(np.uint16)
        geo1[y, x] = np.clip(rel1, 0, max2d).astype(np.uint16)
        if eom is not None and p.eom is not None:
            eom[y, x] = p.eom[vv, uu]
    btp = derive_block_to_patch(occ, patches, width, height, cfg.occupancyResolution)
    return AtlasFrame(width, height, occ, geo0, geo1, btp, patches, eom=eom)


def downsample_occupancy(occ: np.ndarray, precision: int, threshold: int = 0) -> np.ndarray:
    """Full-res binary map -> occupancy video at 1/precision resolution: a
    block is occupied when it holds more than `threshold` occupied pixels
    (threshold > 0 is the reference's lossy occupancy,
    PCCEncoder.cpp:863-962)."""
    h, w = occ.shape
    cnt = (
        (occ != 0)
        .reshape(h // precision, precision, w // precision, precision)
        .sum(axis=(1, 3))
    )
    return (cnt > threshold).astype(np.uint8)

# column order of the patch table read by ops/reconstruct.py
PATCH_FIELDS = (
    "u0", "v0", "size_u0", "size_v0", "u1", "v1", "d1",
    "normal_axis", "tangent_axis", "bitangent_axis",
    "projection_mode", "orientation", "axis_of_additional_plane", "geo_bits",
    "lod_x", "lod_y",
)


def patch_table(patches: List[Patch], capacity: int | None = None) -> np.ndarray:
    """(P_max, len(PATCH_FIELDS)) int32 SoA table, row per patch."""
    p_max = capacity or max(len(patches), 1)
    tbl = np.zeros((p_max, len(PATCH_FIELDS)), np.int32)
    for i, p in enumerate(patches):
        tbl[i] = [getattr(p, f) for f in PATCH_FIELDS]
    return tbl


def derive_block_to_patch(
    occupancy: np.ndarray, patches: List[Patch], width: int, height: int, res: int
) -> np.ndarray:
    """Block-to-patch map from the (decoded, precision-expanded) occupancy.

    Reference rule (PCCCodec.cpp:1723-1776
    generateBlockToPatchFromOccupancyMapVideo): iterate patches in bitstream
    order; every block of the patch's bounding box that contains ANY occupied
    pixel is assigned to that patch — later patches overwrite earlier ones.
    """
    hb, wb = height // res, width // res
    occ_blocks = occupancy.reshape(hb, res, wb, res).max(axis=(1, 3)) > 0
    btp = np.zeros((hb, wb), np.int32)
    for idx, p in enumerate(patches):
        bu, bv = np.meshgrid(np.arange(p.size_u0), np.arange(p.size_v0))
        bx, by = _block_to_canvas(p, bu.ravel(), bv.ravel())
        hit = occ_blocks[by, bx]
        btp[by[hit], bx[hit]] = idx + 1
    return btp


def _block_to_canvas(p: Patch, u: np.ndarray, v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """patchBlock2CanvasBlock (reference: PCCPatch.h:213): the patch->canvas
    transform at block granularity."""
    su, sv = p.size_u0, p.size_v0
    o = p.orientation
    if o == 0:
        x, y = u, v
    elif o == 2:
        x, y = sv - 1 - v, u
    elif o == 3:
        x, y = su - 1 - u, sv - 1 - v
    elif o == 4:
        x, y = v, su - 1 - u
    elif o == 5:
        x, y = su - 1 - u, v
    elif o == 6:
        x, y = sv - 1 - v, su - 1 - u
    elif o == 7:
        x, y = u, sv - 1 - v
    elif o == 1:
        x, y = v, u
    else:
        raise ValueError(o)
    return x + p.u0, y + p.v0


def upsample_occupancy(occ_video: np.ndarray, precision: int) -> np.ndarray:
    """Nearest upsampling back to full resolution
    (reference: PCCCodec.cpp:519-540 occupancy precision expansion)."""
    return np.repeat(np.repeat(occ_video, precision, 0), precision, 1)
