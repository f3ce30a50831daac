"""Patch data model + patch generation from connected components (host).

A copy of `vpcc_tpu/core/patch.py`.  Behavioral reference: `PCCPatch`
(source/lib/PccLibCommon/include/PCCPatch.h:42-213 — projection parameters
u1/v1/d1, axes, depth maps, patch2Canvas) and the per-component depth-map
construction inside `segmentPatches`
(source/lib/PccLibEncoder/source/PCCPatchSegmenter.cpp:910-1200):
D0 = nearest-depth scatter per pixel, d1 offset quantized to minLevel,
peak-per-block depth filtering, D1 = farthest depth within surfaceThickness
of D0 (color-gated), sizeD quantized to quantDD*minLevel-1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from vpcc_tpu_torch.ops.segmentation import VIEW_AXES  # noqa: F401  (re-exported)
from vpcc_tpu_torch.utils.config import VPCCConfig

INFINITE_DEPTH = np.int32(0x7FFF)


def rotate45(pos: np.ndarray, axis: int, bits: int) -> np.ndarray:
    """Forward 45-degree lift for the additional projection planes
    (reference: PCCPatchSegmenter.h:238 convert; offset S = 2^bits - 1
    keeps every rotated coordinate non-negative).  axis: 1=Y, 2=X, 3=Z."""
    s = (1 << bits) - 1
    x, y, z = pos[:, 0].astype(np.int64), pos[:, 1].astype(np.int64), pos[:, 2].astype(np.int64)
    if axis == 1:
        out = np.stack([x + z, y, z - x + s], 1)
    elif axis == 2:
        out = np.stack([x, y - z + s, y + z], 1)
    elif axis == 3:
        out = np.stack([x - y + s, x + y, z], 1)
    else:
        return pos
    return out.astype(np.int64)


def inverse_rotate45(pos: np.ndarray, axis: int, bits: int) -> np.ndarray:
    """Exact integer inverse of rotate45 (reference:
    PCCCodec.cpp:2514 inverseRotatePosition45DegreeOnAxis)."""
    s = (1 << bits) - 1
    p = pos.astype(np.int64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    if axis == 1:
        out = np.stack([(x - z + s) >> 1, y, (x + z - s) >> 1], 1)
    elif axis == 2:
        out = np.stack([x, (y + z - s) >> 1, (z - y + s) >> 1], 1)
    elif axis == 3:
        out = np.stack([(x + y - s) >> 1, (y - x + s) >> 1, z], 1)
    else:
        return pos
    return out


# orientation codes (reference: PCCBitstreamCommon.h:112-123)
ORIENT_DEFAULT = 0
ORIENT_SWAP = 1
ORIENT_ROT90 = 2
ORIENT_ROT180 = 3
ORIENT_ROT270 = 4
ORIENT_MIRROR = 5
ORIENT_MROT90 = 6
ORIENT_MROT180 = 7

# orientation preference orders for packing (reference: PCCCommon.h:131-150)
ORIENT_VERTICAL = [0, 1, 3, 5, 7, 4, 6, 2]
ORIENT_HORIZONTAL = [1, 0, 4, 6, 2, 3, 5, 7]


@dataclasses.dataclass
class Patch:
    """One projected patch. Depth maps hold ABSOLUTE 3D depth along the
    normal axis; video images store depth relative to d1.  The fields are
    the JAX package's, so `dataclasses.asdict` of either package's patch
    builds the other's (`carry.patches_from_dicts`)."""

    index: int
    view_id: int
    normal_axis: int
    tangent_axis: int
    bitangent_axis: int
    projection_mode: int  # 0: min depth ("near"), 1: max depth
    u1: int  # 3D tangent offset
    v1: int  # 3D bitangent offset
    d1: int  # 3D depth offset (quantized to minLevel)
    size_u: int
    size_v: int
    size_d: int
    occupancy_resolution: int
    depth0: np.ndarray  # (size_v, size_u) int32, INFINITE_DEPTH if empty
    depth1: np.ndarray  # (size_v, size_u) int32
    # packing results
    u0: int = 0
    v0: int = 0
    orientation: int = ORIENT_DEFAULT
    size_u0: int = 0  # block dims
    size_v0: int = 0
    # temporal-consistency hint (set by packing.match_patches): preferred
    # placement copied from the matched patch of the reference frame
    pref_u0: int = -1
    pref_v0: int = -1
    pref_orientation: int = -1
    # matched patch's index in the reference frame's patch list
    ref_patch_idx: int = -1
    # EOM in-between-point bits: bit k set means a point at directed depth
    # D0 + k + 1, strictly between D0 and D1 (PCCCodec.cpp:671-804)
    eom: Optional[np.ndarray] = None  # (size_v, size_u) int32 or None
    # 45-degree additional projection plane: 0 = axis-aligned, 1..3 = the
    # rotation axis (Y/X/Z); patch-local coords live in the rotated frame
    axis_of_additional_plane: int = 0
    geo_bits: int = 10  # 3D bit depth (for the rotation offset)
    # PLR fields (not produced by the port's encoder yet)
    plr_level: int = 1
    plr_mode: int = 0
    plr_block_modes: Optional[np.ndarray] = None
    # LOD patch scaling (reference pdu_lod_* syntax)
    lod_x: int = 1
    lod_y: int = 1

    def __post_init__(self):
        res = self.occupancy_resolution
        if self.size_u0 == 0:
            self.size_u0 = (self.size_u + res - 1) // res
        if self.size_v0 == 0:
            self.size_v0 = (self.size_v + res - 1) // res

    @property
    def occupancy(self) -> np.ndarray:
        return self.depth0 != INFINITE_DEPTH

    def block_occupancy(self) -> np.ndarray:
        """(size_v0, size_u0) bool — any occupied pixel in the block."""
        res = self.occupancy_resolution
        occ = np.zeros((self.size_v0 * res, self.size_u0 * res), bool)
        occ[: self.size_v, : self.size_u] = self.occupancy
        return occ.reshape(self.size_v0, res, self.size_u0, res).any(axis=(1, 3))

    # ------------------------------------------------------------------
    def patch_to_canvas(self, u: np.ndarray, v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized patch (u,v) -> canvas (x,y)
        (reference: PCCPatch.cpp:192-251)."""
        res = self.occupancy_resolution
        su = self.size_u0 * res
        sv = self.size_v0 * res
        x0, y0 = self.u0 * res, self.v0 * res
        o = self.orientation
        if o == ORIENT_DEFAULT:
            x, y = u, v
        elif o == ORIENT_ROT90:
            x, y = sv - 1 - v, u
        elif o == ORIENT_ROT180:
            x, y = su - 1 - u, sv - 1 - v
        elif o == ORIENT_ROT270:
            x, y = v, su - 1 - u
        elif o == ORIENT_MIRROR:
            x, y = su - 1 - u, v
        elif o == ORIENT_MROT90:
            x, y = sv - 1 - v, su - 1 - u
        elif o == ORIENT_MROT180:
            x, y = u, sv - 1 - v
        elif o == ORIENT_SWAP:
            x, y = v, u
        else:
            raise ValueError(f"orientation {o}")
        return x + x0, y + y0

    def canvas_footprint(self) -> Tuple[int, int]:
        """(width_blocks, height_blocks) of the patch on the canvas."""
        if self.orientation in (ORIENT_DEFAULT, ORIENT_ROT180, ORIENT_MIRROR, ORIENT_MROT180):
            return self.size_u0, self.size_v0
        return self.size_v0, self.size_u0

    # ------------------------------------------------------------------
    def generate_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All 3D points from the D0/D1 maps: (points_d0 (M,3) int32,
        points_d1 (M2,3), pixel_uv (M,2)) (reference: PCCPatch.h:201
        generatePoint)."""
        vv, uu = np.nonzero(self.occupancy)
        d0 = self.depth0[vv, uu]
        pts0 = self._uvd_to_xyz(uu, vv, d0)
        m1 = self.depth1[vv, uu] != d0
        pts1 = self._uvd_to_xyz(uu[m1], vv[m1], self.depth1[vv, uu][m1])
        if self.eom is not None and self.eom.any():
            # EOM points after D1's; the host depth is not clamped at 0 in
            # projection mode 1 (the device reconstruction clamps it)
            pdt = 1 - 2 * self.projection_mode
            ebits = self.eom[vv, uu]
            extra = []
            for k in range(int(ebits.max()).bit_length()):
                mk = (ebits >> k) & 1 != 0
                extra.append(self._uvd_to_xyz(uu[mk], vv[mk], d0[mk] + pdt * (k + 1)))
            pts1 = np.concatenate([pts1] + extra, axis=0)
        return pts0, pts1, np.stack([uu, vv], 1)

    def _uvd_to_xyz(self, u, v, d_abs):
        pts = np.zeros((len(u), 3), np.int64)
        pts[:, self.normal_axis] = d_abs
        pts[:, self.tangent_axis] = u * self.lod_x + self.u1
        pts[:, self.bitangent_axis] = v * self.lod_y + self.v1
        if self.axis_of_additional_plane:
            pts = inverse_rotate45(pts, self.axis_of_additional_plane, self.geo_bits)
        return pts.astype(np.int32)


def _color_similar(c1: np.ndarray, c2: np.ndarray, threshold: int = 128) -> np.ndarray:
    return np.all(np.abs(c1.astype(np.int32) - c2.astype(np.int32)) < threshold, axis=-1)


def build_patch_from_component(
    index: int,
    positions: np.ndarray,  # (N, 3) int32 full cloud
    colors: np.ndarray,     # (N, 3) uint8
    comp: np.ndarray,       # indices of this component
    view_id: int,
    cfg: VPCCConfig,
) -> Optional[Patch]:
    axes = VIEW_AXES[view_id]
    add_axis, normal_axis, tangent_axis, bitangent_axis, mode = (int(a) for a in axes)
    pdt = 1 - 2 * mode  # projectionDirectionType: +1 for mode 0, -1 for mode 1

    p = positions[comp]
    if add_axis:
        # 45-degree plane: project in the rotated frame (reference convert,
        # PCCPatchSegmenter.h:238); reconstruction inverse-rotates
        p = rotate45(p, add_axis, cfg.geometryBitDepth3D).astype(np.int32)
    d = p[:, normal_axis].astype(np.int32)
    u_abs = p[:, tangent_axis].astype(np.int64)
    v_abs = p[:, bitangent_axis].astype(np.int64)

    # patch splitting (reference: PCCPatchSegmenter.cpp:926-950)
    if cfg.enablePatchSplitting:
        keep = (u_abs - u_abs.min() < cfg.maxPatchSize) & (v_abs - v_abs.min() < cfg.maxPatchSize)
        if not keep.all():
            comp, p, d, u_abs, v_abs = comp[keep], p[keep], d[keep], u_abs[keep], v_abs[keep]
        if len(comp) == 0:
            return None

    u1, v1 = int(u_abs.min()), int(v_abs.min())
    # LOD scaling (reference levelOfDetailX/Y -> pdu lod syntax)
    lod_x = max(int(getattr(cfg, "levelOfDetailX", 1)), 1)
    lod_y = max(int(getattr(cfg, "levelOfDetailY", 1)), 1)
    u = ((u_abs - u1) // lod_x).astype(np.int64)
    v = ((v_abs - v1) // lod_y).astype(np.int64)
    size_u = int(u.max()) + 1
    size_v = int(v.max()) + 1
    pix = v * size_u + u

    # --- D0: nearest-depth scatter, with winning point id for color gating;
    # composite key (depth << 32 | point-rank) so a single minimum gives both
    d_dir = (pdt * d).astype(np.int64)  # minimize directed depth
    rank = np.arange(len(comp), dtype=np.int64)
    key = ((d_dir + (1 << 20)) << 32) | rank
    flat = np.full(size_u * size_v, np.int64(1) << 62, np.int64)
    np.minimum.at(flat, pix, key)
    occupied = flat != (np.int64(1) << 62)
    win_rank = (flat & 0xFFFFFFFF).astype(np.int64)
    d0_dir = (flat >> 32) - (1 << 20)  # directed depth
    d0_abs = np.where(occupied, pdt * d0_dir, INFINITE_DEPTH).astype(np.int32)

    # --- d1 offset quantized to minLevel (reference: :1060-1067)
    min_level = cfg.minLevel
    if mode == 0:
        d1 = (int(d.min()) // min_level) * min_level
    else:
        d1 = int(np.ceil(d.max() / min_level)) * min_level

    # --- depth filter (reference: :1101-1119)
    res = cfg.occupancyResolution
    size_u0 = (size_u + res - 1) // res
    size_v0 = (size_v + res - 1) // res
    d0_map = d0_abs.reshape(size_v, size_u)
    dir_map = np.where(d0_map == INFINITE_DEPTH, np.int32(1 << 20), pdt * d0_map)
    pad_v, pad_u = size_v0 * res - size_v, size_u0 * res - size_u
    dir_pad = np.pad(dir_map, ((0, pad_v), (0, pad_u)), constant_values=1 << 20)
    peak_dir = dir_pad.reshape(size_v0, res, size_u0, res).min(axis=(1, 3))
    peak_full = np.repeat(np.repeat(peak_dir, res, 0), res, 1)[:size_v, :size_u]
    occ_map = d0_map != INFINITE_DEPTH
    drop = occ_map & (
        (np.abs(dir_map - peak_full) > 32)
        | (cfg.surfaceThickness + pdt * d0_map > pdt * d1 + cfg.maxAllowedDepth)
    )
    d0_map = np.where(drop, INFINITE_DEPTH, d0_map)
    occ_map = d0_map != INFINITE_DEPTH

    # --- surface separation (reference: getPatchSurfaceThickness,
    # PCCPatchSegmenter.cpp:472-539): the largest thickness t whose
    # candidate D1 points keep the mean squared color distance to their D0
    # winner below 400
    eff_thickness = cfg.surfaceThickness
    if cfg.surfaceSeparation and cfg.surfaceThickness > 0 and cfg.mapCountMinus1 > 0:
        pix_d0 = d0_map.reshape(-1)[pix]
        delta = pdt * (d - pix_d0)
        win_pt = comp[np.minimum(win_rank, len(comp) - 1)]
        c_pt = colors[comp].astype(np.int32)
        c_d0 = colors[win_pt[pix]].astype(np.int32)
        similar = np.all(np.abs(c_pt - c_d0) < 128, axis=-1)
        err = ((c_pt - c_d0) ** 2).sum(-1).astype(np.int64)
        base = (pix_d0 != INFINITE_DEPTH) & (delta > 0) & similar
        eff_thickness = -1
        for t in range(cfg.surfaceThickness, 0, -1):
            cand_t = base & (delta <= t)
            n_t = int(cand_t.sum())
            if n_t == 0 or float(err[cand_t].sum()) / n_t < 400.0:
                eff_thickness = t
                break

    # --- D1 layer: farthest depth within surfaceThickness of D0, color-gated
    # (reference: :1153-1195)
    d1_map = d0_map.copy()
    if eff_thickness > 0 and cfg.mapCountMinus1 > 0:
        pix_d0 = d0_map.reshape(-1)[pix]
        delta = pdt * (d - pix_d0)
        win_pt = comp[np.minimum(win_rank, len(comp) - 1)]
        similar = _color_similar(colors[comp], colors[win_pt[pix]])
        cand = (pix_d0 != INFINITE_DEPTH) & (delta >= 0) & (delta <= eff_thickness) & similar
        far_key = np.full(size_u * size_v, -(np.int64(1) << 40), np.int64)
        np.maximum.at(far_key, pix[cand], (pdt * d[cand]).astype(np.int64))
        has_far = far_key != -(np.int64(1) << 40)
        d1_flat = d1_map.reshape(-1)
        upd = has_far & (far_key > pdt * d1_flat) & (d1_flat != INFINITE_DEPTH)
        d1_flat[upd] = (pdt * far_key[upd]).astype(np.int32)
        d1_map = d1_flat.reshape(size_v, size_u)

    if not occ_map.any():
        return None

    # --- EOM bits: the points strictly between D0 and D1, which the two maps
    # drop (PCCCodec.cpp:671-804)
    eom_map = None
    if cfg.enhancedOccupancyMapCode:
        pix_d0 = d0_map.reshape(-1)[pix]
        pix_d1 = d1_map.reshape(-1)[pix]
        delta = pdt * (d - pix_d0)
        between = (pix_d0 != INFINITE_DEPTH) & (delta > 0) & (pdt * d < pdt * pix_d1)
        ebits = np.zeros(size_u * size_v, np.int32)
        np.bitwise_or.at(ebits, pix[between],
                         np.int32(1) << (delta[between] - 1).astype(np.int32))
        eom_map = ebits.reshape(size_v, size_u)

    # --- sizeD (reference: :1203-1218)
    rel1 = pdt * (d1_map[occ_map] - d1)
    size_d_pixel = int(rel1.max(initial=0))
    bitdepth_d = min(cfg.geometryBitDepth3D, cfg.geometryBitDepth2D) - int(np.log2(min_level))
    max_dd = 1 << bitdepth_d
    size_d = min((1 << min(cfg.geometryBitDepth3D, cfg.geometryBitDepth2D)) - 1, size_d_pixel)
    quant_dd = 0 if size_d == 0 else (size_d - 1) // min_level + 1
    quant_dd = min(quant_dd, max_dd - 1)
    size_d = 0 if quant_dd == 0 else quant_dd * min_level - 1

    return Patch(
        index=index,
        view_id=view_id,
        normal_axis=normal_axis,
        tangent_axis=tangent_axis,
        bitangent_axis=bitangent_axis,
        projection_mode=mode,
        u1=u1,
        v1=v1,
        d1=d1,
        size_u=size_u,
        size_v=size_v,
        size_d=size_d,
        occupancy_resolution=cfg.occupancyResolution,
        depth0=d0_map.astype(np.int32),
        depth1=d1_map.astype(np.int32),
        eom=eom_map,
        lod_x=lod_x,
        lod_y=lod_y,
        axis_of_additional_plane=add_axis,
        geo_bits=cfg.geometryBitDepth3D,
    )
