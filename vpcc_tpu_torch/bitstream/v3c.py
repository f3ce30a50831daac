"""V3C high-level syntax: parameter sets, atlas patch data, sample-stream mux.

Behavioral reference: the V3C unit layering of PccLibBitstreamCommon /
Writer / Reader — sample-stream header + sized units
(PCCBitstreamWriter.cpp:92-347: V3C_VPS / V3C_AD / V3C_OVD / V3C_GVD /
V3C_AVD), patch data units inside atlas tile layers
(PCCBitstreamWriter.cpp:900-1100 patchDataUnit: 2d pos/size, 3d offsets,
projection id, orientation), Exp-Golomb coded like the spec.

This is a faithful *capability* implementation of the container (unit
typing, parameter sets, per-patch syntax, sample-stream framing), not a
bit-exact clone of ISO/IEC 23090-5 — the video payloads carry the
wavefront codec's substreams (codec id signalled in the VPS, as the spec's
codec-mapping SEI allows).

A copy of `vpcc_tpu/bitstream/v3c.py`, reader and writer halves: the
decoder parses streams the JAX encoder writes and the encoder must write
the same bytes, so the syntax must stay identical.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from vpcc_tpu_torch.bitstream.bitio import BitReader, BitWriter

# unit types (reference: PCCBitstreamCommon.h:125-133)
V3C_VPS = 0
V3C_AD = 1
V3C_OVD = 2
V3C_GVD = 3
V3C_AVD = 4

# atlas NAL unit types (ISO/IEC 23090-5 Table 4 subset; reference:
# PCCBitstreamCommon.h NalUnitType)
NAL_TRAIL_N = 0        # non-IDR atlas tile layer
NAL_IDR_N_LP = 20      # IDR atlas tile layer
NAL_ASPS = 36          # atlas sequence parameter set
NAL_AFPS = 37          # atlas frame parameter set
NAL_PREFIX_NSEI = 43   # non-essential prefix SEI
NAL_SUFFIX_NSEI = 44   # non-essential suffix SEI
NAL_PREFIX_ESEI = 45   # essential prefix SEI (post-processing params)
NAL_SUFFIX_ESEI = 46
NAL_AAPS = 47          # atlas adaptation parameter set

# SEI payload types (reference: PCCBitstreamCommon.h:228-254 SeiPayloadType)
SEI_COMPONENT_CODEC_MAPPING = 11
SEI_VOLUMETRIC_RECTANGLE_INFORMATION = 15
SEI_DECODED_ATLAS_INFORMATION_HASH = 19
SEI_ATTRIBUTE_TRANSFORMATION_PARAMS = 64
SEI_OCCUPANCY_SYNTHESIS = 65
SEI_GEOMETRY_SMOOTHING = 66
SEI_ATTRIBUTE_SMOOTHING = 67

# codec ids for the video payloads
CODEC_LOSSLESS_ZLIB = 0    # host zlib (bring-up / lossless fallback)
CODEC_TPU_INTRA = 1        # TPU-native DCT+DC-DPCM codec (legacy, round 1)
CODEC_TPU_RLE = 2          # binary occupancy RLE+arith
CODEC_LOSSLESS_DELTA = 3   # zlib of the mod-2^b delta against the layer-0 map
CODEC_TPU_HEVC = 4         # TPU-native HEVC-class wavefront codec (video/hevc.py)


@dataclasses.dataclass
class ProfileTierLevel:
    """profile_tier_level() (reference: profileTierLevel,
    PCCBitstreamWriter.cpp:472-491; checked by PCCConformance.cpp:210-307).

    codec_group 127 = MP4RA (external codec mapping via the
    COMPONENT_CODEC_MAPPING SEI — how our TPU-native video codec is
    signalled, PCCBitstreamCommon.h:165)."""

    tier_flag: int = 0
    profile_codec_group_idc: int = 127   # CODEC_GROUP_MP4RA
    profile_toolset_idc: int = 1         # V-PCC extended
    profile_reconstruction_idc: int = 0  # Rec0
    level_idc: int = 30                  # level 1.0 (30), 2.0 (60), ...

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.tier_flag)
        bw.u(7, self.profile_codec_group_idc)
        bw.u(8, self.profile_toolset_idc)
        bw.u(8, self.profile_reconstruction_idc)
        bw.u(8, self.level_idc)

    @classmethod
    def read(cls, br: BitReader) -> "ProfileTierLevel":
        p = cls()
        p.tier_flag = br.u(1)
        p.profile_codec_group_idc = br.u(7)
        p.profile_toolset_idc = br.u(8)
        p.profile_reconstruction_idc = br.u(8)
        p.level_idc = br.u(8)
        return p


@dataclasses.dataclass
class V3CParameterSet:
    """Sequence-level parameters (reference: V3CParameterSet in
    PccLibBitstreamCommon, written at PCCBitstreamWriter.cpp:493)."""

    frame_width: int = 0
    frame_height: int = 0
    frame_count: int = 0
    occupancy_resolution: int = 16
    occupancy_precision: int = 4
    geometry_2d_bitdepth: int = 8
    geometry_3d_bitdepth: int = 10
    map_count_minus1: int = 1
    attribute_count: int = 1
    occupancy_codec_id: int = CODEC_TPU_RLE
    geometry_codec_id: int = CODEC_TPU_INTRA
    attribute_codec_id: int = CODEC_TPU_INTRA
    min_level: int = 64
    vps_id: int = 0
    # EOM (enhanced occupancy map): number of in-between bit planes, 0 = off
    eom_bits: int = 0
    ptl: ProfileTierLevel = dataclasses.field(default_factory=ProfileTierLevel)

    def write(self, bw: BitWriter) -> None:
        self.ptl.write(bw)
        bw.u(4, self.vps_id)
        bw.u(16, self.frame_width)
        bw.u(16, self.frame_height)
        bw.u(16, self.frame_count)
        bw.ue(self.occupancy_resolution)
        bw.ue(self.occupancy_precision)
        bw.u(5, self.geometry_2d_bitdepth)
        bw.u(5, self.geometry_3d_bitdepth)
        bw.u(4, self.map_count_minus1)
        bw.u(7, self.attribute_count)
        bw.u(8, self.occupancy_codec_id)
        bw.u(8, self.geometry_codec_id)
        bw.u(8, self.attribute_codec_id)
        bw.ue(self.min_level)
        bw.u(3, self.eom_bits)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "V3CParameterSet":
        v = cls()
        v.ptl = ProfileTierLevel.read(br)
        v.vps_id = br.u(4)
        v.frame_width = br.u(16)
        v.frame_height = br.u(16)
        v.frame_count = br.u(16)
        v.occupancy_resolution = br.ue()
        v.occupancy_precision = br.ue()
        v.geometry_2d_bitdepth = br.u(5)
        v.geometry_3d_bitdepth = br.u(5)
        v.map_count_minus1 = br.u(4)
        v.attribute_count = br.u(7)
        v.occupancy_codec_id = br.u(8)
        v.geometry_codec_id = br.u(8)
        v.attribute_codec_id = br.u(8)
        v.min_level = br.ue()
        v.eom_bits = br.u(3)
        br.byte_align()
        return v


# tile types / patch modes (reference: PCCBitstreamCommon.h:175-211
# I_INTRA and P_SKIP/P_MERGE/P_INTER/P_INTRA enums; P-mode numbering
# matches the reference PCCPatchModeP order)
TILE_I = 0
TILE_P = 1
PATCH_SKIP = 0
PATCH_MERGE = 1
PATCH_INTER = 2
PATCH_INTRA = 3

# P_MERGE field groups: a merge patch copies its reference and overrides
# only the flagged groups (reference mpdu_override_2d/3d_params_flag,
# PCCBitstreamWriter.cpp mergePatchDataUnit) — temporally matched patches
# that only slide in 2D cost 3 flag bits instead of 10 zero-deltas
_MERGE_GROUPS = (
    ("pos_x", "pos_y"),                                   # 2d position
    ("size_x_m1", "size_y_m1", "size_u", "size_v"),       # 2d size
    ("offset_u", "offset_v", "offset_d", "range_d"),      # 3d params
)


@dataclasses.dataclass
class PatchDataUnit:
    """Per-patch syntax (reference: PatchDataUnit written at
    PCCBitstreamWriter.cpp patchDataUnit; fields mirror pdu_*)."""

    pos_x: int = 0          # u0 (blocks)
    pos_y: int = 0          # v0
    size_x_m1: int = 0      # size_u0 - 1
    size_y_m1: int = 0      # size_v0 - 1
    offset_u: int = 0       # u1
    offset_v: int = 0       # v1
    offset_d: int = 0       # d1 / min_level (quantized)
    range_d: int = 0        # quantDD
    projection_id: int = 0  # view id 0..17
    orientation: int = 0    # 0..8
    size_u: int = 0         # exact pixel dims (pdu via quantizer in ref)
    size_v: int = 0
    # temporal prediction link (not serialized for intra patches): index of
    # the matched patch in the previous tile's patch list (reference:
    # inter patch ref index, PCCDecoder.cpp:829-1213)
    ref_index: int = -1
    # PLR data (serialized only when the ASPS PLR flag is on; reference
    # PLRData written per patch, PCCBitstreamWriter.cpp plrData)
    plr_level: int = 1
    plr_mode: int = 0
    plr_block_modes: Optional[np.ndarray] = None  # patch-space raster
    # LOD scaling (reference pdu_lod_enable_flag / pdu_lod_scale_x_minus1 /
    # pdu_lod_scale_y_idc)
    lod_x: int = 1
    lod_y: int = 1

    def fields(self):
        return (
            self.pos_x, self.pos_y, self.size_x_m1, self.size_y_m1,
            self.offset_u, self.offset_v, self.offset_d, self.range_d,
            self.size_u, self.size_v,
        )

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.pos_x)
        bw.ue(self.pos_y)
        bw.ue(self.size_x_m1)
        bw.ue(self.size_y_m1)
        bw.ue(self.offset_u)
        bw.ue(self.offset_v)
        bw.ue(self.offset_d)
        bw.ue(self.range_d)
        bw.u(5, self.projection_id)
        bw.u(4, self.orientation)
        bw.ue(self.size_u)
        bw.ue(self.size_v)
        lod_on = int(self.lod_x > 1 or self.lod_y > 1)
        bw.u(1, lod_on)
        if lod_on:
            bw.ue(self.lod_x - 1)
            bw.ue(self.lod_y - 1)

    @classmethod
    def read(cls, br: BitReader) -> "PatchDataUnit":
        p = cls()
        p.pos_x = br.ue()
        p.pos_y = br.ue()
        p.size_x_m1 = br.ue()
        p.size_y_m1 = br.ue()
        p.offset_u = br.ue()
        p.offset_v = br.ue()
        p.offset_d = br.ue()
        p.range_d = br.ue()
        p.projection_id = br.u(5)
        p.orientation = br.u(4)
        p.size_u = br.ue()
        p.size_v = br.ue()
        if br.u(1):
            p.lod_x = br.ue() + 1
            p.lod_y = br.ue() + 1
        return p


def _write_plr(bw: BitWriter, p: PatchDataUnit) -> None:
    """PLR data unit (reference plrData syntax): level flag, then one
    patch mode or per-block present+mode over the patch's block grid."""
    bw.u(1, 1 if p.plr_level else 0)
    if p.plr_level:
        bw.u(1, 1 if p.plr_mode > 0 else 0)
        if p.plr_mode > 0:
            bw.ue(p.plr_mode - 1)
        return
    nb = (p.size_x_m1 + 1) * (p.size_y_m1 + 1)
    modes = (
        np.zeros(nb, np.int32)
        if p.plr_block_modes is None
        else np.asarray(p.plr_block_modes, np.int32).ravel()
    )
    for i in range(nb):
        m = int(modes[i]) if i < len(modes) else 0
        bw.u(1, 1 if m > 0 else 0)
        if m > 0:
            bw.ue(m - 1)


def _read_plr(br: BitReader, p: PatchDataUnit) -> None:
    p.plr_level = br.u(1)
    if p.plr_level:
        p.plr_mode = br.ue() + 1 if br.u(1) else 0
        return
    nb = (p.size_x_m1 + 1) * (p.size_y_m1 + 1)
    modes = np.zeros(nb, np.int32)
    for i in range(nb):
        if br.u(1):
            modes[i] = br.ue() + 1
    p.plr_block_modes = modes


def _nblocks64(n: int) -> int:
    return (n + 63) // 64


def _to_blocks64(vals: np.ndarray) -> np.ndarray:
    """Pad a flat int array into (nblocks, 64) int32 'coefficient' blocks so
    the adaptive arithmetic coefficient coder can serve as a generic integer
    coder."""
    v = np.asarray(vals, np.int64)
    assert np.all(np.abs(v) < (1 << 31)), "value exceeds int32 coder range"
    n = len(v)
    out = np.zeros((_nblocks64(n), 64), np.int32)
    out.reshape(-1)[:n] = v.astype(np.int32)
    return out


def _from_blocks64(blocks: np.ndarray, n: int) -> np.ndarray:
    return blocks.reshape(-1)[:n].astype(np.int64)


@dataclasses.dataclass
class AtlasTileLayer:
    """One frame's atlas data (I-tile of patch data units + raw-points
    patch).  The raw-points patch mirrors RawPatchDataUnit
    (reference: PCCBitstreamCommon; points missed by projection are coded
    verbatim for the lossless conditions, PCCPatchSegmenter.cpp:1294-1320)."""

    frame_index: int = 0
    patches: List[PatchDataUnit] = dataclasses.field(default_factory=list)
    raw_positions: Optional[np.ndarray] = None  # (R, 3) int32
    raw_colors: Optional[np.ndarray] = None     # (R, 3) uint8
    geometry_bits: int = 10
    tile_type: int = TILE_I
    ref_patches: Optional[List[PatchDataUnit]] = None  # ref tile (P-tiles)
    # P-tiles: which earlier frame the patch prediction references, coded
    # as frame_index - ref_frame_index (1 = previous frame, the low-delay
    # chain; >1 = hierarchical-GOP tree parent, reference ref-list syntax
    # atgh_ref_atlas_frame_list, PCCBitstreamCommon.h AtlasTileHeader)
    ref_frame_delta: int = 1
    # multi-tile atlases (reference tile partitioning,
    # PCCEncoder.cpp:4837-5355 + AFPS tile information): tile_id selects
    # the partition; pos_y is coded relative to tile_row_start (blocks), so
    # each tile's ATL parses and predicts independently of its siblings
    tile_id: int = 0
    tile_row_start: int = 0
    plr_enabled: int = 0  # from ASPS; set by the substream writer/reader

    def _patch_mode(self, p: PatchDataUnit) -> int:
        """SKIP if the matched reference predicts every field exactly;
        MERGE if at most 2 of the 3 field groups changed (cheaper than
        INTER's full delta list); INTER if at least projection+orientation
        carry over; else INTRA (reference patch modes
        P_SKIP/P_MERGE/P_INTER/P_INTRA, PCCBitstreamCommon.h:194-211,
        decoded at PCCDecoder.cpp:829-1213)."""
        if (
            self.tile_type != TILE_P
            or p.ref_index < 0
            or self.ref_patches is None
            or p.ref_index >= len(self.ref_patches)
        ):
            return PATCH_INTRA
        q = self.ref_patches[p.ref_index]
        if q.projection_id != p.projection_id or q.orientation != p.orientation:
            return PATCH_INTRA
        if q.fields() == p.fields():
            return PATCH_SKIP
        changed = sum(
            1 for grp in _MERGE_GROUPS
            if any(getattr(p, f) != getattr(q, f) for f in grp)
        )
        return PATCH_MERGE if changed <= 2 else PATCH_INTER

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.frame_index)
        bw.ue(self.tile_id)
        bw.ue(self.tile_row_start)
        bw.u(1, self.tile_type)
        if self.tile_type == TILE_P:
            bw.ue(self.ref_frame_delta - 1)
        bw.ue(len(self.patches))
        expected_ref = 0
        for p in self.patches:
            if self.tile_type == TILE_I:
                p.write(bw)
                if self.plr_enabled:
                    _write_plr(bw, p)
                continue
            mode = self._patch_mode(p)
            bw.ue(mode)
            if mode == PATCH_INTRA:
                p.write(bw)
                if self.plr_enabled:
                    _write_plr(bw, p)
                continue
            bw.se(p.ref_index - expected_ref)
            expected_ref = p.ref_index + 1
            if mode == PATCH_MERGE:
                q = self.ref_patches[p.ref_index]
                for grp in _MERGE_GROUPS:
                    over = any(getattr(p, f) != getattr(q, f) for f in grp)
                    bw.u(1, int(over))
                    if over:
                        for f in grp:
                            bw.se(getattr(p, f) - getattr(q, f))
            elif mode != PATCH_SKIP:
                q = self.ref_patches[p.ref_index]
                for a, b in zip(p.fields(), q.fields()):
                    bw.se(a - b)
            # PLR modes are frame-local: coded even for SKIP patches
            if self.plr_enabled:
                _write_plr(bw, p)
        nraw = 0 if self.raw_positions is None else len(self.raw_positions)
        bw.ue(nraw)
        if nraw:
            bw.u(5, self.geometry_bits)
            bw.u(1, 1 if self.raw_colors is not None else 0)
            bw.byte_align()
            # lexicographic sort -> packed-key deltas -> adaptive arithmetic
            # coding (mortonOrderSortRawPoints equivalent; the coefficient
            # syntax doubles as a generic adaptive integer coder)
            from vpcc_tpu_torch.video import entropy

            b = self.geometry_bits
            pos = np.asarray(self.raw_positions, np.int64)
            keys = (pos[:, 0] << (2 * b)) | (pos[:, 1] << b) | pos[:, 2]
            order = np.argsort(keys)
            srt = pos[order]
            deltas = np.diff(srt, axis=0, prepend=np.zeros((1, 3), np.int64))
            payload = entropy.encode_coeffs(_to_blocks64(deltas.ravel()))
            bw.ue(len(payload))
            bw.bytes_(payload)
            if self.raw_colors is not None:
                cols = np.asarray(self.raw_colors, np.int64)[order]
                cdel = np.diff(cols, axis=0, prepend=np.zeros((1, 3), np.int64))
                cpay = entropy.encode_coeffs(_to_blocks64(cdel.ravel()))
                bw.ue(len(cpay))
                bw.bytes_(cpay)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader, ref_patches=None, plr_enabled: int = 0,
             prior_tiles=None) -> "AtlasTileLayer":
        """prior_tiles: all already-parsed tiles of the GOF, indexed by
        frame — P-tiles resolve their reference via ref_frame_delta
        (hierarchical GOPs reference a tree parent, not just frame-1).
        `ref_patches` remains as the direct single-reference form."""
        t = cls()
        t.plr_enabled = plr_enabled
        t.frame_index = br.ue()
        t.tile_id = br.ue()
        t.tile_row_start = br.ue()
        t.tile_type = br.u(1)
        if t.tile_type == TILE_P:
            t.ref_frame_delta = br.ue() + 1
            if prior_tiles is not None:
                ref_patches = prior_tiles[
                    (t.frame_index - t.ref_frame_delta, t.tile_id)
                ].patches
        n = br.ue()
        t.patches = []
        expected_ref = 0
        for _ in range(n):
            if t.tile_type == TILE_I:
                p = PatchDataUnit.read(br)
                if plr_enabled:
                    _read_plr(br, p)
                t.patches.append(p)
                continue
            mode = br.ue()
            if mode == PATCH_INTRA:
                p = PatchDataUnit.read(br)
                if plr_enabled:
                    _read_plr(br, p)
                t.patches.append(p)
                continue
            ref_idx = expected_ref + br.se()
            expected_ref = ref_idx + 1
            q = ref_patches[ref_idx]
            p = PatchDataUnit(
                projection_id=q.projection_id, orientation=q.orientation,
                ref_index=ref_idx,
            )
            vals = list(q.fields())
            if mode == PATCH_INTER:
                vals = [v + br.se() for v in vals]
            (p.pos_x, p.pos_y, p.size_x_m1, p.size_y_m1, p.offset_u,
             p.offset_v, p.offset_d, p.range_d, p.size_u, p.size_v) = vals
            if mode == PATCH_MERGE:
                for grp in _MERGE_GROUPS:
                    if br.u(1):
                        for f in grp:
                            setattr(p, f, getattr(p, f) + br.se())
            if plr_enabled:
                _read_plr(br, p)
            t.patches.append(p)
        nraw = br.ue()
        if nraw:
            from vpcc_tpu_torch.video import entropy

            t.geometry_bits = br.u(5)
            has_col = br.u(1)
            br.byte_align()
            plen = br.ue()
            deltas = _from_blocks64(
                entropy.decode_coeffs(br.bytes_(plen), _nblocks64(nraw * 3)), nraw * 3
            ).reshape(-1, 3)
            t.raw_positions = np.cumsum(deltas, axis=0).astype(np.int32)
            if has_col:
                clen = br.ue()
                cdel = _from_blocks64(
                    entropy.decode_coeffs(br.bytes_(clen), _nblocks64(nraw * 3)), nraw * 3
                ).reshape(-1, 3)
                t.raw_colors = np.cumsum(cdel, axis=0).astype(np.uint8)
        br.byte_align()
        return t


@dataclasses.dataclass
class AtlasSequenceParameterSet:
    """ASPS (reference: AtlasSequenceParameterSetRbsp, written at
    PCCBitstreamWriter.cpp atlasSequenceParameterSetRbsp)."""

    asps_id: int = 0
    frame_width: int = 0
    frame_height: int = 0
    log2_patch_packing_block_size: int = 4  # occupancyResolution = 16
    geometry_3d_bitdepth_minus1: int = 9
    geometry_2d_bitdepth_minus1: int = 7
    map_count_minus1: int = 1
    eom_patch_enabled_flag: int = 0
    plr_enabled_flag: int = 0
    extended_projection_enabled_flag: int = 0  # 45-degree planes
    # PLR information (reference PLRInformation / asps_plr_* syntax,
    # PCCBitstreamWriter.cpp plrInformation): number of modes, the
    # per-mode (interpolate, filling, minD1, neighbor) table, and the
    # small-patch block threshold for patch-level modes
    plr_num_modes: int = 6
    plr_block_threshold: int = 9
    plr_mode_table: Optional[np.ndarray] = None  # (M, 4) int32

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.asps_id)
        bw.u(16, self.frame_width)
        bw.u(16, self.frame_height)
        bw.u(3, self.log2_patch_packing_block_size)
        bw.u(5, self.geometry_3d_bitdepth_minus1)
        bw.u(5, self.geometry_2d_bitdepth_minus1)
        bw.u(4, self.map_count_minus1)
        bw.u(1, self.eom_patch_enabled_flag)
        bw.u(1, self.plr_enabled_flag)
        if self.plr_enabled_flag:
            bw.u(4, self.plr_num_modes - 1)
            bw.ue(self.plr_block_threshold)
            tbl = self.plr_mode_table
            if tbl is None:
                from vpcc_tpu_torch.ops.plr import MODE_TABLE

                tbl = MODE_TABLE[: self.plr_num_modes]
            for row in np.asarray(tbl, np.int32):
                bw.u(1, int(row[0]))
                bw.u(1, int(row[1]))
                bw.ue(int(row[2]))
                bw.u(2, int(row[3]) - 1)
        bw.u(1, self.extended_projection_enabled_flag)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "AtlasSequenceParameterSet":
        a = cls()
        a.asps_id = br.ue()
        a.frame_width = br.u(16)
        a.frame_height = br.u(16)
        a.log2_patch_packing_block_size = br.u(3)
        a.geometry_3d_bitdepth_minus1 = br.u(5)
        a.geometry_2d_bitdepth_minus1 = br.u(5)
        a.map_count_minus1 = br.u(4)
        a.eom_patch_enabled_flag = br.u(1)
        a.plr_enabled_flag = br.u(1)
        if a.plr_enabled_flag:
            a.plr_num_modes = br.u(4) + 1
            a.plr_block_threshold = br.ue()
            tbl = np.zeros((a.plr_num_modes, 4), np.int32)
            for i in range(a.plr_num_modes):
                tbl[i, 0] = br.u(1)
                tbl[i, 1] = br.u(1)
                tbl[i, 2] = br.ue()
                tbl[i, 3] = br.u(2) + 1
            a.plr_mode_table = tbl
        a.extended_projection_enabled_flag = br.u(1)
        br.byte_align()
        return a


@dataclasses.dataclass
class AtlasAdaptationParameterSet:
    """AAPS with the V-PCC extension's atlas camera parameters (reference:
    atlasAdaptationParameterSetRbsp, PCCBitstreamWriter.cpp:891-905, and
    aapsVpccExtension/atlasCameraParameters, :2472-2500): a per-atlas
    model-to-scene transform (scale u(32) x3 / offset i(32) x3 / rotation
    i(16) x3) the renderer applies after reconstruction."""

    aaps_id: int = 0
    camera_model: int = 0          # 1 = orthographic parameters present
    scale: Optional[Tuple[int, int, int]] = None
    offset: Optional[Tuple[int, int, int]] = None
    rotation: Optional[Tuple[int, int, int]] = None

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.aaps_id)
        has_cam = self.camera_model == 1
        bw.u(1, 1)          # extension_flag
        bw.u(1, 1)          # vpcc_extension_flag
        bw.u(7, 0)          # extension_7bits
        bw.u(1, int(has_cam))  # camera_parameters_present_flag
        if has_cam:
            bw.u(8, self.camera_model)
            bw.u(1, int(self.scale is not None))
            bw.u(1, int(self.offset is not None))
            bw.u(1, int(self.rotation is not None))
            if self.scale is not None:
                for v in self.scale:
                    bw.u(32, v)
            if self.offset is not None:
                for v in self.offset:
                    bw.u(32, v & 0xFFFFFFFF)
            if self.rotation is not None:
                for v in self.rotation:
                    bw.u(16, v & 0xFFFF)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "AtlasAdaptationParameterSet":
        a = cls()
        a.aaps_id = br.ue()
        br.u(1)  # extension_flag
        br.u(1)  # vpcc_extension_flag
        br.u(7)  # extension_7bits
        if br.u(1):
            a.camera_model = br.u(8)
            has_s, has_o, has_r = br.u(1), br.u(1), br.u(1)
            sgn32 = lambda v: v - (1 << 32) if v >= (1 << 31) else v
            sgn16 = lambda v: v - (1 << 16) if v >= (1 << 15) else v
            if has_s:
                a.scale = tuple(br.u(32) for _ in range(3))
            if has_o:
                a.offset = tuple(sgn32(br.u(32)) for _ in range(3))
            if has_r:
                a.rotation = tuple(sgn16(br.u(16)) for _ in range(3))
        br.byte_align()
        return a


@dataclasses.dataclass
class AtlasFrameParameterSet:
    """AFPS (reference: AtlasFrameParameterSetRbsp + tile information)."""

    afps_id: int = 0
    asps_id: int = 0
    num_tiles_minus1: int = 0
    output_flag_present: int = 0

    def write(self, bw: BitWriter) -> None:
        bw.ue(self.afps_id)
        bw.ue(self.asps_id)
        bw.ue(self.num_tiles_minus1)
        bw.u(1, self.output_flag_present)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "AtlasFrameParameterSet":
        a = cls()
        a.afps_id = br.ue()
        a.asps_id = br.ue()
        a.num_tiles_minus1 = br.ue()
        a.output_flag_present = br.u(1)
        br.byte_align()
        return a


def patch_list_hash(patches: List[PatchDataUnit], plr_enabled: int = 0) -> bytes:
    """MD5 over the canonical decoded patch parameters of one frame — the
    payload of our decoded-atlas-information-hash SEI (reference:
    SeiDecodedAtlasInformationHash, created at PCCEncoder.cpp:8614 and
    verified at PCCDecoder.cpp:1214).  When PLR is signalled, the PLR
    syntax elements travel in the same ATL, so they are folded into the
    hash too (ADVICE r3: corruption of plr_level/mode/block modes was
    previously undetectable)."""
    import hashlib
    import struct as _s

    h = hashlib.md5()
    for p in patches:
        h.update(_s.pack("<12i", *p.fields(), p.projection_id, p.orientation))
        if plr_enabled:
            # hash exactly what the plrData syntax codes (_write_plr): the
            # level flag, then either the patch mode or the block-mode grid
            if p.plr_level:
                h.update(_s.pack("<2i", 1, p.plr_mode))
            else:
                nb = (p.size_x_m1 + 1) * (p.size_y_m1 + 1)
                modes = (
                    np.zeros(nb, np.int32)
                    if p.plr_block_modes is None
                    else np.asarray(p.plr_block_modes, np.int32).ravel()[:nb]
                )
                if len(modes) < nb:
                    modes = np.pad(modes, (0, nb - len(modes)))
                h.update(_s.pack("<i", 0) + modes.tobytes())
    return h.digest()


# ---------------------------------------------------------------------------
# Prefix SEI payloads (post-processing parameters).  The reference carries
# the decoder's reconstruction parameters as essential prefix SEIs attached
# to the first atlas tile layer (PCCEncoder.cpp:8472-8614 create*Sei;
# decoder consumption PCCDecoder.cpp:553-650 setPostProcessingSeiParameters).


@dataclasses.dataclass
class SEIGeometrySmoothing:
    """Grid geometry smoothing (reference SEIGeometrySmoothing,
    PCCSei.h; method_type 1 = grid smoothing)."""

    method_type: int = 1
    grid_size: int = 8       # coded as grid_size_minus2
    threshold: int = 64

    payload_type = SEI_GEOMETRY_SMOOTHING

    def write(self, bw: BitWriter) -> None:
        bw.u(8, self.method_type)
        bw.u(7, self.grid_size - 2)
        bw.u(16, self.threshold)

    @classmethod
    def read(cls, br: BitReader) -> "SEIGeometrySmoothing":
        s = cls()
        s.method_type = br.u(8)
        s.grid_size = br.u(7) + 2
        s.threshold = br.u(16)
        return s


@dataclasses.dataclass
class SEIAttributeSmoothing:
    """Grid color smoothing (reference SEIAttributeSmoothing)."""

    method_type: int = 1
    grid_size: int = 4
    threshold: int = 10
    threshold_variation: int = 6
    threshold_difference: int = 10

    payload_type = SEI_ATTRIBUTE_SMOOTHING

    def write(self, bw: BitWriter) -> None:
        bw.u(8, self.method_type)
        bw.u(7, self.grid_size - 2)
        bw.u(16, self.threshold)
        bw.u(16, self.threshold_variation)
        bw.u(16, self.threshold_difference)

    @classmethod
    def read(cls, br: BitReader) -> "SEIAttributeSmoothing":
        s = cls()
        s.method_type = br.u(8)
        s.grid_size = br.u(7) + 2
        s.threshold = br.u(16)
        s.threshold_variation = br.u(16)
        s.threshold_difference = br.u(16)
        return s


@dataclasses.dataclass
class SEIOccupancySynthesis:
    """PBF patch border filtering parameters (reference
    SEIOccupancySynthesis, method_type 1 = PBF; encoder fill
    PCCEncoder.cpp:8497-8511, decoder use PCCDecoder.cpp:586-602)."""

    method_type: int = 1
    passes_count: int = 2    # coded minus1
    filter_size: int = 4     # coded minus1
    log2_threshold: int = 2  # coded minus1

    payload_type = SEI_OCCUPANCY_SYNTHESIS

    def write(self, bw: BitWriter) -> None:
        bw.u(8, self.method_type)
        bw.u(8, self.passes_count - 1)
        bw.u(8, self.filter_size - 1)
        bw.u(8, self.log2_threshold - 1)

    @classmethod
    def read(cls, br: BitReader) -> "SEIOccupancySynthesis":
        s = cls()
        s.method_type = br.u(8)
        s.passes_count = br.u(8) + 1
        s.filter_size = br.u(8) + 1
        s.log2_threshold = br.u(8) + 1
        return s


@dataclasses.dataclass
class SEIComponentCodecMapping:
    """Codec-id -> 4CC mapping for the video substreams (reference
    SEIComponentCodecMapping, PCCSei.h; required by the MP4RA codec group
    our PTL signals — it is how a non-enumerated codec like the TPU-native
    wavefront codec is identified, PCCBitstreamCommon.h:165)."""

    mappings: List[Tuple[int, str]] = dataclasses.field(
        default_factory=lambda: [
            (CODEC_TPU_HEVC, "tpuh"),
            (CODEC_TPU_RLE, "tprl"),
            (CODEC_LOSSLESS_ZLIB, "zlib"),
            (CODEC_LOSSLESS_DELTA, "zlbd"),
        ]
    )

    payload_type = SEI_COMPONENT_CODEC_MAPPING

    def write(self, bw: BitWriter) -> None:
        bw.u(8, len(self.mappings) - 1)
        for cid, fourcc in self.mappings:
            bw.u(8, cid)
            raw = fourcc.encode()[:4].ljust(4, b"\0")
            bw.bytes_(raw)

    @classmethod
    def read(cls, br: BitReader) -> "SEIComponentCodecMapping":
        s = cls(mappings=[])
        n = br.u(8) + 1
        for _ in range(n):
            cid = br.u(8)
            fourcc = br.bytes_(4).rstrip(b"\0").decode()
            s.mappings.append((cid, fourcc))
        return s


@dataclasses.dataclass
class SEIAttributeTransformationParams:
    """Per-attribute-dimension scale/offset the renderer applies after
    decoding (reference SEIAttributeTransformationParams, PCCSei.h
    atp_* syntax; carried for HDR / reflectance range mapping)."""

    # (attribute_idx, dimension_idx, scale_q16 u32, offset i32)
    params: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list
    )

    payload_type = SEI_ATTRIBUTE_TRANSFORMATION_PARAMS

    def write(self, bw: BitWriter) -> None:
        bw.ue(len(self.params))
        for ai, di, scale, off in self.params:
            bw.u(7, ai)
            bw.u(2, di)
            bw.u(32, scale)
            bw.u(32, off & 0xFFFFFFFF)

    @classmethod
    def read(cls, br: BitReader) -> "SEIAttributeTransformationParams":
        s = cls()
        n = br.ue()
        for _ in range(n):
            ai = br.u(7)
            di = br.u(2)
            scale = br.u(32)
            off = br.u(32)
            if off >= 1 << 31:
                off -= 1 << 32
            s.params.append((ai, di, scale, off))
        return s


@dataclasses.dataclass
class SEIVolumetricRectangleInformation:
    """2D atlas rectangles labelling scene objects (reference
    SEIVolumetricRectangleInformation, PCCSei.h vri_* syntax — the
    volumetric-tiling hook consumers use for partial access)."""

    # (object_idx, x, y, width, height)
    rectangles: List[Tuple[int, int, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    persistence_flag: int = 1

    payload_type = SEI_VOLUMETRIC_RECTANGLE_INFORMATION

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.persistence_flag)
        bw.ue(len(self.rectangles))
        for oi, x, y, w, h in self.rectangles:
            bw.ue(oi)
            bw.u(16, x)
            bw.u(16, y)
            bw.u(16, w)
            bw.u(16, h)

    @classmethod
    def read(cls, br: BitReader) -> "SEIVolumetricRectangleInformation":
        s = cls()
        s.persistence_flag = br.u(1)
        n = br.ue()
        for _ in range(n):
            s.rectangles.append(
                (br.ue(), br.u(16), br.u(16), br.u(16), br.u(16))
            )
        return s


# ---------------------------------------------------------------------------
# generic / informative SEI set (reference PCCSei.h:43-1940 payload classes;
# payload-type codes from PCCBitstreamCommon.h:229-247)

SEI_BUFFERING_PERIOD = 0
SEI_ATLAS_FRAME_TIMING = 1
SEI_FILLER_PAYLOAD = 2
SEI_USER_DATA_UNREGISTERED = 4
SEI_RECOVERY_POINT = 5
SEI_NO_RECONSTRUCTION = 6
SEI_TIME_CODE = 7
SEI_ACTIVE_SUB_BITSTREAMS = 10
SEI_SCENE_OBJECT_INFORMATION = 12
SEI_OBJECT_LABEL_INFORMATION = 13
SEI_PATCH_INFORMATION = 14
SEI_VIEWPORT_CAMERA_PARAMETERS = 17
SEI_VIEWPORT_POSITION = 18


@dataclasses.dataclass
class SEIBufferingPeriod:
    """HRD buffering period (reference SEIBufferingPeriod, PCCSei.h:
    bp_* syntax; delays in 90 kHz ticks)."""

    irap_cab_params_present_flag: int = 0
    initial_delay: int = 0      # nominal CAB removal delay
    initial_offset: int = 0

    payload_type = SEI_BUFFERING_PERIOD

    def write(self, bw: BitWriter) -> None:
        bw.u(1, self.irap_cab_params_present_flag)
        bw.u(32, self.initial_delay)
        bw.u(32, self.initial_offset)

    @classmethod
    def read(cls, br: BitReader) -> "SEIBufferingPeriod":
        s = cls()
        s.irap_cab_params_present_flag = br.u(1)
        s.initial_delay = br.u(32)
        s.initial_offset = br.u(32)
        return s


@dataclasses.dataclass
class SEIAtlasFrameTiming:
    """Per-frame CAB removal / display delay (reference
    SEIAtlasFrameTiming, aft_* syntax)."""

    cab_removal_delay: int = 0
    dab_output_delay: int = 0

    payload_type = SEI_ATLAS_FRAME_TIMING

    def write(self, bw: BitWriter) -> None:
        bw.u(32, self.cab_removal_delay)
        bw.u(32, self.dab_output_delay)

    @classmethod
    def read(cls, br: BitReader) -> "SEIAtlasFrameTiming":
        s = cls()
        s.cab_removal_delay = br.u(32)
        s.dab_output_delay = br.u(32)
        return s


@dataclasses.dataclass
class SEIUserDataUnregistered:
    """Opaque user data with a 16-byte UUID (reference
    SEIUserDataUnregistered, udu_* syntax)."""

    uuid: bytes = b"\0" * 16
    data: bytes = b""

    payload_type = SEI_USER_DATA_UNREGISTERED

    def write(self, bw: BitWriter) -> None:
        bw.bytes_(self.uuid[:16].ljust(16, b"\0"))
        bw.ue(len(self.data))
        bw.bytes_(self.data)

    @classmethod
    def read(cls, br: BitReader) -> "SEIUserDataUnregistered":
        s = cls()
        s.uuid = br.bytes_(16)
        s.data = br.bytes_(br.ue())
        return s


@dataclasses.dataclass
class SEIRecoveryPoint:
    """Random-access recovery marker (reference SEIRecoveryPoint, rp_*)."""

    recovery_afoc: int = 0     # frame-order delta where recon is correct
    exact_match_flag: int = 1
    broken_link_flag: int = 0

    payload_type = SEI_RECOVERY_POINT

    def write(self, bw: BitWriter) -> None:
        bw.se(self.recovery_afoc)
        bw.u(1, self.exact_match_flag)
        bw.u(1, self.broken_link_flag)

    @classmethod
    def read(cls, br: BitReader) -> "SEIRecoveryPoint":
        s = cls()
        s.recovery_afoc = br.se()
        s.exact_match_flag = br.u(1)
        s.broken_link_flag = br.u(1)
        return s


@dataclasses.dataclass
class SEINoReconstruction:
    """Frames not intended for display/reconstruction (reference
    SEINoDisplay / no-reconstruction marker)."""

    payload_type = SEI_NO_RECONSTRUCTION

    def write(self, bw: BitWriter) -> None:
        bw.u(1, 1)

    @classmethod
    def read(cls, br: BitReader) -> "SEINoReconstruction":
        br.u(1)
        return cls()


@dataclasses.dataclass
class SEITimeCode:
    """Clock timestamp of the frame (reference SEITimeCode, tc_*)."""

    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    n_frames: int = 0

    payload_type = SEI_TIME_CODE

    def write(self, bw: BitWriter) -> None:
        bw.u(5, self.hours)
        bw.u(6, self.minutes)
        bw.u(6, self.seconds)
        bw.u(9, self.n_frames)

    @classmethod
    def read(cls, br: BitReader) -> "SEITimeCode":
        s = cls()
        s.hours = br.u(5)
        s.minutes = br.u(6)
        s.seconds = br.u(6)
        s.n_frames = br.u(9)
        return s


@dataclasses.dataclass
class SEIActiveSubBitstreams:
    """Which substreams are active for partial decode (reference
    SEIActiveSubBitstreams, asb_* syntax)."""

    active_attributes: List[int] = dataclasses.field(default_factory=list)
    active_maps: List[int] = dataclasses.field(default_factory=list)
    raw_points_active_flag: int = 1

    payload_type = SEI_ACTIVE_SUB_BITSTREAMS

    def write(self, bw: BitWriter) -> None:
        bw.ue(len(self.active_attributes))
        for a in self.active_attributes:
            bw.u(7, a)
        bw.ue(len(self.active_maps))
        for m in self.active_maps:
            bw.u(4, m)
        bw.u(1, self.raw_points_active_flag)

    @classmethod
    def read(cls, br: BitReader) -> "SEIActiveSubBitstreams":
        s = cls()
        s.active_attributes = [br.u(7) for _ in range(br.ue())]
        s.active_maps = [br.u(4) for _ in range(br.ue())]
        s.raw_points_active_flag = br.u(1)
        return s


@dataclasses.dataclass
class SEISceneObjectInformation:
    """Scene objects with optional 3D bounding boxes (reference
    SEISceneObjectInformation, soi_* syntax; subset: idx + bbox)."""

    # (object_idx, (x, y, z, dx, dy, dz) | None)
    objects: List[Tuple[int, "Tuple[int, ...] | None"]] = dataclasses.field(
        default_factory=list
    )

    payload_type = SEI_SCENE_OBJECT_INFORMATION

    def write(self, bw: BitWriter) -> None:
        bw.ue(len(self.objects))
        for oi, bbox in self.objects:
            bw.ue(oi)
            bw.u(1, 0 if bbox is None else 1)
            if bbox is not None:
                for c in bbox:
                    bw.ue(int(c))

    @classmethod
    def read(cls, br: BitReader) -> "SEISceneObjectInformation":
        s = cls()
        for _ in range(br.ue()):
            oi = br.ue()
            bbox = tuple(br.ue() for _ in range(6)) if br.u(1) else None
            s.objects.append((oi, bbox))
        return s


@dataclasses.dataclass
class SEIObjectLabelInformation:
    """Object labels (reference SEIObjectLabelInformation, oli_*)."""

    labels: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    payload_type = SEI_OBJECT_LABEL_INFORMATION

    def write(self, bw: BitWriter) -> None:
        bw.ue(len(self.labels))
        for idx, text in self.labels:
            bw.ue(idx)
            raw = text.encode()
            bw.ue(len(raw))
            bw.bytes_(raw)

    @classmethod
    def read(cls, br: BitReader) -> "SEIObjectLabelInformation":
        s = cls()
        for _ in range(br.ue()):
            idx = br.ue()
            s.labels.append((idx, br.bytes_(br.ue()).decode()))
        return s


@dataclasses.dataclass
class SEIPatchInformation:
    """Patch-to-object association (reference SEIPatchInformation, pi_*
    subset: per (tile, patch) an object id)."""

    # (tile_id, patch_idx, object_idx)
    entries: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )

    payload_type = SEI_PATCH_INFORMATION

    def write(self, bw: BitWriter) -> None:
        bw.ue(len(self.entries))
        for t, p, o in self.entries:
            bw.ue(t)
            bw.ue(p)
            bw.ue(o)

    @classmethod
    def read(cls, br: BitReader) -> "SEIPatchInformation":
        s = cls()
        s.entries = [(br.ue(), br.ue(), br.ue()) for _ in range(br.ue())]
        return s


@dataclasses.dataclass
class SEIViewportCameraParameters:
    """Recommended-viewport camera intrinsics (reference
    SEIViewportCameraParameters, vcp_* subset)."""

    camera_id: int = 0
    camera_type: int = 0          # 0 equirect, 1 perspective, 2 ortho
    erp_horizontal_fov: int = 0   # units of 180/256 deg
    erp_vertical_fov: int = 0
    clipping_near_q16: int = 1 << 16
    clipping_far_q16: int = 1 << 24

    payload_type = SEI_VIEWPORT_CAMERA_PARAMETERS

    def write(self, bw: BitWriter) -> None:
        bw.u(10, self.camera_id)
        bw.u(3, self.camera_type)
        bw.u(8, self.erp_horizontal_fov)
        bw.u(8, self.erp_vertical_fov)
        bw.u(32, self.clipping_near_q16)
        bw.u(32, self.clipping_far_q16)

    @classmethod
    def read(cls, br: BitReader) -> "SEIViewportCameraParameters":
        s = cls()
        s.camera_id = br.u(10)
        s.camera_type = br.u(3)
        s.erp_horizontal_fov = br.u(8)
        s.erp_vertical_fov = br.u(8)
        s.clipping_near_q16 = br.u(32)
        s.clipping_far_q16 = br.u(32)
        return s


@dataclasses.dataclass
class SEIViewportPosition:
    """Recommended-viewport pose (reference SEIViewportPosition, vp_*
    subset: position + quaternion in Q16)."""

    camera_id: int = 0
    position_q16: Tuple[int, int, int] = (0, 0, 0)
    quaternion_q14: Tuple[int, int, int] = (0, 0, 0)  # x, y, z (w derived)

    payload_type = SEI_VIEWPORT_POSITION

    def write(self, bw: BitWriter) -> None:
        bw.u(10, self.camera_id)
        for c in self.position_q16:
            bw.u(32, c & 0xFFFFFFFF)
        for c in self.quaternion_q14:
            bw.u(16, c & 0xFFFF)

    @classmethod
    def read(cls, br: BitReader) -> "SEIViewportPosition":
        s = cls()
        s.camera_id = br.u(10)
        s.position_q16 = tuple(br.u(32) for _ in range(3))
        s.quaternion_q14 = tuple(br.u(16) for _ in range(3))
        return s


_SEI_CLASSES = {
    SEI_GEOMETRY_SMOOTHING: SEIGeometrySmoothing,
    SEI_ATTRIBUTE_SMOOTHING: SEIAttributeSmoothing,
    SEI_OCCUPANCY_SYNTHESIS: SEIOccupancySynthesis,
    SEI_COMPONENT_CODEC_MAPPING: SEIComponentCodecMapping,
    SEI_ATTRIBUTE_TRANSFORMATION_PARAMS: SEIAttributeTransformationParams,
    SEI_VOLUMETRIC_RECTANGLE_INFORMATION: SEIVolumetricRectangleInformation,
    SEI_BUFFERING_PERIOD: SEIBufferingPeriod,
    SEI_ATLAS_FRAME_TIMING: SEIAtlasFrameTiming,
    SEI_USER_DATA_UNREGISTERED: SEIUserDataUnregistered,
    SEI_RECOVERY_POINT: SEIRecoveryPoint,
    SEI_NO_RECONSTRUCTION: SEINoReconstruction,
    SEI_TIME_CODE: SEITimeCode,
    SEI_ACTIVE_SUB_BITSTREAMS: SEIActiveSubBitstreams,
    SEI_SCENE_OBJECT_INFORMATION: SEISceneObjectInformation,
    SEI_OBJECT_LABEL_INFORMATION: SEIObjectLabelInformation,
    SEI_PATCH_INFORMATION: SEIPatchInformation,
    SEI_VIEWPORT_CAMERA_PARAMETERS: SEIViewportCameraParameters,
    SEI_VIEWPORT_POSITION: SEIViewportPosition,
}


def _write_nal(bw: BitWriter, nal_type: int, payload: bytes) -> None:
    unit = bytes([nal_type << 1 & 0xFF, 0]) + payload  # 2-byte NAL header
    bw.u(32, len(unit))
    bw.bytes_(unit)


def _sei_size_write(bw: BitWriter, n: int) -> None:
    """SEI payload size with the spec's 0xFF-extension coding (the fixed
    u(8) it replaces silently truncated payloads over 255 bytes,
    ADVICE r3)."""
    while n >= 255:
        bw.u(8, 255)
        n -= 255
    bw.u(8, n)


def _sei_size_read(br: BitReader) -> int:
    n = 0
    while True:
        b = br.u(8)
        n += b
        if b != 255:
            return n


def write_atlas_substream(
    tiles: List[AtlasTileLayer],
    asps: AtlasSequenceParameterSet,
    afps: AtlasFrameParameterSet,
    prefix_seis: "List | None" = None,
    aaps: "AtlasAdaptationParameterSet | None" = None,
) -> bytes:
    """NAL-unit atlas substream: ASPS, AFPS, AAPS, essential prefix SEIs
    (post-processing parameters), then per frame an ATL NAL (IDR for
    frame 0) and a suffix SEI with the decoded-atlas-info hash
    (reference: PCCBitstreamWriter::atlasSubStream, PCCBitstreamWriter.cpp:348)."""
    bw = BitWriter()
    b = BitWriter()
    asps.write(b)
    _write_nal(bw, NAL_ASPS, b.getvalue())
    b = BitWriter()
    afps.write(b)
    _write_nal(bw, NAL_AFPS, b.getvalue())
    if aaps is not None:
        b = BitWriter()
        aaps.write(b)
        _write_nal(bw, NAL_AAPS, b.getvalue())
    for sei in prefix_seis or ():
        body = BitWriter()
        sei.write(body)
        body.byte_align()
        payload = body.getvalue()
        b = BitWriter()
        b.u(8, sei.payload_type)
        _sei_size_write(b, len(payload))
        b.bytes_(payload)
        _write_nal(bw, NAL_PREFIX_ESEI, b.getvalue())
    for t in tiles:
        t.plr_enabled = asps.plr_enabled_flag
        b = BitWriter()
        t.write(b)
        _write_nal(
            bw,
            NAL_IDR_N_LP if t.frame_index == 0 else NAL_TRAIL_N,
            b.getvalue(),
        )
        sei = BitWriter()
        sei.u(8, SEI_DECODED_ATLAS_INFORMATION_HASH)
        _sei_size_write(sei, 16)  # payload size: md5
        sei.bytes_(patch_list_hash(t.patches, plr_enabled=asps.plr_enabled_flag))
        _write_nal(bw, NAL_SUFFIX_NSEI, sei.getvalue())
    return bw.getvalue()


def read_atlas_substream(payload: bytes, tile_filter=None):
    """Returns (asps, afps, tiles, hash_ok: List[bool], seis: dict keyed by
    SEI payload type; seis also carries the AAPS under key "aaps").
    Multi-tile frames are merged into one AtlasTileLayer per frame (patch
    prediction resolves per (frame, tile) so every tile's ATL chain parses
    independently); pass `tile_filter` (a set of tile ids) for partial
    access — only the listed tiles are parsed and merged.  Verifies each
    ATL's decoded-atlas-information-hash SEI against its parsed patches
    (reference: PCCDecoder.cpp:1214)."""
    br = BitReader(payload)
    asps = afps = None
    by_tile: dict = {}          # (frame, tile_id) -> AtlasTileLayer
    frame_order: List[int] = []
    hash_ok: List[bool] = []
    seis: dict = {}
    last = None
    while br.more_data():
        ln = br.u(32)
        unit = br.bytes_(ln)
        nal_type = unit[0] >> 1
        body = BitReader(unit[2:])
        if nal_type == NAL_ASPS:
            asps = AtlasSequenceParameterSet.read(body)
        elif nal_type == NAL_AFPS:
            afps = AtlasFrameParameterSet.read(body)
        elif nal_type == NAL_AAPS:
            seis["aaps"] = AtlasAdaptationParameterSet.read(body)
        elif nal_type in (NAL_IDR_N_LP, NAL_TRAIL_N):
            if tile_filter is not None:
                peek = BitReader(unit[2:])
                peek.ue()  # frame_index
                if peek.ue() not in tile_filter:
                    # skip WITHOUT parsing: a filtered tile's prediction
                    # chain is never needed (tiles are independent)
                    last = None
                    continue
            t = AtlasTileLayer.read(
                body,
                plr_enabled=asps.plr_enabled_flag if asps else 0,
                prior_tiles=by_tile,
            )
            by_tile[(t.frame_index, t.tile_id)] = t
            if t.frame_index not in frame_order:
                frame_order.append(t.frame_index)
            last = t
        elif nal_type == NAL_PREFIX_ESEI:
            ptype = body.u(8)
            size = _sei_size_read(body)
            data = body.bytes_(size)
            klass = _SEI_CLASSES.get(ptype)
            if klass is not None:
                seis[ptype] = klass.read(BitReader(data))
        elif nal_type == NAL_SUFFIX_NSEI:
            ptype = body.u(8)
            size = _sei_size_read(body)
            data = body.bytes_(size)
            if ptype == SEI_DECODED_ATLAS_INFORMATION_HASH and last is not None:
                hash_ok.append(data == patch_list_hash(
                    last.patches,
                    plr_enabled=asps.plr_enabled_flag if asps else 0,
                ))
    # merge tiles into one layer per frame (patch order: tile id ascending)
    tiles: List[AtlasTileLayer] = []
    for fi in sorted(frame_order):
        parts = sorted(
            (t for (f, _), t in by_tile.items() if f == fi),
            key=lambda t: t.tile_id,
        )
        if len(parts) == 1:
            tiles.append(parts[0])
            continue
        merged = AtlasTileLayer(
            frame_index=fi,
            patches=[p for t in parts for p in t.patches],
            tile_type=parts[0].tile_type,
            ref_frame_delta=parts[0].ref_frame_delta,
            geometry_bits=parts[0].geometry_bits,
        )
        for t in parts:
            if t.raw_positions is not None:
                merged.raw_positions = (
                    t.raw_positions if merged.raw_positions is None
                    else np.concatenate([merged.raw_positions, t.raw_positions])
                )
                if t.raw_colors is not None:
                    merged.raw_colors = (
                        t.raw_colors if merged.raw_colors is None
                        else np.concatenate([merged.raw_colors, t.raw_colors])
                    )
        tiles.append(merged)
    return asps, afps, tiles, hash_ok, seis


@dataclasses.dataclass
class VideoSubstream:
    """Coded video payloads: one bytes blob per frame (per map)."""

    unit_type: int = V3C_GVD
    map_index: int = 0
    frames: List[bytes] = dataclasses.field(default_factory=list)

    def write(self, bw: BitWriter) -> None:
        bw.u(8, self.map_index)
        bw.ue(len(self.frames))
        for f in self.frames:
            bw.ue(len(f))
            bw.bytes_(f)
        bw.byte_align()

    @classmethod
    def read(cls, br: BitReader) -> "VideoSubstream":
        v = cls()
        v.map_index = br.u(8)
        n = br.ue()
        v.frames = []
        for _ in range(n):
            ln = br.ue()
            v.frames.append(br.bytes_(ln))
        return v


# ---------------------------------------------------------------------------
# sample stream mux (reference: sampleStreamV3CUnit,
# PCCBitstreamWriter.cpp:1463-1539 + PCCBitstreamReader.cpp:52-71)

def write_sample_stream(units: List[Tuple[int, bytes]]) -> bytes:
    max_size = max((len(p) for _, p in units), default=1)
    precision = max(1, (max_size.bit_length() + 7) // 8)
    out = bytearray([precision - 1 << 5 & 0xE0])
    for utype, payload in units:
        out.append(utype << 3)  # v3c unit header (type in top 5 bits)
        size = len(payload)
        out.extend(size.to_bytes(precision, "big"))
        out.extend(payload)
    return bytes(out)


def read_sample_stream(data: bytes) -> List[Tuple[int, bytes]]:
    precision = ((data[0] >> 5) & 0x7) + 1
    pos = 1
    units = []
    while pos < len(data):
        utype = data[pos] >> 3
        pos += 1
        size = int.from_bytes(data[pos : pos + precision], "big")
        pos += precision
        units.append((utype, data[pos : pos + size]))
        pos += size
    return units
