"""V-PCC decoder (the PCCDecoder equivalent), PyTorch port.

Behavioral reference: `PCCDecoder::decode`
(source/lib/PccLibDecoder/source/PCCDecoder.cpp:69-487) as the JAX package
implements it (vpcc_tpu/decoder.py): parse HLS -> decode video substreams
-> block-to-patch -> generatePointCloud -> grid smoothing -> color gather
-> duplicate removal.

Supported: the default configuration's path — occupancy, two geometry maps
and two attribute maps from the wavefront codec (or the lossless codecs),
hierarchical random-access GOFs, grid geometry smoothing — the CTC's
lossless conditions: the EOM plane (occupancy map 1) with its EOM points
(kernel C) and their aux colors (kernel S), and the raw-points patch, from
the atlas tile or the RAW/EOM aux substreams — and the reconstruction tools
a stream signals: PBF patch-border filtering (occupancy-synthesis SEI,
kernel U), PLR (the ASPS's PLR fields: one geometry and one attribute map,
kernel V's code plane through kernel C) and color smoothing
(attribute-smoothing SEI, kernel T) — and the reflectance attribute (the
AVD unit at map index REFL_MAP_INDEX: zlib or wavefront-coded 16-bit layers,
gathered per point by kernel P's scalar entry).  Other tools that are off by
default raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vpcc_tpu_torch import conformance, device as dev, pipeline
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.core import atlas as atlas_mod
from vpcc_tpu_torch.core.patch import INFINITE_DEPTH, VIEW_AXES, Patch
from vpcc_tpu_torch.ops import plr
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import aux_video, codecs


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1: off-main-path "
        "tools)"
    )


def _pdu_to_patch(pdu: v3c.PatchDataUnit, index: int, vps: v3c.V3CParameterSet) -> Patch:
    add_axis, na, ta, ba, mode = (int(a) for a in VIEW_AXES[pdu.projection_id])
    size_d = 0 if pdu.range_d == 0 else pdu.range_d * vps.min_level - 1
    dummy = np.full((1, 1), INFINITE_DEPTH, np.int32)
    return Patch(
        index=index,
        view_id=pdu.projection_id,
        normal_axis=na,
        tangent_axis=ta,
        bitangent_axis=ba,
        projection_mode=mode,
        u1=pdu.offset_u,
        v1=pdu.offset_v,
        d1=pdu.offset_d * vps.min_level,
        size_u=pdu.size_u,
        size_v=pdu.size_v,
        size_d=size_d,
        occupancy_resolution=vps.occupancy_resolution,
        depth0=dummy,
        depth1=dummy,
        u0=pdu.pos_x,
        v0=pdu.pos_y,
        orientation=pdu.orientation,
        size_u0=pdu.size_x_m1 + 1,
        size_v0=pdu.size_y_m1 + 1,
        axis_of_additional_plane=add_axis,
        geo_bits=vps.geometry_3d_bitdepth,
        lod_x=pdu.lod_x,
        lod_y=pdu.lod_y,
        plr_level=pdu.plr_level,
        plr_mode=pdu.plr_mode,
        plr_block_modes=pdu.plr_block_modes,
    )


class Decoder:
    """`Decoder(cfg, device=None).decode(stream)` -> list of PointCloudData.

    device None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch versions of the kernels."""

    def __init__(self, cfg: VPCCConfig | None = None, device=None):
        self.cfg = cfg or VPCCConfig()
        self.device = dev.resolve_device(device)
        self.frame_info: List[dict] = []
        self.level_violations: List[str] = []

    def decode(self, stream: bytes) -> List[PointCloudData]:
        units = v3c.read_sample_stream(stream)
        vps = None
        asps = None
        seis: dict = {}
        tiles: List[v3c.AtlasTileLayer] = []
        occ_sub = eom_sub = None
        raw_geo_sub = raw_attr_sub = None   # RAW/EOM aux substreams
        refl_sub = None                     # the reflectance attribute
        geo_subs = {}
        attr_subs = {}
        for utype, payload in units:
            br = BitReader(payload)
            if utype == v3c.V3C_VPS:
                vps = v3c.V3CParameterSet.read(br)
            elif utype == v3c.V3C_AD:
                # decoded-atlas-information-hash of every frame is verified
                # against the parsed patches (PCCDecoder.cpp:1214)
                asps, _, tiles, hash_ok, seis = v3c.read_atlas_substream(payload)
                if not all(hash_ok):
                    raise ValueError(
                        "decoded-atlas-information-hash SEI mismatch "
                        f"(frames: {[i for i, ok in enumerate(hash_ok) if not ok]})"
                    )
            elif utype == v3c.V3C_OVD:
                s = v3c.VideoSubstream.read(br)
                if s.map_index == 0:
                    occ_sub = s
                else:
                    eom_sub = s
            elif utype == v3c.V3C_GVD:
                s = v3c.VideoSubstream.read(br)
                if s.map_index == aux_video.AUX_MAP_INDEX:
                    raw_geo_sub = s
                else:
                    geo_subs[s.map_index] = s
            elif utype == v3c.V3C_AVD:
                s = v3c.VideoSubstream.read(br)
                if s.map_index == aux_video.AUX_MAP_INDEX:
                    raw_attr_sub = s
                elif s.map_index == codecs.REFL_MAP_INDEX:
                    refl_sub = s
                else:
                    attr_subs[s.map_index] = s
        assert vps is not None and occ_sub is not None

        cfg = self.cfg
        cfg.occupancyResolution = vps.occupancy_resolution
        cfg.occupancyPrecision = vps.occupancy_precision
        cfg.geometryNominal2dBitdepth = vps.geometry_2d_bitdepth
        # post-processing parameters come from the prefix SEIs (reference
        # PCCDecoder::setPostProcessingSeiParameters, PCCDecoder.cpp:553-650);
        # absent SEI = tool off
        sei_gs = seis.get(v3c.SEI_GEOMETRY_SMOOTHING)
        cfg.flagGeometrySmoothing = cfg.gridSmoothing = int(sei_gs is not None)
        if sei_gs is not None:
            cfg.gridSize = sei_gs.grid_size
            cfg.thresholdSmoothing = float(sei_gs.threshold)
        sei_as = seis.get(v3c.SEI_ATTRIBUTE_SMOOTHING)
        cfg.flagColorSmoothing = int(sei_as is not None)
        if sei_as is not None:
            cfg.cgridSize = sei_as.grid_size
            cfg.thresholdColorSmoothing = float(sei_as.threshold)
            cfg.thresholdColorVariation = float(sei_as.threshold_variation)
            cfg.thresholdColorDifference = float(sei_as.threshold_difference)
        sei_os = seis.get(v3c.SEI_OCCUPANCY_SYNTHESIS)
        cfg.pbfEnableFlag = int(sei_os is not None and sei_os.method_type == 1)
        if cfg.pbfEnableFlag:
            cfg.pbfPassesCount = sei_os.passes_count
            cfg.pbfFilterSize = sei_os.filter_size
            cfg.pbfLog2Threshold = sei_os.log2_threshold
        cfg.enhancedOccupancyMapCode = 1 if vps.eom_bits else 0
        if vps.eom_bits:
            cfg.surfaceThickness = vps.eom_bits + 1
        plr_on = asps is not None and bool(asps.plr_enabled_flag)
        if plr_on and vps.eom_bits:
            raise _unsupported("a stream with both EOM and PLR")

        out: List[PointCloudData] = []
        d = self.device
        geo_decs = {m: codecs.GeometrySubstreamDecoder(cfg, d) for m in geo_subs}
        attr_decs = {m: codecs.AttributeSubstreamDecoder(cfg, d) for m in attr_subs}
        # coding-structure parents from the ATL ref deltas (hierarchical
        # GOPs reference a tree parent, not just frame-1); decoded map
        # banks are pruned once no later frame needs them
        parent = [
            fi - t.ref_frame_delta if t.tile_type == v3c.TILE_P else -1
            for fi, t in enumerate(tiles)
        ]
        geo_bank: dict = {}
        attr_bank: dict = {}
        for fi in range(vps.frame_count):
            tile = tiles[fi]
            patches = [_pdu_to_patch(pdu, i, vps) for i, pdu in enumerate(tile.patches)]
            occ_video = codecs.decode_occupancy(occ_sub.frames[fi], cfg)
            occ = atlas_mod.upsample_occupancy(occ_video, vps.occupancy_precision)
            height, width = occ.shape
            eom = None
            if eom_sub is not None and eom_sub.frames[fi]:
                eom = codecs.decode_eom_plane(eom_sub.frames[fi])
            geo = []
            for m in sorted(geo_subs):
                layer_ref = None
                if geo:
                    layer_ref = (geo[0] if torch.is_tensor(geo[0])
                                 else np.asarray(geo[0]).astype(np.uint16))
                kw = {}
                if not geo:
                    kw["temporal_ref"] = geo_bank.get(parent[fi]) if parent[fi] >= 0 else None
                geo.append(geo_decs[m].decode(
                    geo_subs[m].frames[fi], layer_ref=layer_ref, **kw
                ))
            attr = []
            for m in sorted(attr_subs):
                layer_ref = attr[0] if attr else None
                kw = {}
                if not attr:
                    kw["temporal_ref"] = attr_bank.get(parent[fi]) if parent[fi] >= 0 else None
                attr.append(attr_decs[m].decode(
                    attr_subs[m].frames[fi], layer_ref=layer_ref, **kw
                ))
            needed = set(parent[fi + 1:])
            if fi in needed:
                geo_bank[fi] = geo_decs[0].ref
                attr_bank[fi] = attr_decs[0].refs
            for bank in (geo_bank, attr_bank):
                for k in [k for k in bank if k not in needed]:
                    del bank[k]
            btp = atlas_mod.derive_block_to_patch(
                occ, patches, width, height, vps.occupancy_resolution
            )
            cfg.occupancyResolution = vps.occupancy_resolution
            cfg.geometry3dCoordinatesBitdepth = vps.geometry_3d_bitdepth
            plr_modes = None
            if plr_on:
                plr_modes = plr.block_modes_from_patches(patches, btp, *btp.shape)
            occ_in = occ
            if cfg.pbfEnableFlag:
                occ_in = pipeline.apply_pbf_occupancy(occ, geo[0], btp, patches, cfg, d)
            recon = pipeline.reconstruct_frame(occ_in, geo, btp, patches, cfg, d, eom=eom,
                                               plr_modes=plr_modes,
                                               plr_mode_table=asps.plr_mode_table if plr_on
                                               else None)
            as_img = lambda a: (a if torch.is_tensor(a) else torch.as_tensor(
                np.asarray(a, np.uint8))).to(d)
            a0 = as_img(attr[0])
            a1 = as_img(attr[1]) if len(attr) > 1 else a0
            col_d = pipeline.gather_decoded_colors(recon.pix, recon.layer, a0, a1)
            aux_raw_pos = aux_raw_cols = aux_eom_cols = None
            if raw_geo_sub is not None:
                aux_raw_pos = aux_video.unpack_raw_geometry(raw_geo_sub.frames[fi])
            if raw_attr_sub is not None:
                aux_raw_cols, aux_eom_cols = aux_video.unpack_aux_attribute(
                    raw_attr_sub.frames[fi])
            if aux_eom_cols is not None:
                col_d = pipeline.inject_eom_colors(
                    recon.layer, col_d, torch.as_tensor(aux_eom_cols, device=d))
            col_d = pipeline.apply_color_smoothing_device(recon, col_d, cfg)
            refl_d = None
            if refl_sub is not None and refl_sub.frames[fi]:
                r0d, r1d = codecs.decode_reflectance(refl_sub.frames[fi], d)
                refl_d = pipeline.gather_decoded_scalar(recon.pix, recon.layer, r0d, r1d)
            # the raw points follow the reconstruction (reference
            # decoder.py:257-272): from the aux substreams, else the tile
            raw = None
            raw_pos = aux_raw_pos if aux_raw_pos is not None else tile.raw_positions
            if raw_pos is not None:
                raw_cols = aux_raw_cols if aux_raw_cols is not None else tile.raw_colors
                if raw_cols is None:
                    raw_cols = np.zeros_like(raw_pos, np.uint8)
                raw = (raw_pos, raw_cols)
            # duplicate removal (reference PCCPointSet.h:484, first instance
            # kept) runs on the device before the download
            pos, col, refl = pipeline.download_recon(
                recon, col_d, vps.geometry_3d_bitdepth,
                remove_duplicates=bool(cfg.removeDuplicatePoints), raw=raw, refl=refl_d,
            )
            pc = PointCloudData(pos, col, reflectances=refl)
            self.frame_info.append(
                dict(patch_count=len(patches), width=width, height=height)
            )
            # level-limit conformance against the signalled PTL (reference
            # PCCConformance::checkLevelLimits, PCCConformance.cpp:210-307)
            self.level_violations.extend(
                f"frame {fi}: {e}"
                for e in conformance.check_level_limits(
                    vps.ptl.level_idc, pc.point_count, len(patches),
                    width, height,
                )
            )
            out.append(pc)
        return out
