"""V-PCC encoder (the PCCEncoder equivalent), PyTorch port: the front end
and the geometry video.

Behavioral reference: `PCCEncoder::encode`
(source/lib/PccLibEncoder/source/PCCEncoder.cpp:71-730) as the JAX package
implements it (vpcc_tpu/encoder.py).  The port has
* the front end, from a source frame to the atlas frame: voxelize -> grid
  k-NN (kernel E) -> normals and segmentation (kernel F) -> patch rounds of
  connected components (kernel G) and coverage (kernel H) -> packing ->
  rasterization, occupancy video and block-to-patch;
* the geometry half of the video stage: the occupancy payload (host), the
  D0/D1 geometry substreams (push-pull fill, kernel L; motion search,
  kernel J; wavefront RDO encode, kernel I; SAO, kernel K; host entropy
  coding) and the encoder-side reconstruction with grid smoothing
  (kernels C and D),
over the GOF's hierarchical coding structure.  Recolor, the attribute
video and the mux are not ported yet (ROADMAP queue 1, slice 4).

Tools that are off by default and not ported raise NotImplementedError;
the port never computes something else in their place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev, pipeline
from vpcc_tpu_torch.core import atlas as atlas_mod
from vpcc_tpu_torch.core import packing
from vpcc_tpu_torch.core.patch import Patch, build_patch_from_component
from vpcc_tpu_torch.ops import cc as cc_mod
from vpcc_tpu_torch.ops import coverage, neighbors, voxelize
from vpcc_tpu_torch.ops import normals as normals_mod
from vpcc_tpu_torch.ops.reconstruct import Points
from vpcc_tpu_torch.ops.segmentation import (
    get_orientations,
    initial_segmentation,
    partition_to_view,
    refine_segmentation,
)
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import codecs


@dataclasses.dataclass
class EncoderStats:
    """Host-clock seconds of one frame's stages (the reference's
    `EncoderStats` fields that the ported stages fill)."""

    segmentation_s: float = 0.0
    patchgen_s: float = 0.0
    packing_s: float = 0.0     # packing + rasterization
    occupancy_s: float = 0.0   # occupancy video + block-to-patch
    video_s: float = 0.0       # occupancy payload + geometry substreams
    reconstruct_s: float = 0.0  # point reconstruction + grid smoothing
    total_s: float = 0.0
    point_count: int = 0
    patch_count: int = 0


@dataclasses.dataclass
class Segmentation:
    """What `segment_dispatch` leaves on the device for patch generation."""

    part_pt: torch.Tensor            # (N,) int32 partition per point
    part: torch.Tensor               # (V,) int32 partition per voxel
    nn_idx: torch.Tensor             # (V, K) int32 voxel k-NN
    nn_valid: torch.Tensor           # (V, K) bool
    point_vox: Optional[torch.Tensor]  # (N,) int32, None without voxels
    positions: torch.Tensor          # (N, 3) int32 source points


@dataclasses.dataclass
class FrontEndFrame:
    """One frame's front-end result: everything the video stages read."""

    patches: List[Patch]
    width: int
    height: int
    frame: atlas_mod.AtlasFrame
    occ_video: np.ndarray        # (H/precision, W/precision) uint8
    occ_rec: np.ndarray          # (H, W) uint8, the decoded occupancy
    block_to_patch: np.ndarray   # (H/res, W/res) int32
    cover_dist2: np.ndarray      # (N,) 0 where covered, inf elsewhere
    stats: EncoderStats


@dataclasses.dataclass
class GeometryFrame:
    """One frame through the geometry video: the front end's result, the
    payloads, the decoded planes and the encoder-side reconstruction."""

    front: FrontEndFrame
    occ_payload: bytes
    geo_payloads: List[bytes]    # D0, D1 geometry substream frames
    geo_dec: List[torch.Tensor]  # decoded (H, W) int32 planes on the device
    recon: Points                # reconstructed, smoothed points (device)

    @property
    def stats(self) -> EncoderStats:
        return self.front.stats


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 10: off-main-path tools)")


class Encoder:
    """`Encoder(cfg, device=None)`: the encoder front end.

    device None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch versions of the kernels."""

    def __init__(self, cfg: VPCCConfig | None = None, device=None):
        self.cfg = cfg or VPCCConfig()
        self.device = dev.resolve_device(device)
        self._height_hint = 0  # GOF height ratchet (largest height so far)
        cfg = self.cfg
        for flag, what in (
            ("highGradientSeparation", "highGradientSeparation"),
            ("enablePointCloudPartitioning", "enablePointCloudPartitioning"),
            ("globalPatchAllocation", "globalPatchAllocation"),
            ("enhancedOccupancyMapCode", "enhancedOccupancyMapCode (EOM)"),
            ("rawPointsPatch", "rawPointsPatch"),
            ("pointLocalReconstruction", "pointLocalReconstruction (PLR)"),
        ):
            if getattr(cfg, flag):
                raise _unsupported(what)
        if int(getattr(cfg, "numMaxTilePerFrame", 1)) > 1:
            raise _unsupported("numMaxTilePerFrame > 1 (multi-tile atlases)")
        if int(cfg.normalOrientation) != 1:
            raise _unsupported(f"normalOrientation={cfg.normalOrientation}")

    # ------------------------------------------------------------------
    def segment_dispatch(self, pc_host: PointCloudData) -> Segmentation:
        """Voxelize, k-NN, normals, initial + refined segmentation, all on
        the device (reference `segment_dispatch`, encoder.py:81-145).  With
        gridBasedSegmentation (reference convertPointsToVoxels,
        PCCPatchSegmenter.cpp:152) they run on the voxel cloud and the
        partitions are gathered back to points."""
        cfg = self.cfg
        d = self.device
        pos = torch.as_tensor(np.asarray(pc_host.positions, np.int32), device=d)
        bits = cfg.geometryBitDepth3D
        shift = 0
        if cfg.gridBasedSegmentation:
            shift = max(int(cfg.voxelDimensionGridBasedSegmentation).bit_length() - 1, 1)
        point_vox = None
        positions = pos
        if shift:
            point_vox, positions, _ = voxelize.voxelize(pos, shift, bits)
        grid = neighbors.build_grid(positions, bits)
        k = max(cfg.maxNNCountPatchSegmentation, cfg.nnNormalEstimation)
        # bucket=6 (18-candidate z-windows), as the reference
        nn_idx, nn_d2 = neighbors.knn(grid, positions, k=k, bucket=6)
        nn_valid = nn_d2 < neighbors.MAX_DIST2
        valid_rows = torch.ones(positions.shape[0], dtype=torch.bool, device=d)
        nrm = normals_mod.compute_normals(positions, nn_idx, nn_valid, valid_rows)
        orients = torch.as_tensor(get_orientations(cfg.additionalProjectionPlaneMode), device=d)
        nw = np.ones(orients.shape[0], np.float32)
        nw[0] = nw[3] = cfg.weightNormalX
        nw[1] = nw[4] = cfg.weightNormalY
        nw[2] = nw[5] = cfg.weightNormalZ
        part = initial_segmentation(nrm, orients, torch.as_tensor(nw, device=d))
        part = refine_segmentation(
            nrm, part, nn_idx, nn_valid, orients,
            cfg.lambdaRefineSegmentation, cfg.iterationCountRefineSegmentation,
        )
        part_pt = voxelize.gather_point_values(part, point_vox) if shift else part
        return Segmentation(part_pt, part, nn_idx, nn_valid, point_vox, pos)

    @staticmethod
    def segment_fetch(seg: Segmentation):
        """(partition per point as numpy, the device graph, N): only the
        (N,) partitions leave the device."""
        part = seg.part_pt.cpu().numpy()
        return part, seg, part.shape[0]

    def segment(self, pc_host: PointCloudData):
        """Synchronous segmentation (dispatch + fetch)."""
        return self.segment_fetch(self.segment_dispatch(pc_host))

    @staticmethod
    def with_partition(seg: Segmentation, part_vox: torch.Tensor) -> Segmentation:
        """`seg` with its voxel partition replaced (e.g. by the reference's,
        to drive patch generation with given partitions)."""
        part = part_vox.to(device=seg.part.device, dtype=torch.int32)
        part_pt = (part if seg.point_vox is None
                   else voxelize.gather_point_values(part, seg.point_vox))
        return dataclasses.replace(seg, part=part, part_pt=part_pt)

    # ------------------------------------------------------------------
    def generate_patches(self, pc_host: PointCloudData, partition: np.ndarray,
                         dev_graph: Segmentation):
        """Patch rounds (reference 'while rawPoints' loop,
        PCCPatchSegmenter.cpp:804-1320) -> (patches, cover_dist2)."""
        if self.cfg.geometryBitDepth3D > 10:
            raise _unsupported("patch generation above 10-bit geometry (k-NN coverage)")
        return self._generate_patches_volume(pc_host, partition, dev_graph)

    def _build_components(self, positions, colors, partition, comps, patches):
        cfg = self.cfg
        new_patches = []
        for comp in comps:
            view_id = partition_to_view(
                int(partition[comp[0]]), cfg.additionalProjectionPlaneMode
            )
            p = build_patch_from_component(
                len(patches) + len(new_patches), positions, colors, comp, view_id, cfg
            )
            if p is not None:
                new_patches.append(p)
        return new_patches

    def _generate_patches_volume(self, pc_host, partition, dev_graph: Segmentation):
        """Up to four rounds: connected components of the not-yet-covered
        points (kernel G; the first round labels every voxel, later rounds
        only the active ones), patches from the large components on the
        host, then coverage of the source points by the new patches'
        resampled points (kernel H, cropped to their x-slab)."""
        cfg = self.cfg
        d = self.device
        g = dev_graph
        vcap = int(g.nn_idx.shape[0])
        positions = np.asarray(pc_host.positions, np.int32)
        colors = (pc_host.colors if pc_host.colors is not None
                  else np.zeros_like(positions, np.uint8))
        n = positions.shape[0]
        bits3d = cfg.geometryBitDepth3D
        r2_sel = int(round(cfg.maxAllowedDist2RawPointsSelection))
        r2_det = int(round(cfg.maxAllowedDist2RawPointsDetection))
        r_det = int(np.floor(np.sqrt(r2_det)))
        cov_sel = torch.zeros(n, dtype=torch.bool, device=d)
        cov_det = torch.zeros(n, dtype=torch.bool, device=d)
        valid_pt = torch.ones(n, dtype=torch.bool, device=d)
        # entity = voxel when grid-based segmentation voxelized the cloud,
        # else the points themselves (identity map)
        ident = g.point_vox is None
        pvox = torch.arange(n, dtype=torch.int32, device=d) if ident else g.point_vox
        pv_host = None if ident else pvox.cpu().numpy()
        patches: List[Patch] = []
        for _round in range(4):
            if _round == 0:
                seeds = np.ones(n, bool)
                act_vox0 = torch.zeros(vcap, dtype=torch.bool, device=d)
                act_vox0[pvox.long()] = True
                lab_h = cc_mod.cc_labels_device(g.nn_idx, g.nn_valid, g.part, act_vox0).cpu().numpy()
                labels_pt = lab_h if ident else lab_h[pv_host]
            else:
                seeds_d, act_vox, n_act = cc_mod.round_stats(
                    cov_sel, cov_det, pvox, valid_pt, vcap=vcap)
                seeds = seeds_d.cpu().numpy()
                if not seeds.any() or n_act == 0:
                    break
                sub_d, lab_d = cc_mod.cc_round_voxel_compact(g.nn_idx, g.nn_valid, g.part, act_vox)
                lab_full = np.full(vcap, vcap, np.int32)
                lab_full[sub_d.cpu().numpy()] = lab_d.cpu().numpy()
                labels_pt = lab_full if ident else lab_full[pv_host]
            comps = cc_mod.components_from_labels(
                labels_pt, seeds, cfg.minPointCountPerCCPatchSegmentation, sentinel=vcap)
            if not comps:
                break
            new_patches = self._build_components(positions, colors, partition, comps, patches)
            if not new_patches:
                break
            patches.extend(new_patches)
            res_pts = [pp for p in new_patches for pp in p.generate_points()[:2]]
            res_pts = np.concatenate([r for r in res_pts if len(r)], axis=0)
            rp = torch.as_tensor(coverage.pack_coords10(res_pts, len(res_pts)), device=d)
            x0, sx = coverage.slab_params(res_pts, bits3d, r=r_det)
            s_new, d_new = coverage.covered_radius_slab(
                rp, g.positions, x0, bits3d, r2_sel, r2_det, sx)
            cov_sel |= s_new
            cov_det |= d_new
        covered_sel = cov_sel.cpu().numpy()
        return patches, np.where(covered_sel, 0.0, np.inf)

    # ------------------------------------------------------------------
    def encode_frame_front(self, pc_host: PointCloudData,
                           prev_patches: Optional[List[Patch]] = None,
                           seg: Optional[Segmentation] = None) -> FrontEndFrame:
        """The front half of the reference's `encode_frame`
        (encoder.py:464-588), through `derive_block_to_patch`, for one tile
        without GPA: segmentation (or the given `seg`), patch generation,
        temporal matching against the tree parent's `prev_patches`, packing
        under the GOF's height ratchet, rasterization, the occupancy video
        and the block-to-patch map from the decoded occupancy.  The
        occupancy codec is lossless, so the decoded occupancy is the
        upsampled occupancy video.  The port's `encode_frame` will call this
        once the video encoder is ported (ROADMAP queue 1, item 7)."""
        cfg = self.cfg
        st = EncoderStats(point_count=pc_host.point_count)
        t0 = time.perf_counter()
        if seg is None:
            seg = self.segment_dispatch(pc_host)
        partition, dev_graph, _ = self.segment_fetch(seg)
        st.segmentation_s = time.perf_counter() - t0

        t = time.perf_counter()
        patches, cover_dist2 = self.generate_patches(pc_host, partition, dev_graph)
        st.patchgen_s = time.perf_counter() - t

        t = time.perf_counter()
        if prev_patches and cfg.constrainedPack:
            packing.match_patches(patches, prev_patches)
        width, height = packing.pack_flexible(patches, cfg, preset_height=self._height_hint)
        self._height_hint = max(self._height_hint, height)
        frame = atlas_mod.rasterize_frame(patches, width, height, cfg)
        st.packing_s = time.perf_counter() - t

        t = time.perf_counter()
        occ_video = atlas_mod.downsample_occupancy(
            frame.occupancy, cfg.occupancyPrecision,
            threshold=cfg.thresholdLossyOM if cfg.offsetLossyOM or cfg.thresholdLossyOM else 0,
        )
        occ_rec = atlas_mod.upsample_occupancy(occ_video, cfg.occupancyPrecision)
        btp = atlas_mod.derive_block_to_patch(
            occ_rec, patches, width, height, cfg.occupancyResolution)
        st.occupancy_s = time.perf_counter() - t
        st.total_s = time.perf_counter() - t0
        st.patch_count = len(patches)
        return FrontEndFrame(patches, width, height, frame, occ_video, occ_rec, btp,
                             cover_dist2, st)

    def gof_structure(self, n: int) -> Tuple[List[int], List[int]]:
        """(parent, qp_offset) per frame for this GOF's coding structure
        (reference `gof_structure`, encoder.py:857-888): a dyadic hierarchy
        in each 16-frame GOP for random access, the previous-frame chain for
        low delay; frame 0 is the IRAP."""
        cfg = self.cfg
        ld = "-ld" in (cfg.geometryConfig or "") or (
            str(getattr(cfg, "extra", {}).get("gofStructure", "")) == "ld"
        )
        parent = [0] * n
        qp_off = [0] * n
        gop = 16
        for f in range(1, n):
            if ld:
                parent[f] = f - 1
                qp_off[f] = 1
                continue
            pos = f % gop
            if pos == 0:
                parent[f] = f - gop
                qp_off[f] = 1
            else:
                low = pos & -pos
                parent[f] = f - low
                qp_off[f] = min(1 + (gop // low).bit_length() - 1, 5)
        return parent, qp_off

    def encode_gof_front(self, frames: List[PointCloudData],
                         segs: Optional[List[Segmentation]] = None) -> List[FrontEndFrame]:
        """The front end over a GOF (the frame loop of the reference's
        `encode_gof`, encoder.py:913-995, without video): every P-frame
        packs against its tree parent's patch list.  `segs` optionally
        gives each frame's segmentation."""
        parent, _ = self.gof_structure(len(frames))
        out: List[FrontEndFrame] = []
        for i, f in enumerate(frames):
            prev = out[parent[i]].patches if i > 0 else None
            out.append(self.encode_frame_front(
                f, prev_patches=prev, seg=None if segs is None else segs[i]))
        return out

    # ------------------------------------------------------------------
    def _new_streams(self) -> dict:
        """The geometry substream encoders (attribute streams come with the
        attribute video, ROADMAP slice 4)."""
        return {name: codecs.GeometrySubstreamEncoder(self.cfg, self.device)
                for name in ("geo0", "geo1")}

    def encode_frame_geometry(self, pc_host: PointCloudData, streams: dict,
                              prev_patches: Optional[List[Patch]] = None,
                              seg: Optional[Segmentation] = None,
                              temporal_refs: Optional[dict] = None,
                              qp_offset_geo: int = 0) -> GeometryFrame:
        """The geometry stages of the reference's `encode_frame`
        (encoder.py:567-648, two maps, no PLR/EOM/PBF): the front end, the
        occupancy payload, D0 and D1 through their substream encoders (D1
        predicts from the decoded D0; D0 from `temporal_refs["geo"]` when
        given, None forcing intra), then the reconstruction seam with grid
        smoothing on the decoded planes."""
        cfg = self.cfg
        if cfg.pbfEnableFlag:
            raise _unsupported("PBF patch-border filtering")
        fr = self.encode_frame_front(pc_host, prev_patches=prev_patches, seg=seg)
        st = fr.stats
        t = time.perf_counter()
        occ_payload = codecs.encode_occupancy(fr.occ_video, cfg)
        geo_payloads, geo_dec = [], []
        for name, g in (("geo0", fr.frame.geometry0), ("geo1", fr.frame.geometry1)):
            kw = {}
            if temporal_refs is not None and not geo_dec:
                kw["temporal_ref"] = temporal_refs.get("geo")
            payload, dec = streams[name].encode(
                g, occ=fr.frame.occupancy, layer_ref=geo_dec[0] if geo_dec else None,
                weight=fr.occ_rec, qp_offset=qp_offset_geo, **kw)
            geo_payloads.append(payload)
            geo_dec.append(dec)
        st.video_s = time.perf_counter() - t
        t = time.perf_counter()
        recon = pipeline.reconstruct_frame(fr.occ_rec, geo_dec, fr.block_to_patch,
                                           fr.patches, cfg, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        st.reconstruct_s = time.perf_counter() - t
        st.total_s += st.video_s + st.reconstruct_s
        return GeometryFrame(fr, occ_payload, geo_payloads, geo_dec, recon)

    def encode_gof_geometry(self, frames: List[PointCloudData],
                            segs: Optional[List[Segmentation]] = None) -> List[GeometryFrame]:
        """The reference's `encode_gof` loop (encoder.py:959-1001) through
        the geometry video: each P-frame packs against its tree parent's
        patches and predicts D0 from the parent's decoded D0 (the `geo_bank`,
        pruned as the tree consumes it) under the geometry QP cascade
        min(qp_offset, geometryQpCascadeCap).  `segs` optionally gives
        each frame's segmentation."""
        cfg = self.cfg
        streams = self._new_streams()
        geo_bank: dict = {}
        parent, qp_off = self.gof_structure(len(frames))
        cap = int(getattr(cfg, "geometryQpCascadeCap", 1))
        needed = [set(parent[i + 1:]) for i in range(len(frames))]
        out: List[GeometryFrame] = []
        for i, f in enumerate(frames):
            if i == 0:
                trefs, prev = {"geo": None}, None
            else:
                trefs = {"geo": geo_bank.get(parent[i])}
                prev = out[parent[i]].front.patches
            out.append(self.encode_frame_geometry(
                f, streams, prev_patches=prev, seg=None if segs is None else segs[i],
                temporal_refs=trefs, qp_offset_geo=min(qp_off[i], cap)))
            if i in needed[i]:
                geo_bank[i] = streams["geo0"].ref
            for k in [k for k in geo_bank if k not in needed[i]]:
                del geo_bank[k]
        return out
