"""V-PCC encoder (the PCCEncoder equivalent), PyTorch port.

Behavioral reference: `PCCEncoder::encode`
(source/lib/PccLibEncoder/source/PCCEncoder.cpp:71-730) as the JAX package
implements it (vpcc_tpu/encoder.py, `encode_gof` with mesh=None).  Per
frame:
* the front end, from a source frame to the atlas frame: voxelize -> grid
  k-NN (kernel E) -> normals and segmentation (kernel F) -> patch rounds of
  connected components (kernel G) and coverage (kernel H; above 10-bit
  geometry, exact k-NN distances on kernel E) -> packing -> rasterization,
  occupancy video and block-to-patch;
* the geometry video: the occupancy payload (host), the D0/D1 geometry
  substreams (push-pull fill, kernel L; motion search, kernel J; wavefront
  RDO encode, kernel I; SAO, kernel K; host entropy coding) and the
  encoder-side reconstruction with grid smoothing (kernels C and D);
* recolor (exact match, forward blend, backward splat: kernel M over
  kernel E's sweeps; above 10 bits the exact match runs on the host and
  the sweeps cover every point) and color pre-smoothing (kernel N);
* the attribute video: paint the two layers (kernel P), the background
  fill of attributeBGFill (push-pull, kernel L; sparse dilation, kernel W;
  harmonic fill, kernel W), group dilation (kernel P), T0/T1 through
  the attribute substream encoders (kernels J, B, I, O, K), then the
  encoder-side colors gathered from the decoded layers (kernel P);
* with a reflectance attribute in the frame: the source reflectance
  transferred to the reconstructed points (kernel M's exact match, kernel
  E's nearest source), painted into two 16-bit layers (kernel P's scalar
  entries), coded intra (zlib when lossless, else 10-bit planes through
  kernels L, I, O, K) and gathered back per point;
then `_mux_gof` writes the V3C sample stream on the host, over the GOF's
hierarchical coding structure.

The CTC's lossless conditions ride the same stages: at geometryQP /
attributeQP <= 4 the substreams are coded losslessly (`video/codecs.py`);
with rawPointsPatch the source points left uncovered by the patches are
coded verbatim, in the atlas tile or, with useRawPointsSeparateVideo, in
the RAW aux geometry and attribute substreams; with
enhancedOccupancyMapCode the points between D0 and D1 are coded as EOM
codes in a second occupancy map, reconstructed by kernel C's EOM layers,
and (with the separate video) carry their transferred colors in the aux
attribute substream (kernel S).

The reconstruction tools a stream signals to the decoder ride them too:
with pbfEnableFlag the decoded occupancy's patch borders are filtered
(kernel U) before the reconstruction; with pointLocalReconstruction (and no
EOM) only D0 and T0 are coded, kernel V's RDO picks each block's PLR mode,
and the PLR layers come from kernel V's code plane through kernel C's EOM
entry; with flagColorSmoothing the decoded colors are grid-smoothed
(kernel T).  The mux writes their SEIs and ASPS fields.

Two packing options change where the patches go, not how a frame is coded:
with globalPatchAllocation (a GOF of more than one frame) every frame's
patches are generated first and the chains of matched patches get one
position for the whole GOF (`packing.pack_global`), unless that costs more
canvas than packing frame by frame; with numMaxTilePerFrame > 1 the
patches split into tiles, each packed into its own row band and written as
its own atlas tile layer, which a player can parse alone.

What the port refuses raises NotImplementedError (reflectance above 10-bit
geometry, a mesh of several cards); it never computes something else in
its place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vpcc_tpu_torch import conformance, device as dev, pipeline
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitWriter
from vpcc_tpu_torch.core import atlas as atlas_mod
from vpcc_tpu_torch.core import packing
from vpcc_tpu_torch.core.patch import Patch, build_patch_from_component
from vpcc_tpu_torch.ops import cc as cc_mod
from vpcc_tpu_torch.ops import coverage, neighbors, padding, pbf, plr, recolor, separation
from vpcc_tpu_torch.ops import voxelize
from vpcc_tpu_torch.ops import smoothing as smoothing_mod
from vpcc_tpu_torch.ops import normals as normals_mod
from vpcc_tpu_torch.ops.reconstruct import Points
from vpcc_tpu_torch.ops.segmentation import (
    get_orientations,
    high_gradient_aux,
    partition_to_view,
    segment_partitions,
)
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import aux_video, codecs


@dataclasses.dataclass
class EncoderStats:
    """Host-clock seconds of one frame's stages (the reference's
    `EncoderStats` fields that the ported stages fill)."""

    segmentation_s: float = 0.0
    patchgen_s: float = 0.0
    packing_s: float = 0.0     # packing + rasterization
    occupancy_s: float = 0.0   # occupancy video + block-to-patch
    video_s: float = 0.0       # occupancy payload + geometry substreams
                               # (+ the attribute video and download)
    reconstruct_s: float = 0.0  # point reconstruction + grid smoothing
    recolor_s: float = 0.0     # color transfer + pre-smoothing
    total_s: float = 0.0
    point_count: int = 0
    patch_count: int = 0
    compressed_bytes: int = 0  # the GOF stream's bytes / frames


@dataclasses.dataclass
class Segmentation:
    """What `segment_dispatch` leaves on the device for patch generation."""

    part_pt: torch.Tensor            # (N,) int32 partition per point
    part: torch.Tensor               # (V,) int32 partition per voxel
    nn_idx: torch.Tensor             # (V, K) int32 voxel k-NN
    nn_valid: torch.Tensor           # (V, K) bool
    point_vox: Optional[torch.Tensor]  # (N,) int32, None without voxels
    positions: torch.Tensor          # (N, 3) int32 source points
    # highGradientSeparation: the voxel normals and orientations (to redo
    # the aux for a replaced partition) and, per point, the best other
    # orientation (int32) and the weak-normal flag (bool); `hg_host` holds
    # the two on the host once `segment_fetch` has fetched them
    normals: Optional[torch.Tensor] = None
    orients: Optional[torch.Tensor] = None
    hg: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    hg_host: Optional[Tuple[np.ndarray, np.ndarray]] = None


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
    cover_dist2: np.ndarray      # (N,) float64: 0 where covered, inf elsewhere
                                 # (above 10 bits: the squared distance)
    stats: EncoderStats


@dataclasses.dataclass
class GeometryFrame:
    """One frame through the geometry video: the front end's result, the
    payloads, the decoded planes and the encoder-side reconstruction."""

    front: FrontEndFrame
    occ_payload: bytes
    geo_payloads: List[bytes]    # D0, D1 geometry substream frames (D0 alone with PLR)
    geo_dec: List[torch.Tensor]  # decoded (H, W) int32 planes on the device
    recon: Points                # reconstructed, smoothed points (device)
    eom_payload: Optional[bytes] = None  # the EOM plane's occupancy map-1 frame
    plr_modes: Optional[np.ndarray] = None  # (H/res, W/res) int32 PLR block modes
    plr_inexact: int = 0         # RDO blocks whose float32 sums would round (ops/plr.py)

    @property
    def stats(self) -> EncoderStats:
        return self.front.stats


@dataclasses.dataclass
class EncodedFrame:
    """One frame through the whole encoder (the reference's `EncodedFrame`
    on the default path), plus its device-side geometry stage and T0's
    decoded reference planes (a later P-frame's temporal reference)."""

    patches: List[Patch]
    width: int
    height: int
    occupancy_payload: bytes
    geometry_payloads: List[bytes]   # D0, D1
    attribute_payloads: List[bytes]  # T0, T1
    recon: PointCloudData            # encoder-side reconstruction
    geometry: GeometryFrame
    attr_refs: tuple                 # T0's decoded (y, cbcr) int32 planes
    raw_positions: Optional[np.ndarray] = None  # (R, 3) int32 raw-points patch
    raw_colors: Optional[np.ndarray] = None     # (R, 3) uint8
    eom_colors: Optional[np.ndarray] = None     # (M, 3) uint8 aux EOM samples
    reflectance_payload: Optional[bytes] = None  # the reflectance layers' frame

    @property
    def stats(self) -> EncoderStats:
        return self.geometry.stats


class Encoder:
    """`Encoder(cfg, device=None)`: `encode_gof(frames)` -> (V3C sample
    stream, reconstructed frames); its stages are public too
    (`encode_gof_front`, `encode_gof_geometry`, `encode_frame`).

    device None means CUDA, and raises when no card is present; pass
    device="cpu" to run the plain PyTorch versions of the kernels."""

    def __init__(self, cfg: VPCCConfig | None = None, device=None):
        self.cfg = cfg or VPCCConfig()
        self.device = dev.resolve_device(device)
        self._height_hint = 0  # GOF height ratchet (largest height so far)
        # multi-tile atlases: each tile's height ratchet and the tiles' first
        # block rows of the last packed frame (None until a frame sets them);
        # both persist across frames and GOFs, as the reference's do
        self._tile_hints: Optional[List[int]] = None
        self._tile_rows: Optional[List[int]] = None
        # which allocation the last GPA GOF kept: "gpa", "per-frame" or None
        self.last_gpa_choice: Optional[str] = None

    # ------------------------------------------------------------------
    def segment_dispatch(self, pc_host: PointCloudData) -> Segmentation:
        """Voxelize, k-NN, normals (oriented by normalOrientation, toward
        the cfg's viewPointX/Y/Z where it has them), initial + refined
        segmentation and, with highGradientSeparation, the separation's
        per-voxel aux, all on the device (reference `segment_dispatch`,
        encoder.py:81-145).  With gridBasedSegmentation (reference
        convertPointsToVoxels, PCCPatchSegmenter.cpp:152) they run on the
        voxel cloud and the per-voxel results are gathered back to
        points."""
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
        nrm = normals_mod.compute_normals(
            positions, nn_idx, nn_valid, valid_rows, mode=int(cfg.normalOrientation),
            viewpoint=tuple(float(getattr(cfg, f"viewPoint{a}", 0.0)) for a in "XYZ"))
        orients = torch.as_tensor(get_orientations(cfg.additionalProjectionPlaneMode), device=d)
        nw = np.ones(orients.shape[0], np.float32)
        nw[0] = nw[3] = cfg.weightNormalX
        nw[1] = nw[4] = cfg.weightNormalY
        nw[2] = nw[5] = cfg.weightNormalZ
        _, part = segment_partitions(
            nrm, orients, torch.as_tensor(nw, device=d), nn_idx, nn_valid,
            cfg.lambdaRefineSegmentation, cfg.iterationCountRefineSegmentation,
        )
        part_pt = voxelize.gather_point_values(part, point_vox) if shift else part
        seg = Segmentation(part_pt, part, nn_idx, nn_valid, point_vox, pos)
        if cfg.highGradientSeparation:
            seg = dataclasses.replace(seg, normals=nrm, orients=orients)
            seg = dataclasses.replace(seg, hg=self._hg_aux(seg))
        return seg

    @staticmethod
    def _hg_aux(seg: Segmentation) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per point (alt, weak) of `high_gradient_aux` on the voxel normals
        and partition (reference encoder.py:146-152)."""
        alt, weak = high_gradient_aux(seg.normals, seg.part, seg.orients)
        if seg.point_vox is None:
            return alt, weak
        return (voxelize.gather_point_values(alt, seg.point_vox),
                voxelize.gather_point_values(weak, seg.point_vox))

    @staticmethod
    def segment_fetch(seg: Segmentation):
        """(partition per point as numpy, the device graph, N): only the
        (N,) partitions (and, with highGradientSeparation, the (N,) aux)
        leave the device.  The partition is a writable copy: the separation
        rewrites it on the host, never the device partition."""
        part = np.array(seg.part_pt.cpu().numpy())
        if seg.hg is not None:
            seg = dataclasses.replace(seg, hg_host=(seg.hg[0].cpu().numpy(),
                                                    seg.hg[1].cpu().numpy()))
        return part, seg, part.shape[0]

    def segment(self, pc_host: PointCloudData):
        """Synchronous segmentation (dispatch + fetch)."""
        return self.segment_fetch(self.segment_dispatch(pc_host))

    @staticmethod
    def with_partition(seg: Segmentation, part_vox: torch.Tensor) -> Segmentation:
        """`seg` with its voxel partition replaced (e.g. by the reference's,
        to drive patch generation with given partitions); the
        high-gradient aux, where `seg` has it, is computed anew for it."""
        part = part_vox.to(device=seg.part.device, dtype=torch.int32)
        part_pt = (part if seg.point_vox is None
                   else voxelize.gather_point_values(part, seg.point_vox))
        seg = dataclasses.replace(seg, part=part, part_pt=part_pt, hg_host=None)
        if seg.hg is not None:
            seg = dataclasses.replace(seg, hg=Encoder._hg_aux(seg))
        return seg

    # ------------------------------------------------------------------
    def generate_patches(self, pc_host: PointCloudData, partition: np.ndarray,
                         dev_graph: Segmentation):
        """Patch rounds (reference 'while rawPoints' loop,
        PCCPatchSegmenter.cpp:804-1320) -> (patches, cover_dist2): bit-volume
        coverage up to 10-bit geometry, exact-distance k-NN coverage beyond
        (reference encoder.py:182-187)."""
        if self.cfg.geometryBitDepth3D <= 10:
            return self._generate_patches_volume(pc_host, partition, dev_graph)
        return self._generate_patches_knn(pc_host, partition, dev_graph)

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

    def _separate(self, comps, positions, partition, g: Segmentation):
        """With highGradientSeparation, the round's components after the
        high-gradient separation (reference encoder.py:270-275); `partition`
        takes the moved points' new orientation."""
        if not self.cfg.highGradientSeparation or g.hg_host is None:
            return comps
        comps, _ = separation.separate_high_gradient(
            comps, positions, partition, g.hg_host[0], g.hg_host[1], self.cfg)
        return comps

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
            comps = self._separate(comps, positions, partition, g)
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

    def _generate_patches_knn(self, pc_host, partition, dev_graph: Segmentation):
        """Up to four rounds with exact-distance coverage, for geometry above
        10 bits (reference encoder.py:297-368): components of the points
        still over maxAllowedDist2RawPointsSelection on the full voxel graph
        (`cc_round_voxel`, kernel G), patches from the large components on
        the host, then each source point's squared distance to the new
        patches' resampled points (kernel E's k=1 sweep on an 11-bit grid of
        them: every point in round 0, the still-uncovered ones after).
        Returns (patches, dist2 (N,) float64, inf where no resampled point
        lies in the query's cell window).  The reference pads the resampled
        points and the queries with PAD_COORD rows; such rows lie outside the
        grid and are never candidates, so the port keeps exact sizes."""
        cfg = self.cfg
        d = self.device
        g = dev_graph
        vcap = int(g.nn_idx.shape[0])
        positions = np.asarray(pc_host.positions, np.int32)
        colors = (pc_host.colors if pc_host.colors is not None
                  else np.zeros_like(positions, np.uint8))
        n = positions.shape[0]
        bits3d = cfg.geometryBitDepth3D
        dist2 = np.full(n, np.inf)
        patches: List[Patch] = []
        for _round in range(4):
            seeds = dist2 > cfg.maxAllowedDist2RawPointsDetection
            if not seeds.any():
                break
            act = torch.as_tensor(dist2 > cfg.maxAllowedDist2RawPointsSelection, device=d)
            if g.point_vox is not None:
                labels = cc_mod.cc_round_voxel(g.nn_idx, g.nn_valid, g.part, g.point_vox, act)
            else:
                labels = cc_mod.cc_labels_device(g.nn_idx, g.nn_valid, g.part, act)
            comps = cc_mod.components_from_labels(
                labels.cpu().numpy(), seeds, cfg.minPointCountPerCCPatchSegmentation,
                sentinel=vcap)
            if not comps:
                break
            comps = self._separate(comps, positions, partition, g)
            new_patches = self._build_components(positions, colors, partition, comps, patches)
            if not new_patches:
                break
            patches.extend(new_patches)
            res_pts = [pp for p in new_patches for pp in p.generate_points()[:2]]
            res_pts = np.concatenate([r for r in res_pts if len(r)], axis=0)
            rp = torch.as_tensor(np.ascontiguousarray(res_pts, np.int32), device=d)
            grid_r = neighbors.build_grid(rp, bits3d)
            if _round == 0:
                qsel = np.arange(n)
                q = g.positions
            else:
                qsel = np.nonzero(dist2 > cfg.maxAllowedDist2RawPointsSelection)[0]
                q = torch.as_tensor(positions[qsel], device=d)
            _, d2 = neighbors.nearest(grid_r, q, bucket=8)
            d2h = d2.cpu().numpy().astype(np.float64)
            d2h[d2h >= float(neighbors.MAX_DIST2)] = np.inf
            dist2[qsel] = np.minimum(dist2[qsel], d2h)
        return patches, dist2

    # ------------------------------------------------------------------
    def _roi_boxes(self, pc_host: PointCloudData):
        """ROI bounding boxes (reference `_roi_boxes`, encoder.py:370-407):
        the explicit cfg lists when given, else auto-cuts along the sorted
        longest axes (reference enablePointCloudPartitioning /
        numCutsAlong*Axis, PCCPatchSegmenter.cpp:615-780)."""
        cfg = self.cfg
        if cfg.roiBoundingBoxMinX:
            return [
                (np.array([x0, y0, z0]), np.array([x1, y1, z1]))
                for x0, x1, y0, y1, z0, z1 in zip(
                    cfg.roiBoundingBoxMinX, cfg.roiBoundingBoxMaxX,
                    cfg.roiBoundingBoxMinY, cfg.roiBoundingBoxMaxY,
                    cfg.roiBoundingBoxMinZ, cfg.roiBoundingBoxMaxZ,
                )
            ]
        pos = pc_host.positions.astype(np.int64)
        lo, hi = pos.min(0), pos.max(0)
        axes = np.argsort(-(hi - lo))  # longest first
        cuts = [max(int(cfg.numCutsAlong1stLongestAxis), 0),
                max(int(cfg.numCutsAlong2ndLongestAxis), 0),
                max(int(cfg.numCutsAlong3rdLongestAxis), 0)]
        boxes = [(lo.copy(), hi.copy())]
        for axis_rank, ncut in enumerate(cuts):
            if ncut == 0:
                continue
            ax = int(axes[axis_rank])
            nseg = ncut + 1
            edges = np.linspace(lo[ax], hi[ax] + 1, nseg + 1).astype(np.int64)
            nxt = []
            for b0, b1 in boxes:
                for k in range(nseg):
                    c0, c1 = b0.copy(), b1.copy()
                    c0[ax] = edges[k]
                    c1[ax] = edges[k + 1] - 1
                    nxt.append((c0, c1))
            boxes = nxt
        return boxes

    def _partitioned_pregen(self, pc_host: PointCloudData):
        """ROI partitioning (reference `_partitioned_pregen`,
        encoder.py:409-440): segmentation and patch generation run per ROI
        chunk on its sub-cloud (`self.segment`, `self.generate_patches`),
        patch indices are renumbered over the frame and the chunks' coverage
        distances merged into the frame's; a chunk below
        minPointCountPerCCPatchSegmentation is skipped, its points left at
        inf (the raw-points patch takes them).  Overlapping boxes duplicate
        patches, as in the reference (ROADMAP F3).  Returns (patches,
        cover_dist2)."""
        cfg = self.cfg
        pos = pc_host.positions.astype(np.int64)
        dist2 = np.full(pc_host.point_count, np.inf)
        patches: List[Patch] = []
        for b0, b1 in self._roi_boxes(pc_host):
            sel = np.nonzero(np.all((pos >= b0) & (pos <= b1), axis=1))[0]
            if len(sel) < cfg.minPointCountPerCCPatchSegmentation:
                continue
            sub = PointCloudData(
                pc_host.positions[sel],
                None if pc_host.colors is None else pc_host.colors[sel],
            )
            partition, dev_graph, _ = self.segment(sub)
            sub_patches, sub_d2 = self.generate_patches(sub, partition, dev_graph)
            for p in sub_patches:
                p.index = len(patches)
                patches.append(p)
            dist2[sel] = sub_d2
        return patches, dist2

    def encode_frame_front(self, pc_host: PointCloudData,
                           prev_patches: Optional[List[Patch]] = None,
                           seg: Optional[Segmentation] = None,
                           pregen: Optional[tuple] = None,
                           preset_size: Optional[Tuple[int, int]] = None) -> FrontEndFrame:
        """The front half of the reference's `encode_frame`
        (encoder.py:441-588), through `derive_block_to_patch`: segmentation
        (or the given `seg`), patch generation, temporal matching against
        the tree parent's `prev_patches`, packing under the GOF's height
        ratchet, rasterization, the occupancy video and the block-to-patch
        map from the decoded occupancy.  The occupancy codec is lossless, so
        the decoded occupancy is the upsampled occupancy video;
        `encode_frame_geometry` calls it.  With enablePointCloudPartitioning
        the ROI chunks are segmented and their patches generated one by one
        (`_partitioned_pregen`; `seg` must be None), and the stage split
        counts both stages as segmentation.

        `pregen` = (patches, cover_dist2, segmentation or None) skips
        segmentation and patch generation; `preset_size` = (width, height)
        skips matching and packing (GPA's two phases, `_gof_loop`).  With
        numMaxTilePerFrame > 1 each tile packs into its own row band
        (`_pack_tiles`)."""
        cfg = self.cfg
        st = EncoderStats(point_count=pc_host.point_count)
        t0 = time.perf_counter()
        if pregen is not None:
            patches, cover_dist2 = pregen[0], pregen[1]
        elif cfg.enablePointCloudPartitioning:
            if seg is not None:
                raise ValueError("enablePointCloudPartitioning segments each ROI chunk "
                                 "itself: pass no segmentation")
            patches, cover_dist2 = self._partitioned_pregen(pc_host)
            st.segmentation_s = time.perf_counter() - t0
        else:
            if seg is None:
                seg = self.segment_dispatch(pc_host)
            partition, dev_graph, _ = self.segment_fetch(seg)
            st.segmentation_s = time.perf_counter() - t0
            t = time.perf_counter()
            patches, cover_dist2 = self.generate_patches(pc_host, partition, dev_graph)
            st.patchgen_s = time.perf_counter() - t

        t = time.perf_counter()
        if preset_size is not None:
            # GPA already matched and allocated every patch
            width, height = preset_size
        elif max(int(getattr(cfg, "numMaxTilePerFrame", 1)), 1) > 1:
            width, height = self._pack_tiles(patches, prev_patches)
        else:
            for p in patches:
                p.tile_assigned = 0
            self._tile_rows = [0]
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

    def _pack_tiles(self, patches: List[Patch],
                    prev_patches: Optional[List[Patch]]) -> Tuple[int, int]:
        """Multi-tile atlas packing (reference encoder.py:504-553; tile
        placement, PCCEncoder.cpp:4837-5355): a patch matched to the tree
        parent's keeps its tile (`tile_assigned`), a new patch goes to the
        least-loaded tile (by block area); each tile packs on its own
        (`pack_flexible` under that tile's height ratchet) into a row band
        below the previous tile's.  Reorders `patches` tile-major (the coded
        order, so the encoder's rasterization overwrites as the decoder's
        merged tiles do) and sets `_tile_hints` and `_tile_rows`.  Returns
        the atlas (width, height)."""
        cfg = self.cfg
        ntiles = max(int(cfg.numMaxTilePerFrame), 1)
        if prev_patches and cfg.constrainedPack:
            packing.match_patches(patches, prev_patches)
        loads = [0] * ntiles
        for p in patches:
            tid = -1
            if prev_patches and p.ref_patch_idx >= 0:
                tid = getattr(prev_patches[p.ref_patch_idx], "tile_assigned", -1)
            if tid < 0:
                tid = loads.index(min(loads))
            p.tile_assigned = tid
            loads[tid] += p.size_u0 * p.size_v0
        res = cfg.occupancyResolution
        hints = self._tile_hints if self._tile_hints is not None else [0] * ntiles
        rows, subs = [], []
        width = row_blk = 0
        for ti in range(ntiles):
            sub = [p for p in patches if p.tile_assigned == ti]
            rows.append(row_blk)
            if sub:
                w, h = packing.pack_flexible(sub, cfg, preset_height=hints[ti])
            else:
                w, h = cfg.minimumImageWidth, 256
            hints[ti] = max(hints[ti], h)
            for p in sub:
                p.v0 += row_blk
            width = max(width, w)
            row_blk += h // res
            subs.append(sub)
        patches[:] = [p for sub in subs for p in sub]
        self._tile_hints = hints
        self._tile_rows = rows
        return width, row_blk * res

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
        """The substream encoders of a GOF: geometry D0/D1, attribute T0/T1."""
        d = self.device
        streams = {name: codecs.GeometrySubstreamEncoder(self.cfg, d) for name in ("geo0", "geo1")}
        streams.update({name: codecs.AttributeSubstreamEncoder(self.cfg, d)
                        for name in ("attr0", "attr1")})
        return streams

    def encode_frame_geometry(self, pc_host: PointCloudData, streams: dict,
                              prev_patches: Optional[List[Patch]] = None,
                              seg: Optional[Segmentation] = None,
                              temporal_refs: Optional[dict] = None,
                              qp_offset_geo: int = 0,
                              pregen: Optional[tuple] = None,
                              preset_size: Optional[Tuple[int, int]] = None) -> GeometryFrame:
        """The geometry stages of the reference's `encode_frame`
        (encoder.py:567-648): the front end, the occupancy payload and, with
        enhancedOccupancyMapCode, the EOM plane's payload, D0 and D1 through
        their substream encoders (D1 predicts from the decoded D0; D0 from
        `temporal_refs["geo"]` when given, None forcing intra; D0 alone with
        PLR), the PLR RDO (kernel V) on the decoded D0 and the true D0/D1,
        PBF on the decoded occupancy (kernel U), then the reconstruction
        seam with grid smoothing on the decoded planes, the decoded EOM
        plane or the PLR modes.  `pregen` and `preset_size` go to
        `encode_frame_front`."""
        cfg = self.cfg
        fr = self.encode_frame_front(pc_host, prev_patches=prev_patches, seg=seg,
                                     pregen=pregen, preset_size=preset_size)
        st = fr.stats
        t = time.perf_counter()
        occ_payload = codecs.encode_occupancy(fr.occ_video, cfg)
        eom_payload = eom_dec = None
        if cfg.enhancedOccupancyMapCode and fr.frame.eom is not None:
            eom_payload = codecs.encode_eom_plane(fr.frame.eom)
            eom_dec = codecs.decode_eom_plane(eom_payload)
        plr_on = self.plr_on
        geo_layers = (("geo0", fr.frame.geometry0),) if plr_on else (
            ("geo0", fr.frame.geometry0), ("geo1", fr.frame.geometry1))
        geo_payloads, geo_dec = [], []
        for name, g in geo_layers:
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
        d = self.device
        btp = fr.block_to_patch
        plr_modes, plr_inexact = None, 0
        if plr_on:
            # reference encoder.py:617-636; the patch outputs hold the
            # patch count rounded up to 64, as the reference's.  The result
            # is on the host: kernel V's one packed read
            as_t = lambda a: pipeline._as_int32(a, d).contiguous()
            r = plr.rdo(as_t(geo_dec[0]), as_t(fr.frame.geometry0), as_t(fr.frame.geometry1),
                        pipeline._as_uint8(fr.occ_rec, d), as_t(btp),
                        as_t(pipeline.plr_table(cfg)), cfg.occupancyResolution,
                        int(cfg.patchSize), ((len(fr.patches) + 63) // 64) * 64 or 64)
            plr_modes, plr_inexact = r.block_modes.numpy(), r.inexact
            plr.assign_patch_plr(fr.patches, plr_modes, btp, r.patch_level.numpy(),
                                 r.patch_modes.numpy())
        occ_for_recon = fr.occ_rec
        if cfg.pbfEnableFlag:
            # PBF replaces the upsampled occupancy on both sides (reference
            # PCCCodec.cpp:543-556), from the decoded maps
            occ_for_recon = pipeline.apply_pbf_occupancy(fr.occ_rec, geo_dec[0], btp,
                                                         fr.patches, cfg, d)
        recon = pipeline.reconstruct_frame(occ_for_recon, geo_dec, btp, fr.patches, cfg, d,
                                           eom=eom_dec, plr_modes=plr_modes)
        if d.type == "cuda":
            torch.cuda.synchronize(d)
        st.reconstruct_s = time.perf_counter() - t
        st.total_s += st.video_s + st.reconstruct_s
        return GeometryFrame(fr, occ_payload, geo_payloads, geo_dec, recon, eom_payload,
                             plr_modes, plr_inexact)

    @property
    def plr_on(self) -> bool:
        """Single-map coding with PLR (reference encoder.py:595: not with EOM)."""
        return bool(self.cfg.pointLocalReconstruction) and not self.cfg.enhancedOccupancyMapCode

    def _check_attribute_path(self, pc_host: PointCloudData) -> None:
        if pc_host.reflectances is not None and self.cfg.geometryBitDepth3D > 10:
            raise NotImplementedError(
                "the reflectance attribute above 10-bit geometry: the reference's "
                "`exact_matches_device` asserts bits <= 10 (vpcc_tpu/ops/recolor.py:48)")

    def recolor(self, src_pos: torch.Tensor, src_colors, recon: Points) -> torch.Tensor:
        """(N, 3) int32 colors of the reconstructed points (reference
        encoder.py:650-711): color transfer from the source points (kernel
        M over kernel E; up to 10 bits the compacted path, beyond it the
        host exact matching and the uncompacted blend), then, under
        flagColorPreSmoothing on a lossy attribute path, pre-smoothing of
        the boundary points (kernel N)."""
        cfg = self.cfg
        bits = cfg.geometryBitDepth3D
        sc = (torch.zeros_like(src_pos, dtype=torch.uint8) if src_colors is None else
              torch.as_tensor(np.asarray(src_colors, np.uint8), device=src_pos.device))
        kw = dict(grid_bits=bits, k=cfg.numNeighborsColorTransferFwd,
                  k_bwd=cfg.numNeighborsColorTransferBwd,
                  max_geom_d2_fwd=cfg.maxGeometryDist2Fwd,
                  max_geom_d2_bwd=cfg.maxGeometryDist2Bwd,
                  max_color_d2_fwd=cfg.maxColorDist2Fwd, dist_offset_fwd=cfg.distOffsetFwd)
        if bits <= 10:
            col, _ = recolor.transfer_colors_compact(src_pos, sc, recon.pos, **kw)
        else:
            # 33-bit keys: the reference matches exactly on the host
            ei, he = recolor.exact_matches(src_pos.cpu().numpy(), recon.pos.cpu().numpy(),
                                           src_pos.shape[0], bits)
            col = recolor.transfer_colors(
                src_pos, sc, recon.pos, torch.as_tensor(ei, device=src_pos.device),
                torch.as_tensor(he, device=src_pos.device), **kw)
        return self.presmooth(recon, col)

    def presmooth(self, recon: Points, col: torch.Tensor) -> torch.Tensor:
        """Under flagColorPreSmoothing on a lossy attribute path without raw
        points, the transferred colors with the boundary points pre-smoothed
        (kernel N; reference encoder.py:700-711); else `col` as it is."""
        cfg = self.cfg
        if cfg.flagColorPreSmoothing and cfg.attributeQP > 4 and not cfg.rawPointsPatch:
            col = smoothing_mod.presmooth_colors(
                recon.pos, col, recon.bnd, cfg.geometryBitDepth3D,
                k=int(cfg.neighborCountColorPreSmoothing),
                radius2=float(cfg.radius2ColorPreSmoothing),
                thr_dist=float(cfg.thresholdColorPreSmoothing),
                thr_entropy=float(cfg.thresholdColorPreSmoothingLocalEntropy))
        return col

    def attribute_images(self, recon: Points, colors: torch.Tensor, occupancy,
                         height: int, width: int):
        """The (H, W, 3) int32 attribute images the video codes (reference
        encoder.py:736-755): paint the colors into both layers (kernel P),
        fill every channel's background under the atlas occupancy by
        attributeBGFill (`padding.fill_rgb`), then group dilation (kernel
        P).  With PLR only T0 is coded: layer 0 alone is filled, and not
        dilated."""
        occ = torch.as_tensor(np.ascontiguousarray(occupancy, np.uint8), device=self.device)
        planes = pipeline.paint_attribute(recon.pix, recon.layer, colors, height, width)
        mode = int(self.cfg.attributeBGFill)
        if self.plr_on:
            return (padding.fill_rgb(planes[:1], occ, mode)[0].permute(1, 2, 0).contiguous(),)
        planes = padding.fill_rgb(planes, occ, mode)
        if self.cfg.groupDilation:
            return pipeline.group_dilate(planes, occ)
        return tuple(p.permute(1, 2, 0).contiguous() for p in planes)

    def encode_frame(self, pc_host: PointCloudData, streams: dict,
                     prev_patches: Optional[List[Patch]] = None,
                     seg: Optional[Segmentation] = None,
                     temporal_refs: Optional[dict] = None,
                     qp_offset: int = 0,
                     qp_offset_geo: Optional[int] = None,
                     pregen: Optional[tuple] = None,
                     preset_size: Optional[Tuple[int, int]] = None) -> EncodedFrame:
        """The reference's `encode_frame` (encoder.py:442-846): the geometry
        stages (`encode_frame_geometry`), the raw-points patch (the source
        points whose coverage distance exceeds
        maxAllowedDist2RawPointsSelection), recolor and pre-smoothing, the
        EOM rows' colors for the aux substream, the attribute images, T0 and
        T1 (T1 predicted from the decoded T0; T0 from
        `temporal_refs["attr"]` when given, None forcing intra; QP cascade
        `qp_offset`, uncapped; T0 alone with PLR), the decoded colors of the
        points (the EOM rows' from the aux samples), color smoothing (kernel
        T), with a reflectance attribute its transfer, layers, payload and
        decoded values (reference :779-803), and the duplicate-free
        encoder-side reconstruction, raw points appended before the
        duplicate removal (their reflectance 0).  `pregen` and `preset_size`
        go to `encode_frame_front`; the recolor's source positions are then
        those of pregen's segmentation, when it has one."""
        cfg = self.cfg
        self._check_attribute_path(pc_host)
        if qp_offset_geo is None:
            qp_offset_geo = qp_offset
        t0 = time.perf_counter()
        if pregen is not None:
            seg = pregen[2]
        elif seg is None and not cfg.enablePointCloudPartitioning:
            seg = self.segment_dispatch(pc_host)
        src_pos = seg.positions if seg is not None else torch.as_tensor(
            np.asarray(pc_host.positions, np.int32), device=self.device)
        t_seg = time.perf_counter() - t0
        g = self.encode_frame_geometry(pc_host, streams, prev_patches=prev_patches, seg=seg,
                                       temporal_refs=temporal_refs, qp_offset_geo=qp_offset_geo,
                                       pregen=pregen, preset_size=preset_size)
        st = g.stats
        st.segmentation_s += t_seg
        fr = g.front
        raw_positions = raw_colors = None
        if cfg.rawPointsPatch:
            raw_sel = np.nonzero(fr.cover_dist2 > cfg.maxAllowedDist2RawPointsSelection)[0]
            if len(raw_sel):
                raw_positions = pc_host.positions[raw_sel].astype(np.int32)
                if pc_host.colors is not None:
                    raw_colors = pc_host.colors[raw_sel]

        t = time.perf_counter()
        col = self.recolor(src_pos, pc_host.colors, g.recon)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        st.recolor_s = time.perf_counter() - t
        # the EOM rows carry their transferred colors in the aux attribute
        # substream (reference eomTexturePatch, PCCEncoder.cpp:4380-4665)
        eom_colors = None
        if cfg.enhancedOccupancyMapCode and cfg.useRawPointsSeparateVideo \
                and g.eom_payload is not None:
            ec = pipeline.extract_eom_colors(g.recon.layer, col)
            if ec.shape[0]:
                eom_colors = ec.cpu().numpy().astype(np.uint8)

        t = time.perf_counter()
        imgs = self.attribute_images(g.recon, col, fr.frame.occupancy, fr.height, fr.width)
        payloads, dec = [], []
        for ly, img in enumerate(imgs):
            kw = {}
            if temporal_refs is not None and not dec:
                kw["temporal_ref"] = temporal_refs.get("attr")
            payload, rgb = streams[f"attr{ly}"].encode(
                img, layer_ref=dec[0] if dec else None, weight=fr.occ_rec,
                qp_offset=qp_offset, **kw)
            payloads.append(payload)
            dec.append(rgb)
        col_dec = pipeline.gather_decoded_colors(g.recon.pix, g.recon.layer, dec[0], dec[-1])
        if eom_colors is not None:
            col_dec = pipeline.inject_eom_colors(
                g.recon.layer, col_dec, torch.as_tensor(eom_colors, device=self.device))
        col_dec = pipeline.apply_color_smoothing_device(g.recon, col_dec, cfg)
        refl_payload = refl_dec = None
        if pc_host.reflectances is not None:
            src_refl = torch.as_tensor(np.asarray(pc_host.reflectances).astype(np.int32),
                                       device=self.device)
            refl = recolor.transfer_reflectance(src_pos, src_refl, g.recon.pos,
                                                grid_bits=cfg.geometryBitDepth3D)
            layers = pipeline.paint_scalar(g.recon.pix, g.recon.layer, refl, fr.height,
                                           fr.width)
            refl_payload, r0d, r1d = codecs.encode_reflectance(
                layers[0], layers[1], fr.frame.occupancy, cfg, qp_offset=qp_offset)
            refl_dec = pipeline.gather_decoded_scalar(g.recon.pix, g.recon.layer, r0d, r1d)
        raw = None
        if raw_positions is not None:
            raw = (raw_positions, raw_colors if raw_colors is not None
                   else np.zeros_like(raw_positions, np.uint8))
        pos, col8, rec_refl = pipeline.download_recon(
            g.recon, col_dec, cfg.geometryBitDepth3D,
            remove_duplicates=bool(cfg.removeDuplicatePoints), raw=raw, refl=refl_dec)
        st.video_s += time.perf_counter() - t
        st.total_s += t_seg + st.recolor_s + time.perf_counter() - t
        return EncodedFrame(fr.patches, fr.width, fr.height, g.occ_payload, g.geo_payloads,
                            payloads, PointCloudData(pos, col8, reflectances=rec_refl), g,
                            streams["attr0"].refs, raw_positions, raw_colors, eom_colors,
                            refl_payload)

    def _gof_loop(self, frames, segs, attributes: bool):
        """The reference's `encode_gof` frame loop (encoder.py:913-1001):
        each P-frame packs against its tree parent's patches and predicts
        D0 (and T0) from the parent's decoded planes, kept in banks that are
        pruned as the tree consumes them; the geometry QP cascade is capped
        at geometryQpCascadeCap, the attribute cascade is not.  Under
        globalPatchAllocation with more than one frame, `_gpa_phases`
        first generates and allocates every frame's patches.  Returns
        (per-frame results, tree parents, whether GPA's phases ran)."""
        cfg = self.cfg
        streams = self._new_streams()
        geo_bank: dict = {}
        attr_bank: dict = {}
        parent, qp_off = self.gof_structure(len(frames))
        cap = int(getattr(cfg, "geometryQpCascadeCap", 1))
        needed = [set(parent[i + 1:]) for i in range(len(frames))]
        gpa = bool(cfg.globalPatchAllocation) and len(frames) > 1
        pregen, gpa_size, phase_s = (self._gpa_phases(frames, segs, parent) if gpa
                                     else (None, None, None))
        out = []
        for i, f in enumerate(frames):
            if i == 0:
                trefs, prev = {"geo": None, "attr": None}, None
            else:
                trefs = {"geo": geo_bank.get(parent[i]), "attr": attr_bank.get(parent[i])}
                prev = out[parent[i]].patches if attributes else out[parent[i]].front.patches
            kw = dict(prev_patches=prev, seg=None if segs is None else segs[i],
                      temporal_refs=trefs, qp_offset_geo=min(qp_off[i], cap),
                      pregen=None if pregen is None else pregen[i], preset_size=gpa_size)
            if attributes:
                e = self.encode_frame(f, streams, qp_offset=qp_off[i], **kw)
            else:
                e = self.encode_frame_geometry(f, streams, **kw)
            if phase_s is not None:
                # phase A's segmentation and patch generation of this frame
                st = e.stats
                st.segmentation_s += phase_s[i][0]
                st.patchgen_s += phase_s[i][1]
                st.total_s += sum(phase_s[i])
            out.append(e)
            if i in needed[i]:
                geo_bank[i] = streams["geo0"].ref
                attr_bank[i] = streams["attr0"].refs
            for bank in (geo_bank, attr_bank):
                for k in [k for k in bank if k not in needed[i]]:
                    del bank[k]
        return out, parent, gpa

    def _gpa_phases(self, frames, segs, parent):
        """GPA's two phases (reference `encode_gof`, encoder.py:913-958;
        performDataAdaptiveGPAMethod, PCCEncoder.cpp:6821-7651).  Phase A
        segments every frame (or takes `segs[i]`; ROI partitioning is not
        applied here, as in the reference), generates its patches, matches
        them against the tree parent's and packs them frame by frame under
        the running height: the per-frame allocation.  Phase B allocates
        the tree-linked chains globally (`packing.pack_global`).  The
        data-adaptive choice keeps GPA's positions unless its canvas area
        exceeds the per-frame maximum's, else restores the per-frame
        allocation and size (`last_gpa_choice` says which).  Returns (per
        frame (patches, cover_dist2, segmentation), the GOF's (width,
        height), per frame phase A's (segmentation, patch generation)
        seconds)."""
        cfg = self.cfg
        hint = self._height_hint
        pregen, all_patches, phase_s = [], [], []
        pf_w = pf_h = 0
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            seg = self.segment_dispatch(f) if segs is None else segs[i]
            partition, dev_graph, _ = self.segment_fetch(seg)
            t1 = time.perf_counter()
            patches, dist2 = self.generate_patches(f, partition, dev_graph)
            if i > 0 and cfg.constrainedPack:
                packing.match_patches(patches, all_patches[parent[i]])
            w, h = packing.pack_flexible(patches, cfg, preset_height=max(hint, pf_h))
            pf_w, pf_h = max(pf_w, w), max(pf_h, h)
            pregen.append((patches, dist2, seg))
            all_patches.append(patches)
            phase_s.append((t1 - t0, time.perf_counter() - t1))
        pf_assign = [[(p.u0, p.v0, p.orientation) for p in ps] for ps in all_patches]
        size = packing.pack_global(all_patches, cfg, parents=parent, preset_height=hint)
        self.last_gpa_choice = "gpa"
        if size[0] * size[1] > pf_w * pf_h:
            for ps, assign in zip(all_patches, pf_assign):
                for p, (u0, v0, o) in zip(ps, assign):
                    p.u0, p.v0, p.orientation = u0, v0, o
            size = (pf_w, pf_h)
            self.last_gpa_choice = "per-frame"
        return pregen, size, phase_s

    def encode_gof_geometry(self, frames: List[PointCloudData],
                            segs: Optional[List[Segmentation]] = None) -> List[GeometryFrame]:
        """The GOF through the geometry video (`_gof_loop` without the
        attribute stages).  `segs` optionally gives each frame's
        segmentation."""
        return self._gof_loop(frames, segs, attributes=False)[0]

    def encode_gof(self, frames: List[PointCloudData], mesh=None, parallel: bool = False,
                   segs: Optional[List[Segmentation]] = None
                   ) -> Tuple[bytes, List[PointCloudData]]:
        """Encode a group of frames into one V3C sample stream (reference
        `encode_gof`, encoder.py:890-1002): (stream bytes, the encoder-side
        reconstruction of every frame).  `segs` optionally gives each
        frame's segmentation (e.g. with the reference's partitions,
        `with_partition`).

        parallel=True, or `mesh` a sequence of one torch.device (the
        encoder's), runs the level-batched path (`parallel/gof.py`
        `encode_gof_mesh`): every video dispatch and recolor sweep batches
        the frames of one hierarchy level, and the stream is byte-identical
        to the sequential one.  Options outside the reference's envelope for
        it (GPA and multi-tile atlases among them) raise
        NotImplementedError, as does a mesh of several cards."""
        if mesh is not None:
            devices = [torch.device(m) for m in mesh]
            if len(devices) > 1:
                raise NotImplementedError(
                    "a mesh of several cards: sharding the levels across cards is not "
                    "ported (ROADMAP queue 1); pass one device or parallel=True")
            same = lambda a, b: a.type == b.type and (a.index or 0) == (b.index or 0)
            if devices and not same(devices[0], self.device):
                raise ValueError(f"mesh device {devices[0]} is not the encoder's device "
                                 f"{self.device}")
            parallel = True
        if parallel:
            from vpcc_tpu_torch.parallel.gof import encode_gof_mesh
            return encode_gof_mesh(self, frames, segs=segs)
        encoded, parent, gpa = self._gof_loop(frames, segs, attributes=True)
        self.stats = [e.stats for e in encoded]
        return self._mux_gof(encoded, frames, parent, gpa=gpa)

    def _mux_gof(self, encoded: List[EncodedFrame], frames, parent, gpa: bool = False):
        """Assemble the V3C sample stream (reference `_mux_gof`,
        encoder.py:1004-1261; one map with PLR):
        VPS, the atlas substream (ASPS with its PLR fields, AFPS with the
        tile count, the prefix SEIs (geometry and attribute smoothing,
        occupancy synthesis), one atlas tile layer per frame and tile, each
        with its hash SEI: a tile's patches are those with its
        `tile_assigned`, its P-tiles predict from the same tile of the tree
        parent, its `tile_row_start` is the encoder's `_tile_rows` after the
        last frame (the reference's, for every frame); the raw points in
        tile 0 unless useRawPointsSeparateVideo; one tile under `gpa`),
        then the occupancy (map 1: the EOM planes), geometry and attribute
        video substreams, the reflectance attribute's substream (map index
        REFL_MAP_INDEX) when the frames carry one and, with
        useRawPointsSeparateVideo, the RAW/EOM aux geometry and attribute
        substreams.  Fills `last_stream_stats` and each frame's
        `compressed_bytes`."""
        cfg = self.cfg
        width = max(e.width for e in encoded)
        height = max(e.height for e in encoded)
        n_geo_maps = len(encoded[0].geometry_payloads)
        n_attr_maps = len(encoded[0].attribute_payloads)
        plr_on = n_geo_maps == 1
        map_count_minus1 = 0 if plr_on else cfg.mapCountMinus1
        max_pts = max(e.recon.point_count for e in encoded)
        max_patches = max(len(e.patches) for e in encoded)
        level = next(
            (lv for lv, (mp, mpa, mat) in sorted(conformance.LEVEL_LIMITS.items())
             if max_pts <= mp and max_patches <= mpa and width * height <= mat),
            max(conformance.LEVEL_LIMITS),
        )
        vps = v3c.V3CParameterSet(
            ptl=v3c.ProfileTierLevel(level_idc=level),
            frame_width=width, frame_height=height,
            eom_bits=max(cfg.surfaceThickness - 1, 0) if cfg.enhancedOccupancyMapCode else 0,
            frame_count=len(frames),
            occupancy_resolution=cfg.occupancyResolution,
            occupancy_precision=cfg.occupancyPrecision,
            geometry_2d_bitdepth=cfg.geometryBitDepth2D,
            geometry_3d_bitdepth=cfg.geometryBitDepth3D,
            map_count_minus1=map_count_minus1, min_level=cfg.minLevel,
        )
        bw = BitWriter()
        vps.write(bw)
        units = [(v3c.V3C_VPS, bw.getvalue())]

        ntiles = 1 if gpa else max(int(getattr(cfg, "numMaxTilePerFrame", 1)), 1)
        tile_rows = self._tile_rows if self._tile_rows is not None else [0] * ntiles
        in_tile = not cfg.useRawPointsSeparateVideo
        tiles = []
        groups_list, pdus_list = [], []  # per frame, per tile: patches, PDUs
        for fi, e in enumerate(encoded):
            groups = [[] for _ in range(ntiles)]
            for p in e.patches:
                groups[getattr(p, "tile_assigned", 0)].append(p)
            frame_pdus = []
            for ti in range(ntiles):
                pdus = [_patch_to_pdu(p, cfg) for p in groups[ti]]
                if fi > 0:
                    # ref indices address the same tile of the tree parent
                    idx_in_tile = {id(q): k for k, q in enumerate(groups_list[parent[fi]][ti])}
                    parent_full = encoded[parent[fi]].patches
                    for p, pdu in zip(groups[ti], pdus):
                        pdu.ref_index = -1
                        if 0 <= p.ref_patch_idx < len(parent_full):
                            pdu.ref_index = idx_in_tile.get(id(parent_full[p.ref_patch_idx]), -1)
                raw = in_tile and ti == 0
                tiles.append(v3c.AtlasTileLayer(
                    frame_index=fi, tile_id=ti,
                    tile_row_start=tile_rows[ti] if ti < len(tile_rows) else 0, patches=pdus,
                    raw_positions=e.raw_positions if raw else None,
                    raw_colors=e.raw_colors if raw else None,
                    geometry_bits=cfg.geometryBitDepth3D,
                    tile_type=v3c.TILE_I if fi == 0 else v3c.TILE_P,
                    ref_patches=None if fi == 0 else pdus_list[parent[fi]][ti],
                    ref_frame_delta=max(fi - parent[fi], 1),
                ))
                frame_pdus.append(pdus)
            groups_list.append(groups)
            pdus_list.append(frame_pdus)
        asps = v3c.AtlasSequenceParameterSet(
            frame_width=width, frame_height=height,
            log2_patch_packing_block_size=cfg.occupancyResolution.bit_length() - 1,
            geometry_3d_bitdepth_minus1=cfg.geometryBitDepth3D - 1,
            geometry_2d_bitdepth_minus1=cfg.geometryBitDepth2D - 1,
            map_count_minus1=map_count_minus1, plr_enabled_flag=1 if plr_on else 0,
            plr_num_modes=len(pipeline.plr_table(cfg)), plr_block_threshold=int(cfg.patchSize),
            plr_mode_table=pipeline.plr_table(cfg),
        )
        afps = v3c.AtlasFrameParameterSet(num_tiles_minus1=ntiles - 1)
        prefix_seis = []
        if cfg.flagGeometrySmoothing and cfg.gridSmoothing:
            prefix_seis.append(v3c.SEIGeometrySmoothing(
                grid_size=cfg.gridSize, threshold=int(cfg.thresholdSmoothing)))
        if cfg.flagColorSmoothing:
            prefix_seis.append(v3c.SEIAttributeSmoothing(
                grid_size=cfg.cgridSize, threshold=int(cfg.thresholdColorSmoothing),
                threshold_variation=int(cfg.thresholdColorVariation),
                threshold_difference=int(cfg.thresholdColorDifference)))
        if cfg.pbfEnableFlag:
            prefix_seis.append(v3c.SEIOccupancySynthesis(
                passes_count=pbf.pbf_passes(cfg), filter_size=pbf.pbf_filter_size(cfg),
                log2_threshold=cfg.pbfLog2Threshold))
        prefix_seis.append(v3c.SEIComponentCodecMapping())
        prefix_seis.append(v3c.SEIBufferingPeriod(initial_delay=90000 // 30))
        prefix_seis.append(v3c.SEIAtlasFrameTiming())
        prefix_seis.append(v3c.SEIRecoveryPoint(recovery_afoc=0))
        prefix_seis.append(v3c.SEIActiveSubBitstreams(
            active_attributes=list(range(n_attr_maps))
            + ([1] if encoded[0].reflectance_payload is not None else []),
            active_maps=list(range(n_geo_maps)),
            raw_points_active_flag=1 if cfg.rawPointsPatch else 0))
        rp = encoded[0].recon.positions
        if len(rp):
            lo3 = np.asarray(rp).min(0).astype(np.int64)
            hi3 = np.asarray(rp).max(0).astype(np.int64)
            prefix_seis.append(v3c.SEISceneObjectInformation(objects=[
                (0, tuple(int(v) for v in np.concatenate([lo3, hi3 - lo3 + 1])))]))
            prefix_seis.append(v3c.SEIObjectLabelInformation(labels=[(0, "pointcloud")]))
        res = cfg.occupancyResolution
        with_p = [e for e in encoded if e.patches]
        x0 = min(min(p.u0 for p in e.patches) for e in with_p)
        y0 = min(min(p.v0 for p in e.patches) for e in with_p)
        x1 = max(max(p.u0 + p.size_u0 for p in e.patches) for e in with_p)
        y1 = max(max(p.v0 + p.size_v0 for p in e.patches) for e in with_p)
        prefix_seis.append(v3c.SEIVolumetricRectangleInformation(
            rectangles=[(0, x0 * res, y0 * res, (x1 - x0) * res, (y1 - y0) * res)]))
        scale, offset = float(getattr(cfg, "attributeScale", 1.0)), float(
            getattr(cfg, "attributeOffset", 0.0))
        if scale != 1.0 or offset != 0.0:
            q16, off = int(round(scale * 65536)), int(round(offset))
            prefix_seis.append(v3c.SEIAttributeTransformationParams(
                params=[(0, dim, q16, off) for dim in range(3)]))
        units.append((v3c.V3C_AD, v3c.write_atlas_substream(
            tiles, asps, afps, prefix_seis=prefix_seis, aaps=v3c.AtlasAdaptationParameterSet())))
        ovd_lists = [[e.occupancy_payload for e in encoded]]
        if cfg.enhancedOccupancyMapCode and encoded[0].geometry.eom_payload is not None:
            ovd_lists.append([e.geometry.eom_payload or b"" for e in encoded])
        for unit_type, payload_lists in (
            (v3c.V3C_OVD, ovd_lists),
            (v3c.V3C_GVD, [[e.geometry_payloads[m] for e in encoded] for m in range(n_geo_maps)]),
            (v3c.V3C_AVD, [[e.attribute_payloads[m] for e in encoded]
                           for m in range(n_attr_maps)]),
        ):
            for mi, plist in enumerate(payload_lists):
                bw = BitWriter()
                v3c.VideoSubstream(unit_type, mi, plist).write(bw)
                units.append((unit_type, bw.getvalue()))
        if encoded[0].reflectance_payload is not None:
            bw = BitWriter()
            v3c.VideoSubstream(v3c.V3C_AVD, codecs.REFL_MAP_INDEX,
                               [e.reflectance_payload or b"" for e in encoded]).write(bw)
            units.append((v3c.V3C_AVD, bw.getvalue()))
        if cfg.useRawPointsSeparateVideo:
            for unit_type, plist in (
                (v3c.V3C_GVD, [aux_video.pack_raw_geometry(e.raw_positions) for e in encoded]),
                (v3c.V3C_AVD, [aux_video.pack_aux_attribute(e.raw_colors, e.eom_colors)
                               for e in encoded]),
            ):
                bw = BitWriter()
                v3c.VideoSubstream(unit_type, aux_video.AUX_MAP_INDEX, plist).write(bw)
                units.append((unit_type, bw.getvalue()))
        stream = v3c.write_sample_stream(units)
        names = {v3c.V3C_VPS: "VPS", v3c.V3C_AD: "AD", v3c.V3C_OVD: "OVD",
                 v3c.V3C_GVD: "GVD", v3c.V3C_AVD: "AVD"}
        comp: Dict[str, int] = {}
        for utype, payload in units:
            key = names.get(utype, str(utype))
            comp[key] = comp.get(key, 0) + len(payload)
        comp["total"] = len(stream)
        self.last_stream_stats = comp
        for e in encoded:
            e.stats.compressed_bytes = len(stream) // len(frames)
        self.last_encoded = encoded
        return stream, [e.recon for e in encoded]


def _patch_to_pdu(p: Patch, cfg: VPCCConfig) -> v3c.PatchDataUnit:
    """A patch's atlas syntax (reference `_patch_to_pdu`, encoder.py:1262)."""
    quant_dd = 0 if p.size_d == 0 else (p.size_d + 1) // cfg.minLevel
    return v3c.PatchDataUnit(
        pos_x=p.u0, pos_y=p.v0, size_x_m1=p.size_u0 - 1, size_y_m1=p.size_v0 - 1,
        offset_u=p.u1, offset_v=p.v1, offset_d=p.d1 // cfg.minLevel, range_d=quant_dd,
        projection_id=p.view_id, orientation=p.orientation, size_u=p.size_u,
        size_v=p.size_v, ref_index=p.ref_patch_idx, plr_level=p.plr_level,
        plr_mode=p.plr_mode, plr_block_modes=p.plr_block_modes, lod_x=p.lod_x,
        lod_y=p.lod_y,
    )
