"""Level-batched GOF encoding (the port of vpcc_tpu/parallel/gof.py).

The GOF's coding structure (`Encoder.gof_structure`) is a dyadic
hierarchy: the frames of one tree level depend only on their parents'
DECODED maps, so a level's frames can go through each device program
together.  `encode_gof_mesh` runs the host stages (segmentation, patches,
packing, occupancy coding, entropy coding, mux) per frame exactly as the
sequential `Encoder.encode_gof` does, and batches, per level:
* the geometry D0 and D1 planes and the attribute T0 and T1 luma and
  chroma planes of the level's frames, each in one
  `hevc.encode_planes_dispatch` over a plane stack with per-plane QPs,
  references, occupancies and RD weights (kernels L, J, B, I, O, K), each
  frame's payload cut out by `Coded.payload` (the sequential path's
  `assemble_payload32`): the reference's `_encode_level_planes` and
  `_slice_payload`;
* the recolor: kernel M's exact match over every frame, kernel E's forward
  k-NN and backward nearest sweeps over every frame (one grid per frame,
  built in one sort), kernel M's blend, splat and merge over every frame
  (`recolor_level`).
The reconstruction, pre-smoothing, painting and background fill stay per
frame.  The stream is byte-identical to the sequential path's, as the
reference asserts for its own (tests/test_parallel.py).

On one card the whole level runs on the encoder's device; sharding the
levels across several cards is not ported (ROADMAP).  The reference's
`run_gof_dryrun` (a driver validation, not an encoder path) is left out;
`encode_level_geo` and `_recon_batch`, which only it calls, are thin ports
here.
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vpcc_tpu_torch import pipeline
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.core.pointcloud import shape_bucket
from vpcc_tpu_torch.ops import neighbors, recolor, reconstruct
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import codecs, hevc

PAD = -(1 << 20)   # the reference's padding coordinate for level batches


def level_schedule(parent: List[int]) -> List[List[int]]:
    """Group frames into dependency levels (reference gof.py:39): every
    frame appears after its parent's level; frames inside one level are
    independent."""
    n = len(parent)
    level = [0] * n
    for f in range(1, n):
        level[f] = level[parent[f]] + 1
    out: List[List[int]] = [[] for _ in range(max(level) + 1)] if n else []
    for f in range(n):
        out[level[f]].append(f)
    return out


def level_groups(levels: List[List[int]], parent: List[int], shapes: Sequence[Tuple[int, int]]):
    """[(level, (h, w, ref_ok), frames)] in coding order (reference
    gof.py:564-584): one dispatch needs one atlas shape, and a frame whose
    parent's shape differs is coded intra, as the sequential codec's shape
    gate does, so each level splits into sorted (shape, parent shape
    matches) subgroups."""
    groups = []
    for lv, frames in enumerate(levels):
        sub: dict = {}
        for f in frames:
            h, w = shapes[f]
            ref_ok = lv > 0 and tuple(shapes[parent[f]]) == (h, w)
            sub.setdefault((h, w, ref_ok), []).append(f)
        for key in sorted(sub):
            groups.append((lv, key, sub[key]))
    return groups


def encode_level_geo(geo_b, occ_b, weight_b, refs_b, qps, maxval: int,
                     motion: Optional[bool] = None):
    """One level's geometry maps through the encoder production uses
    (reference gof.py:58): the 32/16/8 one, or the 16/8 one where maxval is
    above 1023 (or `hevc.ENABLE_CU32` is off).  (B, H, W) maps,
    occupancies and RD weights, the parents' decoded maps (None: intra),
    per-plane QPs.  Returns the syntax arrays ((s32, m32, c32, s16, modes,
    c16) or (split, modes, coeffs), then mvs, sao_cls, sao_off) with the
    (B, H, W) reconstruction last."""
    has_ref = refs_b is not None
    c = hevc.encode_planes_dispatch(geo_b, list(qps), [maxval] * geo_b.shape[0], refs=refs_b,
                                    occ=occ_b, deblock=False, weight=weight_b,
                                    motion=has_ref if motion is None else motion)
    return (*c.syntax.values(), c.rec)


def _recon_batch(occ_b, g0_b, g1_b, btp_b, patch_tables, res: int):
    """Reconstruction phase 1 of a level's frames (reference gof.py:184,
    `pipeline._recon_phase1` vmapped): kernel C frame by frame.  Returns
    ([Points per frame], (B,) int32 point counts)."""
    pts = [reconstruct.generate_points(occ_b[b], g0_b[b], g1_b[b], btp_b[b], patch_tables[b], res)
           for b in range(occ_b.shape[0])]
    cnt = torch.tensor([p.pos.shape[0] for p in pts], dtype=torch.int32)
    return pts, cnt


def recolor_level(src_pos_b, src_col_b, src_cnt_b, tgt_pos_b, tgt_cnt_b, bits: int,
                  k: int = 8, gates: Tuple[float, float, float, float] = (1000.0, 1000.0, 1000.0,
                                                                        4.0)):
    """Level-batched attribute transfer (reference gof.py:155): (B, Nt, 3)
    int32 colors of the padded targets, each frame's equal to the
    sequential `transfer_colors_compact`'s.  src_pos_b (B, Ns, 3) int32 and
    tgt_pos_b (B, Nt, 3) int32 are padded with rows out of the grid (the
    reference pads at -2^20), src_col_b (B, Ns, 3) the source colors,
    src_cnt_b (B,) the source counts (rows past them never match or
    splat); tgt_cnt_b is not read, as in the reference.  gates =
    (maxGeometryDist2Fwd, maxGeometryDist2Bwd, maxColorDist2Fwd,
    distOffsetFwd).  Kernel M's batched exact match, kernel E's batched
    sweeps (bucket 6), kernel M's batched blend."""
    if bits > 10:
        raise NotImplementedError(
            "the level-batched recolor above 10-bit geometry: the reference's "
            "`exact_matches_device` asserts bits <= 10 (vpcc_tpu/ops/recolor.py:48)")
    gd2_fwd, gd2_bwd, cd2, doff = (float(g) for g in gates)
    d = src_pos_b.device
    src_cnt = torch.as_tensor(src_cnt_b, device=d).to(torch.int64).reshape(-1)
    order, sk = recolor.sorted_source_keys_batch(src_pos_b, src_cnt, bits)
    eidx, has, matched = recolor.exact_match_batch(order, sk, tgt_pos_b, bits)
    idx, d2 = neighbors.knn_batch(neighbors.build_grid_batch(src_pos_b, bits), tgt_pos_b, k=k,
                                  bucket=6)
    tidx, td2 = neighbors.knn_batch(neighbors.build_grid_batch(tgt_pos_b, bits), src_pos_b, k=1,
                                    bucket=6)
    ns = src_pos_b.shape[1]
    drop = matched | (torch.arange(ns, device=d)[None, :] >= src_cnt[:, None])
    td2 = torch.where(drop, torch.full_like(td2[..., 0], recolor.MAX_DIST2), td2[..., 0])
    return recolor.blend_batch(src_col_b.to(torch.uint8).contiguous(), idx, d2,
                               tidx[..., 0].contiguous(), td2.contiguous(), eidx, has,
                               gd2_fwd, cd2, doff, gd2_bwd)


def struct_pack_ii(py: bytes, pc: bytes) -> bytes:
    """The attribute frame's luma and chroma payloads with their lengths
    (reference gof.py:826)."""
    return struct.pack("<II", len(py), len(pc)) + py + pc


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the level-batched GOF path with {what} is not supported (the reference's "
        "envelope, vpcc_tpu/parallel/gof.py:509-514); use parallel=False")


def check_envelope(cfg) -> None:
    """The reference's envelope asserts (gof.py:509-514) as refusals, and
    what its level path would not code as its sequential path does (lossless
    video)."""
    checks = (
        (cfg.enhancedOccupancyMapCode, "enhancedOccupancyMapCode (EOM)"),
        (cfg.pointLocalReconstruction, "pointLocalReconstruction (PLR)"),
        (int(getattr(cfg, "numMaxTilePerFrame", 1)) > 1,
         "numMaxTilePerFrame > 1 (multi-tile atlases)"),
        (cfg.globalPatchAllocation, "globalPatchAllocation (GPA)"),
        (cfg.enablePointCloudPartitioning, "enablePointCloudPartitioning"),
        (cfg.useRawPointsSeparateVideo, "useRawPointsSeparateVideo"),
        (cfg.numNeighborsColorTransferBwd <= 0, "numNeighborsColorTransferBwd == 0"),
        (cfg.geometryBitDepth3D > 10, "geometry above 10 bits (the batched exact match "
         "packs int32 keys; vpcc_tpu/ops/recolor.py:48)"),
        (cfg.geometryBitDepth2D > 10, "2D geometry above 10 bits (geometryNominal2dBitdepth; "
         "the level path's planes take the 32/16/8 codec only, vpcc_tpu/parallel/gof.py:432)"),
        (cfg.geometryQP <= 4 or cfg.attributeQP <= 4,
         "lossless video (geometryQP or attributeQP <= 4: the level path codes every "
         "plane lossy, the sequential path losslessly)"),
    )
    for bad, what in checks:
        if bad:
            raise _refuse(what)


def _stack(arrays, device, dtype=torch.int32) -> torch.Tensor:
    return torch.stack([torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
                        for a in arrays])


def _pad_rows(rows: List[torch.Tensor], cap: int, fill: int) -> torch.Tensor:
    out = torch.full((len(rows), cap, rows[0].shape[1]), fill, dtype=rows[0].dtype,
                     device=rows[0].device)
    for b, r in enumerate(rows):
        out[b, :r.shape[0]] = r
    return out


def _encode_group(enc, per, parent, qp_off, geo_bank, attr_bank, H: int, W: int,
                  ref_ok: bool, idx: List[int]) -> None:
    """One level group of `encode_gof_mesh`: its frames' video, reconstruction
    and recolor, their results stored in `per` and the decoded references in
    the banks."""
    cfg = enc.cfg
    d = enc.device
    cuda = d.type == "cuda"
    geo_cap = int(getattr(cfg, "geometryQpCascadeCap", 1))
    bits = cfg.geometryBitDepth3D
    maxval_geo = (1 << cfg.geometryBitDepth2D) - 1
    B = len(idx)
    fronts = [per[f]["front"] for f in idx]
    t = time.perf_counter()
    occ_b = _stack([fr.frame.occupancy for fr in fronts], d, torch.uint8)
    w_b = _stack([fr.occ_rec for fr in fronts], d)
    # geometry D0 (temporal parent refs, motion) and D1 (the same
    # frame's decoded D0)
    qps_geo = [min(cfg.geometryQP + min(qp_off[f], geo_cap), 51) for f in idx]
    refs = torch.stack([geo_bank[parent[f]] for f in idx]) if ref_ok else None
    c0 = hevc.encode_planes_dispatch(_stack([fr.frame.geometry0 for fr in fronts], d),
                                     qps_geo, [maxval_geo] * B, refs=refs, occ=occ_b,
                                     deblock=False, weight=w_b, motion=True)
    c1 = hevc.encode_planes_dispatch(_stack([fr.frame.geometry1 for fr in fronts], d),
                                     qps_geo, [maxval_geo] * B, refs=c0.rec, occ=occ_b,
                                     deblock=False, weight=w_b, motion=False)
    tag = bytes([v3c.CODEC_TPU_HEVC])
    for bi, f in enumerate(idx):
        per[f]["geo_payloads"] = [tag + c0.payload(bi, 1), tag + c1.payload(bi, 1)]
        per[f]["geo_dec"] = [c0.rec[bi], c1.rec[bi]]
        geo_bank[f] = c0.rec[bi]
    t_video = time.perf_counter() - t

    # reconstruction per frame, then the batched recolor
    t = time.perf_counter()
    recons = []
    for f, fr in zip(idx, fronts):
        occ_for_recon = fr.occ_rec
        if cfg.pbfEnableFlag:
            occ_for_recon = pipeline.apply_pbf_occupancy(
                fr.occ_rec, per[f]["geo_dec"][0], fr.block_to_patch, fr.patches, cfg, d)
        per[f]["recon"] = pipeline.reconstruct_frame(
            occ_for_recon, per[f]["geo_dec"], fr.block_to_patch, fr.patches, cfg, d)
        recons.append(per[f]["recon"])
    if cuda:
        torch.cuda.synchronize(d)
    t_recon = time.perf_counter() - t
    t = time.perf_counter()
    tcap = max(shape_bucket(max(r.pos.shape[0], 1)) for r in recons)
    scap = max(shape_bucket(per[f]["src_pos"].shape[0]) for f in idx)
    src_cols = [torch.as_tensor(np.zeros((pc.point_count, 3), np.uint8) if pc.colors is None
                                else np.asarray(pc.colors, np.uint8), device=d)
                for pc in (per[f]["pc"] for f in idx)]
    cols_b = recolor_level(
        _pad_rows([per[f]["src_pos"] for f in idx], scap, PAD),
        _pad_rows(src_cols, scap, 0),
        [per[f]["pc"].point_count for f in idx],
        _pad_rows([r.pos for r in recons], tcap, PAD),
        [r.pos.shape[0] for r in recons], bits, k=cfg.numNeighborsColorTransferFwd,
        gates=(cfg.maxGeometryDist2Fwd, cfg.maxGeometryDist2Bwd, cfg.maxColorDist2Fwd,
               cfg.distOffsetFwd))
    imgs = []
    for bi, (fr, r) in enumerate(zip(fronts, recons)):
        col = enc.presmooth(r, cols_b[bi, :r.pos.shape[0]].contiguous())
        imgs.append(enc.attribute_images(r, col, fr.frame.occupancy, H, W))
    if cuda:
        torch.cuda.synchronize(d)
    t_recolor = time.perf_counter() - t

    # attribute video: T0 (temporal refs, motion) and T1 (inter-layer
    # refs from the DECODED T0 RGB through rgb_refs, as the sequential
    # codec), each a luma and a chroma dispatch over the level
    t = time.perf_counter()
    qy = [min(cfg.attributeQP + qp_off[f], 51) for f in idx]
    qc = [min(q + 3, 51) for q in qy for _ in range(2)]
    w_c = w_b.reshape(B, H // 2, 2, W // 2, 2).amax((2, 4)).repeat_interleave(2, 0)
    for layer in (0, 1):
        y_b, c_b = hevc.rgb_to_planes([im[layer] for im in imgs])
        c_b = c_b.view(2 * B, H // 2, W // 2)
        if layer == 0:
            y_refs = torch.cat([attr_bank[parent[f]][0] for f in idx]) if ref_ok else None
            c_refs = torch.cat([attr_bank[parent[f]][1] for f in idx]) if ref_ok else None
        else:
            # rgb_refs of each frame's decoded T0, in one launch
            y_refs, c_refs = hevc.rgb_to_planes([per[f]["attr_dec"][0] for f in idx])
            c_refs = c_refs.view(2 * B, H // 2, W // 2)
        cy = hevc.encode_planes_dispatch(y_b, qy, [255] * B, refs=y_refs, deblock=True,
                                         weight=w_b, motion=layer == 0)
        cc = hevc.encode_planes_dispatch(c_b, qc, [255] * (2 * B), refs=c_refs,
                                         deblock=True, weight=w_c, motion=layer == 0)
        for bi, f in enumerate(idx):
            payload = tag + struct_pack_ii(cy.payload(bi, 1), cc.payload(2 * bi, 2))
            per[f].setdefault("attr_payloads", []).append(payload)
            recy, recc = cy.rec[bi:bi + 1], cc.rec[2 * bi:2 * bi + 2]
            per[f].setdefault("attr_dec", []).append(
                hevc._int_planes_to_rgb(recy[0], recc[0], recc[1]))
            if layer == 0:
                attr_bank[f] = (recy, recc)
    if cuda:
        torch.cuda.synchronize(d)
    t_video += time.perf_counter() - t
    for f in idx:
        st = per[f]["front"].stats
        st.video_s += t_video / B
        st.reconstruct_s += t_recon / B
        st.recolor_s += t_recolor / B
        st.total_s += (t_video + t_recon + t_recolor) / B


def encode_gof_mesh(enc, frames: List[PointCloudData], segs=None):
    """Level-batched GOF encode: (V3C sample stream, reconstructed frames),
    byte for byte the sequential `Encoder.encode_gof`'s (reference
    gof.py:486).  `segs` optionally gives each frame's segmentation, as
    in the sequential path."""
    from vpcc_tpu_torch.encoder import EncodedFrame, GeometryFrame

    cfg = enc.cfg
    check_envelope(cfg)
    parent, qp_off = enc.gof_structure(len(frames))
    levels = level_schedule(parent)

    # ---- host stages per frame, in frame order (as the sequential path:
    # the same matching, height ratchet and rasterization)
    per = []
    for i, f in enumerate(frames):
        if f.reflectances is not None:
            raise _refuse("a reflectance attribute")
        t0 = time.perf_counter()
        seg = enc.segment_dispatch(f) if segs is None else segs[i]
        t_seg = time.perf_counter() - t0
        prev = per[parent[i]]["front"].patches if i > 0 else None
        fr = enc.encode_frame_front(f, prev_patches=prev, seg=seg)
        fr.stats.segmentation_s += t_seg
        raw_positions = raw_colors = None
        if cfg.rawPointsPatch:
            raw_sel = np.nonzero(fr.cover_dist2 > cfg.maxAllowedDist2RawPointsSelection)[0]
            if len(raw_sel):
                raw_positions = f.positions[raw_sel].astype(np.int32)
                if f.colors is not None:
                    raw_colors = f.colors[raw_sel]
        t = time.perf_counter()
        occ_payload = codecs.encode_occupancy(fr.occ_video, cfg)
        fr.stats.video_s += time.perf_counter() - t
        per.append(dict(pc=f, src_pos=seg.positions, front=fr, occ_payload=occ_payload,
                        raw_positions=raw_positions, raw_colors=raw_colors))

    geo_bank: dict = {}
    attr_bank: dict = {}
    shapes = [(p["front"].height, p["front"].width) for p in per]
    for lv, (H, W, ref_ok), idx in level_groups(levels, parent, shapes):
        # a profiler range per level group (free when no profiler runs)
        with torch.profiler.record_function(f"gof level {lv} {H}x{W} B={len(idx)}"):
            _encode_group(enc, per, parent, qp_off, geo_bank, attr_bank, H, W, ref_ok, idx)

    # ---- per-frame finishing: decoded colors, color smoothing, download
    encoded = []
    for f, p in enumerate(per):
        r, fr = p["recon"], p["front"]
        t = time.perf_counter()
        col_dec = pipeline.gather_decoded_colors(r.pix, r.layer, p["attr_dec"][0],
                                                 p["attr_dec"][1])
        col_dec = pipeline.apply_color_smoothing_device(r, col_dec, cfg)
        raw = None
        if p["raw_positions"] is not None:
            raw = (p["raw_positions"], p["raw_colors"] if p["raw_colors"] is not None
                   else np.zeros_like(p["raw_positions"], np.uint8))
        pos, col8, _ = pipeline.download_recon(
            r, col_dec, cfg.geometryBitDepth3D,
            remove_duplicates=bool(cfg.removeDuplicatePoints), raw=raw)
        fr.stats.video_s += time.perf_counter() - t
        fr.stats.total_s += time.perf_counter() - t
        geo = GeometryFrame(fr, p["occ_payload"], p["geo_payloads"], p["geo_dec"], r)
        encoded.append(EncodedFrame(fr.patches, fr.width, fr.height, p["occ_payload"],
                                    p["geo_payloads"], p["attr_payloads"],
                                    PointCloudData(pos, col8), geo, attr_bank.get(f),
                                    p["raw_positions"], p["raw_colors"]))
    enc.stats = [e.stats for e in encoded]
    return enc._mux_gof(encoded, frames, parent)
