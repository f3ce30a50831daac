"""Kernel entries timed one by one on the card, on inputs captured from the
encoder and decoder, for the `vpcc_tpu_torch` of this checkout or of another.

    python vpcc_tpu_torch/apps/profile_entries.py --capture=IN.pt [--kernels=...]
    python vpcc_tpu_torch/apps/profile_entries.py --inputs=IN.pt \\
        [--root=CHECKOUT] [--runs=5] [--kernels=P,E,A,G,K,J,F,O,Q,H,C,M,D,L,B,R,N,W,X,V] \
        [--trace] [--split]
    python vpcc_tpu_torch/apps/profile_entries.py --barriers
    python vpcc_tpu_torch/apps/profile_entries.py --summarize LOG [LOG ...]

--capture encodes one bench frame (`make_person_cloud(bits=10,
n_samples=3_000_000, seed=7)` with the configuration of the committed
front-end reference data, segmented by the encoder itself), with the
package under --root (default: this checkout), and saves the largest call
of (the encodes that only J, A, K, G or B need are skipped where --kernels
names none of them)
* kernel P: `pipeline.paint_attribute`, `group_dilate` and
  `gather_decoded_colors` (the scalar entries take the color inputs' first
  channel: the colors as samples, channel 0 of the two images widened to
  int32);
* kernel E: `neighbors.knn` for each k of the main path (segmentation k=16,
  recolor k=8 and k=1, pre-smoothing k=64), with the points of its grid.
  The unpacked and batched entries take inputs derived from the recolor
  call (k=8): its points and queries doubled into an 11-bit grid
  (`grid_knn_xyz`), and B = 3 frames of all, every second and every fourth
  of its points with the same queries (`grid_knn_batch`);
* kernel A: `hevc.wavefront_decode32` from the decode of the committed
  8-frame fixture (among the largest calls, the one that mixes inter and
  intra samples most evenly), and `hevc.wavefront_decode16` from the decode
  of that frame and the next bench frame encoded at
  geometryNominal2dBitdepth=11 (the two-level codec);
* kernel G: every `cc.cc_labels_device` call of the bench frame's encode
  (`cc_labels.r0` .. one a patch round: round 0 labels every voxel, the
  later rounds the still uncovered ones), and the round-0
  `cc.cc_round_voxel` call of a vox11 frame's front end
  (`make_person_cloud(bits=11, n_samples=12_000_000, seed=7)` with the
  configuration of the committed vox11 reference data);
* kernel K: the encoder's SAO step (`hevc.sao_search_apply`, the largest
  call) at 32-px regions from the bench frame's encode (`sao.encode32`)
  and at 16-px regions from the geometryNominal2dBitdepth=11 encode
  (`sao.encode16`), and the decoder's largest `hevc.sao_apply` call from the
  fixture decode (`sao_apply.decode32`) and from the two-level decode
  (`sao_apply.decode16`);
* kernel O: `hevc.deblock_planes`, the largest call of the bench frame's
  luma dispatches (`deblock.luma`) and of its chroma dispatches
  (`deblock.chroma`), and of the fixture decode (`deblock.decode`);
* kernel Q: the image of the bench frame's largest `hevc.encode_rgb` call
  (int32 RGB; `color.enc_to_planes`) and its largest `_int_planes_to_rgb`
  call (`color.enc_to_rgb`), and the fixture decode's largest
  `hevc.rgb_refs` (uint8 RGB; `color.dec_to_planes`) and
  `_int_planes_to_rgb` calls (`color.dec_to_rgb`).  Each side is timed per
  entry and as the pair (`color.enc_pair`, `color.dec_pair`); a checkout
  without `hevc.rgb_to_planes` converts with `_rgb_to_int_planes` and
  stacks cb and cr, as its callers did;
* kernel H: every `coverage.covered_radius_slab` call of the bench frame's
  encode (`coverage.r0` .. one a patch round), with the packed resampled
  points also as a host array (the encoder's upload);
* kernel C: the largest `reconstruct.generate_points` call of the bench
  frame's encode (`generate_points.encode`), of the fixture decode
  (`generate_points.decode`), of one bench frame encoded under the
  lossless conditions of the committed lossless reference data (EOM
  layers, `generate_points.eom`) and under its tools reference data's
  "plr" configuration (PLR layers, `generate_points.plr`); those two
  encodes only where --kernels names C;
* kernel M: the bench frame's `recolor.transfer_colors_compact` call, as a
  whole (`recolor.call`, kernel E's sweeps included) and as its kernel-M
  unit (`recolor.unit`) on inputs fixed at capture: the sorted source keys,
  the positions before compaction and the k-NN results of the inexact
  targets and unmatched sources (kernel E's, computed once); a checkout
  with `recolor.exact_compact` runs its two entries (also timed apart,
  `recolor.exact` and `recolor.blend`), an older one its exact match, the
  two `nonzero` calls and gathers, its forward blend and splat/merge, as
  its `transfer_colors_compact` did; one vox11 frame's
  `recolor.transfer_colors` call (`make_person_cloud(bits=11,
  n_samples=12_000_000, seed=7)` encoded with the configuration of the
  committed vox11 reference data) as its kernel-M unit after the sweeps
  (`recolor.vox11`); and the level path's largest `recolor.exact_match_batch`
  and `recolor.blend_batch` calls (`recolor.level_exact`,
  `recolor.level_blend`) of the 8 bench frames encoded with
  `encode_gof(parallel=True)`;
* kernel D: the largest `smoothing.grid_smooth` call of the bench frame's
  encode (`grid_smooth.encode`), of the fixture decode
  (`grid_smooth.decode`) and of the vox11 frame's encode
  (`grid_smooth.vox11`), each reported with the bytes its cell tables zero:
  the whole grid's four tables, or the records of the points' cell box
  (key "zeroed_bytes");
* kernel L: the largest `padding.push_pull_round` call of the bench frame's
  geometry encode (`push_pull.geometry`, one plane), its `fill_rgb` call
  (`push_pull.attribute`, six planes under one occupancy) and the level
  path's largest call with an occupancy per plane (`push_pull.level`, from
  the level-batched encode of the 8 bench frames);
* kernel B: the largest `hevc.half_pel_mc` call of the two-frame encode
  (`half_pel_mc.encode`), of the fixture decode (`half_pel_mc.decode`) and
  a 16-px call of the geometryNominal2dBitdepth=11 encode
  (`half_pel_mc.encode16`; where that encode searched no motion, the
  32-px encode call with each MV copied to its four 16-px CUs);
* kernel N: the bench frame's `smoothing.presmooth_colors` call, timed whole
  (`presmooth.call`: the boundary rows, kernel E's k=64 sweep and the vote)
  and as the vote alone (`presmooth.vote`) on kernel E's results computed
  once: a checkout whose `presmooth_vote` takes `bidx` writes into one copy
  of the colors made beforehand, an older one gathers the queries' colors
  once beforehand and returns the voted rows (the md5 of both sides is
  taken over the voted rows);
* kernel R: both directions of bench.py's `compute_metrics` of the bench
  frame against its r3 reconstruction (which the r3 stream decodes to),
  with the source's PCA normals and the reconstruction's transferred ones,
  on `metrics._nearest_exact`'s results computed once (`metrics.unit`:
  both directions, both sums, results on the host: a checkout whose
  `metrics_reduce` takes a list of directions makes its one launch and one
  host read, an older one runs `metrics_reduce` and `d2_sum_f32` a
  direction and reads the maximum, the D1 sum and the float64 sums, as
  its `_directional` did; the md5 is taken over the maximum d2 and the D1
  sum, the float64 sums are kept as "values");
* kernel W: the largest `padding.fill_rgb` call with attributeBGFill=0 of
  the bench frame encoded at r3 + attributeBGFill=0 (the painted T0/T1
  stack, (2, 3, 1280, 1280) int32, and its occupancy), timed as
  `fill_rgb(..., 0)` (`bg_dilate.fill_rgb`: the dilation, rounding and
  clip of the main path) and as `dilate_fill` of its (6, H, W) planes
  (`bg_dilate.dilate`: the float planes and the pass count); and the
  largest call with attributeBGFill=2 of the bench frame encoded at r3 +
  attributeBGFill=2, timed as `fill_rgb(..., 2)` (`bg_harmonic.fill_rgb`)
  and as `harmonic_fill` of its six planes (`bg_harmonic.harmonic`: the
  float planes);
* kernel X: the `normals.orient_normals_spanning_tree` call of the bench
  frame encoded at r3 + normalOrientation=4 (positions, PCA normals,
  `nn_idx`, `nn_valid`, valid rows, `pad_rows`; `orient.flood`: the
  oriented normals and `last_flood_sweeps`);
* kernel V: the `plr.rdo` call of the bench frame encoded at r3 +
  pointLocalReconstruction=1 (the committed tools reference data's "plr"
  configuration; `plr.rdo`: the block modes, patch levels, patch modes and
  the inexact count);
the vox11 encode only where --kernels names M or D, the level encode only
where it names M or L, the R and N encode only where it names R or N, the
option encodes only where it names W, X or V.
--inputs times the entries of the kernels named by --kernels, in the package
found under --root (default: this checkout), on those inputs, so that two
commits can be compared on one card, one process each, in turns (the grids
are built by each package from the saved points; a package without
`hevc.sao_search_apply` runs `sao_search` then `sao_apply` for the SAO
step, whose three outputs are hashed either way).  For each run and entry:
the call time (CUDA events over back-to-back calls, the wrapper's host work
included: 100 calls for P, 10 for W and X, 20 for the others) and, but
for J, F, O, H, C, M, D, R, W, X, V and N's whole call, the device time (one call captured in a CUDA graph and replayed as
often; the device times of J, F, O, H, C, M and D are their kernels' in
--trace: an older checkout's J, F and O wrappers copy from or wait on the
host, which a graph cannot hold, C's and M's wrappers read their counts, and
the cooperative launches of H, M and D are kept out of graphs; R's unit and
N's whole call read from the card; W's and X's parent wrappers read device
flags between launches, and V's wrappers read their results, so theirs
come from --trace too).  Each entry
also reports the launch counters (`device.LAUNCHES`) one call adds (key
"launches").
--trace adds, once per entry, each device kernel's time and launches a
call (`torch.profiler` over as many calls) and the host's waits a call
(`cudaStreamSynchronize` and `cudaMemcpy*` runtime calls: CPU
microseconds and calls); for W and V also each launch of one call in
launch order with its device microseconds (key "timeline").  --split times, for J, builds of the checkout's
`csrc/motion_search.cu` cut after its 1st, 2nd and 3rd `__syncthreads()`
(a `return` the compiler cannot drop), so that the differences split
J's kernel (one block a CU, a barrier after each stage) into its stages
(staging, integer SAD, argmin, half-pel refinement); for O, Q, H, C, M,
D, L and B, the host microseconds a call of back-to-back calls without a
synchronisation (a wrapper that waits on the card includes its wait; for R
and N too),
whether a call raises under torch.cuda.set_sync_debug_mode("error") and the
synchronisations a call reports under mode "warn", and once the host
microseconds of the steps a wrapper may take (the tc table's upload,
setting ctypes argument types, an output allocation, reading the stream;
top-level key "host_parts_us"; with H or C, also H's upload of the packed
resampled points from a host array as the encoder makes it, each round,
and a zeroed volume of each round's slab, C's five output allocations
against one allocation cut into the five fields, and a read of one device
int32; top-level key "hc_host_parts_us"; with L and B on this checkout,
their wrappers' steps, `lb_host_parts`, key "lb_host_parts_us"; with R
and N on this checkout, theirs, `rn_host_parts`, key "rn_host_parts_us";
with W or X, the lists their walks take, `frontier_stats`, key "frontier");
for B, the device time of each call with every MV's phase forced to (0, 0),
(0, 1), (1, 0) and (1, 1) (CUDA graph replay) beside the call's own mix of phases; for L and B on a
checkout with `padding.push_pull_plan`, push_pull.cu built whole and with
the pull phase's rebuild of levels 2..t-1 cut (key "variants": what reading
the levels back could save at most), half_pel_mc.cu whole and with its
window-staging loop not unrolled; for R and N on a checkout whose wrappers
take a list of directions and `bidx`, metrics.cu and presmooth.cu whole,
at lower register caps and (N) cut (no luma counts, no entropy runs) or
with four warps a block.  With M, D, L, B, R or N, the
ptxas lines of the checkout's builds of those kernels (top-level key
"ptxas", from a build made in the process).  Prints the card's name and
power limit, then one JSON line: per entry, the runs' call and device
milliseconds and the md5 of its output (and the trace).  --summarize reads the JSON lines
of such runs (the logs of several processes) and prints, per checkout and
entry, the median and quartiles of the call and device milliseconds over
all runs, and whether the md5s of all runs agree.
--barriers builds `apps/barrier_probe.cu` and prints one JSON line of the
card's empty barriers in microseconds: grid.sync() of cooperative
launches of several grid sizes, barrier.cluster of one cluster of 8 and 16
CTAs, and __syncthreads() of one block (each the median of 5 timings of
a launch passing 2000 barriers, less a launch passing none, over 2000).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[2]
P_ENTRIES = ("paint_attribute", "group_dilate", "gather_decoded_colors")
E_CALLS = {16: "grid_knn.segment_k16", 8: "grid_knn.recolor_k8", 1: "grid_knn.nearest_k1",
           64: "grid_knn.presmooth_k64"}
REPS = {"P": 100, "E": 20, "A": 20, "G": 20, "K": 20, "J": 20, "F": 20, "O": 20, "Q": 20,
        "H": 20, "C": 20, "M": 20, "D": 20, "L": 20, "B": 20, "R": 20, "N": 20, "W": 10,
        "X": 10, "V": 20}
# kernels, and entries, whose device time is read from --trace rather than a
# CUDA graph (R's unit and N's whole call read from the card)
NO_GRAPH = "JFOHCMDRWXV"
NO_GRAPH_ENTRIES = ("presmooth.call",)
F_STAGES = ("segment.pca", "segment.orient", "segment.partition")


def time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one call of fn, replayed from a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, reps)


def _clone(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def _spy(mod, attr, before=None, after=None):
    """Wrap mod.attr: before(args, kw) ahead of each call, after(args, kw,
    out) behind it.  Returns the undo."""
    real = getattr(mod, attr)

    def call(*args, **kw):
        if before:
            before(args, kw)
        out = real(*args, **kw)
        if after:
            after(args, kw, out)
        return out

    setattr(mod, attr, call)
    return lambda: setattr(mod, attr, real)


def _mix(inter: int, total: int) -> int:
    return min(inter, total - inter)


def keep_largest(kept: dict, name: str, region: Optional[int] = None):
    """A `_spy` hook that keeps in kept[name] the call with the most
    elements in its first argument, as (args, kw); given `region`, only
    kernel K's calls at that region size."""
    def before(args, kw):
        if region is not None and kw.get("region", 32) != region:
            return
        if name not in kept or args[0].numel() > kept[name][0][0].numel():
            kept[name] = (_clone(args), dict(kw))
    return before


def sao_step(hevc, src, rec, lam, w, maxv, region):
    """The encoder's SAO step with one checkout's kernel K: (rec_sao, cls,
    off)."""
    if hasattr(hevc, "sao_search_apply"):
        return hevc.sao_search_apply(src, rec, lam, w, maxv, region=region)
    cls, off = hevc.sao_search(src, rec, lam, w, region=region)
    return hevc.sao_apply(rec, cls, off, maxv, region=region), cls, off


def capture_encode(frame, cfg, device) -> tuple:
    """Encode one frame, keeping P's largest calls, E's largest call for
    each k with its grid's points, every call of G and H, K's largest, F's
    first chain, and O's, Q's, C's, M's, D's and L's largest (L: the
    geometry planes' and `fill_rgb`'s).  Returns (P inputs, E inputs, G
    inputs, K inputs, F inputs, O and Q inputs, H and C inputs, M and D
    calls as (args, kw), L calls as (args, kw))."""
    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import (cc, coverage, neighbors, normals, padding, reconstruct,
                                    recolor, segmentation, smoothing)
    from vpcc_tpu_torch.video import hevc

    p_kept, e_kept, grids, k_kept, oq_kept, c_kept = {}, {}, {}, {}, {}, {}
    md_kept, l_kept = {}, {}
    in_fill = []   # set while `fill_rgb` runs: its push-pull is the attribute call
    g_calls, f_calls, h_calls = [], [], []
    plane_kind = []   # "luma" or "chroma": the plane dispatch running now

    def keep_p(name):
        def before(args, kw):
            if name not in p_kept or args[0].numel() > p_kept[name][0]:
                p_kept[name] = (args[0].numel(), _clone(args))
        return before

    def grid_built(args, kw, g):
        grids[id(g)] = args[0].clone()

    def keep_e(args, kw):
        grid, q = args[:2]
        k = kw.get("k")
        if k in E_CALLS and id(grid) in grids and (
                k not in e_kept or q.shape[0] > e_kept[k]["q"].shape[0]):
            e_kept[k] = dict(pos=grids[id(grid)], bits=grid.grid_bits, cell_bits=grid.cell_bits,
                             q=q.clone(), k=k, bucket=kw.get("bucket", 16))

    undo = [_spy(pipeline, name, before=keep_p(name)) for name in P_ENTRIES]
    undo += [_spy(neighbors, "build_grid", after=grid_built),
             _spy(neighbors, "knn", before=keep_e),
             _spy(cc, "cc_labels_device", before=lambda a, kw: g_calls.append(_clone(a))),
             _spy(hevc, "sao_search_apply", before=keep_largest(k_kept, "sao.encode32", 32)),
             _spy(normals, "pca_normals", before=lambda a, kw: f_calls.append(_clone(a))),
             _spy(hevc, "encode_planes_dispatch", before=lambda a, kw: plane_kind.insert(
                 0, "luma" if a[0].shape[0] == 1 else "chroma")),
             _spy(hevc, "deblock_planes", before=lambda a, kw: keep_largest(
                 oq_kept, f"deblock.{plane_kind[0]}")(a, kw)),
             _spy(hevc, "encode_rgb", before=keep_largest(oq_kept, "color.enc_to_planes")),
             _spy(hevc, "_int_planes_to_rgb", before=keep_largest(oq_kept, "color.enc_to_rgb")),
             _spy(coverage, "covered_radius_slab",
                  before=lambda a, kw: h_calls.append(_clone(a))),
             _spy(reconstruct, "generate_points",
                  before=keep_largest(c_kept, "generate_points.encode")),
             _spy(recolor, "transfer_colors_compact",
                  before=keep_largest(md_kept, "recolor.call")),
             _spy(smoothing, "grid_smooth", before=keep_largest(md_kept, "grid_smooth.encode")),
             _spy(padding, "fill_rgb", before=lambda a, kw: in_fill.append(1),
                  after=lambda a, kw, out: in_fill.pop()),
             _spy(padding, "push_pull_round", before=lambda a, kw: keep_largest(
                 l_kept, "push_pull.attribute" if in_fill else "push_pull.geometry")(a, kw))]
    try:
        Encoder(cfg, device=device).encode_gof([frame])
    finally:
        for u in undo:
            u()
    missing = sorted(set(E_CALLS) - set(e_kept))
    if missing or len(p_kept) != len(P_ENTRIES):
        raise RuntimeError(f"calls not seen: k={missing}, P {sorted(p_kept)}")
    e_in = {E_CALLS[k]: c for k, c in e_kept.items()}
    fwd = e_kept[8]
    e_in["grid_knn_xyz"] = dict(pos=fwd["pos"] * 2, bits=fwd["bits"] + 1, cell_bits=None,
                                q=fwd["q"] * 2, k=8, bucket=fwd["bucket"])
    subsets = [fwd["pos"], fwd["pos"][::2], fwd["pos"][::4]]
    pad = torch.full((3, fwd["pos"].shape[0], 3), -(1 << 20), dtype=torch.int32,
                     device=fwd["pos"].device)
    for b, sub in enumerate(subsets):
        pad[b, :sub.shape[0]] = sub
    e_in["grid_knn_batch"] = dict(pos=pad, bits=fwd["bits"], cell_bits=None,
                                  q=fwd["q"][None].expand(3, -1, -1).contiguous(), k=8,
                                  bucket=fwd["bucket"])
    g_in = {f"cc_labels.r{i}": args for i, args in enumerate(g_calls)}
    weights = torch.ones(len(segmentation.get_orientations(cfg.additionalProjectionPlaneMode)))
    weights[[0, 3]], weights[[1, 4]], weights[[2, 5]] = (
        cfg.weightNormalX, cfg.weightNormalY, cfg.weightNormalZ)
    f_in = {"segment.chain": [*f_calls[0], torch.as_tensor(segmentation.get_orientations(
        cfg.additionalProjectionPlaneMode)), weights, float(cfg.lambdaRefineSegmentation),
        int(cfg.iterationCountRefineSegmentation)]}
    oq_in = {n: args[:1] if n == "color.enc_to_planes" else args
             for n, (args, _) in oq_kept.items()}
    hc_in = {f"coverage.r{i}": args for i, args in enumerate(h_calls)}
    hc_in.update({n: [*args, kw] for n, (args, kw) in c_kept.items()})
    return ({name: args for name, (_, args) in p_kept.items()}, e_in, g_in, k_kept, f_in,
            oq_in, hc_in, md_kept, l_kept)


def capture_recon(frame, overrides: dict, name: str, device) -> list:
    """Encode one frame under `overrides` and return the largest
    `reconstruct.generate_points` call as [*args, kw]."""
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import reconstruct
    from vpcc_tpu_torch.utils.config import VPCCConfig

    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    kept = {}
    undo = _spy(reconstruct, "generate_points", before=keep_largest(kept, name))
    try:
        Encoder(cfg, device=device).encode_gof([frame])
    finally:
        undo()
    args, kw = kept[name]
    if kw.get("eom") is None:
        raise RuntimeError(f"{name}: kernel C ran without an EOM or PLR plane")
    return [*args, kw]


def capture_decode(stream: bytes, name: str, device, sao: Optional[dict] = None,
                   sao_name: str = "", region: int = 32, oq: Optional[dict] = None) -> list:
    """Decode `stream`, keeping kernel A's (`name`) largest call that mixes
    inter and intra samples most evenly (and, given `sao`, kernel K's
    largest `sao_apply` call at `region` in sao[sao_name]; given `oq`,
    kernel Q's largest `rgb_refs` and `_int_planes_to_rgb` calls and kernels
    O's, C's, D's and B's largest calls)."""
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.ops import reconstruct, smoothing
    from vpcc_tpu_torch.video import hevc
    from vpcc_tpu_torch.video.hevc_tables import MODE_INTER

    kept = []

    def key(args):
        if name == "wavefront_decode32":
            s32, m32, s16, modes = (args[i] != 0 if i in (1, 4) else args[i]
                                    for i in (1, 2, 4, 5))
            inter = int(((~s32 & (m32 == MODE_INTER)).sum() * 1024
                         + (s32[..., None] & ~s16 & (modes[..., 0] == MODE_INTER)).sum() * 256
                         + ((s32[..., None] & s16)[..., None] & (modes == MODE_INTER)).sum()
                         * 64))
            total = args[1].numel() * 1024
        else:
            split, modes = args[1] != 0, args[2]
            inter = int((~split & (modes[..., 0] == MODE_INTER)).sum() * 256
                        + (split[..., None] & (modes == MODE_INTER)).sum() * 64)
            total = args[1].numel() * 256
        return (args[0].numel(), _mix(inter, total))

    def before(args, kw):
        k = key(args)
        if not kept or k > kept[0]:
            kept[:] = [k, _clone(args)]

    undo = [_spy(hevc, name, before=before)]
    if sao is not None:
        undo.append(_spy(hevc, "sao_apply", before=keep_largest(sao, sao_name, region)))
    if oq is not None:
        undo += [_spy(hevc, "rgb_refs", before=keep_largest(oq, "color.dec_to_planes")),
                 _spy(hevc, "_int_planes_to_rgb", before=keep_largest(oq, "color.dec_to_rgb")),
                 _spy(hevc, "deblock_planes", before=keep_largest(oq, "deblock.decode")),
                 _spy(reconstruct, "generate_points",
                      before=keep_largest(oq, "generate_points.decode")),
                 _spy(smoothing, "grid_smooth", before=keep_largest(oq, "grid_smooth.decode")),
                 _spy(hevc, "half_pel_mc", before=keep_largest(oq, "half_pel_mc.decode"))]
    try:
        Decoder(device=device).decode(stream)
    finally:
        for u in undo:
            u()
    if not kept:
        raise RuntimeError(f"{name} was not called")
    return kept[1]


def capture_vox11(device) -> list:
    """The round-0 `cc_round_voxel` call of a vox11 frame's front end."""
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import cc

    cfg, frame = vox11_setup()
    calls = []
    undo = _spy(cc, "cc_round_voxel", before=lambda a, kw: calls.append(_clone(a)))
    try:
        Encoder(cfg, device=device).encode_gof_front([frame])
    finally:
        undo()
    return calls[0]


def vox11_setup():
    """(config, first frame) of the committed vox11 reference data."""
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads((ROOT / "vpcc_tpu_torch" / "data" / "person_vox11_reference.json")
                     .read_text())
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    return cfg, make_person_cloud(bits=cfg.geometryBitDepth3D, n_samples=ref["n_samples"],
                                  seed=ref["seeds"][0])


def capture_vox11_md(device) -> dict:
    """The vox11 frame's `recolor.transfer_colors` and largest
    `smoothing.grid_smooth` calls of a whole encode, as (args, kw)."""
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import recolor, smoothing

    cfg, frame = vox11_setup()
    kept = {}
    undo = [_spy(recolor, "transfer_colors", before=keep_largest(kept, "recolor.vox11")),
            _spy(smoothing, "grid_smooth", before=keep_largest(kept, "grid_smooth.vox11"))]
    try:
        Encoder(cfg, device=device).encode_gof([frame])
    finally:
        for u in undo:
            u()
    return kept


def capture_level(frames, cfg, device) -> dict:
    """The largest `recolor.exact_match_batch` and `recolor.blend_batch`
    calls of the level-batched encode of `frames`, and its largest
    `padding.push_pull_round` call with an occupancy per plane, as (args,
    kw)."""
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import padding, recolor

    kept = {}

    def keep_planar(args, kw):
        if args[1].ndim == 3:
            keep_largest(kept, "push_pull.level")(args, kw)

    undo = [_spy(recolor, "exact_match_batch", before=keep_largest(kept, "recolor.level_exact")),
            _spy(recolor, "blend_batch", before=keep_largest(kept, "recolor.level_blend")),
            _spy(padding, "push_pull_round", before=keep_planar)]
    try:
        Encoder(cfg, device=device).encode_gof(frames, parallel=True)
    finally:
        for u in undo:
            u()
    return kept


def capture_rn(frame, cfg, device) -> dict:
    """Kernel N's call (the largest `smoothing.presmooth_colors` call of
    the frame's encode, as [*args, kw]) and kernel R's inputs: both
    directions of bench.py's `compute_metrics` of the frame against the
    encode's reconstruction (source -> reconstruction, then back), with
    the source's PCA normals and the reconstruction's transferred ones and
    the nearest searches done once by the checkout's `_nearest_exact`, as
    [pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a] each."""
    import numpy as np

    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import metrics, smoothing

    kept = {}
    undo = _spy(smoothing, "presmooth_colors", before=keep_largest(kept, "presmooth.call"))
    try:
        _, recons = Encoder(cfg, device=device).encode_gof([frame])
    finally:
        undo()
    d = torch.device(device)
    pa = torch.as_tensor(frame.positions.astype(np.int32), device=d)
    ca = torch.as_tensor(frame.colors, device=d)
    pb = torch.as_tensor(recons[0].positions.astype(np.int32), device=d)
    cb = torch.as_tensor(recons[0].colors, device=d)
    bits = cfg.geometryBitDepth3D
    na = metrics.estimate_normals(pa, bits, device=d)
    nb = metrics.transfer_normals(pa, na, pb, bits, device=d)
    pairs = [(pa, ca, pb, cb, nb), (pb, cb, pa, ca, na)]
    if "pairs" in inspect.signature(metrics._nearest_exact).parameters:
        found = metrics._nearest_exact([(a, b) for a, _, b, _, _ in pairs], bits)
    else:
        found = [metrics._nearest_exact(a, b, bits) for a, _, b, _, _ in pairs]
    args, kw = kept["presmooth.call"]
    return {"N": {"presmooth.call": [*args, kw]},
            "R": {"metrics.unit": [[a, ac, b, bc, bn, idx, d2, a.shape[0]]
                                   for (a, ac, b, bc, bn), (idx, d2) in zip(pairs, found)]}}


def capture_wx(frame, cfg, device, kernels: str) -> dict:
    """Kernel W's calls (the largest `padding.fill_rgb` call of the frame's
    encodes at attributeBGFill=0 and 2, as [planes, occupancy]), kernel X's
    (the `normals.orient_normals_spanning_tree` call of its encode at
    normalOrientation=4, as [positions, normals, nn_idx, nn_valid, valid,
    pad_rows]) and kernel V's (the `plr.rdo` call of its encode at
    pointLocalReconstruction=1, as its arguments), for the letters of
    `kernels`."""
    import copy

    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import normals, padding, plr

    out = {}
    if "W" in kernels:
        kept = {}
        for mode, name in ((0, "bg_dilate.fill_rgb"), (2, "bg_harmonic.fill_rgb")):
            def keep_w(args, kw, mode=mode, name=name):
                if (args[2] if len(args) > 2 else kw.get("mode", 1)) == mode:
                    keep_largest(kept, name)(args[:2], {})

            c = copy.copy(cfg)
            c.attributeBGFill = mode
            undo = _spy(padding, "fill_rgb", before=keep_w)
            try:
                Encoder(c, device=device).encode_gof([frame])
            finally:
                undo()
        out["W"] = {n: args for n, (args, _) in kept.items()}
    if "V" in kernels:
        kept = {}
        c = copy.copy(cfg)
        c.pointLocalReconstruction = 1
        undo = _spy(plr, "rdo", before=lambda a, kw: kept.setdefault("plr.rdo", _clone(a)))
        try:
            Encoder(c, device=device).encode_gof([frame])
        finally:
            undo()
        out["V"] = kept
    if "X" in kernels:
        kept = {}
        c = copy.copy(cfg)
        c.normalOrientation = 4
        undo = _spy(normals, "orient_normals_spanning_tree",
                    before=lambda a, kw: kept.setdefault("orient.flood", [
                        *_clone(a[:5]), bool(a[5] if len(a) > 5 else kw.get("pad_rows", False))]))
        try:
            Encoder(c, device=device).encode_gof([frame])
        finally:
            undo()
        out["X"] = kept
    return out


def r_unit(metrics, dirs):
    """Kernel R's work in one `compute_metrics` call after the nearest
    searches, with one checkout's entries, as a call: per direction
    [maximum d2, D1 float32 sum, point-to-plane, Y, U, V sums] as a (2, 6)
    float64 tensor on the host."""
    if "dirs" in inspect.signature(metrics.metrics_reduce).parameters:
        return lambda: metrics.metrics_reduce(dirs).cpu()

    def older():
        rows = []
        for pa, ca, pb, cb, nb, idx, d2, n in dirs:
            dmax, fsums = metrics.metrics_reduce(pa, ca, pb, cb, nb, idx, d2, n)
            mx = int(dmax)
            s = metrics.d2_sum_f32(d2, n, metrics.shape_bucket(n)).cpu()
            rows.append([float(mx), float(s), *fsums.cpu().tolist()])
        return torch.tensor(rows, dtype=torch.float64)
    return older


def n_vote(smoothing, neighbors, args, kw):
    """Kernel N alone on one `presmooth_colors` call, with kernel E's k=64
    sweep over its boundary rows done once: (the vote with one checkout's
    wrapper, the boundary rows).  A wrapper that takes `bidx` writes into
    a copy of the colors made here; an older one takes the queries'
    colors, gathered here."""
    pos, colors, bnd, grid_bits = args[:4]
    bidx = torch.nonzero(bnd).flatten()
    grid = neighbors.build_grid(pos, grid_bits)
    nidx, nd2 = neighbors.knn(grid, pos[bidx].contiguous(), k=kw["k"], bucket=6)
    gates = (kw["radius2"], kw["thr_dist"], kw["thr_entropy"])
    if "bidx" in inspect.signature(smoothing.presmooth_vote).parameters:
        out = colors.clone()
        return (lambda: smoothing.presmooth_vote(colors, nidx, nd2, bidx, out, *gates)), bidx
    q_col = colors[bidx].contiguous()
    return (lambda: smoothing.presmooth_vote(colors, nidx, nd2, q_col, *gates)), bidx


def m_inputs(md: dict) -> dict:
    """Kernel M's captured calls with the work of kernel E around them done
    once: for the bench frame's call the positions before compaction and
    the k-NN results of its inexact targets and unmatched sources (index
    order, as both routes compact); for the vox11 call the sweeps over every
    target and every source."""
    from vpcc_tpu_torch.ops import neighbors, recolor

    out = {}
    if "recolor.call" in md:
        (src_pos, src_col, tgt, *_), kw = md["recolor.call"]
        bits = kw.get("grid_bits", 10)
        order, sk = recolor.sorted_source_keys(src_pos, bits)
        _, has, matched, _ = recolor.exact_match_plain(order, sk, tgt, bits)
        iidx = torch.nonzero(~has).flatten()
        uidx = torch.nonzero(~matched).flatten()
        idx, d2 = neighbors.knn(neighbors.build_grid(src_pos, bits), tgt[iidx].contiguous(),
                                k=kw.get("k", 8), bucket=6)
        tidx, td2 = neighbors.nearest(neighbors.build_grid(tgt, bits),
                                      src_pos[uidx].contiguous(), bucket=6)
        out["recolor.call"] = dict(src_pos=src_pos, src_col=src_col, tgt=tgt, kw=kw)
        out["recolor.unit"] = dict(src_pos=src_pos, src_col=src_col.to(torch.uint8), tgt=tgt,
                                   bits=bits, idx=idx, d2=d2, tidx=tidx, td2=td2,
                                   gates=_gates(kw))
    if "recolor.vox11" in md:
        (src_pos, src_col, tgt, eidx, has), kw = md["recolor.vox11"]
        bits = kw["grid_bits"]
        idx, d2 = neighbors.knn(neighbors.build_grid(src_pos, bits), tgt, k=kw.get("k", 8),
                                bucket=6)
        tidx, td2 = neighbors.nearest(neighbors.build_grid(tgt, bits), src_pos, bucket=6)
        out["recolor.vox11"] = dict(src_col=src_col.to(torch.uint8).contiguous(), eidx=eidx,
                                    has=has, idx=idx, d2=d2, tidx=tidx, td2=td2,
                                    gates=_gates(kw))
    for name in ("recolor.level_exact", "recolor.level_blend"):
        if name in md:
            out[name] = dict(args=md[name][0])
    return out


def _gates(kw) -> tuple:
    """(maxGeometryDist2Fwd, maxColorDist2Fwd, distOffsetFwd,
    maxGeometryDist2Bwd) of a transfer call's keywords (their defaults)."""
    return (float(kw.get("max_geom_d2_fwd", 1000.0)), float(kw.get("max_color_d2_fwd", 1000.0)),
            float(kw.get("dist_offset_fwd", 4.0)), float(kw.get("max_geom_d2_bwd", 1000.0)))


def shapes(c: dict) -> list:
    """The shapes of the tensors of one captured kernel-M call."""
    return [tuple(t.shape) for t in c.get("args", c.values()) if torch.is_tensor(t)]


def m_unit(recolor, c):
    """Kernel M's work in one bench-frame transfer, between and around
    kernel E's sweeps, with one checkout's entries: (exact_idx, has_exact,
    inexact targets and their positions, unmatched sources and their
    positions, colors)."""
    order, sk = c["order"], c["sk"]
    src_pos, tgt, col, bits = c["src_pos"], c["tgt"], c["src_col"], c["bits"]
    gf, cd2, doff, gb = c["gates"]
    if hasattr(recolor, "exact_compact"):
        eidx, has, iidx, tq, uidx, sq = recolor.exact_compact(order, sk, src_pos, tgt, bits)
        out = recolor.blend_merge(col, eidx, has, iidx, c["idx"], c["d2"], uidx, c["tidx"],
                                  c["td2"], gf, cd2, doff, gb)
        return eidx, has, iidx, tq, uidx, sq, out
    eidx, has, matched, counts = recolor.exact_match(order, sk, tgt, bits)
    counts.tolist()
    iidx = torch.nonzero(~has).flatten().to(torch.int32)
    tq = tgt[iidx.long()].contiguous()
    uidx = torch.nonzero(~matched).flatten().to(torch.int32)
    sq = src_pos[uidx.long()].contiguous()
    fwd = recolor.fwd_blend(col, c["idx"], c["d2"], gf, cd2, doff)
    out = recolor.splat_merge(col, uidx, c["tidx"], c["td2"], eidx, has, iidx, fwd, gb)
    return eidx, has, iidx, tq, uidx, sq, out


def m_vox11_unit(recolor, c):
    """Kernel M's work in one vox11 `transfer_colors` call after kernel E's
    sweeps (every target, every source), with one checkout's entries."""
    col, eidx, has, idx, d2, tidx, td2 = (c[k] for k in ("src_col", "eidx", "has", "idx",
                                                          "d2", "tidx", "td2"))
    gf, cd2, doff, gb = c["gates"]
    if hasattr(recolor, "blend_merge"):
        return recolor.blend_merge(col, eidx, has, None, idx, d2, None, tidx, td2, gf, cd2,
                                   doff, gb)
    ns, nt, d = col.shape[0], eidx.shape[0], col.device
    fwd = recolor.fwd_blend(col, idx, d2, gf, cd2, doff)
    matched = torch.zeros(ns, dtype=torch.bool, device=d)
    matched[eidx.long()[has]] = True
    td2 = torch.where(matched, torch.full_like(td2, recolor.MAX_DIST2), td2)
    return recolor.splat_merge(col, torch.arange(ns, dtype=torch.int32, device=d), tidx, td2,
                               eidx, has, torch.arange(nt, dtype=torch.int32, device=d), fwd,
                               gb)


def zeroed_bytes(points, grid_size: int, grid_bits: int) -> dict:
    """Bytes of cell records a kernel D call zeroes: the four tables of the
    whole grid (count, three position sums, min and max patch id; gw^3 + 1
    cells of 24 bytes), or the records of the points' cell box only."""
    gw = (1 << grid_bits) // grid_size
    cell = torch.div(points, grid_size, rounding_mode="floor").clamp(0, gw - 1)
    box = (cell.amax(0) - cell.amin(0) + 1).tolist() if points.shape[0] else [0, 0, 0]
    return {"tables": 24 * (gw ** 3 + 1), "box": 24 * box[0] * box[1] * box[2],
            "box_cells": box}


def capture(path: Path, device="cuda",
            kernels: str = "P,E,A,G,K,J,F,O,Q,H,C,M,D,L,B,R,N") -> None:
    """Encode and decode bench frames on `device` and save the inputs of
    kernels P, E, A, G, K, J, F, O, Q, H, C, M, D, L, B, R and N (the
    two-frame, two-level, vox11 front-end, lossless and PLR, vox11,
    level-batched and R and N encodes only where `kernels` names a kernel
    they feed: J, B; J, A, K, B; G; C; C; M, D; M, L; R, N)."""
    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud
    from vpcc_tpu_torch.video import hevc

    data = ROOT / "vpcc_tpu_torch" / "data"
    ref = json.loads((data / "person_vox10_front_digests.json").read_text())
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    dev.build_kernels()
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in ref["seeds"][:2]]
    p_in, e_in, g_in, k_in, f_in, oq_in, hc_in, md, l_in = capture_encode(frames[0], cfg,
                                                                          device)
    j_in, b_in = {}, {}
    if "J" in kernels or "B" in kernels:
        undo = [_spy(hevc, "motion_search", before=keep_largest(j_in, "motion_search.cu32")),
                _spy(hevc, "half_pel_mc", before=keep_largest(b_in, "half_pel_mc.encode"))]
        try:
            Encoder(cfg, device=device).encode_gof(frames)
        finally:
            for u in undo:
                u()
    sao_calls, oq_dec = {}, {}
    a_in = {"wavefront_decode32": capture_decode(
        (data / "person_vox10_r3_gof8.vpcc").read_bytes(), "wavefront_decode32", device,
        sao_calls, "sao_apply.decode32", oq=oq_dec)}
    oq_in.update({n: args for n, (args, _) in oq_dec.items()
                  if not n.startswith(("generate_points.", "grid_smooth.", "half_pel_mc."))})
    md["grid_smooth.decode"] = oq_dec["grid_smooth.decode"]
    b_in["half_pel_mc.decode"] = oq_dec["half_pel_mc.decode"]
    if "M" in kernels or "D" in kernels:
        md.update(capture_vox11_md(device))
    if "M" in kernels or "L" in kernels:
        frames8 = frames + [make_person_cloud(bits=10, n_samples=3_000_000, seed=s)
                            for s in ref["seeds"][2:]]
        level = capture_level(frames8, cfg, device)
        l_in["push_pull.level"] = level.pop("push_pull.level")
        md.update(level)
        del frames8
    m_in = m_inputs(md)
    d_in = {n: [*args, kw] for n, (args, kw) in md.items() if n.startswith("grid_smooth.")}
    o_in = {n: a for n, a in oq_in.items() if n.startswith("deblock.")}
    q_in = {n: a for n, a in oq_in.items() if n.startswith("color.")}
    hc_in.update({n: [*args, kw] for n, (args, kw) in oq_dec.items()
                  if n.startswith("generate_points.")})
    if "C" in kernels:
        for what, ref_file, conf in (("eom", "person_vox10_lossless_reference.json", "lossless"),
                                     ("plr", "person_vox10_tools_reference.json", "plr")):
            overrides = json.loads((data / ref_file).read_text())["configs"][conf]["overrides"]
            hc_in[f"generate_points.{what}"] = capture_recon(
                frames[0], overrides, f"generate_points.{what}", device)
    h_in = {n: a for n, a in hc_in.items() if n.startswith("coverage.")}
    c_in = {n: a for n, a in hc_in.items() if n.startswith("generate_points.")}
    rn = capture_rn(frames[0], cfg, device) if "R" in kernels or "N" in kernels else {}
    wx = capture_wx(frames[0], cfg, device, kernels) if any(k in kernels for k in "WXV") \
        else {}
    sao16 = {}
    if any(k in kernels for k in "JAKB"):
        cfg.geometryNominal2dBitdepth = 11

        def keep_b16(args, kw):
            if args[3] == 16:
                keep_largest(b_in, "half_pel_mc.encode16")(args, kw)

        undo = [_spy(hevc, "sao_search_apply", before=keep_largest(sao16, "sao.encode16", 16)),
                _spy(hevc, "motion_search", before=keep_largest(j_in, "motion_search.cu16")),
                _spy(hevc, "half_pel_mc", before=keep_b16)]
        try:
            stream, _ = Encoder(cfg, device=device).encode_gof(frames)
        finally:
            for u in undo:
                u()
        if "motion_search.cu16" not in j_in and j_in:   # no motion searched at 16 px
            j_in["motion_search.cu16"] = ([*j_in["motion_search.cu32"][0][:4], 16], {})
        if "half_pel_mc.encode16" not in b_in and "half_pel_mc.encode" in b_in:
            (ref32, mv32, maxv32, _), _ = b_in["half_pel_mc.encode"]
            P32, H32, W32 = ref32.shape
            mv16 = mv32.view(P32, H32 // 32, 1, W32 // 32, 1, 2).expand(
                -1, -1, 2, -1, 2, -1).reshape(P32, -1, 2).contiguous()
            b_in["half_pel_mc.encode16"] = ([ref32, mv16, maxv32, 16], {})
        a_in["wavefront_decode16"] = capture_decode(stream, "wavefront_decode16", device,
                                                    sao_calls, "sao_apply.decode16", 16)
    if "G" in kernels:
        g_in["cc_round_voxel.vox11"] = capture_vox11(device)
    # K: (args, kw) per entry, the region as an argument
    k_in = {**k_in, **sao16, **sao_calls}
    k_in = {n: [*args, kw.get("region", 32)] for n, (args, kw) in k_in.items()}
    j_in = {n: args for n, (args, _) in j_in.items()}
    cpu = lambda v: (v.cpu() if torch.is_tensor(v)
                     else {k: cpu(x) for k, x in v.items()} if isinstance(v, dict) else v)
    torch.save({"J": {n: [cpu(a) for a in args] for n, args in j_in.items()},
                "F": {n: [cpu(a) for a in args] for n, args in f_in.items()},
                "P": {n: [cpu(a) for a in args] for n, args in p_in.items()},
                "E": {n: {k: cpu(v) for k, v in c.items()} for n, c in e_in.items()},
                "A": {n: [cpu(a) for a in args] for n, args in a_in.items()},
                "G": {n: [cpu(a) for a in args] for n, args in g_in.items()},
                "K": {n: [cpu(a) for a in args] for n, args in k_in.items()},
                "O": {n: [cpu(a) for a in args] for n, args in o_in.items()},
                "Q": {n: [cpu(a) for a in args] for n, args in q_in.items()},
                "H": {n: [cpu(a) for a in args] for n, args in h_in.items()},
                "C": {n: [cpu(a) for a in args] for n, args in c_in.items()},
                "M": {n: {k: [cpu(a) for a in v] if k == "args" else cpu(v)
                          for k, v in c.items()} for n, c in m_in.items()},
                "D": {n: [cpu(a) for a in args] for n, args in d_in.items()},
                "L": {n: [cpu(a) for a in args] for n, (args, _) in l_in.items()},
                "B": {n: [cpu(a) for a in args] for n, (args, _) in b_in.items()},
                "R": {n: [[cpu(a) for a in d] for d in dirs]
                      for n, dirs in rn.get("R", {}).items()},
                "N": {n: [cpu(a) for a in args] for n, args in rn.get("N", {}).items()},
                "W": {n: [cpu(a) for a in args] for n, args in wx.get("W", {}).items()},
                "X": {n: [cpu(a) for a in args] for n, args in wx.get("X", {}).items()},
                "V": {n: [cpu(a) for a in args] for n, args in wx.get("V", {}).items()}}, path)
    print(f"captured P {sorted(p_in)}: rows {p_in['paint_attribute'][0].shape[0]}; E "
          + ", ".join(f"{n} {tuple(c['q'].shape)} k={c['k']} bucket={c['bucket']}"
                      for n, c in e_in.items())
          + "; A " + ", ".join(f"{n} {tuple(a[0].shape)}" for n, a in a_in.items())
          + "; G " + ", ".join(f"{n} {tuple(a[0].shape)} active {int(a[-1].sum())}"
                              for n, a in g_in.items())
          + "; K " + ", ".join(f"{n} {tuple(a[1 if n.startswith('sao.') else 0].shape)} "
                              f"region {a[-1]}" for n, a in k_in.items())
          + "; J " + ", ".join(f"{n} {tuple(a[0].shape)} bs {a[4]}" for n, a in j_in.items())
          + "; F " + ", ".join(f"{n} {tuple(a[1].shape)}" for n, a in f_in.items())
          + "; O " + ", ".join(f"{n} {tuple(a[0].shape)} maxvals {sorted(set(a[2].tolist()))}"
                              for n, a in o_in.items())
          + "; Q " + ", ".join(f"{n} {tuple(a[0].shape)} {a[0].dtype}" for n, a in q_in.items())
          + "; H " + ", ".join(f"{n} R {a[0].shape[0]} N {a[1].shape[0]} x0, sx {a[2]}, {a[6]}"
                              for n, a in h_in.items())
          + "; C " + ", ".join(f"{n} {tuple(a[0].shape)} eom_bits {a[-1].get('eom_bits', 0)}"
                              for n, a in c_in.items())
          + "; M " + ", ".join(f"{n} {shapes(c)}" for n, c in m_in.items())
          + "; D " + ", ".join(f"{n} {tuple(a[0].shape)} grid {a[-1]}" for n, a in d_in.items())
          + "; L " + ", ".join(f"{n} {tuple(a[0].shape)} occupancy {tuple(a[1].shape)}"
                              for n, (a, _) in l_in.items())
          + "; B " + ", ".join(f"{n} {tuple(a[0].shape)} bs {a[3]}" for n, (a, _) in b_in.items())
          + "; R " + ", ".join(f"{n} rows {[d[7] for d in dirs]}"
                              for n, dirs in rn.get("R", {}).items())
          + "; N " + ", ".join(f"{n} {tuple(a[0].shape)} boundary {int(a[2].sum())} {a[-1]}"
                              for n, a in rn.get("N", {}).items())
          + "; W " + ", ".join(f"{n} {tuple(a[0].shape)} occupied {int(a[1].sum())}"
                              for n, a in wx.get("W", {}).items())
          + "; X " + ", ".join(f"{n} {tuple(a[2].shape)} valid {int(a[4].sum())} pad_rows {a[5]}"
                              for n, a in wx.get("X", {}).items())
          + "; V " + ", ".join(f"{n} {tuple(a[0].shape)} modes {a[5].shape[0]} res {a[6]} "
                              f"threshold {a[7]} p_max {a[8]} blocks with a patch "
                              f"{int((a[4] > 0).sum())}" for n, a in wx.get("V", {}).items()))


def entry_calls(pkg: dict, inputs: dict, kernels: str, device="cuda") -> dict:
    """name -> (kernel letter, a call of that entry on the captured inputs)
    for the entries of `kernels`, with the modules of one checkout."""
    pipeline, neighbors, hevc, cc = pkg["pipeline"], pkg["neighbors"], pkg["hevc"], pkg["cc"]
    normals, segmentation = pkg["normals"], pkg["segmentation"]
    coverage, reconstruct = pkg["coverage"], pkg["reconstruct"]
    recolor, smoothing, padding = pkg["recolor"], pkg["smoothing"], pkg["padding"]
    metrics = pkg["metrics"]
    on = lambda args: [a.to(device) if torch.is_tensor(a) else a for a in args]
    calls = {}
    if "P" in kernels:
        pix, layer, col, h, w = on(inputs["P"]["paint_attribute"])
        dilate = on(inputs["P"]["group_dilate"])
        gather = on(inputs["P"]["gather_decoded_colors"])
        val = col[:, 0].contiguous()
        g_pix, g_layer, a0, a1 = gather
        i0, i1 = (a[..., 0].to(torch.int32).contiguous() for a in (a0, a1))
        calls.update({
            "paint_attribute": lambda: pipeline.paint_attribute(pix, layer, col, h, w),
            "group_dilate": lambda: pipeline.group_dilate(*dilate),
            "gather_decoded_colors": lambda: pipeline.gather_decoded_colors(*gather),
            "paint_scalar": lambda: pipeline.paint_scalar(pix, layer, val, h, w),
            "gather_decoded_scalar": lambda: pipeline.gather_decoded_scalar(g_pix, g_layer, i0,
                                                                            i1),
        })
    if "E" in kernels:
        for name, c in inputs["E"].items():
            pos, q = c["pos"].to(device), c["q"].to(device)
            if name == "grid_knn_batch":
                grids = neighbors.build_grid_batch(pos, c["bits"])
                calls[name] = lambda g=grids, q=q, c=c: neighbors.knn_batch(g, q, c["k"],
                                                                            c["bucket"])
            else:
                grid = neighbors.build_grid(pos, c["bits"], c["cell_bits"])
                calls[name] = lambda g=grid, q=q, c=c: neighbors.knn(g, q, k=c["k"],
                                                                     bucket=c["bucket"])
    if "A" in kernels:
        for name, args in inputs["A"].items():
            calls[name] = lambda f=getattr(hevc, name), a=on(args): f(*a)
    if "G" in kernels:
        for name, args in inputs["G"].items():
            fn = cc.cc_round_voxel if name.startswith("cc_round_voxel") else cc.cc_labels_device
            calls[name] = lambda f=fn, a=on(args): f(*a)
    if "K" in kernels:
        for name, args in inputs["K"].items():
            *a, region = on(args)
            if name.startswith("sao_apply"):
                calls[name] = lambda a=a, r=region: hevc.sao_apply(*a, region=r)
            else:
                calls[name] = lambda a=a, r=region: sao_step(hevc, *a, r)
    if "J" in kernels:
        for name, args in inputs.get("J", {}).items():
            calls[name] = lambda a=on(args): hevc.motion_search(*a)
    if "F" in kernels:
        for name, args in inputs.get("F", {}).items():
            pos, idx, valid, orients, weights, lam, iters = on(args)
            stages = segment_stages(normals, segmentation, pos, idx, valid, orients, weights,
                                    lam, iters)
            calls[name] = lambda st=stages: st["segment.partition"](st["segment.orient"](
                st["segment.pca"]()))
            calls.update(stages)
    if "O" in kernels:
        for name, args in inputs.get("O", {}).items():
            calls[name] = lambda a=on(args): hevc.deblock_planes(*a)
    if "Q" in kernels:
        q = {n: on(a) for n, a in inputs.get("Q", {}).items()}
        for side in ("enc", "dec"):
            if f"color.{side}_to_planes" not in q:
                continue
            attr, rgb_args = q[f"color.{side}_to_planes"][0], q[f"color.{side}_to_rgb"]
            calls.update({
                f"color.{side}_to_planes": lambda a=attr: color_to_planes(hevc, a),
                f"color.{side}_to_rgb": lambda a=rgb_args: hevc._int_planes_to_rgb(*a),
                f"color.{side}_pair": lambda a=attr, r=rgb_args: (
                    *color_to_planes(hevc, a), hevc._int_planes_to_rgb(*r)),
            })
    if "H" in kernels:
        for name, args in inputs.get("H", {}).items():
            calls[name] = lambda a=on(args): coverage.covered_radius_slab(*a)
    if "C" in kernels:
        for name, (*args, kw) in inputs.get("C", {}).items():
            kw = {k: v.to(device) if torch.is_tensor(v) else v for k, v in kw.items()}
            calls[name] = lambda a=on(args), kw=kw: reconstruct.generate_points(*a, **kw)
    if "M" in kernels:
        for name, c in inputs.get("M", {}).items():
            c = {k: on(v) if k == "args" else v.to(device) if torch.is_tensor(v) else v
                 for k, v in c.items()}
            if name == "recolor.unit":
                c["order"], c["sk"] = recolor.sorted_source_keys(c["src_pos"], c["bits"])
                calls[name] = lambda c=c: m_unit(recolor, c)
                if hasattr(recolor, "exact_compact"):
                    # the unit's two entries apart
                    ex = recolor.exact_compact(c["order"], c["sk"], c["src_pos"], c["tgt"],
                                               c["bits"])
                    calls["recolor.exact"] = lambda c=c: recolor.exact_compact(
                        c["order"], c["sk"], c["src_pos"], c["tgt"], c["bits"])
                    calls["recolor.blend"] = lambda c=c, ex=ex: recolor.blend_merge(
                        c["src_col"], ex[0], ex[1], ex[2], c["idx"], c["d2"], ex[4], c["tidx"],
                        c["td2"], *c["gates"])
            elif name == "recolor.call":
                calls[name] = lambda c=c: recolor.transfer_colors_compact(
                    c["src_pos"], c["src_col"], c["tgt"], **c["kw"])
            elif name == "recolor.vox11":
                calls[name] = lambda c=c: m_vox11_unit(recolor, c)
            else:
                fn = recolor.exact_match_batch if name.endswith("exact") else recolor.blend_batch
                calls[name] = lambda f=fn, a=c["args"]: f(*a)
    if "D" in kernels:
        for name, (*args, kw) in inputs.get("D", {}).items():
            calls[name] = lambda a=on(args), kw=kw: smoothing.grid_smooth(*a, **kw)
    if "L" in kernels:
        for name, args in inputs.get("L", {}).items():
            calls[name] = lambda a=on(args): padding.push_pull_round(*a)
    if "B" in kernels:
        for name, args in inputs.get("B", {}).items():
            calls[name] = lambda a=on(args): hevc.half_pel_mc(*a)
    if "R" in kernels:
        for name, dirs in inputs.get("R", {}).items():
            calls[name] = r_unit(metrics, [on(d) for d in dirs])
    if "N" in kernels:
        for name, (*args, kw) in inputs.get("N", {}).items():
            a = on(args)
            calls[name] = lambda a=a, kw=kw: smoothing.presmooth_colors(*a, **kw)
            calls["presmooth.vote"] = n_vote(smoothing, neighbors, a, kw)[0]
    if "W" in kernels:
        for name, args in inputs.get("W", {}).items():
            planes, occ = on(args)
            flat = planes.reshape(-1, *planes.shape[-2:])
            if name.startswith("bg_harmonic."):
                calls[name] = lambda p=planes, o=occ: padding.fill_rgb(p, o, 2)
                calls["bg_harmonic.harmonic"] = lambda p=flat, o=occ: padding.harmonic_fill(p, o)
                continue
            calls[name] = lambda p=planes, o=occ: padding.fill_rgb(p, o, 0)
            calls["bg_dilate.dilate"] = lambda p=flat, o=occ: (
                lambda r: (r[0], torch.tensor([r[1]])))(padding.dilate_fill(p, o))
    if "V" in kernels:
        for name, args in inputs.get("V", {}).items():
            # the Rdo fields, its inexact count as a tensor (on the host
            # or the card, as the checkout returns them)
            calls[name] = lambda a=on(args): (lambda r: (*r[:3], torch.tensor([r[3]])))(
                pkg["plr"].rdo(*a))
    if "X" in kernels:
        for name, (*args, pad) in inputs.get("X", {}).items():
            calls[name] = lambda a=on(args), pad=pad: (
                normals.orient_normals_spanning_tree(*a, pad_rows=pad),
                torch.tensor([normals.last_flood_sweeps]))
    letter = {n: "P" for n in calls}
    for k in "EAGKJOQHCMDLBRNWXV":
        letter.update({n: k for n in inputs.get(k, {}) if n in calls})
    letter.update({n: "M" for n in calls if n.startswith("recolor.")})
    letter.update({n: "F" for n in calls if n.startswith("segment.")})
    letter.update({n: "Q" for n in calls if n.startswith("color.")})
    letter.update({n: "N" for n in calls if n.startswith("presmooth.")})
    letter.update({n: "W" for n in calls if n.startswith(("bg_dilate.", "bg_harmonic."))})
    return {n: (letter[n], fn) for n, fn in calls.items()}


def md5_views(inputs: dict, device="cuda") -> dict:
    """entry -> the part of its output whose md5 both sides share: R's
    exact fields (the maximum d2, the D1 sum); N's voted rows (a vote that
    writes into a copy of the colors returns the whole copy)."""
    views = {"metrics.unit": lambda r: r[:, :2]}
    call = inputs.get("N", {}).get("presmooth.call")
    if call is not None:
        bidx = torch.nonzero(call[2]).flatten().to(device)
        views["presmooth.vote"] = lambda o: o[bidx] if o.shape[0] == call[1].shape[0] else o
    return views


def color_to_planes(hevc, attr):
    """Kernel Q's RGB -> (y (1, H, W), chroma (1, 2, H/2, W/2)) with one
    checkout's wrappers, as the codec's callers use it: `rgb_to_planes`, or
    where a checkout has none, `_rgb_to_int_planes` and the stack of cb and
    cr its callers made."""
    if hasattr(hevc, "rgb_to_planes"):
        return hevc.rgb_to_planes(attr)
    y, cb, cr = hevc._rgb_to_int_planes(attr)
    return y[None], torch.stack([cb, cr])[None]


def segment_stages(normals, segmentation, pos, idx, valid, orients, weights, lam, iters) -> dict:
    """Kernel F's three stages of the encoder's chain as calls of one
    checkout: PCA (returns the normals), orientation (of given normals;
    the PCA's normals when called without), and the initial + refined
    partition (of given oriented normals)."""
    rows = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    pca = normals.pca_normals(pos, idx, valid)
    oriented = normals.orient_normals(pos, pca, idx, valid, rows)

    def partition(nrm=oriented):
        if hasattr(segmentation, "segment_partitions"):
            return segmentation.segment_partitions(nrm, orients, weights, idx, valid, lam,
                                                   iters)
        p0 = segmentation.initial_segmentation(nrm, orients, weights)
        return p0, segmentation.refine_segmentation(nrm, p0, idx, valid, orients, lam, iters)

    return {"segment.pca": lambda: normals.pca_normals(pos, idx, valid),
            "segment.orient": lambda nrm=pca: normals.orient_normals(pos, nrm, idx, valid,
                                                                      rows),
            "segment.partition": partition}


def md5(out) -> str:
    h = hashlib.md5()

    def add(t):
        if isinstance(t, tuple):
            for x in t:
                add(x)
        else:
            h.update(t.contiguous().cpu().numpy().tobytes())
    add(out)
    return h.hexdigest()


def kernel_trace(fn, reps: int) -> dict:
    """Device kernels of `reps` calls of fn under torch.profiler: kernel
    name (its first 80 characters; names that share them are summed) ->
    [device us a call, launches a call], and "device:total" -> [the sum,
    launches]; and the host's waits, "host:" + runtime call (stream
    synchronisations, copies) -> [CPU us a call, calls a call]."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("cuda") and ("Synchronize" in e.key or "Memcpy" in e.key):
            out["host:" + e.key] = [round(e.self_cpu_time_total / reps, 3), e.count / reps]
            continue
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            # the mean over the launches the trace kept, times the launches a
            # call (the trace can miss some of a cooperative kernel's records)
            n = max(1, round(e.count / reps))
            us, calls = out.get(e.key[:80], (0.0, 0.0))
            out[e.key[:80]] = [round(us + t / e.count * n, 3), calls + e.count / reps]
    dev_items = [v for k, v in out.items() if not k.startswith("host:")]
    out["device:total"] = [round(sum(v[0] for v in dev_items), 3),
                           sum(v[1] for v in dev_items)]
    return out


def kernel_timeline(fn, reps: int = 5) -> list:
    """The device kernels of one call of fn in launch order, as [name (its
    first 40 characters), device us (the median over `reps` calls)]."""
    import statistics

    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if "CUDA" in str(getattr(e, "device_type", "")) and e.time_range.elapsed_us() > 0
               and not e.name.startswith("Memcpy") and not e.name.startswith("Memset")]
        evs.sort(key=lambda e: e.time_range.start)
        per_call.append([(e.name[:40], e.time_range.elapsed_us()) for e in evs])
    n = min(len(c) for c in per_call)
    return [[per_call[0][i][0], round(statistics.median(c[i][1] for c in per_call), 3)]
            for i in range(n)]


def profile(inputs_path: Path, root: Path, runs: int, kernels: str,
            trace: bool = False, split: bool = False) -> dict:
    sys.path.insert(0, str(root))
    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.ops import (cc, coverage, metrics, neighbors, normals, padding, plr,
                                    reconstruct, recolor, segmentation, smoothing)
    from vpcc_tpu_torch.video import hevc

    if Path(pipeline.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {pipeline.__file__}, not the package under {root}")
    inputs = torch.load(inputs_path)
    calls = entry_calls({"pipeline": pipeline, "neighbors": neighbors, "hevc": hevc, "cc": cc,
                         "normals": normals, "segmentation": segmentation,
                         "coverage": coverage, "reconstruct": reconstruct, "recolor": recolor,
                         "smoothing": smoothing, "padding": padding, "metrics": metrics,
                         "plr": plr},
                        inputs, kernels)
    views = md5_views(inputs)
    res = {name: {"md5": md5(views.get(name, lambda o: o)(fn())), "call_ms": [],
                  "device_ms": []}
           for name, (_, fn) in calls.items()}
    from vpcc_tpu_torch import device as dev

    for name, (letter, fn) in calls.items():
        if letter == "R":
            res[name]["values"] = fn().tolist()
        torch.cuda.synchronize()
        before = dict(dev.LAUNCHES)
        fn()
        res[name]["launches"] = {k: v - before.get(k, 0) for k, v in dev.LAUNCHES.items()
                                 if v != before.get(k, 0)}
    for name, (*args, kw) in inputs.get("D", {}).items():
        if name in res:
            res[name]["zeroed_bytes"] = zeroed_bytes(args[0], kw.get("grid_size", 8),
                                                     kw.get("grid_bits", 10))
    for _ in range(runs):
        for name, (letter, fn) in calls.items():
            res[name]["call_ms"].append(time_ms(fn, REPS[letter]))
            if letter not in NO_GRAPH and name not in NO_GRAPH_ENTRIES:
                res[name]["device_ms"].append(graph_ms(fn, REPS[letter]))
    if trace:
        for name, (letter, fn) in calls.items():
            res[name]["kernels"] = kernel_trace(fn, REPS[letter])
            if letter in "WV":
                res[name]["timeline"] = kernel_timeline(fn)
    if split and "J" in kernels:
        for name, args in inputs.get("J", {}).items():
            res[name]["split_ms"] = motion_split(root, [a.cuda() if torch.is_tensor(a) else a
                                                        for a in args], runs)
    if split:
        for name, (letter, fn) in calls.items():
            if letter in "OQHCMDLBRNWXV":
                res[name]["host"] = host_split(fn, REPS[letter])
    if split and "B" in kernels:
        for name, args in inputs.get("B", {}).items():
            res[name]["phases"] = b_phase_split(hevc, [a.cuda() if torch.is_tensor(a) else a
                                                       for a in args])
    if split and hasattr(padding, "push_pull_plan") and ("L" in kernels or "B" in kernels):
        lv = variant_split(root, {n: c for n, c in calls.items() if c[0] in "LB"}, runs,
                           tuple(k for k, letter in (("push_pull", "L"), ("half_pel_mc", "B"))
                                 if letter in kernels))
        for name, v in lv.items():
            res[name]["variants"] = v
    if split and hasattr(recolor, "exact_compact") and ("M" in kernels or "D" in kernels):
        md = variant_split(root, {n: c for n, c in calls.items() if c[0] in "MD"}, runs,
                           ("recolor", "grid_smooth"))
        for name, v in md.items():
            res[name]["variants"] = v
    if split and "dirs" in inspect.signature(metrics.metrics_reduce).parameters and (
            "R" in kernels or "N" in kernels):
        rn = variant_split(root, {n: c for n, c in calls.items() if c[0] in "RN"}, runs,
                           tuple(k for k, letter in (("metrics", "R"), ("presmooth", "N"))
                                 if letter in kernels))
        for name, v in rn.items():
            res[name]["variants"] = v
    if split and hasattr(normals, "flood_scratch_words") and ("W" in kernels or "X" in kernels):
        wx = variant_split(root, {n: c for n, c in calls.items() if c[0] in "WX"}, runs,
                           tuple(k for k, letter in (("bg_fill", "W"), ("orient", "X"))
                                 if letter in kernels))
        for name, v in wx.items():
            res[name]["variants"] = v
    if split and hasattr(padding, "harmonic_scratch_floats") and "V" in kernels:
        for name, v in variant_split(root, {n: c for n, c in calls.items() if c[0] == "V"},
                                     runs, ("plr",)).items():
            res[name]["variants"] = v
    if split and hasattr(coverage, "column_table") and ("H" in kernels or "C" in kernels):
        hc = variant_split(root, {n: c for n, c in calls.items() if c[0] in "HC"}, runs,
                           ("coverage", "generate_points"))
        for name, v in hc.items():
            res[name]["variants"] = v
    return res


def b_phase_split(hevc, args, reps: int = 20) -> dict:
    """Kernel B on one call's inputs with every MV's phase (mvy & 1, mvx &
    1) forced to each of the four: the device ms of each (CUDA graph
    replay), beside the share of the call's CUs at each phase."""
    ref, mv, maxv, bs = args
    ph = ((mv[..., 0] & 1) * 2 + (mv[..., 1] & 1)).flatten()
    out = {"mix": {f"{k >> 1}{k & 1}": round(float((ph == k).float().mean()), 4)
                   for k in range(4)}}
    for fy, fx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        forced = (mv & ~1) | torch.tensor([fy, fx], dtype=torch.int32, device=mv.device)
        out[f"device_ms_{fy}{fx}"] = round(
            graph_ms(lambda m=forced: hevc.half_pel_mc(ref, m, maxv, bs), reps), 4)
    return out


def host_split(fn, reps: int) -> dict:
    """The host's side of a wrapper call: microseconds of host time a call
    over `reps` back-to-back calls without a synchronisation (a wrapper that
    waits on the card includes the wait), whether a call synchronises (one
    call under torch.cuda.set_sync_debug_mode("error")) and how often (the
    synchronisations one call reports under mode "warn")."""
    import time
    import warnings

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        sync = "no host synchronisation"
    except RuntimeError as e:
        sync = "raises: " + str(e).splitlines()[0][:160]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing" in str(w.message) for w in seen)
    return {"host_us": round(host_us, 3), "sync_debug_error": sync, "syncs_warn": syncs}


def host_parts(rec, reps: int = 200) -> dict:
    """Host microseconds of the steps a kernel wrapper may take, each alone:
    uploading the 54-entry tc table from a numpy array (a pageable copy and
    its stream synchronisation), setting a ctypes entry's nine argument
    types, allocating an output like `rec`, reading the current stream."""
    import ctypes
    import time

    import numpy as np

    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.video import hevc_tables as tab

    fn = getattr(ctypes.CDLL(str(dev._kernel_lib_path("deblock"))), "deblock")
    types = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def argtypes():
        fn.argtypes, fn.restype = types, ctypes.c_int

    steps = {"tc_table_upload": lambda: torch.as_tensor(np.asarray(tab.TC_TAB, np.int32),
                                                        device=rec.device),
             "set_argtypes": argtypes, "empty_like": lambda: torch.empty_like(rec),
             "stream_handle": dev.stream_handle}
    out = {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        out[name] = round((time.perf_counter() - t0) / reps * 1e6, 3)
        torch.cuda.synchronize()
    return out


def _host_us(step, reps: int = 200) -> float:
    """Host microseconds of one step (a wait it takes included)."""
    import time

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return round(us, 3)


def hc_host_parts(inputs: dict) -> dict:
    """Host microseconds of the steps around kernels H and C, each alone:
    per coverage round the upload of the packed resampled points from a host
    array (`torch.as_tensor(..., device="cuda")`, the encoder's) and the
    zero fill of a (sx * G * G / 32) int32 volume; for C's largest call,
    five output allocations, one allocation cut into the five fields, and
    reading one device int32 (`int(t)`)."""
    import numpy as np

    out = {}
    for name, args in inputs.get("H", {}).items():
        packed = np.ascontiguousarray(args[0].numpy())
        G = 1 << args[3]
        words = args[6] * G * max(G // 32, 1)
        out[f"{name}.upload"] = _host_us(lambda: torch.as_tensor(packed, device="cuda"))
        out[f"{name}.zero_volume"] = _host_us(
            lambda: torch.zeros(words, dtype=torch.int32, device="cuda"))
    calls = inputs.get("C", {})
    if calls:
        n = int(calls["generate_points.decode"][0].ne(0).sum())
        d = torch.device("cuda")

        def five():
            return (torch.empty((n, 3), dtype=torch.int32, device=d),
                    torch.empty((n, 2), dtype=torch.int32, device=d),
                    torch.empty(n, dtype=torch.int32, device=d),
                    torch.empty(n, dtype=torch.int32, device=d),
                    torch.empty(n, dtype=torch.bool, device=d))

        def one():
            buf = torch.empty(29 * n, dtype=torch.uint8, device=d)
            i32 = buf[:28 * n].view(torch.int32)
            return (i32[:3 * n].view(n, 3), i32[3 * n:5 * n].view(n, 2), i32[5 * n:6 * n],
                    i32[6 * n:], buf[28 * n:].view(torch.bool))

        scalar = torch.zeros(1, dtype=torch.int32, device=d)
        out.update({"generate_points.five_empty": _host_us(five),
                    "generate_points.one_empty_cut": _host_us(one),
                    "generate_points.read_int": _host_us(lambda: int(scalar))})
    return out


def lb_host_parts(inputs: dict) -> dict:
    """Host microseconds of kernel L's and B's wrappers and of their steps,
    each alone (a checkout with `padding.push_pull_plan`): the wrapper on
    the geometry and decode calls; its C entry called with arguments made
    beforehand (the launches and ctypes' conversions); the same entry with
    its argument types set again before each call; the output allocation;
    the checks of the arguments (and L's plan, masks and scratch
    lookups)."""
    import ctypes

    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.ops import padding
    from vpcc_tpu_torch.video import hevc

    out = {}
    on = lambda args: [a.cuda() if torch.is_tensor(a) else a for a in args]
    ref, mv, maxv, bs = on(inputs["B"]["half_pel_mc.decode"])
    P, H, W = ref.shape
    res = torch.empty_like(ref)
    fn = dev.kernel_fn("half_pel_mc", "half_pel_mc", hevc._MC_ARGS)
    args = [dev.ptr(ref), dev.ptr(mv), dev.ptr(maxv), dev.ptr(res), P, H, W, bs, W // bs,
            dev.stream_handle()]

    def set_and_call(f, types, a):
        f.argtypes, f.restype = types, ctypes.c_int
        return f(*a)

    out["B.wrapper"] = _host_us(lambda: hevc.half_pel_mc(ref, mv, maxv, bs))
    out["B.entry"] = _host_us(lambda: fn(*args))
    out["B.entry_setting_argtypes"] = _host_us(lambda: set_and_call(fn, hevc._MC_ARGS, args))
    out["B.empty_like"] = _host_us(lambda: torch.empty_like(ref))
    out["B.checks"] = _host_us(lambda: [dev.check_tensor(t, "t", torch.int32, ref.device)
                                        for t in (ref, mv, maxv)])
    img, occ = on(inputs["L"]["push_pull.geometry"])
    planes = img if img.ndim == 3 else img[None]
    Pl, Hl, Wl = planes.shape
    _, floats = padding.push_pull_plan(Pl, Hl, Wl, occ.ndim == 3, padding.PUSH_TOP_SMEM)
    scratch = dev.scratch("push_pull", img.device, floats)
    lres = torch.empty_like(planes)
    pair, unknown = padding.push_masks(Hl, Wl)
    lfn = dev.kernel_fn("push_pull", "push_pull", padding._PP_ARGS)
    largs = [dev.ptr(planes), dev.ptr(occ), dev.ptr(scratch), dev.ptr(lres), Pl,
             int(occ.ndim == 3), Hl, Wl, pair, unknown, padding.PUSH_TOP_SMEM,
             dev.ptr(padding._inexact_counter(img.device)) if unknown else padding._NULL,
             dev.stream_handle()]
    out["L.wrapper"] = _host_us(lambda: padding.push_pull_round(img, occ))
    out["L.entry"] = _host_us(lambda: lfn(*largs))
    out["L.entry_setting_argtypes"] = _host_us(lambda: set_and_call(lfn, padding._PP_ARGS, largs))
    out["L.empty_like"] = _host_us(lambda: torch.empty_like(planes))
    out["L.plan_masks_scratch"] = _host_us(lambda: (
        padding.push_pull_plan(Pl, Hl, Wl, occ.ndim == 3, padding.PUSH_TOP_SMEM),
        padding.push_masks(Hl, Wl), dev.scratch("push_pull", img.device, floats)))
    return out


def rn_host_parts(inputs: dict) -> dict:
    """Host microseconds of kernel R's and N's wrappers and of their steps,
    each alone (a checkout whose wrappers take a list of directions and
    `bidx`): R's unit (the wrapper and its host read), the wrapper alone,
    its tensor checks, its launch plan, its C entry called with arguments
    made beforehand, the host read of a result made beforehand; N's
    wrapper, its checks and its C entry."""
    import ctypes

    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.ops import metrics, neighbors, smoothing

    out = {}
    on = lambda args: [a.cuda() if torch.is_tensor(a) else a for a in args]
    dirs = [on(d) for d in inputs["R"]["metrics.unit"]]
    tensors = [(t, dt) for d in dirs for t, dt in zip(d[:7], (
        torch.int32, torch.uint8, torch.int32, torch.uint8, torch.float32, torch.int32,
        torch.int32)) if t is not None]
    res = metrics.metrics_reduce(dirs)
    counts = [d[7] for d in dirs]
    plan, blocks, part_off, lvl_off, nbytes = metrics.metrics_plan(counts)
    scratch = dev.scratch("metrics", res.device, -(-nbytes // 4))
    ptrs = (ctypes.c_void_p * 14)(*[None if t is None else t.data_ptr() for d in dirs
                                    for t in d[:7]])
    fn = dev.kernel_fn("metrics", "metrics_reduce", metrics._R_ARGS)
    args = [ptrs, (ctypes.c_int * len(plan))(*plan), blocks, dev.ptr(scratch), part_off,
            lvl_off, dev.ptr(res), dev.stream_handle()]
    out["R.unit"] = _host_us(lambda: metrics.metrics_reduce(dirs).cpu())
    out["R.wrapper"] = _host_us(lambda: metrics.metrics_reduce(dirs))
    out["R.checks"] = _host_us(lambda: [dev.check_tensor(t, "t", dt, res.device)
                                        for t, dt in tensors])
    out["R.plan"] = _host_us(lambda: metrics.metrics_plan(counts))
    out["R.entry"] = _host_us(lambda: fn(*args))
    out["R.read"] = _host_us(lambda: res.cpu())
    pos, colors, bnd, grid_bits, kw = on(inputs["N"]["presmooth.call"])
    bidx = torch.nonzero(bnd).flatten()
    nidx, nd2 = neighbors.knn(neighbors.build_grid(pos, grid_bits), pos[bidx].contiguous(),
                              k=kw["k"], bucket=6)
    gates = (kw["radius2"], kw["thr_dist"], kw["thr_entropy"])
    copy = colors.clone()
    nfn = dev.kernel_fn("presmooth", "presmooth_vote", smoothing._VOTE_ARGS)
    nargs = [dev.ptr(colors), dev.ptr(nidx), dev.ptr(nd2), dev.ptr(bidx),
             dev.ptr(smoothing.entropy_table(colors.device)), bidx.numel(), kw["k"],
             *gates, dev.ptr(copy), dev.stream_handle()]
    out["N.wrapper"] = _host_us(lambda: smoothing.presmooth_vote(colors, nidx, nd2, bidx, copy,
                                                                 *gates))
    out["N.checks"] = _host_us(lambda: [
        dev.check_tensor(t, "t", dt, colors.device)
        for t, dt in ((colors, torch.int32), (nidx, torch.int32), (nd2, torch.int32),
                      (bidx, torch.int64), (copy, torch.int32))])
    out["N.entry"] = _host_us(lambda: nfn(*nargs))
    return out


def _after(marker: str, k: int, text: str):
    """A source edit: `text` inserted after the k-th `marker`."""
    import re

    def edit(src):
        return (lambda at: src[:at] + text + src[at:])(
            [m.end() for m in re.finditer(re.escape(marker), src)][k])
    return edit


def _swap(old: str, new: str):
    """A source edit: `old` (which must be there) replaced by `new`."""
    def edit(src):
        if old not in src:
            raise RuntimeError(f"variant: {old!r} not in the source")
        return src.replace(old, new)
    return edit


# --split builds of kernels H and C: csrc/<kernel>.cu as it is ("whole"),
# cut after a stage (a `return` the compiler cannot drop), or edited
HC_VARIANTS = {
    "coverage": {
        "whole": None,
        "after_box": _after("grid.sync();", 0, " if (a.N > 0) return;"),
        "after_zero": _after("grid.sync();", 1, " if (a.N > 0) return;"),
        "after_scatter": _after("grid.sync();", 2, " if (a.N > 0) return;"),
        "after_dilate": _after("grid.sync();", 3, " if (a.N > 0) return;"),
        "bounds3": _swap("__launch_bounds__(kThreads, RMAX <= 3 ? 2 : 1)",
                         "__launch_bounds__(kThreads, RMAX <= 3 ? 3 : 1)"),
        "step1": _swap("return r <= 3 ? 2 : 1;", "return 1;"),
    },
    "generate_points": {
        "whole": None,
        "count_only": _after("  if (rows == 0) return;", 0, " if (n > 0) return;"),
        "emit_after_scan": _after("int r = block_scan(c, sh, &total);", 0, " if (n > 0) return;"),
        "emit_after_flags": _after("their space takes the pixel table", 0, "\n  if (n > 0) return;"),
        "emit_bounds3": _swap("__launch_bounds__(kThreads, 2) emit_kernel",
                              "__launch_bounds__(kThreads, 3) emit_kernel"),
        "pix8": _swap("constexpr int kThreads = 512;\nconstexpr int kPix = 4;",
                      "constexpr int kThreads = 256;\nconstexpr int kPix = 8;"),
    },
}
# --split builds of kernels M and D (a checkout with `recolor.exact_compact`):
# cut after a phase's grid barrier, the launch only ("empty": the call's host
# and launch cost), or edited
_CUT = " if (a.B > 0) return;"
HC_VARIANTS["recolor"] = {
    "whole": None,
    "empty": (_after("cg::this_grid();", 0, _CUT), _after("cg::this_grid();", 1, _CUT)),
    "exact_after_zero": _after("grid.sync();", 0, _CUT),
    "exact_after_search": _swap("if (!a.compact) return;", "if (a.B > 0) return;"),
    "exact_after_count": _after("grid.sync();", 2, _CUT),
    "blend_after_zero": _after("grid.sync();", 4, _CUT),
    "blend_after_splat": _after("grid.sync();", 5, _CUT),
    "samples1": _swap("constexpr int kSamples = 4096;", "constexpr int kSamples = 1;"),
    "blend_scalar": _swap("a.vec = k % 4 == 0", "a.vec = false && k % 4 == 0"),
    "blend_bounds2": _swap("__launch_bounds__(kThreads, 3)\n    blend_kernel",
                           "__launch_bounds__(kThreads, 2)\n    blend_kernel"),
    "blend_bounds4": _swap("__launch_bounds__(kThreads, 3)\n    blend_kernel",
                           "__launch_bounds__(kThreads, 4)\n    blend_kernel"),
}
HC_VARIANTS["grid_smooth"] = {
    "whole": None,
    "empty": _after("cg::this_grid();", 0, " if (a.M > 0) return;"),
    "after_box": _after("grid.sync();", 0, " if (a.M > 0) return;"),
    "after_zero": _after("grid.sync();", 1, " if (a.M > 0) return;"),
    "after_bin": _after("grid.sync();", 2, " if (a.M > 0) return;"),
    "no_match": _swap("__match_any_sync(0xFFFFFFFFu, cid)", "(1u << (threadIdx.x & 31))"),
    "bounds2": _swap("__launch_bounds__(kThreads, 3)\n    grid_smooth_kernel",
                     "__launch_bounds__(kThreads, 2)\n    grid_smooth_kernel"),
}
# --split builds of kernel L (a checkout with `padding.push_pull_plan`): whole, and
# the pull phase without rebuilding levels 2..t-1 (its output is garbage):
# the most that reading those levels back from phase 1 could save
HC_VARIANTS["push_pull"] = {
    "whole": None,
    "pull_no_rebuild": _swap("const int rebuilt = pull ? t - 1 : t;",
                             "const int rebuilt = pull ? 1 : t;"),
}
# and of kernel B: whole, and its window staged by a loop the compiler does
# not unroll (a load at a time)
HC_VARIANTS["half_pel_mc"] = {
    "whole": None,
    "staging_rolled": _swap("#pragma unroll  // every load of the thread in flight at once",
                            "#pragma unroll 1"),
}
# --split builds of kernels R and N (a checkout whose wrappers take a list of
# directions and `bidx`): whole, at a lower register cap (more blocks an SM);
# R with its row loop unrolled 8 times, cut after its rows (no levels, no
# last block), gathering B's row 0 for every row, or multiplying where it
# divides; N with no luma counts (each slot counts 1), with no entropy
# (every candidate replaced), four warps a block (the cuts' outputs are
# garbage)
HC_VARIANTS["metrics"] = {
    "whole": None,
    "minblocks6": _swap("__launch_bounds__(kThreads) metrics_kernel",
                        "__launch_bounds__(kThreads, 6) metrics_kernel"),
    "unroll8": _swap("#pragma unroll 4\n  for (int i = threadIdx.x; i < rows;",
                     "#pragma unroll 8\n  for (int i = threadIdx.x; i < rows;"),
    "no_division": _swap("__fdiv_rn(", "__fmul_rn("),
    "rows_only": _swap("tile_rows<false, false>(D, r0, rows, tile, s);\n  }\n  __syncthreads();",
                       "tile_rows<false, false>(D, r0, rows, tile, s);\n  }\n  __syncthreads();"
                       " if (D.n >= 0) return;"),
    "gather_row0": _swap("const long long j = D.idx[rc];", "const long long j = 0;"),
}
HC_VARIANTS["presmooth"] = {
    "whole": None,
    "minblocks6": _swap("__launch_bounds__(32 * kWarps)", "__launch_bounds__(32 * kWarps, 6)"),
    "minblocks8": _swap("__launch_bounds__(32 * kWarps)", "__launch_bounds__(32 * kWarps, 8)"),
    "no_counts": _swap("const int cnt = __popc(same[s][0] & v0) + __popc(same[s][1] & v1);",
                       "const int cnt = 1;"),
    "no_entropy": _swap("replace = entropy_below(t, n, thr_entropy, lane);",
                        "replace = t[0] >= 0.0f;"),
    "warps4": _swap("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
}
# --split builds of kernels W's dilation and X's flood: whole, the level
# walk with CTAs of 512 or 1024 threads (X: 512, and 16 reverse-list entries
# queued at once in place of 32), a cluster of 8 CTAs, and the walk cut (it
# returns at once: the seed, prep and finish launches alone; the output is
# garbage)
_STRIDE = "const int stride = gridDim.x * kLevelThreads;"
# "phases": the walk whole, the thread of item 0 summing %globaltimer
# nanoseconds between points of its level (each point waits on what it
# reads: the stall before it is the phase's) and printing the sums once
_CLOCK = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(now_));"
_T0 = (" unsigned long long ph_[6] = {0, 0, 0, 0, 0, 0}, now_ = 0, was_ = 0; " + _CLOCK
       + " was_ = now_;")


def _stamp(i: int) -> str:
    return f" if (vid == 0) {{ {_CLOCK} ph_[{i}] += now_ - was_; was_ = now_; }}"


def _print(what: str) -> str:
    return (f' if (vid == 0) printf("{what} phases ns: %llu %llu %llu %llu %llu %llu\\n", '
            "ph_[0], ph_[1], ph_[2], ph_[3], ph_[4], ph_[5]);")
HC_VARIANTS["bg_fill"] = {
    "whole": None,
    "threads512": _swap("kLevelThreads = 256;", "kLevelThreads = 512;"),
    "threads1024": _swap("kLevelThreads = 256;", "kLevelThreads = 1024;"),
    "cluster8": _swap("constexpr int kCluster = 16;", "constexpr int kCluster = 8;"),
    "no_levels": _after(_STRIDE, 0, " if (a.C > 0) { if (vid == 0) a.cnt[0] = a.cnt[1] = "
                                    "a.cnt[2] = 0; return; }"),
    # count read; the pixel's list entry; claims (stamps); values; append;
    # barrier
    "phases": (_after("  int k = 1;", 0, _T0), _after("if (n == 0) break;", 0, _stamp(0)),
               _swap("        neighbours(p, a.H, a.W, nb);\n        // one round trip",
                     "        neighbours(p, a.H, a.W, nb);" + _stamp(1) + "\n        // one round trip"),
               _swap("#include <cstdint>\n", "#include <cstdint>\n#include <cstdio>\n"),
               _after("const float den = fmaxf(wsum, 1.0f);", 0, _stamp(2)),
               _after("      warp_append(take, nb, a.cnt + (k + 1) % 3, nxt);", 0, _stamp(4)),
               _swap("    cg::this_cluster().sync();\n  }\n  if (vid == 0) {   // every",
                     "    cg::this_cluster().sync();" + _stamp(5) + "\n  }\n  if (vid == 0) {   // every"),
               _swap("        if (claim) {\n#pragma unroll\n          for (int j = 0; j < 4; ++j)\n"
                     "            if (pf[j] == kEmpty)",
                     _stamp(3) + "\n        if (claim) {\n#pragma unroll\n          for (int j = 0; "
                     "j < 4; ++j)\n            if (pf[j] == kEmpty)"),
               _swap("  if (vid == 0) {   // every counter", _print("W") + "\n  if (vid == 0) {   "
                     "// every counter")),
}
# and of kernel W's harmonic entry (a checkout with
# `padding.harmonic_scratch_floats`): its tile levels with no step (the
# pull and the write alone), its coarse launch with no step, the push of
# level 1 alone, the tile levels at four blocks an SM (the cuts' outputs
# are garbage)
HC_VARIANTS["bg_fill"].update({
    "tile_no_steps": _swap("for (int k = 0; k < ps.steps; ++k) {",
                           "for (int k = 0; k < 0; ++k) {"),
    "coarse_no_steps": _swap("for (int st = 0; st < a.steps; ++st) {",
                             "for (int st = 0; st < 0; ++st) {"),
    "push_level1": _swap("for (int l = 2; l <= a.t; ++l) {", "for (int l = 2; l <= 1; ++l) {"),
    "tile_bounds4": _swap("__launch_bounds__(kTileThreads, 3)", "__launch_bounds__(kTileThreads, 4)"),
})
# --split builds of kernel V's RDO: the blocks' launch without its modes,
# the patches' launch without its pools (the outputs are garbage)
HC_VARIANTS["plr"] = {
    "whole": None,
    "blocks_no_modes": _swap("  for (int m = 0; m < M; ++m) {\n    const int dmag",
                             "  for (int m = 0; m < 0; ++m) {\n    const int dmag"),
    "patches_no_pools": _swap("    if (q > 0) {\n      for (int i0 = 0;",
                              "    if (q < 0) {\n      for (int i0 = 0;"),
    "blocks_bounds1": _swap("__launch_bounds__(1024, 2) rdo_blocks_kernel",
                            "__launch_bounds__(1024) rdo_blocks_kernel"),
    "patch_threads256": _swap("constexpr int kPatchThreads = 1024;",
                              "constexpr int kPatchThreads = 256;"),
}
HC_VARIANTS["orient"] = {
    "whole": None,
    "threads512": _swap("kLevelThreads = 256;", "kLevelThreads = 512;"),
    "chunk16": _swap("constexpr int kChunk = 32;", "constexpr int kChunk = 16;"),
    "cluster8": _swap("constexpr int kCluster = 16;", "constexpr int kCluster = 8;"),
    "no_levels": _after(_STRIDE, 0, " if (a.V > 0) return;"),
    # count read; the row's stamp (and its lists); the vote's gathers;
    # nothing; queueing and append; barrier
    "phases": (_swap("#include <cstdint>\n", "#include <cstdint>\n#include <cstdio>\n"),
               _after("  int sweeps = 0;", 0, _T0), _after("if (n == 0) break;", 0, _stamp(0)),
               _after("        if (sr == kUnset) {", 0, _stamp(1)),
               _swap("          if (fabsf(vote) > 1e-6f) {",
                     _stamp(2) + "\n          if (fabsf(vote) > 1e-6f) {"),
               _swap("    cluster.sync();\n    if (__ldcg(a.hdr + 3 + t % 3) == 0) break;",
                     _stamp(4) + "\n    cluster.sync();" + _stamp(5)
                     + "\n    if (__ldcg(a.hdr + 3 + t % 3) == 0) break;"),
               _swap("  if (vid == 0) a.hdr[6] = sweeps;",
                     _print("X") + "\n  if (vid == 0) a.hdr[6] = sweeps;")),
}
HC_ENTRIES = {"recolor": ("recolor_exact_compact", "recolor_blend_merge"),
              "bg_fill": ("bg_dilate", "bg_harmonic"), "orient": ("flood",), "plr": ("plr_rdo",),
              "push_pull": ("push_pull",), "half_pel_mc": ("half_pel_mc",),
              "grid_smooth": ("grid_smooth",),
              "coverage": ("coverage",),
              "generate_points": ("generate_points_count", "generate_points_emit"),
              "metrics": ("metrics_reduce",), "presmooth": ("presmooth_vote",)}


def _or_error(fn):
    """fn(), or the first line of what it raised (a cut build leaves its
    outputs undefined, and a wrapper may refuse what follows from them)."""
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        return "raised: " + str(e).splitlines()[0][:120]


KERNEL_LETTER = {"bg_fill": "W", "orient": "X", "plr": "V",
                 "coverage": "H", "generate_points": "C", "recolor": "M", "grid_smooth": "D",
                 "push_pull": "L", "half_pel_mc": "B", "metrics": "R", "presmooth": "N"}


def variant_split(root: Path, calls: dict, runs: int, kernels: tuple) -> dict:
    """Kernels `kernels` (of H, C, M, D, L and B) built as HC_VARIANTS says (one
    nvcc each, all started together) and swapped into the checkout's wrappers
    (`device.kernel_fn`'s table), each run on the captured calls of its
    kernel: per call and variant, the device kernels' us a call
    (`kernel_trace`), the md5 of the output (a cut build's is garbage) and
    the build's ptxas lines."""
    import ctypes
    import tempfile

    from vpcc_tpu_torch import device as dev

    out_dir = Path(tempfile.mkdtemp(prefix="hc_split_"))
    procs = {}
    for kern in kernels:
        variants = HC_VARIANTS[kern]
        src = (root / "vpcc_tpu_torch" / "csrc" / f"{kern}.cu").read_text()
        for label, edit in variants.items():
            cu = out_dir / f"{kern}_{label}.cu"
            text = src
            try:
                for e in (edit if isinstance(edit, tuple) else (edit,)):
                    text = text if e is None else e(text)
            except RuntimeError:   # a variant of another checkout's source
                continue
            cu.write_text(text)
            lib = out_dir / f"lib{kern}_{label}.so"
            procs[(kern, label)] = (lib, subprocess.Popen(
                [dev.nvcc_path(), *dev.NVCC_FLAGS, *dev.KERNELS[kern],
                 "-I", str(root / "vpcc_tpu_torch" / "csrc"), "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for (kern, label), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {kern} {label}: nvcc failed\n{log}")
        saved = {e: dev.kernel_fn(kern, e, []) for e in HC_ENTRIES[kern]
                 if hasattr(dev.load_kernel(kern), e)}
        cdll = ctypes.CDLL(str(lib))
        for e, fn in saved.items():
            v = getattr(cdll, e)
            v.argtypes, v.restype = fn.argtypes, ctypes.c_int
            dev._fns[(kern, e)] = v
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        try:
            for name, (letter, fn) in calls.items():
                if letter == KERNEL_LETTER[kern]:
                    safe = lambda fn=fn: _or_error(fn)
                    out = safe()
                    res.setdefault(name, {})[label] = {
                        "kernels": kernel_trace(safe, REPS[letter]),
                        "call_ms": round(time_ms(safe, REPS[letter]), 4),
                        "md5": out if isinstance(out, str) else md5(out), "ptxas": ptxas}
        finally:
            dev._fns.update({(kern, e): fn for e, fn in saved.items()})
    return res


def motion_split(root: Path, args, runs: int) -> dict:
    """Kernel J's stages on `args`: the checkout's motion_search.cu built
    whole and cut after its 1st, 2nd and 3rd __syncthreads() (the cut is
    `if (W > 0) return;`, which the compiler cannot prove taken, so no
    stage before it is dropped); per build the median of `runs` timings of
    20 launches (CUDA events), in ms."""
    import ctypes
    import re
    import statistics
    import tempfile

    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.video import hevc

    src = (root / "vpcc_tpu_torch" / "csrc" / "motion_search.cu").read_text()
    body = src.index("__global__")
    syncs = [m.end() for m in re.finditer(r"__syncthreads\(\);", src) if m.start() > body]
    out_dir = Path(tempfile.mkdtemp(prefix="motion_split_"))
    src_p, ref_p, lam, maxv, bs = args
    P, H, W = src_p.shape
    nb = (H // bs) * (W // bs)
    mv = torch.empty((P, nb, 2), dtype=torch.int32, device=src_p.device)
    cost = torch.empty((P, nb), dtype=torch.float32, device=src_p.device)
    bits = torch.as_tensor(hevc._mv_bits(hevc.MV_RANGE), device=src_p.device)
    res = {}
    for label, cut in (("after_staging", 0), ("after_sad", 1), ("after_argmin", 2),
                       ("whole", None)):
        text = src if cut is None else (src[:syncs[cut]] + " if (W > 0) return;"
                                        + src[syncs[cut]:])
        cu = out_dir / f"{label}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{label}.so"
        subprocess.run([dev.nvcc_path(), *dev.NVCC_FLAGS, *dev.KERNELS["motion_search"], "-o",
                str(lib), str(cu)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).motion_search
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p], ctypes.c_int
        call = lambda fn=fn: fn(dev.ptr(src_p), dev.ptr(ref_p), dev.ptr(lam), dev.ptr(maxv),
                                dev.ptr(bits), dev.ptr(mv), dev.ptr(cost), P, H, W, bs,
                                dev.stream_handle())
        if call() != 0:
            raise RuntimeError(f"motion_split {label}: launch failed")
        res[label] = round(statistics.median(time_ms(call, 20) for _ in range(runs)), 4)
    return res


def frontier_stats(inputs: dict, device="cuda") -> dict:
    """The lists kernels W and X walk on the captured inputs, from the plain
    rules (PyTorch on the card): W's ring of each level (the empty pixels at
    4-connected torus distance k from the occupied ones, k = 1..passes), X's
    candidates of each sweep (unsigned valid rows with a valid neighbour
    signed in the sweep before) and the rows each signs.  Per walk: the
    levels, the sum, maximum and median of the list, and the levels whose
    list exceeds 4096, 8192 and 16384 items."""
    import statistics

    from vpcc_tpu_torch.ops import normals

    def summary(sizes):
        return {"levels": len(sizes), "sum": int(sum(sizes)), "max": int(max(sizes, default=0)),
                "median": statistics.median(sizes) if sizes else 0,
                **{f"over_{b}": sum(x > b for x in sizes) for b in (4096, 8192, 16384)}}

    out = {}
    for name, (planes, occ) in inputs.get("W", {}).items():
        filled = occ.to(device).bool()
        rings = []
        while len(rings) < 1024:
            near = (filled.roll(1, 0) | filled.roll(-1, 0) | filled.roll(1, 1)
                    | filled.roll(-1, 1)) & ~filled
            n = int(near.sum())
            if n == 0:
                break
            rings.append(n)
            filled |= near
        out[name] = {"rings": summary(rings), "first_rings": rings[:8]}
    for name, (pos, nrm, idx, valid_k, valid, pad) in inputs.get("X", {}).items():
        pos, nrm, idx, valid_k, valid = (a.to(device) for a in (pos, nrm, idx, valid_k, valid))
        seed, s0 = normals.flood_seed(pos, nrm, valid, pad)
        sign = torch.zeros(pos.shape[0], dtype=torch.float32, device=device)
        new = torch.zeros(pos.shape[0], dtype=torch.bool, device=device)
        if seed >= 0:
            sign[seed] = s0
            new[seed] = True
        cands, signed = [], []
        for _ in range(normals.FLOOD_MAX_SWEEPS):
            cand = (sign == 0) & valid & (new[idx.long()] & valid_k).any(1)
            vote = normals.flood_votes_plain(nrm, idx, valid_k, sign)
            new = (sign == 0) & valid & (vote.abs() > normals.FLOOD_VOTE_MIN)
            if not bool(new.any()):
                break
            cands.append(int(cand.sum()))
            signed.append(int(new.sum()))
            sign = torch.where(new, torch.where(vote < 0, -1.0, 1.0), sign)
        out[name] = {"candidates": summary(cands), "signed": summary(signed)}
    return out


def barriers(iters: int = 2000, runs: int = 5) -> dict:
    """The card's empty barriers in microseconds (`apps/barrier_probe.cu`):
    "grid.sync B x T" for cooperative grids of B blocks of T threads,
    "cluster.sync C x T" for one cluster of C CTAs, "syncthreads T" for one
    block, and "max_cluster T": the largest cluster of T-thread CTAs the
    card places."""
    import ctypes
    import statistics
    import tempfile

    from vpcc_tpu_torch import device as dev

    lib_path = Path(tempfile.mkdtemp(prefix="barrier_probe_")) / "libbarrier_probe.so"
    subprocess.run([dev.nvcc_path(), *dev.NVCC_FLAGS, "-o", str(lib_path),
                    str(Path(__file__).resolve().parent / "barrier_probe.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    for name, n in (("probe_grid", 5), ("probe_cluster", 5), ("probe_block", 4)):
        getattr(lib, name).argtypes = [ctypes.c_int] * (n - 2) + [ctypes.c_void_p] * 2
        getattr(lib, name).restype = ctypes.c_int
    lib.probe_max_cluster.argtypes, lib.probe_max_cluster.restype = [ctypes.c_int], ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def per_barrier(launch) -> float:
        def once(n):
            rc = launch(n)
            if rc != 0:
                raise RuntimeError(f"barrier probe: cudaError {rc}")
        once(iters)
        times = [(time_ms(lambda: once(iters), 1) - time_ms(lambda: once(0), 1)) * 1e3 / iters
                 for _ in range(runs)]
        return round(statistics.median(times), 4)

    st = dev.stream_handle
    out = {"sms": sms}
    for blocks in (16, sms // 2, sms, 2 * sms):
        for threads in (256, 1024):
            if blocks * threads <= 2048 * sms:
                out[f"grid.sync {blocks} x {threads}"] = per_barrier(
                    lambda n, b=blocks, t=threads: lib.probe_grid(b, t, n, dev.ptr(sink), st()))
    for threads in (256, 1024):
        out[f"max_cluster {threads}"] = lib.probe_max_cluster(threads)
        for cluster in (8, 16):
            out[f"cluster.sync {cluster} x {threads}"] = per_barrier(
                lambda n, c=cluster, t=threads: lib.probe_cluster(c, t, n, dev.ptr(sink), st()))
    for threads in (256, 1024):
        out[f"syncthreads {threads}"] = per_barrier(
            lambda n, t=threads: lib.probe_block(t, n, dev.ptr(sink), st()))
    return out


def summarize(paths) -> dict:
    """root -> entry -> {call and device: (q1, median, q3), runs, md5s
    agree} over the JSON lines in `paths`."""
    import statistics

    runs = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                for name, e in r["entries"].items():
                    acc = runs.setdefault(r["root"], {}).setdefault(
                        name, {"call_ms": [], "device_ms": [], "md5": set()})
                    acc["call_ms"] += e["call_ms"]
                    acc["device_ms"] += e["device_ms"]
                    acc["md5"].add(e["md5"])
    q = lambda v: tuple(round(x, 4) for x in statistics.quantiles(v, n=4)) if len(v) > 1 \
        else (v[0],) * 3 if v else None
    return {root: {name: {"call_ms": q(e["call_ms"]), "device_ms": q(e["device_ms"]),
                          "runs": len(e["call_ms"]), "md5_agree": len(e["md5"]) == 1,
                          "md5": sorted(e["md5"])[0]}
                   for name, e in entries.items()}
            for root, entries in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--capture", type=Path, help="encode and decode, save the inputs here")
    ap.add_argument("--inputs", type=Path, help="time the entries on these inputs")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose vpcc_tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--kernels", default="P,E,A,G,K,J,F,O,Q,H,C,M,D,L,B,R,N,W,X,V",
                    help="kernels whose entries are timed")
    ap.add_argument("--trace", action="store_true",
                    help="also each device kernel's time and launches a call")
    ap.add_argument("--split", action="store_true",
                    help="also kernel J's stages (builds cut after each barrier), and the "
                         "host time a call and host waits of O, Q, H, C, M, D, L, B, R "
                         "and N")
    ap.add_argument("--summarize", nargs="+", type=Path, help="logs of --inputs runs")
    ap.add_argument("--barriers", action="store_true",
                    help="time the card's empty grid, cluster and block barriers")
    a = ap.parse_args(argv)
    if a.summarize:
        for root, entries in summarize(a.summarize).items():
            for name, e in entries.items():
                print(f"{root} {name}: call ms (q1, median, q3) {e['call_ms']}, device ms "
                      f"{e['device_ms']}, {e['runs']} runs, md5 {e['md5']} "
                      f"{'agrees' if e['md5_agree'] else 'DIFFERS'} across runs")
        return 0
    if not torch.cuda.is_available():
        print("profile_entries: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    if a.barriers:
        sys.path.insert(0, str(ROOT))
        print(json.dumps({"card": smi, "barriers_us": barriers()}))
        return 0
    if a.capture:
        sys.path.insert(0, str(a.root))
        capture(a.capture, kernels=a.kernels)
        return 0
    if not a.inputs:
        ap.error("give --capture or --inputs")
    res = profile(a.inputs, a.root, a.runs, a.kernels, a.trace, a.split)
    out = {"root": str(a.root), "card": smi, "entries": res}
    if a.split and "O" in a.kernels:
        out["host_parts_us"] = host_parts(torch.load(a.inputs)["O"]["deblock.luma"][0].cuda())
    if a.split and ("W" in a.kernels or "X" in a.kernels):
        out["frontier"] = frontier_stats(torch.load(a.inputs))
    if a.split and ("H" in a.kernels or "C" in a.kernels):
        out["hc_host_parts_us"] = hc_host_parts(torch.load(a.inputs))
    if a.split and "L" in a.kernels and "B" in a.kernels and a.root.resolve() == ROOT:
        out["lb_host_parts_us"] = lb_host_parts(torch.load(a.inputs))
    if a.split and "R" in a.kernels and "N" in a.kernels and a.root.resolve() == ROOT:
        out["rn_host_parts_us"] = rn_host_parts(torch.load(a.inputs))
    built = [k for letter, k in (("M", "recolor"), ("D", "grid_smooth"), ("L", "push_pull"),
                                 ("B", "half_pel_mc"), ("R", "metrics"), ("N", "presmooth"),
                                 ("W", "bg_fill"), ("X", "orient"))
             if letter in a.kernels]
    if built:
        from vpcc_tpu_torch import device as dev

        out["ptxas"] = {k: [ln.strip() for ln in dev.BUILD_LOG.get(k, "").splitlines()
                            if "registers" in ln or "spill" in ln or "Compiling" in ln]
                        for k in built}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
