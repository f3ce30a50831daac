"""Make the committed vox11 reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over two 11-bit
frames of the synthetic person (`make_person_cloud(bits=11,
n_samples=12_000_000)`, seeds 7 and 8: ~2.43M points, ~678k voxels a frame,
the scale of the CTC's S27/S28 sequences) with the bench's overrides at
geometry3dCoordinatesBitdepth=11, resolution=2047 and the CTC r3 QPs, and
writes

    vpcc_tpu_torch/data/person_vox11_reference.json
    vpcc_tpu_torch/data/person_vox11_partitions.npz

The JSON holds the seeds, the overrides, the source point counts and per
frame: the voxel count, the md5 of the segmentation's voxel k-NN (idx, d2;
k=16, bucket 6), of each patch round's CC labels (`cc_round_voxel`, -1 for
an inactive point), of the
patch list (`utils.checksum.patches_md5`) and of the coverage distances
(`_generate_patches_knn`'s dist2, float64), of the transferred and
pre-smoothed colors, of the reconstruction (points, in-order positions and
colors), and the JAX package's `compute_metrics` of that reconstruction
against the source (with `estimate_normals`, as bench.py measures); then
the stream's bytes, md5 and bytes per substream, the command and the
JAX-CPU wall seconds.  The npz holds each frame's refined voxel partitions
(int8, compressed), with which `chip_smoke.py` drives the port's patch
generation.

Run from the repository root (about 15 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_vox11_reference.py
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_make_smoke_stream import OVERRIDES as VOX10_OVERRIDES  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.ops import cc as cc_mod  # noqa: E402
from vpcc_tpu.ops import neighbors, recolor, smoothing  # noqa: E402
from vpcc_tpu.ops.metrics import compute_metrics, estimate_normals  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu_torch.utils.checksum import array_md5, patches_md5  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox11_reference.json"
PARTS = DATA / "person_vox11_partitions.npz"
SEEDS = [7, 8]
N_SAMPLES = 12_000_000
OVERRIDES = dict(VOX10_OVERRIDES, geometry3dCoordinatesBitdepth=11, resolution=2047)
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_vox11_reference.py")


def frame_digest(positions, colors) -> str:
    h = hashlib.md5()
    h.update(np.ascontiguousarray(positions, "<i4").tobytes())
    h.update(np.ascontiguousarray(colors, np.uint8).tobytes())
    return h.hexdigest()


def main() -> int:
    wall = {}
    t0 = time.perf_counter()
    frames = [make_person_cloud(bits=11, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    wall["make_frames"] = time.perf_counter() - t0
    print(f"points {[f.point_count for f in frames]}", flush=True)
    cfg = VPCCConfig()
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)

    rec = [dict() for _ in frames]
    parts = {}
    # encode_gof dispatches frame i + 1's segmentation while frame i encodes:
    # the k-NN is keyed by the dispatch, everything else by encode_frame
    state = {"frame": -1, "dispatched": -1, "in_segment": False}
    knns = {}
    enc = Encoder(cfg)
    spies = []

    def spy(obj, name, fn):
        spies.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    real_dispatch = enc.segment_dispatch

    def dispatch(pc):
        state["dispatched"] += 1
        state["in_segment"] = True
        try:
            return real_dispatch(pc)
        finally:
            state["in_segment"] = False

    real_knn = neighbors.knn

    def knn(grid, positions, queries, k, bucket=16, chunk=1 << 17):
        idx, d2 = real_knn(grid, positions, queries, k=k, bucket=bucket, chunk=chunk)
        if state["in_segment"]:
            knns[state["dispatched"]] = (idx, d2)
        return idx, d2

    real_fetch = enc.segment_fetch

    def fetch(futures):
        out = real_fetch(futures)
        part, nn_idx, nn_valid, point_vox, _, _ = out[1]
        n = out[2]
        nv = int(np.asarray(point_vox)[:n].max()) + 1
        f = state["frame"]
        idx, d2 = knns.pop(f)
        rec[f].update(voxels=nv, knn_idx_md5=array_md5(np.asarray(idx)[:nv], "<i4"),
                      knn_d2_md5=array_md5(np.asarray(d2)[:nv], "<i4"), cc_rounds_md5=[])
        parts[f"refined_{f}"] = np.asarray(part)[:nv].astype(np.int8)
        return out

    real_round = cc_mod.cc_round_voxel

    def cc_round(*a, **kw):
        out = real_round(*a, **kw)
        f = rec[state["frame"]]
        lab = np.asarray(out)[:frames[state["frame"]].point_count]
        # inactive points carry the voxel capacity: -1 here, so that a port
        # without padding hashes the same labels
        f["cc_rounds_md5"].append(array_md5(np.where(lab >= f["voxels"], -1, lab), "<i4"))
        return out

    real_gen = enc.generate_patches

    def gen(pc, partition, graph):
        patches, dist2 = real_gen(pc, partition, graph)
        rec[state["frame"]].update(patches=len(patches), patches_md5=patches_md5(patches),
                                   dist2_md5=array_md5(dist2, "<f8"),
                                   dist2_inf=int(np.isinf(dist2).sum()))
        return patches, dist2

    real_tc = recolor.transfer_colors

    def transfer(*a, **kw):
        out = real_tc(*a, **kw)
        count = int(a[4])
        rec[state["frame"]]["transfer_md5"] = array_md5(np.asarray(out)[:count], "<i4")
        return out

    real_ps = smoothing.presmooth_colors

    def presmooth(pos, col, count, *a, **kw):
        out = real_ps(pos, col, count, *a, **kw)
        rec[state["frame"]]["presmooth_md5"] = array_md5(np.asarray(out)[:int(count)], "<i4")
        return out

    real_frame = enc.encode_frame

    def encode_frame(*a, **kw):
        state["frame"] += 1
        return real_frame(*a, **kw)

    spy(enc, "encode_frame", encode_frame)
    spy(enc, "segment_dispatch", dispatch)
    spy(enc, "segment_fetch", fetch)
    spy(enc, "generate_patches", gen)
    spy(neighbors, "knn", knn)
    spy(cc_mod, "cc_round_voxel", cc_round)
    spy(recolor, "transfer_colors", transfer)
    spy(smoothing, "presmooth_colors", presmooth)
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        wall["encode"] = time.perf_counter() - t0
    finally:
        for obj, name, fn in reversed(spies):
            setattr(obj, name, fn)
    stats = [dataclasses.asdict(s) for s in enc.stats] if hasattr(enc, "stats") else []
    print(f"encoded: {len(stream)} bytes in {wall['encode']:.1f}s", flush=True)

    t0 = time.perf_counter()
    for f, src, r in zip(rec, frames, recons):
        nrm = estimate_normals(src.positions.astype(np.int32), grid_bits=11)
        m = compute_metrics(src.positions.astype(np.int32), src.colors,
                            r.positions.astype(np.int32), r.colors,
                            resolution=2047, src_normals=nrm, grid_bits=11)
        d = dataclasses.asdict(m)
        d["color_psnr"] = [float(x) for x in d["color_psnr"]]
        f["metrics"] = {k: (float(v) if not isinstance(v, list) else v) for k, v in d.items()}
        f["recon_points"] = r.point_count
        f["recon_md5"] = frame_digest(r.positions, r.colors)
    wall["metrics"] = time.perf_counter() - t0

    np.savez_compressed(PARTS, **parts)
    OUT.write_text(json.dumps({
        "seeds": SEEDS,
        "n_samples": N_SAMPLES,
        "overrides": OVERRIDES,
        "source_points": [f.point_count for f in frames],
        "frames": rec,
        "stream_bytes": len(stream),
        "stream_md5": hashlib.md5(stream).hexdigest(),
        "stream_stats": dict(enc.last_stream_stats),
        "stage_seconds": [{k: round(v, 2) for k, v in s.items() if k.endswith("_s")}
                          for s in stats],
        "metrics": ("vpcc_tpu.ops.metrics.compute_metrics(src, rec, resolution=2047, "
                    "src_normals=estimate_normals(src, grid_bits=11), grid_bits=11)"),
        "encoder": "vpcc_tpu.Encoder(cfg).encode_gof on the CPU",
        "command": COMMAND,
        "jax_cpu_wall_s": {k: round(v, 1) for k, v in wall.items()},
    }, indent=1) + "\n")
    print(f"wrote {OUT.name} and {PARTS.name}; JAX-CPU wall seconds "
          f"{ {k: round(v, 1) for k, v in wall.items()} }")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main())
