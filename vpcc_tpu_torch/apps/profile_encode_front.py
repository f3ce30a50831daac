"""Where the encoder front end's time goes: stage split over the 8-frame
bench GOF and a device trace of one warm frame, on CUDA.

    python -m vpcc_tpu_torch.apps.profile_encode_front [--frames=8]

The frames are the bench content (`make_person_cloud(bits=10,
n_samples=3_000_000)`, seeds 7..), with the configuration of the committed
front-end reference data.  Prints (1) a stage split from host clocks, each
stage bracketed by `torch.cuda.synchronize()` (stages do not overlap), and
(2) from `torch.profiler`, device time by kernel name and the device's busy
share of the wall time of one warm, unsynchronised frame.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

import torch

from vpcc_tpu_torch.apps import profiling

DATA = Path(__file__).resolve().parents[1] / "data"


def _stage_patches():
    """(object, attribute, stage name) of every function timed as a stage."""
    from vpcc_tpu_torch import encoder
    from vpcc_tpu_torch.core import atlas, packing
    from vpcc_tpu_torch.core.patch import Patch
    from vpcc_tpu_torch.ops import cc, coverage, neighbors, normals, voxelize

    return [
        (voxelize, "voxelize", "device: voxelize (torch)"),
        (neighbors, "build_grid", "device: k-NN grid build (torch)"),
        (neighbors, "knn", "device: kernel E grid_knn"),
        (normals, "pca_normals", "device: kernel F pca_normals"),
        (normals, "orient_normals", "device: kernel F orientation (centroid + sweeps)"),
        (encoder, "segment_partitions", "device: kernel F initial + refined partition"),
        (cc, "cc_labels_device", "device: kernel G cc_labels"),
        (cc, "round_stats", "device: round bookkeeping (torch)"),
        (coverage, "covered_radius_slab", "device: kernel H coverage"),
        (encoder.Encoder, "_build_components", "host: patches from components"),
        (Patch, "generate_points", "host: patch resampling"),
        (packing, "match_patches", "host: temporal patch matching"),
        (packing, "pack_flexible", "host: packing"),
        (atlas, "rasterize_frame", "host: rasterization (+ its block-to-patch)"),
    ]


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    n_frames = 8
    for a in argv:
        if a.startswith("--frames="):
            n_frames = int(a.split("=", 1)[1])
    if not torch.cuda.is_available():
        print("profile_encode_front: CUDA is not available", file=sys.stderr)
        return 2
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads((DATA / "person_vox10_front_digests.json").read_text())
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s)
              for s in ref["seeds"][:n_frames]]
    Encoder(cfg, device="cuda").encode_gof_front(frames)     # warm-up
    torch.cuda.synchronize()

    acc = collections.defaultdict(float)
    t0 = time.perf_counter()
    with profiling.timed_stages(acc, _stage_patches()):
        out = Encoder(cfg, device="cuda").encode_gof_front(frames)
    wall = time.perf_counter() - t0
    n = len(frames)
    occ = sum(o.stats.occupancy_s for o in out)
    acc["host: occupancy video + block-to-patch"] += occ
    print(f"stage split (synchronised), per frame, {torch.cuda.get_device_name(0)}:")
    for name, s in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {s / n * 1e3:9.2f} ms  {name}")
    staged = sum(acc.values()) / n
    print(f"  {staged * 1e3:9.2f} ms  sum of stages; wall {wall / n * 1e3:.2f} ms/frame "
          f"(rest: Python, host<->device copies, CC and component bookkeeping)")

    enc = Encoder(cfg, device="cuda")
    profiling.print_trace(*profiling.device_trace(lambda: enc.encode_frame_front(frames[0])),
                          "one warm frame (frame 0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
