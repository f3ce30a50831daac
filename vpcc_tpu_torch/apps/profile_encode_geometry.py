"""Where the geometry encoder's time goes: stage split over the 8-frame
bench GOF and a device trace of one warm P-frame, on CUDA.

    python -m vpcc_tpu_torch.apps.profile_encode_geometry [--frames=8]

The frames are the bench content (`make_person_cloud(bits=10,
n_samples=3_000_000)`, seeds 7..), with the configuration of the committed
front-end reference data (CTC r3 geometry QP 24, 8-frame hierarchical RA
GOF, 1280x1280 atlas).  `Encoder.encode_gof_geometry` runs once to warm up,
then again with each stage bracketed by `torch.cuda.synchronize()` (stages
do not overlap; the kernels' wrappers are the stages of the video encoder),
and prints (1) the per-frame stage split from host clocks and (2) from
`torch.profiler`, device time by kernel name and the device's busy share of
the wall time of one warm, unsynchronised P-frame (frame 1: D0 with motion
search, D1 inter-layer).
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


def stage_patches():
    """(object, attribute, stage name) of every function timed as a stage."""
    from vpcc_tpu_torch import encoder, pipeline
    from vpcc_tpu_torch.ops import padding
    from vpcc_tpu_torch.video import codecs, hevc

    return [
        (encoder.Encoder, "encode_frame_front", "front end (segmentation .. block-to-patch)"),
        (codecs, "encode_occupancy", "host: occupancy payload"),
        (padding, "push_pull_round", "device: kernel L push_pull"),
        (hevc, "motion_search", "device: kernel J motion_search"),
        (hevc, "half_pel_mc", "device: kernel B half_pel_mc (MC plane)"),
        (hevc, "block_weights32", "device: RD block weights (torch)"),
        (hevc, "wavefront_encode32", "device: kernel I wavefront_encode32"),
        (hevc, "sao_search_apply", "device: kernel K sao_search_apply"),
        (hevc, "assemble_payload32", "host: entropy coding + payload assembly"),
        (pipeline, "reconstruct_frame", "device: reconstruction + smoothing (C, D)"),
    ]


def trace_p_frame(enc, frames, out, segs=None):
    """Device trace of frame 1 of a GOF already encoded by `enc` into `out`
    (its tree parent, frame 0, gives the patches and the D0 reference)."""
    streams = enc._new_streams()
    return profiling.device_trace(lambda: enc.encode_frame_geometry(
        frames[1], streams, prev_patches=out[0].front.patches,
        seg=None if segs is None else segs[1],
        temporal_refs={"geo": out[0].geo_dec[0]}, qp_offset_geo=1))


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    n_frames = 8
    for a in argv:
        if a.startswith("--frames="):
            n_frames = int(a.split("=", 1)[1])
    if not torch.cuda.is_available():
        print("profile_encode_geometry: CUDA is not available", file=sys.stderr)
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
    Encoder(cfg, device="cuda").encode_gof_geometry(frames)     # warm-up
    torch.cuda.synchronize()

    acc = collections.defaultdict(float)
    enc = Encoder(cfg, device="cuda")
    t0 = time.perf_counter()
    with profiling.timed_stages(acc, stage_patches()):
        out = enc.encode_gof_geometry(frames)
    wall = time.perf_counter() - t0
    n = len(frames)
    print(f"stage split (synchronised), per frame, {torch.cuda.get_device_name(0)}:")
    for name, s in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {s / n * 1e3:9.2f} ms  {name}")
    staged = sum(acc.values()) / n
    print(f"  {staged * 1e3:9.2f} ms  sum of stages; wall {wall / n * 1e3:.2f} ms/frame "
          f"(rest: Python, syntax downloads, plane uploads, tiling)")
    if n > 1:
        profiling.print_trace(*trace_p_frame(enc, frames, out), "one warm P-frame (frame 1)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
