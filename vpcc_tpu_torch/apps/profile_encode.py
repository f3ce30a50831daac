"""Where the whole encoder's time goes: stage split of `Encoder.encode_gof`
over the 8-frame bench GOF and a device trace of one warm P-frame, on CUDA.

    python -m vpcc_tpu_torch.apps.profile_encode [--frames=8] [--vox11]

The frames are the bench content (`make_person_cloud(bits=10,
n_samples=3_000_000)`, seeds 7..), with the configuration of the committed
front-end reference data (CTC r3, geometry QP 24, attribute QP 32, 8-frame
hierarchical RA GOF, 1280x1280 atlas), segmented by the encoder itself;
with --vox11, the two 11-bit frames of the committed vox11 reference data
(`make_person_cloud(bits=11, n_samples=12_000_000)`, seeds 7 and 8, the
same configuration at geometry3dCoordinatesBitdepth=11).
`Encoder.encode_gof` runs once to warm up, then again with each stage
bracketed by `torch.cuda.synchronize()` (stages do not overlap), and prints
(1) the per-frame stage split from host clocks and (2) from
`torch.profiler`, device time by kernel name and the device's busy share of
the wall time of one warm, unsynchronised P-frame (frame 1: D0 and T0
motion-searched against frame 0, D1 and T1 inter-layer).
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

import torch

from vpcc_tpu_torch.apps import profiling
from vpcc_tpu_torch.apps.profile_encode_geometry import stage_patches as geometry_stages

DATA = Path(__file__).resolve().parents[1] / "data"


def stage_patches():
    """(object, attribute, stage name) of every function timed as a stage
    (no stage calls another): the geometry encoder's stages (kernel L's
    also fills the attribute channels), then recolor, pre-smoothing, the
    attribute images, the attribute video's own stages and the mux."""
    from vpcc_tpu_torch import encoder, pipeline
    from vpcc_tpu_torch.ops import recolor, smoothing
    from vpcc_tpu_torch.video import hevc

    return geometry_stages() + [
        (recolor, "transfer_colors_compact",
         "device: recolor (kernel M, two kernel E sweeps, compaction)"),
        (recolor, "exact_matches", "host: exact matching (above 10 bits)"),
        (recolor, "transfer_colors",
         "device: recolor above 10 bits (kernel M over two kernel E sweeps)"),
        (smoothing, "presmooth_colors", "device: pre-smoothing (kernel E k=64, kernel N)"),
        (pipeline, "paint_attribute", "device: kernel P paint"),
        (pipeline, "group_dilate", "device: kernel P group dilation"),
        (pipeline, "gather_decoded_colors", "device: kernel P gather"),
        (hevc, "deblock_planes", "device: kernel O deblock"),
        (hevc, "rgb_to_planes", "device: kernel Q RGB->YCbCr"),
        (hevc, "_int_planes_to_rgb", "device: kernel Q YCbCr->RGB"),
        (pipeline, "download_recon", "device->host: download, incl. duplicate removal"),
        (encoder.Encoder, "_mux_gof", "host: V3C mux"),
    ]


def trace_p_frame(enc, frames, out, segs=None):
    """Device trace of frame 1 of a GOF already encoded by `enc` (`out` =
    `enc.last_encoded`; its frame 0 gives the patches and the D0 / T0
    references)."""
    streams = enc._new_streams()
    return profiling.device_trace(lambda: enc.encode_frame(
        frames[1], streams, prev_patches=out[0].patches,
        seg=None if segs is None else segs[1],
        temporal_refs={"geo": out[0].geometry.geo_dec[0],
                       "attr": out[0].attr_refs},
        qp_offset=4, qp_offset_geo=1))


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    n_frames = 8
    vox11 = "--vox11" in argv
    for a in argv:
        if a.startswith("--frames="):
            n_frames = int(a.split("=", 1)[1])
    if not torch.cuda.is_available():
        print("profile_encode: CUDA is not available", file=sys.stderr)
        return 2
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    if vox11:
        ref = json.loads((DATA / "person_vox11_reference.json").read_text())
        bits, n_samples = 11, ref["n_samples"]
    else:
        ref = json.loads((DATA / "person_vox10_front_digests.json").read_text())
        bits, n_samples = 10, 3_000_000
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    frames = [make_person_cloud(bits=bits, n_samples=n_samples, seed=s)
              for s in ref["seeds"][:n_frames]]
    Encoder(cfg, device="cuda").encode_gof(frames)     # warm-up
    torch.cuda.synchronize()

    acc = collections.defaultdict(float)
    enc = Encoder(cfg, device="cuda")
    t0 = time.perf_counter()
    with profiling.timed_stages(acc, stage_patches()):
        stream, _ = enc.encode_gof(frames)
    wall = time.perf_counter() - t0
    n = len(frames)
    print(f"stage split (synchronised), per frame, {torch.cuda.get_device_name(0)}; "
          f"stream {len(stream)} bytes {enc.last_stream_stats}:")
    for name, s in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {s / n * 1e3:9.2f} ms  {name}")
    staged = sum(v for k, v in acc.items() if not k.startswith("front end")) / n
    front = acc.get(geometry_stages()[0][2], 0.0) / n
    print(f"  {front * 1e3:9.2f} ms  front end; {staged * 1e3:.2f} ms the other stages; "
          f"wall {wall / n * 1e3:.2f} ms/frame (rest: Python, uploads, tiling, "
          "compaction, k-NN grid builds)")
    if n > 1:
        profiling.print_trace(*trace_p_frame(enc, frames, enc.last_encoded),
                              "one warm P-frame (frame 1)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
