"""Where the decode time goes: stage split and device trace of one warm
decode of the committed vox10 fixture on CUDA.

    python -m vpcc_tpu_torch.apps.profile_decode [--reps=2]

Prints (1) a stage split from host clocks, each stage bracketed by
`torch.cuda.synchronize()` (so stages do not overlap; the sum is close to
the synchronised wall time), and (2) from `torch.profiler`, device time by
kernel name and the device's busy share of the wall time of an
unsynchronised warm decode.
"""

from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

import torch

from vpcc_tpu_torch.apps import profiling

FIXTURE = Path(__file__).resolve().parents[1] / "data" / "person_vox10_r3_gof8.vpcc"
NESTED = "  (within the stage above) "


def _stage_patches():
    """(module, attribute, stage name) of every function timed as a stage."""
    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.core import atlas
    from vpcc_tpu_torch.ops import reconstruct, smoothing
    from vpcc_tpu_torch.video import codecs, entropy, hevc

    return [
        (entropy, "decode_hevc32_plane", "host: video syntax entropy decode"),
        (entropy, "decode_mvs", "host: MV entropy decode"),
        (entropy, "decode_coeffs", "host: SAO params entropy decode"),
        (codecs, "decode_occupancy", "host: occupancy decode"),
        (atlas, "derive_block_to_patch", "host: block-to-patch"),
        (hevc, "half_pel_mc", "device: kernel B half_pel_mc"),
        (hevc, "wavefront_decode32", "device: kernel A wavefront_decode32"),
        (hevc, "deblock_planes", "device: kernel O deblock"),
        (hevc, "sao_apply", "device: kernel K sao_apply"),
        (hevc, "_int_planes_to_rgb", "device: kernel Q YCbCr->RGB"),
        (hevc, "rgb_refs", "device: kernel Q RGB->YCbCr refs"),
        (reconstruct, "generate_points", "device: kernel C generate_points"),
        (smoothing, "grid_smooth", "device: kernel D grid_smooth"),
        (pipeline, "gather_decoded_colors", "device: kernel P gather"),
        (pipeline, "download_recon",
         "device->host: download, incl. duplicate removal"),
        (pipeline, "first_unique_rows", NESTED + "duplicate removal (torch)"),
    ]


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    reps = 2
    for a in argv:
        if a.startswith("--reps="):
            reps = int(a.split("=", 1)[1])
    if not torch.cuda.is_available():
        print("profile_decode: CUDA is not available", file=sys.stderr)
        return 2
    from vpcc_tpu_torch.decoder import Decoder

    stream = FIXTURE.read_bytes()
    Decoder(device="cuda").decode(stream)            # warm-up (builds, caches)
    torch.cuda.synchronize()

    acc = collections.defaultdict(float)
    t0 = time.perf_counter()
    with profiling.timed_stages(acc, _stage_patches()):
        for _ in range(reps):
            frames = Decoder(device="cuda").decode(stream)
    wall = (time.perf_counter() - t0) / reps
    n = len(frames)
    print(f"stage split (synchronised), per frame, {torch.cuda.get_device_name(0)}:")
    for name, s in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {s / reps / n * 1e3:9.2f} ms  {name}")
    staged = sum(v for k, v in acc.items() if not k.startswith(NESTED)) / reps / n
    print(f"  {staged * 1e3:9.2f} ms  sum of stages; wall {wall / n * 1e3:.2f} ms/frame "
          f"(rest: parsing, Python, allocation)")

    profiling.print_trace(
        *profiling.device_trace(lambda: Decoder(device="cuda").decode(stream)),
        f"one warm decode ({n} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
