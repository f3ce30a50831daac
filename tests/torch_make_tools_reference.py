"""Make the committed reconstruction-tools reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over the first two
bench frames (`make_person_cloud(bits=10, n_samples=3_000_000)`, seeds 7
and 8) under three configurations, each one of the tools a stream signals
to the decoder, and writes

    vpcc_tpu_torch/data/person_vox10_tools_reference.json

* "cs": the bench's r3 overrides with flagColorSmoothing (the config's
  cgridSize 4 and thresholds 10 / 10 / 6);
* "pbf": the CTC r1 QPs (32 / 42) with occupancyPrecision 4, the CTC's
  precision for r1-r4, and pbfEnableFlag (auto: 2 passes, filter size 4,
  log2 threshold 2);
* "plr": the bench's r3 overrides with pointLocalReconstruction
  (plrlNumberOfModes 6, patchSize 9).

Per configuration it records the overrides, the stream's md5 and length, its
bytes per substream, `last_stream_stats` and the JAX-CPU wall seconds of
the encode and the decode; per frame the source point count, the patch
count, the digest of the encoder's reconstruction (in row order, after
duplicate removal) and of the JAX decoder's output, the md5 and the kept
pixel count of the PBF-filtered occupancy, the md5 of the PLR block-mode
map, and the md5 of the smoothed colors (the (N, 3) int32 rows of
`apply_color_smoothing_device`, before the download).  It also checks that
the JAX package segments frame 0 into the partitions committed in
person_vox10_front_partitions.npz (which drive the port in chip_smoke.py).

Run from the repository root (about 6 minutes on a CPU: 5.5 of them the
three encodes and decodes):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_tools_reference.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_make_lossless_reference import unit_bytes  # noqa: E402
from torch_make_smoke_stream import OVERRIDES as R3_OVERRIDES, frame_digest  # noqa: E402
from vpcc_tpu import pipeline  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox10_tools_reference.json"
PARTITIONS = DATA / "person_vox10_front_partitions.npz"
N_SAMPLES = 3_000_000
SEEDS = [7, 8]
CONFIGS = {
    "cs": dict(R3_OVERRIDES, flagColorSmoothing=1),
    "pbf": dict(R3_OVERRIDES, geometryQP=32, attributeQP=42, occupancyPrecision=4,
                pbfEnableFlag=1),
    "plr": dict(R3_OVERRIDES, pointLocalReconstruction=1),
}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_tools_reference.py")


def md5(a, dtype) -> str:
    return hashlib.md5(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


def run(name: str, overrides: dict, frames) -> dict:
    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    enc = Encoder(cfg)
    seen = {"pbf": [], "plr": [], "cs": []}
    parts = []
    real = (pipeline.apply_pbf_occupancy, pipeline.reconstruct_frame_device,
            pipeline.apply_color_smoothing_device)
    real_fetch = enc.segment_fetch

    def pbf_spy(*a, **kw):
        out = real[0](*a, **kw)
        occ = np.asarray(out).astype(np.uint8)
        seen["pbf"].append(dict(pbf_occ_md5=md5(occ, np.uint8), pbf_kept=int(occ.sum())))
        return out

    def recon_spy(*a, **kw):
        modes = kw.get("plr_modes")
        if modes is not None:
            seen["plr"].append(md5(modes, "<i4"))
        return real[1](*a, **kw)

    def cs_spy(recon, col, cfg_):
        out = real[2](recon, col, cfg_)
        if cfg_.flagColorSmoothing:
            seen["cs"].append(md5(np.asarray(out)[:recon.count], "<i4"))
        return out

    def fetch(futures):
        out = real_fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    pipeline.apply_pbf_occupancy = pbf_spy
    pipeline.reconstruct_frame_device = recon_spy
    pipeline.apply_color_smoothing_device = cs_spy
    enc.segment_fetch = fetch
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        t_enc = time.perf_counter() - t0
    finally:
        (pipeline.apply_pbf_occupancy, pipeline.reconstruct_frame_device,
         pipeline.apply_color_smoothing_device) = real
    t0 = time.perf_counter()
    decoded = Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    committed = np.load(PARTITIONS)["refined_0"]
    if not np.array_equal(parts[0][:len(committed)].astype(np.int8), committed):
        raise AssertionError(f"{name}: frame 0's partitions differ from the committed ones")
    out_frames = []
    for i, (f, e, rc, dc) in enumerate(zip(frames, enc.last_encoded, recons, decoded)):
        fd = dict(source_points=f.point_count, patches=len(e.patches),
                  recon_points=rc.point_count, recon_md5=frame_digest(rc.positions, rc.colors),
                  decoded_points=dc.point_count,
                  decoded_md5=frame_digest(dc.positions, dc.colors))
        if seen["pbf"]:
            fd.update(seen["pbf"][i])
        if seen["plr"]:
            fd["plr_modes_md5"] = seen["plr"][i]
        if seen["cs"]:
            fd["smoothed_colors_md5"] = seen["cs"][i]
        out_frames.append(fd)
        print(f"{name}: {fd}", flush=True)
    return dict(
        overrides=overrides, seeds=SEEDS, n_samples=N_SAMPLES,
        stream_md5=hashlib.md5(stream).hexdigest(), stream_bytes=len(stream),
        unit_bytes=unit_bytes(stream), stream_stats=enc.last_stream_stats,
        frames=out_frames, jax_cpu_encode_s=t_enc, jax_cpu_decode_s=t_dec,
    )


def main() -> int:
    frames = [make_person_cloud(bits=10, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    out = dict(command=COMMAND,
               configs={name: run(name, ov, frames) for name, ov in CONFIGS.items()})
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
