"""Make the committed rate-distortion reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU and writes

    vpcc_tpu_torch/data/person_vox10_rd_reference.json

with, measured by the JAX package's `ops.metrics.compute_metrics` against
the regenerated source frames (seeds 7..14, `make_person_cloud(bits=10,
n_samples=3_000_000)`), with each source frame's `estimate_normals` as its
normals, as bench.py measures its RD curve:

* `fixture`: per frame, every `FrameMetrics` field of the JAX decoder's
  output on the committed r3 fixture (`person_vox10_r3_gof8.vpcc`; the
  script checks that it still decodes to the committed digests);
* `rates`: for r1 and r5, `Encoder(cfg).encode_gof` over the 8 bench frames
  with the fixture's overrides (`torch_make_smoke_stream.OVERRIDES`) and the
  CTC QPs of BASELINE.md (geometry/attribute: r1 32/42, r3 24/32, r5
  16/22; occupancy precision 2 at every rate, as bench.py sets it): stream
  bytes and md5, bytes per substream, per-frame metrics of the encoder's
  reconstruction and their means; r3 is the fixture (the script first
  checks that the JAX encoder still writes it byte for byte);
* the seeds, the command and the JAX-CPU wall seconds.

`chip_smoke.py` and `vpcc_tpu_torch.apps.bench` hold the port against it.
Run from the repository root (about 15 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_rd_reference.py
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

from torch_make_smoke_stream import DIGESTS, OVERRIDES, SEEDS, STREAM  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.ops.metrics import compute_metrics, estimate_normals  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402

OUT = ROOT / "vpcc_tpu_torch" / "data" / "person_vox10_rd_reference.json"
# CTC geometry / attribute QPs per rate point (BASELINE.md rate table)
RATE_QPS = {"r1": (32, 42), "r3": (24, 32), "r5": (16, 22)}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_rd_reference.py")


def rate_cfg(rate: str) -> VPCCConfig:
    cfg = VPCCConfig()
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)
    cfg.geometryQP, cfg.attributeQP = RATE_QPS[rate]
    return cfg


def frame_digest(positions, colors) -> str:
    h = hashlib.md5()
    h.update(np.ascontiguousarray(positions, "<i4").tobytes())
    h.update(np.ascontiguousarray(colors, np.uint8).tobytes())
    return h.hexdigest()


def measure(frames, normals, recons):
    """Per-frame FrameMetrics fields (as bench.py computes them) and the
    means of the PSNRs."""
    out = []
    for src, nrm, rec in zip(frames, normals, recons):
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            rec.positions.astype(np.int32), rec.colors,
            resolution=1023, src_normals=nrm, grid_bits=10,
        )
        d = dataclasses.asdict(m)
        d["color_psnr"] = [float(x) for x in d["color_psnr"]]
        d = {k: (float(v) if not isinstance(v, list) else v) for k, v in d.items()}
        d["points"] = rec.point_count
        out.append(d)
    mean = {
        "d1_db": float(np.mean([f["c2c_psnr"] for f in out])),
        "d2_db": float(np.mean([f["c2p_psnr"] for f in out])),
        "y_db": float(np.mean([f["color_psnr"][0] for f in out])),
        "u_db": float(np.mean([f["color_psnr"][1] for f in out])),
        "v_db": float(np.mean([f["color_psnr"][2] for f in out])),
    }
    return out, mean


def main() -> int:
    wall = {}
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in SEEDS]
    npts = [f.point_count for f in frames]
    t0 = time.perf_counter()
    normals = [estimate_normals(f.positions.astype(np.int32), grid_bits=10) for f in frames]
    wall["estimate_normals"] = time.perf_counter() - t0

    # r3: the JAX encoder still writes the fixture; the JAX decoder's output
    # on it is what the fixture's metrics measure
    fixture = STREAM.read_bytes()
    digests = json.loads(DIGESTS.read_text())
    t0 = time.perf_counter()
    enc = Encoder(rate_cfg("r3"))
    stream, _ = enc.encode_gof(frames)
    wall["encode_r3"] = time.perf_counter() - t0
    if stream != fixture:
        raise SystemExit("the JAX encoder's r3 stream differs from the committed fixture")
    r3_stats = dict(enc.last_stream_stats)
    t0 = time.perf_counter()
    decoded = Decoder().decode(fixture)
    wall["decode_fixture"] = time.perf_counter() - t0
    for pc, ref in zip(decoded, digests["frames"]):
        if pc.point_count != ref["points"] or frame_digest(pc.positions, pc.colors) != ref["md5"]:
            raise SystemExit("the JAX decoder's output differs from the committed digests")
    t0 = time.perf_counter()
    fix_frames, fix_mean = measure(frames, normals, decoded)
    wall["metrics_fixture"] = time.perf_counter() - t0
    print(f"fixture: {fix_mean}", flush=True)

    rates = {"r3": dict(qps=list(RATE_QPS["r3"]), stream_bytes=len(fixture),
                        stream_md5=hashlib.md5(fixture).hexdigest(),
                        stream_stats=r3_stats, frames=fix_frames, mean=fix_mean,
                        note="the committed fixture; frames as in `fixture`")}
    for rate in ("r1", "r5"):
        t0 = time.perf_counter()
        enc = Encoder(rate_cfg(rate))
        stream, recons = enc.encode_gof(frames)
        wall[f"encode_{rate}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_frame, mean = measure(frames, normals, recons)
        wall[f"metrics_{rate}"] = time.perf_counter() - t0
        rates[rate] = dict(qps=list(RATE_QPS[rate]), stream_bytes=len(stream),
                           stream_md5=hashlib.md5(stream).hexdigest(),
                           stream_stats=dict(enc.last_stream_stats), frames=per_frame,
                           mean=mean)
        print(f"{rate}: {len(stream)} bytes, {mean}", flush=True)
    for r in rates.values():
        r["bpp"] = r["stream_bytes"] * 8 / sum(npts)

    OUT.write_text(json.dumps({
        "seeds": SEEDS,
        "source_points": npts,
        "overrides": OVERRIDES,
        "rate_qps": {k: list(v) for k, v in RATE_QPS.items()},
        "occupancyPrecision": OVERRIDES["occupancyPrecision"],
        "metrics": ("vpcc_tpu.ops.metrics.compute_metrics(src, rec, resolution=1023, "
                    "src_normals=estimate_normals(src, grid_bits=10), grid_bits=10)"),
        "encoder": "vpcc_tpu.Encoder(cfg).encode_gof on the CPU",
        "command": COMMAND,
        "jax_cpu_wall_s": {k: round(v, 1) for k, v in wall.items()},
        "fixture": {"frames": fix_frames, "mean": fix_mean},
        "rates": rates,
    }, indent=1) + "\n")
    print(f"wrote {OUT.name}; JAX-CPU wall seconds "
          f"{ {k: round(v, 1) for k, v in wall.items()} }")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main())
