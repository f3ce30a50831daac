"""Make the committed reference data of the two-level (16/8) video codec
for the PyTorch port: 11-bit geometry planes (geometryNominal2dBitdepth=11).

Not a test: a helper that runs the JAX package on the CPU over the two
vox11 frames (`make_person_cloud(bits=11, n_samples=12_000_000)`, seeds 7
and 8, the frames of `tests/torch_make_vox11_reference.py`) with the same
overrides plus geometryNominal2dBitdepth=11, so that patch depths up to 2047
reach the geometry video and every geometry plane (maxval 2047) goes through
the two-level codec, and writes

    vpcc_tpu_torch/data/person_vox11_geo11_reference.json

with the seeds, the overrides, the stream's bytes, md5 and bytes per
substream; per frame the reconstruction's point count and digest (in-order
int32 positions and uint8 colors), the flags byte, length and md5 of its D0
and D1 geometry payloads (FLAG_SAO16 set, FLAG_CU32 clear), the samples
above 1023 in the D0 and D1 maps the geometry encoder codes (of all samples
and of the occupied ones), and the JAX package's `compute_metrics` of the
reconstruction against the source (with `estimate_normals`, as bench.py
measures); the means of D1, D2 and Y over the frames; the command and the
JAX-CPU wall seconds.  The segmentation does not depend on the 2D bit
depth: the script checks that its refined partitions equal the committed
`person_vox11_partitions.npz`, which `chip_smoke.py` uses to drive the
port.

Run from the repository root (about 18 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_geo11_reference.py
"""

from __future__ import annotations

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

from torch_make_vox11_reference import N_SAMPLES, SEEDS, frame_digest  # noqa: E402
from torch_make_vox11_reference import OVERRIDES as VOX11_OVERRIDES  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.ops.metrics import compute_metrics, estimate_normals  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu.video import codecs  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox11_geo11_reference.json"
PARTS = DATA / "person_vox11_partitions.npz"
OVERRIDES = dict(VOX11_OVERRIDES, geometryNominal2dBitdepth=11)
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_geo11_reference.py")


def main() -> int:
    wall = {}
    t0 = time.perf_counter()
    frames = [make_person_cloud(bits=11, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    wall["make_frames"] = time.perf_counter() - t0
    print(f"points {[f.point_count for f in frames]}", flush=True)
    cfg = VPCCConfig()
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)
    committed = np.load(PARTS)

    rec = [dict(geo_flags=[], geo_bytes=[], geo_md5=[], above_1023=[], above_1023_occupied=[])
           for _ in frames]
    state = {"frame": -1, "fetched": 0}
    enc = Encoder(cfg)
    spies = []

    def spy(obj, name, fn):
        spies.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    real_fetch = enc.segment_fetch

    def fetch(futures):
        out = real_fetch(futures)
        part, point_vox, n = out[1][0], out[1][3], out[2]
        nv = int(np.asarray(point_vox)[:n].max()) + 1
        want = committed[f"refined_{state['fetched']}"]
        if not np.array_equal(np.asarray(part)[:nv].astype(np.int8), want):
            raise SystemExit(f"frame {state['fetched']}: the refined partitions differ from "
                             f"{PARTS.name}")
        state["fetched"] += 1
        return out

    real_frame = enc.encode_frame

    def encode_frame(*a, **kw):
        state["frame"] += 1
        return real_frame(*a, **kw)

    real_geo = codecs.GeometrySubstreamEncoder.encode

    def geo_encode(self, geo, occ=None, *a, **kw):
        g = np.asarray(geo)
        f = rec[state["frame"]]
        f["above_1023"].append(int((g > 1023).sum()))
        if occ is not None:
            f["above_1023_occupied"].append(int(((g > 1023) & (np.asarray(occ) != 0)).sum()))
        payload, dec = real_geo(self, geo, occ, *a, **kw)
        if kw.get("defer"):
            fin = payload

            def payload():
                out = fin()
                note(f, out)
                return out
        else:
            note(f, payload)
        return payload, dec

    def note(f, payload):
        f["geo_flags"].append(payload[1 + 5])
        f["geo_bytes"].append(len(payload))
        f["geo_md5"].append(hashlib.md5(payload).hexdigest())

    spy(enc, "encode_frame", encode_frame)
    spy(enc, "segment_fetch", fetch)
    spy(codecs.GeometrySubstreamEncoder, "encode", geo_encode)
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        wall["encode"] = time.perf_counter() - t0
    finally:
        for obj, name, fn in reversed(spies):
            setattr(obj, name, fn)
    if state["fetched"] != len(frames):
        raise SystemExit(f"{state['fetched']} segmentations checked, not {len(frames)}")
    print(f"encoded: {len(stream)} bytes in {wall['encode']:.1f}s", flush=True)

    t0 = time.perf_counter()
    for f, src, r in zip(rec, frames, recons):
        nrm = estimate_normals(src.positions.astype(np.int32), grid_bits=11)
        m = compute_metrics(src.positions.astype(np.int32), src.colors,
                            r.positions.astype(np.int32), r.colors,
                            resolution=2047, src_normals=nrm, grid_bits=11)
        f["metrics"] = dict(c2c_psnr=float(m.c2c_psnr), c2p_psnr=float(m.c2p_psnr),
                            color_psnr=[float(x) for x in m.color_psnr])
        f["recon_points"] = r.point_count
        f["recon_md5"] = frame_digest(r.positions, r.colors)
    wall["metrics"] = time.perf_counter() - t0
    mean = lambda k: float(np.mean([f["metrics"][k] for f in rec]))
    OUT.write_text(json.dumps({
        "seeds": SEEDS,
        "n_samples": N_SAMPLES,
        "overrides": OVERRIDES,
        "source_points": [f.point_count for f in frames],
        "frames": rec,
        "mean": {"d1": mean("c2c_psnr"), "d2": mean("c2p_psnr"),
                 "y": float(np.mean([f["metrics"]["color_psnr"][0] for f in rec]))},
        "stream_bytes": len(stream),
        "stream_md5": hashlib.md5(stream).hexdigest(),
        "stream_stats": dict(enc.last_stream_stats),
        "metrics": ("vpcc_tpu.ops.metrics.compute_metrics(src, rec, resolution=2047, "
                    "src_normals=estimate_normals(src, grid_bits=11), grid_bits=11)"),
        "encoder": "vpcc_tpu.Encoder(cfg).encode_gof on the CPU",
        "command": COMMAND,
        "jax_cpu_wall_s": {k: round(v, 1) for k, v in wall.items()},
    }, indent=1) + "\n")
    print(f"wrote {OUT.name}; JAX-CPU wall seconds "
          f"{ {k: round(v, 1) for k, v in wall.items()} }")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main())
