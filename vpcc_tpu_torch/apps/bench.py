"""The RD sweep and encode throughput of bench.py, on the PyTorch/CUDA port.

    python -m vpcc_tpu_torch.apps.bench [--device=cuda|cpu]

Encodes the 8 bench frames (`make_person_cloud(bits=10,
n_samples=3_000_000)`, seeds 7..14, ~607k points each) at the CTC rate
points r1..r5 with `Encoder(cfg).encode_gof` (one warm pass, then one timed
pass per rate, as bench.py does) and measures each reconstruction with
`ops.metrics.compute_metrics` against the source, with the source's PCA
normals (`estimate_normals`) for D2.  Prints ONE JSON line with bench.py's
keys: `metric`, `value` (encode frames/s at r3), `unit`, `vs_baseline`
(against the documented TMC2 single-thread anchor, ANCHOR.md) and
`detail` (`rd_curve`, `bd_rate_vs_anchor_pct`, `stages_r3`), plus
`detail.vs_jax`: the port's bytes and mean D1/D2/Y against the JAX
encoder's at the rates of the committed JAX reference
(`data/person_vox10_rd_reference.json`, made by
tests/torch_make_rd_reference.py), and `detail.device`.

Each rate's configuration comes from in-repo values: the decode fixture's
overrides (recorded in the reference file: vox10, resolution 1023,
`gridBasedSegmentation=1`, `occupancyPrecision=2` at every rate, as
bench.py sets it, `iterationCountRefineSegmentation=10`) and the CTC QPs of
BASELINE.md's rate table.  The encoder runs its own segmentation.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vpcc_tpu_torch.apps.encode import split_device
from vpcc_tpu_torch.device import resolve_device

REFERENCE = Path(__file__).resolve().parent.parent / "data" / "person_vox10_rd_reference.json"
SEEDS = list(range(7, 15))
# CTC geometry / attribute QPs per rate point (BASELINE.md rate table)
RATE_QPS = {"r1": (32, 42), "r2": (28, 37), "r3": (24, 32), "r4": (20, 27), "r5": (16, 22)}
TMC2_SECONDS_PER_FRAME = 60.0  # documented single-thread anchor (ANCHOR.md)
# documented TMC2 anchor RD points (BASELINE.json, ANCHOR.md; the content
# differs from the bench's)
ANCHOR_RD = {
    "d1_db": [(0.1, 65.0), (0.3, 69.0), (1.1, 73.0)],
    "d2_db": [(0.1, 69.0), (0.3, 73.0), (1.1, 77.0)],
    "y_db": [(0.1, 28.5), (0.3, 32.5), (1.1, 36.5)],
}


def bd_rate(anchor, test):
    """Bjontegaard delta-rate (%) of `test` vs `anchor`, each a list of
    (bpp, psnr_db); negative = test needs less rate at equal quality.  Fits
    log10(rate) as a polynomial in PSNR, integrates both fits over the
    overlapping PSNR span and exponentiates the mean log-rate difference;
    None when the curves do not overlap in quality."""

    def fit(curve):
        r = np.log10([max(p[0], 1e-9) for p in curve])
        q = np.array([p[1] for p in curve], float)
        order = np.argsort(q)
        q, r = q[order], r[order]
        deg = min(3, len(q) - 1)
        return q, np.polyfit(q, r, deg)

    qa, pa = fit(anchor)
    qt, pt = fit(test)
    lo = max(qa.min(), qt.min())
    hi = min(qa.max(), qt.max())
    if hi <= lo:
        return None
    ia, it = np.polyint(pa), np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((10.0 ** (avg_t - avg_a) - 1.0) * 100.0)


def rate_cfg(overrides: dict, rate: str):
    from vpcc_tpu_torch.utils.config import VPCCConfig

    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.geometryQP, cfg.attributeQP = RATE_QPS[rate]
    return cfg


def mean_metrics(ms) -> dict:
    """The unrounded mean PSNRs of a list of FrameMetrics."""
    return {
        "d1_db": float(np.mean([m.c2c_psnr for m in ms])),
        "d2_db": float(np.mean([m.c2p_psnr for m in ms])),
        "y_db": float(np.mean([m.color_psnr[0] for m in ms])),
        "u_db": float(np.mean([m.color_psnr[1] for m in ms])),
        "v_db": float(np.mean([m.color_psnr[2] for m in ms])),
    }


def vs_jax(rate: str, n_bytes: int, mean: dict, ref: dict) -> dict:
    """The port against the JAX encoder at one rate of the reference: the
    relative stream-size difference and the mean PSNR differences (dB)."""
    r = ref["rates"][rate]
    out = {"bytes": n_bytes, "jax_bytes": r["stream_bytes"],
           "bytes_pct": 100.0 * (n_bytes / r["stream_bytes"] - 1.0)}
    for k in ("d1_db", "d2_db", "y_db"):
        out[k] = mean[k] - r["mean"][k]
    return out


def run(device=None, rates=tuple(RATE_QPS)) -> dict:
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops.metrics import compute_metrics, estimate_normals
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    d = resolve_device(device)
    sync = torch.cuda.synchronize if d.type == "cuda" else (lambda: None)
    ref = json.loads(REFERENCE.read_text())
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in SEEDS]
    npts = sum(f.point_count for f in frames) / len(frames)
    src_normals = [estimate_normals(f.positions.astype(np.int32), grid_bits=10, device=d)
                   for f in frames]

    rd_curve, deltas = [], {}
    fps_r3, stages = 0.0, {}
    for rate in rates:
        enc = Encoder(rate_cfg(ref["overrides"], rate), device=d)
        enc.encode_gof(frames)   # warm pass: kernel builds, the height ratchet
        sync()
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        sync()
        dt = time.perf_counter() - t0
        ms = [compute_metrics(src.positions.astype(np.int32), src.colors,
                              rec.positions.astype(np.int32), rec.colors,
                              resolution=1023, src_normals=nrm, grid_bits=10, device=d)
              for src, nrm, rec in zip(frames, src_normals, recons)]
        mean = mean_metrics(ms)
        rd_curve.append({"rate": rate,
                         "bpp": round(len(stream) * 8 / (npts * len(frames)), 4),
                         **{k: round(v, 2) for k, v in mean.items()},
                         "enc_s_per_frame": round(dt / len(frames), 3)})
        if rate in ref["rates"]:
            deltas[rate] = vs_jax(rate, len(stream), mean, ref)
        if rate == "r3":
            fps_r3 = len(frames) / dt
            for s in enc.stats:
                for k, v in dataclasses.asdict(s).items():
                    if k.endswith("_s"):
                        stages[k] = round(stages.get(k, 0.0) + v / len(frames), 3)
        print(f"{rate}: {rd_curve[-1]}", file=sys.stderr, flush=True)

    bd = {k: round(v, 1) for k, v in (
        (k, bd_rate(ANCHOR_RD[k], [(p["bpp"], p[k]) for p in rd_curve]))
        for k in ("d1_db", "d2_db", "y_db")) if v is not None}
    return {
        "metric": "vpcc_encode_fps_vox10_r3",
        "value": round(fps_r3, 4),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps_r3 / (1.0 / TMC2_SECONDS_PER_FRAME), 2),
        "detail": {
            "device": torch.cuda.get_device_name(d) if d.type == "cuda" else str(d),
            "points_per_frame": int(npts),
            "anchor": "TMC2 1-thread 60 s/frame (documented, ANCHOR.md)",
            "rd_curve": rd_curve,
            "bd_rate_vs_anchor_pct": bd,
            "bd_rate_note": ("Bjontegaard delta-rate vs the documented TMC2 longdress "
                             "anchor (negative = we need less rate); content differs "
                             "(synthetic vs CTC), see ANCHOR.md"),
            "stages_r3": stages,
            "vs_jax": deltas,
        },
    }


def main(argv=None) -> int:
    device, rest = split_device(list(argv if argv is not None else sys.argv[1:]))
    if rest:
        print(f"error: unknown arguments {rest}", file=sys.stderr)
        return 1
    print(json.dumps(run(device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
