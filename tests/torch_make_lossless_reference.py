"""Make the committed lossless-condition reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over the bench's
synthetic person frames (`make_person_cloud(bits=10, n_samples=3_000_000)`)
under two configurations and writes

    vpcc_tpu_torch/data/person_vox10_lossless_reference.json

* "lossless": the CTC's lossless conditions (CWAI/CWLD, rate
  ctc-r5-lossless) on seeds 7..10 in one GOF: the bench's overrides with
  geometryQP -12, attributeQP 0, occupancyPrecision 1, rawPointsPatch with
  maxAllowedDist2RawPointsSelection 0, enhancedOccupancyMapCode and
  useRawPointsSeparateVideo, no geometry smoothing, no color pre-smoothing
  (tests/test_e2e.py:118 and :483);
* "r3_eom": EOM under the bench's r3 overrides on seeds 7..8, raw points
  off (tests/test_e2e.py:197).

Per configuration it records the overrides, the stream's md5 and length,
its bytes per substream (per unit type and map index), `last_stream_stats`,
`zlib.ZLIB_RUNTIME_VERSION` and the JAX-CPU wall seconds; per frame the
source point count and digest, the patch count, the raw points' count and
digest, the EOM plane's md5, nonzero count and EOM row count, the digest of
the encoder's reconstruction (in row order, after duplicate removal) and of
the JAX decoder's output.  It also checks that the JAX package segments
frame 0 into the partitions committed in
person_vox10_front_partitions.npz (which drive the port in
`chip_smoke.py`): segmentation reads no QP, precision or raw-point setting.

Run from the repository root (a few minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_lossless_reference.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_make_smoke_stream import OVERRIDES as R3_OVERRIDES, frame_digest  # noqa: E402
from vpcc_tpu import pipeline  # noqa: E402
from vpcc_tpu.bitstream import v3c  # noqa: E402
from vpcc_tpu.bitstream.bitio import BitReader  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu.video import codecs  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox10_lossless_reference.json"
PARTITIONS = DATA / "person_vox10_front_partitions.npz"
N_SAMPLES = 3_000_000
LOSSLESS = dict(
    R3_OVERRIDES, geometryQP=-12, attributeQP=0, occupancyPrecision=1, rawPointsPatch=1,
    maxAllowedDist2RawPointsSelection=0.0, enhancedOccupancyMapCode=1,
    useRawPointsSeparateVideo=1, flagGeometrySmoothing=0, gridSmoothing=0,
    flagColorPreSmoothing=0)
CONFIGS = {
    "lossless": (LOSSLESS, [7, 8, 9, 10]),
    "r3_eom": (dict(R3_OVERRIDES, enhancedOccupancyMapCode=1), [7, 8]),
}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_lossless_reference.py")
UNIT_NAMES = {v3c.V3C_VPS: "VPS", v3c.V3C_AD: "AD", v3c.V3C_OVD: "OVD",
              v3c.V3C_GVD: "GVD", v3c.V3C_AVD: "AVD"}


def unit_bytes(stream: bytes) -> dict:
    """Bytes of each V3C unit's payload, keyed by type and, for the video
    substreams, map index ("OVD 0", "OVD 1" = EOM, "GVD 15" = RAW aux, ...)."""
    out = {}
    for utype, payload in v3c.read_sample_stream(stream):
        key = UNIT_NAMES[utype]
        if utype in (v3c.V3C_OVD, v3c.V3C_GVD, v3c.V3C_AVD):
            key += f" {v3c.VideoSubstream.read(BitReader(payload)).map_index}"
        out[key] = out.get(key, 0) + len(payload)
    return out


def run(name: str, overrides: dict, seeds: list) -> dict:
    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    frames = [make_person_cloud(bits=10, n_samples=N_SAMPLES, seed=s) for s in seeds]
    enc = Encoder(cfg)
    eom_rows, parts = [], []
    real_recon, real_fetch = pipeline.reconstruct_frame_device, enc.segment_fetch

    def recon(*a, **kw):
        r = real_recon(*a, **kw)
        eom_rows.append(int(np.asarray((r.layer == 2) & r.valid).sum()))
        return r

    def fetch(futures):
        out = real_fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    pipeline.reconstruct_frame_device = recon
    enc.segment_fetch = fetch
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        t_enc = time.perf_counter() - t0
    finally:
        pipeline.reconstruct_frame_device = real_recon
    t0 = time.perf_counter()
    decoded = Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    committed = np.load(PARTITIONS)["refined_0"]
    if not np.array_equal(parts[0][:len(committed)].astype(np.int8), committed):
        raise AssertionError(f"{name}: frame 0's partitions differ from the committed ones")
    out_frames = []
    for f, e, rc, dc, nrows in zip(frames, enc.last_encoded, recons, decoded, eom_rows):
        eom = codecs.decode_eom_plane(e.eom_payload) if e.eom_payload else None
        raw = e.raw_positions
        out_frames.append(dict(
            source_points=f.point_count, source_md5=frame_digest(f.positions, f.colors),
            patches=len(e.patches),
            raw_points=0 if raw is None else len(raw),
            raw_md5=None if raw is None else frame_digest(raw, e.raw_colors),
            eom_md5=None if eom is None else hashlib.md5(
                np.ascontiguousarray(eom, "<i4").tobytes()).hexdigest(),
            eom_codes=None if eom is None else int((eom != 0).sum()),
            eom_rows=nrows,
            recon_points=rc.point_count, recon_md5=frame_digest(rc.positions, rc.colors),
            decoded_points=dc.point_count, decoded_md5=frame_digest(dc.positions, dc.colors),
        ))
        print(f"{name}: {out_frames[-1]}", flush=True)
    return dict(
        overrides=overrides, seeds=seeds, n_samples=N_SAMPLES,
        stream_md5=hashlib.md5(stream).hexdigest(), stream_bytes=len(stream),
        unit_bytes=unit_bytes(stream), stream_stats=enc.last_stream_stats,
        frames=out_frames, jax_cpu_encode_s=t_enc, jax_cpu_decode_s=t_dec,
    )


def main() -> int:
    out = dict(command=COMMAND, zlib_runtime_version=zlib.ZLIB_RUNTIME_VERSION,
               configs={name: run(name, *c) for name, c in CONFIGS.items()})
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
