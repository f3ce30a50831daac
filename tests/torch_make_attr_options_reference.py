"""Make the committed attribute-options reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over the first two
bench frames (`make_person_cloud(bits=10, n_samples=3_000_000)`, seeds 7
and 8) under four configurations of the attribute options, and writes

    vpcc_tpu_torch/data/person_vox10_attr_options_reference.json

* "refl": the bench's r3 overrides, the frames carrying a reflectance
  attribute (lossy: 10-bit planes through the wavefront codec);
* "refl_lossless": the CTC's lossless conditions (the overrides of
  tests/torch_make_lossless_reference.py) with reflectance (zlib planes;
  the raw points' reflectance is zero-filled, as the reference decoder
  fills it);
* "bgfill0": the r3 overrides with attributeBGFill=0 (sparse dilation);
* "bgfill2": the r3 overrides with attributeBGFill=2 (harmonic fill).

The reflectance of a point at (x, y, z) of the frame made from seed s is
`clip(21 * (x + y + z) + rng.integers(0, 1024, N), 0, 65535)` as uint16,
rng = `np.random.default_rng(s)` (`reflectance_field`; chip_smoke.py makes
the same field and checks it against the md5 recorded here).

Per configuration it records the overrides, the stream's md5 and length, its
bytes per substream, `last_stream_stats` and the JAX-CPU wall seconds of
the encode and the decode; per frame the source point count, the md5 of
the source reflectances, the patch count, the md5 of the transferred
reflectances (the (N,) int32 output of `recolor.transfer_reflectance` over
the reconstruction's rows), of the T0 and T1 images the attribute video
codes (after the background fill and group dilation, (H, W, 3) int32), the
digest of the encoder's reconstruction (positions and colors in row order,
after duplicate removal) and the md5 of its reflectances (uint16), and the
same two of the JAX decoder's output.  For "refl" it also records
`compute_metrics`' reflectance PSNR of each frame.  It checks that the JAX
package segments frame 0 into the partitions committed in
person_vox10_front_partitions.npz (which drive the port in chip_smoke.py).

Run from the repository root (about 10 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_attr_options_reference.py
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

from torch_make_lossless_reference import LOSSLESS, unit_bytes  # noqa: E402
from torch_make_smoke_stream import OVERRIDES as R3_OVERRIDES, frame_digest  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.ops import metrics, recolor  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.ply import PointCloudData  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu.video import codecs  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox10_attr_options_reference.json"
PARTITIONS = DATA / "person_vox10_front_partitions.npz"
N_SAMPLES = 3_000_000
SEEDS = [7, 8]
CONFIGS = {
    "refl": (dict(R3_OVERRIDES), True),
    "refl_lossless": (dict(LOSSLESS), True),
    "bgfill0": (dict(R3_OVERRIDES, attributeBGFill=0), False),
    "bgfill2": (dict(R3_OVERRIDES, attributeBGFill=2), False),
}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_attr_options_reference.py")


def md5(a, dtype) -> str:
    return hashlib.md5(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


def reflectance_field(positions: np.ndarray, seed: int) -> np.ndarray:
    """The seeded (N,) uint16 reflectance of a frame's points."""
    rng = np.random.default_rng(seed)
    p = np.asarray(positions, np.int64)
    r = 21 * (p[:, 0] + p[:, 1] + p[:, 2]) + rng.integers(0, 1024, p.shape[0])
    return np.clip(r, 0, 65535).astype(np.uint16)


def run(name: str, overrides: dict, frames) -> dict:
    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    enc = Encoder(cfg)
    seen = {"refl": [], "images": []}
    parts = []
    real_tr = recolor.transfer_reflectance
    real_attr = codecs.AttributeSubstreamEncoder.encode
    real_fetch = enc.segment_fetch

    def tr_spy(*a, **kw):
        out = real_tr(*a, **kw)
        seen["refl"].append(md5(np.asarray(out)[:int(a[4])], "<i4"))
        return out

    def attr_spy(self, img, *a, **kw):
        seen["images"].append(md5(np.asarray(img), "<i4"))
        return real_attr(self, img, *a, **kw)

    def fetch(futures):
        out = real_fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    recolor.transfer_reflectance = tr_spy
    codecs.AttributeSubstreamEncoder.encode = attr_spy
    enc.segment_fetch = fetch
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        t_enc = time.perf_counter() - t0
    finally:
        recolor.transfer_reflectance = real_tr
        codecs.AttributeSubstreamEncoder.encode = real_attr
    t0 = time.perf_counter()
    decoded = Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    committed = np.load(PARTITIONS)["refined_0"]
    if not np.array_equal(parts[0][:len(committed)].astype(np.int8), committed):
        raise AssertionError(f"{name}: frame 0's partitions differ from the committed ones")
    has_refl = frames[0].reflectances is not None
    out_frames = []
    for i, (f, e, rc, dc) in enumerate(zip(frames, enc.last_encoded, recons, decoded)):
        fd = dict(source_points=f.point_count, patches=len(e.patches),
                  t0_md5=seen["images"][2 * i], t1_md5=seen["images"][2 * i + 1],
                  recon_points=rc.point_count, recon_md5=frame_digest(rc.positions, rc.colors),
                  decoded_points=dc.point_count,
                  decoded_md5=frame_digest(dc.positions, dc.colors))
        if has_refl:
            fd.update(source_refl_md5=md5(f.reflectances, "<u2"), refl_md5=seen["refl"][i],
                      recon_refl_md5=md5(rc.reflectances, "<u2"),
                      decoded_refl_md5=md5(dc.reflectances, "<u2"))
            if name == "refl":
                m = metrics.compute_metrics(
                    f.positions.astype(np.int32), f.colors, rc.positions.astype(np.int32),
                    rc.colors, resolution=cfg.resolution, grid_bits=cfg.geometryBitDepth3D,
                    src_refl=f.reflectances, rec_refl=rc.reflectances)
                fd["reflectance_psnr"] = m.reflectance_psnr
        out_frames.append(fd)
        print(f"{name}: {fd}", flush=True)
    return dict(
        overrides=overrides, seeds=SEEDS, n_samples=N_SAMPLES,
        stream_md5=hashlib.md5(stream).hexdigest(), stream_bytes=len(stream),
        unit_bytes=unit_bytes(stream), stream_stats=enc.last_stream_stats,
        frames=out_frames, jax_cpu_encode_s=t_enc, jax_cpu_decode_s=t_dec,
    )


def main() -> int:
    clouds = [make_person_cloud(bits=10, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    with_refl = [PointCloudData(c.positions, c.colors,
                                reflectances=reflectance_field(c.positions, s))
                 for c, s in zip(clouds, SEEDS)]
    out = dict(command=COMMAND, configs={
        name: run(name, ov, with_refl if refl else clouds)
        for name, (ov, refl) in CONFIGS.items()})
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
