"""Make the committed attribute-path reference data for the PyTorch port.

Not a test: a helper that runs the JAX package's `Encoder.encode_gof` on the
CPU over the 8 bench frames with the decode fixture's configuration
(`torch_make_smoke_stream.OVERRIDES`, the encode that made
`person_vox10_r3_gof8.vpcc`; the script checks that it writes the same
stream) and records, per frame, by wrapping the encoder's functions in
this process (no file is edited):

* the reconstructed point count and the md5 of the transferred colors
  (`recolor.transfer_colors_compact`) and of the pre-smoothed colors
  (`smoothing.presmooth_colors`), (N, 3) int32 in reconstruction row
  order, with the number of boundary queries and of replaced colors;
* the md5 of the final T0 and T1 images (painted, filled and group
  dilated), (H, W, 3) uint8;
* per attribute plane (T0, T1): the coded bytes and the luma PSNR of the
  decoded plane against the coded one over the decoded occupancy (the RD
  weight the encoder passes);
* the encoder's per-substream byte counts (`last_stream_stats`).

It writes

    vpcc_tpu_torch/data/person_vox10_attr_digests.json

`chip_smoke.py` holds the port against it.  Run from the repository root
(several minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_attr_reference.py
"""

from __future__ import annotations

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

from torch_make_smoke_stream import OVERRIDES, SEEDS, STREAM  # noqa: E402
from vpcc_tpu import encoder as enc_mod  # noqa: E402
from vpcc_tpu.ops import padding as jpadding, recolor as jrecolor  # noqa: E402
from vpcc_tpu.ops import smoothing as jsmoothing  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu.video import codecs as jcodecs, hevc as jhevc  # noqa: E402
from vpcc_tpu_torch.utils.checksum import array_md5  # noqa: E402

OUT = ROOT / "vpcc_tpu_torch" / "data" / "person_vox10_attr_digests.json"


def luma_psnr(coded, decoded, occ) -> float:
    """Occupied-pixel PSNR of two (H, W) luma planes (peak 255)."""
    m = np.asarray(occ) != 0
    err = np.asarray(coded, np.float64)[m] - np.asarray(decoded, np.float64)[m]
    mse = float(np.mean(err * err))
    return float("inf") if mse == 0 else float(10.0 * np.log10(255.0 * 255.0 / mse))


class Recorder:
    """Wraps the JAX encoder's attribute stages and keeps what each frame
    made."""

    def __init__(self):
        self.frames = []
        self._saved = []

    def __enter__(self):
        rec = self
        orig_frame = enc_mod.Encoder.encode_frame
        orig_tc = jrecolor.transfer_colors_compact
        orig_ps = jsmoothing.presmooth_colors
        orig_gd = jpadding.group_dilate
        orig_attr = jcodecs.AttributeSubstreamEncoder.encode

        def encode_frame(self_, *a, **kw):
            rec.frames.append({"planes": []})
            out = orig_frame(self_, *a, **kw)
            cur = rec.frames[-1]
            cur["planes"] = [dict(bytes=len(p), y_psnr=q["y_psnr"])
                             for p, q in zip(out.attribute_payloads, cur["planes"])]
            return out

        def transfer_colors_compact(*a, **kw):
            out = orig_tc(*a, **kw)
            n = int(a[4])
            rec.frames[-1].update(points=n, transfer_md5=array_md5(
                np.asarray(out[0])[:n].astype(np.int32), "<i4"))
            return out

        def presmooth_colors(pos, colors, count, bnd, *a, **kw):
            out = orig_ps(pos, colors, count, bnd, *a, **kw)
            n = int(count)
            before = np.asarray(colors)[:n]
            after = np.asarray(out)[:n]
            rec.frames[-1].update(
                presmooth_md5=array_md5(after.astype(np.int32), "<i4"),
                boundary_queries=int(np.asarray(bnd)[:n].sum()),
                replaced=int((before != after).any(1).sum()))
            return out

        def group_dilate(img0, img1, occ):
            a, b = orig_gd(img0, img1, occ)
            rec.frames[-1].update(t0_md5=array_md5(np.asarray(a), np.uint8),
                                  t1_md5=array_md5(np.asarray(b), np.uint8))
            return a, b

        def attr_encode(self_, attr, *a, weight=None, **kw):
            out = orig_attr(self_, attr, *a, weight=weight, **kw)
            y = np.asarray(jhevc._rgb_to_int_planes(np.asarray(attr), None)[0])
            dec = np.asarray(self_.refs[0])[0]
            rec.frames[-1]["planes"].append(dict(y_psnr=luma_psnr(y, dec, weight)))
            return out

        for obj, name, fn in (
            (enc_mod.Encoder, "encode_frame", encode_frame),
            (jrecolor, "transfer_colors_compact", transfer_colors_compact),
            (jsmoothing, "presmooth_colors", presmooth_colors),
            (jpadding, "group_dilate", group_dilate),
            (jcodecs.AttributeSubstreamEncoder, "encode", attr_encode),
        ):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []


def main() -> int:
    cfg = VPCCConfig()
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in SEEDS]
    t0 = time.perf_counter()
    enc = enc_mod.Encoder(cfg)
    with Recorder() as rec:
        stream, _ = enc.encode_gof(frames)
    dt = time.perf_counter() - t0
    if stream != STREAM.read_bytes():
        raise SystemExit("the JAX encoder's stream differs from the committed fixture")
    OUT.write_text(json.dumps({
        "seeds": SEEDS,
        "overrides": OVERRIDES,
        "encoder": "vpcc_tpu.Encoder(cfg).encode_gof on the CPU",
        "stream_bytes": len(stream),
        "stream_stats": enc.last_stream_stats,
        "frames": rec.frames,
    }, indent=1) + "\n")
    print(f"recorded {len(rec.frames)} frames in {dt:.1f}s; points "
          f"{[f['points'] for f in rec.frames]}; replaced "
          f"{[f['replaced'] for f in rec.frames]}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main())
