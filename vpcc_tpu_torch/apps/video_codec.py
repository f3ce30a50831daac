"""PccAppVideoEncoder / PccAppVideoDecoder equivalents on the PyTorch/CUDA
port: direct access to the video-codec layer for one raw stream.

Reference: source/app/PccAppVideoEncoder/PccAppVideoEncoder.cpp:105,
PccAppVideoDecoder.cpp:54; the port of vpcc_tpu/apps/video_codec.py.  A
mono stream goes through the geometry substream coder (maxval
2^geometryNominal2dBitdepth - 1: above 10 bits the two-level 16/8 codec),
an RGB stream through the attribute substream coder; the first frame is
intra, each later one predicts from the previous decoded frame.

Usage:
    python -m vpcc_tpu_torch.apps.video_codec encode in.npy out.bin --qp=24 \
        [--geometryNominal2dBitdepth=11] [--device=cuda|cpu]
    python -m vpcc_tpu_torch.apps.video_codec decode out.bin rec.npy [--device=cuda|cpu]
(.npy: (F, H, W) uint16 mono or (F, H, W, 3) uint8 RGB)

--device defaults to cuda; without a card the app refuses to start unless
--device=cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.apps.encode import split_device
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import codecs


def _host(frame) -> np.ndarray:
    return frame.cpu().numpy() if hasattr(frame, "cpu") else np.asarray(frame)


def main(argv=None) -> int:
    device, args = split_device(list(argv if argv is not None else sys.argv[1:]))
    pos = [a for a in args if not a.startswith("--")]
    cfg = VPCCConfig.from_args(args)
    if len(pos) < 3:
        print(__doc__, file=sys.stderr)
        return 1
    mode, inp, outp = pos[:3]
    qp = int(cfg.extra.get("qp", 24))
    d = dev.resolve_device(device)
    if mode == "encode":
        frames = np.load(inp)
        rgb = frames.ndim == 4
        cfg.geometryQP = qp
        cfg.attributeQP = qp
        enc = (codecs.AttributeSubstreamEncoder(cfg, d) if rgb
               else codecs.GeometrySubstreamEncoder(cfg, d))
        payloads = [enc.encode(f)[0] for f in frames]
        with open(outp, "wb") as f:
            f.write(len(payloads).to_bytes(4, "little"))
            f.write((1 if rgb else 0).to_bytes(1, "little"))
            for p in payloads:
                f.write(len(p).to_bytes(4, "little"))
                f.write(p)
        total = sum(len(p) for p in payloads)
        print(f"encoded {len(payloads)} frames, {total} bytes")
    elif mode == "decode":
        with open(inp, "rb") as f:
            data = f.read()
        n = int.from_bytes(data[:4], "little")
        rgb = data[4] == 1
        pos_b = 5
        dec = (codecs.AttributeSubstreamDecoder(cfg, d) if rgb
               else codecs.GeometrySubstreamDecoder(cfg, d))
        frames = []
        for _ in range(n):
            ln = int.from_bytes(data[pos_b: pos_b + 4], "little")
            pos_b += 4
            frames.append(_host(dec.decode(data[pos_b: pos_b + ln])))
            pos_b += ln
        np.save(outp, np.stack(frames))
        print(f"decoded {n} frames -> {outp}")
    else:
        print(f"unknown mode {mode}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
