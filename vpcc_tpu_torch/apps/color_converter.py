"""PccAppColorConverter equivalent on the port: RGB <-> YCbCr of an image.

Reference: source/app/PccAppColorConverter/PccAppColorConverter.cpp:104;
the port of vpcc_tpu/apps/color_converter.py, with the same outputs.

Usage:
    python -m vpcc_tpu_torch.apps.color_converter rgb2ycc in.npy out.npy \
        [--f420=1 [--downsampleFilter=N]] [--device=cuda|cpu]
    python -m vpcc_tpu_torch.apps.color_converter ycc2rgb in.npy|in.npz out.npy \
        [--upsampleFilter=N] [--device=cuda|cpu]

rgb2ycc: an (H, W, 3) uint8 RGB `.npy` -> (H, W, 3) float32 full-range
BT.709 YCbCr `.npy`; with --f420=1 an `.npz` of y (H, W) float32 and cb, cr
(H/2, W/2): float32 2x2 means with filter 0, float64 with the reference's
filter N (1, 2, 5).  ycc2rgb: such a `.npy` or `.npz` -> (H, W, 3) uint8 RGB
(`.npz` chroma upsampled: nearest with filter 0, else the reference's
filter N (1, 2, 3, 5)).  The conversion and the 2x2 mean and nearest
resampling run in torch on --device (cuda by default; without a card pass
--device=cpu); the filter banks run in float64 numpy on the host, as in
the JAX package.  Kernel Q (`hevc.rgb_to_planes`) is not used: it computes
the video path's rounded integer planes, not these float outputs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.apps.encode import split_device
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import color


def _f32(a, d) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=d)


def main(argv=None) -> int:
    device, args = split_device(list(argv if argv is not None else sys.argv[1:]))
    pos = [a for a in args if not a.startswith("--")]
    cfg = VPCCConfig.from_args(args)
    if len(pos) < 3:
        print(__doc__, file=sys.stderr)
        return 1
    mode, inp, outp = pos[:3]
    if mode not in ("rgb2ycc", "ycc2rgb"):
        print(f"unknown mode {mode}", file=sys.stderr)
        return 1
    d = dev.resolve_device(device)
    use420 = cfg.extra.get("f420", "0") == "1"
    dfilt = int(cfg.extra.get("downsampleFilter", "0"))
    ufilt = int(cfg.extra.get("upsampleFilter", "0"))
    if mode == "rgb2ycc":
        ycc = color.rgb_to_ycbcr(torch.as_tensor(np.load(inp), device=d))
        if use420:
            if dfilt == 0:
                cb, cr = (color.downsample_420(ycc[..., c]).cpu().numpy() for c in (1, 2))
            else:
                cb, cr = (color.downsample_420_filter(ycc[..., c].cpu().numpy(), dfilt)
                          for c in (1, 2))
            np.savez(outp, y=ycc[..., 0].cpu().numpy(), cb=cb, cr=cr)
        else:
            np.save(outp, ycc.cpu().numpy())
    else:
        if inp.endswith(".npz"):
            z = np.load(inp)
            if ufilt == 0:
                up = lambda p: color.upsample_420(_f32(p, d))
            else:
                up = lambda p: _f32(color.upsample_420_filter(np.asarray(p), ufilt), d)
            ycc = torch.stack([_f32(z["y"], d), up(z["cb"]), up(z["cr"])], -1)
        else:
            ycc = _f32(np.load(inp), d)
        np.save(outp, color.ycbcr_to_rgb(ycc).cpu().numpy())
    print(f"{mode}: {inp} -> {outp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
