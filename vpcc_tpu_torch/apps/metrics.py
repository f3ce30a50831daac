"""PccAppMetrics equivalent on the PyTorch/CUDA port: standalone
source-vs-decoded metrics.

Reference: source/app/PccAppMetrics/PccAppMetrics.cpp:50-186; the port of
vpcc_tpu/apps/metrics.py.

Usage:
    python -m vpcc_tpu_torch.apps.metrics --uncompressedDataPath=src_%04d.ply \
        --reconstructedDataPath=dec_%04d.ply --frameCount=N \
        [--resolution=1023] [--normalDataPath=nrm_%04d.ply] [--device=cuda|cpu]

--device defaults to cuda; without a card the metrics refuse to start
unless --device=cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np

from vpcc_tpu_torch.apps.encode import format_frame_path, split_device
from vpcc_tpu_torch.device import resolve_device
from vpcc_tpu_torch.ops.metrics import compute_metrics
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import read_ply


def main(argv=None) -> int:
    device, rest = split_device(list(argv if argv is not None else sys.argv[1:]))
    cfg = VPCCConfig.from_args(rest)
    if not cfg.uncompressedDataPath or not cfg.reconstructedDataPath:
        print("error: need --uncompressedDataPath and --reconstructedDataPath",
              file=sys.stderr)
        return 1
    d = resolve_device(device)
    agg = []
    for i in range(cfg.startFrameNumber, cfg.startFrameNumber + cfg.frameCount):
        src = read_ply(format_frame_path(cfg.uncompressedDataPath, i))
        rec = read_ply(format_frame_path(cfg.reconstructedDataPath, i))
        nrm = None
        if cfg.normalDataPath:
            nrm = read_ply(format_frame_path(cfg.normalDataPath, i)).normals
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            rec.positions.astype(np.int32), rec.colors,
            resolution=cfg.resolution,
            src_normals=nrm,
            grid_bits=cfg.geometryBitDepth3D,
            with_d2=True,
            src_refl=src.reflectances,
            rec_refl=rec.reflectances,
            device=d,
        )
        line = f"frame {i}: {m.summary()}"
        if m.reflectance_psnr != float("inf"):
            line += f"  R {m.reflectance_psnr:8.4f}"
        print(line)
        agg.append(m)
    if agg:
        print(
            "mean:  D1 %8.4f dB  D2 %8.4f dB  Y %8.4f"
            % (
                float(np.mean([m.c2c_psnr for m in agg])),
                float(np.mean([m.c2p_psnr for m in agg])),
                float(np.mean([m.color_psnr[0] for m in agg])),
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
