"""PccAppNormalGenerator equivalent on the PyTorch/CUDA port: batch normal
estimation to PLY.

Reference: source/app/PccAppNormalGenerator/PccAppNormalGenerator.cpp:297;
the port of vpcc_tpu/apps/normal_generator.py — per-point normals (inputs
of the D2 metric) from the grid k-NN (kernel E, k = nnNormalEstimation)
and kernel F's PCA and orientation, written as PLYs.

Usage:
    python -m vpcc_tpu_torch.apps.normal_generator \
        --uncompressedDataPath=src_%04d.ply --normalDataPath=nrm_%04d.ply \
        --frameCount=N [--nnNormalEstimation=16] [--device=cuda|cpu]

--device defaults to cuda; without a card it refuses to start unless
--device=cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np

from vpcc_tpu_torch.apps.encode import format_frame_path, split_device
from vpcc_tpu_torch.device import resolve_device
from vpcc_tpu_torch.ops.metrics import estimate_normals
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData, read_ply, write_ply


def main(argv=None) -> int:
    device, rest = split_device(list(argv if argv is not None else sys.argv[1:]))
    cfg = VPCCConfig.from_args(rest)
    if not cfg.uncompressedDataPath or not cfg.normalDataPath:
        print("error: need --uncompressedDataPath and --normalDataPath", file=sys.stderr)
        return 1
    d = resolve_device(device)
    for i in range(cfg.startFrameNumber, cfg.startFrameNumber + cfg.frameCount):
        out_p = format_frame_path(cfg.normalDataPath, i)
        pc = read_ply(format_frame_path(cfg.uncompressedDataPath, i))
        normals = estimate_normals(np.asarray(pc.positions, np.int32), cfg.geometryBitDepth3D,
                                   k=cfg.nnNormalEstimation, device=d, bucket=16).cpu().numpy()
        write_ply(out_p, PointCloudData(pc.positions, pc.colors, normals))
        print(f"frame {i}: {pc.point_count} normals -> {out_p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
