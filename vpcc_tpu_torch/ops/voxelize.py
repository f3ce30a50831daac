"""Grid-based segmentation voxelization (plain PyTorch on every device).

Behavioral reference: `vpcc_tpu/ops/voxelize.py` (the reference's
`convertPointsToVoxels`, PCCPatchSegmenter.cpp:152-215): quantize the
cloud onto a 2^shift voxel grid; normals, segmentation and connected
components run on the smaller voxel cloud and are gathered back to points.

The port keeps exact sizes: every input row is a point (no padding), the
voxel table has exactly `nvox` rows.  The representative of a voxel is its
first point in key order — with the stable sort, the lowest original index
among equal keys, as `jnp.argsort` gives.
"""

from __future__ import annotations

import torch


def voxelize(positions: torch.Tensor, shift: int, bits: int):
    """positions (N, 3) int32 -> (point_vox (N,) int32 voxel id per point,
    vox_pos (nvox, 3) int32 representative positions, nvox int)."""
    vb = bits - shift
    if 3 * vb > 31:
        raise ValueError("voxel key must fit int32")
    vx = positions >> shift
    key = (vx[:, 0] << (2 * vb)) | (vx[:, 1] << vb) | vx[:, 2]
    ks, order = torch.sort(key, stable=True)
    new = torch.ones_like(ks, dtype=torch.bool)
    new[1:] = ks[1:] != ks[:-1]
    vox_rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    nvox = int(vox_rank[-1]) + 1 if len(ks) else 0
    point_vox = torch.empty_like(vox_rank)
    point_vox[order] = vox_rank
    vox_pos = positions[order[new]]
    return point_vox, vox_pos, nvox


def gather_point_values(vox_vals: torch.Tensor, point_vox: torch.Tensor) -> torch.Tensor:
    """Map per-voxel values back to points (clipped gather)."""
    return vox_vals[point_vox.long().clamp(0, vox_vals.shape[0] - 1)]
