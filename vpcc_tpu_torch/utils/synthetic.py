"""Deterministic synthetic point clouds for tests and benchmarks.

A copy of `vpcc_tpu/utils/synthetic.py`: the same numpy draws from the same
seed give the same clouds, point for point.  The CTC sequences
(longdress_vox10 etc.) are external datasets, so tests and benchmarks
synthesize voxelized surfaces with similar statistics: voxel grid 2^bits,
smooth colors, ~10^5..10^6 points.
"""

from __future__ import annotations

import numpy as np

from vpcc_tpu_torch.utils.ply import PointCloudData


def _voxelize_surface(samples_xyz: np.ndarray, colors: np.ndarray, bits: int) -> PointCloudData:
    size = 1 << bits
    q = np.clip(np.round(samples_xyz), 0, size - 1).astype(np.int32)
    # dedupe voxels, keep first color
    key = (q[:, 0].astype(np.int64) << (2 * bits)) | (q[:, 1].astype(np.int64) << bits) | q[:, 2]
    _, idx = np.unique(key, return_index=True)
    return PointCloudData(q[idx], colors[idx])


def make_sphere_cloud(bits: int = 8, n_samples: int = 200_000, seed: int = 0) -> PointCloudData:
    """Voxelized sphere surface with angular color bands."""
    rng = np.random.default_rng(seed)
    size = 1 << bits
    c = size / 2.0
    r = size * 0.4
    v = rng.normal(size=(n_samples, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = c + r * v
    colors = np.stack(
        [
            (127 + 120 * v[:, 0]).astype(np.uint8),
            (127 + 120 * v[:, 1]).astype(np.uint8),
            (127 + 120 * v[:, 2]).astype(np.uint8),
        ],
        axis=1,
    )
    return _voxelize_surface(pts, colors, bits)


def make_torus_cloud(bits: int = 8, n_samples: int = 200_000, seed: int = 1) -> PointCloudData:
    rng = np.random.default_rng(seed)
    size = 1 << bits
    c = size / 2.0
    R, r = size * 0.3, size * 0.12
    u = rng.uniform(0, 2 * np.pi, n_samples)
    t = rng.uniform(0, 2 * np.pi, n_samples)
    x = (R + r * np.cos(t)) * np.cos(u) + c
    y = (R + r * np.cos(t)) * np.sin(u) + c
    z = r * np.sin(t) + c
    pts = np.stack([x, y, z], axis=1)
    colors = np.stack(
        [
            (127 + 100 * np.cos(u)).astype(np.uint8),
            (127 + 100 * np.sin(t)).astype(np.uint8),
            np.full(n_samples, 200, np.uint8),
        ],
        axis=1,
    )
    return _voxelize_surface(pts, colors, bits)


def make_person_cloud(bits: int = 10, n_samples: int = 3_000_000, seed: int = 7) -> PointCloudData:
    """Mannequin-like union of ellipsoid surfaces, statistics similar to the
    8i vox10 sequences (~600k occupied voxels at bits=10)."""
    rng = np.random.default_rng(seed)
    size = 1 << bits
    s = size / 1024.0  # scale relative to vox10

    # (center xyz, radii xyz, weight)
    parts = [
        ((512, 300, 512), (120, 180, 90), 0.30),   # torso
        ((512, 560, 512), (55, 70, 55), 0.10),     # head
        ((512, 470, 512), (28, 45, 28), 0.04),     # neck
        ((400, 330, 512), (38, 150, 38), 0.14),    # left arm
        ((624, 330, 512), (38, 150, 38), 0.14),    # right arm
        ((460, 110, 512), (45, 170, 45), 0.14),    # left leg
        ((564, 110, 512), (45, 170, 45), 0.14),    # right leg
    ]
    all_pts, all_cols = [], []
    for i, (ctr, rad, w) in enumerate(parts):
        m = int(n_samples * w)
        v = rng.normal(size=(m, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = np.array(ctr) * s + np.array(rad) * s * v
        # smooth color field: base hue per part + positional gradient
        base = np.array([(60 + 30 * i) % 256, (160 - 20 * i) % 256, (90 + 47 * i) % 256])
        grad = (pts / size * 110.0) % 110
        cols = np.clip(base[None, :] + grad, 0, 255).astype(np.uint8)
        all_pts.append(pts)
        all_cols.append(cols)
    pts = np.concatenate(all_pts, 0)
    cols = np.concatenate(all_cols, 0)
    keep = np.all((pts >= 0) & (pts < size), axis=1)
    return _voxelize_surface(pts[keep], cols[keep], bits)
