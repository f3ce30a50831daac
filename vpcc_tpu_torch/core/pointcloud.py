"""The padding coordinate and the capacity buckets (copies of `PAD_COORD`
and `shape_bucket` from `vpcc_tpu/core/pointcloud.py`).

The port keeps its tensors at their exact sizes, so it has no counterpart
of the reference's padded `PointCloud`.  Where the reference's result
depends on its padding (a float sum over the padded length, the padded rows
of the spanning-tree seed), the port asks `shape_bucket` for the padded
length.  A row holding PAD_COORD lies outside every voxel grid: the k-NN
and coverage kernels treat such rows as absent, as the reference does.
"""

from __future__ import annotations

import numpy as np

PAD_COORD = np.int32(0x3FFFFFFF)  # far outside any voxel grid


def shape_bucket(n: int, minimum: int = 8192) -> int:
    """The reference's padded length of an n-row cloud: the next capacity
    >= n on the {2^k, 3 * 2^(k-1)} ladder, at least `minimum`."""
    n = max(n, minimum)
    p = 1 << (n - 1).bit_length()
    if n <= (p // 4) * 3:
        return (p // 4) * 3
    return p
