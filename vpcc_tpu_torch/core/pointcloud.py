"""The padding coordinate (a copy of `PAD_COORD` from
`vpcc_tpu/core/pointcloud.py`).

The port keeps its tensors at their exact sizes, so it has no counterpart
of the reference's padded `PointCloud` or its capacity buckets
(`shape_bucket`).  A row holding PAD_COORD lies outside every voxel grid:
the k-NN and coverage kernels treat such rows as absent, as the reference
does.
"""

from __future__ import annotations

import numpy as np

PAD_COORD = np.int32(0x3FFFFFFF)  # far outside any voxel grid
