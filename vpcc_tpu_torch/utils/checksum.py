"""Checksums: the point-cloud digest and the encoder front end's digests.

Behavioral reference for `point_cloud_checksum`: `PCCChecksum`
(source/lib/PccLibMetrics/source/PCCChecksum.cpp:51-148): MD5 over the
points (positions + attributes); `PCCPointSet3::computeChecksum`
(PCCPointSet.h:499) sorts points first so the digest is order-invariant.
`array_md5` and `patches_md5` are the digests the committed front-end
reference data holds (tests/torch_make_front_reference.py).
"""

from __future__ import annotations

import hashlib

import numpy as np

from vpcc_tpu_torch.utils.ply import PointCloudData


def array_md5(a, dtype) -> str:
    """md5 of a numpy array's elements as little-endian `dtype`, C order."""
    return hashlib.md5(np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


# the scalar patch fields the front-end digests cover, then depth0/depth1
PATCH_DIGEST_FIELDS = (
    "index", "view_id", "normal_axis", "tangent_axis", "bitangent_axis",
    "projection_mode", "u1", "v1", "d1", "size_u", "size_v", "size_d",
    "occupancy_resolution", "u0", "v0", "orientation", "size_u0", "size_v0",
    "pref_u0", "pref_v0", "pref_orientation", "ref_patch_idx",
    "axis_of_additional_plane", "geo_bits", "lod_x", "lod_y",
)


def patches_md5(patches) -> str:
    """md5 over a patch list, in order: each patch's PATCH_DIGEST_FIELDS as
    int64, then its depth maps' shapes and int32 contents.  Works on either
    package's patches."""
    h = hashlib.md5()
    for p in patches:
        h.update(np.array([getattr(p, f) for f in PATCH_DIGEST_FIELDS], "<i8").tobytes())
        for m in (p.depth0, p.depth1):
            h.update(np.array(m.shape, "<i8").tobytes())
            h.update(np.ascontiguousarray(m, "<i4").tobytes())
    return h.hexdigest()


def point_cloud_checksum(pc: PointCloudData) -> str:
    """Order-invariant MD5 of positions (+ colors if present)."""
    pos = np.asarray(pc.positions, np.int64)
    order = np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0]))
    h = hashlib.md5()
    h.update(pos[order].astype("<i4").tobytes())
    if pc.colors is not None:
        h.update(np.asarray(pc.colors)[order].astype(np.uint8).tobytes())
    return h.hexdigest()
