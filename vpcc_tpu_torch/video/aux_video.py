"""Auxiliary (RAW / EOM) video substreams (a copy of
vpcc_tpu/video/aux_video.py).

The reference packs raw-point coordinates into a GVD_RAW geometry video
(`generateRawPointsGeometryVideo`, PCCEncoder.cpp:4110-4378) and raw/EOM
attribute samples into an AVD_RAW video (`generateRawPointsAttributeVideo`,
:4380-4665); the decoder unpacks them back to points
(PCCCodec.cpp:1462-1593).  Raw points are lossless by construction, so the
planes ride the lossless plane codec, in the reference's 64-wide block
raster (x column-block, then y, then z).  The EOM samples follow the
reconstruction's compacted row order, which encoder and decoder share, so
the only syntax beyond the samples is their count.
"""

from __future__ import annotations

import struct

import numpy as np

from vpcc_tpu_torch.video import lossless

AUX_MAP_INDEX = 15  # map_index tag of the RAW/EOM auxiliary substreams
WIDTH = 64          # reference raw-patch block width (PCCEncoder.cpp:4110)


def pack_raw_geometry(raw_positions) -> bytes:
    """(n, 3) int32 -> aux geometry frame payload (a uint16 plane)."""
    n = 0 if raw_positions is None else len(raw_positions)
    if n == 0:
        return struct.pack("<I", 0)
    h = -(-n // WIDTH)
    plane = np.zeros((3 * h, WIDTH), np.uint16)
    for c in range(3):
        col = np.zeros(h * WIDTH, np.uint16)
        col[:n] = raw_positions[:, c].astype(np.uint16)
        plane[c * h:(c + 1) * h] = col.reshape(h, WIDTH)
    return struct.pack("<I", n) + lossless.encode_plane(plane)


def unpack_raw_geometry(payload: bytes):
    """-> (n, 3) int32 raw positions, or None."""
    (n,) = struct.unpack("<I", payload[:4])
    if n == 0:
        return None
    plane = lossless.decode_plane(payload[4:])
    h = plane.shape[0] // 3
    out = np.zeros((n, 3), np.int32)
    for c in range(3):
        out[:, c] = plane[c * h:(c + 1) * h].reshape(-1)[:n].astype(np.int32)
    return out


def pack_aux_attribute(raw_colors, eom_colors) -> bytes:
    """Raw + EOM attribute samples -> aux attribute frame payload."""
    nr = 0 if raw_colors is None else len(raw_colors)
    ne = 0 if eom_colors is None else len(eom_colors)
    n = nr + ne
    if n == 0:
        return struct.pack("<II", 0, 0)
    h = -(-n // WIDTH)
    plane = np.zeros((h, WIDTH, 3), np.uint8)
    flat = plane.reshape(-1, 3)
    if nr:
        flat[:nr] = np.asarray(raw_colors, np.uint8)
    if ne:
        flat[nr:nr + ne] = np.asarray(eom_colors, np.uint8)
    return struct.pack("<II", nr, ne) + lossless.encode_plane(plane)


def unpack_aux_attribute(payload: bytes):
    """-> (raw_colors (nr, 3) uint8 | None, eom_colors (ne, 3) uint8 | None)."""
    nr, ne = struct.unpack("<II", payload[:8])
    if nr + ne == 0:
        return None, None
    plane = lossless.decode_plane(payload[8:])
    flat = plane.reshape(-1, 3)
    raw = flat[:nr].copy() if nr else None
    eom = flat[nr:nr + ne].copy() if ne else None
    return raw, eom
