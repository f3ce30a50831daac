"""Lossless plane codec (a copy of vpcc_tpu/video/lossless.py): the
bit-exact path for lossless conditions, zlib over a row-delta predictor.
The bytes depend on the zlib library the interpreter links
(`zlib.ZLIB_RUNTIME_VERSION`); every build decodes every other's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_DTYPES = {0: np.uint8, 1: np.uint16}
_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1}


def encode_plane(plane: np.ndarray, level: int = 6) -> bytes:
    """plane: (H, W) or (H, W, C) uint8/uint16 -> bytes."""
    arr = np.ascontiguousarray(plane)
    code = _CODES[arr.dtype]
    shape = arr.shape + (1,) * (3 - arr.ndim)
    # vertical delta prediction improves zlib on smooth depth/attribute maps
    delta = arr.copy()
    delta[1:] = arr[1:] - arr[:-1]
    comp = zlib.compress(delta.tobytes(), level)
    return struct.pack("<BHHH", code, shape[0], shape[1], shape[2]) + comp


def decode_plane(data: bytes) -> np.ndarray:
    code, h, w, c = struct.unpack("<BHHH", data[:7])
    dtype = _DTYPES[code]
    raw = zlib.decompress(data[7:])
    delta = np.frombuffer(raw, dtype=dtype).reshape(h, w, c)
    arr = np.cumsum(delta.astype(np.int64), axis=0).astype(dtype)
    if c == 1:
        arr = arr[..., 0]
    return arr
