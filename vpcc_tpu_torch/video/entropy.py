"""ctypes binding to the host arithmetic coder (native/entropy.cpp).

A copy of `vpcc_tpu/video/entropy.py`'s two-level (16/8) and three-level
(32/16/8) CU syntax, coefficient, motion-vector and binary-plane coders,
writer and reader halves.  The C++ coder is host code shared by both packages; the port
compiles its own copy with g++ into `vpcc_tpu_torch/_build/` at first use
and never writes into `native/`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from vpcc_tpu_torch import device

_SRC = device.REPO_DIR / "native" / "entropy.cpp"

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(device.build_host_library(_SRC, "vpccentropy")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        p32 = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.vpcc_encode_coeffs.restype = i64
        lib.vpcc_encode_coeffs.argtypes = [p32, i64, u8p, i64]
        lib.vpcc_hevc_encode.restype = i64
        lib.vpcc_hevc_encode.argtypes = [p32] * 5 + [i64, i64, u8p, i64]
        lib.vpcc_hevc32_encode.restype = i64
        lib.vpcc_hevc32_encode.argtypes = [p32] * 8 + [i64, i64, u8p, i64]
        lib.vpcc_mv_encode.restype = i64
        lib.vpcc_mv_encode.argtypes = [p32, p32, i64, u8p, i64]
        lib.vpcc_encode_binary_plane.restype = i64
        lib.vpcc_encode_binary_plane.argtypes = [u8p, i64, i64, u8p, i64]
        lib.vpcc_decode_coeffs.restype = i64
        lib.vpcc_decode_coeffs.argtypes = [u8p, i64, p32, i64]
        lib.vpcc_hevc_decode.restype = i64
        lib.vpcc_hevc_decode.argtypes = [u8p, i64] + [p32] * 5 + [i64, i64]
        lib.vpcc_hevc32_decode.restype = i64
        lib.vpcc_hevc32_decode.argtypes = [u8p, i64] + [p32] * 8 + [i64, i64]
        lib.vpcc_mv_decode.restype = i64
        lib.vpcc_mv_decode.argtypes = [u8p, i64, p32, p32, i64]
        lib.vpcc_decode_binary_plane.restype = i64
        lib.vpcc_decode_binary_plane.argtypes = [u8p, i64, u8p, i64, i64]
        _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_coeffs(coeffs: np.ndarray) -> bytes:
    """(nblocks, 64) int32 zigzag coefficient blocks -> compressed bytes."""
    lib = _load()
    c = np.ascontiguousarray(coeffs, np.int32)
    nb = c.shape[0]
    cap = max(nb * 256, 1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_encode_coeffs(_i32p(c), nb, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def encode_mvs(inter: np.ndarray, mv: np.ndarray) -> bytes:
    """inter: (nb,) int32 0/1 per CU; mv: (nb, 2) int32.  The MVs of the
    CUs whose chosen modes use the inter lane, delta-coded in raster
    order."""
    lib = _load()
    i = np.ascontiguousarray(inter, np.int32)
    m = np.ascontiguousarray(mv, np.int32)
    nb = i.shape[0]
    cap = max(nb * 8, 1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_mv_encode(_i32p(i), _i32p(m), nb, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def encode_binary_plane(plane: np.ndarray) -> bytes:
    """(h, w) plane, nonzero = 1 -> context-coded bytes."""
    lib = _load()
    p = np.ascontiguousarray(plane != 0, np.uint8)
    h, w = p.shape
    cap = max(h * w // 2, 1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_encode_binary_plane(_u8p(p), h, w, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def _encode_grow(fn, arrs, nby, nbx, per_cu) -> bytes:
    """Run a CU syntax writer with a buffer guess, growing it and retrying
    when a high-entropy plane outgrows it (the C side returns -1 cleanly)."""
    arrs = [np.ascontiguousarray(a, np.int32) for a in arrs]
    cap = max(nby * nbx * per_cu, 1 << 16)
    for _ in range(6):
        out = np.empty(cap, np.uint8)
        n = fn(*[_i32p(a) for a in arrs], nby, nbx, _u8p(out), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
    raise RuntimeError("entropy buffer overflow")


def encode_hevc_plane(nby, nbx, split, m16, c16, m8, c8) -> bytes:
    """Two-level (16/8) CU syntax over an (nby, nbx) 16-CU grid: split
    (nb,), m16 (nb,), c16 (nb, 256) zigzag, m8 (nb, 4), c8 (nb, 4, 64)
    zigzag."""
    return _encode_grow(_load().vpcc_hevc_encode, (split, m16, c16, m8, c8), nby, nbx, 640)


def encode_hevc32_plane(nby, nbx, split32, m32, c32, split16, m16, c16,
                        m8, c8) -> bytes:
    """Three-level (32/16/8) CU syntax over an (nby, nbx) 32-CU grid:
    split32 (nb,), m32 (nb,), c32 (nb, 1024) zigzag, split16 (nb, 4),
    m16 (nb, 4), c16 (nb, 4, 256), m8 (nb, 4, 4), c8 (nb, 4, 4, 64)."""
    return _encode_grow(_load().vpcc_hevc32_encode,
                        (split32, m32, c32, split16, m16, c16, m8, c8), nby, nbx, 2560)


def decode_coeffs(data: bytes, nblocks: int) -> np.ndarray:
    """compressed bytes -> (nblocks, 64) int32 zigzag coefficient blocks."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((nblocks, 64), np.int32)
    lib.vpcc_decode_coeffs(_u8p(buf), len(buf), _i32p(out), nblocks)
    return out


def decode_mvs(data: bytes, inter: np.ndarray) -> np.ndarray:
    """inter: (nb,) int32 0/1 per CU -> (nb, 2) int32 MVs (0 where intra)."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    i = np.ascontiguousarray(inter, np.int32)
    nb = i.shape[0]
    mv = np.zeros((nb, 2), np.int32)
    lib.vpcc_mv_decode(_u8p(buf), len(buf), _i32p(i), _i32p(mv), nb)
    return mv


def decode_binary_plane(data: bytes, h: int, w: int) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w), np.uint8)
    lib.vpcc_decode_binary_plane(_u8p(buf), len(buf), _u8p(out), h, w)
    return out


def decode_hevc_plane(data: bytes, nby: int, nbx: int):
    """Two-level (16/8) CU syntax over an (nby, nbx) 16-CU grid -> (split,
    m16, c16, m8, c8), shapes as in `encode_hevc_plane`."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    nb = nby * nbx
    split = np.zeros(nb, np.int32)
    m16 = np.zeros(nb, np.int32)
    c16 = np.zeros((nb, 256), np.int32)
    m8 = np.zeros((nb, 4), np.int32)
    c8 = np.zeros((nb, 4, 64), np.int32)
    lib.vpcc_hevc_decode(_u8p(buf), len(buf), _i32p(split), _i32p(m16), _i32p(c16),
                         _i32p(m8), _i32p(c8), nby, nbx)
    return split, m16, c16, m8, c8


def decode_hevc32_plane(data: bytes, nby: int, nbx: int):
    """Three-level (32/16/8) CU syntax over an (nby, nbx) 32-CU grid ->
    (split32, m32, c32, split16, m16, c16, m8, c8), shapes as in
    `vpcc_tpu.video.entropy.encode_hevc32_plane`."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    nb = nby * nbx
    split32 = np.zeros(nb, np.int32)
    m32 = np.zeros(nb, np.int32)
    c32 = np.zeros((nb, 1024), np.int32)
    split16 = np.zeros((nb, 4), np.int32)
    m16 = np.zeros((nb, 4), np.int32)
    c16 = np.zeros((nb, 4, 256), np.int32)
    m8 = np.zeros((nb, 4, 4), np.int32)
    c8 = np.zeros((nb, 4, 4, 64), np.int32)
    lib.vpcc_hevc32_decode(
        _u8p(buf), len(buf), _i32p(split32), _i32p(m32), _i32p(c32),
        _i32p(split16), _i32p(m16), _i32p(c16), _i32p(m8), _i32p(c8),
        nby, nbx,
    )
    return split32, m32, c32, split16, m16, c16, m8, c8
