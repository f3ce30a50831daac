"""Static tables for the HEVC-class video codec (video/hevc.py).

A numpy-only copy of `vpcc_tpu/video/hevc_tables.py`: the constants an
HEVC-class codec needs — angular intra prediction taps, integer transform
bases, quantizer step tables, deblocking thresholds, zigzag scans.  The
codec's stream format is defined by these numbers, so the port keeps them
identical to the JAX package's.

* Every HEVC angular prediction is a 2-tap linear gather over the (4N+1)
  reference-sample vector (`angular_taps`); the wavefront kernels and
  their plain PyTorch versions all read these tables.
* The encoder's rate-distortion constants (`LAMBDA`, `MODE_BITS`) and the
  rate term of a quantised level (`rd_bits_table`).
"""

from __future__ import annotations

import functools
import math

import numpy as np

# HEVC Table 8-4: intraPredAngle per mode 2..34 (spec constants)
_ANGLES = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}
# HEVC invAngle for the negative angles (spec constants)
_INV_ANGLE = {-2: 4096, -5: 1638, -9: 910, -13: 630, -17: 482,
              -21: 390, -26: 315, -32: 256}

N_INTRA_MODES = 35          # 0 planar, 1 DC, 2..34 angular
MODE_INTER = 35             # extra codec mode: zero-MV temporal prediction
N_MODES = 36


def _main_ref_index(k: int, n: int, vertical: bool, angle: int) -> int:
    """Map a main-reference position k (may be negative for projected
    refs) to an index into the (4n+1) reference vector."""
    if k >= 0:
        if k == 0:
            return 0
        k = min(k, 2 * n)  # k == 2n+1 only reachable with tap weight 0 (a=32)
        return k if vertical else 2 * n + k
    # projected from the side array (HM xPredIntraAng invAngleSum loop)
    inv = _INV_ANGLE[angle]
    j = (128 + (-k) * inv) >> 8  # refSide index; refSide[0]=corner
    j = min(j, 2 * n)
    if j == 0:
        return 0
    return (2 * n + j) if vertical else j


@functools.lru_cache(maxsize=None)
def angular_taps(n: int):
    """2-tap gather tables for the 33 angular modes at block size n.

    Returns (idx0, idx1, w0, w1): each (33, n, n) int32; prediction is
    pred = (w0*refs[idx0] + w1*refs[idx1] + 16) >> 5, exactly HEVC's
    ((32-f)*a + f*b + 16) >> 5 two-tap interpolation."""
    idx0 = np.zeros((33, n, n), np.int32)
    idx1 = np.zeros((33, n, n), np.int32)
    w0 = np.zeros((33, n, n), np.int32)
    w1 = np.zeros((33, n, n), np.int32)
    for mi, mode in enumerate(range(2, 35)):
        a = _ANGLES[mode]
        vertical = mode >= 18
        for y in range(n):
            for x in range(n):
                # horizontal modes transpose the roles of x and y
                u, v = (y, x) if vertical else (x, y)
                t = (v + 1) * a
                i, f = t >> 5, t & 31
                p = u + i + 1
                idx0[mi, y, x] = _main_ref_index(p, n, vertical, a)
                idx1[mi, y, x] = _main_ref_index(p + 1, n, vertical, a)
                w0[mi, y, x] = 32 - f
                w1[mi, y, x] = f
    return idx0, idx1, w0, w1


def dct_orthonormal(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float64)


@functools.lru_cache(maxsize=None)
def dct_int(n: int) -> np.ndarray:
    """HEVC-style integer transform basis: round(64*sqrt(n) * C_orthonormal).
    T @ T.T ~= 2^12 * n * I; the inverse transform is T.T @ coeff @ T with
    a total downshift of 18 + log2(n) after the x64 dequant scale."""
    return np.round(64.0 * math.sqrt(n) * dct_orthonormal(n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def zigzag(n: int) -> np.ndarray:
    idx = []
    for s in range(2 * n - 1):
        rng = range(max(0, s - n + 1), min(s, n - 1) + 1)
        diag = [(i, s - i) for i in rng]
        if s % 2 == 0:
            diag = diag[::-1]
        idx.extend(diag)
    return np.array([r * n + c for r, c in idx], np.int32)


# quantizer: qstep(qp) = 2^((qp-4)/6), stored as DQ = round(64*qstep) so the
# dequantized coefficient level*DQ is an exact int32 (= 64x the real value)
QP_MAX = 51
DQ64 = np.round(64.0 * 2.0 ** ((np.arange(QP_MAX + 1) - 4) / 6.0)).astype(np.int32)

# RD lambda ~ HEVC intra: lambda = 0.57 * 2^((qp-12)/3) = 0.0897 * qstep^2
LAMBDA = (0.09 * (DQ64.astype(np.float64) / 64.0) ** 2).astype(np.float32)

# approximate mode-signalling bins per mode (the encoder's RD rate term)
MODE_BITS = np.full(N_MODES, 5.0, np.float32)
MODE_BITS[0] = MODE_BITS[1] = 3.0   # planar/DC: usually MPM-coded
MODE_BITS[MODE_INTER] = 2.0         # inter flag

LEVEL_MAX = 32767  # quantised level cap of the RDO


@functools.lru_cache(maxsize=None)
def rd_bits_table() -> np.ndarray:
    """(LEVEL_MAX + 1,) float32: the RD rate term of a quantised level lv,
    `3 + 2*log2(1 + lv)` for lv > 0 and 0 for lv == 0, as the JAX package's
    XLA CPU program evaluates it (its log2 is not correctly rounded; the
    values were recorded by tests/torch_make_encode_tables.py)."""
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "data" / "rd_bits_xla.npy"
    t = np.load(path)
    if t.shape != (LEVEL_MAX + 1,) or t.dtype != np.float32:
        raise ValueError(f"{path}: expected ({LEVEL_MAX + 1},) float32")
    return t


TC_TAB = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
       6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    np.int32,
)


@functools.lru_cache(maxsize=None)
def wavefront_schedule(nby: int, nbx: int):
    """Wavefront diagonals d = 2*by + bx (WPP order: the top-right
    neighbor, coded on diagonal d-1, is a real reconstructed reference;
    the below-left neighbor is not yet coded, exactly HEVC raster-scan
    availability).  Returns (by_tab, bx_tab, valid) each (n_diag, bmax)."""
    n_diag = 2 * (nby - 1) + (nbx - 1) + 1
    rows = [[] for _ in range(n_diag)]
    for by in range(nby):
        for bx in range(nbx):
            rows[2 * by + bx].append((by, bx))
    bmax = max(len(r) for r in rows)
    by_tab = np.zeros((n_diag, bmax), np.int32)
    bx_tab = np.zeros((n_diag, bmax), np.int32)
    valid = np.zeros((n_diag, bmax), bool)
    for d, r in enumerate(rows):
        for s, (by, bx) in enumerate(r):
            by_tab[d, s] = by
            bx_tab[d, s] = bx
            valid[d, s] = True
    return by_tab, bx_tab, valid


