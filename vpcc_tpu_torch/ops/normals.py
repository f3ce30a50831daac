"""Normal estimation: PCA over k-NN neighbourhoods (K10, kernel F).

Behavioral reference: `vpcc_tpu/ops/normals.py` (the reference's
`PCCNormalsGenerator3`, PCCNormalsGenerator.cpp:61-185): per-voxel
covariance of the k nearest neighbours, closed-form smallest eigenvector,
then orientation by a radially-outward start and 8 neighbour
sign-consensus sweeps (`normalOrientation=1`).

Float32 in the reference's operation order, with `device.fma_f32` where
XLA's CPU backend contracts a multiply into an add (see csrc/segment.cu).
The eigen solver's arccos and cos are PyTorch's (plain version) or CUDA's
(kernel), not XLA's, so normals agree with the reference to a tolerance.
The orientation centroid is plain PyTorch: an exact int64 sum of the
positions, rounded once to float32, divided by the count.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.device import fma_f32, recip_f32

_TWO_PI_3 = float(np.float32(2.0 * math.pi / 3.0))
ORIENT_ITERATIONS = 8  # consensus sweeps (the reference's default)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's 3-term reduce sum(a * b, -1): fma(a2, b2, fma(a1, b1, a0*b0))."""
    return fma_f32(a[..., 2], b[..., 2], fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _msub(a, b, c, d):
    """a*b - c*d with the first product fused."""
    return fma_f32(a, b, -(c * d))


def _smallest_eigenvector_sym3(c00, c01, c02, c11, c12, c22):
    r3, r6 = recip_f32(3.0), recip_f32(6.0)
    s = (c00 + c11) + c22
    b00, b11, b22 = (fma_f32(-s, r3, c) for c in (c00, c11, c22))
    p1 = fma_f32(c12, c12, fma_f32(c01, c01, c02 * c02))
    p2 = fma_f32(2.0, p1, fma_f32(b22, b22, fma_f32(b00, b00, b11 * b11)))
    p = torch.sqrt(torch.maximum(p2 * r6, _f32(1e-20, p2)))
    ip = 1.0 / p
    d00, d11, d22 = b00 * ip, b11 * ip, b22 * ip
    d01, d02, d12 = c01 * ip, c02 * ip, c12 * ip
    t1 = _msub(d11, d22, d12, d12)
    t2 = _msub(d01, d22, d12, d02)
    t3 = _msub(d01, d12, d11, d02)
    detb = fma_f32(d02, t3, fma_f32(d00, t1, -(d01 * t2)))
    r = torch.clamp(detb * 0.5, -1.0, 1.0)
    arg = fma_f32(torch.acos(r), r3, _TWO_PI_3)
    lam = fma_f32(s, r3, (p + p) * torch.cos(arg))
    r0 = torch.stack([c00 - lam, c01, c02], -1)
    r1 = torch.stack([c01, c11 - lam, c12], -1)
    r2 = torch.stack([c02, c12, c22 - lam], -1)

    def cross(a, b):
        return torch.stack([_msub(a[..., 1], b[..., 2], a[..., 2], b[..., 1]),
                            _msub(a[..., 2], b[..., 0], a[..., 0], b[..., 2]),
                            _msub(a[..., 0], b[..., 1], a[..., 1], b[..., 0])], -1)

    v0, v1, v2 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n0, n1, n2 = dot3(v0, v0), dot3(v1, v1), dot3(v2, v2)
    best01 = torch.where((n0 >= n1)[:, None], v0, v1)
    nbest01 = torch.maximum(n0, n1)
    v = torch.where((nbest01 >= n2)[:, None], best01, v2)
    vnorm = torch.maximum(torch.sqrt(torch.maximum(nbest01, n2)), _f32(1e-20, n2))
    v = v / vnorm[:, None]
    iso = p2 < 1e-12
    return torch.where(iso[:, None], torch.tensor([0.0, 0.0, 1.0], device=v.device), v)


def pca_normals_plain(positions, nn_idx, nn_valid):
    """Plain PyTorch version of `pca_normals` (entry point 1 of kernel F)."""
    pos = positions.float()
    w = nn_valid.float()
    npos = pos[nn_idx.long()]                                    # (V, K, 3)
    cnt = torch.clamp(w.sum(1), min=1.0)
    # integer-valued terms below 2^24: the sum is exact in any order
    mean = (npos * w[..., None]).sum(1) / cnt[:, None]
    d = (npos - mean[:, None, :]) * w[..., None]
    c = [torch.zeros_like(cnt) for _ in range(6)]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    for k in range(d.shape[1]):
        for t, (a, b) in enumerate(pairs):
            c[t] = fma_f32(d[:, k, a], d[:, k, b], c[t])
    return _smallest_eigenvector_sym3(*c)


_PCA_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def pca_normals(positions, nn_idx, nn_valid):
    """Unit normals (V, 3) float32 from each voxel's neighbourhood
    covariance.  Kernel F on CUDA; the plain version for a CPU tensor."""
    if positions.device.type == "cpu":
        return pca_normals_plain(positions, nn_idx, nn_valid)
    d = positions.device
    V, K = nn_idx.shape
    dev.check_tensor(positions, "positions", torch.int32, d, 2)
    dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
    dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
    out = torch.empty((V, 3), dtype=torch.float32, device=d)
    fn = dev.load_kernel("segment").pca_normals
    fn.argtypes, fn.restype = _PCA_ARGS, ctypes.c_int
    rc = fn(dev.ptr(positions), dev.ptr(nn_idx), dev.ptr(nn_valid), V, K,
            dev.ptr(out), dev.stream_handle())
    dev.count_launch("segment", 1 if V else 0)
    dev.check_launch("segment", rc)
    return out


def orientation_centroid(positions, valid) -> tuple:
    """Mean position of the valid rows as three float32 values: the exact
    int64 sum, rounded once to float32, divided by the float32 count."""
    w = valid.to(torch.int64)
    total = (positions.to(torch.int64) * w[:, None]).sum(0).cpu().numpy()
    cnt = np.float32(max(int(w.sum()), 1))
    return tuple(float(np.float32(t) / cnt) for t in total)


def orient_normals_plain(positions, normals, nn_idx, nn_valid, valid):
    """Plain PyTorch version of the orientation (entry points 2 and 3 of
    kernel F)."""
    c = torch.tensor(orientation_centroid(positions, valid), device=normals.device)
    outward = positions.float() - c
    sign = torch.where(dot3(normals, outward) < 0.0, -1.0, 1.0)
    idx = nn_idx.long()
    for _ in range(ORIENT_ITERATIONS):
        ns = normals * sign[:, None]
        agree = dot3(ns[idx], ns[:, None, :])                   # (V, K)
        vote = torch.zeros_like(sign)
        for k in range(idx.shape[1]):
            vote = vote + torch.where(nn_valid[:, k], agree[:, k], torch.zeros_like(vote))
        sign = torch.where(vote < 0.0, -sign, sign)
    return normals * sign[:, None]


_INIT_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p] * 2
_STEP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3


def orient_normals(positions, normals, nn_idx, nn_valid, valid):
    """Sign-consistent orientation: radial start + ORIENT_ITERATIONS
    neighbour consensus sweeps (synchronous).  Kernel F on CUDA (one init
    launch, one launch per sweep); the plain version for a CPU tensor."""
    if positions.device.type == "cpu":
        return orient_normals_plain(positions, normals, nn_idx, nn_valid, valid)
    d = positions.device
    V, K = nn_idx.shape
    dev.check_tensor(positions, "positions", torch.int32, d, 2)
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
    dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
    cx, cy, cz = orientation_centroid(positions, valid)
    sign = torch.empty(V, dtype=torch.float32, device=d)
    other = torch.empty_like(sign)
    lib = dev.load_kernel("segment")
    init, step = lib.orient_init, lib.orient_step
    init.argtypes, init.restype = _INIT_ARGS, ctypes.c_int
    step.argtypes, step.restype = _STEP_ARGS, ctypes.c_int
    rc = init(dev.ptr(positions), dev.ptr(normals), V, cx, cy, cz, dev.ptr(sign),
              dev.stream_handle())
    dev.count_launch("segment", 1 if V else 0)
    dev.check_launch("segment", rc)
    for _ in range(ORIENT_ITERATIONS):
        rc = step(dev.ptr(normals), dev.ptr(nn_idx), dev.ptr(nn_valid), V, K,
                  dev.ptr(sign), dev.ptr(other), dev.stream_handle())
        dev.count_launch("segment", 1 if V else 0)
        dev.check_launch("segment", rc)
        sign, other = other, sign
    return normals * sign[:, None]


def compute_normals(positions, nn_idx, nn_valid, valid):
    """PCA normals + orientation: the reference's `compute_normals` for
    normalOrientation=1 (the consensus iteration), the one mode the port
    has; `Encoder` rejects the others."""
    n = pca_normals(positions, nn_idx, nn_valid)
    return orient_normals(positions, n, nn_idx, nn_valid, valid)
