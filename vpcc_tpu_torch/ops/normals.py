"""Normal estimation: PCA over k-NN neighbourhoods (K10, kernels F and X).

Behavioral reference: `vpcc_tpu/ops/normals.py` (the reference's
`PCCNormalsGenerator3`, PCCNormalsGenerator.cpp:61-185): per-voxel
covariance of the k nearest neighbours, closed-form smallest eigenvector
(kernel F), then the orientation of `normalOrientation`: 0 none; 1 and 3 a
radially-outward start and 8 neighbour sign-consensus sweeps (kernel F);
2 toward a viewpoint (kernel X); 4 the spanning-tree flood from the highest
point (kernel X).

Float32 in the reference's operation order, with `device.fma_f32` where
XLA's CPU backend contracts a multiply into an add (see csrc/segment.cu).
The eigen solver's arccos and cos are PyTorch's (plain version) or CUDA's
(kernel), not XLA's, so normals agree with the reference to a tolerance.
The orientation centroid is an exact int64 sum of the valid rows'
positions, rounded once to float32, divided by the float32 count: on the
host for the plain version (`orientation_centroid`), on the device in kernel
F's orientation launch and kernel X's flood (`orientation_centroid_device`
is its tensor twin).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.core.pointcloud import shape_bucket
from vpcc_tpu_torch.device import fma_f32, recip_f32

_TWO_PI_3 = float(np.float32(2.0 * math.pi / 3.0))
ORIENT_ITERATIONS = 8  # consensus sweeps (the reference's default)
FLOOD_MAX_SWEEPS = 256  # the spanning-tree flood's cap (the reference's max_iters)
FLOOD_VOTE_MIN = float(np.float32(1e-6))  # |vote| that signs an unsigned row


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
    fn = dev.kernel_fn("segment", "pca_normals", _PCA_ARGS)
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


def orientation_centroid_device(positions, valid) -> torch.Tensor:
    """`orientation_centroid` as a (3,) float32 tensor on the positions'
    device, with the same arithmetic and no host wait: what kernel F's
    orientation launch computes."""
    w = valid.to(torch.int64)
    total = (positions.to(torch.int64) * w[:, None]).sum(0)
    return total.to(torch.float32) / w.sum().clamp(min=1).to(torch.float32)


def orient_normals_plain(positions, normals, nn_idx, nn_valid, valid):
    """Plain PyTorch version of the orientation (kernel F's
    `orient_normals` entry)."""
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


def sweeps_run(changed: torch.Tensor) -> int:
    """Sweeps a launch of kernel F ran, from its per-sweep "changed" flags:
    through the first sweep that changed nothing, else all of them."""
    flags = changed.cpu().tolist()
    return flags.index(0) + 1 if 0 in flags else len(flags)


_ORIENT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] + [ctypes.c_void_p] * 4
_MAX_BLOCKS = 512   # kernel F's orientation: cooperative blocks at most (its per-block scratch)


def orient_normals(positions, normals, nn_idx, nn_valid, valid):
    """Sign-consistent orientation: radial start about the centroid of the
    `valid` rows, then ORIENT_ITERATIONS neighbour consensus sweeps
    (synchronous).  Kernel F on CUDA (one cooperative launch: the centroid,
    the radial sign and the sweeps, ending early once a sweep flips no
    sign; no host wait); the plain version for a CPU tensor."""
    if positions.device.type == "cpu":
        return orient_normals_plain(positions, normals, nn_idx, nn_valid, valid)
    return orient_launch(positions, normals, nn_idx, nn_valid, valid)[0]


def orient_launch(positions, normals, nn_idx, nn_valid, valid):
    """Kernel F's `orient_normals` entry on CUDA tensors: (oriented (V, 3),
    centroid (3,) float32, changed (ORIENT_ITERATIONS,) int32 flags, one a
    sweep); centroid and changed are None for V = 0 (no launch)."""
    d = positions.device
    V, K = nn_idx.shape
    dev.check_tensor(positions, "positions", torch.int32, d, 2)
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
    dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
    dev.check_tensor(valid, "valid", torch.bool, d, 1)
    out = torch.empty((V, 3), dtype=torch.float32, device=d)
    if V == 0:
        return out, None, None
    signs = torch.empty(2 * V, dtype=torch.uint8, device=d)
    dots = torch.empty(V * K, dtype=torch.float32, device=d)
    partials = torch.empty(4 * _MAX_BLOCKS, dtype=torch.int64, device=d)   # a block's centroid sums
    changed = torch.empty(ORIENT_ITERATIONS, dtype=torch.int32, device=d)
    centroid = torch.empty(3, dtype=torch.float32, device=d)
    fn = dev.kernel_fn("segment", "orient_normals", _ORIENT_ARGS)
    rc = fn(dev.ptr(positions), dev.ptr(normals), dev.ptr(nn_idx), dev.ptr(nn_valid),
            dev.ptr(valid), V, K, ORIENT_ITERATIONS, dev.ptr(signs), dev.ptr(dots),
            dev.ptr(partials), _MAX_BLOCKS, dev.ptr(changed), dev.ptr(centroid), dev.ptr(out),
            dev.stream_handle())
    dev.count_launch("segment")
    dev.check_launch("segment", rc)
    return out, centroid, changed


# ---------------------------------------------------------------------------
# normalOrientation 2: toward a viewpoint (kernel X, `orient_viewpoint`)

def orient_normals_viewpoint_plain(normals, positions, viewpoint):
    """Plain PyTorch version of `orient_normals_viewpoint`."""
    vp = torch.tensor([float(np.float32(v)) for v in viewpoint], dtype=torch.float32,
                      device=normals.device)
    to_vp = vp - positions.float()
    sign = torch.where(dot3(normals, to_vp) < 0.0, -1.0, 1.0)
    return normals * sign[:, None]


_VP_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p] * 2


def orient_normals_viewpoint(normals, positions, viewpoint):
    """View-point orientation (reference `orient_normals_viewpoint`,
    vpcc_tpu/ops/normals.py:146; PCCNormalsGenerator.cpp:289-300): every
    normal flips toward `viewpoint` (three floats, taken as float32): the
    sign of dot(n, viewpoint - position), +1 at 0.  Kernel X on CUDA (one
    launch); the plain version for a CPU tensor."""
    if normals.device.type == "cpu":
        return orient_normals_viewpoint_plain(normals, positions, viewpoint)
    d = normals.device
    V = normals.shape[0]
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    dev.check_tensor(positions, "positions", torch.int32, d, 2)
    out = torch.empty_like(normals)
    fn = dev.kernel_fn("orient", "orient_viewpoint", _VP_ARGS)
    vx, vy, vz = (float(np.float32(v)) for v in viewpoint)
    rc = fn(dev.ptr(normals), dev.ptr(positions), V, vx, vy, vz, dev.ptr(out),
            dev.stream_handle())
    dev.count_launch("orient_viewpoint", 1 if V else 0)
    dev.check_launch("orient_viewpoint", rc)
    return out


# ---------------------------------------------------------------------------
# normalOrientation 4: the spanning-tree flood (kernel X, `flood_*`)
#
# The reference runs without 64-bit integers (jax_enable_x64 is off), so its
# seed key z * 2^22 + y * 2^11 + x is an int32 that wraps for z >= 512, and
# its key for invalid and padded rows, int64(-1) << 60, is 0.  The port
# reproduces both (ROADMAP F3): where every valid key is negative, the seed
# is the first padded row, which signs nothing, and every row takes the
# radial sign.

def seed_keys(positions, valid):
    """(V,) int64 holding the reference's int32 seed keys (wrapped); 0 for
    invalid rows."""
    p = positions.to(torch.int64)
    key = (p[:, 2] << 22) + (p[:, 1] << 11) + p[:, 0]
    key = ((key + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return torch.where(valid, key, torch.zeros_like(key))


def flood_seed(positions, normals, valid, pad_rows: bool):
    """(seed row or -1, its sign): the first row of the largest key; -1 where
    the reference's padded rows (key 0) win, which happens only when every
    key is negative."""
    if positions.shape[0] == 0:
        return -1, 1.0
    key = seed_keys(positions, valid)
    seed = int(torch.argmax(key))   # the first maximum, as jnp.argmax
    if pad_rows and int(key[seed]) < 0:
        return -1, 1.0
    return seed, (-1.0 if float(normals[seed, 2]) < 0.0 else 1.0)


def flood_votes_plain(normals, nn_idx, nn_valid, sign):
    """(V,) float32 votes of one sweep: sum over k of
    dot(n[nn[k]], n) * sign[nn[k]] * mask[k], the dot as XLA's fma chain,
    summed over k in order from 0."""
    idx = nn_idx.long()
    dot = dot3(normals[idx], normals[:, None, :])                   # (V, K)
    terms = dot * sign[idx] * nn_valid.float()
    vote = torch.zeros_like(sign)
    for k in range(idx.shape[1]):
        vote = vote + terms[:, k]
    return vote


def radial_signs(positions, normals, valid):
    """(V,) float32 radial sign about `orientation_centroid`, +1 at 0."""
    c = torch.tensor(orientation_centroid(positions, valid), device=normals.device)
    return torch.where(dot3(normals, positions.float() - c) < 0.0, -1.0, 1.0)


def orient_normals_spanning_tree_plain(positions, normals, nn_idx, nn_valid, valid,
                                       pad_rows: bool = False):
    """Plain PyTorch version of `orient_normals_spanning_tree`: (oriented
    normals, sweeps that signed a row)."""
    V = positions.shape[0]
    seed, seed_sign = flood_seed(positions, normals, valid, pad_rows)
    sign = torch.zeros(V, dtype=torch.float32, device=normals.device)
    if seed >= 0:
        sign[seed] = seed_sign
    sweeps = 0
    for _ in range(FLOOD_MAX_SWEEPS):
        if not bool(((sign == 0.0) & valid).any()):
            break
        vote = flood_votes_plain(normals, nn_idx, nn_valid, sign)
        newly = (sign == 0.0) & valid & (vote.abs() > FLOOD_VOTE_MIN)
        if not bool(newly.any()):
            break   # nothing changes in any later sweep
        sign = torch.where(newly, torch.where(vote < 0.0, -1.0, 1.0), sign)
        sweeps += 1
    sign = torch.where(sign == 0.0, radial_signs(positions, normals, valid), sign)
    return normals * sign[:, None], sweeps


_FLOOD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 \
    + [ctypes.POINTER(ctypes.c_int)]
_FLOOD_SWEEPS_WORD = 6   # csrc/orient.cu: the header word of the sweeps that signed

last_flood_sweeps = 0   # sweeps that signed a row in the last flood


@functools.lru_cache(maxsize=64)
def flood_scratch_words(V: int, K: int) -> int:
    """int32 words of scratch kernel X's flood takes for V rows of K
    neighbours (csrc/orient.cu plans them)."""
    fn = dev.kernel_fn("orient", "flood_scratch_words", [ctypes.c_int] * 2)
    fn.restype = ctypes.c_longlong
    return fn(V, K)


def orient_normals_spanning_tree(positions, normals, nn_idx, nn_valid, valid,
                                 pad_rows: bool = False):
    """Spanning-tree orientation as a flood (reference
    `orient_normals_spanning_tree`, vpcc_tpu/ops/normals.py:158;
    PCCNormalsGenerator.cpp:186-252): the seed is the row of the largest
    (z, y, x) key (see `seed_keys`), its normal forced upward; each
    synchronous sweep gives every unsigned row whose vote
    sum_k dot(n_k, n) * sign_k exceeds 1e-6 in magnitude the vote's sign;
    at most 256 sweeps; rows never reached take the radial sign.  Only
    valid rows are signed by a vote (the reference's invalid rows are its
    padded rows, which have no valid neighbour and so no vote).
    `pad_rows`: the reference's arrays hold padded rows after these (their
    key 0 joins the seed's argmax).  Sets `last_flood_sweeps`.  Kernel X on
    CUDA: three launches and one host read (the sweep count): a cooperative
    prep (the reverse adjacency by a counting sort, the seed, the centroid),
    one cluster of CTAs walking the frontier sweep by sweep (only rows next
    to a row signed in the sweep before vote; the stop decided on the card),
    and the finish; where the card cannot place the prep's grid or the
    cluster, the call raises.  The plain version for a CPU tensor."""
    global last_flood_sweeps
    if positions.device.type == "cpu":
        out, last_flood_sweeps = orient_normals_spanning_tree_plain(
            positions, normals, nn_idx, nn_valid, valid, pad_rows)
        return out
    d = positions.device
    V, K = nn_idx.shape
    dev.check_tensor(positions, "positions", torch.int32, d, 2)
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
    dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
    dev.check_tensor(valid, "valid", torch.bool, d, 1)
    if V * max(K, 1) >= 1 << 31:
        raise ValueError(f"orient_normals_spanning_tree: {V} x {K} neighbour slots")
    out = torch.empty_like(normals)
    last_flood_sweeps = 0
    if V == 0:
        return out
    scratch = dev.scratch("orient", d, flood_scratch_words(V, K))
    launched = ctypes.c_int(0)
    rc = dev.kernel_fn("orient", "flood", _FLOOD_ARGS)(
        dev.ptr(positions), dev.ptr(normals), dev.ptr(nn_idx), dev.ptr(nn_valid),
        dev.ptr(valid), V, K, int(pad_rows), FLOOD_MAX_SWEEPS, dev.ptr(scratch), dev.ptr(out),
        dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("orient", launched.value)
    dev.check_launch("orient", rc)
    last_flood_sweeps = int(scratch[_FLOOD_SWEEPS_WORD])
    return out


def orient_by_mode(positions, normals, nn_idx, nn_valid, valid, mode: int = 1,
                   viewpoint=(0.0, 0.0, 0.0)):
    """The orientation of normalOrientation `mode` applied to PCA normals,
    the reference's `compute_normals` dispatch (vpcc_tpu/ops/normals.py:
    122-142): 0 none, 2 toward `viewpoint`, 4 the spanning-tree flood, 1
    and 3 the consensus iteration.  The flood's seed sees the padded rows
    the reference's shape bucket would add to `positions`
    (`shape_bucket`)."""
    if mode == 0:
        return normals
    if mode == 2:
        return orient_normals_viewpoint(normals, positions, viewpoint)
    if mode == 4:
        V = positions.shape[0]
        return orient_normals_spanning_tree(positions, normals, nn_idx, nn_valid, valid,
                                            pad_rows=shape_bucket(V) > V)
    return orient_normals(positions, normals, nn_idx, nn_valid, valid)


def compute_normals(positions, nn_idx, nn_valid, valid, mode: int = 1,
                    viewpoint=(0.0, 0.0, 0.0)):
    """PCA normals + the orientation of `mode` (`orient_by_mode`)."""
    n = pca_normals(positions, nn_idx, nn_valid)
    return orient_by_mode(positions, n, nn_idx, nn_valid, valid, mode, viewpoint)
