"""Projection-plane segmentation: initial partition + smoothness refinement
(K10, kernel F).

Behavioral reference: `vpcc_tpu/ops/segmentation.py` (the reference's
`initialSegmentation`, PCCPatchSegmenter.cpp:217-265, and
`refineSegmentation`, :1322): per voxel, argmax over the projection
orientations of normal . orientation (x axis weight), then `iterations`
synchronous sweeps maximizing normal . orientation + (lambda / k) * (number
of valid neighbours in that orientation), first maximum on ties; for
highGradientSeparation, each voxel's best other orientation and whether its
assigned orientation's score is at most 0.577 (`high_gradient_aux`).

The tables (orientation sets, `VIEW_AXES`, `partition_to_view`) are copies
of the reference's.  The score arithmetic follows XLA's CPU backend: the
dot products as fma chains (exact for the 6 axis orientations) and the
refine score as fma(lambda / k, votes, base).  On CUDA the encoder's
initial + refined partition is one cooperative launch of kernel F
(`segment_partitions`), whose sweeps end early, with the same result, once
a sweep moves no partition.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.device import fma_f32

_S2 = math.sqrt(2.0) / 2.0

ORIENTATIONS6 = np.array(
    [
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    ],
    np.float32,
)

# additionalProjectionPlaneMode 1 (Y-axis rotated planes), 2 (X), 3 (Z)
# (reference: PCCPatchSegmenter.h:323-364)
ORIENTATIONS10_Y = np.concatenate(
    [ORIENTATIONS6, np.array([[_S2, 0, _S2], [-_S2, 0, _S2], [-_S2, 0, -_S2], [_S2, 0, -_S2]], np.float32)]
)
ORIENTATIONS10_X = np.concatenate(
    [ORIENTATIONS6, np.array([[0, _S2, _S2], [0, _S2, -_S2], [0, -_S2, -_S2], [0, -_S2, _S2]], np.float32)]
)
ORIENTATIONS10_Z = np.concatenate(
    [ORIENTATIONS6, np.array([[_S2, _S2, 0], [_S2, -_S2, 0], [-_S2, -_S2, 0], [-_S2, _S2, 0]], np.float32)]
)

# additionalProjectionPlaneMode 4: all 18 orientations (reference:
# orientations18, PCCPatchSegmenter.h:371-395)
ORIENTATIONS18 = np.concatenate(
    [ORIENTATIONS6, ORIENTATIONS10_Y[6:], ORIENTATIONS10_X[6:],
     ORIENTATIONS10_Z[6:]]
)


def partition_to_view(partition: int, additional_plane_mode: int) -> int:
    """Map a segmentation partition id to the VIEW_AXES row (reference:
    PCCPatch.cpp:111 view table)."""
    if partition < 6 or additional_plane_mode <= 0:
        return int(partition)
    if additional_plane_mode == 4:
        return int(partition)
    return int(partition) + 4 * (additional_plane_mode - 1)


def get_orientations(additional_plane_mode: int) -> np.ndarray:
    if additional_plane_mode == 0:
        return ORIENTATIONS6
    if additional_plane_mode == 1:
        return ORIENTATIONS10_Y
    if additional_plane_mode == 2:
        return ORIENTATIONS10_X
    if additional_plane_mode == 3:
        return ORIENTATIONS10_Z
    if additional_plane_mode == 4:
        return ORIENTATIONS18
    raise ValueError(f"additionalProjectionPlaneMode={additional_plane_mode}")


# viewId -> (axisOfAdditionalPlane, normalAxis, tangentAxis, bitangentAxis,
# projectionMode)   (reference: source/lib/PccLibCommon/source/PCCPatch.cpp:111)
VIEW_AXES = np.array(
    [
        [0, 0, 2, 1, 0],
        [0, 1, 2, 0, 0],
        [0, 2, 0, 1, 0],
        [0, 0, 2, 1, 1],
        [0, 1, 2, 0, 1],
        [0, 2, 0, 1, 1],
        [1, 0, 2, 1, 0],
        [1, 2, 0, 1, 0],
        [1, 0, 2, 1, 1],
        [1, 2, 0, 1, 1],
        [2, 2, 0, 1, 0],
        [2, 1, 2, 0, 0],
        [2, 2, 0, 1, 1],
        [2, 1, 2, 0, 1],
        [3, 1, 2, 0, 0],
        [3, 0, 2, 1, 0],
        [3, 1, 2, 0, 1],
        [3, 0, 2, 1, 1],
    ],
    np.int32,
)

_MAX_J = 18


def _scores(normals, orientations):
    """(V, J) normal . orientation as XLA's fma chain."""
    n, o = normals[:, None, :], orientations[None, :, :]
    return fma_f32(n[..., 2], o[..., 2], fma_f32(n[..., 1], o[..., 1], n[..., 0] * o[..., 0]))


def initial_segmentation_plain(normals, orientations, weights):
    score = _scores(normals, orientations) * weights[None, :]
    # orientation 0 is unweighted: the reference takes its raw score as the
    # initial best (segmentation.py:120-123)
    score[:, 0] = _scores(normals, orientations[:1])[:, 0]
    return torch.argmax(score, dim=1).to(torch.int32)


def refine_segmentation_plain(normals, partition, nn_idx, nn_valid, orientations,
                              lambda_: float, iterations: int):
    J = orientations.shape[0]
    base = _scores(normals, orientations)
    k_norm = torch.clamp(nn_valid.sum(1, keepdim=True), min=1).float()
    lk = torch.full((), lambda_, dtype=torch.float32, device=normals.device) / k_norm
    idx = nn_idx.long()
    part = partition
    for _ in range(iterations):
        onehot = torch.nn.functional.one_hot(part.long()[idx], J) * nn_valid[..., None]
        votes = onehot.sum(1).float()
        score = fma_f32(lk, votes, base)
        # torch.argmax returns the first maximum, as jnp.argmax does
        part = torch.argmax(score, dim=1).to(torch.int32)
    return part


WEAK_SCORE = float(np.float32(0.577))  # the reference's normalThreshold, as float32
_ASSIGNED_PENALTY = 1e9                 # subtracted from the assigned orientation's score


def high_gradient_aux_plain(normals, partition, orientations):
    """Plain PyTorch version of `high_gradient_aux`."""
    score = _scores(normals, orientations)
    part = partition.long()[:, None]
    weak = score.gather(1, part)[:, 0] <= WEAK_SCORE
    onehot = torch.zeros_like(score, dtype=torch.bool).scatter_(1, part, True)
    masked = torch.where(onehot, score - _ASSIGNED_PENALTY, score)
    return torch.argmax(masked, dim=1).to(torch.int32), weak


_AUX_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3


def high_gradient_aux(normals, partition, orientations):
    """Per-voxel aids of the high-gradient separation (reference
    `high_gradient_aux`, vpcc_tpu/ops/segmentation.py:128; the reference
    uses the normal scores inside calculateGradient,
    PCCPatchSegmenter.cpp:1874-1940): (alt, weak), `alt` (V,) int32 the
    first argmax of the scores with the assigned orientation's lowered by
    1e9 (in float32), `weak` (V,) bool the assigned orientation's score <=
    0.577.  Kernel F on CUDA (one launch); the plain version for a CPU
    tensor."""
    if normals.device.type == "cpu":
        return high_gradient_aux_plain(normals, partition, orientations)
    d = normals.device
    V = normals.shape[0]
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    dev.check_tensor(partition, "partition", torch.int32, d, 1)
    _check_orients(orientations, d)
    alt = torch.empty(V, dtype=torch.int32, device=d)
    weak = torch.empty(V, dtype=torch.bool, device=d)
    fn = dev.kernel_fn("segment", "high_gradient_aux", _AUX_ARGS)
    rc = fn(dev.ptr(normals), dev.ptr(orientations), dev.ptr(partition), V,
            orientations.shape[0], dev.ptr(alt), dev.ptr(weak), dev.stream_handle())
    dev.count_launch("high_gradient_aux", 1 if V else 0)
    dev.check_launch("high_gradient_aux", rc)
    return alt, weak


def _check_orients(orientations, d):
    J = orientations.shape[0]
    if not 1 <= J <= _MAX_J:
        raise ValueError(f"{J} orientations (at most {_MAX_J})")
    dev.check_tensor(orientations, "orientations", torch.float32, d, 2)


_PART_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int] \
    + [ctypes.c_void_p] * 6


def initial_segmentation(normals, orientations, weights):
    """(V,) int32 partition: argmax over orientations of the weighted score.
    Kernel F on CUDA (its partition launch with no sweeps); the plain
    version for a CPU tensor."""
    if normals.device.type == "cpu":
        return initial_segmentation_plain(normals, orientations, weights)
    return partition_launch(normals, orientations, weights, None, None, 0.0, 0, None)[0]


def partition_launch(normals, orientations, weights, nn_idx, nn_valid, lambda_: float,
                     iterations: int, part_in):
    """Kernel F's `segment_partition` entry on CUDA tensors: the initial
    partition (part_in None) or `part_in`, then `iterations` refinement
    sweeps.  Returns (initial or None, refined, changed): changed is the
    (iterations,) int32 flags, one a sweep, None for V = 0 (no launch).
    With no sweeps, nn_idx and nn_valid may be None."""
    d = normals.device
    V, J = normals.shape[0], orientations.shape[0]
    dev.check_tensor(normals, "normals", torch.float32, d, 2)
    _check_orients(orientations, d)
    if iterations < 0:
        raise ValueError(f"{iterations} refinement iterations")
    null = ctypes.c_void_p(None)
    if nn_idx is None:
        if iterations:
            raise ValueError("refinement sweeps need the neighbour table")
        K, idx_p, valid_p = 0, null, null
    else:
        dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
        dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
        K, idx_p, valid_p = nn_idx.shape[1], dev.ptr(nn_idx), dev.ptr(nn_valid)
    initial = None
    if part_in is None:
        dev.check_tensor(weights, "weights", torch.float32, d, 1)
        initial = torch.empty(V, dtype=torch.int32, device=d)
    else:
        dev.check_tensor(part_in, "partition", torch.int32, d, 1)
    refined = torch.empty(V, dtype=torch.int32, device=d)
    if V == 0:
        return initial, refined, None
    scratch = torch.empty(2 * V, dtype=torch.uint8, device=d)
    changed = torch.empty(max(iterations, 1), dtype=torch.int32, device=d)
    fn = dev.kernel_fn("segment", "segment_partition", _PART_ARGS)
    rc = fn(dev.ptr(normals), dev.ptr(orientations),
            dev.ptr(weights) if part_in is None else null, idx_p, valid_p,
            V, K, J, float(lambda_), iterations,
            null if part_in is None else dev.ptr(part_in),
            dev.ptr(initial) if part_in is None else null, dev.ptr(scratch),
            dev.ptr(changed), dev.ptr(refined), dev.stream_handle())
    dev.count_launch("segment")
    dev.check_launch("segment", rc)
    return initial, refined, changed[:iterations]


def refine_segmentation(normals, partition, nn_idx, nn_valid, orientations,
                        lambda_: float, iterations: int):
    """Smoothness-regularized re-assignment, `iterations` synchronous
    sweeps from `partition`.  Kernel F on CUDA (one cooperative launch, the
    sweeps ending early once one moves no partition); the plain version for
    a CPU tensor."""
    if normals.device.type == "cpu":
        return refine_segmentation_plain(normals, partition, nn_idx, nn_valid,
                                         orientations, lambda_, iterations)
    return partition_launch(normals, orientations, None, nn_idx, nn_valid, lambda_,
                            iterations, partition)[1]


def segment_partitions(normals, orientations, weights, nn_idx, nn_valid, lambda_: float,
                       iterations: int):
    """(initial, refined) (V,) int32 partitions: `initial_segmentation`,
    then `refine_segmentation` from it.  Kernel F on CUDA (both in one
    cooperative launch, no host wait); the two plain versions in turn for a
    CPU tensor."""
    if normals.device.type == "cpu":
        initial = initial_segmentation_plain(normals, orientations, weights)
        return initial, refine_segmentation_plain(normals, initial, nn_idx, nn_valid,
                                                  orientations, lambda_, iterations)
    return partition_launch(normals, orientations, weights, nn_idx, nn_valid, lambda_,
                            iterations, None)[:2]
