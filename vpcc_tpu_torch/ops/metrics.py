"""Objective quality metrics (K14, kernel R): D1 (point-to-point), D2
(point-to-plane) and color PSNR, the PccLibMetrics equivalent, on the device.

Behavioral reference: `vpcc_tpu/ops/metrics.py` (the reference's
PCCMetrics.cpp: `getPSNR` :42, `QualityMetrics::compute` :73-230, the
symmetric merge :289-322).  Each direction A -> B finds, for every A point,
its nearest B point with the grid k-NN (kernel E, `neighbors.nearest`); a
query with no grid neighbour (d2 >= MAX_DIST2) is searched exactly on the
host with scipy's cKDTree, as the reference does.  Kernel R
(csrc/metrics.cu, `metrics_reduce`) then gathers B at the nearest index and
reduces the per-point errors to sums.

The JAX reference evaluates `_directional` op by op (it is not jitted), so
every float32 operation rounds on its own: no fused multiply-adds and true
divisions by 255.  The per-point terms here round the same way, in the
same order; the point-to-plane and color sums run in float64 (the
reference sums them in float32, which a tolerance covers), the d2 maximum
in int64.  The D1 MSE divides the reference's float32 sum of the
d2 rows, taken in XLA's CPU order over its shape-bucket length
(`d2_sum_f32`), by the point count: past 2^24 that sum rounds.

Unlike the reference, nothing is padded to a shape bucket: the reference's
pad rows carry weight 0 and lie outside every grid cell, so they change no
result; only the D1 sum's order depends on the bucket length.  Everything stays on the device but the miss check, the rows that
missed and the final sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import sys
from typing import Optional

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.core.pointcloud import shape_bucket
from vpcc_tpu_torch.ops import neighbors, normals as normals_mod


def rgb_to_yuv_bt709(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8/int -> (..., 3) float32 YUV in [0, 1] (reference:
    PCCMetrics.cpp:49-55), each operation one float32 rounding, division by
    255 a true division (a device tensor divisor: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal)."""
    r = rgb[..., 0].float()
    g = rgb[..., 1].float()
    b = rgb[..., 2].float()
    k = torch.full((), 255.0, dtype=torch.float32, device=rgb.device)
    y = (0.2126 * r + 0.7152 * g + 0.0722 * b) / k
    u = (-0.1146 * r - 0.3854 * g + 0.5000 * b) / k + 0.5
    v = (0.5000 * r - 0.4542 * g - 0.0458 * b) / k + 0.5
    return torch.stack([y, u, v], dim=-1)


@dataclasses.dataclass
class FrameMetrics:
    c2c_mse: float
    c2c_psnr: float
    c2p_mse: float
    c2p_psnr: float
    color_psnr: tuple  # (Y, U, V)
    c2c_hausdorff: float = 0.0
    c2c_hausdorff_psnr: float = float("inf")
    reflectance_psnr: float = float("inf")

    def summary(self) -> str:
        return (
            f"D1 {self.c2c_psnr:8.4f} dB  D2 {self.c2p_psnr:8.4f} dB  "
            f"Y {self.color_psnr[0]:8.4f}  U {self.color_psnr[1]:8.4f}  "
            f"V {self.color_psnr[2]:8.4f}"
        )


# ---------------------------------------------------------------------------
# kernel R: the per-point errors of one direction, reduced

def metrics_reduce_plain(pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a: int):
    """Plain version of kernel R.  For A rows below `cnt_a`, with B gathered
    at `idx`: returns (dmax 0-d int64, the maximum d2; fsums float64 [sum of
    ((a - b) . n_b)^2, sums of the squared Y, U, V errors]).  The D1 sum is
    `d2_sum_f32`'s.  Normals or
    colors that are None give zero sums."""
    d = pos_a.device
    i = idx[:cnt_a].long()
    dd = d2[:cnt_a].long()
    zero = torch.zeros((), dtype=torch.int64, device=d)
    dmax = dd.max() if cnt_a else zero
    fsums = torch.zeros(4, dtype=torch.float64, device=d)
    if normals_b is not None:
        prod = (pos_a[:cnt_a] - pos_b[i]).float() * normals_b[i]
        proj = (prod[:, 0] + prod[:, 1]) + prod[:, 2]
        fsums[0] = (proj * proj).double().sum()
    if col_a is not None and col_b is not None:
        ce = rgb_to_yuv_bt709(col_a[:cnt_a]) - rgb_to_yuv_bt709(col_b[i])
        fsums[1:] = (ce * ce).double().sum(0)
    return dmax, fsums


_BLOCKS_MAX = 1024


def xla_windows(m: int) -> list:
    """The window widths of XLA's CPU tree reduction of an m-element
    float32 vector, level by level: 32 where 32 divides the length, else
    its largest divisor <= 32, while more than 32 elements remain; then one
    window over the rest."""
    widths = []
    while m > 32:
        w = next(w for w in range(32, 0, -1) if m % w == 0)
        if w < 2:
            raise ValueError(f"no reduction window for length {m}")
        widths.append(w)
        m //= w
    return widths + [m]


def d2_sum_f32_plain(d2: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """Plain version of kernel R's D1 sum: the float32 sum of d2[:n]
    padded with zeros to `cap` rows, as the reference's eager `jnp.sum`
    takes it on XLA's CPU backend (vpcc_tpu/ops/metrics.py:87): windows of
    `xla_windows(cap)` consecutive elements, each summed sequentially from
    0, level by level.  Returns a 0-d float32 tensor."""
    x = torch.zeros(cap, dtype=torch.float32, device=d2.device)
    x[:n] = d2[:n].float()
    for w in xla_windows(cap):
        x = x.reshape(-1, w)
        acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for j in range(w):
            acc = acc + x[:, j]
        x = acc
    return x[0]


def d2_sum_f32(d2: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """Kernel R, `metrics_d2_f32`: `d2_sum_f32_plain` on the card, one
    launch per level, one thread per window; the plain version for CPU
    tensors."""
    if d2.device.type == "cpu":
        return d2_sum_f32_plain(d2, n, cap)
    d = d2.device
    dev.check_tensor(d2, "d2", torch.int32, d, 1)
    widths = xla_windows(cap)
    if not 0 <= n <= d2.shape[0]:
        raise ValueError(f"d2_sum_f32: n={n} outside the {d2.shape[0]} rows")
    scratch, m = 0, cap
    for w in widths[:-1]:
        m //= w
        scratch += m
    buf = torch.empty(max(scratch, 1), dtype=torch.float32, device=d)
    out = torch.empty((), dtype=torch.float32, device=d)
    fn = dev.load_kernel("metrics").metrics_d2_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(d2), n, cap, dev.ptr(buf), dev.ptr(out), ctypes.byref(launched),
            dev.stream_handle())
    dev.count_launch("metrics_d2_f32", launched.value)
    dev.check_launch("metrics_d2_f32", rc)
    return out


def metrics_reduce(pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a: int):
    """Kernel R (csrc/metrics.cu): `metrics_reduce_plain` on the card, one
    thread per A row in a fixed grid-stride order and a two-pass block
    reduction (deterministic: no float atomics); the plain version for CPU
    tensors."""
    if pos_a.device.type == "cpu":
        return metrics_reduce_plain(pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a)
    d = pos_a.device
    dev.check_tensor(pos_a, "pos_a", torch.int32, d, 2)
    dev.check_tensor(pos_b, "pos_b", torch.int32, d, 2)
    dev.check_tensor(idx, "idx", torch.int32, d, 1)
    dev.check_tensor(d2, "d2", torch.int32, d, 1)
    with_col = col_a is not None and col_b is not None
    if with_col:
        dev.check_tensor(col_a, "col_a", torch.uint8, d, 2)
        dev.check_tensor(col_b, "col_b", torch.uint8, d, 2)
    if normals_b is not None:
        dev.check_tensor(normals_b, "normals_b", torch.float32, d, 2)
    if not 0 <= cnt_a <= min(pos_a.shape[0], idx.shape[0], d2.shape[0]):
        raise ValueError(f"metrics_reduce: cnt_a={cnt_a} outside the A rows")
    blocks = max(1, min(_BLOCKS_MAX, -(-cnt_a // 256)))
    part_i = torch.empty(blocks, dtype=torch.int64, device=d)
    part_f = torch.empty((blocks, 4), dtype=torch.float64, device=d)
    dmax = torch.empty((), dtype=torch.int64, device=d)
    fsums = torch.empty(4, dtype=torch.float64, device=d)
    null = ctypes.c_void_p(0)
    fn = dev.load_kernel("metrics").metrics_reduce
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    rc = fn(dev.ptr(pos_a), dev.ptr(col_a) if with_col else null, dev.ptr(pos_b),
            dev.ptr(col_b) if with_col else null,
            null if normals_b is None else dev.ptr(normals_b), dev.ptr(idx), dev.ptr(d2),
            cnt_a, blocks, dev.ptr(part_i), dev.ptr(part_f), dev.ptr(dmax), dev.ptr(fsums),
            dev.stream_handle())
    dev.count_launch("metrics", 2)
    dev.check_launch("metrics", rc)
    return dmax, fsums


# ---------------------------------------------------------------------------
# host API

def _tensor(x, dtype: torch.dtype, np_dtype, d: torch.device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(device=d, dtype=dtype).contiguous()
    return torch.as_tensor(np.array(x, np_dtype, copy=True), device=d)


def _positions(x, d):
    return _tensor(x, torch.int32, np.int32, d)


def _nearest_exact(pos_a, pos_b, grid_bits: int):
    """Nearest B point of every A row: kernel E's grid search, and for the
    rows it misses (d2 >= MAX_DIST2) the reference's exact host KD search
    (metrics.py:73-84).  Returns (idx, d2) int32 on the device."""
    idx, d2 = neighbors.nearest(neighbors.build_grid(pos_b, grid_bits), pos_a)
    missed = d2 >= neighbors.MAX_DIST2
    n_missed = int(missed.sum())
    if n_missed:
        from scipy.spatial import cKDTree

        rows = torch.nonzero(missed).flatten()
        pb = pos_b.cpu().numpy()
        dd, ii = cKDTree(pb).query(pos_a[rows].cpu().numpy().astype(np.float64))
        idx = idx.clone()
        d2 = d2.clone()
        idx[rows] = torch.as_tensor(ii.astype(np.int32), device=idx.device)
        d2[rows] = torch.as_tensor(np.round(dd * dd).astype(np.int32), device=d2.device)
        print(f"metrics: {n_missed} of {pos_a.shape[0]} queries had no grid neighbour; "
              "searched on the host (cKDTree)", file=sys.stderr)
    return idx, d2


def _directional(pos_a, col_a, cnt_a, pos_b, col_b, normals_b, grid_bits):
    """A -> B: for each A point, the nearest B point.  Returns (mse_c2c,
    mse_c2p, mse_color (3,) float64 numpy, hausdorff) on the host."""
    idx, d2 = _nearest_exact(pos_a[:cnt_a], pos_b, grid_bits)
    dmax, fsums = metrics_reduce(pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a)
    max_d2 = int(dmax)
    s_d2 = d2_sum_f32(d2, cnt_a, shape_bucket(cnt_a)).cpu().numpy()
    fs = fsums.cpu().numpy()
    num = max(cnt_a, 1)
    mse_c2c = float(np.float32(s_d2) / np.float32(num))
    haus = float(np.float32(max_d2))
    mse_c2p = mse_c2c if normals_b is None else float(fs[0] / num)
    with_col = col_a is not None and col_b is not None
    mse_col = fs[1:] / num if with_col else np.zeros(3)
    return mse_c2c, mse_c2p, mse_col, haus


def estimate_normals(pos, grid_bits: int, k: int = 16, device=None,
                     bucket: int = 12) -> torch.Tensor:
    """PCA normals of a cloud (the reference's `estimate_normals`: k-NN on
    kernel E with bucket 12, then kernel F's PCA and consensus orientation;
    `apps/normal_generator` asks for the k-NN's default bucket, 16, as its
    reference does).  Returns (N, 3) float32 on the device."""
    d = dev.resolve_device(device)
    p = _positions(pos, d)
    grid = neighbors.build_grid(p, grid_bits)
    nn_idx, nn_d2 = neighbors.knn(grid, p, k=k, bucket=bucket)
    valid = torch.ones(p.shape[0], dtype=torch.bool, device=d)
    return normals_mod.compute_normals(p, nn_idx, nn_d2 < neighbors.MAX_DIST2, valid)


def transfer_normals(src_pos, src_normals, dst_pos, grid_bits: int, device=None) -> torch.Tensor:
    """Nearest-neighbour normal transfer source -> reconstruction (kernel
    E).  A query with no grid neighbour takes source row 0's normal, as the
    reference's `clip(idx, 0, n - 1)` gives it."""
    d = dev.resolve_device(device)
    ps = _positions(src_pos, d)
    idx, _ = neighbors.nearest(neighbors.build_grid(ps, grid_bits), _positions(dst_pos, d))
    nrm = _tensor(src_normals, torch.float32, np.float32, d)
    return nrm[idx.long().clamp(0, ps.shape[0] - 1)]


def _psnr(mse: float, peak: float, factor: float = 1.0) -> float:
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(factor * peak * peak / mse)


def compute_metrics(
    src_pos,
    src_col,
    rec_pos,
    rec_col,
    resolution: int,
    src_normals=None,
    rec_normals=None,
    grid_bits: int = 10,
    with_d2: bool = False,
    src_refl=None,
    rec_refl=None,
    device=None,
) -> FrameMetrics:
    """Symmetric metrics between source and reconstructed clouds.
    Positions (N, 3) int, colors (N, 3) uint8 or None, normals (N, 3)
    float32 or None: numpy arrays or tensors.  with_d2=True estimates the
    source normals (PCA) and transfers them to the reconstruction, so that
    D2 is a point-to-plane PSNR when the caller has no normals.  Runs on
    `device` (CUDA unless the caller asks for the CPU)."""
    d = dev.resolve_device(device)
    pa, pb = _positions(src_pos, d), _positions(rec_pos, d)
    ca = _tensor(src_col, torch.uint8, np.uint8, d)
    cb = _tensor(rec_col, torch.uint8, np.uint8, d)
    if with_d2 and src_normals is None:
        src_normals = estimate_normals(pa, grid_bits, device=d)
    na = _tensor(src_normals, torch.float32, np.float32, d)
    nb = _tensor(rec_normals, torch.float32, np.float32, d)
    if na is not None and nb is None:
        nb = transfer_normals(pa, na, pb, grid_bits, device=d)

    ab = _directional(pa, ca, pa.shape[0], pb, cb, nb, grid_bits)
    ba = _directional(pb, cb, pb.shape[0], pa, ca, na, grid_bits)
    c2c = max(ab[0], ba[0])
    c2p = max(ab[1], ba[1])
    col = np.maximum(ab[2], ba[2])
    haus = max(ab[3], ba[3])

    refl_psnr = float("inf")
    if src_refl is not None and rec_refl is not None:
        refl_psnr = _psnr(
            reflectance_mse(pa, src_refl, pb, rec_refl, grid_bits, device=d),
            65535.0,  # 16-bit reflectance peak (reference PCCMetrics.cpp:218-227)
        )

    return FrameMetrics(
        c2c_mse=c2c,
        c2c_psnr=_psnr(c2c, resolution, 3.0),
        c2p_mse=c2p,
        c2p_psnr=_psnr(c2p, resolution, 3.0),
        color_psnr=tuple(_psnr(float(m), 1.0) for m in col),
        c2c_hausdorff=haus,
        c2c_hausdorff_psnr=_psnr(haus, resolution, 3.0),
        reflectance_psnr=refl_psnr,
    )


def reflectance_mse(src_pos, src_refl, rec_pos, rec_refl, grid_bits: int = 10,
                    device=None) -> float:
    """Symmetric nearest-neighbour reflectance MSE (reference
    PCCMetrics.cpp:218-227): each point compares its 16-bit reflectance
    with its nearest neighbour's in the other cloud (kernel E, bucket 8; a
    point without a grid neighbour counts 0); the worse direction wins."""
    d = dev.resolve_device(device)

    def direction(pa, ra, pb, rb):
        idx, d2 = neighbors.nearest(neighbors.build_grid(pb, grid_bits), pa, bucket=8)
        ok = d2 < neighbors.MAX_DIST2
        diff = ra.double() - rb[idx.long().clamp(0, rb.shape[0] - 1)].double()
        return float(torch.where(ok, diff, torch.zeros_like(diff)).square().mean())

    pa, pb = _positions(src_pos, d), _positions(rec_pos, d)
    ra = _tensor(src_refl, torch.int32, np.int32, d)
    rb = _tensor(rec_refl, torch.int32, np.int32, d)
    return max(direction(pa, ra, pb, rb), direction(pb, rb, pa, ra))
