"""Objective quality metrics (K14, kernel R): D1 (point-to-point), D2
(point-to-plane) and color PSNR, the PccLibMetrics equivalent, on the device.

Behavioral reference: `vpcc_tpu/ops/metrics.py` (the reference's
PCCMetrics.cpp: `getPSNR` :42, `QualityMetrics::compute` :73-230, the
symmetric merge :289-322).  Each direction A -> B finds, for every A point,
its nearest B point with the grid k-NN (kernel E, `neighbors.nearest`); a
query with no grid neighbour (d2 >= MAX_DIST2) is searched exactly on the
host with scipy's cKDTree, as the reference does.  Kernel R
(csrc/metrics.cu, `metrics_reduce`) then gathers B at the nearest index and
reduces the per-point errors of both directions to sums, in one launch.

The JAX reference evaluates `_directional` op by op (it is not jitted), so
every float32 operation rounds on its own: no fused multiply-adds and true
divisions by 255.  The per-point terms here round the same way, in the
same order; the point-to-plane and color sums run in float64 (the
reference sums them in float32, which a tolerance covers), the d2 maximum
in int64.  The D1 MSE divides the reference's float32 sum of the
d2 rows, taken in XLA's CPU order over its shape-bucket length
(`d2_sum_f32_plain`), by the point count: past 2^24 that sum rounds.

Unlike the reference, nothing is padded to a shape bucket: the reference's
pad rows carry weight 0 and lie outside every grid cell, so they change no
result; only the D1 sum's order depends on the bucket length.  Everything
stays on the device but the miss counts of both directions (one host
read), the rows that missed, and the sums of both directions (one host
read).
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
# kernel R: the per-point errors of both directions, reduced

# the columns of kernel R's result, a row a direction
RESULT_FIELDS = ("dmax", "s_d2", "c2p", "y", "u", "v")


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
    """The D1 sum of kernel R's plain version: the float32 sum of d2[:n]
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


def metrics_reduce_plain(dirs) -> torch.Tensor:
    """Plain version of kernel R.  `dirs`: directions (any number), each
    (pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a).  For the A rows
    below cnt_a, with B gathered at `idx`, a row of RESULT_FIELDS: the
    maximum d2, the D1 sum (`d2_sum_f32_plain` over the shape bucket of
    cnt_a), and the float64 sums of ((a - b) . n_b)^2 and of the squared Y,
    U, V errors.  Normals or colors that are None give zero sums.  Returns
    (len(dirs), 6) float64."""
    rows = []
    for pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a in dirs:
        i = idx[:cnt_a].long()
        row = torch.zeros(len(RESULT_FIELDS), dtype=torch.float64, device=pos_a.device)
        if cnt_a:
            row[0] = d2[:cnt_a].max().double()
        row[1] = d2_sum_f32_plain(d2, cnt_a, shape_bucket(cnt_a)).double()
        if normals_b is not None:
            prod = (pos_a[:cnt_a] - pos_b[i]).float() * normals_b[i]
            proj = (prod[:, 0] + prod[:, 1]) + prod[:, 2]
            row[2] = (proj * proj).double().sum()
        if col_a is not None and col_b is not None:
            ce = rgb_to_yuv_bt709(col_a[:cnt_a]) - rgb_to_yuv_bt709(col_b[i])
            row[3:] = (ce * ce).double().sum(0)
        rows.append(row)
    return torch.stack(rows)


# kernel R's tile: level-0 windows a block (csrc/metrics.cu kTile; 64 ran
# fastest of 32, 64 and 128 on the bench frame, PERF.md §6)
R_TILE_WINDOWS = 64
R_MAX_LEVELS = 16


def metrics_plan(counts) -> tuple:
    """Kernel R's launch for directions of `counts` A rows: (plan ints, a
    row of 8 + 16 + 2 * 17 a direction as csrc/metrics.cu reads it; blocks
    in all; byte offsets of the blocks' partials and of the level regions
    in the scratch; scratch bytes).  A direction of n rows over the bucket
    cap = shape_bucket(n) takes max(1, ceil(n / tile)) blocks of a tile of
    R_TILE_WINDOWS level-0 windows; a block also sums each further level
    whose windows lie inside its tile; the last block sums the rest, from the blocks' partials (its
    first level reads zeros past them), a scratch region a level.  Every
    shape bucket is a multiple of 8,192: its first window is 32 rows and
    its 32-row windows fill whole tiles."""
    plan, first, floats = [], 0, 0
    for n in counts:
        cap = shape_bucket(n)
        ws = xla_windows(cap)
        if len(ws) > R_MAX_LEVELS or ws[0] != 32 or cap // 32 % R_TILE_WINDOWS:
            raise ValueError(f"metrics: the D1 sum over {cap} rows has windows {ws}")
        sizes = [cap]
        for w in ws:
            sizes.append(sizes[-1] // w)
        blocks = max(1, -(-n // (R_TILE_WINDOWS * ws[0])))
        fold, per = 1, R_TILE_WINDOWS
        while fold < len(ws) and per % ws[fold] == 0:
            per //= ws[fold]
            fold += 1
        offs = [0] * (R_MAX_LEVELS + 1)
        for k in range(fold, len(ws) + 1):
            offs[k] = floats
            floats += sizes[k]
        plan += [n, blocks, first, len(ws), fold, blocks * per, 0, 0,
                 *ws, *[0] * (R_MAX_LEVELS - len(ws)),
                 *sizes, *[0] * (R_MAX_LEVELS + 1 - len(sizes)), *offs]
        first += blocks
    part_off = 16                     # after the ticket
    lvl_off = part_off + 40 * first   # after the int64 maxima and float64 sums
    return plan, first, part_off, lvl_off, lvl_off + 4 * floats


_R_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def metrics_reduce(dirs) -> torch.Tensor:
    """Kernel R (csrc/metrics.cu): `metrics_reduce_plain` on the card, both
    directions of `dirs` in one launch (a thread a row in a fixed order,
    fixed block trees, the last block finishing: no float atomics, repeated
    runs give the same bits); the plain version for CPU tensors.  Returns
    (2, 6) float64 on the tensors' device."""
    if len(dirs) != 2:
        raise ValueError(f"metrics_reduce: {len(dirs)} directions (two)")
    if dirs[0][0].device.type == "cpu":
        return metrics_reduce_plain(dirs)
    d = dirs[0][0].device
    ptrs, checked = [], set()

    def check(t, name, dtype, ndim):
        if id(t) not in checked:   # each cloud's tensors serve both directions
            dev.check_tensor(t, name, dtype, d, ndim)
            checked.add(id(t))

    for pos_a, col_a, pos_b, col_b, normals_b, idx, d2, cnt_a in dirs:
        check(pos_a, "pos_a", torch.int32, 2)
        check(pos_b, "pos_b", torch.int32, 2)
        check(idx, "idx", torch.int32, 1)
        check(d2, "d2", torch.int32, 1)
        with_col = col_a is not None and col_b is not None
        if with_col:
            check(col_a, "col_a", torch.uint8, 2)
            check(col_b, "col_b", torch.uint8, 2)
        if normals_b is not None:
            check(normals_b, "normals_b", torch.float32, 2)
        if not 0 <= cnt_a <= min(pos_a.shape[0], idx.shape[0], d2.shape[0]):
            raise ValueError(f"metrics_reduce: cnt_a={cnt_a} outside the A rows")
        ptrs += [pos_a.data_ptr(), col_a.data_ptr() if with_col else None, pos_b.data_ptr(),
                 col_b.data_ptr() if with_col else None,
                 None if normals_b is None else normals_b.data_ptr(), idx.data_ptr(),
                 d2.data_ptr()]
    plan, blocks, part_off, lvl_off, nbytes = metrics_plan([int(a[7]) for a in dirs])
    # the ticket at its start must be 0: `dev.scratch` zeroes what it grows
    scratch = dev.scratch("metrics", d, -(-nbytes // 4))
    out = torch.empty((2, len(RESULT_FIELDS)), dtype=torch.float64, device=d)
    rc = dev.kernel_fn("metrics", "metrics_reduce", _R_ARGS)(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(plan))(*plan), blocks,
        dev.ptr(scratch), part_off, lvl_off, dev.ptr(out), dev.stream_handle())
    dev.count_launch("metrics", 1)
    dev.check_launch("metrics", rc)
    return out


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


def _nearest_exact(pairs, grid_bits: int) -> list:
    """Nearest B point of every A row, for each (pos_a, pos_b) of `pairs`:
    kernel E's grid search, one host read of every pair's count of rows it
    missed (d2 >= MAX_DIST2), and for those rows the reference's exact host
    KD search (metrics.py:73-84).  Returns [(idx, d2) int32 on the device]
    a pair."""
    found = [neighbors.nearest(neighbors.build_grid(pb, grid_bits), pa) for pa, pb in pairs]
    missed = [d2 >= neighbors.MAX_DIST2 for _, d2 in found]
    counts = torch.stack([m.sum() for m in missed]).tolist()
    out = []
    for (pa, pb), (idx, d2), miss, n_missed in zip(pairs, found, missed, counts):
        if n_missed:
            from scipy.spatial import cKDTree

            rows = torch.nonzero(miss).flatten()
            dd, ii = cKDTree(pb.cpu().numpy()).query(pa[rows].cpu().numpy().astype(np.float64))
            idx = idx.clone()
            d2 = d2.clone()
            idx[rows] = torch.as_tensor(ii.astype(np.int32), device=idx.device)
            d2[rows] = torch.as_tensor(np.round(dd * dd).astype(np.int32), device=d2.device)
            print(f"metrics: {n_missed} of {pa.shape[0]} queries had no grid neighbour; "
                  "searched on the host (cKDTree)", file=sys.stderr)
        out.append((idx, d2))
    return out


def _mses(row, cnt_a: int, with_normals: bool, with_col: bool) -> tuple:
    """One direction's (mse_c2c, mse_c2p, mse_color (3,) float64 numpy,
    hausdorff) from its row of kernel R's result (host numpy)."""
    num = max(cnt_a, 1)
    mse_c2c = float(np.float32(row[1]) / np.float32(num))
    haus = float(np.float32(row[0]))
    mse_c2p = float(row[2] / num) if with_normals else mse_c2c
    mse_col = row[3:] / num if with_col else np.zeros(3)
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

    if ca is None or cb is None:
        ca = cb = None
    (idx_ab, d2_ab), (idx_ba, d2_ba) = _nearest_exact([(pa, pb), (pb, pa)], grid_bits)
    res = metrics_reduce([(pa, ca, pb, cb, nb, idx_ab, d2_ab, pa.shape[0]),
                          (pb, cb, pa, ca, na, idx_ba, d2_ba, pb.shape[0])]).cpu().numpy()
    ab = _mses(res[0], pa.shape[0], nb is not None, ca is not None)
    ba = _mses(res[1], pb.shape[0], na is not None, ca is not None)
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
