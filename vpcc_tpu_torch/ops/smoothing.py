"""Grid geometry smoothing (kernel D).

Behavioral reference: `PCCCodec::smoothPointCloudGrid` / `gridFiltering`
(source/lib/PccLibCommon/source/PCCCodec.cpp:1002-1107) as the JAX package
computes it (vpcc_tpu/ops/smoothing.py `smooth_point_cloud_grid`): bin the
points into gridSize^3 cells (count, position sum, min/max patch id); every
boundary point whose 2x2x2 trilinear cell neighborhood holds a multi-patch
cell is pulled to the trilinear-weighted centroid when its weighted
distance exceeds max(threshold, count) * 2.

The per-point arithmetic is float32 in the reference's operation order,
including the multiply-adds XLA's CPU backend fuses (the centroid
accumulation, whose first add of two products fuses the first of them, and
the squared-distance sum, see `device.fma_f32`); the cell
sums are exact integers (the JAX float32 scatter-add holds integers below
2^24 exactly, so it equals them).
"""

from __future__ import annotations

import ctypes

import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.device import fma_f32


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    # a device tensor, not a Python scalar: a CUDA division by a Python
    # scalar multiplies by its reciprocal
    return torch.full((), v, dtype=torch.float32, device=like.device)


def smooth_point_cloud_grid_plain(points, patch_idx, boundary, threshold: float,
                                  grid_size: int = 8, grid_bits: int = 10):
    """Plain PyTorch version of kernel D.  points (M, 3) int32 (all rows
    valid), patch_idx (M,) int32, boundary (M,) bool.  Returns (M, 3)
    int32 smoothed positions."""
    gw = (1 << grid_bits) // grid_size
    n_cells = gw * gw * gw + 1
    p = points
    d = p.device
    floordiv = lambda a, b: torch.div(a, b, rounding_mode="floor")
    cell = floordiv(p, grid_size).clamp(0, gw - 1)
    cid = ((cell[:, 2] * gw + cell[:, 1]) * gw + cell[:, 0]).long()

    count = torch.zeros(n_cells, dtype=torch.int64, device=d).index_add_(
        0, cid, torch.ones_like(cid))
    csum = torch.zeros((n_cells, 3), dtype=torch.int64, device=d).index_add_(
        0, cid, p.long()).float()
    pmin = torch.full((n_cells,), 1 << 30, dtype=torch.int32, device=d)
    pmin = pmin.scatter_reduce(0, cid, patch_idx, "amin")
    pmax = torch.full((n_cells,), -1, dtype=torch.int32, device=d)
    pmax = pmax.scatter_reduce(0, cid, patch_idx, "amax")
    do_smooth = (count > 0) & (pmin != pmax)

    half = grid_size // 2
    p2 = floordiv(p, grid_size)
    p3 = p - p2 * grid_size
    s = p2 - (p3 < half).to(p.dtype)                       # (M, 3) base cell
    w_vec = (p - s * grid_size - half) * 2 + 1
    q_vec = 2 * grid_size - w_vec
    gs2 = 2 * grid_size
    denom = _f32(float(gs2 * gs2 * gs2), p)

    cur = p.float()
    M = p.shape[0]
    any_smooth = torch.zeros(M, dtype=torch.bool, device=d)
    centroid4 = None
    wcount = torch.zeros(M, dtype=torch.float32, device=d)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                nc = s + torch.tensor([dx, dy, dz], dtype=p.dtype, device=d)
                ok = ((nc >= 0) & (nc < gw)).all(-1)
                ncid = ((nc[:, 2] * gw + nc[:, 1]) * gw + nc[:, 0]).long()
                ncid = torch.where(ok, ncid, torch.full_like(ncid, n_cells - 1))
                ccount = count[ncid]
                any_smooth = any_smooth | (do_smooth[ncid] & (ccount > 0))
                ccent = torch.where(
                    (ccount > 0)[:, None],
                    csum[ncid] / ccount.clamp(min=1)[:, None].float(),
                    cur,
                )
                wx = (q_vec if dx == 0 else w_vec)[:, 0].float()
                wy = (q_vec if dy == 0 else w_vec)[:, 1].float()
                wz = (q_vec if dz == 0 else w_vec)[:, 2].float()
                wgt = wx * wy * wz
                wgt3 = wgt[:, None].expand_as(ccent)
                if dz == dy == dx == 0:
                    first = (ccent, wgt3)
                elif centroid4 is None:
                    # XLA's first add of two products fuses the first one
                    centroid4 = fma_f32(first[0], first[1], ccent * wgt3)
                else:
                    centroid4 = fma_f32(ccent, wgt3, centroid4)
                wcount = fma_f32(wgt, ccount.float(), wcount)

    centroid4 = centroid4 / denom
    cnt = torch.floor(wcount / denom)
    disth = max(grid_size // 2, 1)
    th = grid_size * gw
    inb = ((p >= disth) & (p + disth < th)).all(-1)
    eligible = boundary & any_smooth & inb & (cnt > 0)
    scaled = centroid4 * cnt[:, None]
    diff = cur * cnt[:, None] - scaled
    ss = diff[:, 0] * diff[:, 0]
    ss = fma_f32(diff[:, 1], diff[:, 1], ss)
    ss = fma_f32(diff[:, 2], diff[:, 2], ss)
    dist2 = ss / cnt.clamp(min=1.0) + 0.5
    move = eligible & (dist2 >= torch.maximum(_f32(threshold, p), cnt) * 2.0)
    target = torch.floor(centroid4 + 0.5).to(torch.int32)
    return torch.where(move[:, None], target, p)


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 3
# int32 of the scratch before the cell records: a block's partial box, 8
# ints, for at most 1024 blocks
_PART_INTS = 8192


def grid_smooth(points, patch_idx, boundary, threshold: float,
                grid_size: int = 8, grid_bits: int = 10):
    """Kernel D (csrc/grid_smooth.cu): one cooperative launch, no host wait:
    the points' cell box, its cell records emptied, the points binned with
    integer atomics (count, position sum, min/max patch id), then each
    boundary point moved.  The plain version runs on the CPU."""
    if points.device.type == "cpu":
        return smooth_point_cloud_grid_plain(points, patch_idx, boundary,
                                             threshold, grid_size, grid_bits)
    d = points.device
    M = points.shape[0]
    dev.check_tensor(points, "points", torch.int32, d, 2)
    dev.check_tensor(patch_idx, "patch_idx", torch.int32, d, 1)
    dev.check_tensor(boundary, "boundary", torch.bool, d, 1)
    if points.shape[1] != 3 or patch_idx.shape[0] != M or boundary.shape[0] != M:
        raise ValueError("grid_smooth: inconsistent shapes")
    gw = (1 << grid_bits) // grid_size
    # records for the whole grid: the box is found on the card
    scratch = dev.scratch("grid_smooth", d, _PART_INTS + 6 * gw ** 3)
    out = torch.empty_like(points)
    rc = dev.kernel_fn("grid_smooth", "grid_smooth", _ARGS)(
        dev.ptr(points), dev.ptr(patch_idx), dev.ptr(boundary), M, float(threshold),
        grid_size, gw, dev.ptr(scratch), dev.ptr(out), dev.stream_handle())
    dev.count_launch("grid_smooth", int(M > 0))
    dev.check_launch("grid_smooth", rc)
    return out


# ---------------------------------------------------------------------------
# Grid color smoothing (kernel T)
#
# Behavioral reference: PCCCodec::colorSmoothing (PCCCodec.cpp:151) as
# vpcc_tpu/ops/smoothing.py `color_smoothing_grid` (smoothing.py:135-189)
# computes it, on both sides of the codec after the colors are gathered:
# every point of a cgridSize^3 cell that holds more than one patch, with a
# low luma variance, takes the cell's rounded mean color when it is a
# boundary point, the cell holds more than one point and its own luma lies
# within `threshold` of the cell's mean luma.  (The reference's docstring
# says the deviation "exceeds" the threshold; its code, which the port
# follows, tests `dev < threshold`.)
#
# Float order (XLA's CPU program, probed with crafted inputs: a threshold
# placed one float32 ulp either side of a candidate deviation or variance
# separates the candidate orders): the luma is
# fma(0.0722, b, fma(0.2126, r, 0.7152 g)); the cell's luma and luma^2 sums
# are float32 sums in row order from 0 (XLA's scatter-add visits the rows in
# order); the variance is fma(-mean, mean, l2sum / count), clamped at 0;
# every division divides by the computed count (a true division).  The
# count, the color sums and the patch bounds are integers, order-free.

def _cell_ids(points, grid_size: int, grid_bits: int) -> torch.Tensor:
    gw = (1 << grid_bits) // grid_size
    cell = torch.div(points, grid_size, rounding_mode="floor").clamp(0, gw - 1).long()
    return (cell[:, 2] * gw + cell[:, 1]) * gw + cell[:, 0]


def color_smoothing_grid_plain(points, colors, patch_idx, boundary, threshold: float,
                               variation_limit: float, grid_size: int = 4,
                               grid_bits: int = 10):
    """Plain PyTorch version of kernel T.  points (M, 3) int32 (every row a
    reconstructed point), colors (M, 3) int32 RGB, patch_idx (M,) int32,
    boundary (M,) bool.  Returns the (M, 3) int32 smoothed colors."""
    d = points.device
    m = points.shape[0]
    if m == 0:
        return colors.clone()
    cid = _cell_ids(points, grid_size, grid_bits)
    cf = colors.to(torch.float32)
    luma = fma_f32(0.0722, cf[:, 2], fma_f32(0.2126, cf[:, 0], 0.7152 * cf[:, 1]))
    perm = torch.sort(cid, stable=True).indices
    _, inv, counts = torch.unique_consecutive(cid[perm], return_inverse=True,
                                              return_counts=True)
    n_cells = counts.shape[0]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=d) - starts[inv]
    # float32 sums in row order: add the cells' r-th rows for r = 0, 1, ...
    by_rank = torch.sort(rank, stable=True).indices
    bounds = torch.cumsum(torch.bincount(rank), 0).tolist()
    lp = luma[perm]
    lsum = torch.zeros(n_cells, dtype=torch.float32, device=d)
    l2sum = torch.zeros_like(lsum)
    lo = 0
    for hi in bounds:
        sel = by_rank[lo:hi]
        c = inv[sel]
        lsum[c] = lsum[c] + lp[sel]
        l2sum[c] = l2sum[c] + lp[sel] * lp[sel]
        lo = hi
    csum = torch.zeros((n_cells, 3), dtype=torch.int64, device=d).index_add_(
        0, inv, colors[perm].long())
    pp = patch_idx[perm]
    pmin = torch.full((n_cells,), 1 << 30, dtype=torch.int32, device=d).scatter_reduce(
        0, inv, pp, "amin")
    pmax = torch.full((n_cells,), -1, dtype=torch.int32, device=d).scatter_reduce(
        0, inv, pp, "amax")
    cnt = counts.to(torch.float32)
    mean_c = csum.to(torch.float32) / cnt[:, None]
    mean_l = lsum / cnt
    var_l = fma_f32(-mean_l, mean_l, l2sum / cnt).clamp(min=0.0)
    lim = _f32(variation_limit, cf)
    cell_ok = (pmin != pmax) & (counts > 1) & (var_l < lim * lim)
    row_cell = torch.empty_like(inv)
    row_cell[perm] = inv
    dev_l = (luma - mean_l[row_cell]).abs()
    smooth = boundary & cell_ok[row_cell] & (dev_l < _f32(threshold, cf))
    out = torch.where(smooth[:, None], torch.round(mean_c[row_cell]), cf)
    return out.clamp(0, 255).to(torch.int32)


_CS_KEY_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
_CS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_void_p]


def color_smoothing_grid(points, colors, patch_idx, boundary, threshold: float,
                         variation_limit: float, grid_size: int = 4, grid_bits: int = 10):
    """Kernel T (csrc/color_smooth.cu): `color_smoothing_grid_plain` on the
    card with O(M) memory.  One launch writes each row's cell key; a stable
    sort of the keys (PyTorch) groups the rows of a cell in row order; a
    second launch gives each cell one thread, which sums its rows in that
    order and writes every row's color.  The plain version runs on the CPU."""
    if points.device.type == "cpu":
        return color_smoothing_grid_plain(points, colors, patch_idx, boundary, threshold,
                                          variation_limit, grid_size, grid_bits)
    d = points.device
    m = points.shape[0]
    dev.check_tensor(points, "points", torch.int32, d, 2)
    dev.check_tensor(colors, "colors", torch.int32, d, 2)
    dev.check_tensor(patch_idx, "patch_idx", torch.int32, d, 1)
    dev.check_tensor(boundary, "boundary", torch.bool, d, 1)
    gw = (1 << grid_bits) // grid_size
    if points.shape != (m, 3) or colors.shape != (m, 3) or patch_idx.shape != (m,) \
            or boundary.shape != (m,) or gw ** 3 >= 1 << 31:
        raise ValueError(f"color_smoothing_grid: points {tuple(points.shape)}, colors "
                         f"{tuple(colors.shape)}, patch_idx {tuple(patch_idx.shape)}, boundary "
                         f"{tuple(boundary.shape)}, {gw}^3 cells")
    out = torch.empty_like(colors)
    if m == 0:
        return out
    lib = dev.load_kernel("color_smooth")
    keys = torch.empty(m, dtype=torch.int32, device=d)
    fn = lib.color_smooth_keys
    fn.argtypes, fn.restype = _CS_KEY_ARGS, ctypes.c_int
    rc = fn(dev.ptr(points), m, grid_size, gw, dev.ptr(keys), dev.stream_handle())
    dev.count_launch("color_smooth")
    dev.check_launch("color_smooth", rc)
    skeys, perm = torch.sort(keys, stable=True)
    perm = perm.to(torch.int32)
    fn = lib.color_smooth_cells
    fn.argtypes, fn.restype = _CS_ARGS, ctypes.c_int
    rc = fn(dev.ptr(skeys), dev.ptr(perm), dev.ptr(colors), dev.ptr(patch_idx),
            dev.ptr(boundary), dev.ptr(out), m, float(threshold), float(variation_limit),
            dev.stream_handle())
    dev.count_launch("color_smooth")
    dev.check_launch("color_smooth", rc)
    return out


# ---------------------------------------------------------------------------
# Color pre-smoothing (K9; kernel N)
#
# Behavioral reference: presmoothPointCloudColor (PCCEncoder.cpp:6593-6656)
# as vpcc_tpu/ops/smoothing.py `_presmooth_vote` and `presmooth_colors`
# (smoothing.py:193-261) compute it, encoder side, before the attribute
# video: each boundary point looks at its k nearest reconstructed points
# within radius2; when its color is far (L1) from their integer centroid and
# their 8-bit luma has low entropy, it takes the centroid.
#
# Float order (XLA's CPU program): the luma is
# trunc(fma(0.0722, b, fma(0.2126, r, 0.7152 g))); a valid slot's entropy
# term is XLA's -log2(max(cnt / n, 1e-12)), read from a committed table of
# XLA's own values (`ENTROPY_TERMS`, tests/torch_make_encode_tables.py:
# XLA's log2 is not correctly rounded); the k = 64 terms, zero at invalid
# slots, are summed as two sequential runs of 32 from 0, then added, then
# divided by n.

ENTROPY_TERMS = dev.PKG_DIR / "data" / "presmooth_log2_xla.npy"
PRESMOOTH_K = 64
_entropy_tabs: dict = {}


def entropy_table(device) -> torch.Tensor:
    """(65 * 65,) float32: entry n * 65 + cnt holds XLA's
    -log2(max(cnt / n, 1e-12)) for 1 <= cnt <= n <= 64."""
    key = str(device)
    if key not in _entropy_tabs:
        import numpy as np

        _entropy_tabs[key] = torch.as_tensor(
            np.load(ENTROPY_TERMS).astype(np.float32).reshape(-1), device=device)
    return _entropy_tabs[key]


def presmooth_vote_plain(colors, nidx, nd2, bidx, out, radius2: float, thr_dist: float,
                         thr_entropy: float):
    """Plain version of kernel N.  colors (N, 3) int32 of the reconstructed
    points; nidx, nd2 (M, 64) int32 from kernel E for the M boundary
    queries at rows bidx (M,) int64; writes each query's new color into
    row bidx of out (N, 3) int32 (another tensor than colors; its other
    rows stay as they are) and returns out."""
    m, k = nidx.shape
    if k != PRESMOOTH_K:
        raise NotImplementedError(
            f"color pre-smoothing with k={k}: only k={PRESMOOTH_K} (the reference "
            "configuration) has its entropy reduction order ported")
    q_col = colors[bidx]
    valid = (nd2 < 0x7FFFFFF0) & (nd2.to(torch.float32) <= radius2)
    nv = valid.sum(1)
    n = nv.clamp(min=1)
    cols = colors[nidx.long()]                                   # (M, k, 3)
    csum = torch.where(valid[:, :, None], cols, torch.zeros_like(cols)).sum(1)
    centroid = torch.div(csum + (n // 2)[:, None], n[:, None], rounding_mode="floor")
    cf = cols.to(torch.float32)
    y = fma_f32(0.0722, cf[..., 2], fma_f32(0.2126, cf[..., 0], 0.7152 * cf[..., 1]))
    y = y.to(torch.int32)                                        # trunc, y >= 0
    same = (y[:, :, None] == y[:, None, :]) & valid[:, None, :]
    cnt = same.sum(2)
    tab = entropy_table(colors.device)
    terms = torch.where(valid, tab[(n[:, None] * 65 + cnt).long()], torch.zeros_like(nd2, dtype=torch.float32))
    s0 = torch.zeros(m, dtype=torch.float32, device=colors.device)
    s1 = torch.zeros_like(s0)
    for j in range(32):
        s0 = s0 + terms[:, j]
        s1 = s1 + terms[:, 32 + j]
    H = (s0 + s1) / n.to(torch.float32)
    l1 = (centroid - q_col).abs().sum(1)
    replace = (nv > 0) & (l1.to(torch.float32) >= thr_dist) & (H < thr_entropy)
    out[bidx] = torch.where(replace[:, None], centroid, q_col).to(torch.int32)
    return out


_VOTE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [
    ctypes.c_void_p] * 2


def presmooth_vote(colors, nidx, nd2, bidx, out, radius2: float, thr_dist: float,
                   thr_entropy: float):
    """Kernel N (csrc/presmooth.cu): `presmooth_vote_plain` on the card, one
    warp per boundary query, the luma counts from ballots of the luma bits,
    the query's color read at bidx and its result written to out there;
    the plain version for CPU tensors."""
    if nidx.device.type == "cpu":
        return presmooth_vote_plain(colors, nidx, nd2, bidx, out, radius2, thr_dist,
                                    thr_entropy)
    d = nidx.device
    dev.check_tensor(colors, "colors", torch.int32, d, 2)
    dev.check_tensor(nidx, "nidx", torch.int32, d, 2)
    dev.check_tensor(nd2, "nd2", torch.int32, d, 2)
    dev.check_tensor(bidx, "bidx", torch.int64, d, 1)
    dev.check_tensor(out, "out", torch.int32, d, 2)
    m, k = nidx.shape
    if k != PRESMOOTH_K:
        raise NotImplementedError(
            f"color pre-smoothing with k={k}: only k={PRESMOOTH_K} has its "
            "entropy reduction order ported")
    if nd2.shape != nidx.shape or bidx.shape != (m,) or colors.shape[1] != 3 \
            or out.shape != colors.shape or out.data_ptr() == colors.data_ptr():
        raise ValueError(f"presmooth_vote: nidx {tuple(nidx.shape)}, nd2 {tuple(nd2.shape)}, "
                         f"bidx {tuple(bidx.shape)}, colors {tuple(colors.shape)}, out "
                         f"{tuple(out.shape)} (out must be another tensor than colors)")
    rc = dev.kernel_fn("presmooth", "presmooth_vote", _VOTE_ARGS)(
        dev.ptr(colors), dev.ptr(nidx), dev.ptr(nd2), dev.ptr(bidx),
        dev.ptr(entropy_table(d)), m, k, float(radius2), float(thr_dist), float(thr_entropy),
        dev.ptr(out), dev.stream_handle())
    dev.count_launch("presmooth", 1 if m else 0)
    dev.check_launch("presmooth", rc)
    return out


def presmooth_colors(pos, colors, bnd, grid_bits: int, k: int, radius2: float,
                     thr_dist: float, thr_entropy: float):
    """Color pre-smoothing of the reconstructed cloud, boundary points only
    (reference `presmooth_colors`).  pos (N, 3) int32, colors (N, 3) int32,
    bnd (N,) bool.  Returns the smoothed (N, 3) int32 colors: a copy of
    `colors` with the boundary rows voted (kernel N writes them into it)."""
    from vpcc_tpu_torch.ops import neighbors

    bidx = torch.nonzero(bnd).flatten()
    if bidx.numel() == 0:
        return colors
    grid = neighbors.build_grid(pos, grid_bits)
    nidx, nd2 = neighbors.knn(grid, pos[bidx].contiguous(), k=k, bucket=6)
    colors = colors.contiguous()
    return presmooth_vote(colors, nidx, nd2, bidx, colors.clone(), radius2, thr_dist,
                          thr_entropy)
