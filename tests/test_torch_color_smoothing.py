"""PyTorch port vs JAX reference: grid color smoothing (kernel T's plain
version, vpcc_tpu/ops/smoothing.py `color_smoothing_grid`).

On the CPU, from numpy seeds:
* `color_smoothing_grid_plain` equals the reference bit for bit on clouds
  of few-point cells at 7 and 10 bits, with cells that straddle patches,
  thresholds that tie exactly with a row's luma deviation and a cell's
  luma variance (both tests are strict `<`), and a cell whose luma sums
  depend on their order;
* the float order of the cell's luma and luma^2 sums is XLA's: on cells of
  20-64 rows, a threshold one float32 ulp either side of the deviation the
  port computes (luma fma(0.0722, b, fma(0.2126, r, 0.7152 g)), row-order
  sums, variance fma(-mean, mean, l2sum / count)) flips the reference's
  decision exactly there, and the port's with it.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpcc_tpu.ops.smoothing import color_smoothing_grid as jsmooth
from vpcc_tpu_torch.device import fma_f32
from vpcc_tpu_torch.ops.smoothing import color_smoothing_grid_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(pts, col, pid, bnd, thr, lim, bits, grid=4, cap=None):
    """(reference, port) smoothed colors; the reference's rows are padded
    to `cap` with invalid rows, as its callers pad them."""
    m = len(pts)
    cap = cap or m + 7
    pad = lambda a, f=0: np.concatenate([a, np.full((cap - m,) + a.shape[1:], f, a.dtype)])
    valid = pad(np.ones(m, bool), False)
    want = np.asarray(jsmooth(jnp.asarray(pad(pts)), jnp.asarray(pad(col)), jnp.asarray(valid),
                              jnp.asarray(pad(pid)), jnp.asarray(pad(bnd, False)), float(thr),
                              float(lim), grid_size=grid, grid_bits=bits))[:m]
    t = torch.as_tensor
    got = color_smoothing_grid_plain(t(pts), t(col), t(pid), t(bnd), thr, lim, grid, bits)
    return want, got.numpy()


def luma(col):
    cf = torch.as_tensor(np.asarray(col, np.float32))
    return fma_f32(0.0722, cf[:, 2], fma_f32(0.2126, cf[:, 0], 0.7152 * cf[:, 1]))


def cell_stats(col):
    """(luma deviation per row, variance) of one cell's rows, in the order
    the port (and, per the probe test, XLA) computes them."""
    lum = luma(col)
    s = s2 = torch.zeros((), dtype=torch.float32)
    for v in lum:
        s, s2 = s + v, s2 + v * v
    n = torch.tensor(float(len(col)), dtype=torch.float32)
    mean = s / n
    var = fma_f32(-mean, mean, s2 / n).clamp(min=0)
    return (lum - mean).abs().numpy(), np.float32(var.item())


def few_point_cells(bits, n_cells, seed):
    """Cells of 1-8 points, each near a base color, two or three patch ids."""
    rng = np.random.default_rng(seed)
    cells = rng.choice((1 << bits) // 4, (n_cells, 3))
    pts, col, pid = [], [], []
    for c in cells:
        k = int(rng.integers(1, 9))
        pts.append(c * 4 + rng.integers(0, 4, (k, 3)))
        col.append(rng.integers(40, 220, 3) + rng.integers(-6, 7, (k, 3)))
        pid.append(rng.integers(0, int(rng.integers(1, 4)), k))
    cat = lambda a: np.concatenate(a).astype(np.int32)
    order = rng.permutation(sum(len(p) for p in pts))
    return (cat(pts)[order], np.clip(cat(col), 0, 255)[order], cat(pid)[order],
            rng.random(len(order)) < 0.8)


@pytest.mark.parametrize("bits,seed", [(7, 0), (10, 1)])
def test_color_smoothing_matches_reference(bits, seed):
    pts, col, pid, bnd = few_point_cells(bits, 600, seed)
    want, got = both(pts, col, pid, bnd, 10.0, 6.0, bits)
    changed = (want != col).any(1).sum()
    print(f"{bits} bits: {len(pts)} points, {changed} smoothed")
    assert changed > 50
    np.testing.assert_array_equal(got, want)


def test_color_smoothing_ties_at_limits():
    """A two-patch cell: the deviation threshold equal to one row's
    deviation (not smoothed: `<`), then one ulp above it; the variation
    limit whose float32 square equals the cell's variance, then the next
    float32 above."""
    rng = np.random.default_rng(4)
    pts = np.full((6, 3), 9, np.int32)
    pid = np.array([0, 1, 0, 1, 0, 1], np.int32)
    bnd = np.ones(6, bool)
    col = np.clip(rng.integers(90, 100, (6, 3)), 0, 255).astype(np.int32)
    dev, var = cell_stats(col)
    up = lambda x: np.nextafter(np.float32(x), np.float32(np.inf))
    lim = np.float32(np.sqrt(np.float64(var)))
    while np.float32(lim) * np.float32(lim) > var:
        lim = np.nextafter(lim, np.float32(0))
    decisions = []
    for thr, lv in ((dev[2], 1e6), (up(dev[2]), 1e6), (1e6, lim), (1e6, up(lim))):
        want, got = both(pts, col, pid, bnd, thr, lv, 7)
        np.testing.assert_array_equal(got, want)
        decisions.append(tuple((want != col).any(1)))
    assert not decisions[0][2] and decisions[1][2]
    assert decisions[2] != decisions[3]


def test_luma_sum_order_matches_xla():
    """Probe of XLA's float order (ROADMAP: kernel T's float order): per
    trial one cell of 20-64 rows with close random colors, two patches; the
    threshold one ulp below and at the next float above the deviation the
    port computes for one row: the reference smooths that row only with the
    second, and so does the port.  Sums in another order (pairwise,
    reversed, 8 lanes) miss about half of these trials."""
    rng = np.random.default_rng(11)
    m = 64
    pts = np.full((m, 3), 9, np.int32)
    pid = (np.arange(m) % 2).astype(np.int32)
    bnd = np.ones(m, bool)
    up = lambda x: np.nextafter(np.float32(x), np.float32(np.inf))
    for trial in range(12):
        n = int(rng.integers(20, m + 1))
        col = rng.integers(60, 60 + int(rng.integers(2, 40)), (n, 3)).astype(np.int32)
        mean_c = np.clip(np.round(col.sum(0).astype(np.float32) / np.float32(n)), 0, 255)
        row = int(np.argmax((col != mean_c).any(1)))
        dev, _ = cell_stats(col)
        for thr, smoothed in ((dev[row], False), (up(dev[row]), True)):
            want, got = both(pts[:n], col, pid[:n], bnd[:n], thr, 1e6, 7, cap=m + 7)
            np.testing.assert_array_equal(got, want)
            assert np.array_equal(want[row], mean_c) == smoothed, (trial, thr)


@pytest.mark.parametrize("on", [0, 1])
def test_host_facing_color_smoothing_matches_reference(on):
    """`pipeline.apply_color_smoothing` (numpy in, uint8 out; the colors as
    they are with the tool off) against the reference's, which pads the
    rows to its shape bucket."""
    from vpcc_tpu import pipeline as jpipe
    from vpcc_tpu.utils.config import VPCCConfig as JCfg
    from vpcc_tpu_torch import pipeline as tpipe
    from vpcc_tpu_torch.utils.config import VPCCConfig

    pts, col, pid, bnd = few_point_cells(10, 300, 5)
    cfgs = []
    for cls in (JCfg, VPCCConfig):
        c = cls()
        c.flagColorSmoothing, c.thresholdColorVariation = on, 8.0
        cfgs.append(c)
    want = jpipe.apply_color_smoothing(pts, col.astype(np.uint8), pid, bnd, cfgs[0])
    got = tpipe.apply_color_smoothing(pts, col.astype(np.uint8), pid, bnd, cfgs[1], device="cpu")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (not np.array_equal(got, col)) == bool(on)
