"""PyTorch port vs JAX reference: the quality metrics (K14, kernel R).

Small person clouds (6 and 7 bits) from numpy seeds go through
`vpcc_tpu.ops.metrics` and `vpcc_tpu_torch.ops.metrics` (on the CPU: the
plain versions of kernels E, F and R).  The JAX version pads every cloud
to a shape bucket, the port does not; agreement below shows the pad rows
change nothing.  Tolerances:
* `rgb_to_yuv_bt709`, `transfer_normals`: exact (both evaluate every
  float32 operation on its own, true divisions by 255);
* `estimate_normals`: NORMAL_ATOL (arccos/cos, as in
  tests/test_torch_segmentation.py);
* `compute_metrics`: the D1 MSE and Hausdorff term equal (the float32 d2
  sum in XLA's CPU order, one float32 division), the other MSEs to
  MSE_RTOL (float64 sums here, float32 sums in XLA's order there), every
  PSNR to PSNR_ATOL_DB;
* `d2_sum_f32_plain` (kernel R's D1 sum): bit for bit equal to XLA's
  float32 `jnp.sum` at bucket lengths where the sum passes 2^24, also
  through `metrics_reduce_plain` at a bucket whose windows are not all 32,
  and through the block tiling that `metrics_plan` lays out for the kernel;
* `metrics_reduce_plain` (both directions in one call) against the JAX
  package's `_directional` on each direction: the D1 MSE and Hausdorff term
  equal, the other MSEs to MSE_RTOL.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.ops import metrics as jm
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch.ops import metrics as tm, neighbors as tn

NORMAL_ATOL = 1e-5
MSE_RTOL = 1e-5
PSNR_ATOL_DB = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """A 7-bit person cloud and a jittered, recolored copy of it."""
    rng = np.random.default_rng(5)
    pc = make_person_cloud(bits=7, n_samples=12000, seed=3)
    src = pc.positions.astype(np.int32)
    rec = np.clip(src + rng.integers(-1, 2, src.shape), 0, 127).astype(np.int32)
    rec = rec[rng.permutation(len(rec))[: len(rec) - 200]]
    rcol = np.clip(pc.colors[: len(rec)].astype(int) + rng.integers(-6, 7, (len(rec), 3)),
                   0, 255).astype(np.uint8)
    return dict(src=src, col=pc.colors, rec=rec, rcol=rcol, rng=rng)


def assert_metrics_close(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g["c2c_mse"] == w["c2c_mse"] and g["c2c_hausdorff"] == w["c2c_hausdorff"]
    assert math.isclose(g["c2p_mse"], w["c2p_mse"], rel_tol=MSE_RTOL)
    for key in ("c2c_psnr", "c2p_psnr", "c2c_hausdorff_psnr", "reflectance_psnr"):
        if math.isinf(w[key]):
            assert g[key] == w[key], key
        else:
            assert abs(g[key] - w[key]) <= PSNR_ATOL_DB, (key, g[key], w[key])
    for a, b in zip(g["color_psnr"], w["color_psnr"]):
        assert a == b if math.isinf(b) else abs(a - b) <= PSNR_ATOL_DB, (a, b)


def test_rgb_to_yuv_exact():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (200_000, 3))
    rgb[:8] = [[r, g, b] for r in (0, 255) for g in (0, 255) for b in (0, 255)]
    want = np.asarray(jm.rgb_to_yuv_bt709(jnp.asarray(rgb.astype(np.int32))))
    got = tm.rgb_to_yuv_bt709(torch.as_tensor(rgb.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_estimate_normals(cloud):
    want = jm.estimate_normals(cloud["src"], grid_bits=7)
    got = tm.estimate_normals(cloud["src"], grid_bits=7, device="cpu")
    err = np.abs(got.numpy() - want).max()
    print(f"estimate_normals max abs err {err:.3g} over {len(want)} points")
    assert got.dtype == torch.float32 and err <= NORMAL_ATOL


def test_transfer_normals_exact(cloud):
    nrm = jm.estimate_normals(cloud["src"], grid_bits=7)
    want = jm.transfer_normals(cloud["src"], nrm, cloud["rec"], grid_bits=7)
    got = tm.transfer_normals(cloud["src"], nrm, cloud["rec"], grid_bits=7, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _both(src, scol, rec, rcol, resolution, bits, **kw):
    want = jm.compute_metrics(src, scol, rec, rcol, resolution=resolution, grid_bits=bits, **kw)
    got = tm.compute_metrics(src, scol, rec, rcol, resolution=resolution, grid_bits=bits,
                             device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("case", ["identical", "jittered_d2", "given_normals", "no_colors"])
def test_compute_metrics(cloud, case):
    src, col, rec, rcol = cloud["src"], cloud["col"], cloud["rec"], cloud["rcol"]
    kw = {}
    if case == "identical":
        # sparse enough that no grid cell window is cut at its bucket, so
        # every point finds itself
        _, first = np.unique(src, axis=0, return_index=True)
        keep = np.sort(first)[::3]
        src, col = src[keep], col[keep]
        rec, rcol = src, col
    elif case == "jittered_d2":
        kw = dict(with_d2=True)
    elif case == "given_normals":
        nrm = cloud["rng"].standard_normal(src.shape).astype(np.float32)
        kw = dict(src_normals=nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    else:
        col = rcol = None
        kw = dict(with_d2=True)
    got, want = _both(src, col, rec, rcol, 127, 7, **kw)
    print(f"{case}: port {got}\nJAX  {want}")
    assert_metrics_close(got, want)
    if case == "identical":
        assert got.c2c_psnr == got.color_psnr[0] == float("inf")
    else:
        assert 0 < got.c2c_mse and got.c2p_mse != got.c2c_mse


def test_compute_metrics_far_apart(capsys):
    """A reconstruction shifted beyond the grid's 3x3x3 cell window: most
    queries of both directions take the host KD search, and every
    transferred normal of a missed query is source row 0's."""
    pc = make_person_cloud(bits=6, n_samples=6000, seed=11)
    src = pc.positions.astype(np.int32)
    rec = np.clip(src + np.array([20, 0, 0]), 0, 63).astype(np.int32)
    keep = rec[:, 0] < 63
    got, want = _both(src, pc.colors, rec[keep], pc.colors[keep], 63, 6, with_d2=True)
    assert_metrics_close(got, want)
    err = capsys.readouterr().err
    assert "searched on the host (cKDTree)" in err
    assert got.c2c_mse > 100
    nrm = jm.estimate_normals(src, grid_bits=6)
    moved = tm.transfer_normals(src, nrm, rec[keep], grid_bits=6, device="cpu").numpy()
    _, d2 = tn.nearest(tn.build_grid(torch.as_tensor(src), 6), torch.as_tensor(rec[keep]))
    missed = (d2 >= tn.MAX_DIST2).numpy()
    assert missed.mean() > 0.5
    np.testing.assert_array_equal(moved[missed], np.broadcast_to(nrm[0], moved[missed].shape))


def test_reflectance_mse(cloud):
    rng = cloud["rng"]
    src, rec = cloud["src"], cloud["rec"]
    ra = rng.integers(0, 65536, len(src)).astype(np.uint16)
    rb = rng.integers(0, 65536, len(rec)).astype(np.uint16)
    want = jm.reflectance_mse(src, ra, rec, rb, grid_bits=7)
    got = tm.reflectance_mse(src, ra, rec, rb, grid_bits=7, device="cpu")
    assert math.isclose(got, want, rel_tol=1e-12)
    g, w = _both(src, cloud["col"], rec, cloud["rcol"], 127, 7, src_refl=ra, rec_refl=rb)
    assert_metrics_close(g, w)
    assert math.isfinite(g.reflectance_psnr)


@pytest.mark.parametrize("n", [
    2_432_872,   # a vox11 frame's source points (bucket 3 * 2^20)
    3_048_337,   # its reconstruction (the same bucket)
    1_435_657,   # bucket 3 * 2^19: a 48-element level split into two windows
    1_000_003,   # bucket 2^20
])
def test_d2_sum_f32_matches_xla(n):
    """The D1 sum (ROADMAP F7): random integer d2 rows whose float32 sum
    passes 2^24, padded with zeros to the reference's shape bucket, summed
    by the port and by XLA's CPU reduce."""
    rng = np.random.default_rng(n)
    cap = tm.shape_bucket(n)
    d2 = rng.integers(0, 41, n).astype(np.int32)
    d2[rng.random(n) < 1e-3] = rng.integers(1000, 300_000)
    x = np.zeros(cap, np.float32)
    x[:n] = d2
    want = np.asarray(jnp.sum(jnp.asarray(x)))
    got = tm.d2_sum_f32_plain(torch.as_tensor(d2), n, cap).numpy()
    exact = float(d2.astype(np.int64).sum())
    print(f"n={n} cap={cap}: XLA {want!r}, port {got!r}, exact {exact}")
    assert exact > 2 ** 24 and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _jax_directional(pa, ca, n_a, pb, cb, nb, bits):
    """The JAX package's `_directional` on A's first n_a rows, with A and B
    padded to their shape buckets as its `compute_metrics` pads them."""
    from vpcc_tpu.core.pointcloud import PAD_COORD, shape_bucket

    def pad(x, fill, dtype):
        if x is None:
            return None
        out = np.full((shape_bucket(x.shape[0]), 3), fill, dtype)
        out[:x.shape[0]] = x
        return jnp.asarray(out)

    return jm._directional(pad(pa, PAD_COORD, np.int32), pad(ca, 0, np.int32), n_a,
                           pad(pb, PAD_COORD, np.int32), pad(cb, 0, np.int32),
                           pad(nb, 0, np.float32), bits)


@pytest.fixture(scope="module")
def cloud_12288():
    """A 7-bit person cloud of 9,435 points (bucket 12,288: D1 windows
    [32, 32, 12]) and a jittered, recolored copy of 9,235."""
    rng = np.random.default_rng(8)
    pc = make_person_cloud(bits=7, n_samples=60000, seed=3)
    src = pc.positions.astype(np.int32)
    rec = np.clip(src + rng.integers(-1, 2, src.shape), 0, 127).astype(np.int32)[:-200]
    rcol = np.clip(pc.colors[:-200].astype(int) + rng.integers(-6, 7, (len(rec), 3)),
                   0, 255).astype(np.uint8)
    nrm = rng.standard_normal(src.shape).astype(np.float32)
    return dict(src=src, col=pc.colors, rec=rec, rcol=rcol,
                nrm=nrm / np.linalg.norm(nrm, axis=1, keepdims=True))


@pytest.mark.parametrize("case", ["bucket_12288", "no_normals", "no_colors", "cnt_a_0"])
def test_metrics_reduce_plain_matches_directional(cloud_12288, case):
    """Kernel R's plain version, both directions in one call, on the port's
    nearest searches, against the JAX package's `_directional` on each
    direction: the D1 MSE and Hausdorff term equal, the other MSEs to
    MSE_RTOL.  cnt_a_0: the first direction counts none of its A rows."""
    c = cloud_12288
    src, col, rec, rcol, nrm = c["src"], c["col"], c["rec"], c["rcol"], c["nrm"]
    assert tm.xla_windows(tm.shape_bucket(len(src))) == [32, 32, 12]
    if case == "no_colors":
        col = rcol = None
    nb = None if case == "no_normals" else tm.transfer_normals(src, nrm, rec, 7, device="cpu")
    na = None if case == "no_normals" else torch.as_tensor(nrm)
    pa, pb = torch.as_tensor(src), torch.as_tensor(rec)
    ca = None if col is None else torch.as_tensor(col)
    cb = None if rcol is None else torch.as_tensor(rcol)
    n_a = 0 if case == "cnt_a_0" else len(src)
    (ia, da), (ib, db) = tm._nearest_exact([(pa, pb), (pb, pa)], 7)
    res = tm.metrics_reduce_plain([(pa, ca, pb, cb, nb, ia, da, n_a),
                                   (pb, cb, pa, ca, na, ib, db, len(rec))]).numpy()
    assert res.shape == (2, len(tm.RESULT_FIELDS))
    for row, n, args in ((res[0], n_a, (src, col, n_a, rec, rcol, nb)),
                         (res[1], len(rec), (rec, rcol, len(rec), src, col, na))):
        a, ac, cnt, b, bc, bn = args
        want = _jax_directional(a, ac, cnt, b, bc, None if bn is None else np.asarray(bn), 7)
        got = tm._mses(row, n, bn is not None, ac is not None)
        assert got[0] == float(want[0]) and got[3] == float(want[3]), (got, want)
        assert math.isclose(got[1], float(want[1]), rel_tol=MSE_RTOL)
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=MSE_RTOL)
    if case == "cnt_a_0":
        assert not res[0].any() and res[1].all()
    else:
        assert (res[:, 2] > 0).all() == (case != "no_normals")
        assert (res[:, 3:] > 0).all() == (case != "no_colors")


@pytest.mark.parametrize("n", [9_000, 12_288])
def test_d1_sum_uneven_windows(n):
    """The D1 sum through `metrics_reduce_plain` at the 12,288-row bucket
    (windows [32, 32, 12]), with d2 rows large enough that every level
    rounds, bit for bit equal to XLA's float32 `jnp.sum` of the padded
    rows."""
    rng = np.random.default_rng(n)
    cap = tm.shape_bucket(n)
    assert tm.xla_windows(cap) == [32, 32, 12]
    d2 = rng.integers(0, 1 << 22, n).astype(np.int32)
    x = np.zeros(cap, np.float32)
    x[:n] = d2
    want = np.asarray(jnp.sum(jnp.asarray(x)))
    pos = torch.zeros((n, 3), dtype=torch.int32)
    row = tm.metrics_reduce_plain([(pos, None, pos, None, None, torch.zeros(n, dtype=torch.int32),
                                    torch.as_tensor(d2), n)])[0]
    assert float(row[0]) == d2.max()
    assert np.float32(row[1].item()).tobytes() == want.tobytes()
    assert float(d2.astype(np.int64).sum()) != float(want)


def _tiled_d1_sum(d2: np.ndarray, n: int) -> np.float32:
    """The D1 sum as kernel R's blocks and last block take it from
    `metrics_plan` (numpy float32, each window sequentially from 0)."""
    plan, blocks, *_ = tm.metrics_plan([n])
    _, nb, _, levels, fold, written = plan[:6]
    ws = plan[8:8 + levels]
    w0, tile = ws[0], tm.R_TILE_WINDOWS * ws[0]

    def windows(v, w):
        out = np.zeros(len(v) // w, np.float32)
        for j in range(w):
            out = out + v[j::w]
        return out.astype(np.float32)
    parts = []
    for b in range(nb):
        rows = np.zeros(tile, np.float32)
        r = d2[b * tile:min((b + 1) * tile, n)]
        rows[:len(r)] = r
        v = windows(rows, w0)
        for k in range(1, fold):
            v = windows(v, ws[k])
        parts.append(v)
    v = np.concatenate(parts)
    assert len(v) == written
    sizes = plan[24:24 + levels + 1]
    full = np.zeros(max(sizes[fold], written), np.float32)
    full[:written] = v
    v = full[:sizes[fold]]
    for k in range(fold, levels):
        v = windows(v, ws[k])
    assert len(v) == 1
    return v[0]


@pytest.mark.parametrize("n", [0, 1, 5_000, 9_435, 12_288, 607_162, 1_435_657])
def test_metrics_plan_tiles_d1_sum(n):
    """`metrics_plan`'s tiling (levels in the blocks, the rest in the last
    block, zeros past the last block's partials) sums the D1 rows in XLA's
    order: bit for bit equal to `d2_sum_f32_plain`."""
    rng = np.random.default_rng(n + 1)
    d2 = rng.integers(0, 1 << 20, n).astype(np.int32)
    cap = tm.shape_bucket(n)
    want = tm.d2_sum_f32_plain(torch.as_tensor(d2), n, cap).numpy()
    got = _tiled_d1_sum(d2.astype(np.float32), n)
    assert got.tobytes() == want.tobytes(), (n, got, want)


def test_metrics_reduce_takes_two_directions():
    """Kernel R's wrapper takes exactly the two directions of a
    `compute_metrics` call, on the CPU as on the card; its plain version
    takes any number."""
    pos = torch.zeros((4, 3), dtype=torch.int32)
    one = (pos, None, pos, None, None, torch.zeros(4, dtype=torch.int32),
           torch.arange(4, dtype=torch.int32), 4)
    for dirs in ([one], [one] * 3):
        with pytest.raises(ValueError, match="directions"):
            tm.metrics_reduce(dirs)
    got = tm.metrics_reduce([one, one])
    assert torch.equal(got, tm.metrics_reduce_plain([one] * 2))
    assert torch.equal(got[0], tm.metrics_reduce_plain([one])[0]) and got[0, 0] == 3


def test_metrics_need_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.compute_metrics(np.zeros((1, 3), np.int32), None, np.zeros((1, 3), np.int32), None, 63)
