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
* `d2_sum_f32`: bit for bit equal to XLA's float32 `jnp.sum` at bucket
  lengths where the sum passes 2^24.
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
    got = tm.d2_sum_f32(torch.as_tensor(d2), n, cap).numpy()
    exact = float(d2.astype(np.int64).sum())
    print(f"n={n} cap={cap}: XLA {want!r}, port {got!r}, exact {exact}")
    assert exact > 2 ** 24 and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_metrics_need_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.compute_metrics(np.zeros((1, 3), np.int32), None, np.zeros((1, 3), np.int32), None, 63)
