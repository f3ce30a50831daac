"""PyTorch port vs JAX reference: the grid k-NN (K4).

The port runs on the CPU (`knn_plain`, the plain version of the grid_knn
kernel).  idx and d2 must be identical, including the bucket truncation in
dense cells and the tie order among equal distances.  All clouds are padded
to one capacity with PAD_COORD rows, so the JAX programs compile once per k
and the padding rows are exercised too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.ops import neighbors as jn
from vpcc_tpu.utils.synthetic import make_sphere_cloud
from vpcc_tpu_torch.core.pointcloud import PAD_COORD
from vpcc_tpu_torch.ops import neighbors as tn

CAP = 8192
BITS = 7


def _pad(pts: np.ndarray) -> np.ndarray:
    out = np.full((CAP, 3), PAD_COORD, np.int32)
    out[: len(pts)] = pts
    return out


def _clouds():
    rng = np.random.default_rng(5)
    sphere = make_sphere_cloud(bits=BITS, n_samples=6000, seed=2).positions
    # a solid 14^3 block: 64 points in every 4^3 cell, far more than a
    # bucket's window holds (truncation)
    g = np.arange(14)
    block = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) + 40
    # a lattice of spacing 2: many neighbours at exactly equal distances
    h = np.arange(0, 34, 2)
    lattice = np.stack(np.meshgrid(h, h, h, indexing="ij"), -1).reshape(-1, 3) + 60
    lattice = lattice[rng.permutation(len(lattice))]
    return {"sphere": sphere, "dense_block": block, "lattice": lattice}


@pytest.fixture(scope="module")
def clouds():
    return {k: _pad(v.astype(np.int32)) for k, v in _clouds().items()}


def test_build_grid_matches_reference(clouds):
    for name, pos in clouds.items():
        jg = jn.build_grid(jnp.asarray(pos), BITS)
        tg = tn.build_grid(torch.as_tensor(pos), BITS)
        for f in ("order", "starts", "table"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f"{name}.{f}")


@pytest.mark.parametrize("k,bucket", [(1, 6), (8, 16), (16, 6), (64, 6)])
def test_knn_matches_reference(clouds, k, bucket):
    """Queries are the cloud itself (padding rows included) plus random
    points, some outside the grid."""
    rng = np.random.default_rng(k)
    extra = rng.integers(-6, (1 << BITS) + 6, (CAP // 4, 3)).astype(np.int32)
    for name, pos in clouds.items():
        q = np.concatenate([pos, extra])[:CAP]
        jg = jn.build_grid(jnp.asarray(pos), BITS)
        ji, jd = jn.knn(jg, None, jnp.asarray(q), k=k, bucket=bucket)
        tg = tn.build_grid(torch.as_tensor(pos), BITS)
        ti, td = tn.knn(tg, torch.as_tensor(q), k=k, bucket=bucket)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"{name} d2")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"{name} idx")
        if name == "dense_block":
            # the bucket window truncates: a window wide enough for every
            # candidate finds nearer neighbours for some queries
            _, full = tn.knn(tg, torch.as_tensor(q), k=k, bucket=64)
            assert (full.numpy()[: 14 ** 3] < td.numpy()[: 14 ** 3]).any()
        if name == "lattice" and k > 1:
            # ties are real: equal distances among the kept neighbours
            d = td.numpy()[: 17 ** 3]
            assert (np.diff(d, axis=1) == 0).any()


def test_knn_rejects_unsupported():
    g = tn.build_grid(torch.zeros((4, 3), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        tn.knn(g, torch.zeros((4, 3), dtype=torch.int32), k=65)
    # above 10 bits the table is unpacked (N, 3) rows, as the reference's
    g11 = tn.build_grid(torch.zeros((4, 3), dtype=torch.int32), 11)
    assert g11.packed is False and tuple(g11.table.shape) == (4, 3) and g.packed
