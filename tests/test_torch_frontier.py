"""The frontier schedule of kernels W (dilation, attributeBGFill=0) and X
(spanning-tree flood, normalOrientation=4) against the JAX package.

The kernels cannot run on the CPU, so their schedule runs here as plain
PyTorch (tests/torch_frontier.py): a level's list in chunks of a random
order, each seeing the claims and stamps of the chunks before it.  On the
crafted cases of that module, made from numpy seeds, the schedule must give
exactly what the reference (`vpcc_tpu/ops/padding.py dilate_fill`,
`vpcc_tpu/ops/normals.py orient_normals_spanning_tree`) and the port's
plain versions give, with the same pass and sweep counts, under two chunk
orders.  Tolerance: none (equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_frontier import (DILATE_CASES, FLOOD_CASES, dilate_case, dilate_frontier,
                            flood_case, flood_frontier, reverse_adjacency)
from vpcc_tpu.core.pointcloud import PAD_COORD
from vpcc_tpu.ops import normals as jno, padding as jpad
from vpcc_tpu_torch.ops import normals as tno, padding as tpad


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", DILATE_CASES)
def test_dilate_frontier_matches_reference(case):
    planes, occ, max_iters = dilate_case(case)
    tp, to = torch.as_tensor(planes), torch.as_tensor(occ)
    want = np.stack([np.asarray(jpad.dilate_fill(jnp.asarray(p), jnp.asarray(occ),
                                                 max_iters=max_iters)) for p in planes])
    plain, plain_passes = tpad.dilate_fill_plain(tp, to, max_iters)
    for seed in (0, 1):
        got, passes = dilate_frontier(tp, to, max_iters, seed=seed)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, plain) and passes == plain_passes
    # the finish's rounding and clip, as fill_rgb(mode=0) takes it
    if max_iters == tpad.DILATE_MAX_PASSES:
        np.testing.assert_array_equal(tpad.round_clip_plain(got).numpy(),
                                      tpad.fill_rgb(tp, to, 0).numpy())
    expected = {"torus": 40, "edge_cap": 7, "empty": 0, "full": 0}
    if case in expected:
        assert passes == expected[case]
    if case == "edge_cap":
        assert (want == 0).sum() > 0   # pixels beyond the cap stay 0


def _flood_jax(pos, nrm, idx, val, valid, pad):
    """The reference's flood over the arrays plus `pad` padded rows (when
    the case asks for them), cut back to the arrays' rows."""
    V = len(pos)
    n_pad = 3 if pad else 0
    cat = lambda a, fill: np.concatenate([a, np.full((n_pad, *a.shape[1:]), fill, a.dtype)])
    out = jno.orient_normals_spanning_tree(
        jnp.asarray(cat(pos, PAD_COORD)), jnp.asarray(cat(nrm, 1.0)),
        jnp.asarray(cat(idx, 0)), jnp.asarray(cat(val, False)), jnp.asarray(cat(valid, False)))
    return np.asarray(out)[:V]


@pytest.mark.parametrize("case", FLOOD_CASES)
def test_flood_frontier_matches_reference(case):
    pos, nrm, idx, val, valid, pad = flood_case(case)
    t = [torch.as_tensor(a) for a in (pos, nrm, idx, val, valid)]
    plain, plain_sweeps = tno.orient_normals_spanning_tree_plain(*t, pad_rows=pad)
    for seed in (0, 1):
        got, sweeps = flood_frontier(*t, pad_rows=pad, seed=seed)
        assert torch.equal(got, plain) and sweeps == plain_sweeps
    if case != "empty":   # the reference's argmax takes no empty array
        np.testing.assert_array_equal(got.numpy(), _flood_jax(pos, nrm, idx, val, valid, pad))
    if case in ("cancel_then_signed", "disconnected"):
        # row 3's vote cancels in sweep 2 and is positive in sweep 3 (its
        # radial sign would be -1); rows 1, 2 in sweep 1, row 4 in sweep 2
        assert sweeps == 3 and got[3].tolist() == [1.0, 0.0, 0.0]
    if case == "disconnected":   # the second component takes the radial sign
        radial = tno.radial_signs(t[0], t[1], t[4])
        assert torch.equal(got[8:12], t[1][8:12] * radial[8:12, None])
    if case == "pad_rows":
        assert sweeps == 0
    if case == "random":
        assert sweeps > 2


def test_reverse_adjacency_counting_sort():
    """The CSR the flood builds lists, for each row j, every valid edge of a
    valid row that points at j, as often as the row lists j."""
    pos, nrm, idx, val, valid, _ = flood_case("random")
    off, rows = reverse_adjacency(torch.as_tensor(idx), torch.as_tensor(val),
                                  torch.as_tensor(valid))
    want = [[] for _ in range(len(pos))]
    for i in range(len(pos)):
        for k in range(idx.shape[1]):
            if valid[i] and val[i, k]:
                want[idx[i, k]].append(i)
    got = [sorted(rows[off[j]:off[j + 1]].tolist()) for j in range(len(pos))]
    assert got == want
