"""PyTorch port vs JAX reference: PBF patch border filtering (kernel U's
plain version, vpcc_tpu/ops/pbf.py `count_border`,
`pbf_filter_occupancy`).

On the CPU, from numpy seeds:
* the forward patch -> canvas orientation helper equals the reference's
  and inverts `_canvas_to_patch_uv` (tests/test_pbf.py:10);
* the border count and the filtered occupancy equal the reference's
  exactly on tests/test_pbf.py's hand-built seam scene, its no-neighbour
  scene, and a random scene of overlapping patches with every orientation,
  both projection modes, 45-degree patches (no border points) and LOD
  fields (ignored by PBF, ROADMAP F3), at one to four passes.
The decoded planes of a tiny encode are held in tests/test_torch_tools.py.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpcc_tpu.ops import pbf as jpbf
from vpcc_tpu.ops.reconstruct import _canvas_to_patch_uv as j_inverse
from vpcc_tpu_torch.ops import pbf as tpbf
from vpcc_tpu_torch.ops.reconstruct import _canvas_to_patch_uv as t_inverse

import test_pbf


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_forward_uv_to_canvas_matches_reference():
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 16, 256), rng.integers(0, 24, 256)
    o = np.arange(256) % 8
    want = jpbf._forward_uv_to_canvas(jnp.asarray(u), jnp.asarray(v), 16, 24, jnp.asarray(o))
    got = tpbf._forward_uv_to_canvas(*(torch.as_tensor(a) for a in (u, v)), 16, 24,
                                     torch.as_tensor(o))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u2, v2 = t_inverse(*got, 16, 24, torch.as_tensor(o))
    np.testing.assert_array_equal(u2.numpy(), u)
    np.testing.assert_array_equal(v2.numpy(), v)
    ju, jv = j_inverse(*(jnp.asarray(a.numpy()) for a in got), 16, 24, jnp.asarray(o))
    np.testing.assert_array_equal(np.asarray(ju), u)


def random_scene(seed):
    """A 128 x 128 canvas, 8-pixel blocks, 12 patches of 2 x 2 blocks (one
    block left empty now and then) over one small world box, so that border
    points of one patch project onto others; holes near block edges."""
    rng = np.random.default_rng(seed)
    h = w = 128
    res = 8
    P = 12
    occ = np.zeros((h, w), np.uint8)
    btp = np.zeros((h // res, w // res), np.int32)
    tbl = np.zeros((16, 16), np.int32)
    perms = [(2, 0, 1), (0, 2, 1), (1, 2, 0), (2, 1, 0), (0, 1, 2), (1, 0, 2)]
    for p in range(P):
        bx, by = (p % 6) * 2 + (p // 6), (p // 6) * 3
        na, ta, ba = perms[p % 6]
        tbl[p] = [bx, by, 2, 2, rng.integers(0, 6), rng.integers(0, 6), rng.integers(0, 6),
                  na, ta, ba, p % 2, p % 8, 1 if p == 11 else 0, 5,
                  rng.integers(1, 3), rng.integers(1, 3)]
        for dy in range(2):
            for dx in range(2):
                if rng.random() < 0.1:
                    continue
                btp[by + dy, bx + dx] = p + 1
                blk = rng.random((res, res)) < 0.97
                blk[2:6, 2:6] = True
                occ[(by + dy) * res:(by + dy + 1) * res, (bx + dx) * res:(bx + dx + 1) * res] = blk
    yy, xx = np.mgrid[0:h, 0:w]
    geo = ((xx // 5 + yy // 7) % 5 + rng.integers(0, 2, (h, w))).astype(np.int32)
    return occ, geo, btp, tbl, res


def both(occ, geo, btp, tbl, res, passes, fs=4, thr=4):
    j = jnp.asarray
    want = np.asarray(jpbf.pbf_filter_occupancy(j(occ), j(geo), j(btp), j(tbl), res,
                                                passes=passes, filter_size=fs, threshold=thr,
                                                bucket=1 << 14))
    nb = int(jpbf.count_border(j(occ), j(btp), res))
    t = lambda a: torch.as_tensor(np.asarray(a))
    got = tpbf.pbf_filter_occupancy_plain(t(occ.astype(np.uint8)), t(geo), t(btp), t(tbl), res,
                                          passes, fs, thr)
    assert tpbf.count_border_plain(t(occ.astype(np.uint8)), t(btp), res) == nb
    return want, got.numpy(), nb


@pytest.mark.parametrize("scene", ["seam", "no_neighbour"])
def test_pbf_hand_built_scenes_match_reference(scene):
    if scene == "seam":
        occ, geo, btp, tbl, res = test_pbf._step_scene()
    else:
        occ = np.zeros((64, 64), bool)
        occ[0:16, 0:16] = True
        geo = np.zeros((64, 64), np.int32)
        btp = np.zeros((4, 4), np.int32)
        btp[0, 0] = 1
        tbl = np.zeros((64, 14), np.int32)
        tbl[0] = [0, 0, 1, 1, 8, 8, 10, 2, 0, 1, 0, 0, 0, 10]
        res = 16
    want, got, nb = both(occ, geo, btp, tbl, res, passes=2)
    assert nb > 0 and (scene == "no_neighbour") == np.array_equal(want, occ)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,passes,fs", [(0, 2, 4), (1, 1, 2)])
def test_pbf_random_scene_matches_reference(seed, passes, fs):
    occ, geo, btp, tbl, res = random_scene(seed)
    occp = occ.astype(bool) & (np.repeat(np.repeat(btp, res, 0), res, 1) > 0)
    want, got, nb = both(occ, geo, btp, tbl, res, passes, fs)
    dropped = int(occp.sum() - want.sum())
    print(f"seed {seed}: {nb} border pixels, {dropped} dropped")
    assert dropped > 0
    np.testing.assert_array_equal(got, want)
