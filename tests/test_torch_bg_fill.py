"""PyTorch port vs JAX reference: the background fills of attribute images
(vpcc_tpu/ops/padding.py `dilate_fill`, `harmonic_fill`, `smooth_fill` and
`fill_rgb`'s attributeBGFill dispatch), and `push_pull_fill` at the shapes
of kernel L's tile plan.

The port's plain versions (kernel W's and kernel L's twins) run on the CPU
on the same inputs, made from numpy seeds, as the JAX functions: random
64x64 planes, an odd 48x80 shape (the pyramids stop early), an all-empty
plane, an all-full plane and one occupied pixel beside an edge (the
stencils wrap around).  The float outputs before rounding must be equal bit
for bit and the rounded integers equal.  Crafted float planes whose values
span 2^0..2^30 make every change of the summation order visible: they hold
the port to the order of the reference's XLA CPU program (the 2x2 pyramid
sums ((a + b) + c) + d, the stencil ((up + down) + left) + right).  They
run at widths of 80 and 320, which share the odd factor 5 of the 1280-wide
atlases: at power-of-two widths XLA's program for `push_pull_fill` (and so
`smooth_fill`) adds some levels' 2x2 sums pairwise, (a + b) + (c + d), which
changes nothing for integer planes whose level sums stay below 2^24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.ops import padding as jpad
from vpcc_tpu_torch.ops import padding as tpad


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops; with several test
    workers on the machine, intra-op threads only contend, so this module
    runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _occupancy(case: str, rng) -> np.ndarray:
    if case == "random64":
        return (rng.random((64, 64)) < 0.3).astype(np.uint8)
    if case == "odd48x80":
        occ = np.zeros((48, 80), np.uint8)
        occ[5:20, 10:30] = 1
        occ[30:44, 60:78] = rng.random((14, 18)) < 0.7
        return occ
    if case == "empty":
        return np.zeros((32, 64), np.uint8)
    if case == "full":
        return np.ones((32, 32), np.uint8)
    if case == "wide128x320":
        return (rng.random((128, 320)) < 0.2).astype(np.uint8)
    if case == "ragged720x400":
        return (rng.random((720, 400)) < 0.3).astype(np.uint8)
    if case == "corner":
        occ = np.zeros((256, 192), np.uint8)
        occ[0, 0] = 1
        return occ
    if case == "tiny6x10":
        return (rng.random((6, 10)) < 0.3).astype(np.uint8)
    if case == "odd47x64":
        return (rng.random((47, 64)) < 0.3).astype(np.uint8)
    occ = np.zeros((64, 64), np.uint8)   # "edge": one pixel on the top row
    occ[0, 5] = 1
    return occ


CASES = ["random64", "odd48x80", "empty", "full", "edge"]
PARAMS = [(c, False) for c in CASES] + [(c, True) for c in ("odd48x80", "wide128x320")]
# the harmonic fill also on the shapes of kernel W's crafted cases
# (tests/torch_fill_rdo_cases.py): sides off its 64-pixel tiles at two
# tiled levels, one pixel in a corner (every halo wraps), a plane smaller
# than a halo, an odd side (level 0 alone), and a stack of three planes
HARMONIC_PARAMS = PARAMS + [("ragged720x400", True), ("corner", False), ("tiny6x10", False),
                            ("odd47x64", False), ("stack3", False)]


def _image(occ, rng, crafted: bool) -> np.ndarray:
    if crafted:
        mag = np.float32(2.0) ** rng.integers(0, 31, occ.shape)
        return (mag * rng.random(occ.shape, dtype=np.float32)).astype(np.float32)
    return rng.integers(0, 256, occ.shape).astype(np.int32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case,crafted", PARAMS)
def test_dilate_fill_matches_reference(case, crafted):
    rng = np.random.default_rng(11)
    occ = _occupancy(case, rng)
    img = _image(occ, rng, crafted)
    got, passes = tpad.dilate_fill_plain(torch.as_tensor(img), torch.as_tensor(occ))
    _eq(got, jpad.dilate_fill(jnp.asarray(img), jnp.asarray(occ)))
    if case == "edge":
        assert passes == 64     # the torus' farthest pixel is 32 + 32 steps away
    if case in ("empty", "full"):
        assert passes == 0


def test_dilate_fill_pass_limit():
    """A plane that needs more passes than the limit: the reference stops
    at max_iters with pixels left empty (0)."""
    rng = np.random.default_rng(12)
    occ = _occupancy("edge", rng)
    img = _image(occ, rng, False)
    got, passes = tpad.dilate_fill_plain(torch.as_tensor(img), torch.as_tensor(occ), 7)
    want = jpad.dilate_fill(jnp.asarray(img), jnp.asarray(occ), max_iters=7)
    _eq(got, want)
    assert passes == 7 and (np.asarray(want) == 0).sum() > 0


@pytest.mark.parametrize("case,crafted", HARMONIC_PARAMS)
def test_harmonic_fill_matches_reference(case, crafted):
    rng = np.random.default_rng(13)
    if case == "stack3":   # three planes under one occupancy, as fill_rgb fills them
        occ = _occupancy("random64", rng)
        img = np.stack([_image(occ, rng, crafted) for _ in range(3)])
    else:
        occ = _occupancy(case, rng)
        img = _image(occ, rng, crafted)
    got = tpad.harmonic_fill_plain(torch.as_tensor(img), torch.as_tensor(occ))
    planes = img.reshape(-1, *occ.shape)
    want = np.stack([np.asarray(jpad.harmonic_fill(jnp.asarray(p), jnp.asarray(occ)))
                     for p in planes])
    _eq(got, want.reshape(img.shape))


@pytest.mark.parametrize("case,crafted", PARAMS)
def test_smooth_fill_matches_reference(case, crafted):
    rng = np.random.default_rng(14)
    occ = _occupancy(case, rng)
    img = _image(occ, rng, crafted)
    got = tpad.smooth_fill_plain(torch.as_tensor(img), torch.as_tensor(occ))
    _eq(got, jpad.smooth_fill(jnp.asarray(img), jnp.asarray(occ)))


def test_stencil_order_is_xla_order():
    """One relaxation step whose four neighbour values only add up right
    in the reference's order: ((2^24 + 1) + 1) + 0 rounds to 2^24 twice,
    while any order that adds the two ones first gives 2^24 + 2."""
    img = np.zeros((8, 8), np.float32)
    occ = np.zeros((8, 8), np.uint8)
    for (y, x), v in (((2, 4), 2.0 ** 24), ((4, 4), 1.0), ((3, 3), 1.0), ((3, 5), 0.0)):
        img[y, x], occ[y, x] = v, 1
    got = tpad.smooth_fill_plain(torch.as_tensor(img), torch.as_tensor(occ), 1)
    want = jpad.smooth_fill(jnp.asarray(img), jnp.asarray(occ), iterations=1)
    _eq(got, want)
    assert float(got[3, 4]) == 2.0 ** 22   # (2^24) * 0.25


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fill_rgb_matches_reference(mode):
    """`fill_rgb` of two layers' RGB planes (the encoder's (2, 3, H, W)
    stack) against the reference's `fill_rgb` of each (H, W, 3) image."""
    rng = np.random.default_rng(20 + mode)
    occ = _occupancy("odd48x80", rng)
    imgs = rng.integers(0, 256, (2, 48, 80, 3)).astype(np.int32)
    planes = torch.as_tensor(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))
    got = tpad.fill_rgb(planes, torch.as_tensor(occ), mode)
    for ly in range(2):
        want = jpad.fill_rgb(jnp.asarray(imgs[ly]), jnp.asarray(occ), mode)
        np.testing.assert_array_equal(got[ly].permute(1, 2, 0).numpy(), np.asarray(want))


# kernel L's tile plan (csrc/push_pull.cu): one level (6x10 has L = 1),
# L < 5 and a ragged region (12x20), L > 5 with 1024-wide planes (64x1024,
# L = 6: tile push, top, tile pull), a single occupied pixel (every fill
# from the coarse levels), and a stack with an occupancy per plane (the
# level path's vmapped `_round_int_plane`)
PP_CASES = ["6x10", "12x20", "64x1024", "single_pixel", "stack3"]


@pytest.mark.parametrize("case", PP_CASES)
def test_push_pull_tile_plan_matches_reference(case):
    """`push_pull_fill_plain` and `push_pull_round_plain` against the
    reference's `push_pull_fill` (and its rounding) at the shapes of kernel
    L's tile plan, bit for bit."""
    rng = np.random.default_rng(len(case))
    h, w = {"6x10": (6, 10), "12x20": (12, 20)}.get(case, (64, 1024))
    shape = (3, h, w) if case == "stack3" else (h, w)
    img = rng.integers(0, 1024, shape).astype(np.int32)
    occ = (rng.random(shape) < 0.2).astype(np.uint8)
    if case == "single_pixel":
        occ[:] = 0
        occ[41, 877] = 1
    fill = jax.vmap(jpad.push_pull_fill) if case == "stack3" else jpad.push_pull_fill
    want = np.asarray(fill(jnp.asarray(img), jnp.asarray(occ)))
    got = tpad.push_pull_fill_plain(torch.as_tensor(img), torch.as_tensor(occ))
    _eq(got, want)
    _eq(tpad.push_pull_round_plain(torch.as_tensor(img), torch.as_tensor(occ)),
        np.round(want).astype(np.int32))
