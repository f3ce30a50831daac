"""PyTorch port vs JAX reference: color transfer (K7) and color
pre-smoothing (K9), the plain versions of kernels M and N.

The same numpy inputs, made from a seed, go through
`vpcc_tpu.ops.recolor.transfer_colors_compact` / `smoothing.
presmooth_colors` (XLA on the CPU) and the port's counterparts (torch on
the CPU).  Integer stages and the float32 blends are exact: the port
evaluates XLA's float order (fused multiply-adds, the entropy table,
the split entropy sum), so every output color must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_md_cases import PRESMOOTH_CASES, presmooth_case, recolor_case
from vpcc_tpu.ops import recolor as jrecolor, smoothing as jsmoothing
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch.ops import recolor, smoothing

BITS = 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: with several test workers on the machine,
    intra-op threads only contend (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clouds():
    """A 7-bit person cloud as the source; the targets are 60 % of its
    positions verbatim (exact matches) and 40 % jittered by up to 2 voxels
    (mostly inexact), shuffled.  Sources picked by no target stay
    unmatched."""
    rng = np.random.default_rng(3)
    src = make_person_cloud(bits=BITS, n_samples=60000, seed=5)
    sp = src.positions.astype(np.int32)
    sc = src.colors.astype(np.uint8)
    n = sp.shape[0]
    pick = rng.permutation(n)[: int(0.8 * n)]
    n_ex = int(0.6 * len(pick))
    jit = sp[pick[n_ex:]] + rng.integers(-2, 3, (len(pick) - n_ex, 3))
    tp = np.concatenate([sp[pick[:n_ex]], np.clip(jit, 0, (1 << BITS) - 1)]).astype(np.int32)
    tp = tp[rng.permutation(len(tp))]
    return sp, sc, tp


@pytest.mark.parametrize("k_bwd", [1, 0])
def test_transfer_colors_compact_matches_reference(clouds, k_bwd):
    sp, sc, tp = clouds
    kw = dict(grid_bits=BITS, k=8, k_bwd=k_bwd, max_geom_d2_fwd=1000.0,
              max_geom_d2_bwd=1000.0, max_color_d2_fwd=1000.0, dist_offset_fwd=4.0)
    ref, (r_idx, r_has) = jrecolor.transfer_colors_compact(
        jnp.asarray(sp), jnp.asarray(sc), jnp.asarray(sp.shape[0]), jnp.asarray(tp),
        jnp.asarray(tp.shape[0]), **kw)
    got, (g_idx, g_has) = recolor.transfer_colors_compact(
        torch.as_tensor(sp), torch.as_tensor(sc), torch.as_tensor(tp), **kw)
    has = np.asarray(r_has)
    np.testing.assert_array_equal(g_has.numpy(), has)
    np.testing.assert_array_equal(g_idx.numpy()[has], np.asarray(r_idx)[has])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # all three kinds of rows occur: exact and inexact targets, unmatched sources
    matched = np.zeros(sp.shape[0], bool)
    matched[np.asarray(r_idx)[has]] = True
    assert has.sum() > 0 and (~has).sum() > 0 and (~matched).sum() > 0


def test_transfer_colors_gates_and_far_targets(clouds):
    """Tight gates (distance, color) and targets far from every source:
    the nearest neighbour still votes, far splats are dropped."""
    sp, sc, tp = clouds
    tp = tp.copy()
    tp[:50] = (1 << BITS) - 1
    kw = dict(grid_bits=BITS, k=8, k_bwd=1, max_geom_d2_fwd=2.0,
              max_geom_d2_bwd=1.0, max_color_d2_fwd=300.0, dist_offset_fwd=4.0)
    ref, _ = jrecolor.transfer_colors_compact(
        jnp.asarray(sp), jnp.asarray(sc), jnp.asarray(sp.shape[0]), jnp.asarray(tp),
        jnp.asarray(tp.shape[0]), **kw)
    got, _ = recolor.transfer_colors_compact(
        torch.as_tensor(sp), torch.as_tensor(sc), torch.as_tensor(tp), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["duplicates", "out_of_grid", "all_matched"])
def test_exact_compact_matches_reference(case):
    """`exact_compact_plain` (kernel M's exact entry with the compaction)
    against the reference's `_exact_and_counts` and `_compact_gather`:
    exact matches, the counts, and the first n rows of each compacted list
    (index and position).  Duplicated source positions resolve to the first
    of equal keys; targets outside the grid are inexact."""
    sp, _, tp = recolor_case(case, bits=BITS, n=8000, seed=4)
    ns, nt = sp.shape[0], tp.shape[0]
    ex_idx, ex_has, inexact, unmatched, n_in, n_un = jrecolor._exact_and_counts(
        jnp.asarray(sp), jnp.ones(ns, bool), jnp.asarray(tp), nt, BITS)
    n_in, n_un = int(n_in), int(n_un)
    j_iidx, j_tq = (np.asarray(a) for a in jrecolor._compact_gather(jnp.asarray(tp), inexact,
                                                                      nt))
    j_uidx, j_sq = (np.asarray(a) for a in jrecolor._compact_gather(jnp.asarray(sp), unmatched,
                                                                      ns))
    order, sk = recolor.sorted_source_keys(torch.as_tensor(sp), BITS)
    eidx, has, iidx, tq, uidx, sq = recolor.exact_compact_plain(
        order, sk, torch.as_tensor(sp), torch.as_tensor(tp), BITS)
    has_ref = np.asarray(ex_has)
    np.testing.assert_array_equal(has.numpy(), has_ref)
    np.testing.assert_array_equal(eidx.numpy()[has_ref], np.asarray(ex_idx)[has_ref])
    assert (iidx.shape[0], uidx.shape[0]) == (n_in, n_un)
    np.testing.assert_array_equal(iidx.numpy(), j_iidx[:n_in])
    np.testing.assert_array_equal(tq.numpy(), j_tq[:n_in])
    np.testing.assert_array_equal(uidx.numpy(), j_uidx[:n_un])
    np.testing.assert_array_equal(sq.numpy(), j_sq[:n_un])
    if case == "all_matched":
        assert n_in == 0 and n_un == 0
    else:
        assert n_in > 0 and n_un > 0 and has_ref.any()


@pytest.fixture(scope="module")
def smooth_input():
    """A 6-bit person cloud whose colors are flat per 8-voxel block (low
    luma entropy) with 15 % of the points recolored at random (far from
    their block's centroid), and a boundary mask over 40 % of the rows."""
    rng = np.random.default_rng(11)
    pc = make_person_cloud(bits=6, n_samples=40000, seed=9)
    pos = pc.positions.astype(np.int32)
    blk = pos // 8
    base = ((blk * np.array([37, 91, 53])) % 256).astype(np.int32)
    noisy = rng.random(len(pos)) < 0.15
    colors = np.where(noisy[:, None], rng.integers(0, 256, (len(pos), 3)), base).astype(np.int32)
    bnd = rng.random(len(pos)) < 0.4
    return pos, colors, bnd


def test_presmooth_colors_matches_reference(smooth_input):
    pos, colors, bnd = smooth_input
    kw = dict(k=64, radius2=64.0, thr_dist=10.0, thr_entropy=2.0)
    ref = np.asarray(jsmoothing.presmooth_colors(
        jnp.asarray(pos), jnp.asarray(colors), pos.shape[0], jnp.asarray(bnd), 6, **kw))
    got = smoothing.presmooth_colors(torch.as_tensor(pos), torch.as_tensor(colors),
                                     torch.as_tensor(bnd), 6, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    changed = (got != colors).any(1)
    # both branches: boundary points replaced by their centroid, and kept
    assert changed.sum() > 0 and (bnd & ~changed).sum() > 0
    assert not changed[~bnd].any()


@pytest.mark.parametrize("bits,n_samples,bnd_share", [(7, 30000, 0.3), (6, 40000, 1.0),
                                                     (6, 40000, 0.0)])
def test_presmooth_colors_cases(bits, n_samples, bnd_share):
    """`presmooth_colors` (kernel N's plain version writing into a copy of
    the colors at the boundary rows) against the reference on a 7-bit cloud
    and on a 6-bit one whose every or no point is a boundary point."""
    rng = np.random.default_rng(bits)
    pc = make_person_cloud(bits=bits, n_samples=n_samples, seed=12)
    pos = pc.positions.astype(np.int32)
    base = (((pos // 8) * np.array([37, 91, 53])) % 256).astype(np.int32)
    noisy = rng.random(len(pos)) < 0.15
    colors = np.where(noisy[:, None], rng.integers(0, 256, (len(pos), 3)), base).astype(np.int32)
    bnd = rng.random(len(pos)) < bnd_share
    kw = dict(k=64, radius2=64.0, thr_dist=10.0, thr_entropy=2.0)
    ref = np.asarray(jsmoothing.presmooth_colors(
        jnp.asarray(pos), jnp.asarray(colors), pos.shape[0], jnp.asarray(bnd), bits, **kw))
    got = smoothing.presmooth_colors(torch.as_tensor(pos), torch.as_tensor(colors),
                                     torch.as_tensor(bnd), bits, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    changed = (got != colors).any(1)
    assert changed.any() == (bnd_share > 0) and not changed[~bnd].any()


@pytest.mark.parametrize("case", PRESMOOTH_CASES)
def test_presmooth_vote_plain_matches_reference(case):
    """`presmooth_vote_plain` against the reference's `_presmooth_vote` on
    crafted neighbour rows (queries without a valid neighbour, with one,
    entropies exactly at thr_entropy and one float32 step below it, the
    cloud's first and last rows): the
    voted rows written into the copy at bidx, its other rows untouched."""
    colors, nidx, nd2, bidx, r2, td, te = presmooth_case(case)
    want, replace = jsmoothing._presmooth_vote(
        jnp.asarray(colors), jnp.asarray(nidx), jnp.asarray(nd2), jnp.asarray(colors[bidx]),
        jnp.float32(r2), jnp.float32(td), jnp.float32(te))
    out = torch.full(colors.shape, -1, dtype=torch.int32)
    got = smoothing.presmooth_vote_plain(torch.as_tensor(colors), torch.as_tensor(nidx),
                                         torch.as_tensor(nd2), torch.as_tensor(bidx), out,
                                         r2, td, te)
    assert got is out
    np.testing.assert_array_equal(out.numpy()[bidx], np.asarray(want))
    rest = np.ones(len(colors), bool)
    rest[bidx] = False
    assert (out.numpy()[rest] == -1).all()
    replace = np.asarray(replace)
    if case == "entropy_tie":
        assert replace[::2].any() and not replace[1::2].any()
    elif case == "entropy_ulp":
        assert replace[::2].any() and replace[1::2].any()
    elif case in ("all_invalid", "one_valid"):
        assert replace.any() and not (case == "all_invalid" and replace[::2].any())


def test_entropy_table_equals_xla_expression():
    """The committed table holds XLA's -log2(max(cnt / n, 1e-12)), evaluated
    here in a (M, 64) program like the vote's, for every 1 <= cnt <= n <= 64."""
    rng = np.random.default_rng(0)
    n = rng.integers(1, 65, (4096, 1)).repeat(64, 1)
    cnt = np.minimum(rng.integers(1, 65, (4096, 64)), n)
    f = jax.jit(lambda c, m: -jnp.log2(jnp.maximum(c / m, 1e-12)))
    xla = np.asarray(f(cnt.astype(np.float32), n.astype(np.float32)))
    tab = smoothing.entropy_table(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(tab[n * 65 + cnt], xla)
    nn, cc = np.meshgrid(np.arange(1, 65), np.arange(1, 65), indexing="ij")
    ok = cc <= nn
    full = np.asarray(f(cc[ok].astype(np.float32), nn[ok].astype(np.float32)))
    np.testing.assert_array_equal(tab[nn[ok] * 65 + cc[ok]], full)
