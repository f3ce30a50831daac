"""PyTorch port vs JAX reference: PLR, point local reconstruction (kernel
V's plain versions, vpcc_tpu/ops/plr.py).

On the CPU, from numpy seeds:
* `interp_deltas`, the per-pixel `mode_planes` (and the code plane built
  from them) and the RDO (`rdo`: block modes, patch levels, patch modes)
  equal the reference's exactly on random planes, with small and large
  patches, one, six and all ten modes;
* `assign_patch_plr` gives the reference's patch syntax for patches of
  every orientation, and `block_modes_from_patches` rebuilds the block map
  from it as the reference does;
* the PLR layers through kernel C's EOM entry (`generate_points_plain` with
  the code plane as a 3-bit EOM plane) equal the reference's
  `_recon_phase1(plr=True)` + `_recon_phase2` rows: positions, pixels,
  layer tags, patch ids, boundary flags.
All comparisons are exact.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_fill_rdo_cases import rdo_case
from vpcc_tpu import pipeline as jpipe
from vpcc_tpu.ops import plr as jplr
from vpcc_tpu_torch.ops import plr as tplr
from vpcc_tpu_torch.ops import reconstruct as trec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planes(seed, h=64, w=96, res=16, n_patch=5):
    """Decoded D0 (a smooth surface with a few depth steps), the true D0
    and D1 around it, an occupancy with holes and a block-to-patch map
    whose patches hold 1 to 8 blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    g0t = (30 + (xx // 7) % 4 + (yy // 9) % 3).astype(np.int32)
    g1t = g0t + rng.integers(0, 5, (h, w)).astype(np.int32)
    g0d = (g0t + rng.integers(-1, 2, (h, w))).astype(np.int32)
    occ = (rng.random((h, w)) < 0.85).astype(np.uint8)
    btp = rng.integers(0, n_patch + 1, (h // res, w // res)).astype(np.int32)
    return g0d, g0t, g1t, occ, btp, res


def _rdo_crafted(case: str, n_modes: int) -> None:
    """The RDO on a crafted case of tests/torch_fill_rdo_cases.py against
    the reference: in "big" the blocks and pools whose sums reach 2^24
    (patches 1 and 4: XLA's float32 order decides them) are counted, not
    compared."""
    *arrays, res, thr, p_max = rdo_case(case)
    g0d, g0t, g1t, occ, btp, tbl = arrays
    assert tbl.shape[0] == n_modes
    j, t = jnp.asarray, torch.as_tensor
    bm, pl, pm = (np.asarray(a) for a in jplr.rdo(*(j(a) for a in arrays), res, thr, p_max))
    got = tplr.rdo_plain(*(t(np.ascontiguousarray(a)) for a in arrays), res, thr, p_max)
    keep, kept_patches = np.ones(btp.shape, bool), np.ones(p_max, bool)
    if case == "big":
        assert got.inexact == 3
        keep, kept_patches[[0, 3]] = ~np.isin(btp, (1, 4)), False
    else:
        assert got.inexact == 0
    np.testing.assert_array_equal(got.block_modes.numpy()[keep], bm[keep])
    np.testing.assert_array_equal(got.patch_level.numpy(), pl)
    np.testing.assert_array_equal(got.patch_modes.numpy()[kept_patches], pm[kept_patches])
    assert pl[4] and not pl[0] and pl[6] and pl[7]   # patch 5 == threshold; 7, 8 unused


@pytest.mark.parametrize("seed,n_modes", [(0, 6), (1, 10), (2, 1), ("chunks", 6),
                                          ("one_mode", 1), ("modes16", 16), ("big", 6)])
def test_rdo_and_mode_planes_match_reference(seed, n_modes):
    """The RDO and the mode planes on random planes (an integer seed), and
    the RDO on kernel V's crafted cases (a patch across many scan chunks,
    an index with no block, blocks of patch 0, a patch of exactly
    block_threshold blocks, 1 and 16 modes, sums reaching 2^24)."""
    if isinstance(seed, str):
        _rdo_crafted(seed, n_modes)
        return
    g0d, g0t, g1t, occ, btp, res = planes(seed)
    tbl = jplr.MODE_TABLE[:n_modes]
    j, t = jnp.asarray, torch.as_tensor
    d1, d2 = jplr.interp_deltas(j(g0d))
    t1, t2 = tplr.interp_deltas_plain(t(g0d))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(d2))
    bm, pl, pm = jplr.rdo(j(g0d), j(g0t), j(g1t), j(occ), j(btp), j(tbl), res, 2, 64)
    got = tplr.rdo_plain(t(g0d), t(g0t), t(g1t), t(occ), t(btp), t(tbl), res, 2, 64)
    np.testing.assert_array_equal(got.block_modes.numpy(), np.asarray(bm))
    np.testing.assert_array_equal(got.patch_level.numpy(), np.asarray(pl))
    np.testing.assert_array_equal(got.patch_modes.numpy(), np.asarray(pm))
    assert got.inexact == 0
    if n_modes > 1:
        assert len(np.unique(np.asarray(bm))) > 1 and np.asarray(pl)[:5].any()
    dm, fl = jplr.mode_planes(j(g0d), j(jplr.upsample_modes(np.asarray(bm), res)), j(tbl))
    tdm, tfl = tplr.mode_planes_plain(t(g0d), got.block_modes, t(tbl), res)
    np.testing.assert_array_equal(tdm.numpy(), np.asarray(dm))
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(fl))
    want = sum(((np.asarray(dm) == k) | (np.asarray(fl) & (np.asarray(dm) > k))).astype(np.int32)
               << (k - 1) for k in (1, 2, 3))
    code = tplr.code_plane_plain(t(g0d), got.block_modes, t(tbl), res)
    np.testing.assert_array_equal(code.numpy(), want)


def _patches(rng, btp_shape):
    """Six patches of 1x1 to 3x4 blocks, every orientation, placed apart."""
    out = []
    for i in range(6):
        su, sv = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        o = i % 8 if i < 5 else 7
        cw, ch = (sv, su) if o in (1, 2, 4, 6) else (su, sv)
        out.append(types.SimpleNamespace(size_u0=su, size_v0=sv, orientation=o,
                                         u0=(i % 3) * 5, v0=(i // 3) * 5, cw=cw, ch=ch))
    return out


def test_patch_syntax_round_trip():
    rng = np.random.default_rng(3)
    nbh, nbw = 10, 15
    pats = _patches(rng, (nbh, nbw))
    btp = np.zeros((nbh, nbw), np.int32)
    for i, p in enumerate(pats):
        btp[p.v0:p.v0 + p.ch, p.u0:p.u0 + p.cw] = i + 1
    btp[pats[2].v0, pats[2].u0] = 0                    # a block the patch does not own
    modes = rng.integers(0, 6, (nbh, nbw)).astype(np.int32)
    level = np.array([1, 0, 0, 1, 0, 0], bool)
    pmodes = rng.integers(0, 6, 6).astype(np.int32)
    jp = [types.SimpleNamespace(**vars(p)) for p in pats]
    jplr.assign_patch_plr(jp, modes, btp, level, pmodes)
    tplr.assign_patch_plr(pats, modes, btp, level, pmodes)
    for a, b in zip(pats, jp):
        assert (a.plr_level, a.plr_mode) == (b.plr_level, b.plr_mode)
        assert (a.plr_block_modes is None) == (b.plr_block_modes is None)
        if a.plr_block_modes is not None:
            np.testing.assert_array_equal(a.plr_block_modes, b.plr_block_modes)
    got = tplr.block_modes_from_patches(pats, btp, nbh, nbw)
    np.testing.assert_array_equal(got, jplr.block_modes_from_patches(jp, btp, nbh, nbw))
    for i, p in enumerate(pats):                       # owned blocks come back
        own = btp == i + 1
        want = p.plr_mode if p.plr_level else modes
        np.testing.assert_array_equal(got[own], np.broadcast_to(want, own.shape)[own])


def test_plr_layers_through_kernel_c_match_reference():
    """A synthetic atlas (as tests/test_torch_eom.py's) with PLR modes from
    the RDO: the code plane through generate_points_plain equals the
    reference's PLR rows, in its order."""
    rng = np.random.default_rng(5)
    g0d, g0t, g1t, occ, btp, res = planes(5, h=64, w=128)
    P = int(btp.max())
    ptable = np.stack([
        np.zeros(P), np.zeros(P),                                       # u0, v0 (blocks)
        np.full(P, 4), np.full(P, 8),                                   # su0, sv0
        rng.integers(0, 50, P), rng.integers(0, 50, P), rng.integers(5, 200, P),
        np.arange(P) % 3, (np.arange(P) + 1) % 3, (np.arange(P) + 2) % 3,
        rng.integers(0, 2, P), np.arange(P) % 8, np.arange(P) % 4, np.full(P, 10),
        rng.integers(1, 3, P), rng.integers(1, 3, P),
    ], 1).astype(np.int32)
    tbl = jplr.MODE_TABLE[:10]
    j, t = jnp.asarray, torch.as_tensor
    bm = tplr.rdo_plain(t(g0d), t(g0t), t(g1t), t(occ), t(btp), t(tbl), res, 2, 64).block_modes
    dm, fl = jplr.mode_planes(j(g0d), j(jplr.upsample_modes(bm.numpy(), res)), j(tbl))
    pts, valid, pix, pid, bnd, cnt = jpipe._recon_phase1(
        j(occ), j(g0d), j(g0d), j(btp), j(ptable), res, plr=True, plr_dmag=dm, plr_fill=fl)
    n = int(cnt)
    want = [np.asarray(a)[:n] for a in jpipe._recon_phase2(
        pts, valid, pix, pid, bnd, jnp.float32(64.0), n, False, 8, 10)]
    code = tplr.code_plane_plain(t(g0d), bm, t(tbl), res)
    got = trec.generate_points_plain(t(occ), t(g0d), t(g0d), t(btp), t(ptable), res,
                                     eom=code, eom_bits=tplr.N_LAYERS)
    assert want[1].all() and got.pos.shape[0] == n and (want[3] == 2).sum() > 500
    for name, w in zip(("pos", None, "pix", "layer", "pid", "bnd"), want):
        if name is not None:
            np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)
