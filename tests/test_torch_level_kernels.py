"""PyTorch port vs JAX reference: the pieces of the level-batched GOF path
(`vpcc_tpu_torch/parallel/gof.py` against `vpcc_tpu/parallel/gof.py` with
mesh=None), and kernel L's push order.

On the CPU, with the plain versions of the kernels; inputs from numpy seeds.
Checked exactly:
* `recolor_level` over a 2-frame level of padded 6-bit clouds of different
  counts (kernel M's frame-batched exact match and blend, kernel E's
  frame-batched sweeps);
* one level dispatch of two 64x64 geometry planes (per-plane QPs,
  occupancies and RD weights, parent references, motion search) and of two
  frames' chroma pairs (two planes per frame, deblocked): each frame's
  payload cut out of the batch, and the reconstruction;
* the thin ports `encode_level_geo` and `_recon_batch`;
* `push_pull_fill` on crafted planes whose 2x2 push sums pass 2^24, where
  XLA sums some levels pairwise (ROADMAP F8), alone and as the encoder's
  vmapped `_round_int_plane` over planes with their own occupancies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.ops import padding as jpadding
from vpcc_tpu.parallel import gof as jgof
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import hevc as jhevc
from vpcc_tpu_torch.core import atlas
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import padding, reconstruct
from vpcc_tpu_torch.parallel import gof
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import hevc

PAD = -(1 << 20)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _level_clouds():
    """Two padded 6-bit frames: sources of different counts (a person cloud
    each), targets a jittered 80 % of them plus a few far points."""
    rng = np.random.default_rng(11)
    srcs = [make_person_cloud(bits=6, n_samples=6000, seed=s) for s in (3, 4)]
    tgts = []
    for pc in srcs:
        pick = rng.permutation(pc.point_count)[: int(0.8 * pc.point_count)]
        t = pc.positions[pick].astype(np.int32)
        t[::4] = np.clip(t[::4] + rng.integers(-2, 3, t[::4].shape), 0, 63)
        tgts.append(np.concatenate([t, rng.integers(0, 64, (25, 3)).astype(np.int32)]))
    ns = max(pc.point_count for pc in srcs) + 37
    nt = max(len(t) for t in tgts) + 53
    sp = np.full((2, ns, 3), PAD, np.int32)
    sc = np.zeros((2, ns, 3), np.int32)
    tp = np.full((2, nt, 3), PAD, np.int32)
    for b, (pc, t) in enumerate(zip(srcs, tgts)):
        sp[b, : pc.point_count] = pc.positions
        sc[b, : pc.point_count] = pc.colors
        tp[b, : len(t)] = t
    return sp, sc, np.array([pc.point_count for pc in srcs], np.int32), tp, \
        np.array([len(t) for t in tgts], np.int32)


def test_recolor_level_matches_reference():
    sp, sc, scnt, tp, tcnt = _level_clouds()
    gates = (30.0, 20.0, 900.0, 4.0)
    want = np.asarray(jgof.recolor_level(jnp.asarray(sp), jnp.asarray(sc), jnp.asarray(scnt),
                                         jnp.asarray(tp), jnp.asarray(tcnt), 6, k=8,
                                         gates=gates))
    got = gof.recolor_level(torch.as_tensor(sp), torch.as_tensor(sc), torch.as_tensor(scnt),
                            torch.as_tensor(tp), torch.as_tensor(tcnt), 6, k=8, gates=gates)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, : tcnt[0]] != 0).any() and (want[1, : tcnt[1]] != 0).any()


def _level_planes():
    """Two 64x64 geometry-like planes (gradients and noise), their parents'
    decoded planes (shifted copies), occupancies and RD weights of their
    own."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:64, :64]
    planes = np.stack([(yy * 2 + xx + 40 * b) % 256 for b in range(2)])
    planes = np.clip(planes + rng.integers(-6, 7, planes.shape), 0, 255).astype(np.int32)
    refs = np.clip(np.roll(planes, (1, 3), (1, 2)) + rng.integers(-2, 3, planes.shape),
                   0, 255).astype(np.int32)
    occ = np.zeros((2, 64, 64), np.int32)
    occ[0, 8:50, 4:60] = 1
    occ[1, 20:64, 0:40] = 1
    wts = (occ * (rng.random(occ.shape) < 0.9)).astype(np.int32)
    return planes, refs, occ, wts


def test_level_geometry_dispatch_matches_reference():
    """D0 of a level: per-plane QPs, occupancies, weights, parent references
    and motion; each frame's payload and the reconstruction."""
    planes, refs, occ, wts = _level_planes()
    qps = [31, 36]
    outs, (ty, tx) = jgof._encode_level_planes(
        jnp.asarray(planes), qps, [255, 255], jnp.asarray(refs), True, False,
        jnp.asarray(wts), jnp.asarray(occ), None)
    coded = hevc.encode_planes_dispatch(torch.as_tensor(planes), qps, [255, 255],
                                        refs=torch.as_tensor(refs),
                                        occ=torch.as_tensor(occ.astype(np.uint8)),
                                        deblock=False, weight=torch.as_tensor(wts), motion=True)
    np.testing.assert_array_equal(coded.rec.numpy(), np.asarray(outs[6]))
    for b in range(2):
        want = jgof._slice_payload(None, outs, ty, tx, b, 64, 64, qps[b], 255, True, False, True)
        assert coded.payload(b, 1) == want
    # the thin port of `encode_level_geo`: the same arrays, the rec last
    j = jgof.encode_level_geo(jnp.asarray(planes), jnp.asarray(occ), jnp.asarray(wts),
                              jnp.asarray(refs), qps, 255)
    t = gof.encode_level_geo(torch.as_tensor(planes), torch.as_tensor(occ.astype(np.uint8)),
                             torch.as_tensor(wts), torch.as_tensor(refs), qps, 255)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


def test_level_chroma_dispatch_matches_reference():
    """T1's chroma of a level: two planes per frame (the inline chroma
    payload, gof.py:768-775), deblocked, inter-layer references, no
    occupancy, weights repeated per pair."""
    planes, refs, _, wts = _level_planes()
    cpl = np.stack([planes[:, ::2, ::2], planes[:, 1::2, 1::2]], 1).reshape(4, 32, 32)
    cref = np.stack([refs[:, ::2, ::2], refs[:, 1::2, 1::2]], 1).reshape(4, 32, 32)
    w2 = np.repeat(wts.reshape(2, 32, 2, 32, 2).max((2, 4)), 2, 0)
    qc = [35, 35, 40, 40]
    outs, (ty, tx) = jgof._encode_level_planes(
        jnp.asarray(cpl), qc, [255] * 4, jnp.asarray(cref), False, True, jnp.asarray(w2),
        None, None)
    coded = hevc.encode_planes_dispatch(torch.as_tensor(cpl), qc, [255] * 4,
                                        refs=torch.as_tensor(cref), deblock=True,
                                        weight=torch.as_tensor(w2), motion=False)
    np.testing.assert_array_equal(coded.rec.numpy(), np.asarray(outs[6]))
    T = ty * tx
    for b in range(2):
        sl = slice(2 * b * T, 2 * (b + 1) * T)
        want = jhevc.assemble_payload32(
            32, 32, 2, qc[2 * b: 2 * b + 2], [255, 255], True, True, False, ty, tx,
            *[np.asarray(outs[i][sl]) for i in (0, 1, 2, 3, 4, 5, 7, 8, 9)])
        assert coded.payload(2 * b, 2) == want


def test_recon_batch_matches_reference():
    """The thin port of `_recon_batch`: kernel C per frame against the
    vmapped `_recon_phase1` on two 6-bit frames' atlases (valid rows, in
    raster and layer order)."""
    cfg = VPCCConfig()
    for k, v in dict(geometry3dCoordinatesBitdepth=6, resolution=63, minimumImageWidth=64,
                     minimumImageHeight=64, iterationCountRefineSegmentation=2).items():
        setattr(cfg, k, v)
    enc = Encoder(cfg, device="cpu")
    fronts = enc.encode_gof_front([make_person_cloud(bits=6, n_samples=6000, seed=s)
                                   for s in (3, 4)])
    assert len({(f.height, f.width) for f in fronts}) == 1
    tables = [atlas.patch_table(f.patches) for f in fronts]
    pt = np.zeros((2, max(len(t) for t in tables), tables[0].shape[1]), np.int32)
    for b, t in enumerate(tables):
        pt[b, : len(t)] = t
    stack = lambda key, dt: np.stack([np.asarray(key(f)).astype(dt) for f in fronts])
    occ = stack(lambda f: f.occ_rec, np.uint8)
    g0 = stack(lambda f: f.frame.geometry0, np.int32)
    g1 = stack(lambda f: f.frame.geometry1, np.int32)
    btp = stack(lambda f: f.block_to_patch, np.int32)
    res = cfg.occupancyResolution
    pts, valid, cnt = jgof._recon_batch(*(jnp.asarray(a) for a in (occ, g0, g1, btp, pt)), res)
    got, tcnt = gof._recon_batch(*(torch.as_tensor(a) for a in (occ, g0, g1, btp)),
                                 [torch.as_tensor(t) for t in tables], res)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    for b in range(2):
        want = np.asarray(pts[b]).reshape(-1, 3)[np.asarray(valid[b]).reshape(-1)]
        np.testing.assert_array_equal(got[b].pos.numpy(), want)
    assert isinstance(got[0], reconstruct.Points) and int(cnt.min()) > 0


def _f8_plane(h, w, planes=0, seed=8):
    """Values below 2^24 on 5 % of the pixels, the top-left (h/4, w/4) block
    empty: push sums pass 2^24 from level 3, and the empty block reads a
    deep pairwise level (not the 1x1 top, whose order is not established)."""
    rng = np.random.default_rng(seed)
    shape = (planes, h, w) if planes else (h, w)
    img = rng.integers(0, 1 << 24, shape).astype(np.int32)
    occ = (rng.random(shape) < 0.05).astype(np.uint8)
    occ[..., : h // 4, : w // 4] = 0
    return img, occ


@pytest.mark.parametrize("h,w", [(256, 256), (512, 512)])
def test_push_pull_order_matches_reference(h, w, monkeypatch):
    """ROADMAP F8: XLA sums the 2x2 push blocks of these shapes pairwise at
    most levels; the plain fill follows data/push_order_xla.json and equals
    `push_pull_fill` bit for bit where the sums pass 2^24 (summing every
    level ((a + b) + c) + d would not)."""
    img, occ = _f8_plane(h, w)
    want = np.asarray(jpadding.push_pull_fill(jnp.asarray(img), jnp.asarray(occ)))
    assert "P" in padding.push_order(h, w)
    got = padding.push_pull_fill_plain(torch.as_tensor(img), torch.as_tensor(occ)).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(padding, "push_masks", lambda *_: (0, 0))
    seq = padding.push_pull_fill_plain(torch.as_tensor(img), torch.as_tensor(occ)).numpy()
    assert (seq != want).any()


def test_push_pull_order_at_the_encoder_call_site():
    """The vmapped `_round_int_plane` of the level path (a stack of planes,
    each under its own occupancy) against `push_pull_round`."""
    img, occ = _f8_plane(512, 512, planes=2)
    want = np.asarray(jnp.stack([jhevc._round_int_plane(jnp.asarray(p), jnp.asarray(o))
                                 for p, o in zip(img, occ)]))
    got = padding.push_pull_round(torch.as_tensor(img), torch.as_tensor(occ)).numpy()
    np.testing.assert_array_equal(got, want)


def test_push_pull_counts_unknown_orders():
    """Where XLA's order is not established (a shape outside the table, the
    1x1 top of a square power-of-two plane) the blocks past 2^24 are
    counted; 8-bit planes of the bench's atlas shapes count none."""
    img, occ = _f8_plane(1216, 1280)
    padding.reset_inexact()
    padding.push_pull_round(torch.as_tensor(img), torch.as_tensor(occ))
    assert padding.inexact_blocks() > 0
    padding.reset_inexact()
    small = (img >> 16).astype(np.int32)   # 8-bit samples
    padding.push_pull_round(torch.as_tensor(small), torch.as_tensor(occ))
    assert padding.inexact_blocks() == 0
    assert padding.push_order(512, 512).endswith("?")
    padding.reset_inexact()
