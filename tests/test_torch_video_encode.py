"""PyTorch port vs JAX reference: the geometry video encoder's pieces.

Same numpy inputs, made from seeds, go through the JAX package (CPU) and
the port's plain versions of kernels I-L (CPU): motion search (J), SAO
search and apply (K), push-pull fill (L), the payload writers, and the
whole plane encoder (kernel I inside) on intra, inter-layer and motion
planes.  Integer stages must be identical.  The RD decisions are float32;
the port evaluates them in the order the reference's XLA CPU program was
found to use (fused multiply-adds, its log2 values), and on these planes
every decision, hence every payload byte, equals the reference's.  The
tests pin the CU syntax agreement at >= 0.99 per plane (measured: 1.0) and
the RD tolerances of the port's gate: bytes within 1 %, occupied-pixel
PSNR within 0.1 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.ops import padding as jpad
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.video import codecs as jcodecs, entropy as jent, hevc as jh
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.ops import padding as tpad
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import codecs as tcodecs, entropy as tent, hevc as th
from vpcc_tpu_torch.video import hevc_tables as tab

AGREEMENT_FLOOR = 0.99
BYTES_TOL = 0.01
PSNR_TOL_DB = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions of kernels I-L run many small tensor ops; with
    several test workers on the machine, intra-op threads only contend, so
    this module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _smooth(rng, shape, maxval, k=7):
    """Smooth integer planes: box-filtered noise plus a few flat
    rectangles (sharp edges), clipped to [0, maxval]."""
    P, H, W = shape
    x = rng.random((P, H + k, W + k))
    c = np.cumsum(np.cumsum(x, 1), 2)
    box = (c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]) / (k * k)
    box = (box - box.min()) / (np.ptp(box) + 1e-9) * maxval
    out = box[:, :H, :W] + rng.integers(-2, 3, (P, H, W))
    for p in range(P):
        for _ in range(4):
            y, xx = rng.integers(0, H), rng.integers(0, W)
            out[p, y: y + rng.integers(4, 30), xx: xx + rng.integers(4, 30)] = rng.integers(0, maxval)
    return np.clip(out, 0, maxval).astype(np.int32)


# ---------------------------------------------------------------------------
# kernel L: push-pull


@pytest.mark.parametrize("H,W,share,seed", [(256, 256, 0.6, 0), (128, 96, 0.03, 1),
                                            (64, 40, 0.0, 2)])
def test_push_pull_matches_reference(H, W, share, seed):
    """256x256 with 1023-valued samples puts the coarse sums above 2^24,
    where the order of the 2x2 reduce decides the rounding."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1024, (H, W)).astype(np.int32)
    occ = (rng.random((H, W)) < share).astype(np.uint8)
    want = np.asarray(jpad.push_pull_fill(jnp.asarray(img), jnp.asarray(occ)))
    got = tpad.push_pull_fill_plain(_t(img), _t(occ)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpad.push_pull_round(_t(img), _t(occ)).numpy(),
                                  np.round(want).astype(np.int32))


# ---------------------------------------------------------------------------
# kernel J: motion search


@pytest.mark.parametrize("bs,seed", [(32, 0), (16, 1)])
def test_motion_search_matches_reference(bs, seed):
    rng = np.random.default_rng(seed)
    P, H, W = 2, 128, 96
    base = _smooth(rng, (P, H + 16, W + 16), 255)
    src = np.ascontiguousarray(base[:, 5:5 + H, 3:3 + W])
    # half a sample off the source grid: fractional vectors must win
    ref = ((base[:, 8:8 + H, 8:8 + W] + base[:, 8:8 + H, 9:9 + W] + 1) // 2).astype(np.int32)
    lam = tab.LAMBDA[[24, 34]]
    maxv = np.array([255, 255], np.int32)
    jm, jc = jh._motion_search_half(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(lam),
                                    jh.MV_RANGE, H // bs, W // bs, bs, jnp.asarray(maxv))
    tm, tc = th.motion_search(_t(src), _t(ref), _t(lam), _t(maxv), bs)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ((tm.numpy() & 1) != 0).any()


# ---------------------------------------------------------------------------
# kernel K: SAO


@pytest.mark.parametrize("seed,maxval", [(0, 255), (1, 1023)])
def test_sao_matches_reference(seed, maxval):
    rng = np.random.default_rng(seed)
    P, H, W = 2, 96, 128
    src = _smooth(rng, (P, H, W), maxval)
    rec = np.clip(src + rng.integers(-5, 6, src.shape), 0, maxval).astype(np.int32)
    w = (rng.random(src.shape) < 0.7).astype(np.int32)
    lam = tab.LAMBDA[[22, 32]]
    maxv = np.full(P, maxval, np.int32)
    r_j, c_j, o_j = jh._sao_search_apply(jnp.asarray(src), jnp.asarray(rec), jnp.asarray(lam),
                                         jnp.asarray(maxv), jnp.asarray(w))
    c_t, o_t = th.sao_search(_t(src), _t(rec), _t(lam), _t(w))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    assert (c_t.numpy() > 0).any()
    r_t = th.sao_apply(_t(rec), c_t, o_t, _t(maxv))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(
        r_t.numpy(), np.asarray(jh._sao_apply(jnp.asarray(rec), c_j, o_j, jnp.asarray(maxv))))
    # the fused wrapper's plain path (the encoder's call) against all three outputs
    fused = th.sao_search_apply(_t(src), _t(rec), _t(lam), _t(w), _t(maxv))
    for got, want in zip(fused, (r_j, c_j, o_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# payload writers


def test_binary_plane_and_occupancy_writers_match_reference():
    rng = np.random.default_rng(4)
    occ = (rng.random((96, 160)) < 0.4).astype(np.uint8)
    assert tent.encode_binary_plane(occ) == jent.encode_binary_plane(occ)
    assert tcodecs.encode_occupancy(occ, VPCCConfig()) == jcodecs.encode_occupancy(occ, JCfg())
    back = tcodecs.decode_occupancy(tcodecs.encode_occupancy(occ, VPCCConfig()), VPCCConfig())
    np.testing.assert_array_equal(back, occ)
    blocks = (rng.integers(-9, 10, (7, 64)) * (rng.random((7, 64)) < 0.2)).astype(np.int32)
    assert tent.encode_coeffs(blocks) == jent.encode_coeffs(blocks)
    inter = rng.integers(0, 2, 12).astype(np.int32)
    mv = rng.integers(-17, 18, (12, 2)).astype(np.int32)
    assert tent.encode_mvs(inter, mv) == jent.encode_mvs(inter, mv)


# ---------------------------------------------------------------------------
# the plane encoder


H, W = 128, 128


@pytest.fixture(scope="module")
def planes():
    """Source, layer reference, temporal reference and occupancy of one
    128x128 geometry-like plane."""
    rng = np.random.default_rng(7)
    base = _smooth(rng, (1, H + 16, W + 16), 255)
    src = np.ascontiguousarray(base[:, 4:4 + H, 6:6 + W])
    layer = np.clip(src + rng.integers(0, 3, src.shape) * (rng.random(src.shape) < 0.3),
                    0, 255).astype(np.int32)
    temporal = ((base[:, 7:7 + H, 9:9 + W] + base[:, 8:8 + H, 9:9 + W] + 1) // 2).astype(np.int32)
    occ = (rng.random((H // 8, W // 8)) < 0.6).repeat(8, 0).repeat(8, 1).astype(np.uint8)
    return src, layer, temporal, occ


def _jax_encode(src, ref, occ, motion):
    """The reference's plane encode and its raw syntax arrays."""
    kw = dict(occ=jnp.asarray(occ), deblock=False, weight=jnp.asarray(occ), motion=motion,
              refs=None if ref is None else jnp.asarray(ref))
    payload, rec = jh.encode_planes(jnp.asarray(src), [24], [255], **kw)
    ty, tx = jh._tile_grid(H, W, cu=jh.CU32)
    fn = jh._build_encode32(1, H, W, False, True, True, bool(motion and ref is not None), ty, tx)
    syn = fn(jnp.asarray(src), jnp.asarray([24]),
             jnp.asarray(ref) if ref is not None else jnp.zeros((1, H, W), jnp.int32),
             jnp.asarray(ref is not None), jnp.asarray([255]), jnp.asarray(occ), jnp.asarray(occ))
    return payload, np.asarray(rec), [np.asarray(a) for a in syn], (ty, tx)


def _psnr(src, rec, occ):
    m = np.broadcast_to(occ != 0, src.shape)
    return 10 * np.log10(255.0 ** 2 / np.mean((src[m].astype(float) - rec[m]) ** 2))


def _agreement(a, b):
    same = np.ones(a["s32"].shape, bool)
    for k in ("s32", "m32", "c32", "s16", "modes", "c16"):
        same &= (a[k] == b[k]).reshape(a[k].shape[0], a[k].shape[1], -1).all(-1)
    return float(same.mean())


@pytest.mark.parametrize("kind", ["intra", "inter_layer", "motion"])
def test_encode_planes_cross_decodes_and_matches_reference_rd(planes, kind):
    src, layer, temporal, occ = planes
    ref = {"intra": None, "inter_layer": layer, "motion": temporal}[kind]
    motion = kind == "motion"
    pay_j, rec_j, syn_j, (ty, tx) = _jax_encode(src, ref, occ, motion)
    pay_t, rec_t = th.encode_planes(_t(src), [24], [255], refs=None if ref is None else _t(ref),
                                    occ=_t(occ), deblock=False, weight=_t(occ), motion=motion)
    rec_t = rec_t.numpy()
    # cross-decode: both decoders give exactly the port encoder's planes
    np.testing.assert_array_equal(
        np.asarray(jh.decode_planes(pay_t, refs=None if ref is None else jnp.asarray(ref))), rec_t)
    np.testing.assert_array_equal(
        th.decode_planes(pay_t, refs=None if ref is None else _t(ref), device="cpu").numpy(), rec_t)
    # the same syntax assembles to the same bytes
    s32, m32, c32, s16, modes, c16, _, mvs, sao_cls, sao_off = syn_j
    assert th.assemble_payload32(H, W, 1, [24], [255], ref is not None, False, motion, ty, tx,
                                 s32, m32, c32, s16, modes, c16, mvs, sao_cls, sao_off) == pay_j
    # RD against the reference, and the CU syntax agreement
    agree = _agreement(th.parse_planes32(pay_t), th.parse_planes32(pay_j))
    assert agree >= AGREEMENT_FLOOR, agree
    assert abs(len(pay_t) / len(pay_j) - 1.0) <= BYTES_TOL
    assert abs(_psnr(src, rec_t, occ) - _psnr(src, rec_j, occ)) <= PSNR_TOL_DB
    if motion:
        assert (th.parse_planes32(pay_t)["mv"] & 1).any()


def test_encode_planes_unsupported():
    # maxval 1024..2047 takes the two-level codec; above 2047 the reference
    # asserts (the prediction is integer-exact up to 11 bits): refused
    with pytest.raises(ValueError, match="above 2047"):
        th.encode_planes(torch.zeros((1, 64, 64), dtype=torch.int32), [24], [4095])
    # geometryQP <= 4 is no longer refused: the plane is coded losslessly
    cfg = VPCCConfig()
    cfg.geometryQP = 4
    enc = tcodecs.GeometrySubstreamEncoder(cfg, torch.device("cpu"))
    plane = np.random.default_rng(1).integers(0, 256, (64, 64)).astype(np.uint16)
    payload, dec = enc.encode(plane)
    assert payload[0] == v3c.CODEC_LOSSLESS_ZLIB
    np.testing.assert_array_equal(dec.numpy(), plane)
    np.testing.assert_array_equal(
        tcodecs.GeometrySubstreamDecoder(cfg, torch.device("cpu")).decode(payload), plane)


def test_rdo_tie_crop_matches_reference():
    """A 64x256 crop of the bench GOF's first D0 plane (CTC r3, JAX
    partitions; its push-pull-filled samples and RD weights,
    vpcc_tpu_torch/data/rdo_tie_crop.npy) where two angular modes of CU
    (1, 6) cost the same unless the distortion sum follows XLA's reduce
    order and the cost contracts the rate product: the port must choose
    JAX's mode 33, and the payload must be JAX's byte for byte."""
    from pathlib import Path

    crop = np.load(Path(th.__file__).resolve().parents[1] / "data" / "rdo_tie_crop.npy")
    plane, weight = crop[:1].astype(np.int32), crop[1].astype(np.int32)
    want, _ = jh.encode_planes(plane, [24], [255], deblock=False, weight=weight)
    got, _ = th.encode_planes(_t(plane), [24], [255], deblock=False, weight=_t(weight))
    assert th.parse_planes32(want)["m32"][0, 1 * 8 + 6] == 33
    assert got == want
