"""PyTorch port vs JAX reference: the wavefront video decoder.

Payloads come from `vpcc_tpu.video.hevc.encode_planes` / `encode_rgb`; the
JAX decoder and the port (device="cpu", i.e. the plain PyTorch versions of
kernels A and B) must give identical int32 planes.  Inputs are made from a
seed with numpy and handed to both packages.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpcc_tpu.video import hevc as jh
from vpcc_tpu_torch import carry
from vpcc_tpu_torch.video import color as tcolor
from vpcc_tpu_torch.video import hevc as th

CPU = torch.device("cpu")


def _planes(P, H, W, maxval, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (np.sin(yy / 7.0) + np.cos(xx / 5.0)) * maxval / 4 + maxval / 2
    noise = rng.normal(0, maxval / 20, (P, H, W))
    return np.clip(base[None] + noise, 0, maxval).astype(np.int32)


def _port_decode(payload, refs=None):
    r = None if refs is None else torch.as_tensor(np.array(refs))
    return th.decode_planes(payload, refs=r, device="cpu").numpy()


# (P, H, W, maxval, qp): one tile; P=2 with a 1x2 tile split; a 2x2 split
# with padding (H, W not multiples of the tile size)
SHAPES = [(1, 64, 64, 255, 30), (2, 64, 320, 1023, 24), (1, 288, 264, 255, 34)]


@pytest.mark.parametrize("P,H,W,maxval,qp", SHAPES)
def test_decode_planes_intra_inter_motion(P, H, W, maxval, qp):
    """Intra, inter-layer (co-located ref) and motion (FLAG_MC) payloads."""
    src = _planes(P, H, W, maxval, seed=H + W)
    pay, rec = jh.encode_planes(jnp.asarray(src), [qp] * P, [maxval] * P)
    np.testing.assert_array_equal(_port_decode(pay), np.asarray(jh.decode_planes(pay)))
    nxt = np.clip(np.roll(src, 3, axis=2) + 2, 0, maxval).astype(np.int32)
    for motion in (False, True):
        pay2, _ = jh.encode_planes(jnp.asarray(nxt), [qp] * P, [maxval] * P,
                                   refs=rec, motion=motion)
        flags = pay2[5]
        assert bool(flags & jh.FLAG_MC) == motion
        np.testing.assert_array_equal(
            _port_decode(pay2, refs=rec),
            np.asarray(jh.decode_planes(pay2, refs=rec)),
        )


def test_decode_rgb_and_layer_refs():
    """encode_rgb T0 intra, then T1 predicted from rgb_refs(T0): the float32
    color path (both directions) must agree exactly for T1 to decode."""
    rng = np.random.default_rng(5)
    H, W = 64, 96
    yy, xx = np.mgrid[0:H, 0:W]
    rgb0 = np.stack([(yy * 3 + xx) % 256, (xx * 2) % 256, (yy * 5) % 256], -1)
    rgb0 = np.clip(rgb0 + rng.integers(0, 20, rgb0.shape), 0, 255).astype(np.uint8)
    rgb1 = np.clip(rgb0.astype(int) + rng.integers(-6, 7, rgb0.shape), 0, 255).astype(np.uint8)
    pay0, dec0_j, _ = jh.encode_rgb(jnp.asarray(rgb0), qp=32)
    pay1, _, _ = jh.encode_rgb(jnp.asarray(rgb1), qp=32, refs=jh.rgb_refs(dec0_j))
    j0, _ = jh.decode_rgb(pay0)
    t0, _ = th.decode_rgb(pay0, device="cpu")
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    j1, _ = jh.decode_rgb(pay1, refs=jh.rgb_refs(j0))
    t1, _ = th.decode_rgb(pay1, refs=th.rgb_refs(t0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    assert th.peek_rgb_dims(pay1) == (H, W)


def test_color_conversion_float32_exact():
    """rgb_to_ycbcr over every 8-bit RGB triple of a 1/4-sampled cube and
    ycbcr_to_rgb over every integer YCbCr triple it can meet: bit-equal
    float32 / uint8 results (the reference's XLA CPU code fuses
    multiply-adds and multiplies by constant reciprocals; the port must
    round identically)."""
    from vpcc_tpu.video import color as jcolor

    g = np.arange(0, 256, 4)
    rgb = np.stack(np.meshgrid(g, g, np.arange(256), indexing="ij"), -1)
    rgb = rgb.reshape(-1, 3).astype(np.uint8)
    np.testing.assert_array_equal(
        tcolor.rgb_to_ycbcr(torch.as_tensor(rgb)).numpy(),
        np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(rgb))),
    )
    ycc = np.stack(np.meshgrid(np.arange(0, 256, 2), np.arange(256),
                               np.arange(0, 256, 3), indexing="ij"), -1)
    ycc = ycc.reshape(-1, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.ycbcr_to_rgb(torch.as_tensor(ycc)).numpy(),
        np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(ycc))),
    )


def test_rgb_planes_both_ways_exact():
    """The RGB 4:2:0 layer's two conversions (kernel Q's plain versions) on
    random images: `_int_planes_to_rgb` of random int planes and
    `rgb_refs` of a random RGB image equal the reference's."""
    rng = np.random.default_rng(21)
    y = rng.integers(0, 256, (64, 96)).astype(np.int32)
    cb, cr = (rng.integers(0, 256, (32, 48)).astype(np.int32) for _ in range(2))
    want = np.asarray(jh._int_planes_to_rgb(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    got = th._int_planes_to_rgb(*(torch.as_tensor(a) for a in (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), want)
    rgb = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    for a, b in zip(th.rgb_refs(torch.as_tensor(rgb)), jh.rgb_refs(jnp.asarray(rgb))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_rgb_to_planes_batch_matches_reference(dtype):
    """Kernel Q's batched entry (its plain version on the CPU) equals the
    reference's `_rgb_to_int_planes` of each image, stacked: y (B, H, W)
    and one chroma tensor (B, 2, H/2, W/2), from a (B, H, W, 3) tensor and
    from a list of (H, W, 3) images alike."""
    rng = np.random.default_rng(17)
    rgb = rng.integers(0, 256, (2, 18, 26, 3)).astype(dtype)
    rgb[0, :2, :2] = [[0, 0, 255], [255, 255, 255]]
    want = [[np.asarray(p) for p in jh._rgb_to_int_planes(jnp.asarray(im), None)]
            for im in rgb]
    want_y = np.stack([w[0] for w in want])
    want_c = np.stack([np.stack(w[1:]) for w in want])
    for attr in (torch.as_tensor(rgb), [torch.as_tensor(im) for im in rgb]):
        y, chroma = th.rgb_to_planes(attr)
        np.testing.assert_array_equal(y.numpy(), want_y)
        np.testing.assert_array_equal(chroma.numpy(), want_c)


def test_deblock_kernel_tc_table_text():
    """Kernel O keeps the tc table as a __constant__ array in its source
    (no upload a call): its text equals the reference's TC_TAB."""
    from vpcc_tpu.video import hevc_tables as jtab

    src = (Path(th.__file__).resolve().parents[1] / "csrc" / "deblock.cu").read_text()
    body = re.search(r"kTcTab\[54\]\s*=\s*\{([^}]*)\}", src).group(1)
    got = [int(v) for v in body.split(",") if v.strip()]
    assert got == np.asarray(jtab.TC_TAB).tolist()


@pytest.mark.parametrize("bs,maxval", [(32, 1023), (32, 255), (16, 255)])
def test_half_pel_mc_matches_reference(bs, maxval):
    """Kernel B's plain version vs `_half_planes` + `_apply_motion_half`,
    MVs seeded in +-16 half-pel units (all four phases, edge clamping)."""
    rng = np.random.default_rng(bs + maxval)
    P, H, W = 3, 96, 128
    nby, nbx = H // bs, W // bs
    ref = rng.integers(0, maxval + 1, (P, H, W)).astype(np.int32)
    mv = rng.integers(-16, 17, (P, nby * nbx, 2)).astype(np.int32)
    maxv = np.full(P, maxval, np.int32)
    want = jh._apply_motion_half(jnp.asarray(ref), jnp.asarray(mv), jh.MV_RANGE,
                                 nby, nbx, bs, jnp.asarray(maxv))
    got = th.half_pel_mc(torch.as_tensor(ref), torch.as_tensor(mv),
                         torch.as_tensor(maxv), bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs,maxval", [(16, 2047), (32, 255)])
def test_half_pel_mc_far_vectors_match_reference(bs, maxval):
    """Kernel B's plain version vs `_half_planes` + `_apply_motion_half`
    with MVs up to +-300 half-pel (150 samples, beyond the search range:
    windows wholly outside the tile collapse to edge values), with small
    MVs across every tile edge, all four phases present."""
    rng = np.random.default_rng(bs * maxval)
    P, H, W = 2, 64, 96
    nby, nbx = H // bs, W // bs
    ref = rng.integers(0, maxval + 1, (P, H, W)).astype(np.int32)
    mv = rng.integers(-300, 301, (P, nby * nbx, 2)).astype(np.int32)
    mv[:, ::3] = rng.integers(-8, 9, mv[:, ::3].shape)
    mv[0, :4] = [[1, 0], [0, 1], [1, 1], [0, 0]]
    maxv = np.full(P, maxval, np.int32)
    want = jh._apply_motion_half(jnp.asarray(ref), jnp.asarray(mv), jh.MV_RANGE,
                                 nby, nbx, bs, jnp.asarray(maxv))
    got = th.half_pel_mc_plain(torch.as_tensor(ref), torch.as_tensor(mv),
                               torch.as_tensor(maxv), bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("qp,maxval", [(30, 255), (45, 1023)])
def test_deblock_and_sao_apply(qp, maxval):
    rng = np.random.default_rng(qp)
    P, H, W = 2, 64, 96
    rec = rng.integers(0, maxval + 1, (P, H, W)).astype(np.int32)
    qps = np.full(P, qp, np.int32)
    maxv = np.full(P, maxval, np.int32)
    want = np.asarray(jh._deblock(jnp.asarray(rec), jnp.asarray(qps), jnp.asarray(maxv)))
    got = th.deblock_planes(torch.as_tensor(rec), torch.as_tensor(qps), torch.as_tensor(maxv))
    np.testing.assert_array_equal(got.numpy(), want)
    cls = rng.integers(0, 5, (P, H // 32, W // 32)).astype(np.int32)
    off = rng.integers(-7, 8, (P, H // 32, W // 32, 4)).astype(np.int32)
    want = np.asarray(jh._sao_apply(jnp.asarray(rec), jnp.asarray(cls.astype(np.int8)),
                                    jnp.asarray(off.astype(np.int8)), jnp.asarray(maxv)))
    got = th.sao_apply(torch.as_tensor(rec), torch.as_tensor(cls.astype(np.int8)),
                       torch.as_tensor(off.astype(np.int8)), torch.as_tensor(maxv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pframe_from_carried_reference_planes():
    """Both packages' substream decoders, seeded with the same numpy
    reference planes (the port's through `carry.refs_from_numpy`), decode
    one motion-compensated P-frame payload of geometry and of attributes
    identically."""
    from vpcc_tpu.utils.config import VPCCConfig as JCfg
    from vpcc_tpu.video import codecs as jcodecs
    from vpcc_tpu_torch.video import codecs as tcodecs

    H, W = 64, 96
    geo_ref = _planes(1, H, W, 255, seed=11)[0]
    nxt = np.clip(np.roll(geo_ref, 2, axis=1) + 1, 0, 255).astype(np.int32)
    pay, _ = jh.encode_planes(jnp.asarray(nxt)[None], [28], [255],
                              refs=jnp.asarray(geo_ref)[None], motion=True)
    payload = bytes([4]) + pay          # CODEC_TPU_HEVC
    jdec = jcodecs.GeometrySubstreamDecoder(JCfg())
    jdec.ref = jnp.asarray(geo_ref)
    cfg = carry.config_from_dict(dataclasses.asdict(JCfg()))
    tdec = tcodecs.GeometrySubstreamDecoder(cfg, CPU)
    tdec.ref = carry.refs_from_numpy(geo_ref, device="cpu")
    np.testing.assert_array_equal(tdec.decode(payload).numpy(),
                                  np.asarray(jdec.decode(payload)))

    rng = np.random.default_rng(12)
    yref = rng.integers(0, 256, (1, H, W)).astype(np.int32)
    cref = rng.integers(0, 256, (2, H // 2, W // 2)).astype(np.int32)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    pay, _, _ = jh.encode_rgb(jnp.asarray(rgb), qp=32,
                              refs=(jnp.asarray(yref), jnp.asarray(cref)), motion=True)
    payload = bytes([4]) + pay
    jadec = jcodecs.AttributeSubstreamDecoder(JCfg())
    jadec.refs = (jnp.asarray(yref), jnp.asarray(cref))
    tadec = tcodecs.AttributeSubstreamDecoder(cfg, CPU)
    tadec.refs = carry.refs_from_numpy((yref, cref), device="cpu")
    np.testing.assert_array_equal(tadec.decode(payload).numpy(),
                                  np.asarray(jadec.decode(payload)))
