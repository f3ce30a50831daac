"""PyTorch port vs JAX reference: the attribute images (paint, push-pull
fill, group dilation, gather: the plain versions of kernels P and L), the
deblocking filter (kernel O's plain version) and the RGB attribute codec
`encode_rgb`.

The same numpy inputs, made from a seed, go through the JAX functions (XLA
on the CPU) and the port's (torch on the CPU).  Everything here is integer
or reproduces XLA's float order, so every comparison is exact; the codec's
payloads must be byte-identical and decode, with both packages' decoders,
to the port encoder's reconstruction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu import pipeline as jpipeline
from vpcc_tpu.ops import padding as jpadding
from vpcc_tpu.video import hevc as jh
from vpcc_tpu_torch import pipeline
from vpcc_tpu_torch.ops import padding
from vpcc_tpu_torch.video import hevc as th

H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: with several test workers on the machine,
    intra-op threads only contend (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def points():
    """Points on distinct (pixel, layer) slots of an H x W atlas: layer 0 on
    60 % of the pixels, layer 1 on half of those, tag-2 rows that share a
    layer-0 pixel (they never paint), colors partly outside 0..255 (paint
    clamps); the atlas occupancy is the layer-0 pixels."""
    rng = np.random.default_rng(21)
    pixels = rng.permutation(H * W)[: int(0.6 * H * W)]
    l1 = pixels[: len(pixels) // 2]
    l2 = pixels[len(pixels) // 2: len(pixels) // 2 + 200]
    flat = np.concatenate([pixels, l1, l2])
    layer = np.concatenate([np.zeros(len(pixels)), np.ones(len(l1)), np.full(len(l2), 2)])
    order = rng.permutation(len(flat))
    flat, layer = flat[order], layer[order].astype(np.int32)
    pix = np.stack([flat % W, flat // W], 1).astype(np.int32)
    col = rng.integers(-20, 276, (len(flat), 3)).astype(np.int32)
    occ = np.zeros(H * W, np.uint8)
    occ[pixels] = 1
    return pix, layer, col, occ.reshape(H, W)


def test_paint_fill_dilate_gather_match_reference(points):
    pix, layer, col, occ = points
    valid = np.ones(len(col), bool)
    j0, j1 = jpipeline.paint_attribute(jnp.asarray(pix), jnp.asarray(layer),
                                       jnp.asarray(valid), jnp.asarray(col), H, W)
    planes = pipeline.paint_attribute(torch.as_tensor(pix), torch.as_tensor(layer),
                                      torch.as_tensor(col), H, W)
    np.testing.assert_array_equal(planes[0].permute(1, 2, 0).numpy(), np.asarray(j0))
    np.testing.assert_array_equal(planes[1].permute(1, 2, 0).numpy(), np.asarray(j1))
    occ_t = torch.as_tensor(occ)
    filled = padding.fill_rgb(planes, occ_t)
    f0 = jpadding.fill_rgb(j0, jnp.asarray(occ), 1)
    f1 = jpadding.fill_rgb(j1, jnp.asarray(occ), 1)
    np.testing.assert_array_equal(filled[0].permute(1, 2, 0).numpy(), np.asarray(f0))
    np.testing.assert_array_equal(filled[1].permute(1, 2, 0).numpy(), np.asarray(f1))
    g0, g1 = jpadding.group_dilate(f0, f1, jnp.asarray(occ))
    t0, t1 = pipeline.group_dilate(filled, occ_t)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(g0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(g1))
    a0, a1 = np.asarray(g0).astype(np.uint8), np.asarray(g1).astype(np.uint8)
    want = jpipeline.gather_decoded_colors(jnp.asarray(pix), jnp.asarray(layer),
                                           jnp.asarray(a0), jnp.asarray(a1))
    got = pipeline.gather_decoded_colors(torch.as_tensor(pix), torch.as_tensor(layer),
                                         torch.as_tensor(a0), torch.as_tensor(a1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", [1, 3])
def test_deblock_matches_reference(P):
    rng = np.random.default_rng(P)
    rec = rng.integers(0, 256, (P, 48, 72)).astype(np.int32)
    rec[:, :, 30:] //= 4      # flat regions: small steps get filtered
    qps = np.array([22, 37, 51][:P], np.int32)
    maxv = np.full(P, 255, np.int32)
    want = np.asarray(jh._deblock(jnp.asarray(rec), jnp.asarray(qps), jnp.asarray(maxv)))
    got = th.deblock_planes(torch.as_tensor(rec), torch.as_tensor(qps), torch.as_tensor(maxv))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != rec).any()


def _image(seed: int, shift: int = 0):
    """A smooth 64 x 64 RGB picture with texture (gradients, a disc, noise),
    optionally shifted right by `shift` pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64 + shift]
    img = np.stack([2 * xx + yy, 180 - yy + xx // 2, 90 + 40 * np.sin(xx / 7.0)], -1)
    img = img + 60 * (((yy - 30) ** 2 + (xx - 34) ** 2) < 200)[..., None]
    img = img + rng.integers(-6, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.int32)[:, shift: shift + 64]


def test_encode_rgb_matches_reference():
    """Intra, inter-layer (T1 from rgb_refs of the decoded T0) and
    motion-searched (T0 of the next frame from the decoded planes): payloads
    byte-identical, both decoders give the port's reconstruction."""
    rng = np.random.default_rng(5)
    weight = (rng.random((64, 64)) < 0.7).astype(np.int32)
    a0, a1, b0 = _image(1), _image(2), _image(3, shift=3)
    cases = []
    jp, jrgb, jrefs = jh.encode_rgb(jnp.asarray(a0), 32, weight=jnp.asarray(weight))
    tp, trgb, trefs = th.encode_rgb(torch.as_tensor(a0), 32, weight=weight)
    cases.append((jp, tp, trgb, None, None))
    lj, lt = jh.rgb_refs(jrgb), th.rgb_refs(trgb)
    jp1, _, _ = jh.encode_rgb(jnp.asarray(a1), 32, refs=lj, weight=jnp.asarray(weight))
    tp1, trgb1, _ = th.encode_rgb(torch.as_tensor(a1), 32, refs=lt, weight=weight)
    cases.append((jp1, tp1, trgb1, lj, lt))
    jp2, _, _ = jh.encode_rgb(jnp.asarray(b0), 33, refs=jrefs, weight=jnp.asarray(weight),
                              motion=True)
    tp2, trgb2, _ = th.encode_rgb(torch.as_tensor(b0), 33, refs=trefs, weight=weight,
                                  motion=True)
    cases.append((jp2, tp2, trgb2, jrefs, trefs))
    for k, (jpay, tpay, rgb, jref, tref) in enumerate(cases):
        assert tpay == jpay, k
        jdec, _ = jh.decode_rgb(tpay, refs=jref)
        tdec, _ = th.decode_rgb(tpay, refs=tref, device="cpu")
        np.testing.assert_array_equal(np.asarray(jdec), rgb.numpy())
        np.testing.assert_array_equal(tdec.numpy(), rgb.numpy())
    assert th.parse_planes32(tp2[8:8 + int.from_bytes(tp2[:4], "little")])["flags"] & th.FLAG_MC
