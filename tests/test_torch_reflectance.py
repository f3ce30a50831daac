"""PyTorch port vs JAX reference: the attribute options through the whole
codec: the reflectance attribute and attributeBGFill 0 / 2.

The stages, on the CPU (the plain versions of kernels E, M and P):
`recolor.transfer_reflectance`, `pipeline.paint_scalar` and
`gather_decoded_scalar` against the JAX functions, and the lossy and
lossless reflectance payloads of `codecs.encode_reflectance` byte for byte.

One-frame GOFs of a 6-bit synthetic person (one frame keeps the module's
JAX compiles near a minute; the reflectance is coded intra in every frame),
encoded by `vpcc_tpu.Encoder` and by the port (driven by the JAX encoder's
partitions) under four configurations: "refl" (reflectance, lossy),
"refl_lossless" (the CTC's lossless conditions with raw points and
reflectance), "bgfill0" (sparse dilation) and "bgfill2" (harmonic fill).
Each stream must be byte-identical to the JAX encoder's with equal
`last_stream_stats`, and cross-decode both ways to the other encoder's
reconstruction, positions, colors and reflectances alike.  All
comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu import pipeline as jpipe
from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.ops import recolor as jrecolor
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData as JPointCloudData
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import codecs as jcodecs
from vpcc_tpu_torch import pipeline as tpipe
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import recolor as trecolor
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import codecs as tcodecs

BITS = 6
BASE = dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
            minimumImageWidth=64, minimumImageHeight=64, gridBasedSegmentation=1,
            occupancyPrecision=2, iterationCountRefineSegmentation=4)
LOSSLESS = dict(BASE, geometryQP=-12, attributeQP=0, occupancyPrecision=1, rawPointsPatch=1,
                maxAllowedDist2RawPointsSelection=0, enhancedOccupancyMapCode=1,
                useRawPointsSeparateVideo=1, flagGeometrySmoothing=0, gridSmoothing=0,
                flagColorPreSmoothing=0)
# name -> (overrides, frames, with reflectance)
CONFIGS = {
    "refl": (BASE, 1, True),
    "refl_lossless": (LOSSLESS, 1, True),
    "bgfill0": (dict(BASE, attributeBGFill=0), 1, False),
    "bgfill2": (dict(BASE, attributeBGFill=2), 1, False),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reflectance_field(positions: np.ndarray, seed: int) -> np.ndarray:
    """The seeded 16-bit reflectance of tests/torch_make_attr_options_reference.py."""
    rng = np.random.default_rng(seed)
    p = np.asarray(positions, np.int64)
    r = 21 * (p[:, 0] + p[:, 1] + p[:, 2]) + rng.integers(0, 1024, p.shape[0])
    return np.clip(r, 0, 65535).astype(np.uint16)


def _frames(n: int, with_refl: bool):
    out = []
    for s in (7, 8)[:n]:
        c = make_person_cloud(bits=BITS, n_samples=6000, seed=s)
        out.append(JPointCloudData(c.positions, c.colors, reflectances=(
            reflectance_field(c.positions, s) if with_refl else None)))
    return out


def _cfg(cls, overrides):
    c = cls()
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def _encode_both(overrides, frames):
    jenc = JEncoder(_cfg(JCfg, overrides))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    jstream, jrec = jenc.encode_gof(frames)
    enc = Encoder(_cfg(VPCCConfig, overrides), device="cpu")
    tframes = [PointCloudData(f.positions, f.colors, reflectances=f.reflectances)
               for f in frames]
    segs = []
    for f, p in zip(tframes, parts):
        s = enc.segment_dispatch(f)
        segs.append(Encoder.with_partition(s, torch.as_tensor(
            p[:s.nn_idx.shape[0]].astype(np.int32))))
    stream, rec = enc.encode_gof(tframes, segs=segs)
    return jenc, jstream, jrec, enc, stream, rec


@pytest.fixture(scope="module", params=list(CONFIGS))
def gof(request):
    overrides, n, with_refl = CONFIGS[request.param]
    return (request.param, *_encode_both(overrides, _frames(n, with_refl)))


def _same(got, want, with_refl: bool):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))
        if with_refl:
            assert a.reflectances is not None and b.reflectances is not None
            np.testing.assert_array_equal(a.reflectances, b.reflectances)
        else:
            assert a.reflectances is None and b.reflectances is None


def test_stream_equals_reference(gof):
    name, jenc, jstream, jrec, enc, stream, rec = gof
    with_refl = CONFIGS[name][2]
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    _same(rec, jrec, with_refl)
    maps = [v3c.VideoSubstream.read(BitReader(p)).map_index
            for u, p in v3c.read_sample_stream(stream) if u == v3c.V3C_AVD]
    assert (tcodecs.REFL_MAP_INDEX in maps) == with_refl
    if with_refl and name == "refl_lossless":
        # the raw points' reflectance is zero-filled (ROADMAP F3)
        raw = enc.last_encoded[0].raw_positions
        assert raw is not None and len(raw) and (rec[0].reflectances[-len(raw):] == 0).all()


def test_port_decoder_decodes_reference_stream(gof):
    name, _, jstream, jrec = gof[:4]
    _same(Decoder(device="cpu").decode(jstream), jrec, CONFIGS[name][2])


def test_reference_decoder_decodes_port_stream(gof):
    name, stream, rec = gof[0], gof[5], gof[6]
    _same(JDecoder().decode(stream), rec, CONFIGS[name][2])


def _recon_rows(seed: int, n: int):
    """Source points of a 6-bit cloud and targets: the sources moved by
    -1..1 per axis (some exact twins), plus far rows with no source in
    their cell window (they read source row 0)."""
    rng = np.random.default_rng(seed)
    c = make_person_cloud(bits=BITS, n_samples=n, seed=seed)
    src = c.positions.astype(np.int32)
    tgt = np.clip(src[rng.permutation(len(src))] + rng.integers(-1, 2, src.shape),
                  0, (1 << BITS) - 1).astype(np.int32)
    far = np.array([[0, 0, 0], [63, 63, 63], [0, 63, 0]], np.int32)
    return src, reflectance_field(src, seed), np.concatenate([tgt, far])


def test_transfer_reflectance_matches_reference():
    src, refl, tgt = _recon_rows(3, 3000)
    cap_s, cap_t = 4096, 4096
    sp = np.full((cap_s, 3), 1 << 20, np.int32)
    sp[:len(src)] = src
    sr = np.zeros(cap_s, np.int32)
    sr[:len(src)] = refl
    tp = np.full((cap_t, 3), 1 << 20, np.int32)
    tp[:len(tgt)] = tgt
    want = np.asarray(jrecolor.transfer_reflectance(
        jnp.asarray(sp), jnp.asarray(sr), jnp.asarray(len(src)), jnp.asarray(tp),
        jnp.asarray(len(tgt)), grid_bits=BITS))[:len(tgt)]
    got = trecolor.transfer_reflectance(torch.as_tensor(src),
                                        torch.as_tensor(refl.astype(np.int32)),
                                        torch.as_tensor(tgt), grid_bits=BITS)
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (src[:, None] == tgt[None, :200]).all(-1).any(0)
    assert exact.any() and not exact.all()
    assert (got.numpy()[-3:] == refl[0]).any()   # a far row read source row 0


def test_transfer_reflectance_above_10_bits_raises():
    with pytest.raises(NotImplementedError, match="bits <= 10"):
        trecolor.transfer_reflectance(torch.zeros((4, 3), dtype=torch.int32),
                                      torch.zeros(4, dtype=torch.int32),
                                      torch.zeros((4, 3), dtype=torch.int32), grid_bits=11)
    cfg = VPCCConfig()
    cfg.geometry3dCoordinatesBitdepth = 11
    frame = PointCloudData(np.zeros((4, 3), np.int32), np.zeros((4, 3), np.uint8),
                           reflectances=np.zeros(4, np.uint16))
    with pytest.raises(NotImplementedError, match="reflectance attribute above 10-bit"):
        Encoder(cfg, device="cpu").encode_gof([frame])


def _paint_inputs(seed: int):
    rng = np.random.default_rng(seed)
    h, w, n = 48, 64, 4000
    flat = rng.integers(0, h * w, n)          # duplicates: the last row wins
    pix = np.stack([flat % w, flat // w], 1).astype(np.int32)
    layer = rng.integers(0, 3, n).astype(np.int32)   # tag 2 never paints
    val = rng.integers(0, 65536, n).astype(np.int32)
    return pix, layer, val, h, w


def test_paint_and_gather_scalar_match_reference():
    pix, layer, val, h, w = _paint_inputs(5)
    valid = jnp.ones(len(val), bool)
    j0, j1 = jpipe.paint_scalar(jnp.asarray(pix), jnp.asarray(layer), valid, jnp.asarray(val),
                                h, w)
    got = tpipe.paint_scalar(torch.as_tensor(pix), torch.as_tensor(layer),
                             torch.as_tensor(val), h, w)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j0))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(j1))
    assert int(got.max()) > 255                  # not clamped
    want = jpipe.gather_decoded_scalar(jnp.asarray(pix), jnp.asarray(layer), j0, j1)
    g = tpipe.gather_decoded_scalar(torch.as_tensor(pix), torch.as_tensor(layer), got[0],
                                    got[1])
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("attribute_qp", [32, 0])
def test_reflectance_payload_matches_reference(attribute_qp):
    """encode_reflectance: lossy (10-bit planes, wavefront codec) and
    lossless (zlib): the payload byte for byte and the decoded planes; and
    each package's decode_reflectance of it."""
    pix, layer, val, h, w = _paint_inputs(6)
    rng = np.random.default_rng(7)
    occ = (rng.random((h, w)) < 0.6).astype(np.uint8)
    r = tpipe.paint_scalar(torch.as_tensor(pix), torch.as_tensor(layer),
                           torch.as_tensor(val), h, w)
    jcfg, tcfg = JCfg(), VPCCConfig()
    jcfg.attributeQP = tcfg.attributeQP = attribute_qp
    jpay, j0, j1 = jcodecs.encode_reflectance(jnp.asarray(r[0].numpy()),
                                              jnp.asarray(r[1].numpy()), jnp.asarray(occ),
                                              jcfg, qp_offset=2)
    pay, d0, d1 = tcodecs.encode_reflectance(r[0], r[1], occ, tcfg, qp_offset=2)
    assert pay == jpay and pay[0] == (0 if attribute_qp <= 4 else 1)
    np.testing.assert_array_equal(d0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(j1))
    e0, e1 = tcodecs.decode_reflectance(jpay, torch.device("cpu"))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(j1))


def test_apps_carry_reflectance(tmp_path):
    """A PLY with a reflectance property through the port's encode and
    decode apps (lossless video, the quick path on the CPU): the
    reconstruction and the decoded PLY carry it, equal."""
    from vpcc_tpu_torch.apps import decode as t_decode, encode as t_encode
    from vpcc_tpu_torch.utils import ply as tply

    c = make_person_cloud(bits=BITS, n_samples=4000, seed=9)
    tply.write_ply(tmp_path / "src_0000.ply", PointCloudData(
        c.positions, c.colors, reflectances=reflectance_field(c.positions, 9)))
    common = [f"--compressedStreamPath={tmp_path}/out.vpcc", "--device=cpu"]
    assert t_encode.main([f"--uncompressedDataPath={tmp_path}/src_%04d.ply", "--frameCount=1",
                          "--geometry3dCoordinatesBitdepth=6", "--resolution=63",
                          "--minimumImageWidth=64", "--minimumImageHeight=64",
                          "--gridBasedSegmentation=1", "--iterationCountRefineSegmentation=4",
                          "--geometryQP=-12", "--attributeQP=0",
                          f"--reconstructedDataPath={tmp_path}/rec_%04d.ply", *common]) == 0
    assert t_decode.main([f"--reconstructedDataPath={tmp_path}/dec_%04d.ply", *common]) == 0
    rec = tply.read_ply(tmp_path / "rec_0000.ply")
    dec = tply.read_ply(tmp_path / "dec_0000.ply")
    assert rec.reflectances is not None and int(rec.reflectances.max()) > 255
    np.testing.assert_array_equal(dec.positions, rec.positions)
    np.testing.assert_array_equal(dec.reflectances, rec.reflectances)
