"""PyTorch port vs JAX reference: the two-level (16/8) video codec, which
codes planes whose samples pass 10 bits (maxval 1024..2047, geometry at
geometryNominal2dBitdepth=11), and every plane when `ENABLE_CU32` is off.

Same numpy inputs, made from seeds, go through the JAX package (CPU) and
the port's plain versions (CPU):
* the two-level CU syntax coders (`entropy.encode_hevc_plane` /
  `decode_hevc_plane`): the same bytes, and a round trip;
* `encode_planes` at maxval 2047 on random-walk planes spanning 0..2047,
  intra, inter-layer and motion-searched, deblocked or not (kernel I's
  two-level entry and kernel A's, through their plain versions): the
  payload byte-identical to the JAX encoder's, decoded by both decoders to
  the port's reconstruction, and the JAX payload by the port's decoder to
  JAX's reconstruction;
* the two-level payload's flags (FLAG_SAO16 set, FLAG_CU32 clear), a crop
  of real 11-bit content whose decisions only the right float order of the
  RD sums reproduces, and the reference's `ENABLE_CU32 = False` switch on
  8-bit content;
* a 2-frame 6-bit GOF at geometryNominal2dBitdepth=11 and lossy geometry
  (QP 24), the port driven by the JAX encoder's partitions: the stream
  byte-identical, its decode equal to the encoder's reconstruction;
* `apps/video_codec.py` on two 11-bit depth frames: the JAX app's bytes,
  and its decode.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpcc_tpu.apps import video_codec as japp
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import entropy as jent, hevc as jh
from vpcc_tpu_torch.apps import video_codec as tapp
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData
from vpcc_tpu_torch.video import entropy as tent, hevc as th

MAXVAL = 2047


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(seed, shape, maxval=MAXVAL, step=40):
    """Random-walk planes along the rows, clipped to 0..maxval (they span
    the whole range)."""
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-step, step + 1, shape), axis=-1) + maxval // 2,
                   0, maxval).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_entropy_two_level_matches_reference():
    """The two-level CU syntax coders on a 3x5 CU grid with split and whole
    CUs, inter modes and sparse levels: the port's bytes are the JAX
    package's, and both readers give the syntax back."""
    rng = np.random.default_rng(11)
    nby, nbx = 3, 5
    nb = nby * nbx
    split = (rng.random(nb) < 0.5).astype(np.int32)
    m16 = rng.integers(0, 36, nb).astype(np.int32)
    m8 = rng.integers(0, 36, (nb, 4)).astype(np.int32)
    c16 = (rng.integers(-300, 301, (nb, 256)) * (rng.random((nb, 256)) < 0.1)).astype(np.int32)
    c8 = (rng.integers(-40, 41, (nb, 4, 64)) * (rng.random((nb, 4, 64)) < 0.2)).astype(np.int32)
    want = jent.encode_hevc_plane(nby, nbx, split, m16, c16, m8, c8)
    got = tent.encode_hevc_plane(nby, nbx, split, m16, c16, m8, c8)
    assert got == want
    for dec in (tent.decode_hevc_plane(got, nby, nbx), jent.decode_hevc_plane(got, nby, nbx)):
        s_, a_, b_, c_, d_ = (np.asarray(x) for x in dec)
        np.testing.assert_array_equal(s_, split)
        whole, spl = split == 0, split != 0
        np.testing.assert_array_equal(a_[whole], m16[whole])
        np.testing.assert_array_equal(b_[whole], c16[whole])
        np.testing.assert_array_equal(c_[spl], m8[spl])
        np.testing.assert_array_equal(d_[spl], c8[spl])


def _both(src, qp, ref=None, motion=False, deblock=False, occ=None, maxval=MAXVAL):
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else _t(a)
    pay_j, rec_j = jh.encode_planes(src, [qp] * src.shape[0], [maxval] * src.shape[0],
                                    refs=j(ref), occ=j(occ), weight=j(occ), deblock=deblock,
                                    motion=motion)
    pay_t, rec_t = th.encode_planes(_t(src), [qp] * src.shape[0], [maxval] * src.shape[0],
                                    refs=t(ref), occ=t(occ), weight=t(occ), deblock=deblock,
                                    motion=motion)
    return pay_j, np.asarray(rec_j), pay_t, rec_t.numpy()


@pytest.mark.parametrize("kind,deblock", [("intra", False), ("inter_layer", True),
                                          ("motion", False), ("motion", True)])
def test_encode_planes_two_level_matches_reference(kind, deblock):
    """64x96 planes at maxval 2047 spanning 0..2047; the inter-layer
    reference is the source plus noise, the motion reference the source
    shifted by (3, -2); the RD weights and background fill from a random
    occupancy.  The port's payload is JAX's byte for byte, and decodes in
    both decoders to the port's reconstruction (= JAX's)."""
    src = _walk(1, (1, 64, 96))
    occ = (np.random.default_rng(2).random((64, 96)) < 0.7).astype(np.uint8)
    ref = None
    if kind == "inter_layer":
        noise = np.random.default_rng(3).integers(-30, 31, src.shape)
        ref = np.clip(src + noise, 0, MAXVAL).astype(np.int32)
    elif kind == "motion":
        ref = np.roll(src, (3, -2), (1, 2))
    pay_j, rec_j, pay_t, rec_t = _both(src, 30, ref, kind == "motion", deblock, occ)
    assert pay_t == pay_j
    np.testing.assert_array_equal(rec_t, rec_j)
    flags = pay_t[5]
    assert flags & th.FLAG_SAO16 and not flags & th.FLAG_CU32
    assert bool(flags & th.FLAG_DEBLOCK) == deblock
    assert bool(flags & th.FLAG_MC) == (kind == "motion")
    refs_j = None if ref is None else jnp.asarray(ref)
    np.testing.assert_array_equal(np.asarray(jh.decode_planes(pay_t, refs=refs_j)), rec_t)
    np.testing.assert_array_equal(
        th.decode_planes(pay_t, refs=None if ref is None else _t(ref), device="cpu").numpy(),
        rec_t)
    if kind == "motion":
        assert (th.parse_planes32(pay_t)["mv"] != 0).any()


def test_two_level_flags_and_sao():
    """The counterpart of tests/test_hevc.py::test_two_level_sao_parity_and_gain:
    a 96x96 random-walk plane at maxval 2047 (QP 30) gives a payload with
    FLAG_SAO16 set and FLAG_CU32 clear, JAX's bytes, whose decode is the
    encoder's reconstruction; and at QP 4 the 16x16 DC levels stay inside
    the int16 syntax as JAX's do."""
    rng = np.random.default_rng(3)
    img = np.clip(np.cumsum(rng.integers(-40, 41, (96, 96)), axis=1), 0, 2047).astype(np.int32)
    for qp in (30, 4):
        pay_j, rec_j, pay_t, rec_t = _both(img[None], qp)
        assert pay_t == pay_j
        np.testing.assert_array_equal(rec_t, rec_j)
        assert pay_t[5] & th.FLAG_SAO16 and not pay_t[5] & th.FLAG_CU32
        np.testing.assert_array_equal(th.decode_planes(pay_t, device="cpu").numpy(), rec_t)
    syn = th.parse_planes32(pay_t)
    assert np.abs(syn["coeffs"].astype(np.int64)).max() > 1000


def test_rdo_tie_crop16_matches_reference():
    """A 256x256 crop of a D0 plane of the vox11 GOF at 11-bit geometry
    (its push-pull-filled samples and RD weights,
    vpcc_tpu_torch/data/rdo_tie_crop16.npz, made by
    tests/torch_make_rdo_tie_crop16.py) whose 16x16 and 8x8 decisions come
    out as the JAX encoder's only when the RD sums follow the port's order
    (the maker checked that the 32x32 row order, a sequential sum and a
    pairwise tree give other bytes): the payloads must be equal."""
    from pathlib import Path

    z = np.load(Path(th.__file__).resolve().parents[1] / "data" / "rdo_tie_crop16.npz")
    plane, weight, qp = z["plane"].astype(np.int32)[None], z["weight"].astype(np.int32), int(z["qp"])
    want, rec_j = jh.encode_planes(plane, [qp], [MAXVAL], deblock=False, weight=weight)
    got, rec_t = th.encode_planes(_t(plane), [qp], [MAXVAL], deblock=False, weight=_t(weight))
    assert got == want
    np.testing.assert_array_equal(rec_t.numpy(), np.asarray(rec_j))


def test_enable_cu32_off_matches_reference():
    """The counterpart of tests/test_hevc.py::test_cu32_beats_two_level_on_smooth:
    with ENABLE_CU32 off in both packages an 8-bit smooth plane takes the
    two-level codec, and the port's payload is JAX's byte for byte (with it
    on, the three-level one, smaller)."""
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = np.clip(120 + 40 * np.sin(yy / 90) + 30 * np.cos(xx / 110), 0, 255).astype(np.int32)
    old_j, old_t = jh.ENABLE_CU32, th.ENABLE_CU32
    try:
        jh.ENABLE_CU32 = th.ENABLE_CU32 = False
        pay_j, rec_j, pay_t, rec_t = _both(smooth[None], 28, maxval=255)
    finally:
        jh.ENABLE_CU32, th.ENABLE_CU32 = old_j, old_t
    assert pay_t == pay_j
    np.testing.assert_array_equal(rec_t, rec_j)
    assert not pay_t[5] & th.FLAG_CU32
    np.testing.assert_array_equal(th.decode_planes(pay_t, device="cpu").numpy(), rec_t)
    p32, _ = th.encode_planes(_t(smooth[None]), [28], [255])
    assert p32[5] & th.FLAG_CU32 and len(p32) < len(pay_t)


# the 2-frame GOF: 6-bit person clouds, 11-bit geometry planes coded lossy
# at the CTC r3 geometry QP; the attribute video lossless (QP 4), which keeps
# the plain 32/16/8 RDO of the colour planes, held elsewhere, out of the file
# time
GOF = dict(geometry3dCoordinatesBitdepth=6, resolution=63, minimumImageWidth=64,
           minimumImageHeight=64, gridBasedSegmentation=1, occupancyPrecision=2,
           iterationCountRefineSegmentation=10, geometryNominal2dBitdepth=11,
           geometryQP=24, attributeQP=4)


class DrivenEncoder(Encoder):
    """The port's encoder with each frame's voxel partition replaced, in call
    order, by the JAX encoder's."""

    def __init__(self, cfg, parts, **kw):
        super().__init__(cfg, **kw)
        self._parts = list(parts)

    def segment_dispatch(self, pc_host):
        seg = super().segment_dispatch(pc_host)
        p = self._parts.pop(0)
        return Encoder.with_partition(seg, torch.as_tensor(
            p[:seg.nn_idx.shape[0]].astype(np.int32)))


def _cfg(cls, overrides):
    c = cls()
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def test_gof_at_11_bit_geometry_matches_reference():
    frames = [make_person_cloud(bits=6, n_samples=20000, seed=s) for s in (7, 8)]
    jenc = JEncoder(_cfg(JCfg, GOF))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    jstream, jrec = jenc.encode_gof(frames)
    enc = DrivenEncoder(_cfg(VPCCConfig, GOF), parts, device="cpu")
    stream, rec = enc.encode_gof([PointCloudData(f.positions, f.colors) for f in frames])
    assert not enc._parts
    # every geometry payload is two-level, and the stream is JAX's
    for e in enc.last_encoded:
        for pay in e.geometry_payloads:
            assert pay[1 + 5] & th.FLAG_SAO16 and not pay[1 + 5] & th.FLAG_CU32
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    dec = Decoder(device="cpu").decode(stream)
    assert len(dec) == len(rec) == len(jrec) == 2
    for a, b, c in zip(dec, rec, jrec):
        np.testing.assert_array_equal(np.asarray(b.positions), np.asarray(c.positions))
        np.testing.assert_array_equal(np.asarray(b.colors), np.asarray(c.colors))
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))


def test_video_codec_app_matches_reference(tmp_path):
    """`apps/video_codec.py` on two 64x64 11-bit depth frames (the second
    a shifted copy of the first, so it is motion-coded): the JAX app's
    bytes, and the port's decode equals the JAX app's."""
    f0 = _walk(5, (64, 64))
    frames = np.stack([f0, np.roll(f0, (2, 1), (0, 1))]).astype(np.uint16)
    np.save(tmp_path / "in.npy", frames)
    opts = ["--qp=24", "--geometryNominal2dBitdepth=11"]
    assert japp.main(["encode", str(tmp_path / "in.npy"), str(tmp_path / "j.bin")] + opts) == 0
    assert tapp.main(["encode", str(tmp_path / "in.npy"), str(tmp_path / "t.bin"),
                      "--device=cpu"] + opts) == 0
    data = (tmp_path / "t.bin").read_bytes()
    assert data == (tmp_path / "j.bin").read_bytes()
    assert data[4] == 0
    assert tapp.main(["decode", str(tmp_path / "t.bin"), str(tmp_path / "t.npy"),
                      "--device=cpu"] + opts) == 0
    assert japp.main(["decode", str(tmp_path / "j.bin"), str(tmp_path / "j.npy")] + opts) == 0
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == frames.shape and got.max() > 1023
    np.testing.assert_array_equal(got, want)
