"""PyTorch port vs JAX reference: high-gradient separation
(highGradientSeparation).

* `segmentation.high_gradient_aux` (kernel F's entry, its plain version on
  the CPU) is identical to the reference's at J = 6, 10 and 18, on random
  normals with crafted rows whose assigned score lies at 0.577 (+-3 float32
  ulps, where the score's float order decides `weak`) and rows on the
  bisector of two orientations (ties between alternatives).
* `separation.separate_high_gradient` returns the reference's components
  and `n_moved` and updates the partition alike, on the inputs the JAX
  encoder passes it.
* Two GOFs of one frame, encoded by `vpcc_tpu.Encoder` and by the port
  driven by the JAX encoder's partitions and point aux: "sheets", the
  two-sheet cloud of tests/test_e2e.py::
  test_surface_and_high_gradient_separation (7 bits, surface separation
  on; no group reaches minNumHighGradientPoints there, so nothing moves),
  and "person7", a 7-bit person (minNumHighGradientPoints 32, so that
  groups move in two patch rounds), both with lossless video (QP 4, which
  keeps the plain wavefront RDO out of the GOFs).  The streams are
  byte-identical and cross-decode.
* `Encoder.segment_fetch` hands out a copy of the partition: a separation
  round on the 7-bit person without grid segmentation (where the point
  partition is the device's) moves points and leaves `Segmentation.part`
  as it was.
All comparisons are exact.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.ops import segmentation as js, separation as jsep
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData as JPointCloudData
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import segmentation as ts, separation as tsep
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData

f32 = np.float32
SMALL = dict(geometry3dCoordinatesBitdepth=7, minimumImageWidth=128, minimumImageHeight=128,
             resolution=127, iterationCountRefineSegmentation=10, highGradientSeparation=1)
# name -> (overrides, cloud)
GOFS = {
    "sheets": (dict(SMALL, geometryQP=4, attributeQP=4, surfaceSeparation=1), "sheets"),
    "person7": (dict(SMALL, geometryQP=4, attributeQP=4, minNumHighGradientPoints=32),
                "person7"),
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


def _cfg(cls, overrides):
    c = cls()
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def two_sheets() -> JPointCloudData:
    """tests/test_e2e.py's two parallel sheets 3 voxels apart."""
    rng = np.random.default_rng(5)
    n = 9000
    xy = rng.integers(5, 120, (n, 2))
    z = np.where(rng.random(n) < 0.5, 60, 63)
    pos = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float64)
    col = np.where((z == 60)[:, None], [230, 40, 40], [40, 40, 230]).astype(np.uint8)
    return JPointCloudData(pos, col).remove_duplicates()


def person7() -> JPointCloudData:
    return make_person_cloud(bits=7, n_samples=30000, seed=7)


def crafted_aux_inputs(mode: int, seed: int):
    """Random normals and partitions; every second row's assigned score
    set to 0.577 +- up to 3 ulps through its largest component; every
    fourth row on the bisector of two orientations."""
    rng = np.random.default_rng(seed)
    o = js.get_orientations(mode)
    J = len(o)
    N = 3000
    n = rng.normal(size=(N, 3)).astype(f32)
    part = rng.integers(0, J, N).astype(np.int32)
    for i in range(0, N, 2):
        oj = o[part[i]]
        c = int(np.argmax(np.abs(oj)))
        rest = sum(np.float64(n[i, cc]) * oj[cc] for cc in range(3) if cc != c)
        n[i, c] = f32((np.float64(0.577) - rest) / oj[c])
        for _ in range(rng.integers(-3, 4)):
            n[i, c] = np.nextafter(n[i, c], f32(np.inf))
    for i in range(1, N, 4):
        n[i] = (o[rng.integers(0, J)] + o[rng.integers(0, J)]).astype(f32)
    return n, part, o


@pytest.mark.parametrize("mode", [0, 1, 4])
def test_high_gradient_aux_matches_reference(mode):
    n, part, o = crafted_aux_inputs(mode, seed=10 + mode)
    want = js.high_gradient_aux(jnp.asarray(n), jnp.asarray(part), jnp.asarray(o))
    got = ts.high_gradient_aux(torch.as_tensor(n), torch.as_tensor(part), torch.as_tensor(o))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[1].sum()) < len(n)
    assert (got[0].numpy() != part).all()   # the assigned orientation never wins
    if mode:
        # the crafted rows decide `weak` by the score's float order: an
        # unfused sum disagrees with the reference on some of them
        s = [((n[i, 0] * o[p, 0] + n[i, 1] * o[p, 1]) + n[i, 2] * o[p, 2])
             for i, p in enumerate(part)]
        assert ((np.array(s, f32) <= f32(0.577)) != np.asarray(want[1])).any()


def _record_jax(overrides, frames):
    """The JAX encoder's GOF with every separation call's inputs and
    outputs, and each frame's partitions and point aux."""
    jenc = JEncoder(_cfg(JCfg, overrides))
    calls, segs = [], []
    real_sep = jsep.separate_high_gradient

    def sep_spy(comps, positions, partition, alt, weak, cfg):
        before = (copy.deepcopy(comps), positions.copy(), partition.copy(), alt.copy(),
                  weak.copy())
        out = real_sep(comps, positions, partition, alt, weak, cfg)
        calls.append((before, (copy.deepcopy(out[0]), out[1], partition.copy())))
        return out

    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        segs.append((np.asarray(out[1][0]), out[1][5]))
        return out

    jenc.segment_fetch = record
    jsep.separate_high_gradient = sep_spy
    try:
        jstream, jrec = jenc.encode_gof(frames)
    finally:
        jsep.separate_high_gradient = real_sep
    return jenc, jstream, jrec, calls, segs


@pytest.fixture(scope="module", params=list(GOFS))
def gof(request):
    overrides, cloud = GOFS[request.param]
    src = two_sheets() if cloud == "sheets" else person7()
    return (request.param, src, *_record_jax(overrides, [src]))


def test_separate_high_gradient_matches_reference(gof):
    name, calls = gof[0], gof[5]
    assert calls
    assert any(out[1] > 0 for _, out in calls) == (name == "person7")
    cfg = _cfg(VPCCConfig, GOFS[name][0])
    for (comps, positions, partition, alt, weak), (w_comps, w_moved, w_part) in calls:
        part = partition.copy()
        got, moved = tsep.separate_high_gradient(comps, positions, part, alt, weak, cfg)
        assert moved == w_moved
        assert len(got) == len(w_comps)
        for a, b in zip(got, w_comps):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(part, w_part)


def test_stream_equals_reference(gof):
    """Driven by the JAX partitions and the JAX point aux (alt, weak)."""
    name, src, jenc, jstream, jrec, _, segs = gof
    enc = Encoder(_cfg(VPCCConfig, GOFS[name][0]), device="cpu")
    frame = PointCloudData(src.positions, src.colors)
    s = enc.segment_dispatch(frame)
    part, hg = segs[0]
    s = Encoder.with_partition(s, torch.as_tensor(part[:s.nn_idx.shape[0]].astype(np.int32)))
    s = dataclasses.replace(s, hg=(torch.as_tensor(hg[0].astype(np.int32)),
                                   torch.as_tensor(hg[1].astype(bool))))
    stream, rec = enc.encode_gof([frame], segs=[s])
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    for a, b in zip(rec, jrec):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))
    for dec, want in ((Decoder(device="cpu").decode(jstream), jrec),
                      (JDecoder().decode(stream), rec)):
        for a, b in zip(dec, want):
            np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
            np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))


def test_segment_fetch_partition_is_a_copy():
    """Without grid segmentation the point partition is the device's voxel
    partition; the separation must rewrite only the fetched copy."""
    ov = dict(SMALL, geometryQP=4, attributeQP=4, gridBasedSegmentation=0)
    enc = Encoder(_cfg(VPCCConfig, ov), device="cpu")
    src = person7()
    seg = enc.segment_dispatch(PointCloudData(src.positions, src.colors))
    assert seg.point_vox is None and seg.part_pt is seg.part
    before = seg.part.clone()
    part, g, _ = enc.segment_fetch(seg)
    moved = []
    real = tsep.separate_high_gradient

    def spy(*a, **kw):
        out = real(*a, **kw)
        moved.append(out[1])
        return out

    tsep.separate_high_gradient = spy
    try:
        enc.generate_patches(PointCloudData(src.positions, src.colors), part, g)
    finally:
        tsep.separate_high_gradient = real
    assert sum(moved) > 0 and not np.array_equal(part, before.numpy())
    assert torch.equal(seg.part, before)
