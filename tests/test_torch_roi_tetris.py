"""PyTorch port vs JAX reference: ROI partitioning (enablePointCloudPartitioning)
and tetris packing (packingStrategy=2).

* `Encoder._roi_boxes` equals the reference's, for auto-cuts along the
  longest axes and for explicit boxes.
* ROI: the 7-bit torus of tests/test_e2e.py::test_point_cloud_partitioning_roi
  (2 x 2 chunks, raw-points patch; lossless video here), encoded by `vpcc_tpu.Encoder` and by
  the port, each chunk's segmentation driven by the JAX encoder's partitions
  for that chunk (a subclass swaps them in with `Encoder.with_partition`).
* tetris: the 2-frame sphere GOF of tests/test_e2e.py::
  test_spatial_consistency_tetris (frame 1 the same cloud shifted by one
  voxel, so that matched patches keep their place; lossless video here),
  driven by the JAX partitions.
Each stream must be byte-identical to the JAX encoder's with equal
`last_stream_stats`, and the port's decoder must decode it to the
encoder's reconstruction.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData as JPointCloudData
from vpcc_tpu.utils.synthetic import make_sphere_cloud, make_torus_cloud
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData

# tests/test_e2e.py's small_cfg: lossless video (QP 4), which keeps the
# plain wavefront RDO out of these GOFs; ROI and packing act before the video
SMALL = dict(geometry3dCoordinatesBitdepth=7, minimumImageWidth=128, minimumImageHeight=128,
             resolution=127, iterationCountRefineSegmentation=10, geometryQP=4,
             attributeQP=4)
ROI = dict(SMALL, enablePointCloudPartitioning=1, numCutsAlong1stLongestAxis=1,
           numCutsAlong2ndLongestAxis=1, rawPointsPatch=1)
TETRIS = dict(SMALL, packingStrategy=2)


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


class DrivenEncoder(Encoder):
    """The port's encoder with each segmentation's voxel partition replaced,
    in call order, by the given ones (one per frame, or per ROI chunk)."""

    def __init__(self, cfg, parts, **kw):
        super().__init__(cfg, **kw)
        self._parts = list(parts)

    def segment_dispatch(self, pc_host):
        seg = super().segment_dispatch(pc_host)
        p = self._parts.pop(0)
        return Encoder.with_partition(seg, torch.as_tensor(
            p[:seg.nn_idx.shape[0]].astype(np.int32)))


def _encode_both(overrides, frames):
    """(JAX encoder, its stream and recons, the port's encoder, stream and
    recons), the port driven by the partitions of every JAX segmentation."""
    jenc = JEncoder(_cfg(JCfg, overrides))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    jstream, jrec = jenc.encode_gof(frames)
    enc = DrivenEncoder(_cfg(VPCCConfig, overrides), parts, device="cpu")
    stream, rec = enc.encode_gof([PointCloudData(f.positions, f.colors) for f in frames])
    assert not enc._parts, "a JAX segmentation was not used"
    return jenc, jstream, jrec, enc, stream, rec


def _check(jenc, jstream, jrec, enc, stream, rec):
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    assert [len(e.patches) for e in enc.last_encoded] == \
        [len(e.patches) for e in jenc.last_encoded]
    dec = Decoder(device="cpu").decode(stream)
    assert len(dec) == len(rec) == len(jrec)
    for a, b, c in zip(dec, rec, jrec):
        np.testing.assert_array_equal(np.asarray(b.positions), np.asarray(c.positions))
        np.testing.assert_array_equal(np.asarray(b.colors), np.asarray(c.colors))
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))


@pytest.mark.parametrize("cuts", [(1, 1, 0), (2, 0, 1), (0, 0, 0), (1, 2, 3)])
def test_roi_boxes_match_reference_auto_cuts(cuts):
    src = make_torus_cloud(bits=7, n_samples=5000, seed=4)
    ov = dict(SMALL, enablePointCloudPartitioning=1, numCutsAlong1stLongestAxis=cuts[0],
              numCutsAlong2ndLongestAxis=cuts[1], numCutsAlong3rdLongestAxis=cuts[2])
    want = JEncoder(_cfg(JCfg, ov))._roi_boxes(src)
    got = Encoder(_cfg(VPCCConfig, ov), device="cpu")._roi_boxes(
        PointCloudData(src.positions, src.colors))
    assert len(got) == len(want) == (cuts[0] + 1) * (cuts[1] + 1) * (cuts[2] + 1)
    for (a0, a1), (b0, b1) in zip(got, want):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_roi_boxes_match_reference_explicit():
    src = make_torus_cloud(bits=7, n_samples=5000, seed=4)
    ov = dict(SMALL, enablePointCloudPartitioning=1,
              roiBoundingBoxMinX=[0, 64], roiBoundingBoxMaxX=[63, 127],
              roiBoundingBoxMinY=[0, 10], roiBoundingBoxMaxY=[127, 90],
              roiBoundingBoxMinZ=[5, 0], roiBoundingBoxMaxZ=[127, 70])
    want = JEncoder(_cfg(JCfg, ov))._roi_boxes(src)
    got = Encoder(_cfg(VPCCConfig, ov), device="cpu")._roi_boxes(
        PointCloudData(src.positions, src.colors))
    assert len(got) == len(want) == 2
    for (a0, a1), (b0, b1) in zip(got, want):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_roi_stream_equals_reference():
    src = make_torus_cloud(bits=7, n_samples=30000)
    jenc, jstream, jrec, enc, stream, rec = _encode_both(ROI, [src])
    _check(jenc, jstream, jrec, enc, stream, rec)
    # four chunks, each segmented on its own, and the same raw-points patch
    assert len(enc._roi_boxes(PointCloudData(src.positions, src.colors))) == 4
    a, b = enc.last_encoded[0].raw_positions, jenc.last_encoded[0].raw_positions
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_tetris_stream_equals_reference():
    f0 = make_sphere_cloud(bits=7, n_samples=25000, seed=3)
    pos1 = np.clip(f0.positions.astype(np.int32) + 1, 0, 127)
    f1 = JPointCloudData(pos1, f0.colors).remove_duplicates()
    jenc, jstream, jrec, enc, stream, rec = _encode_both(TETRIS, [f0, f1])
    _check(jenc, jstream, jrec, enc, stream, rec)
    # matched patches of frame 1 kept their frame-0 place
    e1 = enc.last_encoded[1]
    stayed = sum(1 for p in e1.patches if p.pref_u0 >= 0 and
                 (p.u0, p.v0, p.orientation) == (p.pref_u0, p.pref_v0, p.pref_orientation))
    assert stayed > 0
