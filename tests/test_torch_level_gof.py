"""PyTorch port: the level-batched GOF encode, `Encoder.encode_gof(
parallel=True)` (vpcc_tpu_torch/parallel/gof.py), against the port's
sequential `encode_gof` and the JAX package's decoder.

A 3-frame random-access GOF of 6-bit clouds: two person frames and a
torus, whose atlas is wider.  Its levels are [[0], [1, 2]]; frame 1 keeps
its parent's atlas shape and predicts from it, frame 2 (wider) is coded
intra, so level 1 splits into two shape subgroups (reference gof.py:564-584).
On the CPU (plain kernels); checked exactly:
* the split happened;
* the level-batched stream equals the sequential one byte for byte, and the
  reconstructions agree;
* `vpcc_tpu.decoder.Decoder` decodes the stream to that reconstruction;
* the options outside the reference's envelope for the path raise
  NotImplementedError, as does a mesh of several cards.
The JAX mesh path itself is not run here (tests/test_parallel.py does).
"""

import numpy as np
import pytest
import torch

from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.utils.synthetic import make_person_cloud, make_torus_cloud
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.parallel import gof
from vpcc_tpu_torch.utils.config import VPCCConfig

BITS = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    cfg = VPCCConfig()
    fields = dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
                  minimumImageWidth=64, minimumImageHeight=64, gridBasedSegmentation=1,
                  occupancyPrecision=2, iterationCountRefineSegmentation=10)
    for k, v in {**fields, **over}.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def frames():
    return [make_person_cloud(bits=BITS, n_samples=20000, seed=7),
            make_person_cloud(bits=BITS, n_samples=20000, seed=8),
            make_torus_cloud(bits=BITS, n_samples=3000, seed=33)]


@pytest.fixture(scope="module")
def sequential(frames):
    enc = Encoder(_cfg(), device="cpu")
    stream, recon = enc.encode_gof(frames)
    return enc, stream, recon


@pytest.fixture(scope="module")
def level_batched(frames):
    enc = Encoder(_cfg(), device="cpu")
    stream, recon = enc.encode_gof(frames, parallel=True)
    return enc, stream, recon


def test_level_splits_into_shape_subgroups(level_batched):
    enc, _, _ = level_batched
    parent, _ = enc.gof_structure(3)
    levels = gof.level_schedule(parent)
    assert levels == [[0], [1, 2]]
    shapes = [(e.height, e.width) for e in enc.last_encoded]
    groups = gof.level_groups(levels, parent, shapes)
    assert [(lv, ok, fr) for lv, (_, _, ok), fr in groups] == [
        (0, False, [0]), (1, True, [1]), (1, False, [2])]
    assert shapes[2] != shapes[0] == shapes[1]


def test_level_batched_stream_equals_sequential(sequential, level_batched):
    enc_s, stream_s, recon_s = sequential
    enc_p, stream_p, recon_p = level_batched
    assert stream_p == stream_s
    assert enc_p.last_stream_stats == enc_s.last_stream_stats
    for a, b in zip(recon_p, recon_s):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.colors, b.colors)
    assert all(s.video_s > 0 and s.recolor_s > 0 for s in enc_p.stats)


def test_level_batched_stream_decodes_with_the_reference(level_batched):
    _, stream, recon = level_batched
    got = JDecoder().decode(stream)
    assert len(got) == len(recon)
    for a, b in zip(got, recon):
        np.testing.assert_array_equal(np.asarray(a.positions), b.positions)
        np.testing.assert_array_equal(np.asarray(a.colors), b.colors)


@pytest.mark.parametrize("field,value,what", [
    ("enhancedOccupancyMapCode", 1, "enhancedOccupancyMapCode"),
    ("pointLocalReconstruction", 1, "pointLocalReconstruction"),
    ("enablePointCloudPartitioning", 1, "enablePointCloudPartitioning"),
    ("useRawPointsSeparateVideo", 1, "useRawPointsSeparateVideo"),
    ("numNeighborsColorTransferBwd", 0, "numNeighborsColorTransferBwd"),
    ("geometry3dCoordinatesBitdepth", 11, "above 10 bits"),
    ("geometryNominal2dBitdepth", 11, "2D geometry above 10 bits"),
    ("geometryQP", 4, "lossless video"),
    ("numMaxTilePerFrame", 2, "numMaxTilePerFrame"),
    ("globalPatchAllocation", 1, "globalPatchAllocation"),
])
def test_envelope_refusals(frames, field, value, what):
    """The reference's envelope asserts (gof.py:509-514) as refusals; GPA and
    multi-tile atlases are refused by the encoder itself, whatever path."""
    cfg = _cfg(**{field: value})
    with pytest.raises(NotImplementedError, match=what):
        Encoder(cfg, device="cpu").encode_gof(frames[:1], parallel=True)


def test_mesh_of_several_cards_is_refused(frames):
    enc = Encoder(_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="several cards"):
        enc.encode_gof(frames[:1], mesh=[torch.device("cpu"), torch.device("cpu")])
    with pytest.raises(ValueError, match="not the encoder's device"):
        enc.encode_gof(frames[:1], mesh=[torch.device("meta")])
