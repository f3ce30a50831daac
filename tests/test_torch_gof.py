"""PyTorch port vs JAX reference: a 3-frame random-access GOF.

Frames 1 and 2 are P-frames: their geometry D0 and attribute T0 are
motion-compensated from the tree parent (kernel B's path), their D1 / T1
are predicted from D0 / T0 (inter-layer), and the decoder keeps the
hierarchical reference banks.  The port (device="cpu") must give the JAX
decoder's positions and colors exactly, in order, frame by frame.
"""

import numpy as np
import pytest
import torch

from vpcc_tpu.decoder import Decoder as JaxDecoder
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu.utils.synthetic import make_sphere_cloud
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.video import hevc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_random_access_gof_matches_reference():
    cfg = JCfg()
    cfg.geometry3dCoordinatesBitdepth = 7
    cfg.minimumImageWidth = cfg.minimumImageHeight = 128
    cfg.resolution = 127
    cfg.iterationCountRefineSegmentation = 10
    cfg.geometryQP, cfg.attributeQP = 22, 30
    base = make_sphere_cloud(bits=7, n_samples=20000)
    frames = []
    for t in range(3):
        pos = np.clip(base.positions.astype(np.int32) + t, 0, 127)
        frames.append(PointCloudData(pos, base.colors))
    stream, _ = Encoder(cfg).encode_gof(frames)

    # the stream really carries temporal motion-compensated video
    mc = []
    for utype, payload in v3c.read_sample_stream(stream):
        if utype in (v3c.V3C_GVD, v3c.V3C_AVD):
            s = v3c.VideoSubstream.read(BitReader(payload))
            if s.map_index == 0:
                for f in s.frames[1:]:
                    inner = f[1:] if utype == v3c.V3C_GVD else f[9:]
                    assert f[0] == v3c.CODEC_TPU_HEVC
                    mc.append(bool(inner[5] & hevc.FLAG_MC))
    assert mc and all(mc), mc

    ref = JaxDecoder().decode(stream)
    got = Decoder(device="cpu").decode(stream)
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert a.point_count == b.point_count > 0
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(b.colors, a.colors)
