"""PyTorch port vs JAX reference: the whole encoder, `Encoder.encode_gof`.

A 3-frame random-access GOF of a 6-bit synthetic person (frames 1 and 2
are P-frames whose D0 and T0 are motion-searched against the tree parent).
The JAX encoder runs `encode_gof` on the CPU and its refined voxel
partitions are recorded; the port, driven by those partitions
(`Encoder.with_partition`), runs its own `encode_gof` on the CPU (the plain
versions of every kernel).  Checked, exactly:
* the port's V3C sample stream equals JAX's byte for byte;
* both packages' decoders decode it to the port encoder's reconstruction
  (positions and colors, in order);
* the per-substream byte counts (`last_stream_stats`) agree;
* frame 2 encoded alone from the JAX encoder's state (its tree parent's
  patches and decoded D0/T0 planes, the height ratchet; `carry`) gives the
  JAX encoder's payloads for that frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import codecs as jcodecs
from vpcc_tpu_torch import carry
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
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


def _cfg(cls):
    cfg = cls()
    for k, v in dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
                     minimumImageWidth=64, minimumImageHeight=64,
                     gridBasedSegmentation=1, occupancyPrecision=2,
                     iterationCountRefineSegmentation=10).items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def gof():
    """The frames, the JAX encoder (after its `encode_gof`), its stream, its
    refined voxel partitions per frame, the geometry / attribute substream
    encoders' decoded reference planes after each call (D0, D1, ... and
    T0, T1, ... in coding order) and the height ratchet before each
    frame."""
    frames = [make_person_cloud(bits=BITS, n_samples=20000, seed=s) for s in (7, 8, 9)]
    enc = JEncoder(_cfg(JCfg))
    rec = {"parts": [], "geo": [], "attr": [], "hint": []}
    fetch, frame_fn = JEncoder.segment_fetch, JEncoder.encode_frame
    geo_enc, attr_enc = jcodecs.GeometrySubstreamEncoder.encode, jcodecs.AttributeSubstreamEncoder.encode

    def record_fetch(futures):
        out = fetch(futures)
        rec["parts"].append(np.asarray(out[1][0]))
        return out

    def record_frame(self_, *a, **kw):
        rec["hint"].append(getattr(self_, "_height_hint", 0))
        return frame_fn(self_, *a, **kw)

    def record_geo(self_, *a, **kw):
        out = geo_enc(self_, *a, **kw)
        rec["geo"].append(np.asarray(self_.ref))
        return out

    def record_attr(self_, *a, **kw):
        out = attr_enc(self_, *a, **kw)
        rec["attr"].append(tuple(np.asarray(r) for r in self_.refs))
        return out

    enc.segment_fetch = record_fetch
    enc.encode_frame = lambda *a, **kw: record_frame(enc, *a, **kw)
    jcodecs.GeometrySubstreamEncoder.encode = record_geo
    jcodecs.AttributeSubstreamEncoder.encode = record_attr
    try:
        stream, _ = enc.encode_gof(frames)
    finally:
        jcodecs.GeometrySubstreamEncoder.encode = geo_enc
        jcodecs.AttributeSubstreamEncoder.encode = attr_enc
    return frames, enc, stream, rec


@pytest.fixture(scope="module")
def segs(gof):
    """The port's segmentations, driven by the JAX partitions."""
    frames, _, _, rec = gof
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    out = []
    for f, p in zip(frames, rec["parts"]):
        seg = enc.segment_dispatch(f)
        nv = seg.nn_idx.shape[0]
        out.append(Encoder.with_partition(seg, torch.as_tensor(p[:nv].astype(np.int32))))
    return out


@pytest.fixture(scope="module")
def port_gof(gof, segs):
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    stream, recon = enc.encode_gof(gof[0], segs=segs)
    return enc, stream, recon


def test_encode_gof_stream_equals_reference(gof, port_gof):
    _, jenc, jstream, _ = gof
    enc, stream, recon = port_gof
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    assert len(recon) == 3 and all(r.point_count > 0 for r in recon)
    st = enc.stats
    assert all(s.recolor_s > 0 and s.compressed_bytes == len(stream) // 3 for s in st)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_encode_gof_stream_decodes_to_encoder_reconstruction(port_gof, which):
    _, stream, recon = port_gof
    dec = Decoder(device="cpu") if which == "port" else JDecoder()
    got = dec.decode(stream)
    assert len(got) == len(recon)
    for a, b in zip(got, recon):
        np.testing.assert_array_equal(np.asarray(a.positions), b.positions)
        np.testing.assert_array_equal(np.asarray(a.colors), b.colors)


def test_encode_gof_out_of_slice_options_raise():
    frames = [make_person_cloud(bits=BITS, n_samples=4000, seed=7)]
    cfg = _cfg(VPCCConfig)
    cfg.enhancedOccupancyMapCode = 1
    with pytest.raises(NotImplementedError, match="level-batched GOF path with "
                                                  "enhancedOccupancyMapCode"):
        Encoder(cfg, device="cpu").encode_gof(frames, parallel=True)


def test_p_frame_seeded_from_reference_state(gof, segs):
    """Frame 2 (tree parent 0, QP offset 4, geometry cascade capped at 1)
    alone, from the JAX encoder's state through `carry`."""
    frames, jenc, _, rec = gof
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    carry.seed_height_hint(enc, rec["hint"][2])
    parent = carry.patches_from_dicts([dataclasses.asdict(p) for p in jenc.last_encoded[0].patches])
    streams = carry.seed_geometry_streams(enc._new_streams(), {"geo0": rec["geo"][2]}, device="cpu")
    carry.seed_attribute_streams(streams, {"attr0": rec["attr"][2]}, device="cpu")
    trefs = {"geo": carry.geo_bank_from_numpy({0: rec["geo"][0]}, device="cpu")[0],
             "attr": carry.attr_bank_from_numpy({0: rec["attr"][0]}, device="cpu")[0]}
    e = enc.encode_frame(frames[2], streams, prev_patches=parent, seg=segs[2],
                         temporal_refs=trefs, qp_offset=4, qp_offset_geo=1)
    want = jenc.last_encoded[2]
    assert e.geometry_payloads == want.geometry_payloads
    assert e.attribute_payloads == want.attribute_payloads
    np.testing.assert_array_equal(e.recon.positions, want.recon.positions)
    np.testing.assert_array_equal(e.recon.colors, want.recon.colors)
