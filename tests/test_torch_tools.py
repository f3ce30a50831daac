"""PyTorch port vs JAX reference: the reconstruction tools a stream signals
to the decoder, together: color smoothing (attribute-smoothing SEI, kernel
T), PBF patch-border filtering (occupancy-synthesis SEI, kernel U) and PLR
(the ASPS's PLR fields, single-map geometry and attribute, kernel V's code
plane through kernel C).

On the CPU, one module-scoped GOF of two frames (I and P) of a thick
spherical shell (tests/test_plr.py's cloud at 6 bits, ~9k points) with
occupancyPrecision 4 and all three tools on (PLR's patch-level modes only
for one-block patches, patchSize 1, so that the 4 x 4-block atlas also
codes block-level modes), encoded by `vpcc_tpu.Encoder`
and by the port, driven by the JAX encoder's partitions:
* the streams are byte-identical, and so are the reconstructions;
* the stream signals the tools (both SEIs, the ASPS's PLR fields, one
  geometry and one attribute map) and every tool changes the result;
* the port's `Decoder(device="cpu")` decodes the JAX stream to the JAX
  encoder's reconstruction, and `vpcc_tpu.Decoder` decodes the port's
  stream to the port's;
* PBF on the GOF's decoded planes equals the reference's
  `apply_pbf_occupancy`, and the PLR RDO's sums stay exact.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from vpcc_tpu import pipeline as jpipe
from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu_torch import pipeline as tpipe
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import plr as tplr
from vpcc_tpu_torch.utils.config import VPCCConfig

BITS = 6
TOOLS = dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
             minimumImageWidth=1 << BITS, minimumImageHeight=1 << BITS,
             iterationCountRefineSegmentation=4, geometryQP=28, attributeQP=36,
             occupancyPrecision=4, flagColorSmoothing=1, pbfEnableFlag=1,
             pointLocalReconstruction=1, patchSize=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shell(seed: int, r0: float) -> PointCloudData:
    """A thick spherical shell (2-3 voxels radially: D1 > D0, the regime PLR
    is for) with a color gradient, as tests/test_plr.py's."""
    rng = np.random.default_rng(seed)
    c = (1 << BITS) / 2
    v = rng.normal(size=(60000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.clip(np.round(c + (r0 + rng.uniform(0.0, 2.3, (60000, 1))) * v), 0,
                  (1 << BITS) - 1).astype(np.int32)
    pts = np.unique(pts, axis=0)
    col = np.stack([(127 + 120 * (pts[:, 0] - c) / (r0 + 3)).astype(np.uint8),
                    (127 + 120 * (pts[:, 1] - c) / (r0 + 3)).astype(np.uint8),
                    ((pts[:, 2] * 7) % 200 + 30).astype(np.uint8)], 1)
    return PointCloudData(pts, col)


def _cfg(cls):
    c = cls()
    for k, v in TOOLS.items():
        setattr(c, k, v)
    return c


@pytest.fixture(scope="module")
def gof():
    frames = [shell(5, 14.0), shell(6, 14.5)]
    jenc = JEncoder(_cfg(JCfg))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    jstream, jrec = jenc.encode_gof(frames)
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    segs = []
    for f, p in zip(frames, parts):
        s = enc.segment_dispatch(f)
        segs.append(Encoder.with_partition(s, torch.as_tensor(p[:s.nn_idx.shape[0]]
                                                              .astype(np.int32))))
    stream, rec = enc.encode_gof(frames, segs=segs)
    return jenc, jstream, jrec, enc, stream, rec


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))


def test_tools_stream_equals_reference(gof):
    jenc, jstream, jrec, enc, stream, rec = gof
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    _same(rec, jrec)
    for e in enc.last_encoded:
        assert e.geometry.plr_inexact == 0
        assert len(np.unique(e.geometry.plr_modes)) > 2


def test_tools_signalled(gof):
    stream = gof[4]
    units = v3c.read_sample_stream(stream)
    kinds = [u for u, _ in units]
    assert kinds.count(v3c.V3C_GVD) == 1 and kinds.count(v3c.V3C_AVD) == 1
    vps = v3c.V3CParameterSet.read(BitReader(units[0][1]))
    assert vps.map_count_minus1 == 0
    asps, _, tiles, hash_ok, seis = v3c.read_atlas_substream(
        next(p for u, p in units if u == v3c.V3C_AD))
    assert all(hash_ok) and asps.plr_enabled_flag == 1 and asps.plr_num_modes == 6
    np.testing.assert_array_equal(asps.plr_mode_table, tplr.MODE_TABLE[:6])
    assert any(not p.plr_level for t in tiles for p in t.patches)
    sm, os_ = seis[v3c.SEI_ATTRIBUTE_SMOOTHING], seis[v3c.SEI_OCCUPANCY_SYNTHESIS]
    assert (sm.grid_size, sm.threshold, sm.threshold_variation) == (4, 10, 6)
    assert (os_.method_type, os_.passes_count, os_.filter_size, os_.log2_threshold) == \
        (1, 2, 4, 2)


def test_port_decoder_decodes_reference_stream(gof, monkeypatch):
    """... and every tool changes what the decoder makes: PBF drops pixels,
    PLR adds tag-2 rows, color smoothing moves colors."""
    _, jstream, jrec = gof[:3]
    seen = {"dropped": 0, "plr_rows": 0, "smoothed": 0}
    pbf_fn, rec_fn, cs_fn = (tpipe.apply_pbf_occupancy, tpipe.reconstruct_frame,
                             tpipe.apply_color_smoothing_device)

    def pbf_spy(occ, *a, **kw):
        out = pbf_fn(occ, *a, **kw)
        seen["dropped"] += int(np.asarray(occ).astype(bool).sum()) - int(out.sum())
        return out

    def rec_spy(*a, **kw):
        out = rec_fn(*a, **kw)
        seen["plr_rows"] += int((out.layer == 2).sum())
        return out

    def cs_spy(recon, col, cfg):
        out = cs_fn(recon, col, cfg)
        seen["smoothed"] += int((out != col).any(1).sum())
        return out

    monkeypatch.setattr(tpipe, "apply_pbf_occupancy", pbf_spy)
    monkeypatch.setattr(tpipe, "reconstruct_frame", rec_spy)
    monkeypatch.setattr(tpipe, "apply_color_smoothing_device", cs_spy)
    got = Decoder(device="cpu").decode(jstream)
    _same(got, jrec)
    print(seen)
    assert all(v > 0 for v in seen.values()), seen


def test_reference_decoder_decodes_port_stream(gof):
    _same(JDecoder().decode(gof[4]), gof[5])


def test_pbf_on_decoded_planes_matches_reference(gof):
    enc = gof[3]
    for e in enc.last_encoded:
        fr = e.geometry.front
        geo0 = e.geometry.geo_dec[0].numpy()
        want = np.asarray(jpipe.apply_pbf_occupancy(fr.occ_rec, geo0, fr.block_to_patch,
                                                    e.patches, _cfg(JCfg)))
        got = tpipe.apply_pbf_occupancy(fr.occ_rec, geo0, fr.block_to_patch, e.patches,
                                        enc.cfg, torch.device("cpu"))
        assert (want != fr.occ_rec.astype(bool)).sum() > 0
        np.testing.assert_array_equal(got.numpy().astype(bool), want)
