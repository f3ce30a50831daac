"""PyTorch port vs JAX reference: the geometry video over a random-access
GOF (`Encoder.encode_gof_geometry`).

A 3-frame RA GOF of a 6-bit synthetic person: the reference's front end
gives the atlas frames and partitions; the port's front end, driven by
those partitions, reproduces the same atlas frames (tests/
test_torch_patchgen.py), and its geometry video runs on the CPU (plain
versions of kernels I-L).  The reference side is its
`GeometrySubstreamEncoder` chain as `encode_gof` drives it (D1 from the
decoded D0, D0 of a P-frame motion-searched against its tree parent's
decoded D0, QP cascade capped at geometryQpCascadeCap).  Checked: the
occupancy payload is byte-identical; every geometry payload decodes, with
both packages' decoders, exactly to the port encoder's planes; the
encoder's reconstruction equals `pipeline.reconstruct_frame` on the
decoded planes; RD within the gate (bytes 1 %, PSNR 0.1 dB) and the CU
syntax agreement pinned at >= 0.99 per plane (measured: 1.0, every payload
byte-identical).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.core import atlas as jatlas, packing as jpacking
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import codecs as jcodecs
from vpcc_tpu_torch import carry, pipeline
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import codecs as tcodecs, hevc as th

BITS = 6
AGREEMENT_FLOOR = 0.99


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions of kernels I-L run many small tensor ops; with
    several test workers on the machine, intra-op threads only contend, so
    this module runs them on one thread (restored afterwards)."""
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


def _jax_gof(frames, cfg):
    """The reference's front end per frame (encoder.py:472-588, one tile)
    and its geometry substream chain (encoder.py:627-646, 959-1001)."""
    enc = JEncoder(cfg)
    parent, qp_off = enc.gof_structure(len(frames))
    cap = int(getattr(cfg, "geometryQpCascadeCap", 1))
    streams = {k: jcodecs.GeometrySubstreamEncoder(cfg) for k in ("geo0", "geo1")}
    hint, bank, out = 0, {}, []
    for i, f in enumerate(frames):
        part_pt, graph, _ = enc.segment(f)
        patches, _ = enc.generate_patches(f, part_pt, graph)
        if i > 0:
            jpacking.match_patches(patches, out[parent[i]]["patches"])
        w, h = jpacking.pack_flexible(patches, cfg, preset_height=hint)
        hint = max(hint, h)
        fr = jatlas.rasterize_frame(patches, w, h, cfg)
        ov = jatlas.downsample_occupancy(fr.occupancy, cfg.occupancyPrecision)
        occ_rec = jatlas.upsample_occupancy(ov, cfg.occupancyPrecision)
        pays, decs = [], []
        for name, g in (("geo0", fr.geometry0), ("geo1", fr.geometry1)):
            kw = {} if decs else {"temporal_ref": bank.get(parent[i]) if i else None}
            p, dcd = streams[name].encode(g, occ=fr.occupancy, weight=occ_rec,
                                          layer_ref=decs[0] if decs else None,
                                          qp_offset=min(qp_off[i], cap), **kw)
            pays.append(p)
            decs.append(dcd)
        bank[i] = streams["geo0"].ref
        out.append(dict(patches=patches, frame=fr, occ_payload=jcodecs.encode_occupancy(ov, cfg),
                        geo=pays, dec=[np.asarray(d) for d in decs], hint=hint,
                        bank=np.asarray(bank[i]), part_vox=np.asarray(graph[0])))
    return out


@pytest.fixture(scope="module")
def gof():
    frames = [make_person_cloud(bits=BITS, n_samples=20000, seed=s) for s in (7, 8, 9)]
    return frames, _jax_gof(frames, _cfg(JCfg))


def _segs(enc, frames, ref):
    out = []
    for f, r in zip(frames, ref):
        seg = enc.segment_dispatch(f)
        nv = seg.nn_idx.shape[0]
        out.append(Encoder.with_partition(seg, torch.as_tensor(r["part_vox"][:nv].astype(np.int32))))
    return out


def _psnr(src, rec, occ):
    m = occ != 0
    return 10 * np.log10(255.0 ** 2 / np.mean((src[m].astype(float) - rec[m]) ** 2))


def _agreement(a, b):
    same = np.ones(a["s32"].shape, bool)
    for k in ("s32", "m32", "c32", "s16", "modes", "c16"):
        same &= (a[k] == b[k]).reshape(a[k].shape[0], a[k].shape[1], -1).all(-1)
    return float(same.mean())


def test_geometry_gof_matches_reference(gof):
    frames, ref = gof
    cfg = _cfg(VPCCConfig)
    enc = Encoder(cfg, device="cpu")
    got = enc.encode_gof_geometry(frames, segs=_segs(enc, frames, ref))
    parent, _ = enc.gof_structure(len(frames))
    t_decs = [tcodecs.GeometrySubstreamDecoder(cfg, torch.device("cpu")) for _ in range(2)]
    j_decs = [jcodecs.GeometrySubstreamDecoder(_cfg(JCfg)) for _ in range(2)]
    t_bank, j_bank = {}, {}
    port_bytes = jax_bytes = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.occ_payload == r["occ_payload"]
        assert g.front.frame.geometry0.tobytes() == r["frame"].geometry0.tobytes()
        # both decoders decode the port's payloads to the port's planes
        t0 = t_decs[0].decode(g.geo_payloads[0], temporal_ref=t_bank.get(parent[i]) if i else None)
        t1 = t_decs[1].decode(g.geo_payloads[1], layer_ref=t0)
        j0 = j_decs[0].decode(g.geo_payloads[0], temporal_ref=j_bank.get(parent[i]) if i else None)
        j1 = j_decs[1].decode(g.geo_payloads[1], layer_ref=j0)
        t_bank[i], j_bank[i] = t0, j0
        for k, (a, b) in enumerate(((t0, j0), (t1, j1))):
            np.testing.assert_array_equal(a.numpy(), g.geo_dec[k].numpy())
            np.testing.assert_array_equal(np.asarray(b), g.geo_dec[k].numpy())
        # the encoder's reconstruction is the seam's on the decoded planes
        rc = pipeline.reconstruct_frame(g.front.occ_rec, [t0, t1], g.front.block_to_patch,
                                        g.front.patches, cfg, torch.device("cpu"))
        for a, b in zip(rc, g.recon):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
        # RD against the reference and the CU syntax agreement
        occ = g.front.frame.occupancy
        for k, src in enumerate((g.front.frame.geometry0, g.front.frame.geometry1)):
            pt, pj = g.geo_payloads[k], r["geo"][k]
            port_bytes += len(pt)
            jax_bytes += len(pj)
            agree = _agreement(th.parse_planes32(pt[1:]), th.parse_planes32(pj[1:]))
            assert agree >= AGREEMENT_FLOOR, (i, k, agree)
            assert abs(_psnr(src, g.geo_dec[k].numpy(), occ) - _psnr(src, r["dec"][k], occ)) <= 0.1
    assert abs(port_bytes / jax_bytes - 1.0) <= 0.01
    assert g.stats.video_s > 0 and g.stats.reconstruct_s > 0
    assert th.parse_planes32(got[1].geo_payloads[0][1:])["flags"] & th.FLAG_MC


def test_p_frame_seeded_from_reference_state(gof):
    """Frame 2 alone, from the reference's state through `carry`: its tree
    parent's patches and decoded D0, and the height ratchet."""
    frames, ref = gof
    cfg = _cfg(VPCCConfig)
    enc = Encoder(cfg, device="cpu")
    carry.seed_height_hint(enc, ref[1]["hint"])
    parent = carry.patches_from_dicts([dataclasses.asdict(p) for p in ref[0]["patches"]])
    streams = carry.seed_geometry_streams(enc._new_streams(), {"geo0": ref[1]["bank"]},
                                          device="cpu")
    bank = carry.geo_bank_from_numpy({0: ref[0]["bank"]}, device="cpu")
    g = enc.encode_frame_geometry(frames[2], streams, prev_patches=parent,
                                  seg=_segs(enc, frames[2:], ref[2:])[0],
                                  temporal_refs={"geo": bank[0]}, qp_offset_geo=1)
    assert g.occ_payload == ref[2]["occ_payload"]
    for k in range(2):
        np.testing.assert_array_equal(
            g.geo_dec[k].numpy(),
            np.asarray(jcodecs.GeometrySubstreamDecoder(_cfg(JCfg)).decode(
                g.geo_payloads[k], layer_ref=g.geo_dec[0].numpy() if k else None,
                temporal_ref=None if k else jnp.asarray(ref[0]["bank"]))))
    assert abs(len(g.geo_payloads[0]) / len(ref[2]["geo"][0]) - 1.0) <= 0.01
    assert torch.equal(streams["geo0"].ref, g.geo_dec[0])
