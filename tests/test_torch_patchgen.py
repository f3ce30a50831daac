"""PyTorch port vs JAX reference: connected components (K5), coverage (K6),
patch building, and the encoder front end over a random-access GOF.

The port runs on the CPU (plain versions of the kernels).  Everything here
is integer or host numpy, so everything is identical: CC labels, coverage
flags, patches, atlas frames, occupancy video and block-to-patch.  The GOF
test drives the port with the reference's partitions, so it checks the
patch-generation half exactly.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.core import atlas as jatlas, packing as jpacking
from vpcc_tpu.core.patch import build_patch_from_component as j_build
from vpcc_tpu.core.pointcloud import PAD_COORD, from_host, shape_bucket
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.ops import cc as jcc, coverage as jcov, neighbors as jn, voxelize as jv
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch import carry
from vpcc_tpu_torch.core.patch import build_patch_from_component as t_build
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import cc as tcc, coverage as tcov
from vpcc_tpu_torch.utils.checksum import array_md5, patches_md5

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "vpcc_tpu_torch" / "data"


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# connected components


def _random_graph(seed: int, V: int = 3000, K: int = 8, chains: bool = False):
    rng = np.random.default_rng(seed)
    if chains:
        # long paths in a scrambled order: the worst case for min-label
        # propagation (each path's minimum sits somewhere in the middle)
        perm = rng.permutation(V)
        idx = np.zeros((V, K), np.int32)
        idx[perm[:-1], 0] = perm[1:]
        valid = np.zeros((V, K), bool)
        valid[perm[:-1], 0] = True
        valid[perm[np.arange(0, V - 1, 500)], 0] = False   # cut into paths
        part = np.zeros(V, np.int32)
        return idx, valid, part, np.ones(V, bool)
    else:
        idx = rng.integers(0, V, (V, K)).astype(np.int32)
        valid = rng.random((V, K)) < 0.3
        part = rng.integers(0, 3, V).astype(np.int32)
    active = rng.random(V) < 0.9
    return idx, valid, part, active


@pytest.mark.parametrize("seed,chains", [(0, False), (1, False), (2, True)])
def test_cc_labels_match_reference(seed, chains):
    idx, valid, part, active = _random_graph(seed, chains=chains)
    want = np.asarray(jcc.cc_labels_device(*map(jnp.asarray, (idx, valid, part, active))))
    got = tcc.cc_labels_device(*map(_t, (idx, valid, part, active)))
    np.testing.assert_array_equal(got.numpy(), want)
    if chains:
        assert np.bincount(want[want < len(want)]).max() >= 400
    # the compact round: same active ids, same labels in the original space
    act = active & (np.random.default_rng(seed + 9).random(len(active)) < 0.3)
    acap = shape_bucket(int(act.sum()))
    js, jl = (np.asarray(a) for a in jcc.cc_round_voxel_compact(
        *map(jnp.asarray, (idx, valid, part, act)), acap))
    ts, tl = tcc.cc_round_voxel_compact(*map(_t, (idx, valid, part, act)))
    m = int(act.sum())
    np.testing.assert_array_equal(ts.numpy(), js[:m])
    np.testing.assert_array_equal(tl.numpy(), jl[:m])
    assert (js[m:] == len(idx)).all()
    # components from labels (host numpy, copied)
    seeds = np.random.default_rng(seed).random(len(idx)) < 0.5
    jc = jcc.components_from_labels(want, seeds, 5)
    tc = tcc.components_from_labels(got.numpy(), seeds, 5)
    assert len(jc) == len(tc) > 0
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# a real frame: the reference's segmentation of a 7-bit person


BITS = 7


def small_cfg(cls=JCfg):
    cfg = cls()
    for k, v in dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
                     minimumImageWidth=128, minimumImageHeight=128,
                     gridBasedSegmentation=1, occupancyPrecision=2,
                     iterationCountRefineSegmentation=10).items():
        setattr(cfg, k, v)
    return cfg


def _port_cfg():
    from vpcc_tpu_torch.utils.config import VPCCConfig

    return small_cfg(VPCCConfig)


def _jax_front_gof(frames, cfg):
    """The reference's front end over an RA GOF: `Encoder.encode_frame`'s
    one-tile path (encoder.py:472-588: segment, generate_patches,
    match_patches against the tree parent, pack_flexible under the height
    ratchet, rasterize, occupancy video, block-to-patch), without video."""
    enc = JEncoder(cfg)
    parent, _ = enc.gof_structure(len(frames))
    hint, out = 0, []
    for i, f in enumerate(frames):
        part_pt, graph, _ = enc.segment(f)
        patches, _ = enc.generate_patches(f, part_pt, graph)
        if i > 0:
            jpacking.match_patches(patches, out[parent[i]]["patches"])
        w, h = jpacking.pack_flexible(patches, cfg, preset_height=hint)
        hint = max(hint, h)
        fr = jatlas.rasterize_frame(patches, w, h, cfg)
        ov = jatlas.downsample_occupancy(fr.occupancy, cfg.occupancyPrecision)
        btp = jatlas.derive_block_to_patch(
            jatlas.upsample_occupancy(ov, cfg.occupancyPrecision), patches, w, h,
            cfg.occupancyResolution)
        out.append(dict(patches=patches, frame=fr, occ_video=ov, btp=btp, hint=hint,
                        part_vox=np.asarray(graph[0])))
    return out


@pytest.fixture(scope="module")
def gof():
    frames = [make_person_cloud(bits=BITS, n_samples=40000, seed=s) for s in (7, 8, 9)]
    return frames, _jax_front_gof(frames, small_cfg())


def _digests(patches, frame, occ_video, btp):
    return (patches_md5(patches), frame.width, frame.height,
            array_md5(frame.occupancy, np.uint8), array_md5(frame.geometry0, "<u2"),
            array_md5(frame.geometry1, "<u2"), array_md5(occ_video, np.uint8),
            array_md5(btp, "<i4"))


def _seg_with_reference_partition(enc, frame, ref):
    seg = enc.segment_dispatch(frame)
    nv = seg.nn_idx.shape[0]
    return Encoder.with_partition(seg, _t(ref["part_vox"][:nv].astype(np.int32)))


def test_front_end_gof_matches_reference(gof):
    """Frames 0-2 of an RA GOF (both P-frames pack against frame 0), driven
    by the reference's partitions: identical patch lists, atlas frames,
    occupancy video and block-to-patch."""
    frames, ref = gof
    enc = Encoder(_port_cfg(), device="cpu")
    segs = [_seg_with_reference_partition(enc, f, r) for f, r in zip(frames, ref)]
    got = enc.encode_gof_front(frames, segs=segs)
    assert [len(g.patches) for g in got] == [len(r["patches"]) for r in ref]
    for g, r in zip(got, ref):
        assert _digests(g.patches, g.frame, g.occ_video, g.block_to_patch) == \
            _digests(r["patches"], r["frame"], r["occ_video"], r["btp"])
        np.testing.assert_array_equal(g.occ_rec, np.repeat(np.repeat(g.occ_video, 2, 0), 2, 1))
    assert any(p.ref_patch_idx >= 0 for p in got[1].patches)


def test_p_frame_seeded_from_reference_parent(gof):
    """A P-frame alone: the parent's patch list and the height ratchet come
    from the reference through `carry`."""
    frames, ref = gof
    enc = Encoder(_port_cfg(), device="cpu")
    parent = carry.patches_from_dicts([dataclasses.asdict(p) for p in ref[0]["patches"]])
    carry.seed_height_hint(enc, ref[0]["hint"])
    seg = _seg_with_reference_partition(enc, frames[2], ref[2])
    g = enc.encode_frame_front(frames[2], prev_patches=parent, seg=seg)
    r = ref[2]
    assert _digests(g.patches, g.frame, g.occ_video, g.block_to_patch) == \
        _digests(r["patches"], r["frame"], r["occ_video"], r["btp"])
    with pytest.raises(KeyError):
        carry.patches_from_dicts([{"no_such_field": 1}])


def test_build_patch_from_component_matches_reference(gof):
    frames, _ = gof
    pc = frames[0]
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = small_cfg(), _port_cfg()
    for view in range(6):
        comp = np.sort(rng.choice(pc.point_count, 3000, replace=False))
        a = j_build(3, pc.positions, pc.colors, comp, view, cfg_j)
        b = t_build(3, pc.positions, pc.colors, comp, view, cfg_t)
        assert patches_md5([a]) == patches_md5([b])
        for pa, pb in zip(a.generate_points(), b.generate_points()):
            np.testing.assert_array_equal(pa, pb)


def test_cc_labels_on_a_real_frame(gof):
    """Round-0 labels of the voxel graph with the reference's partitions."""
    frames, ref = gof
    P = from_host(frames[0])
    _, vp, nv = jv.voxelize(P.positions, 1, BITS)
    nv = int(nv)
    vpos = vp[: shape_bucket(nv)]
    idx, d2 = jn.knn(jn.build_grid(vpos, BITS), vpos, vpos, k=16, bucket=6)
    valid = (d2 < jn.MAX_DIST2) & (vpos[:, 0] != PAD_COORD)[:, None]
    act = np.arange(len(vpos)) < nv
    part = jnp.asarray(ref[0]["part_vox"])
    want = np.asarray(jcc.cc_labels_device(idx, valid, part, jnp.asarray(act)))[:nv]
    h = lambda a: _t(np.asarray(a)[:nv])
    got = tcc.cc_labels_device(h(idx), h(valid), h(part), torch.ones(nv, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# coverage


@pytest.mark.parametrize("seed", [0, 1])
def test_covered_radius_slab_matches_reference_and_brute_force(seed):
    """Random resampled points in a slab of an 8-bit grid, queries around
    them (some outside the slab, some padding): identical flags, and equal
    to the brute-force distance test inside the slab."""
    rng = np.random.default_rng(seed)
    bits, G = 8, 256
    res = rng.integers(0, G, (400, 3))
    res[:, 0] = rng.integers(40, 90, 400)
    x0, sx = tcov.slab_params(res, bits)
    assert (x0, sx) == jcov.slab_params(res, bits)
    q = np.concatenate([res + rng.integers(-4, 5, res.shape),
                        rng.integers(0, G, (600, 3))]).astype(np.int32)
    q = np.clip(q, 0, G - 1)
    q[::97] = PAD_COORD
    packed = tcov.pack_coords10(res, 512)
    assert np.array_equal(packed, jcov.pack_coords10(res, 512))
    want = [np.asarray(a) for a in jcov.covered_radius_slab(
        jnp.asarray(packed), jnp.asarray(q), jnp.int32(x0), bits, 1, 9, sx)]
    got = tcov.covered_radius_slab(_t(packed), _t(q), x0, bits, 1, 9, sx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    d2 = ((q[:, None, :].astype(np.int64) - res[None, :, :]) ** 2).sum(-1).min(1)
    inside = (q[:, 0] >= x0) & (q[:, 0] < x0 + sx) & (q[:, 0] != PAD_COORD)
    np.testing.assert_array_equal(got[0].numpy(), inside & (d2 <= 1))
    np.testing.assert_array_equal(got[1].numpy(), inside & (d2 <= 9))
    assert got[1].numpy().sum() > got[0].numpy().sum() > 0


# ---------------------------------------------------------------------------
# the committed full-size reference data


def test_coverage_column_table_matches_ball_columns():
    """Kernel H's host-built column table: for r2 in 0..16 (alone and beside
    a smaller and a larger second ball) each ball's columns equal
    `_ball_columns` of the port and of the JAX package, ordered by
    dx^2 + dy^2, each ball a prefix of the table."""
    for r2 in range(17):
        want = sorted(jcov._ball_columns(r2))
        assert sorted(tcov._ball_columns(r2)) == want
        for other in (0, r2, 16):
            for r2_sel, r2_det in ((other, r2), (r2, other)):
                tbl = tcov.column_table(r2_sel, r2_det)
                d2 = [dx * dx + dy * dy for dx, dy, _, _ in tbl]
                assert d2 == sorted(d2)
                for r2x, col in ((r2_sel, 3), (r2_det, 2)):
                    inside = [(dx, dy, c[col]) for c in tbl for dx, dy in [c[:2]] if c[col] >= 0]
                    assert sorted(inside) == sorted(jcov._ball_columns(r2x))
                    assert [c[col] >= 0 for c in tbl] == sorted(
                        (c[col] >= 0 for c in tbl), reverse=True)


def test_committed_front_digests_frame0_match_reference():
    """Frame 0 of the committed digests (the bench frame, seed 7): the
    reference's k-NN digests and patch count."""
    dg = json.loads((DATA / "person_vox10_front_digests.json").read_text())
    cfg = JCfg()
    for k, v in dg["overrides"].items():
        setattr(cfg, k, v)
    pc = make_person_cloud(bits=10, n_samples=3_000_000, seed=dg["seeds"][0])
    f0 = dg["frames"][0]
    P = from_host(pc)
    _, vp, nv = jv.voxelize(P.positions, 1, 10)
    assert int(nv) == f0["voxels"]
    vpos = vp[: shape_bucket(int(nv))]
    idx, d2 = jn.knn(jn.build_grid(vpos, 10), vpos, vpos, k=16, bucket=6)
    assert array_md5(np.asarray(idx)[: int(nv)], "<i4") == f0["knn_idx_md5"]
    assert array_md5(np.asarray(d2)[: int(nv)], "<i4") == f0["knn_d2_md5"]
    enc = JEncoder(cfg)
    part_pt, graph, _ = enc.segment(pc)
    patches, _ = enc.generate_patches(pc, part_pt, graph)
    assert len(patches) == f0["patches"]


def test_committed_placements_match_fixture_stream():
    """The recorded patch placements are those the port's V3C reader parses
    from the committed decode fixture, which the same encode produced."""
    from vpcc_tpu_torch.bitstream import v3c
    from vpcc_tpu_torch.bitstream.bitio import BitReader
    from vpcc_tpu_torch.decoder import _pdu_to_patch

    dg = json.loads((DATA / "person_vox10_front_digests.json").read_text())
    units = v3c.read_sample_stream((DATA / "person_vox10_r3_gof8.vpcc").read_bytes())
    vps = next(v3c.V3CParameterSet.read(BitReader(p)) for t, p in units if t == v3c.V3C_VPS)
    _, _, tiles, _, _ = v3c.read_atlas_substream(
        next(p for t, p in units if t == v3c.V3C_AD))
    assert len(tiles) == len(dg["frames"])
    for tile, f in zip(tiles, dg["frames"]):
        parsed = [_pdu_to_patch(pdu, i, vps) for i, pdu in enumerate(tile.patches)]
        got = [[p.u0, p.v0, p.size_u0, p.size_v0, p.orientation, p.u1, p.v1, p.d1,
                p.view_id] for p in parsed]
        assert got == f["placements"]


def test_encoder_device_policy_and_unsupported_options():
    from vpcc_tpu_torch.utils.config import VPCCConfig

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder()
    assert Encoder(device="cpu").device == torch.device("cpu")
    # the lossless conditions' tools, the decoder-signalled reconstruction
    # tools, the segmentation options, GPA and multi-tile atlases are ported
    for k, v in (("globalPatchAllocation", 1), ("numMaxTilePerFrame", 2),
                 ("enhancedOccupancyMapCode", 1), ("rawPointsPatch", 1),
                 ("useRawPointsSeparateVideo", 1), ("pointLocalReconstruction", 1),
                 ("pbfEnableFlag", 1), ("flagColorSmoothing", 1),
                 ("highGradientSeparation", 1), ("enablePointCloudPartitioning", 1),
                 ("normalOrientation", 0), ("normalOrientation", 2),
                 ("normalOrientation", 3), ("normalOrientation", 4)):
        cfg = VPCCConfig()
        setattr(cfg, k, v)
        assert getattr(Encoder(cfg, device="cpu").cfg, k) == v
    from vpcc_tpu_torch.core import packing

    cfg = VPCCConfig()
    cfg.packingStrategy = 2   # tetris packing: an empty patch list packs to the minimum
    assert packing.pack_flexible([], cfg) == (cfg.minimumImageWidth, cfg.minimumImageHeight)
