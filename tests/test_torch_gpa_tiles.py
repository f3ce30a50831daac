"""PyTorch port vs JAX reference: global patch allocation
(globalPatchAllocation) and multi-tile atlases (numMaxTilePerFrame).

Each GOF is encoded by `vpcc_tpu.Encoder` and by the port on the CPU, the
port driven by the partitions of every JAX segmentation, in call order.
Lossless video (QP 4) keeps the plain RDO out: these options act before the
video.  Checked, exactly:
* `packing.pack_global` against the reference's on seeded synthetic chains
  over the coding tree, with and without orientations, several of them
  doubling the canvas;
* GPA GOFs byte-identical to the JAX encoder's, one content for each branch
  of the data-adaptive choice: a 6-bit person keeps GPA's positions, a
  7-bit person moved frame to frame (no chains) falls back to per-frame
  packing;
* a 2-tile GOF byte-identical to JAX's, every tile parsing alone with good
  hash SEIs; its content grows (a half-size person, a person, a stack of
  planes), so tile 0's band grows in frame 2 and the one `tile_row_start`
  the mux writes (the encoder's rows after the last frame, as the
  reference's) lies below frame 0's tile-1 patches: a reference defect the
  port copies (ROADMAP F3; positions are coded absolute, so decoding is
  unaffected);
* two GOFs on one encoder (tile and height ratchets carried over);
* the port's decoder on the JAX streams and JAX's decoder on the port's;
* frame 2's front end from the JAX encoder's tile state (`carry`);
* the level-batched path refusing both options.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from vpcc_tpu.core import packing as jpacking
from vpcc_tpu.core.patch import Patch as JPatch
from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch import carry
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.core import packing
from vpcc_tpu_torch.core.patch import INFINITE_DEPTH, Patch
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.parallel.gof import check_envelope
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import PointCloudData


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, bits: int, **overrides):
    cfg = cls()
    for k, v in dict(geometry3dCoordinatesBitdepth=bits, resolution=(1 << bits) - 1,
                     minimumImageWidth=64, minimumImageHeight=64, gridBasedSegmentation=1,
                     occupancyPrecision=2, iterationCountRefineSegmentation=10,
                     geometryQP=4, attributeQP=4, **overrides).items():
        setattr(cfg, k, v)
    return cfg


def _clip(pos, bits: int, off=(0, 0, 0)):
    return np.clip(pos.astype(np.int32) + np.asarray(off), 0, (1 << bits) - 1)


def _person(bits: int, seeds, n: int, offsets=None):
    out = []
    for i, s in enumerate(seeds):
        c = make_person_cloud(bits=bits, n_samples=n, seed=s)
        out.append(PointCloudData(_clip(c.positions, bits, offsets[i] if offsets else (0, 0, 0)),
                                  c.colors))
    return out


def _growing():
    """6 bits: a half-size person, a person, then ten 64 x 64 planes (many
    large patches), so tile 0 outgrows its 256-row band in frame 2."""
    a, b = _person(6, (7, 8), 20000)
    g = np.stack(np.meshgrid(np.arange(64), np.arange(64), indexing="ij"), -1).reshape(-1, 2)
    planes = np.concatenate([np.concatenate([g, np.full((len(g), 1), z)], 1)
                             for z in range(2, 64, 7)]).astype(np.int32)
    colors = (np.arange(len(planes))[:, None] * np.array([[7, 13, 29]]) % 256).astype(np.uint8)
    return [PointCloudData(a.positions // 2, a.colors), b, PointCloudData(planes, colors)]


CONTENTS = {
    # content, bits, overrides
    "gpa": (lambda: _person(6, (7, 8, 9), 20000), 6, dict(globalPatchAllocation=1)),
    "per-frame": (lambda: _person(7, (7, 8, 9), 30000, [(0, 0, 0), (40, 0, 40), (-40, 0, -40)]),
                  7, dict(globalPatchAllocation=1)),
    "tiles": (_growing, 6, dict(numMaxTilePerFrame=2)),
}


class DrivenEncoder(Encoder):
    """The port's encoder with each segmentation's voxel partition replaced,
    in call order, by the given ones; `rows` records `_tile_rows` after
    each frame's front end."""

    def __init__(self, cfg, parts, **kw):
        super().__init__(cfg, **kw)
        self._parts = list(parts)
        self.rows = []

    def segment_dispatch(self, pc_host):
        seg = super().segment_dispatch(pc_host)
        return Encoder.with_partition(seg, torch.as_tensor(
            self._parts.pop(0)[:seg.nn_idx.shape[0]].astype(np.int32)))

    def encode_frame_front(self, *a, **kw):
        out = super().encode_frame_front(*a, **kw)
        self.rows.append(None if self._tile_rows is None else list(self._tile_rows))
        return out


def _jax_encoder(cfg):
    """A JAX encoder whose segmentations' partitions land in `.parts` and
    whose tile and height state before each frame lands in `.state`."""
    jenc = JEncoder(cfg)
    jenc.parts, jenc.state = [], []
    fetch, frame = jenc.segment_fetch, jenc.encode_frame

    def record_fetch(futures):
        out = fetch(futures)
        jenc.parts.append(np.asarray(out[1][0]))
        return out

    def record_frame(*a, **kw):
        jenc.state.append(dict(hint=jenc._height_hint if hasattr(jenc, "_height_hint") else 0,
                               hints=list(getattr(jenc, "_tile_hints", [])),
                               rows=list(getattr(jenc, "_tile_rows", []))))
        return frame(*a, **kw)

    jenc.segment_fetch, jenc.encode_frame = record_fetch, record_frame
    return jenc


def _port(frames):
    return [PointCloudData(f.positions, f.colors) for f in frames]


@functools.lru_cache(maxsize=None)
def _encode(name: str):
    """(name, frames, JAX encoder, its stream and recons, the port's driven
    encoder, its stream and recons) of one content, encoded once."""
    make, bits, ov = CONTENTS[name]
    frames = make()
    jenc = _jax_encoder(_cfg(JCfg, bits, **ov))
    jstream, jrec = jenc.encode_gof(frames)
    enc = DrivenEncoder(_cfg(VPCCConfig, bits, **ov), jenc.parts, device="cpu")
    stream, rec = enc.encode_gof(_port(frames))
    assert not enc._parts, "a JAX segmentation was not used"
    return name, frames, jenc, jstream, jrec, enc, stream, rec


@pytest.fixture(scope="module", params=list(CONTENTS))
def gof(request):
    return _encode(request.param)


@pytest.fixture(scope="module")
def tiles_gof():
    return _encode("tiles")


def test_stream_equals_reference(gof):
    name, _, jenc, jstream, jrec, enc, stream, rec = gof
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    assert [len(e.patches) for e in enc.last_encoded] == \
        [len(e.patches) for e in jenc.last_encoded]
    assert [(e.width, e.height) for e in enc.last_encoded] == \
        [(e.width, e.height) for e in jenc.last_encoded]
    for a, b in zip(rec, jrec):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))
    if name == "tiles":
        assert enc.last_gpa_choice is None
    else:
        # the data-adaptive choice took the branch this content is for
        assert enc.last_gpa_choice == name
        sizes = {(e.width, e.height) for e in enc.last_encoded}
        assert len(sizes) == 1
        chains = {getattr(p, "gpa_chain", -1) for e in enc.last_encoded for p in e.patches}
        assert -1 not in chains  # pack_global ran over every frame's patches


@pytest.mark.parametrize("which", ["port", "jax"])
def test_cross_decode(gof, which):
    """The port's decoder on the JAX encoder's stream, JAX's on the port's;
    both give the encoder's reconstruction, in order."""
    _, _, _, jstream, _, _, stream, rec = gof
    got = Decoder(device="cpu").decode(jstream) if which == "port" else \
        JDecoder().decode(stream)
    assert len(got) == len(rec)
    for a, b in zip(got, rec):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))


def _atlas_payload(stream: bytes) -> bytes:
    return next(p for t, p in v3c.read_sample_stream(stream) if t == v3c.V3C_AD)


def test_tiles_parse_alone(tiles_gof):
    _, _, _, _, _, enc, stream, _ = tiles_gof
    payload = _atlas_payload(stream)
    _, afps, full, hash_ok, _ = v3c.read_atlas_substream(payload)
    assert afps.num_tiles_minus1 == 1
    assert len(full) == 3 and len(hash_ok) == 6 and all(hash_ok)
    per_tile = [[sum(1 for p in e.patches if p.tile_assigned == t) for e in enc.last_encoded]
                for t in (0, 1)]
    for t in (0, 1):
        _, _, alone, ok, _ = v3c.read_atlas_substream(payload, tile_filter={t})
        assert len(ok) == 3 and all(ok)
        assert [len(x.patches) for x in alone] == per_tile[t]
        assert all(0 < n < len(f.patches) for n, f in zip(per_tile[t], full))


def test_tile_row_start_is_the_last_frames(tiles_gof):
    """ROADMAP F3: the mux writes the encoder's `_tile_rows` after the last
    frame for every frame (reference encoder.py:1059); frame 2's tile 0
    outgrew its band, so frames 0 and 1 carry a `tile_row_start` of tile 1
    above their own band, below their tile-1 patches' rows.  The stream is
    still JAX's byte for byte (test_stream_equals_reference)."""
    _, _, jenc, _, _, enc, stream, _ = tiles_gof
    assert enc.rows == [[0, 16], [0, 16], [0, 32]]
    assert [s["rows"] for s in jenc.state[1:]] == enc.rows[:2]
    for fi, e in enumerate(enc.last_encoded):
        v0 = min(p.v0 for p in e.patches if p.tile_assigned == 1)
        assert v0 == enc.rows[fi][1]
    _, _, alone, _, _ = v3c.read_atlas_substream(_atlas_payload(stream), tile_filter={1})
    for fi, t1 in enumerate(alone):
        assert (t1.frame_index, t1.tile_id, t1.tile_row_start) == (fi, 1, 32)
        assert min(p.pos_y for p in t1.patches) - t1.tile_row_start == (-16 if fi < 2 else 0)


def test_p_frame_front_seeded_from_reference_tile_state(tiles_gof):
    """Frame 2's front end (tree parent 0) alone, from the JAX encoder's
    tile and height state before it (`carry.seed_tile_state`,
    `seed_height_hint`) and frame 0's patches with their tiles."""
    _, frames, jenc, _, _, _, _, _ = tiles_gof
    st = jenc.state[2]
    enc = Encoder(_cfg(VPCCConfig, 6, numMaxTilePerFrame=2), device="cpu")
    carry.seed_height_hint(enc, st["hint"])
    carry.seed_tile_state(enc, st["hints"], st["rows"])
    jparent = jenc.last_encoded[0].patches
    parent = carry.patches_from_dicts([dataclasses.asdict(p) for p in jparent])
    for p, q in zip(parent, jparent):
        p.tile_assigned = q.tile_assigned
    seg = enc.segment_dispatch(_port(frames)[2])
    seg = Encoder.with_partition(seg, torch.as_tensor(
        jenc.parts[2][:seg.nn_idx.shape[0]].astype(np.int32)))
    fr = enc.encode_frame_front(_port(frames)[2], prev_patches=parent, seg=seg)
    want = jenc.last_encoded[2]
    assert (fr.width, fr.height) == (want.width, want.height)
    key = lambda p: (p.u0, p.v0, p.orientation, p.tile_assigned, p.ref_patch_idx, p.size_u,
                     p.size_v, p.u1, p.v1, p.d1)
    assert [key(p) for p in fr.patches] == [key(p) for p in want.patches]
    assert (enc._tile_hints, enc._tile_rows) == (jenc._tile_hints, jenc._tile_rows)


def test_two_gofs_on_one_encoder():
    """The tile ratchets (`_tile_hints`) and the height ratchet carry over
    from one `encode_gof` to the next, as in apps/encode.py's GOF loop: both
    GOFs byte-identical to the JAX encoder's, the state equal after each."""
    frames = _growing()
    gofs = [frames[:2], [frames[2], frames[0]]]
    jenc = _jax_encoder(_cfg(JCfg, 6, numMaxTilePerFrame=2))
    jstreams, jstate = [], []
    for g in gofs:
        jstreams.append(jenc.encode_gof(g)[0])
        jstate.append((list(jenc._tile_hints), list(jenc._tile_rows), jenc._height_hint))
    enc = DrivenEncoder(_cfg(VPCCConfig, 6, numMaxTilePerFrame=2), jenc.parts, device="cpu")
    for g, js, state in zip(gofs, jstreams, jstate):
        assert enc.encode_gof(_port(g))[0] == js
        assert (enc._tile_hints, enc._tile_rows, enc._height_hint) == state
    assert jstate[0][0] != jstate[1][0]  # the second GOF raised a tile's ratchet


def _synthetic(rng, n_frames: int, parents, bits: int, res: int = 16):
    """Per frame a list of (port patch, JAX patch) kwargs-twins with random
    sizes and block-sparse occupancies, each linked (ref_patch_idx) to a
    distinct patch of its tree parent with probability 0.7."""
    out = []
    for fi in range(n_frames):
        ps = []
        n_parent = len(out[parents[fi]]) if fi else 0
        refs = list(rng.permutation(n_parent))
        for i in range(int(rng.integers(4, 12))):
            su, sv = int(rng.integers(1, 60)), int(rng.integers(1, 60))
            d0 = np.full((sv, su), INFINITE_DEPTH, np.int32)
            mask = rng.random(((sv + res - 1) // res, (su + res - 1) // res)) < 0.6
            mask[0, 0] = True
            full = np.kron(mask, np.ones((res, res), bool))[:sv, :su]
            d0[full] = 3
            kw = dict(index=i, view_id=int(rng.integers(0, 6)), normal_axis=0, tangent_axis=2,
                      bitangent_axis=1, projection_mode=0, u1=0, v1=0, d1=0, size_u=su,
                      size_v=sv, size_d=0, occupancy_resolution=res, depth0=d0,
                      depth1=d0.copy(), geo_bits=bits)
            ref = int(refs.pop()) if refs and rng.random() < 0.7 else -1
            ps.append((kw, ref))
        out.append(ps)
    return out


@pytest.mark.parametrize("seed,strategy,n_frames,min_h", [
    (0, 0, 3, 64), (1, 1, 5, 64), (2, 1, 8, 256), (3, 0, 16, 64), (4, 1, 9, 512)])
def test_pack_global_matches_reference(seed, strategy, n_frames, min_h):
    rng = np.random.default_rng(seed)
    enc = Encoder(VPCCConfig(), device="cpu")
    parents = enc.gof_structure(n_frames)[0]
    spec = _synthetic(rng, n_frames, parents, bits=8)
    cfgs = []
    for cls in (VPCCConfig, JCfg):
        c = cls()
        c.packingStrategy, c.minimumImageWidth, c.minimumImageHeight = strategy, 64, min_h
        cfgs.append(c)
    res_, fps = [], []
    for cls, cfg in zip((Patch, JPatch), cfgs):
        fp = []
        for ps in spec:
            frame = []
            for kw, ref in ps:
                p = cls(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                           for k, v in kw.items()})
                p.ref_patch_idx = ref
                frame.append(p)
            fp.append(frame)
        pack = packing.pack_global if cls is Patch else jpacking.pack_global
        size = pack(fp, cfg, parents=parents, preset_height=min_h)
        res_.append((size, [[(p.u0, p.v0, p.orientation, p.gpa_chain) for p in f] for f in fp]))
        fps.append(fp)
    assert res_[0] == res_[1]
    size, rows = res_[0]
    chains = {c for f in rows for *_, c in f}
    # a chain holds at most one patch a frame, and some chains span frames
    assert len(chains) < sum(len(f) for f in rows)
    # the first canvas is as high as the highest union (or the minimum
    # height); a chain below it means the canvas doubled
    members: dict = {}
    for f in fps[0]:
        for p in f:
            members.setdefault(p.gpa_chain, []).append(p.canvas_footprint()[1])
    first = max(max(max(h) for h in members.values()), min_h // 16)
    assert max(p.v0 + p.canvas_footprint()[1] for f in fps[0] for p in f) > first


@pytest.mark.parametrize("field,what", [("globalPatchAllocation", "globalPatchAllocation"),
                                        ("numMaxTilePerFrame", "numMaxTilePerFrame")])
def test_level_path_refuses(field, what):
    cfg = _cfg(VPCCConfig, 6, **{field: 2 if field == "numMaxTilePerFrame" else 1})
    with pytest.raises(NotImplementedError, match=what):
        check_envelope(cfg)
    frames = _person(6, (7,), 2000)
    with pytest.raises(NotImplementedError, match=what):
        Encoder(cfg, device="cpu").encode_gof(frames, parallel=True)
