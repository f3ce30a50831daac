"""PyTorch port vs JAX reference: EOM (enhancedOccupancyMapCode), the
in-between points between D0 and D1.

On the CPU (the plain versions of kernels C and S), from numpy seeds:
* the EOM plane coder (`codecs.encode_eom_plane`) gives the reference's
  bytes and decodes them back;
* a patch built from a component with points between its two layers has
  the reference's EOM map, depth maps and points (`Patch.generate_points`,
  both projection modes), and `rasterize_frame` writes the reference's EOM
  plane;
* kernel C's plain version with EOM layers equals the reference's
  `_recon_phase1` + `_recon_phase2` rows (positions, pixels, layer tags,
  patch ids, boundary flags) on a synthetic atlas with every orientation;
* kernel S's plain extract and inject equal the reference's
  `extract_eom_colors` / `inject_eom_colors`, with an aux shorter than the
  EOM rows;
* `Encoder.encode_gof(device="cpu")`, driven by the JAX encoder's
  partitions, writes the JAX encoder's stream byte for byte under EOM with
  lossy QPs (tests/test_e2e.py:197) and with the raw points and EOM colors
  in the aux substreams (:483), and the port's decoder decodes the JAX
  streams to the JAX decoder's output.
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpcc_tpu import pipeline as jpipe
from vpcc_tpu.core import atlas as jatlas
from vpcc_tpu.core import patch as jpatch
from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu.video import codecs as jcodecs
from vpcc_tpu_torch import pipeline as tpipe
from vpcc_tpu_torch.core import atlas as tatlas
from vpcc_tpu_torch.core import patch as tpatch
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import reconstruct as trec
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import codecs as tcodecs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eom_plane_coder_bytes():
    rng = np.random.default_rng(0)
    eom = np.where(rng.random((64, 96)) < 0.05, rng.integers(1, 8, (64, 96)), 0).astype(np.int32)
    got = tcodecs.encode_eom_plane(eom)
    assert got == jcodecs.encode_eom_plane(eom)
    np.testing.assert_array_equal(tcodecs.decode_eom_plane(got), eom)


def _component(seed: int, view_id: int):
    """A 14 x 11 patch of points along the view's normal axis: a front
    surface and, per pixel, points 1-4 deeper (some beyond the surface
    thickness), colors close enough to pass the D1 color gate."""
    rng = np.random.default_rng(seed)
    na, ta, ba, mode = (int(a) for a in jpatch.VIEW_AXES[view_id][1:])
    pdt = 1 - 2 * mode
    rows = []
    for u in range(14):
        for v in range(11):
            if rng.random() < 0.1:
                continue
            d0 = 60 + int(rng.integers(0, 3))
            for dd in [0] + [k for k in range(1, 6) if rng.random() < 0.45]:
                p = [0, 0, 0]
                p[na], p[ta], p[ba] = d0 + pdt * dd, 20 + u, 30 + v
                rows.append(p)
    pos = np.unique(np.asarray(rows, np.int32), axis=0)
    col = (100 + rng.integers(0, 20, (len(pos), 3))).astype(np.uint8)
    return pos, col


@pytest.mark.parametrize("view_id", [0, 4])
def test_patch_eom_map_points_and_raster(view_id):
    pos, col = _component(view_id, view_id)
    comp = np.arange(len(pos))
    jcfg, tcfg = JCfg(), VPCCConfig()
    for c in (jcfg, tcfg):
        c.enhancedOccupancyMapCode = 1
        c.geometry3dCoordinatesBitdepth = 7
    want = jpatch.build_patch_from_component(0, pos, col, comp, view_id, jcfg)
    got = tpatch.build_patch_from_component(0, pos, col, comp, view_id, tcfg)
    assert got.eom is not None and (got.eom != 0).sum() > 20
    for name in ("eom", "depth0", "depth1"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for a, b in zip(got.generate_points(), want.generate_points()):
        np.testing.assert_array_equal(a, b)
    wf = jatlas.rasterize_frame([want], 64, 64, jcfg)
    gf = tatlas.rasterize_frame([got], 64, 64, tcfg)
    np.testing.assert_array_equal(gf.eom, wf.eom)
    np.testing.assert_array_equal(gf.occupancy, wf.occupancy)


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_points_eom_matches_reference(seed):
    """Kernel C's plain version with eom_bits = 3 EOM layers against the
    reference's phase 1 + phase 2 (smoothing off): D1 equal to D0 on half
    the pixels, projection mode 1 depths clamped at 0 where d1 < D0 + k."""
    rng = np.random.default_rng(seed)
    res, hb, wb, P, eom_bits = 4, 12, 16, 24, 3
    H, W = hb * res, wb * res
    btp = rng.integers(0, P + 1, (hb, wb)).astype(np.int32)
    occ = (rng.random((H, W)) < 0.8).astype(np.uint8)
    g0 = rng.integers(0, 200, (H, W)).astype(np.int32)
    g1 = np.where(rng.random((H, W)) < 0.5, g0, g0 + rng.integers(1, 5, (H, W))).astype(np.int32)
    eom = np.where(rng.random((H, W)) < 0.4, rng.integers(0, 16, (H, W)), 0).astype(np.int32)
    axes = np.array([[0, 2, 1], [1, 2, 0], [2, 0, 1]])
    ax = axes[rng.integers(0, 3, P)]
    ptable = np.stack([
        rng.integers(0, wb // 2, P), rng.integers(0, hb // 2, P),       # u0 v0
        rng.integers(2, 8, P), rng.integers(2, 8, P),                   # size u0 v0
        rng.integers(0, 300, P), rng.integers(0, 300, P),               # u1 v1
        rng.integers(0, 256, P),                                        # d1
        ax[:, 0], ax[:, 1], ax[:, 2],                                   # axes
        rng.integers(0, 2, P), np.arange(P) % 8,                        # mode, orient
        np.arange(P) % 4, np.full(P, 10),                               # axis45, bits
        rng.integers(1, 3, P), rng.integers(1, 3, P),                   # lod x y
    ], 1).astype(np.int32)
    j = lambda a: jnp.asarray(a)
    pts, valid, pix, pid, bnd, cnt = jpipe._recon_phase1(
        j(occ), j(g0), j(g1), j(btp), j(ptable), res, eom=j(eom), eom_bits=eom_bits)
    n = int(cnt)
    pos, vv, pixc, layc, pidc, bndc = (np.asarray(a)[:n] for a in jpipe._recon_phase2(
        pts, valid, pix, pid, bnd, jnp.float32(64.0), n, False, 8, 10))
    t = lambda a: torch.as_tensor(a)
    got = trec.generate_points(t(occ), t(g0), t(g1), t(btp), t(ptable), res,
                               eom=t(eom), eom_bits=eom_bits)
    assert vv.all() and got.pos.shape[0] == n and (layc == 2).sum() > 500
    for name, want in (("pos", pos), ("pix", pixc), ("layer", layc), ("pid", pidc),
                       ("bnd", bndc)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want, err_msg=name)


@pytest.mark.parametrize("n_aux", ["all", "short"])
def test_extract_inject_eom_colors(n_aux):
    rng = np.random.default_rng(3)
    n = 5000
    layer = rng.choice([0, 1, 2], n, p=[0.6, 0.3, 0.1]).astype(np.int32)
    col = rng.integers(0, 256, (n, 3)).astype(np.int32)
    valid = jnp.ones(n, bool)
    m = int((layer == 2).sum())
    want = np.asarray(jpipe.extract_eom_colors(jnp.asarray(layer), valid, jnp.asarray(col),
                                               1024 * 8))[:m]
    got = tpipe.extract_eom_colors(torch.as_tensor(layer), torch.as_tensor(col))
    np.testing.assert_array_equal(got.numpy(), want)
    aux = rng.integers(0, 256, (m if n_aux == "all" else m // 3, 3)).astype(np.uint8)
    want = np.asarray(jpipe.inject_eom_colors(jnp.asarray(layer), valid, jnp.asarray(col),
                                              jnp.asarray(aux)))
    got = tpipe.inject_eom_colors(torch.as_tensor(layer), torch.as_tensor(col),
                                  torch.as_tensor(aux))
    np.testing.assert_array_equal(got.numpy(), want)


CASES = {
    # tests/test_e2e.py:197: EOM under lossy QPs, the EOM rows inherit T0
    "eom_lossy": (6, 6000, dict(geometryQP=22, attributeQP=30, enhancedOccupancyMapCode=1)),
    # tests/test_e2e.py:483: raw points and EOM colors in the aux substreams
    "eom_aux": (7, 12000, dict(geometryQP=4, attributeQP=4, rawPointsPatch=1,
                               useRawPointsSeparateVideo=1, enhancedOccupancyMapCode=1,
                               flagColorPreSmoothing=0, flagGeometrySmoothing=0,
                               gridSmoothing=0)),
}


def encode_both(bits: int, n_samples: int, overrides: dict):
    """One 7- or 6-bit person frame through the JAX encoder and, driven by
    its partitions, the port's: (source, JAX encoder, JAX stream, port
    encoder, port stream, port reconstruction)."""
    def cfg(cls):
        c = cls()
        for k, v in dict(geometry3dCoordinatesBitdepth=bits, resolution=(1 << bits) - 1,
                         minimumImageWidth=1 << bits, minimumImageHeight=1 << bits,
                         iterationCountRefineSegmentation=10, **overrides).items():
            setattr(c, k, v)
        return c

    src = make_person_cloud(bits=bits, n_samples=n_samples, seed=3)
    jenc = JEncoder(cfg(JCfg))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    jstream, _ = jenc.encode_gof([src])
    enc = Encoder(cfg(VPCCConfig), device="cpu")
    seg = enc.segment_dispatch(src)
    seg = Encoder.with_partition(seg, torch.as_tensor(parts[0][:seg.nn_idx.shape[0]]
                                                      .astype(np.int32)))
    stream, recon = enc.encode_gof([src], segs=[seg])
    return src, jenc, jstream, enc, stream, recon


@pytest.mark.parametrize("case", list(CASES))
def test_encode_gof_eom_stream_equals_reference(case):
    src, jenc, jstream, enc, stream, recon = encode_both(*CASES[case])
    e = enc.last_encoded[0]
    assert (e.geometry.recon.layer == 2).sum() > 100
    assert (e.eom_colors is not None) == (case == "eom_aux")
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    want = JDecoder().decode(jstream)[0]
    got = Decoder(device="cpu").decode(jstream)[0]
    for a, b in ((got, want), (recon[0], want)):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(b.colors))
