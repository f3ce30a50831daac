"""PyTorch port vs JAX reference: point reconstruction (kernel C) and grid
geometry smoothing (kernel D), plain PyTorch versions on the CPU.

The atlas comes from a real small encode (7-bit sphere, lossy video) made
by the JAX encoder and parsed by the port; synthetic atlases and clouds made
from numpy seeds cover the orientations, 45-degree planes and the float32
borderline cases the real one may miss.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_md_cases import SMOOTH_CASES, smooth_case

from vpcc_tpu import pipeline as jpipe
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.ops import reconstruct as jrec
from vpcc_tpu.ops import smoothing as jsm
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_sphere_cloud
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.core import atlas as tatlas
from vpcc_tpu_torch.decoder import _pdu_to_patch
from vpcc_tpu_torch.device import fma_f32
from vpcc_tpu_torch.ops import reconstruct as trec
from vpcc_tpu_torch.ops import smoothing as tsm
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.video import codecs as tcodecs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def atlas():
    """Frame 0 of a small lossy encode, decoded to the reconstruction's
    inputs by the port's parser and video decoders."""
    cfg = JCfg()
    cfg.geometry3dCoordinatesBitdepth = 7
    cfg.minimumImageWidth = cfg.minimumImageHeight = 128
    cfg.resolution = 127
    cfg.iterationCountRefineSegmentation = 10
    cfg.geometryQP, cfg.attributeQP = 22, 30
    stream, _ = Encoder(cfg).encode_gof([make_sphere_cloud(bits=7, n_samples=25000)])
    vps = occ_sub = tiles = None
    geo = {}
    for utype, payload in v3c.read_sample_stream(stream):
        if utype == v3c.V3C_VPS:
            vps = v3c.V3CParameterSet.read(BitReader(payload))
        elif utype == v3c.V3C_AD:
            tiles = v3c.read_atlas_substream(payload)[2]
        elif utype == v3c.V3C_OVD:
            occ_sub = v3c.VideoSubstream.read(BitReader(payload))
        elif utype == v3c.V3C_GVD:
            s = v3c.VideoSubstream.read(BitReader(payload))
            geo[s.map_index] = s
    tcfg = VPCCConfig()
    patches = [_pdu_to_patch(p, i, vps) for i, p in enumerate(tiles[0].patches)]
    occ = tatlas.upsample_occupancy(
        tcodecs.decode_occupancy(occ_sub.frames[0], tcfg), vps.occupancy_precision)
    g0 = tcodecs.GeometrySubstreamDecoder(tcfg, CPU).decode(geo[0].frames[0])
    g1 = tcodecs.GeometrySubstreamDecoder(tcfg, CPU).decode(geo[1].frames[0], layer_ref=g0)
    res = vps.occupancy_resolution
    btp = tatlas.derive_block_to_patch(occ, patches, occ.shape[1], occ.shape[0], res)
    return dict(occ=occ, g0=g0.numpy(), g1=g1.numpy(), btp=btp, patches=patches,
                ptable=tatlas.patch_table(patches), res=res, bits=7)


def _port_points(occ, g0, g1, btp, ptable, res):
    t = lambda a, dt: torch.as_tensor(np.array(a, dt))
    return trec.generate_points(t(occ, np.uint8), t(g0, np.int32), t(g1, np.int32),
                                t(btp, np.int32), t(ptable, np.int32), res)


def _reference_points(occ, g0, g1, btp, ptable, res):
    """JAX generate_point_cloud + boundary_pixels + stable compaction."""
    pts, valid, pix, pid = (np.asarray(a) for a in jrec.generate_point_cloud(
        jnp.asarray(occ), jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(btp),
        jnp.asarray(ptable), res))
    bnd = np.asarray(jsm.boundary_pixels(jnp.asarray(occ), jnp.asarray(btp))).reshape(-1)
    rows = np.nonzero(valid.reshape(-1))[0]
    return dict(pos=pts.reshape(-1, 3)[rows], pix=pix[rows // 2],
                layer=(rows % 2).astype(np.int32), pid=pid[rows // 2],
                bnd=bnd[rows // 2])


def test_generate_points_matches_pipeline_on_real_atlas(atlas):
    """Kernel C's plain version == the JAX reconstruction seam (phase 1 +
    phase 2 compaction, smoothing off) on a decoded atlas, row for row."""
    a = atlas
    got = _port_points(a["occ"], a["g0"], a["g1"], a["btp"], a["ptable"], a["res"])
    jcfg = JCfg()
    jcfg.flagGeometrySmoothing = 0
    jcfg.occupancyResolution = a["res"]
    r = jpipe.reconstruct_frame_device(a["occ"], [a["g0"], a["g1"]], a["btp"],
                                       a["patches"], jcfg)
    n = r.count
    assert n > 1000 and got.pos.shape[0] == n
    for name in ("pos", "pix", "layer", "pid", "bnd"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(r, name))[:n], err_msg=name)
    assert got.bnd.any() and (got.layer == 1).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_points_all_orientations_and_planes(seed):
    """Seeded synthetic atlas: patches with every orientation, all four
    45-degree plane settings, LOD scaling and both projection modes, on an
    atlas whose occupancy touches the image edge (the boundary test wraps)."""
    rng = np.random.default_rng(seed)
    res, hb, wb, P = 4, 12, 16, 24
    H, W = hb * res, wb * res
    btp = rng.integers(0, P + 1, (hb, wb)).astype(np.int32)
    occ = (rng.random((H, W)) < 0.8).astype(np.uint8)
    g0 = rng.integers(0, 200, (H, W)).astype(np.int32)
    g1 = np.where(rng.random((H, W)) < 0.5, g0, g0 + rng.integers(1, 5, (H, W))).astype(np.int32)
    axes = np.array([[0, 2, 1], [1, 2, 0], [2, 0, 1]])
    ax = axes[rng.integers(0, 3, P)]
    ptable = np.stack([
        rng.integers(0, wb // 2, P), rng.integers(0, hb // 2, P),       # u0 v0
        rng.integers(2, 8, P), rng.integers(2, 8, P),                   # size u0 v0
        rng.integers(0, 300, P), rng.integers(0, 300, P),               # u1 v1
        rng.integers(0, 512, P),                                        # d1
        ax[:, 0], ax[:, 1], ax[:, 2],                                   # axes
        rng.integers(0, 2, P), np.arange(P) % 8,                        # mode, orient
        np.arange(P) % 4, np.full(P, 10),                               # axis45, bits
        rng.integers(1, 3, P), rng.integers(1, 3, P),                   # lod x y
    ], 1).astype(np.int32)
    want = _reference_points(occ, g0, g1, btp, ptable, res)
    got = _port_points(occ, g0, g1, btp, ptable, res)
    for name in ("pos", "pix", "layer", "pid", "bnd"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)


def _smooth_both(pts, pid, bnd, thr, gs, bits):
    M = len(pts)
    want = np.asarray(jsm.smooth_point_cloud_grid(
        jnp.asarray(pts), jnp.ones(M, bool), jnp.asarray(pid), jnp.asarray(bnd),
        jnp.float32(thr), grid_size=gs, grid_bits=bits))
    got = tsm.grid_smooth(torch.as_tensor(pts), torch.as_tensor(pid),
                          torch.as_tensor(bnd), thr, gs, bits).numpy()
    return want, got


def test_grid_smoothing_on_real_reconstruction(atlas):
    a = atlas
    p = _port_points(a["occ"], a["g0"], a["g1"], a["btp"], a["ptable"], a["res"])
    pts, pid, bnd = p.pos.numpy(), p.pid.numpy(), p.bnd.numpy()
    moved = 0
    for thr, gs in ((64.0, 8), (4.0, 4), (1.0, 2)):
        want, got = _smooth_both(pts, pid, bnd, thr, gs, a["bits"])
        np.testing.assert_array_equal(got, want)
        moved += int((want != pts).any(axis=1).sum())
    assert moved > 0


@pytest.mark.parametrize("thr", [1.0, 2.0, 8.0])
def test_grid_smoothing_vox10_borderline(thr):
    """A jittered vox10 sphere whose patch ids change along bands: tens of
    thousands of points move, and at threshold 2 the float32 distance test
    meets rows where an unfused multiply-add would decide the other way
    (the reference's XLA CPU code fuses them)."""
    pc = make_sphere_cloud(bits=10, n_samples=400_000, seed=3)
    rng = np.random.default_rng(int(thr))
    pts = np.clip(pc.positions.astype(np.int32)
                  + rng.integers(-2, 3, pc.positions.shape), 0, 1023).astype(np.int32)
    pid = ((pts[:, 0] // 37 + pts[:, 2] // 53) % 7).astype(np.int32)
    bnd = rng.random(len(pts)) < 0.9
    want, got = _smooth_both(pts, pid, bnd, thr, 8, 10)
    np.testing.assert_array_equal(got, want)
    assert (want != pts).any(axis=1).sum() > 100


@pytest.mark.parametrize("case", SMOOTH_CASES)
def test_grid_smoothing_edge_cases(case):
    """The crafted 7-bit clouds the card's kernel-D tests also run: points at
    the grid's corners (the points' cell box is the grid), one cell, one
    patch, no boundary point, the faces' distance test, gridSize 4 and 16."""
    pts, pid, bnd, thr, gs = smooth_case(case, bits=7)
    with torch_threads(1):
        want, got = _smooth_both(pts, pid, bnd, thr, gs, 7)
    np.testing.assert_array_equal(got, want)
    moved = int((want != pts).any(axis=1).sum())
    assert (moved == 0) == (case in ("one_patch", "no_boundary"))


class torch_threads:
    """torch's intra-op threads set to n inside the block (restored
    afterwards)."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.saved = torch.get_num_threads()
        torch.set_num_threads(self.n)

    def __exit__(self, *exc):
        torch.set_num_threads(self.saved)


def test_fma_f32_single_rounding():
    """fma_f32 == exactly rounded a*b + c, including the halfway cases that
    rounding through float64 would get wrong."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-2e3, 2e3, 4000).astype(np.float32)
    b = rng.uniform(-4e3, 4e3, 4000).astype(np.float32)
    c = rng.uniform(-4e6, 4e6, 4000).astype(np.float32)
    # crafted: a*b exactly halfway between two float32 values, c tiny
    a[:4] = np.float32(4097.0)
    b[:4] = np.float32(4097.0)
    c[:4] = np.array([2.0 ** -30, -(2.0 ** -30), 0.0, 2.0 ** -40], np.float32)
    got = fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()

    def exact(x, y, z):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(v))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        err = [abs(Fraction(float(q)) - v) for q in cands]
        best = min(err)
        ties = [q for q, e in zip(cands, err) if e == best]
        even = [q for q in ties if not (np.float32(q).view(np.int32) & 1)]
        return (even or ties)[0]

    want = np.array([exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(16785410.0) and got[1] == np.float32(16785408.0)
