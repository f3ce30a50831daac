"""PyTorch port vs JAX reference: the 11-bit geometry path (vox11, the CTC's
S27/S28 class).

Every cloud lies in the 11-bit coordinate range: small clouds shifted by
+1200, as tests/test_e2e.py `test_vox11_roundtrip` does.  The port runs on
the CPU (the plain versions of kernels E, G and M); the JAX package on the
CPU.  Everything compared here is integer or host numpy, so it must be
identical:
* `build_grid` (the unpacked (N, 3) table) field by field, and `knn` /
  `nearest` on it;
* `cc_round_voxel`, the full-graph CC round;
* `_generate_patches_knn` (the k-NN coverage rounds) on the reference's
  partitions: the patch list and the per-point squared distances;
* `exact_matches` + `transfer_colors` (`_blend`);
* one frame through the whole encoder: the stream byte for byte, both
  decoders on both streams, and `compute_metrics(grid_bits=11)`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_neighbors import _clouds
from vpcc_tpu.core.pointcloud import PAD_COORD, from_host, shape_bucket
from vpcc_tpu.decoder import Decoder as JDecoder
from vpcc_tpu.encoder import Encoder as JEncoder
from vpcc_tpu.ops import cc as jcc, neighbors as jn, recolor as jrecolor, voxelize as jv
from vpcc_tpu.ops.metrics import compute_metrics as j_metrics
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu.utils.synthetic import make_sphere_cloud
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops import cc as tcc, neighbors as tn, recolor as trecolor
from vpcc_tpu_torch.ops.metrics import compute_metrics as t_metrics
from vpcc_tpu_torch.utils.checksum import patches_md5
from vpcc_tpu_torch.utils.config import VPCCConfig

BITS = 11
SHIFT = 1200
CAP = 8192
METRICS_PSNR_TOL_DB = 1e-3   # chip_smoke.py's, for the float32-vs-float64 PSNR sums


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def sphere11(n_samples: int = 25000, seed: int = 0, bits: int = 8) -> PointCloudData:
    """A sphere surface on a `bits`-bit grid moved into the 11-bit range."""
    base = make_sphere_cloud(bits=bits, n_samples=n_samples, seed=seed)
    return PointCloudData(base.positions.astype(np.int32) + SHIFT, base.colors)


def _cfg(cls):
    cfg = cls()
    for k, v in dict(geometry3dCoordinatesBitdepth=BITS, resolution=(1 << BITS) - 1,
                     minimumImageWidth=256, minimumImageHeight=256,
                     gridBasedSegmentation=1, occupancyPrecision=2,
                     iterationCountRefineSegmentation=10).items():
        setattr(cfg, k, v)
    return cfg


# ---------------------------------------------------------------------------
# the unpacked grid and its k-NN


@pytest.fixture(scope="module")
def clouds():
    """tests/test_torch_neighbors.py's clouds (a sphere, a solid block that
    overfills the 8^3-voxel cells, a spacing-2 lattice of ties), shifted
    into the 11-bit range and padded to CAP with PAD_COORD rows."""
    out = {}
    for name, pts in _clouds().items():
        pos = np.full((CAP, 3), PAD_COORD, np.int32)
        pos[: len(pts)] = pts.astype(np.int32) + SHIFT
        out[name] = pos
    return out


def test_build_grid_11bit_matches_reference(clouds):
    for name, pos in clouds.items():
        jg = jn.build_grid(jnp.asarray(pos), BITS)
        tg = tn.build_grid(torch.as_tensor(pos), BITS)
        assert not tg.packed and tuple(tg.table.shape) == (CAP, 3) and tg.cell_bits == 3
        for f in ("order", "starts", "table"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f"{name}.{f}")


@pytest.mark.parametrize("k,bucket", [(1, 8), (8, 6), (16, 6), (64, 6)])
def test_knn_11bit_matches_reference(clouds, k, bucket):
    """Queries: the cloud (padding rows included) plus random points around
    it, some outside the 11-bit grid."""
    rng = np.random.default_rng(k)
    extra = rng.integers(SHIFT - 12, SHIFT + 140, (CAP // 4, 3)).astype(np.int32)
    extra[:64, 0] = rng.integers(2040, 2060, 64)
    extra[64:128, 1] = rng.integers(-8, 0, 64)
    for name, pos in clouds.items():
        q = np.concatenate([pos, extra])[:CAP]
        jg = jn.build_grid(jnp.asarray(pos), BITS)
        ji, jd = jn.knn(jg, None, jnp.asarray(q), k=k, bucket=bucket)
        tg = tn.build_grid(torch.as_tensor(pos), BITS)
        ti, td = tn.knn(tg, torch.as_tensor(q), k=k, bucket=bucket)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"{name} d2")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"{name} idx")
        if k == 1:
            ni, nd = tn.nearest(tg, torch.as_tensor(q), bucket=bucket)
            np.testing.assert_array_equal(nd.numpy(), np.asarray(jd)[:, 0])
            np.testing.assert_array_equal(ni.numpy(), np.asarray(ji)[:, 0])
        if name == "dense_block":
            # 8^3-voxel cells hold up to 512 points: the window truncates, and
            # a wider one finds nearer neighbours for some queries
            _, full = tn.knn(tg, torch.as_tensor(q), k=k, bucket=200)
            assert (full.numpy()[: 14 ** 3] < td.numpy()[: 14 ** 3]).any()
        if name == "lattice" and k > 1:
            d = td.numpy()[: 17 ** 3]
            assert (np.diff(d, axis=1) == 0).any()


# ---------------------------------------------------------------------------
# the full-graph CC round


def test_cc_round_voxel_matches_reference():
    """A voxelized 11-bit sphere, its voxel k-NN graph (k=16, bucket 6),
    partitions by dominant axis, and a partial per-point active mask."""
    src = sphere11(seed=4)
    P = from_host(src)
    n = src.point_count
    point_vox, vp, nv = jv.voxelize(P.positions, 1, BITS)
    nv = int(nv)
    vpos = vp[: shape_bucket(nv)]
    idx, d2 = jn.knn(jn.build_grid(vpos, BITS), vpos, vpos, k=16, bucket=6)
    valid = (d2 < jn.MAX_DIST2) & (vpos[:, 0] != PAD_COORD)[:, None]
    vh = np.asarray(vpos)
    c = vh[:nv].mean(0)
    part = np.zeros(len(vh), np.int32)
    part[:nv] = np.argmax(np.abs(vh[:nv] - c), axis=1)
    rng = np.random.default_rng(1)
    act = np.zeros(P.positions.shape[0], bool)
    act[:n] = rng.random(n) < 0.7
    want = np.asarray(jcc.cc_round_voxel(idx, valid, jnp.asarray(part), point_vox,
                                         jnp.asarray(act), vcap=len(vh)))[:n]
    h = lambda a: _t(np.asarray(a)[:nv])
    got = tcc.cc_round_voxel(h(idx), h(valid), h(part), _t(np.asarray(point_vox)[:n]),
                             _t(act[:n]))
    # the sentinel of an inactive voxel is the row count: JAX's vcap, the port's nv
    want = np.where(want >= len(vh), nv, want)
    np.testing.assert_array_equal(got.numpy(), want)
    labels = want[want < nv]
    assert 0 < len(labels) < n and len(np.unique(labels)) >= 6


# ---------------------------------------------------------------------------
# grid smoothing (kernel D) at 11-bit magnitudes


def test_grid_smooth_11bit_matches_reference():
    """Dense clusters of points with mixed patch ids near the top of the
    11-bit range: the trilinear centroid's float32 rounding there depends on
    which of the first two corner products XLA fuses, and the move test on
    how the squared distance is formed, so every position must equal the
    reference's (this data moves ~110k points; accumulating the centroid
    with the first add unfused changes one of them)."""
    from vpcc_tpu.ops import smoothing as jsmooth
    from vpcc_tpu_torch.ops import smoothing as tsmooth

    rng = np.random.default_rng(1)
    m = 400_000
    centers = rng.integers(1400, 2040, (2000, 3))
    pts = (centers[rng.integers(0, 2000, m)] + rng.integers(-12, 13, (m, 3))).clip(0, 2047)
    pts = pts.astype(np.int32)
    pid = rng.integers(0, 40, m).astype(np.int32)
    bnd = rng.random(m) < 0.7
    want = np.asarray(jsmooth.smooth_point_cloud_grid(
        jnp.asarray(pts), jnp.ones(m, bool), jnp.asarray(pid), jnp.asarray(bnd), 4.0, 8, BITS))
    got = tsmooth.smooth_point_cloud_grid_plain(_t(pts), _t(pid), _t(bnd), 4.0, 8, BITS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != pts).any(1).sum() > 100_000


# ---------------------------------------------------------------------------
# the k-NN coverage rounds


def test_generate_patches_knn_matches_reference():
    """Patch rounds of an 11-bit frame driven by the reference's voxel
    partitions: identical patches and coverage distances."""
    src = sphere11(seed=0)
    jenc = JEncoder(_cfg(JCfg))
    part_pt, graph, _ = jenc.segment(src)
    j_patches, j_dist2 = jenc.generate_patches(src, part_pt, graph)
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    seg = enc.segment_dispatch(src)
    nv = seg.nn_idx.shape[0]
    seg = Encoder.with_partition(seg, _t(np.asarray(graph[0])[:nv].astype(np.int32)))
    part, graph_t, _ = Encoder.segment_fetch(seg)
    np.testing.assert_array_equal(part, np.asarray(part_pt)[: src.point_count])
    patches, dist2 = enc.generate_patches(src, part, graph_t)
    assert len(patches) == len(j_patches) > 6
    assert [dataclasses.asdict(p).keys() for p in patches] == \
        [dataclasses.asdict(p).keys() for p in j_patches]
    assert patches_md5(patches) == patches_md5(j_patches)
    np.testing.assert_array_equal(dist2, j_dist2)
    assert dist2.dtype == np.float64 and (dist2 > 0).any() and np.isfinite(dist2).all()


# ---------------------------------------------------------------------------
# recolor: host exact matching and the uncompacted blend


@pytest.fixture(scope="module")
def recolor_clouds():
    """Source: an 11-bit sphere.  Targets: half of its positions verbatim
    (exact twins), the rest jittered by up to 2 voxels (mostly without a
    twin) and a few outside the grid, shuffled."""
    rng = np.random.default_rng(3)
    src = sphere11(n_samples=30000, seed=5)
    sp, sc = src.positions.astype(np.int32), src.colors.astype(np.uint8)
    n = sp.shape[0]
    pick = rng.permutation(n)[: int(0.9 * n)]
    n_ex = len(pick) // 2
    jit = sp[pick[n_ex:]] + rng.integers(-2, 3, (len(pick) - n_ex, 3))
    far = np.full((20, 3), 2047, np.int32) + np.arange(20, dtype=np.int32)[:, None]
    tp = np.concatenate([sp[pick[:n_ex]], jit, far]).astype(np.int32)
    return sp, sc, tp[rng.permutation(len(tp))]


@pytest.mark.parametrize("k_bwd", [1, 0])
def test_transfer_colors_11bit_matches_reference(recolor_clouds, k_bwd):
    sp, sc, tp = recolor_clouds
    j_idx, j_has = jrecolor.exact_matches(sp, tp, sp.shape[0], BITS)
    t_idx, t_has = trecolor.exact_matches(sp, tp, sp.shape[0], BITS)
    np.testing.assert_array_equal(t_has, j_has)
    np.testing.assert_array_equal(t_idx, j_idx)
    kw = dict(grid_bits=BITS, k=8, k_bwd=k_bwd, max_geom_d2_fwd=1000.0,
              max_geom_d2_bwd=1000.0, max_color_d2_fwd=1000.0, dist_offset_fwd=4.0)
    want = np.asarray(jrecolor.transfer_colors(
        jnp.asarray(sp), jnp.asarray(sc.astype(np.int32)), jnp.asarray(sp.shape[0]),
        jnp.asarray(tp), jnp.asarray(tp.shape[0]), jnp.asarray(j_idx), jnp.asarray(j_has), **kw))
    got = trecolor.transfer_colors(_t(sp), _t(sc), _t(tp), _t(t_idx), _t(t_has), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # exact and inexact targets, unmatched sources all occur
    matched = np.zeros(sp.shape[0], bool)
    matched[j_idx[j_has]] = True
    assert j_has.any() and (~j_has).any() and (~matched).any()


# ---------------------------------------------------------------------------
# the whole slice: one 11-bit frame through encoder, decoders and metrics


@pytest.fixture(scope="module")
def slice_run():
    """The JAX encoder's `encode_gof` of one 11-bit frame and its refined
    voxel partitions; the port's `encode_gof` of the same frame driven by
    them.  The frame is a 7-bit sphere (~7k points) moved into the 11-bit
    range, whose atlas fits the 256x256 minimum: the plain wavefront encode
    of four such planes is most of the module's time.  Tensors are dropped
    when the module ends."""
    src = sphere11(n_samples=8000, seed=0, bits=7)
    jenc = JEncoder(_cfg(JCfg))
    parts = []
    fetch = jenc.segment_fetch

    def record(futures):
        out = fetch(futures)
        parts.append(np.asarray(out[1][0]))
        return out

    jenc.segment_fetch = record
    j_stream, j_recon = jenc.encode_gof([src])
    enc = Encoder(_cfg(VPCCConfig), device="cpu")
    seg = enc.segment_dispatch(src)
    nv = seg.nn_idx.shape[0]
    seg = Encoder.with_partition(seg, _t(parts[0][:nv].astype(np.int32)))
    stream, recon = enc.encode_gof([src], segs=[seg])
    yield src, (j_stream, j_recon), (stream, recon), enc
    del seg, enc


def _same_cloud(a, b):
    return (a.point_count == b.point_count and np.array_equal(a.positions, b.positions)
            and np.array_equal(a.colors, b.colors))


def test_vox11_encode_stream_equals_reference(slice_run):
    src, (j_stream, j_recon), (stream, recon), enc = slice_run
    assert enc.last_encoded[0].width == 256 and len(enc.last_encoded[0].patches) > 6
    assert stream == j_stream, (len(stream), len(j_stream))
    assert _same_cloud(recon[0], j_recon[0])


def test_vox11_cross_decode(slice_run):
    """Each decoder decodes each stream to that encoder's reconstruction."""
    _, (j_stream, j_recon), (stream, recon), _ = slice_run
    assert _same_cloud(JDecoder().decode(stream)[0], recon[0])
    assert _same_cloud(Decoder(device="cpu").decode(j_stream)[0], j_recon[0])


def test_vox11_metrics_match_reference(slice_run):
    src, _, (_, recon), _ = slice_run
    args = (src.positions.astype(np.int32), src.colors,
            recon[0].positions.astype(np.int32), recon[0].colors)
    want = j_metrics(*args, resolution=(1 << BITS) - 1, grid_bits=BITS)
    got = t_metrics(*args, resolution=(1 << BITS) - 1, grid_bits=BITS, device="cpu")
    assert (got.c2c_mse, got.c2c_hausdorff) == (want.c2c_mse, want.c2c_hausdorff)
    for a, b in [(got.c2c_psnr, want.c2c_psnr), (got.c2p_psnr, want.c2p_psnr),
                 *zip(got.color_psnr, want.color_psnr)]:
        assert np.isfinite(a) and abs(a - b) <= METRICS_PSNR_TOL_DB, (a, b)

