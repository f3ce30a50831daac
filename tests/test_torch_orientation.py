"""PyTorch port vs JAX reference: the orientation of the normals
(normalOrientation 0 / 2 / 3 / 4; kernel X's plain versions on the CPU).

* Given the reference's PCA normals of the 8-bit person of
  tests/test_torch_segmentation.py, `normals.orient_by_mode` is identical
  to the reference's `compute_normals(mode=...)` for modes 0, 2 (two
  viewpoints), 3 and 4.
* Crafted probes hold the float order at each call site: a viewpoint dot
  of exactly 0 and +-1 ulp; flood votes of exactly 1e-6 and +-1 ulp; flood
  votes whose 16 terms cancel so that the sum order decides (sequential
  from k = 0, not pairwise); flood votes whose 3-term dot cancels (XLA's
  fma chain, not an unfused sum).
* The seed: the reference's int32 key wraps for z >= 512 (10-bit positions
  without voxels), so the seed is the highest point below z = 512; where
  every key wraps the padded rows' key 0 wins and every row takes the
  radial sign (ROADMAP F3); ties take the first row.
* From the voxel cloud alone, the port's partitions under each mode agree
  with the reference's at a rate of at least AGREEMENT_FLOOR (printed).
All comparisons but the last are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpcc_tpu.core.pointcloud import PAD_COORD, from_host, shape_bucket
from vpcc_tpu.ops import neighbors as jn, normals as jno, segmentation as js, voxelize as jv
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu.utils.synthetic import make_person_cloud, make_sphere_cloud
from vpcc_tpu_torch.ops import neighbors as tn, normals as tno, segmentation as ts

AGREEMENT_FLOOR = 0.998
BITS = 8
K = 16
f32 = np.float32
VIEWPOINTS = ((0.0, 0.0, 0.0), (128.5, 300.0, -20.25))
MODES = [(0, VIEWPOINTS[0]), (2, VIEWPOINTS[0]), (2, VIEWPOINTS[1]), (3, VIEWPOINTS[0]),
         (4, VIEWPOINTS[0])]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's stages on the 8-bit person's voxels, over the
    padded shape bucket as its encoder runs them."""
    pc = make_person_cloud(bits=BITS, n_samples=60000, seed=3)
    _, vp, nv = jv.voxelize(from_host(pc).positions, 1, BITS)
    nv = int(nv)
    vpos = vp[: shape_bucket(nv)]
    idx, d2 = jn.knn(jn.build_grid(vpos, BITS), vpos, vpos, k=K, bucket=6)
    rows = vpos[:, 0] != PAD_COORD
    valid = (d2 < jn.MAX_DIST2) & rows[:, None]
    orients = jnp.asarray(js.get_orientations(0))
    out = dict(nv=nv, pos=np.asarray(vpos)[:nv], idx=np.asarray(idx)[:nv],
               valid=np.asarray(valid)[:nv], pca=np.asarray(jno.pca_normals(vpos, idx, valid))[:nv])
    for mode, vpt in MODES:
        nrm = jno.compute_normals(vpos, idx, valid, rows, mode=mode, viewpoint=vpt)
        p0 = js.initial_segmentation(nrm, orients, jnp.ones(6, jnp.float32))
        p1 = js.refine_segmentation(nrm, p0, idx, valid, orients, 3.0, 10)
        out[(mode, vpt)] = (np.asarray(nrm)[:nv], np.asarray(p1)[:nv])
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("mode,vpt", MODES)
def test_orientation_identical_given_reference_pca(ref, mode, vpt):
    rows = torch.ones(ref["nv"], dtype=torch.bool)
    got = tno.orient_by_mode(_t(ref["pos"]), _t(ref["pca"]), _t(ref["idx"]), _t(ref["valid"]),
                             rows, mode, vpt)
    np.testing.assert_array_equal(got.numpy(), ref[(mode, vpt)][0])
    if mode == 4:
        print(f"flood: {tno.last_flood_sweeps} sweeps signed voxels")
        assert 0 < tno.last_flood_sweeps < tno.FLOOD_MAX_SWEEPS


@pytest.mark.parametrize("mode,vpt", MODES)
def test_partition_agreement_end_to_end(ref, mode, vpt):
    """From the voxel cloud alone: the port's k-NN, normals and partitions."""
    pos = _t(ref["pos"])
    idx, d2 = tn.knn(tn.build_grid(pos, BITS), pos, k=K, bucket=6)
    valid = d2 < tn.MAX_DIST2
    nrm = tno.compute_normals(pos, idx, valid, torch.ones(ref["nv"], dtype=torch.bool),
                              mode=mode, viewpoint=vpt)
    o, w = _t(js.get_orientations(0)), torch.ones(6, dtype=torch.float32)
    p1 = ts.refine_segmentation(nrm, ts.initial_segmentation(nrm, o, w), idx, valid, o, 3.0, 10)
    a = np.mean(p1.numpy() == ref[(mode, vpt)][1])
    print(f"mode {mode} viewpoint {vpt}: refined partition agreement {a:.6f} of {ref['nv']}")
    assert a >= AGREEMENT_FLOOR


def test_viewpoint_dot_zero_and_one_ulp():
    """n . (vp - pos) = 3 - 3 * n1: exactly 0 (sign +1) and +-1 ulp."""
    n1 = [f32(1.0), np.nextafter(f32(1.0), f32(2.0)), np.nextafter(f32(1.0), f32(0.0))]
    n = np.array([[1.0, v, 0.5] for v in n1], f32)
    pos = np.array([[7, 10, 4]] * 3, np.int32)
    vpt = (10.0, 7.0, 4.0)   # vp - pos = (3, -3, 0)
    want = np.asarray(jno.orient_normals_viewpoint(jnp.asarray(n), jnp.asarray(pos),
                                                   jnp.asarray(vpt, jnp.float32)))
    got = tno.orient_normals_viewpoint(_t(n), _t(pos), vpt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sign(got[:, 0]), [1, -1, 1])


def _probe_graph(neigh_normals, probe_normals, valid_k):
    """A seed (row 0, the highest point, normal +z) that every helper
    neighbours, so that the helpers are signed +1 in sweep 1; then probe
    row p's vote in sweep 2 is sum_k dot(helper_k, probe) over its valid
    helpers.  A probe whose vote stays within 1e-6 keeps sign 0 and takes
    the radial sign, +1 here (probes sit at large x, normals along +x)."""
    M = len(probe_normals)
    V = 1 + M * (K + 1)
    rng = np.random.default_rng(0)
    pos = np.zeros((V, 3), np.int32)
    nrm = np.zeros((V, 3), f32)
    idx = np.zeros((V, K), np.int32)
    val = np.zeros((V, K), bool)
    pos[0], nrm[0] = (0, 0, 500), (0, 0, 1)
    for i in range(M):
        base = 1 + i * (K + 1)
        p = base + K
        for k in range(K):
            h = base + k
            pos[h] = (rng.integers(0, 50), rng.integers(0, 50), rng.integers(0, 100))
            nrm[h] = neigh_normals[i][k]
            val[h, 0] = True
            idx[p, k] = h
            val[p, k] = valid_k[i][k]
        pos[p] = (1000, 10, 10)
        nrm[p] = probe_normals[i]
    return pos, nrm, idx, val, np.array([1 + i * (K + 1) + K for i in range(M)])


def _flood_both(pos, nrm, idx, val, valid=None, pad=0):
    """The reference's flood over the arrays (plus `pad` padded rows) and
    the port's on the unpadded arrays."""
    V = len(pos)
    if valid is None:
        valid = np.ones(V, bool)
    jp = np.concatenate([pos, np.full((pad, 3), PAD_COORD, np.int32)])
    jnrm = np.concatenate([nrm, np.tile(np.array([[0, 0, 1]], f32), (pad, 1))])
    jidx = np.concatenate([idx, np.zeros((pad, idx.shape[1]), np.int32)])
    jval = np.concatenate([val, np.zeros((pad, idx.shape[1]), bool)])
    jvalid = np.concatenate([valid, np.zeros(pad, bool)])
    want = np.asarray(jno.orient_normals_spanning_tree(
        *map(jnp.asarray, (jp, jnrm, jidx, jval, jvalid))))[:V]
    got = tno.orient_normals_spanning_tree(_t(pos), _t(nrm), _t(idx), _t(val), _t(valid),
                                           pad_rows=pad > 0).numpy()
    return want, got


def test_flood_vote_threshold_and_sum_order():
    rng = np.random.default_rng(1)
    terms = []
    # |vote| exactly 1e-6 (not signed), and one ulp either side
    e6 = f32(1e-6)
    for t in (e6, np.nextafter(e6, f32(1)), np.nextafter(e6, f32(0))):
        for sgn in (1, -1):
            terms.append(np.array([sgn * t] + [0] * (K - 1), f32))
    n_limit = len(terms)
    # 16 terms with a large pair that cancels: the sum order decides
    for _ in range(600):
        t = rng.choice([-1, 1], K) * rng.integers(1, 9, K).astype(f32) * f32(0.25)
        a, b = rng.choice(K, 2, replace=False)
        big = f32(2.0 ** rng.integers(20, 27))
        t[a], t[b] = big, -big * f32(rng.choice([1, 1, 0.5]))
        terms.append(t.astype(f32))
    T = np.array(terms)
    neigh = [[(T[i, k], 0, 1) for k in range(K)] for i in range(len(T))]
    probes = [(1, 0, 0)] * len(T)
    pos, nrm, idx, val, P = _probe_graph(neigh, probes, np.ones((len(T), K), bool))
    want, got = _flood_both(pos, nrm, idx, val)
    np.testing.assert_array_equal(got, want)
    signs = np.sign(got[P, 0])
    np.testing.assert_array_equal(signs[:n_limit], [1, 1, 1, -1, 1, 1])

    def decide(v):
        return np.where(np.abs(v) > e6, np.where(v < 0, -1, 1), 1)

    seq = np.zeros(len(T), f32)
    for k in range(K):
        seq = (seq + T[:, k]).astype(f32)
    pair = T.copy()
    while pair.shape[1] > 1:
        pair = (pair[:, 0::2] + pair[:, 1::2]).astype(f32)
    np.testing.assert_array_equal(decide(seq), signs)
    assert (decide(pair[:, 0]) != signs).sum() > 0   # the probes tell the orders apart


def test_flood_dot_order():
    rng = np.random.default_rng(2)
    neigh, probes = [], []
    for _ in range(300):
        h = (rng.normal(size=3) * 3e3).astype(f32)
        h[2] = abs(h[2]) + f32(10)   # signed +1 by the seed
        p = (rng.normal(size=3) * 3e3).astype(f32)
        p[2] = f32(-(np.float64(h[0]) * p[0] + np.float64(h[1]) * p[1]) / h[2])
        for _ in range(rng.integers(-3, 4)):
            p[2] = np.nextafter(p[2], f32(np.inf))
        neigh.append([h] * K)
        probes.append(p)
    one = np.zeros((len(probes), K), bool)
    one[:, 0] = True
    pos, nrm, idx, val, P = _probe_graph(neigh, probes, one)
    want, got = _flood_both(pos, nrm, idx, val)
    np.testing.assert_array_equal(got, want)
    hh, pp = np.array([n[0] for n in neigh]), np.array(probes)
    naive = ((hh[:, 0] * pp[:, 0] + hh[:, 1] * pp[:, 1]) + hh[:, 2] * pp[:, 2]).astype(f32)
    naive_sign = np.where(np.abs(naive) > f32(1e-6), np.where(naive < 0, -1, 1),
                          np.sign(want[P, 0]))
    assert (naive_sign != np.sign(want[P, 0])).sum() > 0


def _sphere10(z0: int):
    """A 10-bit sphere shell with its k-NN, positions offset to z0 in z."""
    s = make_sphere_cloud(bits=7, n_samples=6000, seed=5)
    p = s.positions.astype(np.int32) * 2 + np.array([100, 100, z0], np.int32)
    pc = from_host(PointCloudData(p, s.colors))
    cap = pc.positions.shape[0]
    idx, d2 = jn.knn(jn.build_grid(pc.positions, 10), pc.positions, pc.positions, k=K,
                     bucket=12)
    rows = pc.positions[:, 0] != PAD_COORD
    valid = (d2 < jn.MAX_DIST2) & rows[:, None]
    nrm = jno.pca_normals(pc.positions, idx, valid)
    n = len(p)
    return p, np.asarray(nrm)[:n], np.asarray(idx)[:n], np.asarray(valid)[:n], cap - n


@pytest.mark.parametrize("z0", [300, 700])
def test_seed_key_wraps_in_int32(z0):
    """z0 = 300: the shell spans z = 300..554, so the keys of its top wrap
    negative and the seed is the highest point below z = 512; z0 = 700:
    every key wraps, the padded rows win and every row is radial."""
    p, nrm, idx, val, pad = _sphere10(z0)
    assert pad > 0
    key = tno.seed_keys(_t(p), torch.ones(len(p), dtype=torch.bool)).numpy()
    assert (key < 0).any() and ((key >= 0).any() == (z0 == 300))
    want, got = _flood_both(p, nrm, idx, val, pad=pad)
    np.testing.assert_array_equal(got, want)
    seed, _ = tno.flood_seed(_t(p), _t(nrm), torch.ones(len(p), dtype=torch.bool), True)
    radial = tno.radial_signs(_t(p), _t(nrm), torch.ones(len(p), dtype=torch.bool)).numpy()
    if z0 == 300:
        assert p[seed, 2] == p[p[:, 2] < 512, 2].max()
        assert tno.last_flood_sweeps > 0
    else:
        assert seed == -1 and tno.last_flood_sweeps == 0
        np.testing.assert_array_equal(got, nrm * radial[:, None])


def test_seed_ties_take_the_first_row():
    """Duplicate top positions with opposite normals: the first row seeds;
    an invalid row's key 0 ties with a valid row at the origin."""
    p, nrm, idx, val, _ = _sphere10(300)
    top = int(np.argmax(tno.seed_keys(_t(p), torch.ones(len(p), dtype=torch.bool)).numpy()))
    p2 = np.concatenate([p[:top], p[top:top + 1], p[top:]])   # row top duplicated
    n2 = np.concatenate([nrm[:top], -nrm[top:top + 1], nrm[top:]])
    i2 = np.concatenate([idx[:top], idx[top:top + 1], idx[top:]])
    i2 = np.where(i2 >= top, i2 + 1, i2).astype(np.int32)
    v2 = np.concatenate([val[:top], val[top:top + 1], val[top:]])
    want, got = _flood_both(p2, n2, i2, v2)
    np.testing.assert_array_equal(got, want)
    assert tno.flood_seed(_t(p2), _t(n2), torch.ones(len(p2), dtype=torch.bool), False)[0] == top
    # a valid row at the origin (key 0) before an invalid row (key 0), all
    # other keys negative: the origin row seeds
    p3 = np.array([[0, 0, 0], [5, 5, 600], [6, 5, 600]], np.int32)
    n3 = np.array([[0, 0, -1], [0, 0, 1], [0, 0, 1]], f32)
    valid3 = np.array([True, False, True])
    seed, s = tno.flood_seed(_t(p3), _t(n3), _t(valid3), True)
    assert (seed, s) == (0, -1.0)
