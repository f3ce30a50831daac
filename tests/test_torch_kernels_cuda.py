"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; every test skips without CUDA.  The file
imports neither JAX nor vpcc_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Inputs are made from numpy seeds; results must be identical.
"""

import numpy as np
import pytest
import torch

from torch_fill_rdo_cases import (HARMONIC_CASES, RDO_CASES, harmonic_case, harmonic_launches,
                                  rdo_case)
from torch_frontier import DILATE_CASES, FLOOD_CASES, dilate_case, flood_case
from torch_md_cases import (PRESMOOTH_CASES, SMOOTH_CASES, presmooth_case, recolor_case,
                            smooth_case)
from vpcc_tpu_torch import device as dev, pipeline
from vpcc_tpu_torch.ops import cc, coverage, neighbors, normals, padding, pbf, plr, recolor
from vpcc_tpu_torch.ops import reconstruct
from vpcc_tpu_torch.ops import segmentation, smoothing
from vpcc_tpu_torch.video import hevc
from vpcc_tpu_torch.video import hevc_tables as tab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), b.cpu())


def _syncs(fn):
    """(fn(), the host synchronisations torch reports for the call under
    sync debug mode "warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("called a synchronizing" in str(w.message) for w in seen)


def _no_sync(fn):
    """fn() under sync debug mode "error": a host wait raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("maxval,qp,big,nbx", [(255, 30, False, 4),
                                               (1023, 8, True, 4),
                                               (511, 20, False, 1)])
def test_wavefront_decode32_kernel(cuda, maxval, qp, big, nbx):
    """Random syntax (every mode, mixed splits); `big` draws levels up to
    the int16 limit so the inverse transform's int32 arithmetic wraps.  A
    one-CU-wide plane leaves every other diagonal empty.  One launch a
    call."""
    rng = np.random.default_rng(qp)
    PT, nby = 3, 3
    nb = nby * nbx
    lim = 32767 if big else 40
    sparse = lambda shape: (rng.integers(-lim, lim + 1, shape)
                            * (rng.random(shape) < 0.1)).astype(np.int16)
    args = [
        rng.integers(0, maxval + 1, (PT, nby * 32, nbx * 32)).astype(np.int32),
        rng.integers(0, 2, (PT, nb)).astype(np.int8),
        rng.integers(0, 36, (PT, nb)).astype(np.int8),
        sparse((PT, nb, 1024)),
        rng.integers(0, 2, (PT, nb, 4)).astype(np.int8),
        rng.integers(0, 36, (PT, nb, 4, 4)).astype(np.int8),
        sparse((PT, nb, 4, 256)),
        np.full(PT, tab.DQ64[qp], np.int32),
        np.full(PT, maxval, np.int32),
    ]
    t = [torch.as_tensor(a, device=cuda) for a in args]
    before = dev.LAUNCHES["wavefront_decode32"]
    got = hevc.wavefront_decode32(*t, nby, nbx)
    assert dev.LAUNCHES["wavefront_decode32"] == before + 1
    _same(got, hevc.wavefront_decode32_plain(*t, nby, nbx))


def _decode_args(rng, cuda, PT, nby, nbx, two_level, maxval, qp, zero_cus=0.0,
                 inter_only=False):
    """Kernel A's arguments on (PT, nby*cu, nbx*cu) planes: random syntax
    (mixed splits, every mode, or only the inter mode), levels up to 200 in
    a tenth of the positions, and a share `zero_cus` of the CUs with no
    level at all."""
    nb = nby * nbx
    cu = 16 if two_level else 32
    mode = lambda shape: (np.full(shape, tab.MODE_INTER, np.int8) if inter_only
                          else rng.integers(0, 36, shape).astype(np.int8))
    zero = rng.random((PT, nb)) < zero_cus

    def levels(shape):
        lv = rng.integers(-200, 201, shape) * (rng.random(shape) < 0.1)
        lv[zero] = 0
        return lv.astype(np.int16)

    ref = rng.integers(0, maxval + 1, (PT, nby * cu, nbx * cu)).astype(np.int32)
    head = [ref, rng.integers(0, 2, (PT, nb)).astype(np.int8)]
    if two_level:
        body = [mode((PT, nb, 4)), levels((PT, nb, 256))]
    else:
        body = [mode((PT, nb)), levels((PT, nb, 1024)),
                rng.integers(0, 2, (PT, nb, 4)).astype(np.int8), mode((PT, nb, 4, 4)),
                levels((PT, nb, 4, 256))]
    tail = [np.full(PT, tab.DQ64[qp], np.int32), np.full(PT, maxval, np.int32)]
    return [torch.as_tensor(a, device=cuda) for a in head + body + tail]


@pytest.mark.parametrize("two_level,PT,nby,nbx,zero_cus,inter_only", [
    (False, 48, 3, 5, 0.0, False),   # 144 CUs on diagonal 4, more than the card's 132 SMs
    (True, 40, 4, 8, 0.0, False),    # 160 16x16 CUs on diagonals 6-9
    (False, 6, 4, 4, 0.5, False),    # all-zero-level CUs mixed with coded ones
    (True, 6, 4, 6, 0.5, False),
    (False, 4, 3, 4, 0.7, True),     # inter-only planes, mostly without levels
    (True, 4, 3, 5, 0.7, True),
])
def test_wavefront_decode_schedule_kernel(cuda, two_level, PT, nby, nbx, zero_cus, inter_only):
    """Kernel A's single-launch wavefront (per-CU ready flags, CUs taken in
    diagonal order) against the plain version, bit for bit: stacks whose
    diagonals hold more CUs than there are SMs, CUs whose transform is
    skipped beside coded ones, inter-only planes."""
    rng = np.random.default_rng(300 + PT + nby + 7 * two_level)
    name = "wavefront_decode16" if two_level else "wavefront_decode32"
    args = _decode_args(rng, cuda, PT, nby, nbx, two_level, 2047 if two_level else 1023, 26,
                        zero_cus, inter_only)
    before = dev.LAUNCHES[name]
    got = getattr(hevc, name)(*args, nby, nbx)
    assert dev.LAUNCHES[name] == before + 1
    _same(got, getattr(hevc, name + "_plain")(*args, nby, nbx))


@pytest.mark.parametrize("bs", [32, 16])
def test_half_pel_mc_kernel(cuda, bs):
    """Kernel B against its plain version at maxval 255, 1023 and 2047, on
    4 and 25 tile planes: MVs within +-16 half-pel (windows across every
    tile edge), the four phases side by side in one plane, MVs up to +-300
    (windows wholly outside the tile, as a decoder may be sent), and the
    phase CUs at the tile's corners.  One launch a call, no host wait."""
    rng = np.random.default_rng(bs)
    for maxval, P, H, W, reach in ((1023, 4, 96, 160, 16), (255, 25, 64, 64, 16),
                                   (2047, 4, 96, 160, 300), (255, 3, 256, 256, 300),
                                   (1023, 25, 2 * bs, 3 * bs, 8)):
        nby, nbx = H // bs, W // bs
        ref = torch.as_tensor(rng.integers(0, maxval + 1, (P, H, W)).astype(np.int32),
                              device=cuda)
        mv_np = rng.integers(-reach, reach + 1, (P, nby * nbx, 2)).astype(np.int32)
        mv_np[0, :, 0] = (mv_np[0, :, 0] & ~1) | (np.arange(nby * nbx) >> 1 & 1)
        mv_np[0, :, 1] = (mv_np[0, :, 1] & ~1) | (np.arange(nby * nbx) & 1)
        mv_np[1, [0, nbx - 1, -nbx, -1]] = [[-7, -7], [-7, 7], [7, -7], [7, 7]]
        mv = torch.as_tensor(mv_np, device=cuda)
        maxv = torch.full((P,), maxval, dtype=torch.int32, device=cuda)
        before = dev.LAUNCHES["half_pel_mc"]
        got = _no_sync(lambda: hevc.half_pel_mc(ref, mv, maxv, bs))
        assert dev.LAUNCHES["half_pel_mc"] == before + 1
        _same(got, hevc.half_pel_mc_plain(ref, mv, maxv, bs))


# (case, H, W, res, eom_bits, entry): W = res (one block column); H * W
# not a multiple of the 2048-pixel tile, and a single pixel row; no
# occupied pixel (no row: one launch) and every pixel occupied; occupied
# pixels on all four image edges (the boundary test wraps); sparse tiles
# (their rows staged at once) and dense EOM planes at 0, 3 and 30 bits
# (tiles staged in several chunks); the PLR entry; planes off their 16-byte alignment
# (scalar loads); a row too wide for the neighbour window; geo11's atlas
GP_CASES = [("random", 80, 96, 4, 0, None), ("one_block_column", 640, 16, 16, 3, None),
            ("random", 36, 100, 4, 3, None), ("random", 1, 3000, 1, 3, None),
            ("empty", 64, 64, 16, 3, None), ("full", 64, 128, 16, 0, None),
            ("edges", 48, 64, 8, 3, None), ("sparse", 128, 256, 16, 0, None),
            ("dense", 64, 128, 16, 0, None), ("dense", 64, 128, 16, 3, None),
            ("dense", 64, 128, 16, 30, None), ("random", 80, 96, 4, 3, "generate_points_plr"),
            ("unaligned", 36, 100, 4, 3, None), ("random", 16, 8192, 16, 0, None),
            ("random", 5632, 1280, 16, 0, None)]


def _gp_case(case, H, W, res, eom_bits, seed=0):
    """Inputs of kernel C: occupancy, D0, D1, block-to-patch, patch table
    and the EOM plane (None at eom_bits 0), numpy."""
    rng = np.random.default_rng(seed)
    hb, wb, P = H // res, W // res, 30
    g0 = rng.integers(0, 200, (H, W)).astype(np.int32)
    p_d1 = {"sparse": 0.2, "dense": 0.9, "full": 1.0}.get(case, 0.5)
    g1 = np.where(rng.random((H, W)) < p_d1, g0 + 3, g0).astype(np.int32)
    axes = np.array([[0, 2, 1], [1, 2, 0], [2, 0, 1]])[rng.integers(0, 3, P)]
    ptable = np.stack([
        rng.integers(0, max(wb // 2, 1), P), rng.integers(0, max(hb // 2, 1), P),
        rng.integers(2, 8, P), rng.integers(2, 8, P),
        rng.integers(0, 300, P), rng.integers(0, 300, P), rng.integers(0, 512, P),
        axes[:, 0], axes[:, 1], axes[:, 2], rng.integers(0, 2, P),
        np.arange(P) % 8, np.arange(P) % 4, np.full(P, 10),
        rng.integers(1, 3, P), rng.integers(1, 3, P),
    ], 1).astype(np.int32)
    p_occ = {"sparse": 0.3, "empty": 0.0, "full": 1.0, "dense": 0.95}.get(case, 0.8)
    occ = (rng.random((H, W)) < p_occ).astype(np.uint8)
    btp = rng.integers(0, P + 1, (hb, wb)).astype(np.int32)
    if case in ("full", "dense"):
        btp = rng.integers(1, P + 1, (hb, wb)).astype(np.int32)
    if case == "edges":
        occ[:] = 0
        occ[[0, -1], :] = 1
        occ[:, [0, -1]] = 1
        btp[:] = 1
        btp[0, 0] = 2
    eom = None
    if eom_bits:
        p_eom = 0.95 if case == "dense" else 0.4
        eom = np.where(rng.random((H, W)) < p_eom,
                       rng.integers(0, 1 << min(eom_bits + 1, 31), (H, W)), 0).astype(np.int32)
    return occ, g0, g1, btp, ptable, eom


def _tile_rows(pts, W):
    """Rows of each 2048-pixel raster tile in kernel C's result."""
    pix = pts.pix.cpu().long()
    return torch.bincount((pix[:, 1] * W + pix[:, 0]) // 2048)


@pytest.mark.parametrize("case,H,W,res,eom_bits,entry", GP_CASES)
def test_generate_points_kernel(cuda, case, H, W, res, eom_bits, entry):
    import warnings

    occ, g0, g1, btp, ptable, eom = _gp_case(case, H, W, res, eom_bits)
    t = [torch.as_tensor(a, device=cuda) for a in (occ, g0, g1, btp, ptable)]
    if case == "unaligned":   # every plane one element past a 16-byte boundary
        t[:3] = [torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(H, W) for a in t[:3]]
    kw = {}
    if eom is not None:
        kw = dict(eom=torch.as_tensor(eom, device=cuda), eom_bits=eom_bits)
        if case == "unaligned":
            e = kw["eom"]
            kw["eom"] = torch.cat([e.new_zeros(1), e.reshape(-1)])[1:].view(H, W)
    counter = "generate_points" if eom is None else entry or "generate_points_eom"
    if entry:
        kw["entry"] = entry
    torch.cuda.synchronize()
    before = dev.LAUNCHES[counter]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = reconstruct.generate_points(*t, res, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "called a synchronizing" in str(w.message)]
    want = reconstruct.generate_points_plain(*t, res, **{k: v for k, v in kw.items()
                                                         if k != "entry"})
    for a, b in zip(got, want):
        _same(a, b)
    n = got.pos.shape[0]
    assert dev.LAUNCHES[counter] - before == (2 if n else 1)
    assert len(syncs) == 1, [f"{w.filename}:{w.lineno} {w.message}" for w in syncs]
    assert (n == 0) == (case == "empty")
    if n:
        assert got.bnd.any() and (case in ("sparse", "edges") or not got.bnd.all())
    rows = _tile_rows(got, W) if n else torch.zeros(1)
    if case == "sparse":      # every tile's rows staged at once
        assert rows.max() <= 2048
    if case == "dense":       # tiles staged in several chunks
        assert rows.max() > 2048
    if eom_bits and n:
        assert (got.layer == 2).sum() > 0


@pytest.mark.parametrize("case,thr", [("sphere", 1.0), ("sphere", 2.0), ("sphere", 64.0),
                                      *((c, None) for c in SMOOTH_CASES), ("bits11", None),
                                      ("after_larger", None)])
def test_grid_smooth_kernel(cuda, case, thr):
    """A jittered vox10 sphere with banded patch ids, and the crafted clouds
    of `torch_md_cases.smooth_case` at 10 bits (points at the grid's corners,
    so that the box is the grid; one cell; one patch; no boundary point; the
    faces' distance test; gridSize 4 and 16), its corners cloud at 11 bits,
    and a call after a larger one (the scratch's records of another box).
    One launch a call and no host synchronisation."""
    bits, gs = 10, 8
    if case == "sphere":
        rng = np.random.default_rng(int(thr))
        v = rng.normal(size=(300_000, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = np.unique(np.round(512 + 400 * v).astype(np.int32), axis=0)
        pts = np.clip(pts + rng.integers(-2, 3, pts.shape), 0, 1023).astype(np.int32)
        pid = ((pts[:, 0] // 37 + pts[:, 2] // 53) % 7).astype(np.int32)
        bnd = rng.random(len(pts)) < 0.9
    elif case == "bits11":
        bits = 11
        pts, pid, bnd, thr, gs = smooth_case("corners", bits=11)
    else:
        if case == "after_larger":
            big = [torch.as_tensor(a, device=cuda) for a in smooth_case("corners", bits=11)[:3]]
            smoothing.grid_smooth(*big, 2.0, 8, 11)
        pts, pid, bnd, thr, gs = smooth_case("one_cell" if case == "after_larger" else case,
                                             bits=10)
    p, i, b = (torch.as_tensor(a, device=cuda) for a in (pts, pid, bnd))
    n0 = dev.LAUNCHES["grid_smooth"]
    got = _no_sync(lambda: smoothing.grid_smooth(p, i, b, thr, gs, bits))
    assert dev.LAUNCHES["grid_smooth"] == n0 + 1
    _same(got, smoothing.smooth_point_cloud_grid_plain(p, i, b, thr, gs, bits))


def test_decoder_defaults_to_cuda(cuda):
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.encoder import Encoder

    assert Decoder().device.type == "cuda"
    assert Encoder().device.type == "cuda"


def _knn_clouds():
    """A noisy sphere, a solid block (every cell overflows the bucket) and a
    lattice of spacing 2 (many equal distances), 10-bit coordinates."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(60000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sphere = np.unique(np.round(512 + 300 * v).astype(np.int32), axis=0)
    g = np.arange(24)
    block = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3) + 100
    h = np.arange(0, 60, 2)
    lattice = np.stack(np.meshgrid(h, h, h, indexing="ij"), -1).reshape(-1, 3) + 700
    return [c.astype(np.int32) for c in (sphere, block, lattice[rng.permutation(len(lattice))])]


@pytest.mark.parametrize("k,bucket", [(1, 8), (8, 16), (16, 6), (64, 6)])
def test_grid_knn_kernel(cuda, k, bucket):
    rng = np.random.default_rng(k)
    for pts in _knn_clouds():
        q = np.concatenate([pts, rng.integers(-8, 1032, (2000, 3)).astype(np.int32),
                            np.full((5, 3), 0x3FFFFFFF, np.int32)])
        p, qq = torch.as_tensor(pts, device=cuda), torch.as_tensor(q, device=cuda)
        g = neighbors.build_grid(p, 10)
        got = neighbors.knn(g, qq, k=k, bucket=bucket)
        want = neighbors.knn_plain(g, qq, k=k, bucket=bucket)
        for a, b in zip(got, want):
            _same(a, b)


@pytest.mark.parametrize("k,bucket", [(1, 8), (8, 6), (16, 6), (64, 6)])
def test_grid_knn_xyz_kernel(cuda, k, bucket):
    """The unpacked-table entry (grids above 10 bits): the clouds moved
    into the 11-bit range (8^3-voxel cells; the block overfills them),
    queries around them and outside the grid."""
    rng = np.random.default_rng(20 + k)
    for pts in _knn_clouds():
        pts = pts + 1000
        q = np.concatenate([pts, rng.integers(990, 2060, (2000, 3)).astype(np.int32),
                            np.full((5, 3), 0x3FFFFFFF, np.int32)])
        p, qq = torch.as_tensor(pts, device=cuda), torch.as_tensor(q, device=cuda)
        g = neighbors.build_grid(p, 11)
        assert not g.packed
        n0 = dev.LAUNCHES["grid_knn_xyz"]
        got = neighbors.knn(g, qq, k=k, bucket=bucket)
        assert dev.LAUNCHES["grid_knn_xyz"] == n0 + 1
        want = neighbors.knn_plain(g, qq, k=k, bucket=bucket)
        for a, b in zip(got, want):
            _same(a, b)


def _knn_pair(got, want, k):
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0].shape[1] == k


def test_grid_knn_padding_kernel(cuda):
    """k=64 where the 27-cell windows hold fewer than 64 points: the missing
    neighbours come out as idx 0, d2 MAX_DIST2, as the plain version pads."""
    rng = np.random.default_rng(64)
    pts = np.unique(rng.integers(0, 1024, (3000, 3)), axis=0).astype(np.int32)
    p = torch.as_tensor(pts, device=cuda)
    q = torch.as_tensor(np.concatenate([pts[:500], rng.integers(0, 1024, (500, 3))])
                        .astype(np.int32), device=cuda)
    g = neighbors.build_grid(p, 10)
    got = neighbors.knn(g, q, k=64, bucket=6)
    _knn_pair(got, neighbors.knn_plain(g, q, k=64, bucket=6), 64)
    missing = got[1] == neighbors.MAX_DIST2
    assert bool(missing.any()) and bool((got[0][missing] == 0).all())


@pytest.mark.parametrize("k,bucket,bits,cell_bits", [
    (16, 12, 10, None),   # the metrics' source normals
    (1, 12, 10, None),
    (33, 12, 10, None),
    (8, 20, 10, None),    # windows wider than 48 slots
    (16, 16, 11, 10),     # cells so coarse that the keys need 64 bits
])
def test_grid_knn_wide_kernel(cuda, k, bucket, bits, cell_bits):
    """Kernel E's wider windows and larger k against the plain version."""
    rng = np.random.default_rng(400 + k + bucket)
    for pts in _knn_clouds():
        if bits == 11:
            pts = pts + 1000
        q = np.concatenate([pts, rng.integers(-8, (1 << bits) + 8, (1000, 3)).astype(np.int32)])
        p, qq = torch.as_tensor(pts, device=cuda), torch.as_tensor(q, device=cuda)
        g = neighbors.build_grid(p, bits, cell_bits)
        got = neighbors.knn(g, qq, k=k, bucket=bucket)
        _knn_pair(got, neighbors.knn_plain(g, qq, k=k, bucket=bucket), k)


@pytest.mark.parametrize("k", [1, 8, 16, 64])
def test_grid_knn_shuffled_queries_kernel(cuda, k):
    """Queries in an order unrelated to the grid's (neighbouring query
    groups of a warp in far-apart cells), against the plain version and
    against the same queries in cell order, row for row."""
    rng = np.random.default_rng(500 + k)
    pts = _knn_clouds()[0]
    p = torch.as_tensor(pts, device=cuda)
    g = neighbors.build_grid(p, 10)
    ordered = p[g.order.long()].contiguous()
    perm = torch.as_tensor(rng.permutation(len(pts)), device=cuda)
    got = neighbors.knn(g, ordered[perm].contiguous(), k=k, bucket=6)
    _knn_pair(got, neighbors.knn_plain(g, ordered[perm].contiguous(), k=k, bucket=6), k)
    base = neighbors.knn(g, ordered, k=k, bucket=6)
    _same(got[0], base[0][perm])
    _same(got[1], base[1][perm])


def test_cc_round_voxel_kernel(cuda):
    """A full-graph patch round: the point mask lifted to the voxels, kernel
    G over the whole voxel graph, the labels gathered back."""
    p, idx, valid = _voxel_graph(cuda)
    rng = np.random.default_rng(60)
    n = 3 * p.shape[0]
    point_vox = torch.as_tensor(rng.integers(0, p.shape[0], n).astype(np.int32), device=cuda)
    act = torch.as_tensor(rng.random(n) < 0.6, device=cuda)
    part = (p[:, 0] // 200).to(torch.int32)
    got = cc.cc_round_voxel(idx, valid, part, point_vox, act)
    want = cc.cc_round_voxel(idx.cpu(), valid.cpu(), part.cpu(), point_vox.cpu(), act.cpu())
    _same(got, want)


@pytest.mark.parametrize("case,k_bwd", [("mixed", 1), ("mixed", 0), ("all_exact", 1),
                                         ("duplicates", 1), ("no_exact", 1)])
def test_recolor_blend_kernel(cuda, case, k_bwd):
    """The uncompacted transfer of grids above 10 bits (host exact matching,
    kernel M's blend entry over every target and every source, the sources
    of exact targets dropped in the launch) on the card against the CPU's
    plain versions: one launch, no host synchronisation; and the entry
    alone against its plain version."""
    sp, sc, tp = (torch.as_tensor(a, device=cuda) for a in recolor_case(case, seed=70 + k_bwd))
    sp, tp = sp + 1500, tp + 1500
    ei, he = recolor.exact_matches(sp.cpu().numpy(), tp.cpu().numpy(), sp.shape[0], 11)
    ei, he = torch.as_tensor(ei, device=cuda), torch.as_tensor(he, device=cuda)
    kw = dict(grid_bits=11, k=8, k_bwd=k_bwd)
    n0 = dev.LAUNCHES["recolor"]
    card = _no_sync(lambda: recolor.transfer_colors(sp, sc, tp, ei, he, **kw))
    assert dev.LAUNCHES["recolor"] == n0 + 1
    host = recolor.transfer_colors(sp.cpu(), sc.cpu(), tp.cpu(), ei.cpu(), he.cpu(), **kw)
    _same(card, host)
    idx, d2 = neighbors.knn(neighbors.build_grid(sp, 11), tp, k=8, bucket=6)
    tidx, td2 = neighbors.nearest(neighbors.build_grid(tp, 11), sp, bucket=6)
    args = (sc, ei, he, None, idx, d2, None, tidx, td2, 30.0, 2000.0, 4.0, 3.0)
    _same(recolor.blend_merge(*args), recolor.blend_merge_plain(*args))


def _voxel_graph(cuda):
    pts = _knn_clouds()[0]
    p = torch.as_tensor(pts, device=cuda)
    idx, d2 = neighbors.knn(neighbors.build_grid(p, 10), p, k=16, bucket=6)
    return p, idx, d2 < neighbors.MAX_DIST2


def _grid_graph(rng, n, K, z_sign):
    """An n x n plane (z = 5) whose rows are each other's grid neighbours
    (K slots, the ones off the plane invalid), normals (0, 0, z_sign)."""
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel(), np.full(n * n, 5)], 1).astype(np.int32)
    off = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx][:K]
    idx = np.zeros((n * n, K), np.int32)
    nnv = np.zeros((n * n, K), bool)
    for k, (dy, dx) in enumerate(off):
        y, x = yy.ravel() + dy, xx.ravel() + dx
        ok = (y >= 0) & (y < n) & (x >= 0) & (x < n)
        idx[:, k] = np.where(ok, y * n + x, 0)
        nnv[:, k] = ok
    nrm = np.zeros((n * n, 3), np.float32)
    nrm[:, 2] = z_sign
    return pos, nrm, idx, nnv, np.ones(n * n, bool)


def _segment_case(case):
    """(positions, normals, nn_idx, nn_valid, valid, orientations, weights,
    (sweeps that change the orientation, sweeps that change the partition
    at 10 iterations, as the plain versions run them)) for kernel F's
    orientation and partition launches."""
    rng = np.random.default_rng(sum(map(ord, case)))
    o6, w6 = segmentation.ORIENTATIONS6, np.array([1.0, 0.5, 2.0, 1.0, 0.5, 2.0], np.float32)
    if case in ("cloud", "cloud18"):
        pts = _knn_clouds()[0]
        p = torch.as_tensor(pts)
        idx, d2 = neighbors.knn(neighbors.build_grid(p, 10), p, k=16, bucket=6)
        nnv = (d2 < neighbors.MAX_DIST2).numpy()
        nrm = normals.pca_normals_plain(p, idx, torch.as_tensor(nnv)).numpy()
        pos, idx = pts.astype(np.int32), idx.numpy()
        valid = rng.random(len(pos)) < 0.9   # rows left out of the centroid
        if case == "cloud18":
            o6 = segmentation.get_orientations(4)
            w6 = rng.uniform(0.5, 2.0, len(o6)).astype(np.float32)
        changes = (0, 10)   # a consistent radial start; the refinement moves to the end
    elif case == "stable":   # nothing moves: the first sweep ends both loops
        pos, nrm, idx, nnv, valid = _grid_graph(rng, 45, 8, 1.0)
        changes = (0, 0)
    elif case == "one_sweep":
        # isolated rows tilted toward x: the radial start turns those left of
        # the centroid over, sweeps 0 and 1 turn them back; they start in
        # partition 0 and sweep 0 moves them to their neighbours' 2
        pos, nrm, idx, nnv, valid = _grid_graph(rng, 45, 8, 1.0)
        tilt = rng.choice(len(pos), 60, replace=False)
        nrm[tilt] = [0.95, 0.0, 0.31]
        changes = (2, 1)
    elif case == "oscillate":   # pairs that swap in every sweep
        V = 2 * 700
        pos = rng.integers(0, 1024, (V, 3)).astype(np.int32)
        mate = np.arange(V) ^ 1
        idx = np.stack([mate, np.zeros(V, int)], 1).astype(np.int32)
        nnv = np.stack([np.ones(V, bool), np.zeros(V, bool)], 1)
        a, b = np.float32(0.71), np.float32(0.70)
        nrm = np.where((np.arange(V) % 2 == 0)[:, None], [a, b, 0.0], [b, a, 0.0])
        nrm = nrm.astype(np.float32)
        nrm[1::2] *= -1   # each pair opposite: both flip each orientation sweep
        valid = np.ones(V, bool)
        w6 = np.ones(6, np.float32)
        changes = (normals.ORIENT_ITERATIONS, 10)
    elif case == "big_coords":   # V off the block size, sums rounding in float32
        V = 1037
        pos = rng.integers(0, 1 << 20, (V, 3)).astype(np.int32)
        idx = rng.integers(0, V, (V, 16)).astype(np.int32)
        nnv = rng.random((V, 16)) < 0.7
        nrm = rng.normal(size=(V, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        valid = rng.random(V) < 0.7
        changes = (8, 6)
    else:   # "empty"
        pos, nrm = np.zeros((0, 3), np.int32), np.zeros((0, 3), np.float32)
        idx, nnv, valid = np.zeros((0, 16), np.int32), np.zeros((0, 16), bool), np.zeros(0, bool)
        changes = (0, 0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    return (t(pos), t(nrm), t(idx), t(nnv), t(valid), t(np.asarray(o6, np.float32)),
            t(np.asarray(w6, np.float32)), changes)


@pytest.mark.parametrize("case", ["cloud", "cloud18", "stable", "one_sweep", "oscillate",
                                  "big_coords", "empty"])
def test_segment_kernel(cuda, case):
    """Normals to 1e-5 (the kernel's acosf/cosf against PyTorch's); the
    orientation, the initial partition (alone and before the refinement)
    and the refined partition at 0, 1 and 10 iterations exactly given the
    same normals; one launch a call, no host synchronisation; the device
    centroid equals its tensor twin; the sweeps that ran end just after the
    last sweep that changed something."""
    pos, nrm, idx, nnv, valid, o, w, (n_orient, n_refine) = _segment_case(case)
    V = pos.shape[0]
    if case == "cloud":
        got = normals.pca_normals(pos, idx, nnv)
        want = normals.pca_normals_plain(pos, idx, nnv)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5
    want_o = normals.orient_normals_plain(pos, nrm, idx, nnv, valid)
    want_p = {it: segmentation.refine_segmentation_plain(
        want_o, segmentation.initial_segmentation_plain(want_o, o, w), idx, nnv, o, 3.0, it)
        for it in (0, 1, 10)}
    want_i = segmentation.initial_segmentation_plain(want_o, o, w)
    centroid = normals.orientation_centroid_device(pos, valid)
    torch.cuda.synchronize()
    one = 1 if V else 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = dev.LAUNCHES["segment"]
        got_o = normals.orient_normals(pos, nrm, idx, nnv, valid)
        got_o2, got_c, flags_o = normals.orient_launch(pos, nrm, idx, nnv, valid)
        got_i = segmentation.initial_segmentation(want_o, o, w)
        assert dev.LAUNCHES["segment"] == before + 3 * one
        got_p = {}
        for it in (0, 1, 10):
            before = dev.LAUNCHES["segment"]
            got_p[it] = segmentation.segment_partitions(want_o, o, w, idx, nnv, 3.0, it)
            got_r = segmentation.refine_segmentation(want_o, want_i, idx, nnv, o, 3.0, it)
            assert dev.LAUNCHES["segment"] == before + 2 * one
            got_p[it] = (*got_p[it], got_r)
        _, got_r10, flags_r = segmentation.partition_launch(want_o, o, None, idx, nnv, 3.0, 10,
                                                            want_i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got_o, want_o)
    _same(got_o2, want_o)
    _same(got_i, want_i)
    for it, (init, refined, refined_given) in got_p.items():
        _same(init, want_i)
        _same(refined, want_p[it])
        _same(refined_given, want_p[it])
    _same(got_r10, want_p[10])
    if not V:
        assert got_c is None and flags_o is None and flags_r is None
        return
    _same(got_c, centroid)
    assert normals.sweeps_run(flags_o) == min(n_orient + 1, normals.ORIENT_ITERATIONS)
    assert normals.sweeps_run(flags_r) == min(n_refine + 1, 10)


def _cc_case(case):
    """A (V, 16) k-NN graph for kernel G: idx, valid, partition, active."""
    rng = np.random.default_rng(sum(map(ord, case)))
    V, K = 200_000, {"k8": 8, "k20": 20}.get(case, 16)   # rows narrower or wider than a group
    idx = rng.integers(0, V, (V, K)).astype(np.int32)
    valid = rng.random((V, K)) < 0.08
    part = rng.integers(0, 3, V).astype(np.int32)
    active = rng.random(V) < 0.9
    i = np.arange(V)
    if case == "chains":   # random-order chains of 50,000
        perm = rng.permutation(V)
        idx[:] = 0
        idx[perm[:-1], 0] = perm[1:]
        valid[:] = False
        valid[perm[:-1], 0] = True
        valid[perm[::50_000], 0] = False
        part[:], active[:] = 0, True
    elif case == "sparse":   # ~2 % active, as the later patch rounds
        idx = np.clip(i[:, None] + rng.integers(-30, 31, (V, K)), 0, V - 1).astype(np.int32)
        valid = rng.random((V, K)) < 0.7
        active = ((i // 100) % 50 == 0) | (rng.random(V) < 0.002)
    elif case == "star":   # every vertex points at one hub
        valid[:] = False
        idx[:, 0], valid[:, 0] = V // 2, True
        part[:], active[:] = 0, True
    elif case == "duplicates":   # repeated slots and self edges
        idx[:, 8:] = idx[:, :8]
        idx[:, 3] = i
        valid[:, 3] = True
        valid[:, 8:] = valid[:, :8]
    elif case == "partition_boundary":   # mutual pairs across partitions never join
        idx[:, 0], idx[:, 1] = i ^ 1, np.maximum(i - 2, 0)
        valid[:] = False
        valid[:, 0] = valid[:, 1] = True
        part = (i % 2).astype(np.int32)
        active[:] = True
    elif case == "downward_chain":   # i -> i - 1: every link climbs a chain
        V = 100_000
        idx, valid = np.zeros((V, K), np.int32), np.zeros((V, K), bool)
        idx[1:, 0], valid[1:, 0] = np.arange(V - 1), True
        part, active = np.zeros(V, np.int32), np.ones(V, bool)
    return idx, valid, part, active


@pytest.mark.parametrize("case", ["random", "chains", "sparse", "star", "duplicates",
                                  "partition_boundary", "downward_chain", "k8", "k20"])
def test_cc_labels_kernel(cuda, case):
    """Kernel G against its plain version on crafted graphs, three launches
    a call."""
    t = [torch.as_tensor(a, device=cuda) for a in _cc_case(case)]
    before = dev.LAUNCHES["cc_labels"]
    got = cc.cc_labels_device(*t)
    assert dev.LAUNCHES["cc_labels"] == before + 3
    want = cc.cc_labels_plain(*t)
    _same(got, want)
    if case == "partition_boundary":   # pairs i, i ^ 1 stay apart
        assert bool((want[0::2] != want[1::2]).all())
    sub, lab = cc.cc_round_voxel_compact(*t)
    torch.cuda.synchronize()
    assert torch.equal(lab.cpu(), got.cpu()[sub.cpu().long()])


# (case, bits, r2_sel, r2_det): 8-, 9- and 10-bit grids (8, 16, 32 words
# a column); resampled points at y and z = 0 and G - 1 (the box meets the
# grid's edge); a slab at x0 = G - sx; points whose x the slab clips;
# all-padding points (R > 0, none valid), R = 0 and N = 0; r2_sel = r2_det,
# r2_sel = 0, r2_sel > r2_det and the largest ball the kernel takes
COVERAGE_CASES = [("random", 10, 1, 9), ("random", 9, 1, 9), ("random", 8, 1, 9),
                  ("edges", 10, 1, 9), ("edges", 8, 4, 4), ("top_slab", 10, 1, 9),
                  ("clipped", 10, 1, 9), ("padding", 10, 1, 9), ("no_points", 10, 1, 9),
                  ("no_queries", 10, 1, 9), ("random", 10, 9, 9), ("random", 10, 0, 9),
                  ("random", 10, 9, 1), ("random", 9, 16, 4), ("random", 10, 1, 63)]


def _coverage_case(case, bits, seed=0, n_res=20_000, n_q=30_000, spread=None):
    """(res_packed, queries, x0, sx) of kernel H, numpy."""
    rng = np.random.default_rng(seed)
    G = 1 << bits
    res = rng.integers(0, G, (n_res, 3))
    spread = spread or G // 3
    res[:, 0] = rng.integers(G // 4, G // 4 + spread, n_res)
    if case == "edges":
        res[:, 1] = rng.choice([0, 1, G - 2, G - 1], n_res)
        res[:, 2] = rng.choice([0, 1, 30, 33, G - 2, G - 1], n_res)
    if case == "top_slab":
        res[:, 0] = rng.integers(G - G // 8, G, n_res)
    x0, sx = coverage.slab_params(res, bits)
    if case == "clipped":   # a slab narrower than the points: their x clips
        sx = 128
        x0 = int(res[:, 0].min()) + 40
    q = np.concatenate([res + rng.integers(-4, 5, res.shape), rng.integers(-3, G + 3, (n_q, 3))])
    q = q.astype(np.int32)
    q[::101] = 0x3FFFFFFF
    packed = coverage.pack_coords10(res, n_res + 7)
    if case == "padding":
        packed[:] = -1
    if case == "no_points":
        packed = packed[:0]
    if case == "no_queries":
        q = q[:0]
    return packed, q, x0, sx


def _coverage_check(cuda, packed, q, x0, sx, bits, r2_sel, r2_det):
    rp, qq = torch.as_tensor(packed, device=cuda), torch.as_tensor(q, device=cuda)
    got, launches = _one_launch_no_sync(
        "coverage", lambda: coverage.covered_radius_slab(rp, qq, x0, bits, r2_sel, r2_det, sx))
    want = coverage.covered_radius_slab_plain(rp, qq, x0, bits, r2_sel, r2_det, sx)
    for a, b in zip(got, want):
        _same(a, b)
    assert launches == (1 if len(q) else 0)
    return got


@pytest.mark.parametrize("case,bits,r2_sel,r2_det", COVERAGE_CASES)
def test_coverage_kernel(cuda, case, bits, r2_sel, r2_det):
    packed, q, x0, sx = _coverage_case(case, bits)
    if case == "top_slab":
        assert x0 == (1 << bits) - sx
    sel, det = _coverage_check(cuda, packed, q, x0, sx, bits, r2_sel, r2_det)
    if case in ("padding", "no_points"):
        assert not det.any() and not sel.any()
    elif case != "no_queries":
        assert det.sum() > 0 and sel.sum() > 0
        assert (sel.sum() < det.sum()) == (r2_sel < r2_det)


def test_coverage_stale_scratch_kernel(cuda):
    """A call at the bench frame's round-0 shapes (530k resampled points,
    607k queries, a 384-wide slab) after a call whose points fill the whole
    grid: a word the second call's box did not zero would show."""
    big = _coverage_case("random", 10, seed=1, n_res=200_000, n_q=10_000, spread=700)
    _coverage_check(cuda, *big, 10, 1, 9)
    bench = _coverage_case("random", 10, seed=2, n_res=530_000, n_q=77_000, spread=360)
    sel, det = _coverage_check(cuda, *bench, 10, 1, 9)
    assert bench[3] == 384 and len(bench[1]) == 607_000 and det.sum() > sel.sum() > 0


# ---------------------------------------------------------------------------
# geometry video encoder: kernels I-L


def _smooth_planes(rng, P, H, W, maxval, k=9):
    """Smooth integer planes with a little noise (box-filtered noise)."""
    x = rng.random((P, H + k, W + k))
    c = np.cumsum(np.cumsum(x, 1), 2)
    box = (c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]) / (k * k)
    box = (box - box.min()) / (np.ptp(box) + 1e-9) * maxval
    out = box[:, :H, :W] + rng.integers(-2, 3, (P, H, W))
    for p in range(P):   # a few flat rectangles: sharp edges beside smooth areas
        for _ in range(6):
            y, x = rng.integers(0, H), rng.integers(0, W)
            out[p, y: y + rng.integers(4, 40), x: x + rng.integers(4, 40)] = rng.integers(0, maxval)
    return np.clip(out, 0, maxval).astype(np.int32)


def _pp_check(img, occ):
    """Kernel L against its plain version on one call, with the launches its
    tile plan makes (one where the pyramid has at most 5 levels, which a
    2^5-pixel region holds, or a side is odd, else three) and no host
    wait."""
    P, H, W = (1, *img.shape) if img.ndim == 2 else img.shape
    want_launches = 1 if len(padding._levels(H, W)) - 1 <= 5 else 3
    before = dev.LAUNCHES["push_pull"]
    got = _no_sync(lambda: padding.push_pull_round(img, occ))
    assert dev.LAUNCHES["push_pull"] - before == want_launches <= 3
    _same(got, padding.push_pull_round_plain(img, occ))


def test_push_pull_kernel(cuda):
    """Every branch of kernel L's tile plan: one level (6x10), a ragged
    region (12x20, L = 2; 256x96, L = 5), a 1 x W plane and an odd side
    (L = 0), 64x1024 and 1216x1280 (L = 6), 1280x1280 (L = 8), 512x1024 (L
    = 9) and 2048x2048 (L = 11: a level t of 64x64, more pixels than the
    top's threads): tile push, top, tile pull; the top's levels in global
    scratch; six planes under one occupancy and three with one each; an
    all-empty plane and a single occupied pixel."""
    rng = np.random.default_rng(3)
    shapes = ((1280, 1280, 0.6), (256, 96, 0.02), (6, 10, 0.0), (6, 10, 0.3), (12, 20, 0.2),
              (1, 64, 0.5), (7, 12, 0.5), (64, 1024, 0.05), (1216, 1280, 0.3),
              (512, 1024, 0.002), (2048, 2048, 0.01))
    for H, W, share in shapes:
        img = torch.as_tensor(rng.integers(0, 1024, (H, W)).astype(np.int32), device=cuda)
        occ = torch.as_tensor((rng.random((H, W)) < share).astype(np.uint8), device=cuda)
        _pp_check(img, occ)
    stack = torch.as_tensor(rng.integers(0, 256, (6, 1280, 1280)).astype(np.int32), device=cuda)
    occ = torch.as_tensor((rng.random((1280, 1280)) < 0.4).astype(np.uint8), device=cuda)
    _pp_check(stack, occ)
    occ3 = torch.as_tensor((rng.random((3, 1280, 1280)) < 0.4).astype(np.uint8), device=cuda)
    _pp_check(stack[:3].contiguous(), occ3)
    _pp_check(stack[:2, :12, :20].contiguous(), occ3[:2, :12, :20].contiguous())
    empty = torch.zeros((1280, 1280), dtype=torch.uint8, device=cuda)
    _pp_check(stack[0], empty)
    single = empty.clone()
    single[637, 1011] = 1
    _pp_check(stack[0], single)
    big = torch.as_tensor(rng.integers(0, 1024, (2048, 2048)).astype(np.int32), device=cuda)
    big_occ = torch.as_tensor((rng.random((2048, 2048)) < 0.02).astype(np.uint8), device=cuda)
    smem = padding.PUSH_TOP_SMEM
    try:
        padding.PUSH_TOP_SMEM = 0   # the top's levels in global scratch
        _pp_check(big, big_occ)
        _pp_check(stack, occ)
        _pp_check(stack[:3].contiguous(), occ3)
    finally:
        padding.PUSH_TOP_SMEM = smem


def _f8_plane(h, w, planes=0, seed=8):
    """Values below 2^24 on 5 % of the pixels, the top-left (h/4, w/4) block
    empty: push sums pass 2^24 from level 3 (tests/test_torch_level_kernels.py
    holds the plain version against JAX on the same planes)."""
    rng = np.random.default_rng(seed)
    shape = (planes, h, w) if planes else (h, w)
    img = rng.integers(0, 1 << 24, shape).astype(np.int32)
    occ = (rng.random(shape) < 0.05).astype(np.uint8)
    occ[..., : h // 4, : w // 4] = 0
    return img, occ


@pytest.mark.parametrize("h,w,planes", [(256, 256, 0), (512, 512, 0), (512, 512, 3),
                                        (1216, 1280, 0), (2048, 2048, 0), (64, 1024, 0),
                                        (384, 640, 0)])
def test_push_pull_order_kernel(cuda, h, w, planes):
    """Kernel L in XLA's push order (pairwise levels at 256x256, 512x512
    and 2048x2048), over a stack with an occupancy per plane, and counting
    the blocks past 2^24 where the order is not established (the 1x1 tops,
    every level of 1216x1280, 64x1024 and 384x640) as its plain version
    counts them: once, though the tile pull rebuilds the levels the tile
    push counted."""
    img, occ = (torch.as_tensor(a, device=cuda) for a in _f8_plane(h, w, planes))
    padding.reset_inexact()
    got = padding.push_pull_round(img, occ)
    n_k = padding.inexact_blocks()
    padding.reset_inexact()
    want = padding.push_pull_round_plain(img, occ)
    assert padding.inexact_blocks() == n_k > 0   # each shape has levels of unknown order
    _same(got, want)
    padding.reset_inexact()


@pytest.mark.parametrize("case,bs,maxval,P", [
    ("half_shift", 32, 255, 3), ("half_shift", 16, 255, 3),
    ("random", 32, 1023, 1), ("random", 16, 2047, 1), ("random", 32, 2047, 25),
    ("random", 16, 1023, 25), ("random", 32, 255, 2), ("flat", 32, 255, 2),
    ("flat", 16, 2047, 2), ("corners", 32, 255, 4), ("corners", 16, 2047, 4)])
def test_motion_search_kernel(cuda, case, bs, maxval, P):
    """Kernel J against its plain version, mv and cost bit for bit, one
    launch a call: a reference half a sample off the source (half-pel
    vectors win); smooth planes with a shifted, noisy reference at 8, 10
    and 11 bits, one and 25 tile planes; flat planes with lambda 0, where
    every candidate ties and the lowest linear index (-8, -8) must win; and
    planes of one CU row and column, every CU at a tile corner with the
    reference shifted outward, where both half-pel clamps act."""
    rng = np.random.default_rng(sum(map(ord, case)) + bs + P)
    H, W = {"corners": (2 * bs, 2 * bs), "random": (96, 128) if P > 2 else (128, 96)}.get(
        case, (128, 96))
    lam = torch.as_tensor(tab.LAMBDA[rng.integers(20, 41, P)], device=cuda)
    if case == "half_shift":
        base = _smooth_planes(rng, P, H + 16, W + 16, maxval)
        src = base[:, 5:5 + H, 3:3 + W]
        ref = (base[:, 8:8 + H, 8:8 + W] + base[:, 8:8 + H, 9:9 + W] + 1) // 2
    elif case == "flat":
        src = np.broadcast_to(rng.integers(0, maxval + 1, (P, 1, 1)), (P, H, W))
        ref = src.copy()
        lam = torch.zeros(P, dtype=torch.float32, device=cuda)
    else:
        dy, dx = (7, -6) if case == "corners" else (3, -2)
        base = _smooth_planes(rng, P, H + 20, W + 20, maxval)
        src = base[:, 10:10 + H, 10:10 + W]
        ref = np.clip(base[:, 10 + dy:10 + dy + H, 10 + dx:10 + dx + W]
                      + rng.integers(-3, 4, (P, H, W)), 0, maxval)
    src = torch.as_tensor(np.ascontiguousarray(src, np.int32), device=cuda)
    ref = torch.as_tensor(np.ascontiguousarray(ref, np.int32), device=cuda)
    maxv = torch.full((P,), maxval, dtype=torch.int32, device=cuda)
    before = dev.LAUNCHES["motion_search"]
    mv, cost = hevc.motion_search(src, ref, lam, maxv, bs)
    assert dev.LAUNCHES["motion_search"] == before + 1
    mv_p, cost_p = hevc.motion_search_plain(src, ref, lam, maxv, bs)
    _same(mv, mv_p)
    _same(cost, cost_p)
    if case == "half_shift":
        assert bool(((mv & 1) != 0).any())   # some half-pel vectors win
    elif case == "flat":
        assert bool((mv == -2 * hevc.MV_RANGE).all())
    elif case == "corners":   # vectors reach past the tile, where the clamps act
        assert int(mv[..., 0].abs().max()) >= 12 or int(mv[..., 1].abs().max()) >= 12


def _sao_case(case, region, maxval):
    """Kernel K's inputs (src, rec, weights, lam, maxvals) on crafted planes."""
    rng = np.random.default_rng(sum(map(ord, case)) + region)
    shape = {"one_region": (2, region, region), "one_row": (2, region, 4 * region),
             "one_column": (2, 3 * region, region)}.get(case, (2, 96, 160))
    P, H, W = shape
    lam = tab.LAMBDA[[20, 34]]
    if case == "clip_ties":
        # rows alternating low/high (a plane at 0..2, a plane at maxval-2..
        # maxval): the three vertical-axis classes tie, the lowest must win;
        # the source far from rec clips every offset at -7 / +7 and the
        # applied samples at 0 and maxval
        low = np.array([0, maxval - 2])[:, None, None]
        rows = (np.arange(H) % 2 * 2)[None, :, None]
        rec = np.broadcast_to(low + rows, (P, H, W)).astype(np.int32)
        src = (rec + np.where(rows == 0, -20, 20)).astype(np.int32)
        w = np.ones((P, H, W), np.int32)
        lam = tab.LAMBDA[[4, 4]]
    else:
        src = _smooth_planes(rng, P, H, W, maxval)
        noise = 12 if maxval > 1023 else 6
        rec = np.clip(src + rng.integers(-noise, noise + 1, src.shape), 0,
                      maxval).astype(np.int32)
        w = (rng.random((P, H, W)) < 0.8).astype(np.int32)
        if case == "zero_weights":   # every other region row carries no weight
            w.reshape(P, H // region, region, W)[:, ::2] = 0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    return (t(src), t(rec), t(w), torch.as_tensor(lam, device="cuda"),
            torch.full((P,), maxval, dtype=torch.int32, device="cuda"))


def _sao_check(case, region, maxval):
    """The three entries of kernel K against the plain search then apply,
    bit for bit; one launch a fused call."""
    src, rec, w, lam, maxv = _sao_case(case, region, maxval)
    cls_p, off_p = hevc.sao_search_plain(src, rec, lam, w, region)
    out_p = hevc.sao_apply_plain(rec, cls_p, off_p, maxv, region)
    before = dev.LAUNCHES["sao"]
    out, cls, off = hevc.sao_search_apply(src, rec, lam, w, maxv, region)
    assert dev.LAUNCHES["sao"] == before + 1
    _same(cls, cls_p)
    _same(off, off_p)
    _same(out, out_p)
    c2, o2 = hevc.sao_search(src, rec, lam, w, region)
    _same(c2, cls_p)
    _same(o2, off_p)
    _same(hevc.sao_apply(rec, cls_p, off_p, maxv, region), out_p)
    if case == "zero_weights":
        assert int((cls_p[:, ::2] != 0).sum()) == 0
    elif case == "clip_ties":
        assert bool((cls_p == 2).all())
        assert {-7, 7} <= set(off_p.flatten().tolist()) <= {-7, 0, 7}
        assert int((out_p == 0).sum()) > 0 and int((out_p == maxval).sum()) > 0
    if case in ("smooth", "zero_weights"):
        assert int((cls_p > 0).sum()) > 0


@pytest.mark.parametrize("case,maxval", [("smooth", 255), ("smooth", 1023),
                                         ("zero_weights", 1023), ("one_region", 255),
                                         ("one_row", 1023), ("one_column", 255),
                                         ("clip_ties", 255), ("clip_ties", 1023)])
def test_sao_kernel(cuda, case, maxval):
    """Kernel K at 32-px regions."""
    _sao_check(case, 32, maxval)


@pytest.mark.parametrize("case", ["smooth", "zero_weights", "one_region", "one_row",
                                  "one_column", "clip_ties"])
def test_sao_region16_kernel(cuda, case):
    """Kernel K at the two-level codec's 16-px regions on 11-bit planes."""
    _sao_check(case, 16, 2047)


@pytest.mark.parametrize("has_ref", [False, True])
def test_wavefront_encode32_kernel(cuda, has_ref):
    rng = np.random.default_rng(11 + has_ref)
    PT, nby, nbx = 2, 2, 3
    nb = nby * nbx
    H, W = nby * 32, nbx * 32
    t = lambda a: torch.as_tensor(a, device=cuda)
    src = _smooth_planes(rng, PT, H, W, 255)
    ref = np.zeros_like(src)
    if has_ref:   # a good reference on the left, an unrelated one on the right
        ref = np.clip(src + rng.integers(-3, 4, src.shape), 0, 255).astype(np.int32)
        ref[:, :, W // 2:] = _smooth_planes(rng, PT, H, W - W // 2, 255)
    wgt = (rng.random((PT, nby * 4, nbx * 4)) < 0.6).repeat(8, 1).repeat(8, 2)
    w32, w16, w8 = hevc.block_weights32(t(wgt.astype(np.int32)), nby, nbx)
    qp = np.array([34, 44])
    dq = tab.DQ64[qp].astype(np.int32)
    qstep = dq.astype(np.float32) / np.float32(64)
    args = [t(src), t(ref), w32, w16, w8,
            t((rng.random((PT, nb)) * 20).astype(np.float32)), t(qstep),
            t(np.float32(1) / qstep), t(tab.LAMBDA[qp]),
            torch.full((PT,), 0.0 if has_ref else 1e30, device=cuda), t(dq),
            torch.full((PT,), 255, dtype=torch.int32, device=cuda)]
    before = dev.LAUNCHES["wavefront_encode32"]
    got = hevc.wavefront_encode32(*args, nby, nbx)
    assert dev.LAUNCHES["wavefront_encode32"] == before + 1   # one launch a call
    want = hevc.wavefront_encode32_plain(*args, nby, nbx)
    for a, b in zip(got, want):
        _same(a, b)
    flags = torch.cat([got[0].flatten(), got[3].flatten()]).long()
    assert 0 < int(flags.sum()) < flags.numel()   # split and unsplit blocks


def _encode_args(rng, cuda, PT, nby, nbx, cu, maxval, mixed=True):
    """Kernel I's arguments on (PT, nby*cu, nbx*cu) planes: smooth sources;
    the inter reference a good one on the left of each tile and an
    unrelated one on the right (so that inter and intra CUs mix), the
    first plane without a reference (pen 1e30)."""
    H, W = nby * cu, nbx * cu
    nb = nby * nbx
    t = lambda a: torch.as_tensor(a, device=cuda)
    src = _smooth_planes(rng, PT, H, W, maxval)
    ref = np.clip(src + rng.integers(-3, 4, src.shape), 0, maxval).astype(np.int32)
    if mixed:
        ref[:, :, W // 2:] = _smooth_planes(rng, PT, H, W - W // 2, maxval)
    sub = cu // 8
    wgt = t((rng.random((PT, nby * sub, nbx * sub)) < 0.6).repeat(8, 1).repeat(8, 2)
            .astype(np.int32))
    weights = (hevc.block_weights32(wgt, nby, nbx) if cu == 32
               else hevc.block_weights16(wgt, nby, nbx))
    qp = rng.integers(22, 45, PT)
    dq = tab.DQ64[qp].astype(np.int32)
    qstep = dq.astype(np.float32) / np.float32(64)
    pen = np.zeros(PT, np.float32)
    pen[0] = 1e30
    return [t(src), t(ref), *weights, t((rng.random((PT, nb)) * 20).astype(np.float32)),
            t(qstep), t(np.float32(1) / qstep), t(tab.LAMBDA[qp].astype(np.float32)), t(pen),
            t(dq), torch.full((PT,), maxval, dtype=torch.int32, device=cuda)]


@pytest.mark.parametrize("two_level,PT,nby,nbx", [
    (False, 48, 3, 5),   # 144 CUs on diagonal 4, more than the card's 132 SMs
    (True, 40, 4, 8),    # 160 16x16 CUs on diagonals 6-9
    (False, 2, 3, 1), (False, 2, 8, 3),   # ragged tiles: one CU wide; 8 x 3 CUs
    (True, 2, 3, 1), (True, 2, 8, 3),
])
def test_wavefront_encode_schedule_kernel(cuda, two_level, PT, nby, nbx):
    """Kernel I's single-launch wavefront (per-CU ready flags, CUs taken in
    diagonal order) against the plain version, bit for bit: stacks whose
    diagonals hold more CUs than there are SMs, ragged tiles, planes that
    mix inter and intra CUs."""
    rng = np.random.default_rng(200 + PT + nby + 7 * two_level)
    cu, name = (16, "wavefront_encode16") if two_level else (32, "wavefront_encode32")
    args = _encode_args(rng, cuda, PT, nby, nbx, cu, 2047 if two_level else 1023)
    kern = getattr(hevc, name)
    plain = getattr(hevc, name + "_plain")
    before = dev.LAUNCHES[name]
    got = kern(*args, nby, nbx)
    assert dev.LAUNCHES[name] == before + 1
    want = plain(*args, nby, nbx)
    for a, b in zip(got, want):
        _same(a, b)
    # the decoded mode of every 8x8 area of the planes with a reference
    if two_level:
        split, modes = got[0].long()[..., None], got[1].long()
        eff = torch.where(split != 0, modes, modes[..., :1].expand_as(modes))
    else:
        s32, m32, s16, modes = (got[k].long() for k in (0, 1, 3, 4))
        per16 = torch.where(s16[..., None] != 0, modes, modes[..., :1].expand_as(modes))
        eff = torch.where(s32[..., None, None] != 0, per16, m32[..., None, None].expand_as(per16))
    inter = eff[1:] == tab.MODE_INTER
    if nbx >= 3:   # a good reference on the left of the tile, an unrelated one on the right
        assert 0 < int(inter.sum()) < inter.numel()


def test_rdo_tie_crops_kernel(cuda):
    """The committed RD tie crops through kernel I on the card: the 32x32
    crop (vpcc_tpu_torch/data/rdo_tie_crop.npy, the tie of
    tests/test_torch_video_encode.py) must choose mode 33 at CU (1, 6), and
    the 16/8 crop (rdo_tie_crop16.npz); both payloads and reconstructions
    equal the plain path's, which the CPU tests hold to the JAX encoder's."""
    from pathlib import Path

    data = Path(hevc.__file__).resolve().parents[1] / "data"
    crop = np.load(data / "rdo_tie_crop.npy")
    z = np.load(data / "rdo_tie_crop16.npz")
    cases = [(crop[:1].astype(np.int32), crop[1].astype(np.int32), 24, 255,
              "wavefront_encode32"),
             (z["plane"].astype(np.int32)[None], z["weight"].astype(np.int32), int(z["qp"]),
              2047, "wavefront_encode16")]
    for plane, weight, qp, maxval, name in cases:
        kw = dict(deblock=False)
        want, rec_p = hevc.encode_planes(torch.as_tensor(plane), [qp], [maxval],
                                         weight=torch.as_tensor(weight), **kw)
        before = dev.LAUNCHES[name]
        got, rec_k = hevc.encode_planes(torch.as_tensor(plane, device=cuda), [qp], [maxval],
                                        weight=torch.as_tensor(weight, device=cuda), **kw)
        assert dev.LAUNCHES[name] > before
        assert got == want
        _same(rec_k, rec_p)
        if name == "wavefront_encode32":
            assert hevc.parse_planes32(got)["m32"][0, 1 * 8 + 6] == 33


@pytest.mark.parametrize("motion", [False, True])
def test_encode_planes_on_the_card(cuda, motion):
    """The whole plane encoder on the card equals it on the CPU (payload and
    reconstruction), and the card's decoder reads it back exactly."""
    rng = np.random.default_rng(21 + motion)
    H, W = 192, 288
    planes = _smooth_planes(rng, 2, H, W, 255)
    src, ref = planes[:1], planes[1:]
    occ = (rng.random((H // 8, W // 8)) < 0.7).repeat(8, 0).repeat(8, 1).astype(np.uint8)
    kw = dict(qps=[24], maxvals=[255], occ=occ, weight=occ, deblock=False, motion=motion)
    pay_c, rec_c = hevc.encode_planes(torch.as_tensor(src), refs=torch.as_tensor(ref), **kw)
    pay_g, rec_g = hevc.encode_planes(torch.as_tensor(src, device=cuda),
                                      refs=torch.as_tensor(ref, device=cuda), **kw)
    assert pay_g == pay_c
    _same(rec_g, rec_c)
    _same(hevc.decode_planes(pay_g, refs=torch.as_tensor(ref, device=cuda)), rec_g)


@pytest.mark.parametrize("maxval,qp,big,nbx", [(2047, 30, False, 4), (2047, 4, True, 5),
                                               (255, 20, False, 1)])
def test_wavefront_decode16_kernel(cuda, maxval, qp, big, nbx):
    """Kernel A's two-level entry on random 16/8 syntax (every mode, mixed
    splits; `big` draws levels up to the int16 limit).  One launch a
    call."""
    rng = np.random.default_rng(100 + qp)
    PT, nby = 3, 3
    nb = nby * nbx
    lim = 32767 if big else 40
    args = [
        rng.integers(0, maxval + 1, (PT, nby * 16, nbx * 16)).astype(np.int32),
        rng.integers(0, 2, (PT, nb)).astype(np.int8),
        rng.integers(0, 36, (PT, nb, 4)).astype(np.int8),
        (rng.integers(-lim, lim + 1, (PT, nb, 256))
         * (rng.random((PT, nb, 256)) < 0.1)).astype(np.int16),
        np.full(PT, tab.DQ64[qp], np.int32),
        np.full(PT, maxval, np.int32),
    ]
    t = [torch.as_tensor(a, device=cuda) for a in args]
    before = dev.LAUNCHES["wavefront_decode16"]
    got = hevc.wavefront_decode16(*t, nby, nbx)
    assert dev.LAUNCHES["wavefront_decode16"] == before + 1
    _same(got, hevc.wavefront_decode16_plain(*t, nby, nbx))


@pytest.mark.parametrize("has_ref", [False, True])
def test_wavefront_encode16_kernel(cuda, has_ref):
    """Kernel I's two-level entry against its plain version on 11-bit
    planes (a good reference on the left, an unrelated one on the right)."""
    rng = np.random.default_rng(31 + has_ref)
    PT, nby, nbx = 2, 3, 4
    nb = nby * nbx
    H, W = nby * 16, nbx * 16
    t = lambda a: torch.as_tensor(a, device=cuda)
    src = _smooth_planes(rng, PT, H, W, 2047)
    ref = np.zeros_like(src)
    if has_ref:
        ref = np.clip(src + rng.integers(-6, 7, src.shape), 0, 2047).astype(np.int32)
        ref[:, :, W // 2:] = _smooth_planes(rng, PT, H, W - W // 2, 2047)
    wgt = (rng.random((PT, nby * 2, nbx * 2)) < 0.6).repeat(8, 1).repeat(8, 2)
    w16, w8 = hevc.block_weights16(t(wgt.astype(np.int32)), nby, nbx)
    qp = np.array([30, 40])
    dq = tab.DQ64[qp].astype(np.int32)
    qstep = dq.astype(np.float32) / np.float32(64)
    args = [t(src), t(ref), w16, w8, t((rng.random((PT, nb)) * 20).astype(np.float32)),
            t(qstep), t(np.float32(1) / qstep), t(tab.LAMBDA[qp]),
            torch.full((PT,), 0.0 if has_ref else 1e30, device=cuda), t(dq),
            torch.full((PT,), 2047, dtype=torch.int32, device=cuda)]
    before = dev.LAUNCHES["wavefront_encode16"]
    got = hevc.wavefront_encode16(*args, nby, nbx)
    assert dev.LAUNCHES["wavefront_encode16"] == before + 1   # one launch a call
    want = hevc.wavefront_encode16_plain(*args, nby, nbx)
    for a, b in zip(got, want):
        _same(a, b)
    assert 0 < int(got[0].long().sum()) < got[0].numel()   # split and whole CUs


@pytest.mark.parametrize("motion", [False, True])
def test_encode_planes_two_level_on_the_card(cuda, motion):
    """The two-level plane encoder (maxval 2047: kernels L, J and B at 16-px
    CUs, I's two-level entry, K at 16-px regions) on the card equals it on
    the CPU, payload and reconstruction, and the card's decoder (A's
    two-level entry) reads it back exactly."""
    rng = np.random.default_rng(41 + motion)
    H, W = 160, 288
    planes = _smooth_planes(rng, 2, H, W, 2047)
    src, ref = planes[:1], planes[1:]
    occ = (rng.random((H // 8, W // 8)) < 0.7).repeat(8, 0).repeat(8, 1).astype(np.uint8)
    kw = dict(qps=[24], maxvals=[2047], occ=occ, weight=occ, deblock=motion, motion=motion)
    pay_c, rec_c = hevc.encode_planes(torch.as_tensor(src), refs=torch.as_tensor(ref), **kw)
    pay_g, rec_g = hevc.encode_planes(torch.as_tensor(src, device=cuda),
                                      refs=torch.as_tensor(ref, device=cuda), **kw)
    assert pay_g[5] & hevc.FLAG_SAO16 and not pay_g[5] & hevc.FLAG_CU32
    assert pay_g == pay_c
    _same(rec_g, rec_c)
    _same(hevc.decode_planes(pay_g, refs=torch.as_tensor(ref, device=cuda)), rec_g)


def _recolor_inputs(rng, cuda):
    """A 7-bit cloud of unique positions; the targets are 70 % of them and
    jittered copies, so that exact and inexact targets and unmatched
    sources all occur."""
    keys = rng.choice(1 << 21, 30000, replace=False)
    sp = np.stack([keys >> 14, (keys >> 7) & 127, keys & 127], 1).astype(np.int32)
    sc = rng.integers(0, 256, sp.shape).astype(np.uint8)
    pick = rng.permutation(len(sp))[:21000]
    tp = sp[pick].copy()
    tp[::3] = np.clip(tp[::3] + rng.integers(-2, 3, tp[::3].shape), 0, 127)
    return (torch.as_tensor(sp, device=cuda), torch.as_tensor(sc, device=cuda),
            torch.as_tensor(tp, device=cuda))


@pytest.mark.parametrize("case,k,k_bwd", [("mixed", 8, 1), ("mixed", 8, 0), ("mixed", 1, 0),
                                           ("no_exact", 8, 1), ("all_exact", 8, 1),
                                           ("all_matched", 8, 1), ("duplicates", 8, 1),
                                           ("out_of_grid", 1, 1), ("after_larger", 8, 1)])
def test_recolor_kernel(cuda, case, k, k_bwd):
    """Kernel M's two entries against their plain versions on the same
    k-NN results (`torch_md_cases.recolor_case`: no exact hit, every target
    exact, every source matched, duplicated source positions, targets
    outside the grid; k = 1 and 8, k_bwd 0 and 1; a call after a larger one,
    whose scratch holds another cloud's), the single-frame exact match, and
    the whole transfer on the card against the CPU's: two launches and one
    host synchronisation (the counts) a transfer."""
    if case == "after_larger":
        big = [torch.as_tensor(a, device=cuda) for a in recolor_case("mixed", bits=8, n=200_000,
                                                                     seed=41)]
        recolor.transfer_colors_compact(*big, grid_bits=8)
    sp, sc, tp = (torch.as_tensor(a, device=cuda)
                  for a in recolor_case("mixed" if case == "after_larger" else case, seed=40))
    order, sk = recolor.sorted_source_keys(sp, 7)
    got = recolor.exact_compact(order, sk, sp, tp, 7)
    for a, b in zip(got, recolor.exact_compact_plain(order, sk, sp, tp, 7)):
        _same(a, b)
    for a, b in zip(recolor.exact_match(order, sk, tp, 7), recolor.exact_match_plain(order, sk,
                                                                                    tp, 7)):
        _same(a, b)
    eidx, has, iidx, tq, uidx, sq = got
    assert (iidx.numel() == 0) == (case in ("all_exact", "all_matched"))
    assert (uidx.numel() == 0) == (case == "all_matched")
    idx = d2 = torch.zeros((0, k), dtype=torch.int32, device=cuda)
    if iidx.numel():
        idx, d2 = neighbors.knn(neighbors.build_grid(sp, 7), tq, k=k, bucket=6)
    tidx = td2 = torch.zeros(0, dtype=torch.int32, device=cuda)
    if k_bwd and uidx.numel():
        tidx, td2 = neighbors.nearest(neighbors.build_grid(tp, 7), sq, bucket=6)
    else:
        uidx = tidx
    args = (sc, eidx, has, iidx, idx, d2, uidx, tidx, td2, 30.0, 2000.0, 4.0, 3.0)
    _same(recolor.blend_merge(*args), recolor.blend_merge_plain(*args))
    kw = dict(grid_bits=7, k=k, k_bwd=k_bwd)
    n0 = dev.LAUNCHES["recolor"]
    (card, _), syncs = _syncs(lambda: recolor.transfer_colors_compact(sp, sc, tp, **kw))
    assert dev.LAUNCHES["recolor"] == n0 + 2 and syncs == 1
    host, _ = recolor.transfer_colors_compact(sp.cpu(), sc.cpu(), tp.cpu(), **kw)
    _same(card, host)


def _level_clouds(rng, cuda, B=3, case=None):
    """B padded frames of `_recolor_inputs` clouds (or, given `case`,
    `torch_md_cases.recolor_case` clouds) of different counts (the level
    path's layout: rows out of the grid at -2^20)."""
    clouds = [_recolor_inputs(rng, cuda) if case is None else
              [torch.as_tensor(a, device=cuda) for a in recolor_case(case, seed=b)]
              for b in range(B)]
    cuts = [(min(30000, c[0].shape[0]) - 997 * b, min(21000, c[2].shape[0]) - 1301 * b)
            for b, c in enumerate(clouds)]
    ns, nt = max(c[0] for c in cuts) + 50, max(c[1] for c in cuts) + 70
    pad = -(1 << 20)
    sp = torch.full((B, ns, 3), pad, dtype=torch.int32, device=cuda)
    sc = torch.zeros((B, ns, 3), dtype=torch.uint8, device=cuda)
    tp = torch.full((B, nt, 3), pad, dtype=torch.int32, device=cuda)
    for b, ((p, c, t), (a, m)) in enumerate(zip(clouds, cuts)):
        sp[b, :a], sc[b, :a], tp[b, :m] = p[:a], c[:a], t[:m]
    cnt = torch.tensor([a for a, _ in cuts], device=cuda)
    return sp, sc, cnt, tp


@pytest.mark.parametrize("k,bucket", [(1, 6), (8, 6), (16, 16), (64, 6)])
def test_grid_knn_batch_kernel(cuda, k, bucket):
    """Kernel E's frame-batched entry against its plain version and against
    each frame's own grid and query, padded rows included."""
    sp, _, _, tp = _level_clouds(np.random.default_rng(90 + k), cuda)
    grids = neighbors.build_grid_batch(sp, 7)
    n0 = dev.LAUNCHES["grid_knn_batch"]
    got = neighbors.knn_batch(grids, tp, k, bucket)
    assert dev.LAUNCHES["grid_knn_batch"] == n0 + 1
    want = neighbors.knn_batch_plain(grids, tp, k, bucket)
    for a, b in zip(got, want):
        _same(a, b)
    for b in range(sp.shape[0]):
        one = neighbors.knn(neighbors.build_grid(sp[b], 7), tp[b].contiguous(), k=k,
                            bucket=bucket)
        _same(got[0][b], one[0])
        _same(got[1][b], one[1])


def test_grid_knn_batch_fill_kernel(cuda):
    """B = 3 frames of very different fill (a full frame, a sparse one, one
    of 40 points), each against its own grid and the plain version."""
    rng = np.random.default_rng(95)
    sp, _, _, tp = _level_clouds(rng, cuda)
    pad = -(1 << 20)
    sp[1, 3000:] = pad    # a sparse frame
    sp[2, 40:] = pad      # nearly empty
    grids = neighbors.build_grid_batch(sp, 7)
    n0 = dev.LAUNCHES["grid_knn_batch"]
    got = neighbors.knn_batch(grids, tp, 8, 6)
    assert dev.LAUNCHES["grid_knn_batch"] == n0 + 1
    want = neighbors.knn_batch_plain(grids, tp, 8, 6)
    for a, b in zip(got, want):
        _same(a, b)
    for b in range(3):
        one = neighbors.knn(neighbors.build_grid(sp[b], 7), tp[b].contiguous(), k=8, bucket=6)
        _same(got[0][b], one[0])
        _same(got[1][b], one[1])


@pytest.mark.parametrize("case", [None, "duplicates", "out_of_grid", "all_exact"])
def test_recolor_batch_kernel(cuda, case):
    """Kernel M's frame-batched exact match and blend against their plain
    versions (one launch each, no host synchronisation), and the level
    recolor on the card against the CPU's."""
    from vpcc_tpu_torch.parallel import gof

    sp, sc, cnt, tp = _level_clouds(np.random.default_rng(95), cuda, case=case)
    order, sk = recolor.sorted_source_keys_batch(sp, cnt, 7)
    n0 = dev.LAUNCHES["recolor_exact_batch"]
    got = _no_sync(lambda: recolor.exact_match_batch(order, sk, tp, 7))
    assert dev.LAUNCHES["recolor_exact_batch"] == n0 + 1
    for a, b in zip(got, recolor.exact_match_batch_plain(order, sk, tp, 7)):
        _same(a, b)
    eidx, has, matched = got
    idx, d2 = neighbors.knn_batch(neighbors.build_grid_batch(sp, 7), tp, 8, 6)
    tidx, td2 = neighbors.knn_batch(neighbors.build_grid_batch(tp, 7), sp, 1, 6)
    td2 = torch.where(matched, torch.full_like(td2[..., 0], neighbors.MAX_DIST2), td2[..., 0])
    args = (sc, idx, d2, tidx[..., 0].contiguous(), td2.contiguous(), eidx, has, 30.0, 2000.0,
            4.0, 3.0)
    n0 = dev.LAUNCHES["recolor_blend_batch"]
    out = _no_sync(lambda: recolor.blend_batch(*args))
    assert dev.LAUNCHES["recolor_blend_batch"] == n0 + 1
    _same(out, recolor.blend_batch_plain(*args))
    gates = (30.0, 3.0, 2000.0, 4.0)
    card = gof.recolor_level(sp, sc, cnt, tp, None, 7, gates=gates)
    host = gof.recolor_level(sp.cpu(), sc.cpu(), cnt.cpu(), tp.cpu(), None, 7, gates=gates)
    _same(card, host)


def test_presmooth_kernel(cuda):
    rng = np.random.default_rng(50)
    keys = rng.choice(1 << 18, 20000, replace=False)
    pos = np.stack([keys >> 12, (keys >> 6) & 63, keys & 63], 1).astype(np.int32)
    col = ((pos // 8) * np.array([37, 91, 53]) % 256).astype(np.int32)
    noisy = rng.random(len(pos)) < 0.2
    col[noisy] = rng.integers(0, 256, (int(noisy.sum()), 3))
    bnd = torch.as_tensor(rng.random(len(pos)) < 0.5, device=cuda)
    p, c = torch.as_tensor(pos, device=cuda), torch.as_tensor(col, device=cuda)
    bidx = torch.nonzero(bnd).flatten()
    nidx, nd2 = neighbors.knn(neighbors.build_grid(p, 6), p[bidx].contiguous(), k=64, bucket=6)
    args = (c, nidx, nd2, bidx)
    got = smoothing.presmooth_vote(*args, c.clone(), 64.0, 10.0, 3.0)
    _same(got, smoothing.presmooth_vote_plain(*args, c.clone(), 64.0, 10.0, 3.0))
    assert (got[bidx] != c[bidx]).any(1).any() and (got[bidx] == c[bidx]).all(1).any()
    _same(got[~bnd], c[~bnd])
    whole = smoothing.presmooth_colors(p, c, bnd, 6, 64, 64.0, 10.0, 3.0)
    _same(whole, smoothing.presmooth_colors(p.cpu(), c.cpu(), bnd.cpu(), 6, 64, 64.0, 10.0, 3.0))


@pytest.mark.parametrize("case", PRESMOOTH_CASES)
def test_presmooth_kernel_cases(cuda, case):
    """Kernel N against its plain version on crafted neighbour rows: queries
    without a valid neighbour, with one (n = 1), entropies exactly at
    thr_entropy and one float32 step below it (the kernel's exact runs),
    the cloud's first and last rows; one launch, no host wait, the rows not
    voted untouched."""
    colors, nidx, nd2, bidx, r2, td, te = presmooth_case(case)
    t = lambda a: torch.as_tensor(a, device=cuda)
    c, ni, nd, b = t(colors), t(nidx), t(nd2), t(bidx)
    out = torch.full_like(c, -1)
    got, launches = _one_launch_no_sync(
        "presmooth", lambda: smoothing.presmooth_vote(c, ni, nd, b, out, r2, td, te))
    assert got is out and launches == 1
    want = smoothing.presmooth_vote_plain(c.cpu(), ni.cpu(), nd.cpu(), b.cpu(),
                                          torch.full_like(c.cpu(), -1), r2, td, te)
    _same(got, want)
    changed = (got[b] != c[b]).any(1)
    assert changed.any() and (case == "end_rows" or not changed.all())


def _one_launch_no_sync(name, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error") (a host wait
    raises), and the launches it added to dev.LAUNCHES[name]."""
    torch.cuda.synchronize()
    before = dev.LAUNCHES[name]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, dev.LAUNCHES[name] - before


# (case, P, H, W, maxval): stacks of 1, 3 and 43 planes; H = 8 (no
# horizontal edge) and W = 8 (no vertical edge); W = 264 (a narrow last
# strip); samples at 0 and at maxval under a large tc (both clamps);
# qps whose tc is 0 and qps at and past the table's end; steps whose delta
# is one below 10 tc (filtered) and at it (not filtered)
DEBLOCK_CASES = [("random", 1, 64, 96, 255), ("random", 3, 64, 96, 255),
                 ("random", 43, 64, 64, 255), ("random", 3, 8, 96, 255),
                 ("random", 3, 96, 8, 255), ("random", 2, 48, 264, 255),
                 ("clamp", 3, 64, 136, 1023), ("clamp", 3, 64, 136, 2047),
                 ("tc", 4, 64, 96, 255), ("threshold", 2, 64, 96, 255)]


@pytest.mark.parametrize("case,P,H,W,maxval", DEBLOCK_CASES)
def test_deblock_kernel(cuda, case, P, H, W, maxval):
    rng = np.random.default_rng(60 + P + H + W + maxval)
    qps = rng.integers(10, 52, P)
    if case == "random":
        rec = rng.integers(0, maxval + 1, (P, H, W))
        rec[:, :, W // 2:] //= 5
    elif case == "clamp":
        rec = rng.choice([0, maxval, maxval // 2], (P, H, W), p=[0.4, 0.4, 0.2])
        rec = np.where(rng.random((P, H, W)) < 0.3, rng.integers(0, maxval + 1, (P, H, W)), rec)
        qps[:] = 51
    elif case == "tc":
        rec = rng.integers(0, maxval + 1, (P, H, W))
        qps = np.array([-4, 15, 51, 60])   # tc 0, tc 0, TC_TAB[53], clamped to 53
    else:
        # 8x8 blocks of a and a + D in a checkerboard, qp 37 (tc 5): the
        # step D = 130 gives |delta| = 49 < 10 tc up and down, D = 133
        # gives 50 (floor((9 - 3) D + 8) / 16) and its negative)
        yy, xx = np.mgrid[0:H, 0:W]
        check = ((yy // 8 + xx // 8) % 2)[None]
        rec = 60 + check * np.array([130, 133])[:, None, None]
        qps[:] = 37
        assert int(tab.TC_TAB[39]) == 5
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=cuda)
    r, q, mv = t(rec), t(qps), t(np.full(P, maxval))
    got, launches = _one_launch_no_sync("deblock", lambda: hevc.deblock_planes(r, q, mv))
    want = hevc.deblock_planes_plain(r, q, mv)
    _same(got, want)
    assert launches == 1
    if case == "threshold":   # the D = 130 plane filtered, the D = 133 plane not
        assert not torch.equal(want[0], r[0]) and torch.equal(want[1], r[1])
    else:
        assert not torch.equal(want, r)


def test_deblock_refuses_unaligned_kernel(cuda):
    """Kernel O moves 16-byte words: planes off 16 bytes are refused before
    any launch."""
    buf = torch.zeros(2 * 16 * 16 + 1, dtype=torch.int32, device=cuda)
    off = buf[1:].view(2, 16, 16)
    q = torch.full((2,), 30, dtype=torch.int32, device=cuda)
    before = dev.LAUNCHES["deblock"]
    with pytest.raises(ValueError, match="16 bytes"):
        hevc.deblock_planes(off, q, q)
    assert dev.LAUNCHES["deblock"] == before


def test_attr_image_kernel(cuda):
    """Paint (with duplicate (pixel, layer) rows: the highest row wins on
    both), fill, group dilation and gather; each entry counts its own
    launches."""
    rng = np.random.default_rng(70)
    H, W, n = 96, 128, 9000
    flat = rng.integers(0, H * W, n)
    pix = torch.as_tensor(np.stack([flat % W, flat // W], 1).astype(np.int32), device=cuda)
    layer = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32), device=cuda)
    col = torch.as_tensor(rng.integers(-10, 266, (n, 3)).astype(np.int32), device=cuda)
    before = {k: dev.LAUNCHES[k] for k in ("attr_paint", "attr_group_dilate", "attr_gather")}
    got = pipeline.paint_attribute(pix, layer, col, H, W)
    _same(got, pipeline.paint_attribute_plain(pix, layer, col, H, W))
    occ = torch.as_tensor((rng.random((H, W)) < 0.5).astype(np.uint8), device=cuda)
    filled = padding.fill_rgb(got, occ)
    d_k = pipeline.group_dilate(filled, occ)
    d_p = pipeline.group_dilate_plain(filled, occ)
    _same(d_k[0], d_p[0])
    _same(d_k[1], d_p[1])
    a0, a1 = d_k[0].to(torch.uint8), d_k[1].to(torch.uint8)
    _same(pipeline.gather_decoded_colors(pix, layer, a0, a1),
          pipeline.gather_decoded_colors_plain(pix, layer, a0, a1))
    assert {k: dev.LAUNCHES[k] - v for k, v in before.items()} == {
        "attr_paint": 2, "attr_group_dilate": 1, "attr_gather": 1}


@pytest.mark.parametrize("H,W", [(96, 128), (36, 51)])   # rows on and off 16 bytes
def test_attr_entries_duplicates_kernel(cuda, H, W):
    """Kernel P's five entries on duplicate-heavy pixels (~8 rows a pixel),
    tags outside 0..2 (-1, 3: never paint; gather reads image 0), pixels
    outside the image (dropped by paint, clamped by gather) and colors
    outside 0..255, against the plain versions."""
    rng = np.random.default_rng(72 + H)
    n = H * W
    flat = rng.integers(0, H * W // 8, n)
    x = flat % W + rng.integers(-2, 3, n) * W * (rng.random(n) < 0.1)
    y = flat // W - H * (rng.random(n) < 0.05)
    t = lambda a: torch.as_tensor(a, device=cuda)
    pix = t(np.stack([x, y], 1).astype(np.int32))
    layer = t(rng.integers(-1, 4, n).astype(np.int32))
    col = t(rng.integers(-10, 266, (n, 3)).astype(np.int32))
    val = t(rng.integers(0, 65536, n).astype(np.int32))
    planes = pipeline.paint_attribute(pix, layer, col, H, W)
    _same(planes, pipeline.paint_attribute_plain(pix, layer, col, H, W))
    occ = t((rng.random((H, W)) < 0.5).astype(np.uint8))
    filled = t(rng.integers(0, 256, (2, 3, H, W)).astype(np.int32))
    for a, b in zip(pipeline.group_dilate(filled, occ), pipeline.group_dilate_plain(filled, occ)):
        _same(a, b)
    a0, a1 = (t(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)) for _ in range(2))
    _same(pipeline.gather_decoded_colors(pix, layer, a0, a1),
          pipeline.gather_decoded_colors_plain(pix, layer, a0, a1))
    sc = pipeline.paint_scalar(pix, layer, val, H, W)
    _same(sc, pipeline.paint_scalar_plain(pix, layer, val, H, W))
    i0, i1 = sc[0].contiguous(), sc[1].contiguous()
    _same(pipeline.gather_decoded_scalar(pix, layer, i0, i1),
          pipeline.gather_decoded_scalar_plain(pix, layer, i0, i1))


def test_attr_entries_refuse_ragged_planes_kernel(cuda):
    """Kernel P's pixel passes take whole 16-byte words: a plane whose pixel
    count is not a multiple of 4, or a plane stack off 16 bytes, is refused
    by the wrapper before any launch."""
    n = 64
    pix = torch.zeros((n, 2), dtype=torch.int32, device=cuda)
    layer = torch.zeros(n, dtype=torch.int32, device=cuda)
    col = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
    before = dict(dev.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 4"):
        pipeline.paint_attribute(pix, layer, col, 37, 51)
    with pytest.raises(ValueError, match="multiple of 4"):
        pipeline.paint_scalar(pix, layer, col[:, 0].contiguous(), 37, 51)
    with pytest.raises(ValueError, match="multiple of 4"):
        pipeline.group_dilate(torch.zeros((2, 3, 37, 51), dtype=torch.int32, device=cuda),
                              torch.zeros((37, 51), dtype=torch.uint8, device=cuda))
    off = torch.zeros(2 * 3 * 8 * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(2, 3, 8, 8)
    with pytest.raises(ValueError, match="16 bytes"):
        pipeline.group_dilate(off, torch.zeros((8, 8), dtype=torch.uint8, device=cuda))
    assert dict(dev.LAUNCHES) == before


# (H, W, B, form): the smallest image; W = 130 (not a multiple of 4: the
# quad form); a batch of 3 as one tensor and as a list of images; a list
# whose images lie off their word alignment (the quad form); the bench's
# 1280 x 1280 atlas
COLOR_CASES = [(2, 2, 1, "tensor"), (96, 130, 1, "tensor"), (96, 128, 3, "tensor"),
               (96, 128, 3, "list"), (64, 96, 2, "unaligned"), (1280, 1280, 1, "tensor")]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("H,W,B,form", COLOR_CASES)
def test_color_convert_kernel(cuda, H, W, B, form, dtype):
    """Both entries of kernel Q, on uint8 (decoded) and int32 (encoder)
    RGB with the saturated corners of the RGB cube: `rgb_to_planes` equals
    the plain conversion of each image, its chroma tensor the stack of the
    plain cb and cr; `_int_planes_to_rgb` equals its plain version given
    cb and cr as the two planes of one chroma tensor.  One launch a call,
    no host synchronisation."""
    rng = np.random.default_rng(80 + H + W + B)
    rgb = rng.integers(0, 256, (B, H, W, 3))
    corners = np.array([[0, 0, 255], [255, 0, 0], [0, 255, 0], [255, 255, 255],
                        [0, 0, 0], [255, 255, 0], [0, 255, 255], [255, 0, 255]])
    rgb[0].reshape(-1, 3)[:min(H * W, 8)] = corners[:H * W]
    attr = torch.as_tensor(rgb, device=cuda).to(dtype)
    if form == "list":
        attr = list(attr)
    elif form == "unaligned":
        n = H * W * 3
        buf = torch.zeros(B * n + B, dtype=dtype, device=cuda)
        attr = [buf[b * n + b + 1:(b + 1) * n + b + 1].view(H, W, 3) for b in range(B)]
        for b, im in enumerate(attr):
            im.copy_(torch.as_tensor(rgb[b], device=cuda).to(dtype))
    elif B == 1:
        attr = attr[0]
    (y, chroma), launches = _one_launch_no_sync("color_convert",
                                                lambda: hevc.rgb_to_planes(attr))
    assert launches == 1 and y.shape == (B, H, W) and chroma.shape == (B, 2, H // 2, W // 2)
    imgs = attr if isinstance(attr, list) else (attr[None] if attr.ndim == 3 else attr)
    for b, im in enumerate(imgs):
        wy, wcb, wcr = hevc.rgb_to_int_planes_plain(im)
        _same(y[b], wy)
        _same(chroma[b], torch.stack([wcb, wcr]))
    py, pc = hevc.rgb_to_planes_plain(attr)
    _same(y, py)
    _same(chroma, pc)
    if not isinstance(attr, list) and attr.ndim == 3:   # the single-image view of the entry
        for a, b in zip(hevc._rgb_to_int_planes(attr), hevc.rgb_to_int_planes_plain(attr)):
            _same(a, b)
    ry = torch.as_tensor(rng.integers(0, 256, (H, W)).astype(np.int32), device=cuda)
    rc = torch.as_tensor(rng.integers(0, 256, (2, H // 2, W // 2)).astype(np.int32),
                         device=cuda)
    for yy, cc_ in ((ry, rc), (y[0], chroma[0])):
        got, launches = _one_launch_no_sync(
            "color_convert", lambda: hevc._int_planes_to_rgb(yy, cc_[0], cc_[1]))
        _same(got, hevc.int_planes_to_rgb_plain(yy, cc_[0], cc_[1]))
        assert launches == 1


def _r_same(got, want):
    """Kernel R's result against its plain version's: the maximum d2 and
    the D1 sum bit for bit, the float64 sums to 1e-9 (R_FLOAT_RTOL in
    chip_smoke.py: another summation order)."""
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[:, :2], want[:, :2]), (got, want)
    torch.testing.assert_close(got[:, 2:], want[:, 2:], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("with_normals,with_colors", [(True, True), (False, False)])
def test_metrics_kernel(cuda, with_normals, with_colors):
    """Kernel R on both directions of a jittered cloud: the maximum d2 and
    the D1 sum exact, the float64 sums to 1e-9 (another summation order)."""
    from vpcc_tpu_torch.ops import metrics

    rng = np.random.default_rng(90)
    n = 50_000
    pa = rng.integers(0, 256, (n, 3)).astype(np.int32)
    pb = np.clip(pa + rng.integers(-2, 3, pa.shape), 0, 255).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    ca = t(rng.integers(0, 256, (n, 3)).astype(np.uint8)) if with_colors else None
    cb = t(rng.integers(0, 256, (n, 3)).astype(np.uint8)) if with_colors else None
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nb = t(nrm / np.linalg.norm(nrm, axis=1, keepdims=True)) if with_normals else None
    pa_t, pb_t = t(pa), t(pb)
    idx, d2 = neighbors.nearest(neighbors.build_grid(pb_t, 8), pa_t)
    ib, db = neighbors.nearest(neighbors.build_grid(pa_t, 8), pb_t)
    dirs = [(pa_t, ca, pb_t, cb, nb, idx, d2, n - 7), (pb_t, cb, pa_t, ca, nb, ib, db, n)]
    got = metrics.metrics_reduce(dirs)
    _r_same(got, metrics.metrics_reduce_plain(dirs))
    assert ((got[:, 2] > 0) == with_normals).all() and ((got[:, 3] > 0) == with_colors).all()


def _r_dirs(rng, na: int, nb: int, cuda, colors=True, normals=True, shift=0, cnt_a=None):
    """Both directions of kernel R between a random 10-bit cloud of na
    points and a jittered copy of nb (shifted by `shift` on x), with the
    port's nearest searches (the misses searched on the host)."""
    from vpcc_tpu_torch.ops import metrics

    keys = rng.choice(1 << 30, max(na, nb), replace=False)
    pos = np.stack([keys >> 20, (keys >> 10) & 1023, keys & 1023], 1).astype(np.int32)
    pa = pos[:na]
    pb = np.clip(pos[:nb] + rng.integers(-2, 3, (nb, 3)) + [shift, 0, 0], 0, 1023)
    t = lambda a: torch.as_tensor(a, device=cuda)
    pa_t, pb_t = t(pa), t(pb.astype(np.int32))
    ca = t(rng.integers(0, 256, (na, 3)).astype(np.uint8)) if colors else None
    cb = t(rng.integers(0, 256, (nb, 3)).astype(np.uint8)) if colors else None
    unit = lambda m: t((lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
        rng.standard_normal((m, 3))).astype(np.float32))
    nrm_a, nrm_b = (unit(na), unit(nb)) if normals else (None, None)
    (ia, da), (ib, db) = metrics._nearest_exact([(pa_t, pb_t), (pb_t, pa_t)], 10)
    return [(pa_t, ca, pb_t, cb, nrm_b, ia, da, na if cnt_a is None else cnt_a),
            (pb_t, cb, pa_t, ca, nrm_a, ib, db, nb)]


@pytest.mark.parametrize("na,nb,colors,normals", [
    (607_162, 573_865, True, True),      # the bench frame's rows: bucket 3 * 2^18
    (1_000_003, 900_000, True, True),    # bucket 2^20
    (9_435, 5_000, False, True),         # buckets 12,288 ([32, 32, 12]) and 8,192
    (3_048_337, 2_432_872, True, False),  # the vox11 frame's: bucket 3 * 2^20
])
def test_metrics_fused_kernel(cuda, na, nb, colors, normals):
    """Kernel R's one launch over both directions against its plain
    version: the maximum d2 and the D1 sum bit for bit, the float64 sums to
    1e-9; repeated launches give the same bits."""
    from vpcc_tpu_torch.ops import metrics

    dirs = _r_dirs(np.random.default_rng(na), na, nb, cuda, colors, normals)
    got, launches = _one_launch_no_sync("metrics", lambda: metrics.metrics_reduce(dirs))
    assert launches == 1
    _r_same(got, metrics.metrics_reduce_plain(dirs))
    for _ in range(3):
        assert torch.equal(metrics.metrics_reduce(dirs), got)
    assert ((got[:, 3:] > 0).all() if colors else not got[:, 3:].any())
    assert ((got[:, 2] > 0).all() if normals else not got[:, 2].any())


@pytest.mark.parametrize("case", ["misses", "cnt_a_0", "one_direction"])
def test_metrics_fused_kernel_edges(cuda, case):
    """Kernel R on a reconstruction shifted past the grid's cell window (most
    queries of both directions taken by the host search), with a direction
    that counts none of its rows, and refusing one direction alone."""
    from vpcc_tpu_torch.ops import metrics

    rng = np.random.default_rng(7)
    dirs = _r_dirs(rng, 50_000, 40_000, cuda, shift=40 if case == "misses" else 0,
                   cnt_a=0 if case == "cnt_a_0" else None)
    if case == "one_direction":
        with pytest.raises(ValueError, match="directions"):
            metrics.metrics_reduce(dirs[1:])
    got = metrics.metrics_reduce(dirs)
    _r_same(got, metrics.metrics_reduce_plain(dirs))
    if case == "cnt_a_0":
        assert not got[0].any() and got[1].all()
    if case == "misses":
        assert got[:, 0].min() > 1000


def test_compute_metrics_host_reads(cuda):
    """`compute_metrics` on the card with both clouds' normals given and no
    query missing the grid: two host reads (the miss counts, the result),
    one launch of kernel R."""
    from vpcc_tpu_torch.ops import metrics

    rng = np.random.default_rng(3)
    pa_t, ca, pb_t, cb, nb, *_ = _r_dirs(rng, 50_000, 50_000, cuda)[0]
    na = torch.nn.functional.normalize(torch.randn(pa_t.shape, device=cuda), dim=1)
    n0 = dev.LAUNCHES["metrics"]
    m, syncs = _syncs(lambda: metrics.compute_metrics(pa_t, ca, pb_t, cb, 1023, src_normals=na,
                                                      rec_normals=nb, device=cuda))
    assert syncs == 2 and dev.LAUNCHES["metrics"] == n0 + 1
    host = metrics.compute_metrics(pa_t.cpu(), ca.cpu(), pb_t.cpu(), cb.cpu(), 1023,
                                   src_normals=na.cpu(), rec_normals=nb.cpu(), device="cpu")
    assert (m.c2c_mse, m.c2c_hausdorff) == (host.c2c_mse, host.c2c_hausdorff)
    assert abs(m.c2p_psnr - host.c2p_psnr) < 1e-6
    assert abs(m.color_psnr[0] - host.color_psnr[0]) < 1e-6


@pytest.mark.parametrize("n,frac,n_aux", [(0, 0.0, 1), (3000, 0.0, 1), (700_000, 0.007, 5000),
                                          (700_000, 0.007, 100)])
def test_eom_colors_kernel(cuda, n, frac, n_aux):
    """Kernel S: no rows, no tag-2 rows, ~4.9k tag-2 rows over several tiles
    with an aux that covers them or is shorter (the last sample repeats)."""
    rng = np.random.default_rng(n + n_aux)
    layer = np.where(rng.random(n) < frac, 2, rng.integers(0, 2, n)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    lay, col = t(layer), t(rng.integers(0, 256, (n, 3)).astype(np.int32))
    aux = t(rng.integers(0, 256, (n_aux, 3)).astype(np.uint8))
    got = pipeline.extract_eom_colors(lay, col)
    _same(got, pipeline.extract_eom_colors_plain(lay, col))
    assert got.shape[0] == int((layer == 2).sum())
    _same(pipeline.inject_eom_colors(lay, col, aux), pipeline.inject_eom_colors_plain(lay, col, aux))


@pytest.mark.parametrize("n", [5000, 1_435_657, 2_432_872])
def test_metrics_d2_f32_kernel(cuda, n):
    """Kernel R's D1 sum in XLA's CPU order (inside its one launch) ==
    `d2_sum_f32_plain`, bit for bit, at bucket lengths with a 32-wide and a
    24-wide level."""
    from vpcc_tpu_torch.ops import metrics

    rng = np.random.default_rng(n)
    d2 = torch.as_tensor(rng.integers(0, 41, n).astype(np.int32), device=cuda)
    pos = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
    idx = torch.zeros(n, dtype=torch.int32, device=cuda)
    cap = metrics.shape_bucket(n)
    n0 = dev.LAUNCHES["metrics"]
    got = metrics.metrics_reduce([(pos, None, pos, None, None, idx, d2, n)] * 2)
    assert dev.LAUNCHES["metrics"] == n0 + 1
    want = metrics.d2_sum_f32_plain(d2, n, cap)
    torch.cuda.synchronize()
    assert float(got[0, 1]) == float(want) == float(got[1, 1])


@pytest.mark.parametrize("case", ["empty", "one_cell", "cloud"])
def test_color_smooth_kernel(cuda, case):
    """Kernel T: no rows; one cell holding every row (two patches, close
    colors: smoothed); a vox10 cloud of few-point cells."""
    rng = np.random.default_rng(len(case))
    if case == "empty":
        pts = np.zeros((0, 3), np.int32)
    elif case == "one_cell":
        pts = rng.integers(8, 12, (5000, 3)).astype(np.int32)
    else:
        pts = np.clip(rng.normal(512, 40, (200_000, 3)), 0, 1023).astype(np.int32)
    n = len(pts)
    col = np.clip(rng.integers(95, 101, (n, 3)) + (rng.random((n, 3)) < 0.01) * 40, 0,
                  255).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    args = (t(pts), t(col), t(rng.integers(0, 2, n).astype(np.int32)), t(rng.random(n) < 0.8))
    before = dev.LAUNCHES["color_smooth"]
    got = smoothing.color_smoothing_grid(*args, 10.0, 6.0, 4, 10)
    assert dev.LAUNCHES["color_smooth"] == before + (2 if n else 0)
    _same(got, smoothing.color_smoothing_grid_plain(*args, 10.0, 6.0, 4, 10))
    if n:
        assert (got.cpu().numpy() != col).any()


def _pbf_scene(rng, n_patch):
    """A 128 x 128 canvas of 8-pixel blocks: `n_patch` patches of 2 x 2
    blocks over one small world box, every orientation and axis order."""
    h = w = 128
    res = 8
    occ = np.zeros((h, w), np.uint8)
    btp = np.zeros((h // res, w // res), np.int32)
    tbl = np.zeros((64, 16), np.int32)
    perms = [(2, 0, 1), (0, 2, 1), (1, 2, 0), (2, 1, 0), (0, 1, 2), (1, 0, 2)]
    for p in range(n_patch):
        bx, by = (p % 6) * 2 + (p // 6), (p // 6) * 3
        na, ta, ba = perms[p % 6]
        tbl[p] = [bx, by, 2, 2, rng.integers(0, 6), rng.integers(0, 6), rng.integers(0, 6),
                  na, ta, ba, p % 2, p % 8, 1 if p == 11 else 0, 5, 1, 1]
        btp[by:by + 2, bx:bx + 2] = p + 1
        blk = rng.random((2 * res, 2 * res)) < 0.97
        blk[3:13, 3:13] = True
        occ[by * res:(by + 2) * res, bx * res:(bx + 2) * res] = blk
    yy, xx = np.mgrid[0:h, 0:w]
    geo = ((xx // 5 + yy // 7) % 5 + rng.integers(0, 2, (h, w))).astype(np.int32)
    return occ, geo, btp, tbl, res


@pytest.mark.parametrize("case", ["no_border", "one_patch", "scene"])
def test_pbf_kernel(cuda, case):
    """Kernel U: an empty occupancy (no border pixel, nothing projected);
    one patch (border pixels, no other patch to project into); twelve
    overlapping patches (a 45-degree one among them), 1 to 4 passes."""
    rng = np.random.default_rng(len(case))
    occ, geo, btp, tbl, res = _pbf_scene(rng, 0 if case == "no_border" else
                                         1 if case == "one_patch" else 12)
    t = lambda a: torch.as_tensor(a, device=cuda)
    args = (t(occ), t(geo), t(btp), t(tbl), res)
    assert pbf.count_border(t(occ), t(btp), res) == pbf.count_border_plain(
        occ=torch.as_tensor(occ), btp=torch.as_tensor(btp), res=res)
    for passes, fs in ((2, 4), (1, 2), (4, 4)):
        got = pbf.pbf_filter_occupancy(*args, passes, fs, 4)
        _same(got, pbf.pbf_filter_occupancy_plain(*args, passes, fs, 4))
    if case == "scene":
        assert (got.cpu().numpy() != occ.astype(bool)).any()


@pytest.mark.parametrize("case", ["one_mode", "one_patch", "planes"])
def test_plr_kernel(cuda, case):
    """Kernel V: the code plane and the RDO with one mode; with every block
    in one patch (one pool, no patch-level mode); random planes and patches
    with all ten modes.  Then the code plane through kernel C's EOM entry,
    counted as its PLR use."""
    rng = np.random.default_rng(len(case))
    h, w, res = 160, 224, 16
    yy, xx = np.mgrid[0:h, 0:w]
    g0t = (30 + (xx // 7) % 4 + (yy // 9) % 3).astype(np.int32)
    g1t = (g0t + rng.integers(0, 5, (h, w))).astype(np.int32)
    g0d = (g0t + rng.integers(-1, 2, (h, w))).astype(np.int32)
    occ = (rng.random((h, w)) < 0.85).astype(np.uint8)
    btp = (np.ones((h // res, w // res)) if case == "one_patch"
           else rng.integers(0, 9, (h // res, w // res))).astype(np.int32)
    tbl = plr.MODE_TABLE[:1 if case == "one_mode" else 10]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)
    args = [t(a) for a in (g0d, g0t, g1t, occ, btp, tbl)]
    got = plr.rdo(*args, res, 9, 64)
    want = plr.rdo_plain(*args, res, 9, 64)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got.inexact == want.inexact == 0
    modes = got.block_modes.to(cuda)
    code = plr.code_plane(args[0], modes, args[5], res)
    _same(code, plr.code_plane_plain(args[0], modes, args[5], res))
    ptable = np.zeros((9, 16), np.int32)
    ptable[:, 2:4] = [w // res, h // res]
    ptable[:, 7:10] = [2, 0, 1]
    before = dev.LAUNCHES["generate_points_plr"]
    rows = reconstruct.generate_points(args[3], args[0], args[0], args[4], t(ptable), res,
                                       eom=code, eom_bits=3, entry="generate_points_plr")
    assert dev.LAUNCHES["generate_points_plr"] == before + 2
    for a, b in zip(rows, reconstruct.generate_points_plain(
            args[3], args[0], args[0], args[4], t(ptable), res, eom=code, eom_bits=3)):
        _same(a, b)


def _fill_case(case: str, cuda):
    """(C, H, W) int32 planes of 0..255 and an (H, W) uint8 occupancy."""
    rng = np.random.default_rng(sum(map(ord, case)))
    shapes = {"random": (3, 96, 128), "odd": (2, 48, 80), "edge_top": (1, 64, 64),
              "edge_corner": (2, 40, 80), "empty": (2, 32, 64), "full": (1, 32, 32),
              "atlas": (6, 1280, 1280)}
    C, H, W = shapes[case]
    occ = np.zeros((H, W), np.uint8)
    if case in ("random", "atlas"):
        occ = (rng.random((H, W)) < 0.3).astype(np.uint8)
        if case == "atlas":
            occ[900:] = 0            # a wide empty band: a few hundred dilation passes
    elif case == "odd":
        occ[5:20, 10:30] = 1
        occ[30:44, 60:78] = rng.random((14, 18)) < 0.7
    elif case == "edge_top":
        occ[0, 5] = 1                # the stencils wrap around the top row
    elif case == "edge_corner":
        occ[H - 1, W - 1] = occ[0, 0] = 1
    elif case == "full":
        occ[:] = 1
    planes = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    return (torch.as_tensor(planes, device=cuda), torch.as_tensor(occ, device=cuda))


@pytest.mark.parametrize("case", ["random", "odd", "edge_top", "edge_corner", "empty", "full",
                                  "atlas"])
def test_bg_fill_kernel(cuda, case):
    """Kernel W (dilation, harmonic and smoothed fills, the fill_rgb modes)
    against their plain versions; the harmonic fill's push counts the sums
    reaching 2^24 as the plain push does."""
    planes, occ = _fill_case(case, cuda)
    before = dev.LAUNCHES["bg_dilate"]
    x_k, n_k = padding.dilate_fill(planes, occ)
    x_p, n_p = padding.dilate_fill_plain(planes, occ)
    assert dev.LAUNCHES["bg_dilate"] == before + 3
    _same(x_k, x_p)
    assert n_k == n_p
    padding.reset_inexact()
    h_p = padding.harmonic_fill_plain(planes, occ)
    n_p = padding.inexact_blocks()
    padding.reset_inexact()
    _same(padding.harmonic_fill(planes, occ), h_p)
    assert padding.inexact_blocks() == n_p
    _same(padding.smooth_fill(planes, occ), padding.smooth_fill_plain(planes, occ))
    want = {0: padding.round_clip_plain(x_p), 2: padding.round_clip_plain(h_p),
            1: torch.stack([padding.push_pull_round_plain(p, occ) for p in planes])}
    for mode, w in want.items():
        _same(padding.fill_rgb(planes, occ, mode), w)


@pytest.mark.parametrize("case", HARMONIC_CASES)
def test_harmonic_kernel(cuda, case):
    """Kernel W's harmonic entry on the crafted cases of
    tests/torch_fill_rdo_cases.py: the float planes, the rounded ones
    (`harmonic_fill(rounded=True)`, `fill_rgb(mode=2)`) and the smoothed
    push-pull bit for bit as the plain versions', also with more steps than
    a tile launch runs (11 a level, 10 after the push-pull), the push's
    count of sums reaching 2^24 as the plain push's; a call makes the
    launches `harmonic_launches` plans (6 on 1280 x 1280 planes, 1 where a
    side is odd) and no host read."""
    planes, occ = (torch.as_tensor(a, device=cuda) for a in harmonic_case(case))
    padding.reset_inexact()
    h_p = padding.harmonic_fill_plain(planes, occ)
    n_p = padding.inexact_blocks()
    padding.reset_inexact()
    before = dev.LAUNCHES["bg_harmonic"]
    h_k, syncs = _syncs(lambda: padding.harmonic_fill(planes, occ))
    launches = dev.LAUNCHES["bg_harmonic"] - before
    _same(h_k, h_p)
    assert padding.inexact_blocks() == n_p
    assert (n_p > 0) == (case == "crafted")
    assert syncs == 0
    assert launches == harmonic_launches(*occ.shape)
    assert launches == 6 or occ.shape != (1280, 1280)
    rounded = padding.round_clip_plain(h_p)
    _same(padding.harmonic_fill(planes, occ, rounded=True), rounded)
    _same(padding.fill_rgb(planes, occ, 2), rounded)
    _same(padding.smooth_fill(planes, occ), padding.smooth_fill_plain(planes, occ))
    before = dev.LAUNCHES["bg_harmonic"]
    _same(padding.harmonic_fill(planes, occ, 11), padding.harmonic_fill_plain(planes, occ, 11))
    assert dev.LAUNCHES["bg_harmonic"] - before == harmonic_launches(*occ.shape, 11, 11)
    _same(padding.smooth_fill(planes, occ, 10), padding.smooth_fill_plain(planes, occ, 10))


@pytest.mark.parametrize("case", RDO_CASES)
def test_rdo_crafted_kernel(cuda, case):
    """Kernel V's RDO on the crafted cases of tests/torch_fill_rdo_cases.py
    (a patch across many scan steps, an index with no block, blocks of
    patch 0, a patch of exactly block_threshold blocks, 1 and 16 modes,
    blocks and a small patch whose sums reach 2^24, 112,640 blocks with
    patches of more than 1,024 blocks under the level flag): the block modes, patch
    levels, patch modes and inexact count equal the plain version's; two
    launches and one host read a call."""
    *arrays, res, threshold, p_max = rdo_case(case)
    args = [torch.as_tensor(np.ascontiguousarray(a), device=cuda) for a in arrays]
    want = plr.rdo_plain(*args, res, threshold, p_max)
    before = dev.LAUNCHES["plr_rdo"]
    got, syncs = _syncs(lambda: plr.rdo(*args, res, threshold, p_max))
    assert dev.LAUNCHES["plr_rdo"] - before == 2 and syncs == 1
    assert all(t.device.type == "cpu" for t in (*got[:3], *want[:3]))   # both on the host
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got.inexact == want.inexact
    assert (got.inexact == 3) == (case == "big")
    level = want.patch_level.numpy()
    assert level[4] and not level[0] and level[6] and level[7]   # 5 == threshold; 7, 8 unused


@pytest.mark.parametrize("limit", [7, 40])
def test_bg_dilate_pass_limit_kernel(cuda, limit):
    """A limit below the passes the plane needs (the level walk stops
    claiming at the limit): the same pixels stay empty."""
    planes, occ = _fill_case("edge_top", cuda)
    x_k, n_k = padding.dilate_fill(planes, occ, limit)
    x_p, n_p = padding.dilate_fill_plain(planes, occ, limit)
    _same(x_k, x_p)
    assert n_k == n_p == limit


def test_attr_scalar_kernel(cuda):
    """Kernel P's scalar paint (duplicates: the highest row wins; tag 2
    never paints; samples above 255 kept) and gather."""
    rng = np.random.default_rng(71)
    H, W, n = 96, 128, 9000
    flat = rng.integers(0, H * W, n)
    pix = torch.as_tensor(np.stack([flat % W, flat // W], 1).astype(np.int32), device=cuda)
    layer = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32), device=cuda)
    val = torch.as_tensor(rng.integers(0, 65536, n).astype(np.int32), device=cuda)
    got = pipeline.paint_scalar(pix, layer, val, H, W)
    _same(got, pipeline.paint_scalar_plain(pix, layer, val, H, W))
    assert int(got.max()) > 255
    img0, img1 = got[0].contiguous(), got[1].contiguous()
    _same(pipeline.gather_decoded_scalar(pix, layer, img0, img1),
          pipeline.gather_decoded_scalar_plain(pix, layer, img0, img1))


def test_orient_viewpoint_kernel(cuda):
    """Kernel X's viewpoint pass on a sphere's normals at two viewpoints, and
    on rows whose dot is exactly 0 or one ulp either side."""
    p, idx, valid = _voxel_graph(cuda)
    n = normals.pca_normals_plain(p, idx, valid)
    for vp in ((0.0, 0.0, 0.0), (512.25, -40.0, 900.5)):
        before = dev.LAUNCHES["orient_viewpoint"]
        got = normals.orient_normals_viewpoint(n, p, vp)
        assert dev.LAUNCHES["orient_viewpoint"] == before + 1
        _same(got, normals.orient_normals_viewpoint_plain(n, p, vp))
    one = np.float32(1.0)
    n1 = [one, np.nextafter(one, np.float32(2)), np.nextafter(one, np.float32(0))]
    nc = torch.as_tensor(np.array([[1.0, v, 0.5] for v in n1], np.float32), device=cuda)
    pc = torch.tensor([[7, 10, 4]] * 3, dtype=torch.int32, device=cuda)
    got = normals.orient_normals_viewpoint(nc, pc, (10.0, 7.0, 4.0))
    _same(got, normals.orient_normals_viewpoint_plain(nc, pc, (10.0, 7.0, 4.0)))
    assert got[:, 0].sign().tolist() == [1.0, -1.0, 1.0]


def _chain(cuda, n):
    """A chain of n rows, row i's one neighbour row i - 1, row 0 the seed:
    the flood needs n - 1 sweeps."""
    pos = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
    pos[:, 0] = torch.arange(n - 1, -1, -1, device=cuda)
    nrm = torch.tensor([[0.0, 0.6, 0.8]], device=cuda).repeat(n, 1)
    nrm[1::2] *= -1
    idx = (torch.arange(n, device=cuda) - 1).clamp(min=0).to(torch.int32)[:, None].repeat(1, 4)
    val = torch.zeros((n, 4), dtype=torch.bool, device=cuda)
    val[1:, 0] = True
    return pos, nrm, idx.contiguous(), val


@pytest.mark.parametrize("case", ["sphere", "wrapped", "chain", "capped"])
def test_orient_flood_kernel(cuda, case):
    """Kernel X's flood against its plain version: the sphere (keys of
    z >= 512 wrap, so the seed is the highest point below), the sphere
    lifted so that every key wraps (the padded rows win: all radial), a
    chain the flood walks in 199 sweeps, and one of 400 rows that the
    256-sweep cap cuts (the rest radial)."""
    if case in ("sphere", "wrapped"):
        p, idx, valid = _voxel_graph(cuda)
        if case == "wrapped":   # z in 512..812: every key wraps negative
            p = p.clone()
            p[:, 2] = 512 + (p[:, 2] - p[:, 2].min()) // 2
        n = normals.pca_normals_plain(p, idx, valid)
        pad = True
    else:
        p, n, idx, valid = _chain(cuda, 200 if case == "chain" else 400)
        pad = False
    rows = torch.ones(p.shape[0], dtype=torch.bool, device=cuda)
    want = normals.orient_normals_spanning_tree_plain(p, n, idx, valid, rows, pad)
    before = dev.LAUNCHES["orient"]
    got = normals.orient_normals_spanning_tree(p, n, idx, valid, rows, pad)
    assert dev.LAUNCHES["orient"] == before + 3
    _same(got, want[0])
    assert normals.last_flood_sweeps == want[1]
    expect = {"wrapped": 0, "chain": 199, "capped": 256}
    if case in expect:
        assert want[1] == expect[case]


@pytest.mark.parametrize("case", DILATE_CASES)
def test_bg_dilate_frontier_kernel(cuda, case):
    """Kernel W's dilation on the crafted cases of the frontier schedule
    (torus wrap, sides of 1 and 2, the cap, empty and full occupancy):
    the float planes, the pass count and fill_rgb(mode=0)'s rounded planes
    against the plain versions; three launches and one host
    synchronisation a call; a second call on the same scratch (the
    kernel's counters left at 0) gives the same."""
    planes, occ, max_iters = dilate_case(case)
    tp, to = torch.as_tensor(planes, device=cuda), torch.as_tensor(occ, device=cuda)
    x_p, n_p = padding.dilate_fill_plain(tp, to, max_iters)
    for _ in range(2):
        before = dev.LAUNCHES["bg_dilate"]
        (x_k, n_k), syncs = _syncs(lambda: padding.dilate_fill(tp, to, max_iters))
        assert dev.LAUNCHES["bg_dilate"] == before + 3 and syncs == 1
        _same(x_k, x_p)
        assert n_k == n_p
        r_k, n_r = padding.dilate_fill(tp, to, max_iters, rounded=True)
        _same(r_k, padding.round_clip_plain(x_p))
        assert n_r == n_p
    if max_iters == padding.DILATE_MAX_PASSES:
        stack = tp[None].expand(2, -1, -1, -1).contiguous()
        before = dev.LAUNCHES["bg_dilate"]
        got = padding.fill_rgb(stack, to, 0)
        assert dev.LAUNCHES["bg_dilate"] == before + 3
        _same(got, padding.round_clip_plain(padding.dilate_fill_plain(stack.reshape(
            -1, *occ.shape), to)[0]).reshape(stack.shape))


def test_bg_dilate_after_larger_kernel(cuda):
    """A small plane after a 1280 x 1280 one (the scratch grown, then
    reused from its start), and a plane whose walk runs 1024 levels."""
    big, big_occ = _fill_case("atlas", cuda)
    small, small_occ, _ = dilate_case("random")
    ts, tso = torch.as_tensor(small, device=cuda), torch.as_tensor(small_occ, device=cuda)
    for planes, occ in ((big, big_occ), (ts, tso)):
        x_k, n_k = padding.dilate_fill(planes, occ)
        x_p, n_p = padding.dilate_fill_plain(planes, occ)
        _same(x_k, x_p)
        assert n_k == n_p
    line = torch.zeros((1, 1, 2100), dtype=torch.int32, device=cuda)
    line[0, 0, 0] = 200
    line_occ = (line[0] > 0).to(torch.uint8)
    x_k, n_k = padding.dilate_fill(line, line_occ)
    x_p, n_p = padding.dilate_fill_plain(line, line_occ)
    _same(x_k, x_p)
    assert n_k == n_p == padding.DILATE_MAX_PASSES


@pytest.mark.parametrize("case", FLOOD_CASES)
def test_orient_flood_frontier_kernel(cuda, case):
    """Kernel X's flood on the crafted cases of the frontier schedule (a
    vote that cancels and is signed two sweeps later, a disconnected
    component, pad_rows, V = 0, a random graph): against the plain
    version with its sweep count; three launches and one host
    synchronisation a call (none for V = 0)."""
    pos, nrm, idx, val, valid, pad = flood_case(case)
    t = [torch.as_tensor(a, device=cuda) for a in (pos, nrm, idx, val, valid)]
    want, sweeps = normals.orient_normals_spanning_tree_plain(*t, pad_rows=pad)
    for _ in range(2):
        before = dev.LAUNCHES["orient"]
        got, syncs = _syncs(lambda: normals.orient_normals_spanning_tree(*t, pad_rows=pad))
        n = 3 if len(pos) else 0
        assert dev.LAUNCHES["orient"] == before + n and syncs == min(n, 1)
        _same(got, want)
        assert normals.last_flood_sweeps == sweeps


@pytest.mark.parametrize("mode", [0, 1, 4])
def test_high_gradient_aux_kernel(cuda, mode):
    """Kernel F's high-gradient entry: random normals and partitions at J =
    6, 10 and 18, with rows on the bisector of two orientations."""
    rng = np.random.default_rng(mode)
    o = segmentation.get_orientations(mode)
    n = rng.normal(size=(50000, 3)).astype(np.float32)
    n[::4] = (o[rng.integers(0, len(o), 12500)] + o[rng.integers(0, len(o), 12500)])
    part = rng.integers(0, len(o), 50000).astype(np.int32)
    t = [torch.as_tensor(a, device=cuda) for a in (n, part, o)]
    before = dev.LAUNCHES["high_gradient_aux"]
    got = segmentation.high_gradient_aux(*t)
    assert dev.LAUNCHES["high_gradient_aux"] == before + 1
    want = segmentation.high_gradient_aux_plain(*t)
    _same(got[0], want[0])
    _same(got[1], want[1])
