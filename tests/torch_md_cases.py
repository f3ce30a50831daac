"""Crafted inputs of kernels M (color transfer), D (grid geometry
smoothing) and N (color pre-smoothing vote), shared by the CPU tests
against the JAX package and the card's tests against the plain versions.
numpy only, made from seeds."""

import numpy as np

RECOLOR_CASES = ("mixed", "no_exact", "all_exact", "all_matched", "duplicates", "out_of_grid")
SMOOTH_CASES = ("corners", "one_cell", "one_patch", "no_boundary", "border", "gs4", "gs16")
PRESMOOTH_CASES = ("mixed", "all_invalid", "one_valid", "entropy_tie", "entropy_ulp",
                   "end_rows")
MAX_DIST2 = 0x7FFFFFF0


def presmooth_case(name: str, n: int = 4000, m: int = 700, seed: int = 0):
    """(colors (N, 3) int32, nidx (M, 64) int32, nd2 (M, 64) int32, bidx
    (M,) int64, radius2, thr_dist, thr_entropy) for kernel N: N points in
    patches of 100 of one color, 15 % recolored at random; M queries (rows
    bidx, the first and the last row among them), each with 64 neighbours
    drawn mostly from its own patch at squared distances 0..100 (radius2
    64) or MAX_DIST2 (a tenth):
    * mixed: as said;
    * all_invalid: every other query has no neighbour within radius2;
    * one_valid: every other query has one (n = 1);
    * entropy_tie: every query has two, of different lumas at odd queries
      (entropy exactly 1) and of one luma at even ones; thr_entropy 1.0;
    * entropy_ulp: as entropy_tie, thr_entropy the next float32 above 1.0;
    * end_rows: the queries are the first and the last row, each other's
      neighbours."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (n // 100 + 1, 3))
    colors = palette[np.arange(n) // 100]
    noisy = rng.random(n) < 0.15
    colors[noisy] = rng.integers(0, 256, (int(noisy.sum()), 3))
    colors = colors.astype(np.int32)
    if name == "end_rows":
        m = 2
    bidx = np.sort(rng.choice(n, m, replace=False))
    bidx[0], bidx[-1] = 0, n - 1
    own = (bidx // 100)[:, None] * 100 + rng.integers(0, 100, (m, 64))
    nidx = np.where(rng.random((m, 64)) < 0.8, np.minimum(own, n - 1),
                    rng.integers(0, n, (m, 64))).astype(np.int32)
    nd2 = rng.integers(0, 101, (m, 64)).astype(np.int32)
    nd2[rng.random((m, 64)) < 0.1] = MAX_DIST2
    thr_entropy = 2.0
    if name == "all_invalid":
        nd2[::2] = np.where(rng.random((len(nd2[::2]), 64)) < 0.5, MAX_DIST2, 65)
    elif name == "one_valid":
        nd2[::2] = MAX_DIST2
        nd2[::2, rng.integers(0, 64)] = 3
    elif name in ("entropy_tie", "entropy_ulp"):
        luma = (0.2126 * colors[:, 0] + 0.7152 * colors[:, 1] + 0.0722 * colors[:, 2])
        nd2[:] = MAX_DIST2
        for q in range(m):
            a = int(nidx[q, 0])
            if q % 2:
                far = np.flatnonzero(np.abs(luma - luma[a]) > 8)
                b = int(far[rng.integers(0, len(far))])
            else:
                b = int(np.flatnonzero(np.all(colors == colors[a], axis=1))[0])
            slots = rng.choice(64, 2, replace=False)
            nidx[q, slots] = (a, b)
            nd2[q, slots] = (1, 4)
        thr_entropy = 1.0 if name == "entropy_tie" else float(
            np.nextafter(np.float32(1.0), np.float32(2.0)))
    elif name == "end_rows":
        nidx[:] = rng.choice([0, n - 1], (m, 64)).astype(np.int32)
    return colors, nidx, nd2, bidx.astype(np.int64), 64.0, 10.0, thr_entropy


def recolor_case(name: str, bits: int = 7, n: int = 30000, seed: int = 0):
    """(source positions (Ns, 3) int32, source colors (Ns, 3) uint8, target
    positions (Nt, 3) int32) on a grid of `bits`:
    * mixed: unique sources; the targets are 70 % of them, a third jittered
      by up to 2 voxels (exact and inexact targets, unmatched sources);
    * no_exact: sources at even x, targets at odd x (no exact hit);
    * all_exact: the targets are 70 % of the sources (no inexact target);
    * all_matched: the targets are every source, shuffled, some twice (no
      inexact target, no unmatched source);
    * duplicates: a third of the sources repeat the position of another
      (the first of equal keys is the match), targets as in mixed;
    * out_of_grid: mixed, with a tenth of the targets moved outside the
      grid on one axis (key -1)."""
    rng = np.random.default_rng(seed)
    g = 1 << bits
    keys = rng.choice(g ** 3, n, replace=False)
    sp = np.stack([keys >> (2 * bits), (keys >> bits) & (g - 1), keys & (g - 1)], 1)
    if name == "no_exact":
        sp[:, 0] &= ~1
        sp = np.unique(sp, axis=0)
    if name == "duplicates":
        dup = rng.choice(len(sp), len(sp) // 3, replace=False)
        sp[dup] = sp[rng.integers(0, len(sp), len(dup))]
    sc = rng.integers(0, 256, sp.shape).astype(np.uint8)
    if name == "no_exact":
        tp = sp[rng.permutation(len(sp))[:len(sp) * 7 // 10]].copy()
        tp[:, 0] |= 1
        tp[::4, 1:] = np.clip(tp[::4, 1:] + rng.integers(-2, 3, tp[::4, 1:].shape), 0, g - 1)
    elif name == "all_exact":
        tp = sp[rng.permutation(len(sp))[:len(sp) * 7 // 10]].copy()
    elif name == "all_matched":
        tp = np.concatenate([sp, sp[rng.integers(0, len(sp), len(sp) // 5)]])
        tp = tp[rng.permutation(len(tp))]
    else:
        tp = sp[rng.permutation(len(sp))[:len(sp) * 7 // 10]].copy()
        tp[::3] = np.clip(tp[::3] + rng.integers(-2, 3, tp[::3].shape), 0, g - 1)
        if name == "out_of_grid":
            out = rng.choice(len(tp), len(tp) // 10, replace=False)
            axis = rng.integers(0, 3, len(out))
            tp[out, axis] = np.where(rng.random(len(out)) < 0.5, -1 - rng.integers(0, 3, len(out)),
                                     g + rng.integers(0, 3, len(out)))
    return sp.astype(np.int32), sc, tp.astype(np.int32)


def _sphere(rng, bits: int, n: int, radius: float):
    g = 1 << bits
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.unique(np.round(g / 2 + radius * v).astype(np.int32), axis=0)
    return np.clip(pts + rng.integers(-2, 3, pts.shape), 0, g - 1).astype(np.int32)


def smooth_case(name: str, bits: int = 7, seed: int = 0):
    """(points (M, 3) int32, patch ids (M,) int32, boundary (M,) bool,
    threshold, grid_size) on a grid of `bits`:
    * corners: a jittered sphere with banded patch ids and two points at the
      grid's corners (0, 0, 0) and (2^bits - 1, ...), so that the points'
      cell box is the whole grid;
    * one_cell: 200 points of two patches inside one cell;
    * one_patch: the sphere with one patch id (nothing moves);
    * no_boundary: the sphere with no boundary point;
    * border: two patches on slabs at the grid's faces, at distances
      gridSize / 2 - 1 .. gridSize / 2 + 1 from them (the move's border
      test);
    * gs4, gs16: the sphere at gridSize 4 and 16."""
    rng = np.random.default_rng(seed)
    g = 1 << bits
    gs = 4 if name == "gs4" else 16 if name == "gs16" else 8
    pts = _sphere(rng, bits, 30 * g * g // 16, 0.4 * g)
    pid = ((pts[:, 0] // 5 + pts[:, 2] // 7) % 5).astype(np.int32)
    bnd = rng.random(len(pts)) < 0.9
    thr = 2.0
    if name == "corners":
        pts = np.concatenate([pts, [[0, 0, 0], [g - 1, g - 1, g - 1]]]).astype(np.int32)
        pid = np.concatenate([pid, [1, 2]]).astype(np.int32)
        bnd = np.concatenate([bnd, [True, True]])
    elif name == "one_cell":
        c0 = rng.integers(1, g // gs - 1, 3) * gs
        pts = (c0 + rng.integers(0, gs, (200, 3))).astype(np.int32)
        pid = (pts[:, 0] % 2).astype(np.int32)
        bnd = np.ones(len(pts), bool)
        thr = 0.5
    elif name == "one_patch":
        pid = np.full(len(pts), 3, np.int32)
    elif name == "no_boundary":
        bnd = np.zeros(len(pts), bool)
    elif name == "border":
        h = gs // 2
        d = np.array([h - 1, h, h + 1])
        uv = rng.integers(0, g, (3000, 2))
        depth = d[rng.integers(0, 3, 3000)]
        lo = np.stack([depth, uv[:, 0], uv[:, 1]], 1)
        hi = np.stack([g - 1 - depth, uv[:, 0], uv[:, 1]], 1)
        pts = np.unique(np.concatenate([lo, hi, np.roll(lo, 1, 1), np.roll(hi, 1, 1)]), axis=0)
        pts = pts.astype(np.int32)
        pid = ((pts.sum(1) // 3) % 2).astype(np.int32)
        bnd = np.ones(len(pts), bool)
        thr = 0.5
    return pts, pid, bnd, thr, gs
