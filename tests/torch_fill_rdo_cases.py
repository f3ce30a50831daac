"""Crafted cases of kernel W's harmonic entry (the harmonic fill and the
smoothed push-pull) and kernel V's RDO, for the card's tests against the
plain versions and `chip_smoke.py`.  Imports neither JAX nor vpcc_tpu.

The harmonic entry splits a plane's pyramid into a push launch, a launch
that runs the levels of at most 80 x 80 pixels whole, a plane a block, and
one launch a larger level in 64 x 64 tiles with a halo of 8 pixels (one for
each 8 steps of a level that runs more), csrc/bg_fill.cu;
`harmonic_launches` counts them.  The cases reach every part of that plan:
sides that are not tile multiples at two tile levels, one occupied pixel in
a corner (every halo wraps to the opposite side), all empty and all full,
integer values spanning 2^0..2^30 (whose float sums change with any change
of order), stacks of 1, 3 and 6 planes, 48 x 80 (the pyramid stops at
3 x 5), a plane smaller than a halo, an odd side (level 0 alone), a
1024 x 1024 plane whose levels go down to 2 x 2 (the coarse launch pushes
levels 6..9), and two atlases whose coarsest level is larger than 80 x 80
pixels (1280 x 1296: 80 x 81; 2560 x 1040: 160 x 65), so that it is the
first tile level.

The RDO's cases: a patch whose blocks span many 4,096-block steps of the
scan, a patch index with no block, blocks of patch 0, a patch of exactly
`block_threshold` blocks, one mode and all 16 (interpolate, fill, minD1,
neighbour) rows, blocks and a small patch whose sums reach 2^24, and a
5632 x 1280 plane at a resolution of 8 (112,640 blocks) with a threshold of
1,500 blocks, so that patches with the level flag hold more blocks than
the kernel keeps from its scan (1,024).
"""

import numpy as np

HARMONIC_CASES = ("ragged", "corner", "empty", "full", "crafted", "c1_1280", "odd48x80",
                  "tiny6x10", "odd_side", "pow2_1024", "wide_top", "tall_top")


def harmonic_launches(H: int, W: int, steps: int = 8, steps0: int = 8,
                      min_side: int = 2) -> int:
    """Kernel W's harmonic launches on H x W planes, as csrc/bg_fill.cu plans
    them: the push (where there is a level above 0), the coarse launch
    (where it pushes levels above the push's five or relaxes levels of at
    most 80 x 80 pixels), and one for each 8 steps, at least one, of every
    larger level."""
    sides = [(H, W)]
    while all(s > min_side and s % 2 == 0 for s in sides[-1]):
        sides.append((sides[-1][0] // 2, sides[-1][1] // 2))
    top = len(sides) - 1
    c = top + 1
    while c > 1 and sides[c - 1][0] * sides[c - 1][1] <= 80 * 80:
        c -= 1
    passes = lambda n: max(1, -(-n // 8))
    return ((top >= 1) + (top > min(top, 5) or c <= top)
            + passes(steps0) + (c - 1) * passes(steps))


def harmonic_case(case: str):
    """((C, H, W) int32 planes, (H, W) uint8 occupancy) of a crafted case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    shapes = {"ragged": (3, 720, 400), "corner": (1, 256, 192), "empty": (6, 128, 128),
              "full": (6, 128, 128), "crafted": (3, 320, 480), "c1_1280": (1, 1280, 1280),
              "odd48x80": (3, 48, 80), "tiny6x10": (2, 6, 10), "odd_side": (3, 47, 64),
              "pow2_1024": (3, 1024, 1024), "wide_top": (3, 1280, 1296),
              "tall_top": (1, 2560, 1040)}
    C, H, W = shapes[case]
    occ = np.zeros((H, W), np.uint8)
    if case in ("ragged", "crafted", "c1_1280", "tiny6x10", "odd_side", "wide_top", "tall_top"):
        occ = (rng.random((H, W)) < 0.3).astype(np.uint8)
    elif case == "pow2_1024":
        occ = (rng.random((H, W)) < 0.02).astype(np.uint8)
    elif case == "corner":
        occ[0, 0] = 1
    elif case == "full":
        occ[:] = 1
    elif case == "odd48x80":
        occ[5:20, 10:30] = 1
        occ[30:44, 60:78] = rng.random((14, 18)) < 0.7
    if case == "crafted":
        mag = 2.0 ** rng.integers(0, 31, (C, H, W))
        planes = np.minimum(mag * rng.random((C, H, W)), 2.0 ** 31 - 1).astype(np.int32)
    else:
        planes = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    return planes, occ


# every (interpolate, filling, minD1, neighbour) row: the most modes a table
# may hold
ALL_MODES = np.array([[i, f, m, n] for i in (0, 1) for f in (0, 1) for m in (0, 1)
                      for n in (1, 2)], np.int32)
RDO_CASES = ("chunks", "one_mode", "modes16", "big", "many_blocks")


def rdo_case(case: str):
    """(g0d, g0t, g1t, occ, btp, mode table, res, block_threshold, p_max)
    of a crafted RDO case, numpy arrays."""
    rng = np.random.default_rng(sum(map(ord, case)))
    h, w, res = (1280, 5632, 8) if case == "many_blocks" else (512, 768, 16)
    nbh, nbw = h // res, w // res
    yy, xx = np.mgrid[0:h, 0:w]
    g0t = (30 + (xx // 7) % 4 + (yy // 9) % 3).astype(np.int32)
    # a spread of D1 above D0 and a slope of D0 per block: the blocks'
    # modes differ
    spread = np.repeat(np.repeat(rng.integers(0, 6, (nbh, nbw)), res, 0), res, 1)
    slope = np.repeat(np.repeat(rng.integers(0, 3, (nbh, nbw)), res, 0), res, 1)
    g0t = (g0t + slope * ((xx % res) // 4)).astype(np.int32)
    g1t = (g0t + (rng.random((h, w)) * (spread + 1)).astype(np.int32)).astype(np.int32)
    g0d = (g0t + rng.integers(-1, 2, (h, w))).astype(np.int32)
    occ = (rng.random((h, w)) < 0.85).astype(np.uint8)
    threshold = 1500 if case == "many_blocks" else 9
    # patch 1 every third block (many_blocks: every 37th, 3,044 blocks: its
    # blocks in every step of the scan), patches 2..6 small, patch 5 exactly
    # `threshold` blocks, patch 7 never used, the rest of the blocks in no
    # patch
    btp = np.zeros(nbh * nbw, np.int32)
    btp[::37 if case == "many_blocks" else 3] = 1
    free = np.flatnonzero(btp == 0)
    pick = rng.permutation(free)
    at = 0
    for q, n in ((2, 3), (3, 12), (4, 1), (5, threshold), (6, 40)):
        btp[np.sort(pick[at:at + n])] = q
        at += n
    btp = btp.reshape(nbh, nbw)
    six = ALL_MODES[[0, 8, 9, 12, 13, 15]]
    tbl = {"one_mode": ALL_MODES[:1], "modes16": ALL_MODES}.get(case, six)
    if case == "big":
        # blocks of patch 4 (one block, so patch-level) and of patch 1
        # whose true depths sit 1,500 above the decoded D0: their sums
        # reach 2^24
        for q in (4, 1):
            by, bx = np.argwhere(btp == q)[0]
            sl = np.s_[by * res:(by + 1) * res, bx * res:(bx + 1) * res]
            g0t[sl] += 1500
            g1t[sl] += 1500
    return g0d, g0t, g1t, occ, btp, tbl, res, threshold, 8
