"""The frontier schedule of kernels W (dilation) and X (spanning-tree flood)
as plain PyTorch, and their crafted cases, for the CPU tests against the
JAX package and the card's tests against the plain versions.  Imports
neither JAX nor vpcc_tpu.

The kernels walk a frontier level by level in one persistent launch
instead of sweeping the whole array each level (csrc/bg_fill.cu
`dilate_levels`, csrc/orient.cu `flood_levels`).  The mirrors here follow
their schedule step for step: the level stamps, the claims, the ping-pong
lists, the in-place writes.  A level's list is processed in chunks of a
random order, each chunk seeing the claims and stamps of the chunks before
it, as the card's threads see each other's writes within a level; the
result must not depend on that order.
"""

import numpy as np
import torch

from vpcc_tpu_torch.ops import normals as tno

UNSET = np.iinfo(np.int32).max


def _chunks(items: torch.Tensor, rng, n: int = 3):
    """`items` in a random order, cut into up to n chunks."""
    order = items[torch.as_tensor(rng.permutation(items.numel()), dtype=torch.long)]
    return [c for c in torch.tensor_split(order, n) if c.numel()]


def _neighbours(p: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, 4) up, down, left, right of flat pixels p on the torus, as
    `dilate_pass` forms them (a side of 1 or 2 repeats a pixel)."""
    y, x = p // W, p % W
    up = torch.where(y == 0, H - 1, y - 1) * W + x
    dn = torch.where(y == H - 1, 0, y + 1) * W + x
    lf = y * W + torch.where(x == 0, W - 1, x - 1)
    rt = y * W + torch.where(x == W - 1, 0, x + 1)
    return torch.stack([up, dn, lf, rt], 1)


def dilate_frontier(image: torch.Tensor, occupancy: torch.Tensor, max_iters: int = 1024,
                    seed: int = 0):
    """Kernel W's dilation schedule on (C, H, W) planes under one (H, W)
    occupancy: (float32 planes, passes that filled a pixel).

    Init: pass_of = 0 where occupied; an empty pixel with an occupied
    4-neighbour is claimed for level 1 (pass_of = 1) and listed.  Level k:
    each listed pixel averages its neighbours with pass_of < k (occupied ones
    read the image, filled ones their value) over all planes; then claims
    each neighbour still unclaimed for level k + 1 (while k + 1 <= max_iters)
    and lists it.  The walk stops at an empty list.  Finish: occupied pixels
    the image, filled ones their value, unreached ones image * 0."""
    rng = np.random.default_rng(seed)
    img = image.to(torch.float32).reshape(-1, *image.shape[-2:])
    C, H, W = img.shape
    occ = occupancy.to(torch.bool).flatten()
    flat = img.reshape(C, -1)
    pass_of = torch.where(occ, 0, UNSET).to(torch.int64)
    x = torch.zeros_like(flat)
    empty = torch.nonzero(~occ).flatten()
    near = occ[_neighbours(empty, H, W)].any(1)
    frontier = empty[near] if max_iters >= 1 else empty[:0]
    pass_of[frontier] = 1
    k, passes = 1, 0
    while frontier.numel():
        nxt = []
        for p in _chunks(frontier, rng):
            nb = _neighbours(p, H, W)
            pf = pass_of[nb]                                   # (n, 4), read now
            f = (pf < k).to(torch.float32)
            wsum = f[:, 0]
            for j in range(1, 4):
                wsum = wsum + f[:, j]
            den = torch.clamp(wsum, min=1.0)
            # an unfilled neighbour adds 0.0, as the kernel's select does
            val = torch.where(pf[None] < k, torch.where(pf[None] == 0, flat[:, nb], x[:, nb]),
                              0.0)
            v = val[..., 0]
            for j in range(1, 4):
                v = v + val[..., j]
            x[:, p] = torch.round(v / den)
            if k + 1 <= max_iters:
                for j in range(4):   # claims in order, seeing each other's
                    q = nb[:, j]
                    free = pass_of[q] == UNSET
                    q = torch.unique(q[free])
                    pass_of[q] = k + 1
                    nxt.append(q)
        passes = k
        frontier = torch.cat(nxt) if nxt else frontier[:0]
        k += 1
    out = torch.where(occ, flat, torch.where(pass_of != UNSET, x, flat * 0.0))
    return out.reshape(image.shape), passes


def reverse_adjacency(nn_idx: torch.Tensor, nn_valid: torch.Tensor, valid: torch.Tensor):
    """The CSR of "rows whose list holds j" over the valid edges of valid
    rows, by a counting sort: (offsets (V + 1,), rows)."""
    V, K = nn_idx.shape
    edge = nn_valid & valid[:, None]
    dst = nn_idx[edge].long()
    src = torch.arange(V).repeat_interleave(K).reshape(V, K)[edge]
    deg = torch.bincount(dst, minlength=V)
    off = torch.zeros(V + 1, dtype=torch.long)
    off[1:] = torch.cumsum(deg, 0)
    cursor = off[:-1].clone()
    rows = torch.empty(dst.numel(), dtype=torch.long)
    for e in range(dst.numel()):   # the scatter; any order within a list will do
        rows[cursor[dst[e]]] = src[e]
        cursor[dst[e]] += 1
    return off, rows


def flood_frontier(positions, normals, nn_idx, nn_valid, valid, pad_rows: bool = False,
                   seed: int = 0):
    """Kernel X's flood schedule: (oriented normals, sweeps that signed a row).

    st[i] = (sweep << 1) | negative for a signed row, UNSET else; the seed
    is signed at sweep 0 and its reverse list queued for sweep 1 (queued[i]
    = the sweep it is listed for).  Sweep t: each listed row still unset
    votes over its K terms in order, a neighbour's sign read as 0 where
    st >= 2t; |vote| > 1e-6 signs it (st = 2t | (vote < 0)) and queues the
    unset rows of its reverse list for t + 1 (while t + 1 <= 256).  The walk
    stops after a sweep that signs nothing or at the cap; unsigned rows take
    the radial sign."""
    rng = np.random.default_rng(seed)
    V = positions.shape[0]
    if V == 0:
        return normals.clone(), 0
    off, rev = reverse_adjacency(nn_idx, nn_valid, valid)
    st = torch.full((V,), UNSET, dtype=torch.int64)
    queued = torch.zeros(V, dtype=torch.int64)
    s, s_sign = tno.flood_seed(positions, normals, valid, pad_rows)
    cand = torch.empty(0, dtype=torch.long)
    if s >= 0:
        st[s] = int(s_sign < 0)
        q = rev[off[s]:off[s + 1]]
        cand = torch.unique(q[st[q] == UNSET])
        queued[cand] = 1
    idx = nn_idx.long()
    sweeps = 0
    for t in range(1, tno.FLOOD_MAX_SWEEPS + 1):
        if not cand.numel():
            break
        signed_any, nxt = False, []
        for r in _chunks(cand, rng):
            r = r[st[r] == UNSET]
            sj = st[idx[r]]
            sgn = torch.where(sj < 2 * t, torch.where(sj & 1 == 1, -1.0, 1.0), 0.0)
            dots = tno.dot3(normals[idx[r]], normals[r][:, None, :])
            vote = torch.zeros(r.numel(), dtype=torch.float32)
            for k in range(idx.shape[1]):
                vote = torch.where(nn_valid[r, k], vote + dots[:, k] * sgn[:, k], vote)
            newly = vote.abs() > tno.FLOOD_VOTE_MIN
            st[r[newly]] = 2 * t + (vote[newly] < 0).long()
            signed_any |= bool(newly.any())
            if t + 1 <= tno.FLOOD_MAX_SWEEPS:
                for i in r[newly].tolist():
                    q = rev[off[i]:off[i + 1]]
                    q = torch.unique(q[(st[q] == UNSET) & (queued[q] != t + 1)])
                    queued[q] = t + 1
                    nxt.append(q)
        if not signed_any:
            break
        sweeps = t
        cand = torch.cat(nxt) if nxt else cand[:0]
    sign = torch.where(st == UNSET, tno.radial_signs(positions, normals, valid),
                       torch.where(st & 1 == 1, -1.0, 1.0))
    return normals * sign[:, None], sweeps


# ---------------------------------------------------------------------------
# crafted cases (numpy, made from seeds)

DILATE_CASES = ("torus", "side1", "side2", "edge_cap", "empty", "full", "random")


def dilate_case(name: str, seed: int = 0):
    """(planes (C, H, W) int32, occupancy (H, W) uint8, max_iters):
    * torus: one occupied pixel in a corner, whose fill wraps around both
      axes (the farthest pixel 40 steps away on a 48 x 32 torus);
    * side1: a 1 x 37 plane (up and down are the pixel itself);
    * side2: a 2 x 29 plane (up and down are one pixel, counted twice);
    * edge_cap: one pixel on the top row of 64 x 64, capped at 7 passes
      (pixels farther stay 0);
    * empty / full: nothing occupied (nothing fills) / everything (0 passes);
    * random: a 96 x 80 plane, 10 % occupied in blobs and scattered pixels."""
    rng = np.random.default_rng(seed)
    shape = {"torus": (48, 32), "side1": (1, 37), "side2": (2, 29), "edge_cap": (64, 64),
             "empty": (16, 24), "full": (16, 16), "random": (96, 80)}[name]
    occ = np.zeros(shape, np.uint8)
    if name == "torus":
        occ[0, 0] = 1
    elif name == "side1":
        occ[0, [3, 20]] = 1
    elif name == "side2":
        occ[1, 4] = occ[0, 17] = 1
    elif name == "edge_cap":
        occ[0, 5] = 1
    elif name == "full":
        occ[:] = 1
    elif name == "random":
        occ[:] = rng.random(shape) < 0.03
        occ[10:30, 5:25] = 1
        occ[60:70, 50:78] = rng.random((10, 28)) < 0.8
    planes = rng.integers(0, 256, (3, *shape)).astype(np.int32)
    return planes, occ, 7 if name == "edge_cap" else 1024


FLOOD_CASES = ("cancel_then_signed", "disconnected", "pad_rows", "empty", "random")


def flood_case(name: str, seed: int = 0):
    """(positions (V, 3) int32, normals (V, 3) float32, nn_idx (V, K) int32,
    nn_valid (V, K) bool, valid (V,) bool, pad_rows):
    * cancel_then_signed: the seed (row 0, the highest) signs rows 1 and 2 in
      sweep 1; row 3 lists them and row 4, and its two terms cancel exactly
      (+1 and -1), so sweep 2 leaves it unset; row 4 (listing row 1) is
      signed in sweep 2, and row 3 is signed in sweep 3 by row 4's term;
      rows 5-7 hang off row 3; a self-neighbour and duplicate neighbours;
    * disconnected: two components, the second never reached (radial), one
      invalid row (with no valid neighbour, as the encoder's padded rows)
      listed by the first;
    * pad_rows: a shell whose keys all wrap negative (z >= 512) with padded
      rows after it: no seed, every row radial;
    * empty: V = 0;
    * random: 400 rows, K = 8, random normals and lists, a fifth of the
      edges masked, a few invalid rows."""
    rng = np.random.default_rng(seed)
    K = 4 if name != "random" else 8
    if name == "empty":
        return (np.zeros((0, 3), np.int32), np.zeros((0, 3), np.float32),
                np.zeros((0, K), np.int32), np.zeros((0, K), bool), np.zeros(0, bool), False)
    if name == "random":
        V = 400
        pos = rng.integers(0, 400, (V, 3)).astype(np.int32)
        nrm = rng.normal(size=(V, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True).astype(np.float32)
        idx = rng.integers(0, V, (V, K)).astype(np.int32)
        valid = rng.random(V) < 0.97
        val = (rng.random((V, K)) < 0.8) & valid[:, None]   # an invalid row lists nothing
        return pos, nrm.astype(np.float32), idx, val, valid, False
    if name == "pad_rows":
        V = 60
        pos = np.column_stack([rng.integers(0, 50, V), rng.integers(0, 50, V),
                               rng.integers(600, 700, V)]).astype(np.int32)
        nrm = rng.normal(size=(V, 3)).astype(np.float32)
        idx = rng.integers(0, V, (V, K)).astype(np.int32)
        return pos, nrm, idx, np.ones((V, K), bool), np.ones(V, bool), True
    s2 = np.float32(np.sqrt(0.5))
    rows = [  # (position, normal, list)
        ((0, 0, 500), (0, 0, 1), [0, 1, 2, 0]),          # 0: the seed (self listed)
        ((1, 0, 400), (s2, 0, s2), [0, 0, 3, 4]),        # 1: the seed twice
        ((2, 0, 400), (-s2, 0, s2), [0, 3, 3, 3]),       # 2
        ((3, 0, 300), (1, 0, 0), [1, 2, 4, 3]),          # 3: +1 - 1 cancel, then row 4
        ((4, 0, 300), (s2, 0, s2), [1, 5, 6, 7]),        # 4: signed in sweep 2
        ((5, 0, 200), (0, 1, 0), [3, 4, 6, 7]),
        ((6, 0, 200), (0, -1, 0), [3, 5, 7, 7]),
        ((7, 0, 200), (0, 0, -1), [3, 6, 5, 4]),
    ]
    if name == "disconnected":
        rows += [((100, 100, 10), (1, 0, 0), [9, 10, 11, 8]),
                 ((101, 100, 10), (-1, 0, 0), [8, 10, 11, 9]),
                 ((102, 100, 10), (0, 1, 0), [8, 9, 11, 12]),
                 ((103, 100, 10), (0, 0, 1), [8, 9, 10, 12]),
                 ((5, 5, 300), (0, 0, 1), [0, 1, 3, 12])]   # 12: invalid
    V = len(rows)
    pos = np.array([r[0] for r in rows], np.int32)
    nrm = np.array([r[1] for r in rows], np.float32)
    idx = np.array([r[2] for r in rows], np.int32)
    val = np.ones((V, K), bool)
    val[2, 3] = False
    valid = np.ones(V, bool)
    if name == "disconnected":
        valid[12] = False
        val[12] = False   # an invalid row lists nothing, as the encoder's padded rows
        idx[3, 3] = 12    # row 3 lists the invalid row (never signed: sign 0)
    return pos, nrm, idx, val, valid, False
