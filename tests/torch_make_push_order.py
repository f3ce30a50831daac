"""Map the order in which XLA's CPU backend sums each 2x2 push block of
`vpcc_tpu.ops.padding.push_pull_fill`, per plane shape and pyramid level,
and write it to `vpcc_tpu_torch/data/push_order_xla.json`, which kernel L
and its plain twin (`vpcc_tpu_torch/ops/padding.py`) follow.

Two orders occur: "S", ((a + b) + c) + d over the children (0,0), (0,1),
(1,0), (1,1), and "P", (a + b) + (c + d).  They differ only where a block's
sum leaves float32's exact integers (2^24).  A probe puts, in every block
of one level, a child of 2^25, two children of 2 and one empty child, and
reads the empty child's fill (the block's sum / 3): the twos meet before
the big value under P for some placements and not under S.  All twelve
placements are run; every block of a level must name the same order among
the fifteen ways to sum four values, or the script fails.

A 1x1 top level (square power-of-two planes) is marked "?": XLA computes it
as one reduction over the whole plane (its optimized HLO), not from the
level below, so no 2x2 order describes it.  Then the probed orders are
held on random planes (values below 2^24, sparse occupancy, level sums
well past 2^24): a float32 push-pull in numpy following them must give
XLA's fill at every pixel that does not read a "?" level, or the shape is
left out of the table (its order not established).

The shapes are every H and W that are multiples of 256 up to 2048: a plane
with 8-bit samples reaches 2^24 from level 9 and one with 10-bit samples
from level 8, so only such shapes have levels whose order shows.  The same
order holds in `jax.vmap(video.hevc._round_int_plane)` (the encoder's call
site, one or several planes) and under XLA_FLAGS=--xla_cpu_max_isa=AVX2 or
SSE4_2 (checked on an AVX-512 host for 64x64, 32x32, 512x512, 1280x256).

Run: JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python
tests/torch_make_push_order.py   (about 1 minute)
"""

from __future__ import annotations

import itertools
import json
import platform
import sys
from pathlib import Path

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vpcc_tpu.ops import padding  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "vpcc_tpu_torch" / "data" / "push_order_xla.json"
BIG, SMALL = float(1 << 25), 2.0
SIDES = range(256, 2049, 256)


def _candidates():
    """name -> float32 sum of four values, for every way to sum them."""
    f32 = np.float32

    def seq(p):
        return lambda v: f32(f32(f32(f32(v[p[0]]) + f32(v[p[1]])) + f32(v[p[2]])) + f32(v[p[3]]))

    def pair(a, b, c, d):
        return lambda v: f32(f32(f32(v[a]) + f32(v[b])) + f32(f32(v[c]) + f32(v[d])))

    out = {"seq" + "".join(map(str, p)): seq(p)
           for p in itertools.permutations(range(4)) if p[0] < p[1]}
    out.update({f"pair{a}{b}{c}{d}": pair(a, b, c, d)
                for a, b, c, d in ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))})
    return out


CANDS = _candidates()
NAMES = {"seq0123": "S", "pair0123": "P"}


def n_levels(h: int, w: int) -> int:
    n = 0
    while h > 1 and w > 1 and h % 2 == 0 and w % 2 == 0:
        h, w, n = h // 2, w // 2, n + 1
    return n


def level_order(fill, H: int, W: int, lvl: int) -> str:
    s = 1 << (lvl - 1)
    nbh, nbw = H >> lvl, W >> lvl
    alive = {n: np.ones((nbh, nbw), bool) for n in CANDS}
    for empty, big in ((e, b) for e in range(4) for b in range(4) if e != b):
        img = np.zeros((H, W), np.float32)
        occ = np.zeros((H, W), np.uint8)
        vals = [SMALL] * 4
        vals[empty], vals[big] = 0.0, BIG
        for k in range(4):
            if k != empty:
                ix = np.ix_((2 * np.arange(nbh) + (k >> 1)) * s, (2 * np.arange(nbw) + (k & 1)) * s)
                img[ix], occ[ix] = vals[k], 1
        out = np.asarray(fill(img, occ))
        got = out[np.ix_((2 * np.arange(nbh) + (empty >> 1)) * s,
                         (2 * np.arange(nbw) + (empty & 1)) * s)]
        for n, f in CANDS.items():
            alive[n] &= got == np.float32(f(vals) / np.float32(3.0))
    names = [n for n, a in alive.items() if a.all()]
    hit = [NAMES[n] for n in names if n in NAMES]
    if len(hit) != 1 or any(not (alive[n].all() or not alive[n].any()) for n in alive):
        raise SystemExit(f"{H}x{W} level {lvl}: no single order ({names})")
    return hit[0]


def _sum4(v: np.ndarray, order: str) -> np.ndarray:
    h, w = v.shape
    x = v.reshape(h // 2, 2, w // 2, 2)
    a, b, c, d = x[:, 0, :, 0], x[:, 0, :, 1], x[:, 1, :, 0], x[:, 1, :, 1]
    return ((a + b) + (c + d)) if order == "P" else (((a + b) + c) + d)


def holds(fill, H: int, W: int, orders: str, seed: int) -> bool:
    """The orders reproduce XLA's fill on a random plane, except at pixels
    reading a "?" level."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1 << 24, (H, W)).astype(np.float32)
    occ = (rng.random((H, W)) < 0.05).astype(np.float32)
    occ[: H // 2, : W // 2] = 0.0   # a quadrant that reads the deep levels
    vals, wts = [img * occ], [occ]
    for o in orders:
        vals.append(_sum4(vals[-1], o))
        wts.append(_sum4(wts[-1], o))
    fill_ = vals[-1] / np.maximum(wts[-1], np.float32(1))
    level = np.full(wts[-1].shape, len(orders))
    for lvl in range(len(vals) - 2, -1, -1):
        up = np.repeat(np.repeat(fill_, 2, 0), 2, 1)
        lup = np.repeat(np.repeat(level, 2, 0), 2, 1)
        have = wts[lvl] > 0
        fill_ = np.where(have, vals[lvl] / np.maximum(wts[lvl], np.float32(1)), up)
        level = np.where(have, lvl, lup)
    want = np.where(occ > 0, img, fill_).astype(np.float32)
    got = np.asarray(fill(img, occ.astype(np.uint8)))
    known = np.array([True] + [c != "?" for c in orders])[level]
    return bool(np.array_equal(got[known], want[known]))


def main() -> None:
    fill = jax.jit(padding.push_pull_fill)
    table = {}
    for H in SIDES:
        for W in SIDES:
            L = n_levels(H, W)
            orders = "".join(level_order(fill, H, W, l) for l in range(1, L + 1))
            if (H >> L, W >> L) == (1, 1):
                orders = orders[:-1] + "?"
            ok = all(holds(fill, H, W, orders, seed) for seed in (1, 2))
            print(H, W, orders, "held" if ok else "NOT HELD: left out", flush=True)
            if ok:
                table[f"{H}x{W}"] = orders
    OUT.write_text(json.dumps({
        "about": "per plane shape 'HxW', the order of each push level l = 1.. of "
                 "vpcc_tpu.ops.padding.push_pull_fill under XLA's CPU backend: "
                 "S = ((a+b)+c)+d, P = (a+b)+(c+d) over children (0,0),(0,1),(1,0),(1,1), "
                 "? = not established (a whole-plane reduction); "
                 "made by tests/torch_make_push_order.py",
        "jax": jax.__version__, "machine": platform.machine(),
        "orders": table,
    }, indent=0, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
