"""Color transfer from the source cloud to the reconstructed geometry (K7;
kernel M).

Behavioral reference: `PCCPointSet3::transferColors` (source/lib/
PccLibCommon/include/PCCPointSet.h:295-320) as the JAX package computes it:
for grids of at most 10 bits vpcc_tpu/ops/recolor.py
`transfer_colors_compact` and its helpers `exact_matches_device`,
`_exact_and_counts`, `_compact_gather`, `_fwd_blend` and
`_bwd_and_merge_compact` (recolor.py:43-264); above 10 bits (vox11) the
host `exact_matches` (:22) and `transfer_colors` (:70) with its one device
program `_blend` (:291), which sweeps every target and every source
(`transfer_colors` below).  In order:

1. exact match: each target looks its packed position key up in the
   stably sorted source keys (left insertion point, as `jnp.searchsorted`);
   a hit keeps that source's color verbatim, and marks the source matched;
2. compaction: the inexact targets and the unmatched sources in index
   order, with their positions (the queries of step 3's and 4's sweeps);
3. forward blend: each inexact target averages its k=8 nearest sources
   (kernel E), weighted 1 / (d2 + offset), gated by distance and by color
   distance to the nearest one (which always votes);
4. backward splat: each unmatched source adds its color to its nearest
   target (kernel E, k=1), gated by distance;
5. merge: exact, else forward, else 0.5 * (forward + backward) where a
   splat landed; rounded half to even and clamped to 0..255.

Float order.  `_fwd_blend`'s weights are correctly rounded divisions; XLA's
CPU program sums them in slot order from 0, and sums color * weight as a
chain of fused multiply-adds in slot order from 0 (`device.fma_f32`,
`__fmaf_rn`); the color numerator is then divided by max(weight sum,
1e-8).  The backward sums add integers of at most 255, exact in float32 in
any order, so the kernel adds them as integers with atomics.

`_blend` computes the forward half and the merge in the same float order
(its optimized HLO, recolor.cu's header), so `transfer_colors` runs the
same blend entry uncompacted.  The port holds only valid rows (no padding),
so the reference's validity masks of padded rows have no counterpart.

`transfer_reflectance` (recolor.py:267) gives each target its exact twin's
16-bit reflectance, else its nearest source's: kernel M's exact match and
kernel E's k=1 sweep (bucket 6), no kernel of its own.

Kernel M (csrc/recolor.cu) has two entry points, each one cooperative
launch: the exact match with the compaction (`exact_compact`; steps 1-2,
after which the wrapper reads the two counts, the transfer's one host
wait) and the blend (`blend_merge`; steps 3-5).  `exact_match_plain`,
`fwd_blend_plain` and `splat_merge_plain` are the specification; the
entries' plain versions, used for CPU tensors, are built from them
(`exact_compact_plain`, `blend_merge_plain`).

The level-batched GOF path (`parallel/gof.py` `recolor_level`, reference
`parallel/gof.py` `_exact_batch` / `_blend_batch`) runs the uncompacted
route over the B frames of a hierarchy level at once, on clouds padded to
common sizes: `sorted_source_keys_batch` gives the padded sources the key
0x7FFFFFFF (reference recolor.py:50-53), `exact_match_batch` (the exact
entry without compaction) matches every frame's targets, and `blend_batch`
(the blend entry, uncompacted) runs the forward blend, the splat and the
merge of every frame; their plain versions loop over the frames.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.ops import neighbors

MAX_DIST2 = neighbors.MAX_DIST2


def _packed_keys(pos: torch.Tensor, bits: int) -> torch.Tensor:
    return (pos[:, 0] << (2 * bits)) | (pos[:, 1] << bits) | pos[:, 2]


def sorted_source_keys(src_pos: torch.Tensor, bits: int):
    """(order, sorted keys) of the source positions' packed keys, int32;
    the sort is stable, as `jnp.argsort`."""
    ks = _packed_keys(src_pos, bits)
    srt = torch.sort(ks, stable=True)
    return srt.indices.to(torch.int32), srt.values.contiguous()


def exact_matches(src_pos, tgt_pos, n_src: int, bits: int):
    """Host exact position matching for any grid size (a copy of the
    reference's `exact_matches`, recolor.py:22-40: int64 keys, numpy's
    default argsort and a left searchsorted, so that a duplicated source
    position resolves to the reference's row).  Returns (exact_idx (Nt,)
    int32, has_exact (Nt,) bool) numpy arrays."""
    sp = np.asarray(src_pos[:n_src], np.int64)
    tp = np.asarray(tgt_pos, np.int64)
    key_s = (sp[:, 0] << (2 * bits)) | (sp[:, 1] << bits) | sp[:, 2]
    in_grid = np.all((tp >= 0) & (tp < (1 << bits)), axis=1)
    key_t = np.where(
        in_grid, (tp[:, 0] << (2 * bits)) | (tp[:, 1] << bits) | tp[:, 2], -1
    )
    order = np.argsort(key_s)
    sk = key_s[order]
    loc = np.clip(np.searchsorted(sk, key_t), 0, max(len(sk) - 1, 0))
    has = np.zeros(len(tp), bool) if len(sk) == 0 else (sk[loc] == key_t)
    idx = order[loc].astype(np.int32) if len(sk) else np.zeros(len(tp), np.int32)
    return idx, has


# ---------------------------------------------------------------------------
# plain versions

def exact_match_plain(order, sk, tgt_pos, bits: int):
    """(exact_idx (Nt,) int32, has_exact (Nt,) bool, matched_src (Ns,) bool,
    counts (2,) int32 = (inexact targets, unmatched sources))."""
    ns = sk.shape[0]
    in_grid = ((tgt_pos >= 0) & (tgt_pos < (1 << bits))).all(1)
    kt = torch.where(in_grid, _packed_keys(tgt_pos, bits), torch.full_like(tgt_pos[:, 0], -1))
    loc = torch.searchsorted(sk, kt).clamp(0, max(ns - 1, 0))
    has = (sk[loc] == kt) & (kt >= 0)
    eidx = order[loc]
    matched = torch.zeros(ns, dtype=torch.bool, device=sk.device)
    matched[eidx[has].long()] = True
    counts = torch.stack([(~has).sum(), (~matched).sum()]).to(torch.int32)
    return eidx, has, matched, counts


def fwd_blend_plain(src_col, idx, d2, gd2: float, cd2: float, doff: float):
    """(M, 3) float32 forward colors of M inexact targets from their k
    nearest sources (src_col (Ns, 3) uint8; idx, d2 (M, k) int32)."""
    cols = src_col[idx.long()].to(torch.float32)                    # (M, k, 3)
    d2f = d2.to(torch.float32)
    valid = (d2 < MAX_DIST2) & (d2f <= gd2)
    cdist = ((cols - cols[:, 0:1]) ** 2).sum(-1)                    # exact
    valid = valid & (cdist <= cd2)
    valid[:, 0] = d2[:, 0] < MAX_DIST2
    w = valid.to(torch.float32) / (d2f + doff).clamp(min=1e-8)
    wsum = torch.zeros_like(w[:, 0])
    num = torch.zeros_like(cols[:, 0])
    for j in range(w.shape[1]):
        wsum = wsum + w[:, j]
        num = dev.fma_f32(cols[:, j], w[:, j:j + 1].expand_as(num), num)
    return num / wsum.clamp(min=1e-8)[:, None]


def splat_merge_plain(src_col, uidx, tidx, td2, exact_idx, has_exact, iidx, fwd,
                      gd2_bwd: float):
    """(Nt, 3) int32 merged colors.  uidx (Mu,): unmatched source rows;
    tidx, td2 (Mu,): their nearest targets; iidx (Mi,): the inexact targets
    whose forward colors `fwd` (Mi, 3) float32 holds."""
    nt = exact_idx.shape[0]
    d = src_col.device
    ok = (td2 < MAX_DIST2) & (td2.to(torch.float32) <= gd2_bwd)
    acc = torch.zeros((nt, 3), dtype=torch.int64, device=d)
    cnt = torch.zeros(nt, dtype=torch.int64, device=d)
    t = tidx[ok].long()
    acc.index_add_(0, t, src_col[uidx[ok].long()].long())
    cnt.index_add_(0, t, torch.ones_like(t))
    fwd_full = torch.zeros((nt, 3), dtype=torch.float32, device=d)
    fwd_full[iidx.long()] = fwd
    out = torch.where(has_exact[:, None], src_col[exact_idx.long()].to(torch.float32), fwd_full)
    bwd = acc.to(torch.float32) / cnt.to(torch.float32).clamp(min=1.0)[:, None]
    blend = ((cnt > 0) & ~has_exact)[:, None]
    out = torch.where(blend, 0.5 * (out + bwd), out)
    return torch.round(out).clamp(0, 255).to(torch.int32)


def exact_compact_plain(order, sk, src_pos, tgt_pos, bits: int):
    """The exact match and the compaction: (exact_idx (Nt,) int32, has_exact
    (Nt,) bool, the inexact targets (Mi,) int32 and their positions (Mi, 3),
    the unmatched sources (Mu,) int32 and their positions (Mu, 3)), the lists
    in index order (`exact_match_plain`, `torch.nonzero`, the gathers)."""
    eidx, has, matched, _ = exact_match_plain(order, sk, tgt_pos, bits)
    iidx = torch.nonzero(~has).flatten().to(torch.int32)
    uidx = torch.nonzero(~matched).flatten().to(torch.int32)
    return eidx, has, iidx, tgt_pos[iidx.long()], uidx, src_pos[uidx.long()]


def blend_merge_plain(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2,
                      gd2_fwd: float, cd2: float, doff: float, gd2_bwd: float):
    """(Nt, 3) int32 merged colors: `fwd_blend_plain` of the k-NN rows idx,
    d2 of the inexact targets iidx (every one), then `splat_merge_plain` of
    the unmatched sources uidx with their nearest targets tidx, td2.  iidx
    None: a row a target (every target); uidx None: every source, those of
    exact targets dropped (td2 set to MAX_DIST2), as the reference's
    `_blend` drops `matched_src`."""
    ns, nt = src_col.shape[0], exact_idx.shape[0]
    d = src_col.device
    if iidx is None:
        iidx = torch.arange(nt, dtype=torch.int32, device=d)
    if uidx is None:
        matched = torch.zeros(ns, dtype=torch.bool, device=d)
        matched[exact_idx.long()[has_exact]] = True
        td2 = torch.where(matched, torch.full_like(td2, MAX_DIST2), td2)
        uidx = torch.arange(ns, dtype=torch.int32, device=d)
    fwd = fwd_blend_plain(src_col, idx, d2, gd2_fwd, cd2, doff)
    return splat_merge_plain(src_col, uidx, tidx, td2, exact_idx, has_exact, iidx, fwd, gd2_bwd)


# ---------------------------------------------------------------------------
# kernel M

_EXACT_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
               + [ctypes.c_int] + [ctypes.c_void_p] * 7)
_BLEND_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
               + [ctypes.c_float] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
# int32 of the exact entry's scratch: per-block counts, then 4096 sorted-key
# samples a frame
_PARTS = 4096
_SAMPLES = 4096


def _exact_launch(order, sk, tgt_pos, src_pos, B: int, ns: int, nt: int, bits: int,
                  compact: bool, counter: str):
    """Kernel M's exact entry on B frames (order, sk (B, Ns); tgt_pos
    (B, Nt, 3)), unchecked.  Returns (ints, flags): int32 eidx (B * Nt)
    and, with `compact` (B = 1), the lists iidx (Nt), tq (3 Nt), uidx (Ns),
    sq (3 Ns) (positions given src_pos) and the two counts, in this order;
    bool matched (B * Ns), then has (B * Nt)."""
    d = tgt_pos.device
    flags = torch.empty(B * (ns + nt), dtype=torch.bool, device=d)
    ints = torch.empty(5 * nt + 4 * ns + 2 if compact else B * nt, dtype=torch.int32, device=d)
    base, fb = ints.data_ptr(), flags.data_ptr()
    lists = [None] * 5
    if compact:
        lists = [base + 4 * nt, base + 8 * nt, base + 20 * nt, base + 20 * nt + 4 * ns,
                 base + 20 * nt + 16 * ns]
        if src_pos is None:
            lists[1] = lists[3] = None
    scratch = dev.scratch("recolor_exact", d, _PARTS + B * _SAMPLES)
    rc = dev.kernel_fn("recolor", "recolor_exact_compact", _EXACT_ARGS)(
        order.data_ptr(), sk.data_ptr(), tgt_pos.data_ptr(),
        None if src_pos is None else src_pos.data_ptr(), B, ns, nt, bits, base, fb + B * ns, fb,
        int(compact), *lists, scratch.data_ptr(), dev.stream_handle())
    dev.count_launch(counter, int(B > 0 and (nt > 0 or compact)))
    dev.check_launch(counter, rc)
    return ints, flags


def _exact_read(ints, flags, ns: int, nt: int):
    """The outputs of a compacting exact launch (`_exact_launch`), its lists
    cut to the counts read from the card (the one host wait)."""
    n_in, n_un = ints[5 * nt + 4 * ns:].tolist()
    return (ints[:nt], flags[ns:], ints[nt:nt + n_in], ints[2 * nt:2 * nt + 3 * n_in].view(-1, 3),
            ints[5 * nt:5 * nt + n_un], ints[5 * nt + ns:5 * nt + ns + 3 * n_un].view(-1, 3))


def _check_exact(order, sk, tgt_pos, bits: int, ndim: int, src_pos=None) -> None:
    d = tgt_pos.device
    dev.check_tensor(order, "order", torch.int32, d, ndim)
    dev.check_tensor(sk, "sorted keys", torch.int32, d, ndim)
    dev.check_tensor(tgt_pos, "tgt_pos", torch.int32, d, ndim + 1)
    if src_pos is not None:
        dev.check_tensor(src_pos, "src_pos", torch.int32, d, 2)
    if bits > 10:
        raise ValueError("recolor exact match: packed keys need bits <= 10")
    if (order.shape != sk.shape or tgt_pos.shape[-1] != 3 or tgt_pos.shape[:-2] != sk.shape[:-1]
            or (src_pos is not None and src_pos.shape != (sk.shape[-1], 3))):
        raise ValueError(f"recolor exact match: order {tuple(order.shape)}, keys "
                         f"{tuple(sk.shape)}, targets {tuple(tgt_pos.shape)}")


def exact_match(order, sk, tgt_pos, bits: int):
    """`exact_match_plain` on the card: kernel M's exact entry (one
    cooperative launch, no host wait)."""
    if tgt_pos.device.type == "cpu":
        return exact_match_plain(order, sk, tgt_pos, bits)
    _check_exact(order, sk, tgt_pos, bits, 1)
    ns, nt = sk.shape[0], tgt_pos.shape[0]
    ints, flags = _exact_launch(order, sk, tgt_pos, None, 1, ns, nt, bits, True, "recolor")
    return ints[:nt], flags[ns:], flags[:ns], ints[5 * nt + 4 * ns:]


def exact_compact(order, sk, src_pos, tgt_pos, bits: int):
    """`exact_compact_plain` on the card: kernel M's exact entry matches
    every target and lists the inexact targets and unmatched sources in
    index order beside their positions, in one cooperative launch; the
    wrapper reads the two counts (one host wait) and returns the lists cut
    to them."""
    if tgt_pos.device.type == "cpu":
        return exact_compact_plain(order, sk, src_pos, tgt_pos, bits)
    _check_exact(order, sk, tgt_pos, bits, 1, src_pos)
    ns, nt = sk.shape[0], tgt_pos.shape[0]
    return _exact_read(*_exact_launch(order, sk, tgt_pos, src_pos, 1, ns, nt, bits, True,
                                      "recolor"), ns, nt)


def _blend_launch(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2, B: int,
                  ns: int, nt: int, gd2_fwd: float, cd2: float, doff: float, gd2_bwd: float,
                  mark: bool, counter: str):
    """Kernel M's blend entry on B frames (src_col (B, Ns, 3); exact_idx,
    has_exact (B, Nt)), unchecked; iidx / uidx None: every target / source.
    Returns (B * Nt, 3) int32."""
    d = idx.device
    out = torch.empty((B * nt, 3), dtype=torch.int32, device=d)
    scratch = dev.scratch("recolor_blend", d, 4 * B * nt + (B * ns + 3) // 4)
    rc = dev.kernel_fn("recolor", "recolor_blend_merge", _BLEND_ARGS)(
        src_col.data_ptr(), exact_idx.data_ptr(), has_exact.data_ptr(),
        None if iidx is None else iidx.data_ptr(), -1 if iidx is None else iidx.shape[0],
        idx.data_ptr(), d2.data_ptr(), idx.shape[-1], None if uidx is None else uidx.data_ptr(),
        -1 if uidx is None else uidx.shape[0], tidx.data_ptr(), td2.data_ptr(), B, ns, nt,
        gd2_fwd, cd2, doff, gd2_bwd, int(mark), scratch.data_ptr(), out.data_ptr(),
        dev.stream_handle())
    dev.count_launch(counter, int(B * nt > 0))
    dev.check_launch(counter, rc)
    return out


def _blend_merge(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2,
                 gd2_fwd: float, cd2: float, doff: float, gd2_bwd: float):
    """`blend_merge` on the card, unchecked: one launch."""
    return _blend_launch(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2, 1,
                         src_col.shape[0], exact_idx.shape[0], float(gd2_fwd), float(cd2),
                         float(doff), float(gd2_bwd), uidx is None, "recolor")


def blend_merge(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2,
                gd2_fwd: float, cd2: float, doff: float, gd2_bwd: float):
    """`blend_merge_plain` on the card: kernel M's blend entry, the splat of
    the sources, then a thread a target: the exact color, or the forward
    blend of its k-NN row merged with the splat, in one cooperative
    launch."""
    if idx.device.type == "cpu":
        return blend_merge_plain(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2,
                                 gd2_fwd, cd2, doff, gd2_bwd)
    d = idx.device
    dev.check_tensor(src_col, "src_col", torch.uint8, d, 2)
    for name, t in (("exact_idx", exact_idx), ("tidx", tidx), ("td2", td2), ("iidx", iidx),
                    ("uidx", uidx)):
        if t is not None:
            dev.check_tensor(t, name, torch.int32, d, 1)
    dev.check_tensor(has_exact, "has_exact", torch.bool, d, 1)
    dev.check_tensor(idx, "idx", torch.int32, d, 2)
    dev.check_tensor(d2, "d2", torch.int32, d, 2)
    ns, nt, k = src_col.shape[0], exact_idx.shape[0], idx.shape[1]
    rows = nt if iidx is None else iidx.shape[0]
    srcs = ns if uidx is None else uidx.shape[0]
    if (k > 64 or k < 1 or idx.shape[0] != rows or d2.shape != idx.shape or src_col.shape[1] != 3
            or has_exact.shape != exact_idx.shape or tidx.shape != (srcs,)
            or td2.shape != (srcs,)):
        raise ValueError(f"recolor blend/merge: k-NN rows {tuple(idx.shape)} (of {rows}), "
                         f"d2 {tuple(d2.shape)}, colors {tuple(src_col.shape)}, sources "
                         f"{tuple(tidx.shape)}, {tuple(td2.shape)} (of {srcs}); k <= 64")
    return _blend_merge(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2, gd2_fwd,
                        cd2, doff, gd2_bwd)


# ---------------------------------------------------------------------------

def transfer_colors_compact(
    src_pos: torch.Tensor,     # (Ns, 3) int32
    src_col: torch.Tensor,     # (Ns, 3) uint8
    tgt_pos: torch.Tensor,     # (Nt, 3) int32
    grid_bits: int = 10,
    k: int = 8,
    k_bwd: int = 1,
    max_geom_d2_fwd: float = 1000.0,
    max_geom_d2_bwd: float = 1000.0,
    max_color_d2_fwd: float = 1000.0,
    dist_offset_fwd: float = 4.0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(Nt, 3) int32 colors of the targets, and (exact_idx, has_exact), as
    the reference's `transfer_colors_compact`: the k-NN sweeps run only on
    the inexact targets and (k_bwd > 0) the unmatched sources.  On the card
    kernel M's two launches around kernel E's sweeps, one host wait (the
    two counts)."""
    if grid_bits > 10:
        raise ValueError("transfer_colors_compact: packed int32 keys need grid_bits <= 10 "
                         "(above, use exact_matches + transfer_colors)")
    d = tgt_pos.device
    src_col = src_col.to(torch.uint8).contiguous()
    order, sk = sorted_source_keys(src_pos, grid_bits)
    grids = lambda: (neighbors.build_grid(src_pos, grid_bits),
                     neighbors.build_grid(tgt_pos, grid_bits) if k_bwd > 0 else None)
    if d.type == "cpu":
        lists = exact_compact_plain(order, sk, src_pos, tgt_pos, grid_bits)
        grid_s, grid_t = grids()
        blend = blend_merge_plain
    else:
        # the inputs checked once; the entries' unchecked launches
        dev.check_tensor(src_pos, "src_pos", torch.int32, d, 2)
        dev.check_tensor(tgt_pos, "tgt_pos", torch.int32, d, 2)
        if src_pos.shape[1] != 3 or tgt_pos.shape[1] != 3 or src_col.shape != src_pos.shape:
            raise ValueError(f"transfer_colors_compact: sources {tuple(src_pos.shape)}, colors "
                             f"{tuple(src_col.shape)}, targets {tuple(tgt_pos.shape)}")
        ns, nt = src_pos.shape[0], tgt_pos.shape[0]
        pending = _exact_launch(order, sk, tgt_pos, src_pos, 1, ns, nt, grid_bits, True,
                                "recolor")
        # the grids' host work queued behind the exact launch, before the read waits on it
        grid_s, grid_t = grids()
        lists, blend = _exact_read(*pending, ns, nt), _blend_merge
    exact_idx, has_exact, iidx, tq, uidx, sq = lists
    if iidx.shape[0]:
        idx, d2 = neighbors.knn(grid_s, tq, k=k, bucket=6)
    else:
        idx = d2 = torch.empty((0, k), dtype=torch.int32, device=d)
    if k_bwd > 0 and uidx.shape[0]:
        # a matched source's nearest target is its exact twin, which keeps
        # the exact color and never reads the splat: sweep only the rest
        tidx, td2 = neighbors.nearest(grid_t, sq, bucket=6)
    else:
        uidx = tidx = td2 = torch.empty(0, dtype=torch.int32, device=d)
    out = blend(src_col, exact_idx, has_exact, iidx, idx, d2, uidx, tidx, td2,
                float(max_geom_d2_fwd), float(max_color_d2_fwd), float(dist_offset_fwd),
                float(max_geom_d2_bwd))
    return out, (exact_idx, has_exact)


def transfer_colors(
    src_pos: torch.Tensor,     # (Ns, 3) int32
    src_col: torch.Tensor,     # (Ns, 3) uint8
    tgt_pos: torch.Tensor,     # (Nt, 3) int32
    exact_idx: torch.Tensor,   # (Nt,) int32
    has_exact: torch.Tensor,   # (Nt,) bool
    grid_bits: int = 10,
    k: int = 8,
    k_bwd: int = 1,
    max_geom_d2_fwd: float = 1000.0,
    max_geom_d2_bwd: float = 1000.0,
    max_color_d2_fwd: float = 1000.0,
    dist_offset_fwd: float = 4.0,
) -> torch.Tensor:
    """(Nt, 3) int32 colors of the targets, as the reference's
    `transfer_colors` + `_blend` (recolor.py:70-110, 291-339), the path it
    takes above 10 bits: the k-NN forward sweep over every target and, with
    k_bwd > 0, the nearest-target sweep over every source (kernel E,
    bucket 6), then kernel M's blend entry over every target and every
    source, a matched source gated out (one launch).
    `exact_idx`/`has_exact` come from the host `exact_matches`."""
    d = tgt_pos.device
    src_col = src_col.to(torch.uint8).contiguous()
    idx, d2 = neighbors.knn(neighbors.build_grid(src_pos, grid_bits), tgt_pos, k=k, bucket=6)
    if k_bwd > 0:
        tidx, td2 = neighbors.nearest(neighbors.build_grid(tgt_pos, grid_bits), src_pos, bucket=6)
        uidx = None
    else:
        uidx = tidx = td2 = torch.empty(0, dtype=torch.int32, device=d)
    return blend_merge(src_col, exact_idx, has_exact, None, idx, d2, uidx, tidx, td2,
                       float(max_geom_d2_fwd), float(max_color_d2_fwd), float(dist_offset_fwd),
                       float(max_geom_d2_bwd))


def transfer_reflectance(src_pos: torch.Tensor, src_refl: torch.Tensor,
                         tgt_pos: torch.Tensor, grid_bits: int = 10) -> torch.Tensor:
    """(Nt,) int32 reflectance of the targets (reference
    `transfer_reflectance`, recolor.py:267-288): the exact-position twin's
    value where one exists (kernel M's exact match, the first of equal
    source keys), else the nearest source's (kernel E, k=1, bucket 6) at
    whatever distance; a target with no source in its cell window reads
    source row 0, as the reference's `nearest` returns index 0 there.
    src_refl (Ns,) int32."""
    if grid_bits > 10:
        raise NotImplementedError(
            "the reflectance attribute above 10-bit geometry: the reference's "
            "`exact_matches_device` asserts bits <= 10 (vpcc_tpu/ops/recolor.py:48)")
    order, sk = sorted_source_keys(src_pos, grid_bits)
    exact_idx, has_exact, _, _ = exact_match(order, sk, tgt_pos, grid_bits)
    grid_s = neighbors.build_grid(src_pos, grid_bits)
    nidx, _ = neighbors.nearest(grid_s, tgt_pos.contiguous(), bucket=6)
    idx = torch.where(has_exact, exact_idx, nidx)
    return src_refl[idx.long()].to(torch.int32)


# ---------------------------------------------------------------------------
# B frames at once (the level-batched GOF path)

PAD_KEY = 0x7FFFFFFF


def sorted_source_keys_batch(src_pos: torch.Tensor, src_cnt: torch.Tensor, bits: int):
    """(order, sorted keys) (B, Ns) int32 of B padded source clouds (B, Ns,
    3): rows at or past a frame's count `src_cnt` (B,) take the key
    0x7FFFFFFF and sort last (stable sort per frame)."""
    B, ns, _ = src_pos.shape
    ks = _packed_keys(src_pos.reshape(-1, 3), bits).view(B, ns)
    valid = torch.arange(ns, device=src_pos.device)[None, :] < src_cnt.to(src_pos.device)[:, None]
    ks = torch.where(valid, ks, torch.full_like(ks, PAD_KEY))
    srt = torch.sort(ks, dim=1, stable=True)
    return srt.indices.to(torch.int32).contiguous(), srt.values.contiguous()


def exact_match_batch_plain(order, sk, tgt_pos, bits: int):
    """Frame by frame `exact_match_plain`: (exact_idx (B, Nt) int32,
    has_exact (B, Nt) bool, matched_src (B, Ns) bool)."""
    outs = [exact_match_plain(order[b], sk[b], tgt_pos[b], bits)[:3]
            for b in range(tgt_pos.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def blend_batch_plain(src_col, idx, d2, tidx, td2, exact_idx, has_exact, gd2_fwd: float,
                      cd2: float, doff: float, gd2_bwd: float):
    """Frame by frame, the uncompacted forward blend over every target and
    the splat (every source; td2 = MAX_DIST2 drops one) and merge:
    (B, Nt, 3) int32."""
    B, ns, _ = src_col.shape
    nt = exact_idx.shape[1]
    d = src_col.device
    every_src = torch.arange(ns, dtype=torch.int32, device=d)
    every_tgt = torch.arange(nt, dtype=torch.int32, device=d)
    return torch.stack([
        splat_merge_plain(src_col[b], every_src, tidx[b], td2[b], exact_idx[b], has_exact[b],
                          every_tgt, fwd_blend_plain(src_col[b], idx[b], d2[b], gd2_fwd, cd2,
                                                     doff), gd2_bwd)
        for b in range(B)])


def exact_match_batch(order, sk, tgt_pos, bits: int):
    """`exact_match_batch_plain` of B frames on the card: kernel M's exact
    entry without compaction, a frame's blocks its own (one cooperative
    launch)."""
    if tgt_pos.device.type == "cpu":
        return exact_match_batch_plain(order, sk, tgt_pos, bits)
    _check_exact(order, sk, tgt_pos, bits, 2)
    B, nt, ns = tgt_pos.shape[0], tgt_pos.shape[1], sk.shape[1]
    ints, flags = _exact_launch(order, sk, tgt_pos, None, B, ns, nt, bits, False,
                                "recolor_exact_batch")
    return ints.view(B, nt), flags[B * ns:].view(B, nt), flags[:B * ns].view(B, ns)


def blend_batch(src_col, idx, d2, tidx, td2, exact_idx, has_exact, gd2_fwd: float,
                cd2: float, doff: float, gd2_bwd: float):
    """`blend_batch_plain` of B frames on the card: kernel M's blend entry
    uncompacted (every (frame, target) row, every (frame, source); the
    caller set td2 to MAX_DIST2 where a source is matched or padded), one
    cooperative launch.  src_col (B, Ns, 3) uint8; idx, d2 (B, Nt, k);
    tidx, td2 (B, Ns); exact_idx, has_exact (B, Nt)."""
    if idx.device.type == "cpu":
        return blend_batch_plain(src_col, idx, d2, tidx, td2, exact_idx, has_exact, gd2_fwd,
                                 cd2, doff, gd2_bwd)
    d = idx.device
    dev.check_tensor(src_col, "src_col", torch.uint8, d, 3)
    for name, t, nd in (("idx", idx, 3), ("d2", d2, 3), ("tidx", tidx, 2), ("td2", td2, 2),
                        ("exact_idx", exact_idx, 2)):
        dev.check_tensor(t, name, torch.int32, d, nd)
    dev.check_tensor(has_exact, "has_exact", torch.bool, d, 2)
    B, nt, k = idx.shape
    ns = src_col.shape[1]
    if (k > 64 or k < 1 or d2.shape != idx.shape or src_col.shape != (B, ns, 3)
            or tidx.shape != (B, ns) or td2.shape != (B, ns)
            or exact_idx.shape != (B, nt) or has_exact.shape != (B, nt)):
        raise ValueError("recolor blend batch: inconsistent shapes")
    return _blend_launch(src_col, exact_idx, has_exact, None, idx, d2, None, tidx, td2, B, ns,
                         nt, float(gd2_fwd), float(cd2), float(doff), float(gd2_bwd), False,
                         "recolor_blend_batch").view(B, nt, 3)
