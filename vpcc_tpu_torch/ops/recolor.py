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
2. compaction: the inexact targets and the unmatched sources (torch
   `nonzero`, index order);
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
(its optimized HLO, recolor.cu's header), so `transfer_colors` drives the
same two entries uncompacted.  The port holds only valid rows (no padding),
so the reference's validity masks of padded rows have no counterpart.

`transfer_reflectance` (recolor.py:267) gives each target its exact twin's
16-bit reflectance, else its nearest source's: kernel M's exact match and
kernel E's k=1 sweep (bucket 6), no kernel of its own.

Kernel M (csrc/recolor.cu) has three entry points (exact match, forward
blend, splat and merge); the `*_plain` functions are their plain versions,
used for CPU tensors.

The level-batched GOF path (`parallel/gof.py` `recolor_level`, reference
`parallel/gof.py` `_exact_batch` / `_blend_batch`) runs the uncompacted
route over the B frames of a hierarchy level at once, on clouds padded to
common sizes: `sorted_source_keys_batch` gives the padded sources the key
0x7FFFFFFF (reference recolor.py:50-53), `exact_match_batch` (kernel M's
`recolor_exact_batch`) matches every frame's targets, and `blend_batch`
(`recolor_blend_batch`) runs the forward blend, the splat and the merge of
every frame; their plain versions loop over the frames.
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


# ---------------------------------------------------------------------------
# kernel M

_EXACT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [
    ctypes.c_void_p] * 2
_MERGE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float]
               + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)])


def _fn(name: str, args):
    fn = getattr(dev.load_kernel("recolor"), name)
    fn.argtypes, fn.restype = args, ctypes.c_int
    return fn


def exact_match(order, sk, tgt_pos, bits: int):
    """Kernel M, entry 1: `exact_match_plain` on the card."""
    if tgt_pos.device.type == "cpu":
        return exact_match_plain(order, sk, tgt_pos, bits)
    d = tgt_pos.device
    dev.check_tensor(order, "order", torch.int32, d, 1)
    dev.check_tensor(sk, "sorted keys", torch.int32, d, 1)
    dev.check_tensor(tgt_pos, "tgt_pos", torch.int32, d, 2)
    if bits > 10:
        raise ValueError("recolor exact match: packed keys need bits <= 10")
    ns, nt = sk.shape[0], tgt_pos.shape[0]
    if order.shape != sk.shape or tgt_pos.shape[1] != 3:
        raise ValueError(f"recolor exact match: order {tuple(order.shape)}, keys "
                         f"{tuple(sk.shape)}, targets {tuple(tgt_pos.shape)}")
    eidx = torch.empty(nt, dtype=torch.int32, device=d)
    has = torch.empty(nt, dtype=torch.bool, device=d)
    matched = torch.zeros(ns, dtype=torch.int32, device=d)
    counts = torch.tensor([0, ns], dtype=torch.int32, device=d)
    rc = _fn("recolor_exact", _EXACT_ARGS)(
        dev.ptr(order), dev.ptr(sk), dev.ptr(tgt_pos), ns, nt, bits,
        dev.ptr(eidx), dev.ptr(has), dev.ptr(matched), dev.ptr(counts), dev.stream_handle())
    dev.count_launch("recolor", 1 if nt else 0)
    dev.check_launch("recolor", rc)
    return eidx, has, matched != 0, counts


def fwd_blend(src_col, idx, d2, gd2: float, cd2: float, doff: float):
    """Kernel M, entry 2: `fwd_blend_plain` on the card (one thread per
    inexact target)."""
    if idx.device.type == "cpu":
        return fwd_blend_plain(src_col, idx, d2, gd2, cd2, doff)
    d = idx.device
    dev.check_tensor(src_col, "src_col", torch.uint8, d, 2)
    dev.check_tensor(idx, "idx", torch.int32, d, 2)
    dev.check_tensor(d2, "d2", torch.int32, d, 2)
    m, k = idx.shape
    if k > 64 or d2.shape != idx.shape or src_col.shape[1] != 3:
        raise ValueError(f"recolor forward blend: idx {tuple(idx.shape)}, d2 "
                         f"{tuple(d2.shape)}, colors {tuple(src_col.shape)} (k <= 64)")
    out = torch.empty((m, 3), dtype=torch.float32, device=d)
    rc = _fn("recolor_fwd_blend", _FWD_ARGS)(
        dev.ptr(src_col), dev.ptr(idx), dev.ptr(d2), m, k, gd2, cd2, doff,
        dev.ptr(out), dev.stream_handle())
    dev.count_launch("recolor", 1 if m else 0)
    dev.check_launch("recolor", rc)
    return out


def splat_merge(src_col, uidx, tidx, td2, exact_idx, has_exact, iidx, fwd,
                gd2_bwd: float):
    """Kernel M, entry 3: `splat_merge_plain` on the card: the integer
    atomic splat of the unmatched sources, the forward colors scattered to
    their targets, then the merge per target."""
    if exact_idx.device.type == "cpu":
        return splat_merge_plain(src_col, uidx, tidx, td2, exact_idx, has_exact,
                                 iidx, fwd, gd2_bwd)
    d = exact_idx.device
    dev.check_tensor(src_col, "src_col", torch.uint8, d, 2)
    for name, t in (("uidx", uidx), ("tidx", tidx), ("td2", td2),
                    ("exact_idx", exact_idx), ("iidx", iidx)):
        dev.check_tensor(t, name, torch.int32, d, 1)
    dev.check_tensor(has_exact, "has_exact", torch.bool, d, 1)
    dev.check_tensor(fwd, "fwd", torch.float32, d, 2)
    nt, mu, mi = exact_idx.shape[0], uidx.shape[0], iidx.shape[0]
    if (tidx.shape != uidx.shape or td2.shape != uidx.shape or has_exact.shape != exact_idx.shape
            or fwd.shape != (mi, 3) or src_col.shape[1] != 3):
        raise ValueError("recolor splat/merge: inconsistent shapes")
    acc = torch.zeros((nt, 4), dtype=torch.int32, device=d)   # r, g, b, count
    fwd_full = torch.zeros((nt, 3), dtype=torch.float32, device=d)
    out = torch.empty((nt, 3), dtype=torch.int32, device=d)
    launched = ctypes.c_int(0)
    rc = _fn("recolor_splat_merge", _MERGE_ARGS)(
        dev.ptr(src_col), dev.ptr(uidx), dev.ptr(tidx), dev.ptr(td2), dev.ptr(exact_idx),
        dev.ptr(has_exact), dev.ptr(iidx), dev.ptr(fwd), nt, mu, mi, gd2_bwd,
        dev.ptr(acc), dev.ptr(fwd_full), dev.ptr(out), dev.stream_handle(),
        ctypes.byref(launched))
    dev.count_launch("recolor", launched.value)
    dev.check_launch("recolor", rc)
    return out


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
    the inexact targets and (k_bwd > 0) the unmatched sources."""
    if grid_bits > 10:
        raise ValueError("transfer_colors_compact: packed int32 keys need grid_bits <= 10 "
                         "(above, use exact_matches + transfer_colors)")
    src_col = src_col.to(torch.uint8).contiguous()
    order, sk = sorted_source_keys(src_pos, grid_bits)
    exact_idx, has_exact, matched, counts = exact_match(order, sk, tgt_pos, grid_bits)
    n_in, n_un = (int(v) for v in counts.tolist())   # one sync sizes both sweeps
    iidx = torch.nonzero(~has_exact).flatten().to(torch.int32)
    fwd = torch.zeros((n_in, 3), dtype=torch.float32, device=tgt_pos.device)
    if n_in:
        grid_s = neighbors.build_grid(src_pos, grid_bits)
        idx, d2 = neighbors.knn(grid_s, tgt_pos[iidx.long()].contiguous(), k=k, bucket=6)
        fwd = fwd_blend(src_col, idx, d2, float(max_geom_d2_fwd),
                        float(max_color_d2_fwd), float(dist_offset_fwd))
    empty = torch.zeros(0, dtype=torch.int32, device=tgt_pos.device)
    uidx, tidx, td2 = empty, empty, empty
    if k_bwd > 0 and n_un:
        # a matched source's nearest target is its exact twin, which keeps
        # the exact color and never reads the splat: sweep only the rest
        uidx = torch.nonzero(~matched).flatten().to(torch.int32)
        grid_t = neighbors.build_grid(tgt_pos, grid_bits)
        tidx, td2 = neighbors.nearest(grid_t, src_pos[uidx.long()].contiguous(), bucket=6)
    out = splat_merge(src_col, uidx, tidx, td2, exact_idx, has_exact, iidx, fwd,
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
    bucket 6), then kernel M's forward blend over every target and its
    splat and merge over every source, a matched source gated out.
    `exact_idx`/`has_exact` come from the host `exact_matches`."""
    d = tgt_pos.device
    src_col = src_col.to(torch.uint8).contiguous()
    ns, nt = src_pos.shape[0], tgt_pos.shape[0]
    grid_s = neighbors.build_grid(src_pos, grid_bits)
    idx, d2 = neighbors.knn(grid_s, tgt_pos, k=k, bucket=6)
    fwd = fwd_blend(src_col, idx, d2, float(max_geom_d2_fwd), float(max_color_d2_fwd),
                    float(dist_offset_fwd))
    if k_bwd > 0:
        grid_t = neighbors.build_grid(tgt_pos, grid_bits)
        tidx, td2 = neighbors.nearest(grid_t, src_pos, bucket=6)
        matched = torch.zeros(ns, dtype=torch.bool, device=d)
        matched[exact_idx.long()[has_exact]] = True
        td2 = torch.where(matched, torch.full_like(td2, MAX_DIST2), td2)
        uidx = torch.arange(ns, dtype=torch.int32, device=d)
    else:
        uidx = tidx = td2 = torch.zeros(0, dtype=torch.int32, device=d)
    iidx = torch.arange(nt, dtype=torch.int32, device=d)
    return splat_merge(src_col, uidx, tidx, td2, exact_idx, has_exact, iidx, fwd,
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


_EXACT_BATCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
_BLEND_BATCH_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                     + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)])


def exact_match_batch(order, sk, tgt_pos, bits: int):
    """Kernel M's `recolor_exact_batch`: `exact_match_batch_plain` of B
    frames in one launch."""
    if tgt_pos.device.type == "cpu":
        return exact_match_batch_plain(order, sk, tgt_pos, bits)
    d = tgt_pos.device
    dev.check_tensor(order, "order", torch.int32, d, 2)
    dev.check_tensor(sk, "sorted keys", torch.int32, d, 2)
    dev.check_tensor(tgt_pos, "tgt_pos", torch.int32, d, 3)
    if bits > 10:
        raise ValueError("recolor exact match: packed keys need bits <= 10")
    B, nt, _ = tgt_pos.shape
    ns = sk.shape[1]
    if order.shape != sk.shape or sk.shape[0] != B or tgt_pos.shape[2] != 3:
        raise ValueError(f"recolor exact match batch: order {tuple(order.shape)}, keys "
                         f"{tuple(sk.shape)}, targets {tuple(tgt_pos.shape)}")
    eidx = torch.empty((B, nt), dtype=torch.int32, device=d)
    has = torch.empty((B, nt), dtype=torch.bool, device=d)
    matched = torch.zeros((B, ns), dtype=torch.int32, device=d)
    rc = _fn("recolor_exact_batch", _EXACT_BATCH_ARGS)(
        dev.ptr(order), dev.ptr(sk), dev.ptr(tgt_pos), B, ns, nt, bits,
        dev.ptr(eidx), dev.ptr(has), dev.ptr(matched), dev.stream_handle())
    dev.count_launch("recolor_exact_batch", 1 if B * nt else 0)
    dev.check_launch("recolor_exact_batch", rc)
    return eidx, has, matched != 0


def blend_batch(src_col, idx, d2, tidx, td2, exact_idx, has_exact, gd2_fwd: float,
                cd2: float, doff: float, gd2_bwd: float):
    """Kernel M's `recolor_blend_batch`: `blend_batch_plain` of B frames,
    one launch per step (blend, splat, merge) for all of them.  src_col
    (B, Ns, 3) uint8; idx, d2 (B, Nt, k); tidx, td2 (B, Ns); exact_idx,
    has_exact (B, Nt)."""
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
    if (k > 64 or d2.shape != idx.shape or src_col.shape != (B, ns, 3)
            or tidx.shape != (B, ns) or td2.shape != (B, ns)
            or exact_idx.shape != (B, nt) or has_exact.shape != (B, nt)):
        raise ValueError("recolor blend batch: inconsistent shapes")
    acc = torch.zeros((B, nt, 4), dtype=torch.int32, device=d)
    fwd = torch.empty((B, nt, 3), dtype=torch.float32, device=d)
    out = torch.empty((B, nt, 3), dtype=torch.int32, device=d)
    launched = ctypes.c_int(0)
    rc = _fn("recolor_blend_batch", _BLEND_BATCH_ARGS)(
        dev.ptr(src_col), dev.ptr(idx), dev.ptr(d2), dev.ptr(tidx), dev.ptr(td2),
        dev.ptr(exact_idx), dev.ptr(has_exact), B, ns, nt, k, gd2_fwd, cd2, doff, gd2_bwd,
        dev.ptr(acc), dev.ptr(fwd), dev.ptr(out), dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("recolor_blend_batch", launched.value)
    dev.check_launch("recolor_blend_batch", rc)
    return out
