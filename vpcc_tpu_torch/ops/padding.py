"""Occupancy-aware background fill of video planes (K13).

The port of vpcc_tpu/ops/padding.py: unoccupied pixels are filled with a
smooth continuation of the occupied signal, so that the block transform
spends no bits on artificial edges.  Four fills, each with a `*_plain`
twin (the plain PyTorch version, used for tensors on the CPU):

* push-pull (`push_pull_fill`, padding.py:23; kernel L): the geometry
  planes (`video/hevc.py _round_int_plane`, rounded to int32) and the
  attribute images under attributeBGFill=1.  Push: level l+1 holds the 2x2
  sums of level l's value (image * occupancy) and weight (occupancy) planes,
  while both sides stay even and above 1.  Pull: from the coarsest level
  down, a pixel with weight takes value / weight, one without its parent's
  fill;
* sparse dilation (`dilate_fill`, :78; kernel W, attributeBGFill=0):
  synchronous passes in which every empty pixel with a filled 4-neighbour
  takes the rounded (half to even) average of its filled neighbours, until
  the plane is full, a pass fills nothing (a fixed point) or 1024 passes
  have run;
* harmonic fill (`harmonic_fill`, :109; kernel W, attributeBGFill=2): push-pull's pyramid stopping at sides of 2 (not 1),
  pulled coarse to fine with 8 Jacobi steps per level, the pixels with
  weight held at value / weight;
* smoothed push-pull (`smooth_fill`, :58; kernel W; no caller in either
  package): push-pull, then 4 Jacobi steps with the occupied pixels
  held.

Every stencil wraps around the plane, as the reference's `jnp.roll`: the
"up" neighbour of the top row is the bottom row.  The float order is the
reference's XLA CPU program's (probed with crafted inputs,
tests/test_torch_bg_fill.py): the four stencil terms add as
((up + down) + left) + right, each step of the relaxation scaled by 0.25;
the averages are true divisions.  XLA sums a 2x2 push block of
`push_pull_fill` in one of two orders, S = ((a + b) + c) + d over (0,0),
(0,1), (1,0), (1,1), or P = (a + b) + (c + d), chosen per plane shape and
level by its fusion decisions (no closed form found: level 1 is P only on
square power-of-two planes, a middle level P where its input width is a
power of two), and the 1x1 top of a square power-of-two plane is one
reduction over the whole plane, which no 2x2 order describes.  The order
only shows where a block sum of non-negative integers reaches 2^24, i.e.
from level 9 of an 8-bit plane and level 8 of a 10-bit one, so both sides
are multiples of 256 there.  `data/push_order_xla.json`
(tests/torch_make_push_order.py) holds the probed order of every level
for every H and W that are multiples of 256 up to 2048 ("?" for a 1x1
top); the push-pull follows it.  At a "?" level, and at every level of a
shape not in the table, the push sums S and counts the blocks whose sum
reaches 2^24 (`inexact_blocks`): their order is not established, and a
caller that needs exactness requires the count to stay 0.  The same holds
for the pyramid of the harmonic and smoothed fills (`push_levels_plain`;
the harmonic fill's push is another XLA program whose order was not
probed), which always sums S and counts.  The attribute call
site (`fill_rgb`, channels vmapped last) sums level 1 of square
power-of-two planes S where `push_pull_fill` sums P; 8-bit sums there stay
below 2^11, exact in either order.

Kernel L (csrc/push_pull.cu) runs the whole push-pull of a stack of
planes, each under its own occupancy or all under one, rounded to int32
(`push_pull_round`).  Kernel W (csrc/bg_fill.cu) runs the dilation (a
frontier walked level by level in one persistent launch between a seed and
a finish launch) and the harmonic and smoothed fills (one entry: a push
launch, a launch for the levels of at most 80 x 80 pixels, a block a
plane, and one launch a larger level, 64 x 64 tiles with their halo
relaxed in shared memory, the first of three or more inside the second's
launch; the last selects, and rounds and clips where asked).
"""

from __future__ import annotations

import ctypes
import functools
import json
from typing import Dict, List, Optional, Tuple

import torch

from vpcc_tpu_torch import device as dev

DILATE_MAX_PASSES = 1024   # the reference's `max_iters`
HARMONIC_SMOOTH = 8        # Jacobi steps per level (the reference's `n_smooth`)
SMOOTH_ITERATIONS = 4      # Jacobi steps after the push-pull (`iterations`)


def _levels(h: int, w: int, min_side: int = 1) -> List[Tuple[int, int]]:
    """Pyramid level shapes, finest first: halve while both sides are even
    and above `min_side` (1 for push-pull, 2 for the harmonic fill)."""
    out = [(h, w)]
    while h > min_side and w > min_side and h % 2 == 0 and w % 2 == 0:
        h //= 2
        w //= 2
        out.append((h, w))
    return out


EXACT_LIMIT = float(1 << 24)  # float32 holds every integer up to here


@functools.lru_cache(maxsize=None)
def _order_table() -> Dict[str, str]:
    path = dev.PKG_DIR / "data" / "push_order_xla.json"
    return json.loads(path.read_text())["orders"]


def push_order(h: int, w: int) -> str:
    """XLA's order of each push level l = 1.. of `push_pull_fill` on an
    (h, w) plane, one letter a level: "S", "P", or "?" where it is not
    established (every level of a shape that was not probed)."""
    n = len(_levels(h, w)) - 1
    return _order_table().get(f"{h}x{w}", "?" * n)


@functools.lru_cache(maxsize=None)
def push_masks(h: int, w: int) -> Tuple[int, int]:
    """(pair mask, count mask): bit l-1 set where level l sums P, and where
    its order is not established (its sums reaching 2^24 are counted)."""
    order = push_order(h, w)
    bits = lambda ch: sum(1 << i for i, c in enumerate(order) if c == ch)
    return bits("P"), bits("?")


_INEXACT: Dict[str, torch.Tensor] = {}


def _inexact_counter(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in _INEXACT:
        _INEXACT[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _INEXACT[key]


def inexact_blocks() -> int:
    """Push blocks since the last `reset_inexact` whose sum reached 2^24
    where XLA's order is not established (reads every device's count)."""
    return sum(int(c.item()) for c in _INEXACT.values())


def reset_inexact() -> None:
    for c in _INEXACT.values():
        c.zero_()


def _sum2x2(x: torch.Tensor, pair: bool = False,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2x2 block sums in the order S or, with `pair`, P; with `count`, the
    blocks whose sum reaches 2^24 are added to it."""
    *lead, h, w = x.shape
    v = x.reshape(*lead, h // 2, 2, w // 2, 2)
    a, b, c, d = v[..., :, 0, :, 0], v[..., :, 0, :, 1], v[..., :, 1, :, 0], v[..., :, 1, :, 1]
    out = (a + b) + (c + d) if pair else ((a + b) + c) + d
    if count is not None:
        count += (out >= EXACT_LIMIT).sum().to(torch.int32)
    return out


def _stencil_sum(x: torch.Tensor) -> torch.Tensor:
    """((up + down) + left) + right with wraparound over the last two axes."""
    return (((torch.roll(x, 1, -2) + torch.roll(x, -1, -2)) + torch.roll(x, 1, -1))
            + torch.roll(x, -1, -1))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


# ---------------------------------------------------------------------------
# plain versions (any leading axes share the (H, W) occupancy; the
# push-pull also takes one per plane)

def push_pull_fill_plain(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """(..., H, W) image (integer or float) and an (H, W) occupancy, or one
    per plane, -> float32: occupied pixels keep their value, the others get
    the pull fill.  The push follows `push_order`; where it is unknown,
    blocks reaching 2^24 are counted (`inexact_blocks`)."""
    img = image.to(torch.float32)
    occ = occupancy.to(torch.float32)
    pair, unknown = push_masks(*img.shape[-2:])
    count = _inexact_counter(img.device)
    vals, wts = [img * occ], [occ]
    for lvl in range(1, len(_levels(*img.shape[-2:]))):
        p, c = bool(pair >> (lvl - 1) & 1), bool(unknown >> (lvl - 1) & 1)
        vals.append(_sum2x2(vals[-1], p, count if c else None))
        wts.append(_sum2x2(wts[-1], p))
    fill = vals[-1] / wts[-1].clamp(min=1.0)
    for lvl in range(len(vals) - 2, -1, -1):
        fill = torch.where(wts[lvl] > 0, vals[lvl] / wts[lvl].clamp(min=1.0), _up2(fill))
    return torch.where(occ > 0, img, fill)


def push_pull_round_plain(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """`push_pull_fill_plain` rounded half-to-even to (H, W) int32."""
    return torch.round(push_pull_fill_plain(image, occupancy)).to(torch.int32)


def push_levels_plain(image: torch.Tensor, occupancy: torch.Tensor, min_side: int):
    """The push alone: ([value sums of levels 1..L] (..., h, w) float32,
    [weight sums of levels 1..L] (h, w) float32), summed S, the blocks
    reaching 2^24 counted (`inexact_blocks`)."""
    v = image.to(torch.float32) * occupancy.to(torch.float32)
    w = occupancy.to(torch.float32)
    count = _inexact_counter(v.device)
    vals, wts = [], []
    for _ in _levels(*image.shape[-2:], min_side)[1:]:
        v, w = _sum2x2(v, False, count), _sum2x2(w)
        vals.append(v)
        wts.append(w)
    return vals, wts


def dilate_fill_plain(image: torch.Tensor, occupancy: torch.Tensor,
                      max_iters: int = DILATE_MAX_PASSES) -> Tuple[torch.Tensor, int]:
    """Sparse dilation of (..., H, W) planes under one (H, W) occupancy:
    (float32 planes, passes that filled a pixel).  The reference loops
    while a pixel is empty; a pass that fills nothing leaves the state as
    it is, so stopping there changes nothing."""
    img = image.to(torch.float32)
    occ = occupancy.to(torch.bool)
    filled = occ.clone()
    x = img * occ.to(torch.float32)
    passes = 0
    for _ in range(max_iters):
        if bool(filled.all()):
            break
        f = filled.to(torch.float32)
        wsum = _stencil_sum(f)
        newly = ~filled & (wsum > 0)
        if not bool(newly.any()):
            break
        avg = torch.round(_stencil_sum(x * f) / wsum.clamp(min=1.0))
        x = torch.where(newly, avg, x)
        filled = filled | newly
        passes += 1
    return torch.where(occ, img, x), passes


def _relax_plain(x: torch.Tensor, hold: torch.Tensor, fixed: torch.Tensor, n: int):
    for _ in range(n):
        x = torch.where(hold, fixed, _stencil_sum(x) * 0.25)
    return x


def harmonic_fill_plain(image: torch.Tensor, occupancy: torch.Tensor,
                        n_smooth: int = HARMONIC_SMOOTH) -> torch.Tensor:
    """Cascadic harmonic fill of (..., H, W) planes under one (H, W)
    occupancy -> float32."""
    img = image.to(torch.float32)
    occ = occupancy.to(torch.float32)
    pv, pw = push_levels_plain(image, occupancy, 2)
    vals, wts = [img * occ] + pv, [occ] + pw
    fill = vals[-1] / wts[-1].clamp(min=1.0)
    fill = _relax_plain(fill, wts[-1] > 0, fill, n_smooth)
    for lvl in range(len(vals) - 2, -1, -1):
        hold = wts[lvl] > 0
        avg = vals[lvl] / wts[lvl].clamp(min=1.0)
        fill = _relax_plain(torch.where(hold, avg, _up2(fill)), hold, avg, n_smooth)
    return torch.where(occ > 0, img, fill)


def smooth_fill_plain(image: torch.Tensor, occupancy: torch.Tensor,
                      iterations: int = SMOOTH_ITERATIONS) -> torch.Tensor:
    """Push-pull, then Jacobi steps with the occupied pixels held ->
    float32 (..., H, W)."""
    x = push_pull_fill_plain(image, occupancy)
    return _relax_plain(x, occupancy.to(torch.bool), x, iterations)


def round_clip_plain(filled: torch.Tensor, lo: int = 0, hi: int = 255) -> torch.Tensor:
    """Round half to even, clip, int32 (the reference's `fill_rgb` tail)."""
    return torch.round(filled).clamp(lo, hi).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel L

_NULL = ctypes.c_void_p(0)
_PP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
# the shared memory kernel L's top phase may take, in bytes (the H100's
# 227 KB a block; above it the top's levels go to scratch)
PUSH_TOP_SMEM = 232448


@functools.lru_cache(maxsize=None)
def push_pull_plan(P: int, H: int, W: int, planar: bool, top_smem: int) -> Tuple[int, int]:
    """(launches, scratch floats) of kernel L's `push_pull` on P planes of
    H x W, as csrc/push_pull.cu plans them: one launch where the pyramid has
    at most 5 levels (or a side is odd), else three (tile push, top, tile
    pull)."""
    args = (P, H, W, int(planar), top_smem)
    return tuple(dev.kernel_fn("push_pull", entry, [ctypes.c_int] * 5)(*args)
                 for entry in ("push_pull_launches", "push_pull_scratch_floats"))


def _check_planes(planes: torch.Tensor, occupancy: torch.Tensor, what: str):
    d = planes.device
    dev.check_tensor(planes, "planes", torch.int32, d)
    dev.check_tensor(occupancy, "occupancy", torch.uint8, d, 2)
    if planes.ndim < 2 or tuple(planes.shape[-2:]) != tuple(occupancy.shape):
        raise ValueError(f"{what}: planes {tuple(planes.shape)}, occupancy "
                         f"{tuple(occupancy.shape)}")


def push_pull_round(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """Kernel L: push-pull fill of an (H, W) or (P, H, W) int32 image under
    an (H, W) uint8 occupancy or one per plane (P, H, W), rounded to int32;
    `push_pull_round_plain` on the CPU.  At most three launches cover every
    plane (`push_pull_plan`), with no host wait."""
    if image.device.type == "cpu":
        return push_pull_round_plain(image, occupancy)
    d = image.device
    dev.check_tensor(image, "image", torch.int32, d)
    dev.check_tensor(occupancy, "occupancy", torch.uint8, d)
    planes = image if image.ndim == 3 else image[None]
    if planes.ndim != 3 or occupancy.ndim not in (2, 3) or (
            tuple(occupancy.shape[-2:]) != tuple(planes.shape[1:])
            or (occupancy.ndim == 3 and occupancy.shape[0] != planes.shape[0])):
        raise ValueError(f"push_pull: shapes {tuple(image.shape)} / {tuple(occupancy.shape)}")
    P, H, W = planes.shape
    planar = occupancy.ndim == 3
    pair, unknown = push_masks(H, W)
    launches, floats = push_pull_plan(P, H, W, planar, PUSH_TOP_SMEM)
    scratch = dev.scratch("push_pull", d, floats)
    out = torch.empty_like(planes)
    rc = dev.kernel_fn("push_pull", "push_pull", _PP_ARGS)(
        dev.ptr(planes), dev.ptr(occupancy), dev.ptr(scratch), dev.ptr(out), P, int(planar),
        H, W, pair, unknown, PUSH_TOP_SMEM,
        dev.ptr(_inexact_counter(d)) if unknown else _NULL, dev.stream_handle())
    dev.count_launch("push_pull", launches if P * H * W else 0)
    dev.check_launch("push_pull", rc)
    return out.reshape(image.shape)


# ---------------------------------------------------------------------------
# kernel W

_DILATE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_HARMONIC_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
_DILATE_HEADER = 4   # csrc/bg_fill.cu kHeader: three list counters, the passes run


@functools.lru_cache(maxsize=64)
def dilate_scratch_words(C: int, hw: int) -> int:
    """int32 words of scratch kernel W's dilation takes for C planes of hw
    pixels (csrc/bg_fill.cu plans them)."""
    fn = dev.kernel_fn("bg_fill", "bg_dilate_scratch_words", [ctypes.c_int, ctypes.c_longlong])
    fn.restype = ctypes.c_longlong
    return fn(C, hw)


def dilate_fill(planes: torch.Tensor, occupancy: torch.Tensor,
                max_iters: int = DILATE_MAX_PASSES,
                rounded: bool = False) -> Tuple[torch.Tensor, int]:
    """Kernel W, dilation: `dilate_fill_plain` of a (C, H, W) int32 stack
    on the card, and with `rounded` its `round_clip_plain` (int32) in its
    place.  Three launches and one host read (the pass count): a seed
    launch stamps each pixel's level (0 occupied) and lists the empty
    pixels next to an occupied one; one cluster of CTAs then walks the
    frontier level by level, a pixel filled in place from the neighbours
    stamped below its level, its unreached neighbours claimed for the next
    level, a cluster barrier between levels and the stop (an empty list, or
    max_iters) decided on the card; a finish launch selects (and rounds).
    The level walk is one cluster launch or nothing: where the card cannot
    place the cluster, the call raises."""
    if planes.device.type == "cpu":
        x, passes = dilate_fill_plain(planes, occupancy, max_iters)
        return (round_clip_plain(x) if rounded else x), passes
    _check_planes(planes, occupancy, "dilate_fill")
    C, H, W = planes.shape
    d = planes.device
    x = torch.empty((C, H, W), dtype=torch.float32, device=d)
    out = torch.empty((C, H, W), dtype=torch.int32, device=d) if rounded else None
    # zero when it grows; the kernel leaves its counters at 0
    scratch = dev.scratch("bg_dilate", d, dilate_scratch_words(C, H * W))
    launched = ctypes.c_int(0)
    rc = dev.kernel_fn("bg_fill", "bg_dilate", _DILATE_ARGS)(
        dev.ptr(planes), dev.ptr(occupancy), dev.ptr(x), dev.ptr(scratch),
        _NULL if out is None else dev.ptr(out), C, H, W, max_iters, 0, 255,
        dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("bg_dilate", launched.value)
    if rc != 0:
        scratch[:_DILATE_HEADER].zero_()   # a level walk that never ran leaves its counts
    dev.check_launch("bg_dilate", rc)
    return (x if out is None else out), int(scratch[_DILATE_HEADER - 1])


@functools.lru_cache(maxsize=64)
def harmonic_scratch_floats(C: int, H: int, W: int, min_side: int, steps: int,
                            steps0: int) -> int:
    """float32 scratch kernel W's harmonic entry takes for C planes of H x W
    (csrc/bg_fill.cu plans it)."""
    fn = dev.kernel_fn("bg_fill", "bg_harmonic_scratch_floats", [ctypes.c_int] * 6)
    fn.restype = ctypes.c_longlong
    return fn(C, H, W, min_side, steps, steps0)


def _harmonic(planes, occupancy, min_side: int, steps: int, steps0: int, hold_img: bool,
              floats: bool, rounded: bool, what: str):
    """Kernel W's harmonic entry on a (C, H, W) int32 stack: (float32
    planes or None, rounded int32 planes or None)."""
    _check_planes(planes, occupancy, what)
    C, H, W = planes.shape
    d = planes.device
    n = harmonic_scratch_floats(C, H, W, min_side, steps, steps0)
    fill = torch.empty((C, H, W), dtype=torch.float32, device=d) if floats else None
    out = torch.empty((C, H, W), dtype=torch.int32, device=d) if rounded else None
    scratch = dev.scratch("bg_harmonic", d, max(n, 1))
    launched = ctypes.c_int(0)
    rc = dev.kernel_fn("bg_fill", "bg_harmonic", _HARMONIC_ARGS)(
        dev.ptr(planes), dev.ptr(occupancy), dev.ptr(scratch),
        _NULL if fill is None else dev.ptr(fill), _NULL if out is None else dev.ptr(out),
        C, H, W, min_side, steps, steps0, int(hold_img), 0, 255,
        dev.ptr(_inexact_counter(d)), dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("bg_harmonic", launched.value)
    dev.check_launch("bg_harmonic", rc)
    return fill, out


def harmonic_fill(planes: torch.Tensor, occupancy: torch.Tensor,
                  n_smooth: int = HARMONIC_SMOOTH, rounded: bool = False) -> torch.Tensor:
    """Kernel W, harmonic fill: `harmonic_fill_plain` of a (C, H, W) int32
    stack on the card, and with `rounded` its `round_clip_plain` (int32) in
    its place.  One launch pushes levels 1..5 (32 x 32 regions in shared
    memory, the weights once for the stack, the value sums reaching 2^24
    counted in `inexact_blocks`), one pushes the rest and pulls and relaxes
    every level of at most 80 x 80 pixels whole in shared memory (a block a
    plane), then one launch a larger level (one for each 8 steps of a level
    that runs more) pulls 64 x 64 tiles with a halo of 8 pixels and relaxes
    them in shared memory; level 0 also selects (and rounds and clips).  6
    launches on 1280 x 1280 planes, no host wait."""
    if planes.device.type == "cpu":
        x = harmonic_fill_plain(planes, occupancy, n_smooth)
        return round_clip_plain(x) if rounded else x
    fill, out = _harmonic(planes, occupancy, 2, n_smooth, n_smooth, False, not rounded,
                          rounded, "harmonic_fill")
    return out if rounded else fill


def smooth_fill(planes: torch.Tensor, occupancy: torch.Tensor,
                iterations: int = SMOOTH_ITERATIONS) -> torch.Tensor:
    """Kernel W: `smooth_fill_plain` of a (C, H, W) int32 stack on the card,
    through the harmonic entry: the push-pull's pyramid (sides above 1,
    summed ((a + b) + c) + d, the sums reaching 2^24 counted), the pull with
    no steps above level 0, then `iterations` Jacobi steps at level 0 with
    the occupied pixels held at the image."""
    if planes.device.type == "cpu":
        return smooth_fill_plain(planes, occupancy, iterations)
    return _harmonic(planes, occupancy, 1, 0, iterations, True, True, False, "smooth_fill")[0]


def fill_rgb(planes: torch.Tensor, occupancy: torch.Tensor, mode: int = 1) -> torch.Tensor:
    """Background fill of attribute images (reference `fill_rgb`,
    padding.py:176, through `fill_plane`'s dispatch, :165): every (H, W)
    int32 channel plane of `planes` (..., H, W) is filled under the (H, W)
    uint8 occupancy by attributeBGFill `mode` (0 dilation, 1 push-pull,
    2 harmonic), rounded half to even and clipped to 0..255.  Every mode
    fills the whole stack at once: kernel L for mode 1 (its clip changes
    nothing: the fill averages integer channels of 0..255), kernel W for
    modes 0 and 2, its selection, rounding and clip in its last launch."""
    h, w = planes.shape[-2:]
    flat = planes.reshape(-1, h, w)
    if mode == 0:
        out, _ = dilate_fill(flat, occupancy, rounded=True)
    elif mode == 2:
        out = harmonic_fill(flat, occupancy, rounded=True)
    else:
        out = push_pull_round(flat.contiguous(), occupancy)
    return out.reshape(planes.shape)
