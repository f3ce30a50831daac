"""Occupancy-aware background fill of a video plane (push-pull).

The port of vpcc_tpu/ops/padding.py `push_pull_fill` as the geometry
encoder uses it (`video/hevc.py _round_int_plane`): unoccupied pixels take
a mip-pyramid interpolation of the occupied ones, so the block transform
spends no bits on artificial edges; then the plane is rounded to int32.

Push: level l+1 holds the 2x2 sums of level l's value (image * occupancy)
and weight (occupancy) planes, while both sides stay even.  Pull: from the
coarsest level down, a pixel with weight takes value / weight, one without
takes its parent's fill.  The 2x2 sums run in the order the reference's
XLA reduce uses, ((a + b) + c) + d over (0,0), (0,1), (1,0), (1,1); sums
above 2^24 (coarse levels of large planes) round in that order.

Kernel L (`csrc/push_pull.cu`) runs one launch per push level and one per
pull level; `push_pull_round_plain` is its plain version, used for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from vpcc_tpu_torch import device as dev


def _levels(h: int, w: int):
    """Pyramid level shapes, finest first (the reference's halving rule)."""
    out = [(h, w)]
    while h > 1 and w > 1 and h % 2 == 0 and w % 2 == 0:
        h //= 2
        w //= 2
        out.append((h, w))
    return out


def _sum2x2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    v = x.reshape(h // 2, 2, w // 2, 2)
    return ((v[:, 0, :, 0] + v[:, 0, :, 1]) + v[:, 1, :, 0]) + v[:, 1, :, 1]


def push_pull_fill_plain(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """(H, W) image (integer or float) and occupancy -> (H, W) float32:
    occupied pixels keep their value, the others get the pull fill."""
    img = image.to(torch.float32)
    occ = occupancy.to(torch.float32)
    vals, wts = [img * occ], [occ]
    for _ in _levels(*img.shape)[1:]:
        vals.append(_sum2x2(vals[-1]))
        wts.append(_sum2x2(wts[-1]))
    fill = vals[-1] / wts[-1].clamp(min=1.0)
    for lvl in range(len(vals) - 2, -1, -1):
        up = fill.repeat_interleave(2, 0).repeat_interleave(2, 1)
        fill = torch.where(wts[lvl] > 0, vals[lvl] / wts[lvl].clamp(min=1.0), up)
    return torch.where(occ > 0, img, fill)


def push_pull_round_plain(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """`push_pull_fill_plain` rounded half-to-even to (H, W) int32."""
    return torch.round(push_pull_fill_plain(image, occupancy)).to(torch.int32)


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]


def scratch_floats(h: int, w: int) -> int:
    """float32 scratch kernel L needs: value, weight and fill planes of
    every level."""
    return sum(3 * a * b for a, b in _levels(h, w))


def push_pull_round(image: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """Kernel L: push-pull fill of an (H, W) int32 image under an (H, W)
    uint8 occupancy, rounded to int32; `push_pull_round_plain` on the CPU."""
    if image.device.type == "cpu":
        return push_pull_round_plain(image, occupancy)
    d = image.device
    dev.check_tensor(image, "image", torch.int32, d, 2)
    dev.check_tensor(occupancy, "occupancy", torch.uint8, d, 2)
    if occupancy.shape != image.shape:
        raise ValueError(f"push_pull: shapes {tuple(image.shape)} / {tuple(occupancy.shape)}")
    H, W = image.shape
    scratch = torch.empty(scratch_floats(H, W), dtype=torch.float32, device=d)
    out = torch.empty_like(image)
    fn = dev.load_kernel("push_pull").push_pull
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(dev.ptr(image), dev.ptr(occupancy), dev.ptr(scratch), dev.ptr(out),
            H, W, dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("push_pull", launched.value)
    dev.check_launch("push_pull", rc)
    return out


def fill_rgb(planes: torch.Tensor, occupancy: torch.Tensor) -> torch.Tensor:
    """Background fill mode 1 of attribute images (reference `fill_rgb`,
    padding.py:176, through `fill_plane` to `push_pull_fill`): every (H, W)
    int32 channel plane of `planes` (..., H, W) is push-pull filled under
    the (H, W) uint8 occupancy and rounded half to even (kernel L, one
    launch sequence per plane).  The reference then clamps to 0..255, which
    changes nothing here: the fill averages integer channels of 0..255."""
    h, w = planes.shape[-2:]
    flat = planes.reshape(-1, h, w)
    return torch.stack([push_pull_round(p, occupancy) for p in flat]).reshape(planes.shape)
