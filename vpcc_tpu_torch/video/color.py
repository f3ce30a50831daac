"""Color conversion RGB <-> YCbCr, full range, BT.709, and 4:2:0 chroma
resampling (a copy of vpcc_tpu/video/color.py).

Both directions are float32 and must round exactly as the JAX reference
does: the inter-layer attribute reference (`hevc.rgb_refs`) is derived from
these values on both the encoder and the decoder side.  The reference runs
on XLA's CPU backend, which fuses multiply-adds and multiplies by the
float32 reciprocal of a constant divisor; the formulas below are written in
that fused form (`device.fma_f32`, `device.recip_f32`), each remaining op
being one float32 rounding.  They are the plain versions of kernel Q
(csrc/color_convert.cu, `hevc.rgb_to_planes` / `_int_planes_to_rgb`),
which the video path runs on the card.

The chroma resampling serves `apps/color_converter.py`: `downsample_420`
(2x2 mean) and `upsample_420` (nearest) in torch on the caller's device,
and the reference's selectable filter banks (`downsample_420_filter`,
`upsample_420_filter`) in float64 numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from vpcc_tpu_torch.device import fma_f32, recip_f32

# the float32 reciprocals XLA multiplies by (kernel Q receives the same)
INV_CB = recip_f32(1.8556)
INV_CR = recip_f32(1.5748)
INV_G = recip_f32(0.7152)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W, 3) float32 YCbCr, full range [0, 255].
    y = 0.2126 r + 0.7152 g + 0.0722 b; cb = (b - y) / 1.8556 + 128;
    cr = (r - y) / 1.5748 + 128."""
    r = rgb[..., 0].float()
    g = rgb[..., 1].float()
    b = rgb[..., 2].float()
    y = fma_f32(0.0722, b, fma_f32(0.2126, r, 0.7152 * g))
    cb = fma_f32(b - y, INV_CB, 128.0)
    cr = fma_f32(r - y, INV_CR, 128.0)
    return torch.stack([y, cb, cr], -1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float32 YCbCr full range -> (H, W, 3) uint8 RGB.
    r = y + 1.5748 cr'; b = y + 1.8556 cb'; g = (y - 0.2126 r - 0.0722 b)
    / 0.7152 (cb', cr' = cb - 128, cr - 128)."""
    y = ycc[..., 0]
    cb = ycc[..., 1] - 128.0
    cr = ycc[..., 2] - 128.0
    r = fma_f32(1.5748, cr, y)
    b = fma_f32(1.8556, cb, y)
    g = fma_f32(-0.0722, b, fma_f32(-0.2126, r, y)) * INV_G
    rgb = torch.stack([r, g, b], -1)
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


def downsample_420(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> (H/2, W/2) 2x2 mean: each row's pair summed, then
    the two rows' sums (XLA's CPU order, probed on random planes), then
    quartered (exact)."""
    h, w = plane.shape
    q = plane.reshape(h // 2, 2, w // 2, 2)
    return ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])) * 0.25


def upsample_420(plane: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2) -> (H, W) nearest (the F0 fallback of the reference's
    chroma upsampling)."""
    return plane.repeat_interleave(2, 0).repeat_interleave(2, 1)


# ---------------------------------------------------------------------------
# Selectable chroma resampling filter banks (reference g_filter444to420 /
# g_filter420to444, PCCInternalColorConverter.cpp:37-330).  Each downsample
# filter is (odd-phase taps, even-phase taps, offset, shift), applied
# separably (horizontal to half width, then vertical); each upsample filter
# carries 4 phase kernels (v0, v1, h0, h1).  Names per the reference enum:
# DF_F0 / DF_F1 / DF_TM5 / DF_WCS; UF_F0 / UF_FV / UF_GS / UF_LS3 / UF_TM.

DOWN_FILTERS = {
    0: ([64, 384, 64], [256, 256], 256.0, 9),            # DF_F0
    1: ([128, 256, 128], [256, 256], 256.0, 9),          # DF_F1
    2: ([21, 0, -52, 0, 159, 256, 159, 0, -52, 0, 21],
        [5, 11, -21, -37, 70, 228, 228, 70, -37, -21, 11, 5],
        256.0, 9),                                        # DF_TM5
    5: ([2, -3, -9, 6, 39, 58, 39, 6, -9, -3, 2],
        [1, 0, -7, -5, 22, 53, 53, 22, -5, -7, 0, 1],
        64.0, 7),                                         # DF_WCS
}

UP_FILTERS = {
    0: ([0, 256], [-8, 64, 216, -16], [-16, 144, 144, -16],
        [-16, 216, 64, -8], 128.0, 8),                    # UF_F0
    1: ([0, 256], [0, -16, 56, 240, -32, 8], [-16, 144, 144, -16],
        [8, -32, 240, 56, -16, 0], 128.0, 8),             # UF_FV
    2: ([0, 256], [-6, 58, 222, -18], [-16, 144, 144, -16],
        [-18, 222, 58, -6], 128.0, 8),                    # UF_GS
    3: ([0, 256], [2, -18, 70, 228, -34, 8], [6, -34, 156, 156, -34, 6],
        [8, -34, 228, 70, -18, 2], 128.0, 8),             # UF_LS3
    5: ([0, 256], [3, -16, 67, 227, -32, 7], [21, -52, 159, 159, -52, 21],
        [7, -32, 227, 67, -16, 3], 128.0, 8),             # UF_TM
}


def _edge_padded(x: np.ndarray, n: int, center: int) -> np.ndarray:
    """x (along axis 0) with `center` copies of its first row before and
    n - 1 - center of its last after."""
    return np.concatenate([np.repeat(x[:1], center, 0), x,
                           np.repeat(x[-1:], n - 1 - center, 0)], 0)


def _conv_phase(x: np.ndarray, taps, center: int, axis: int, phase: int) -> np.ndarray:
    """Edge-replicated 1-D convolution sampled at 2k + phase along `axis`
    (float64)."""
    t = np.asarray(taps, np.float64)
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    xp = _edge_padded(x, len(t), center)
    pos = np.arange(phase, x.shape[0], 2)
    out = np.zeros((len(pos),) + x.shape[1:], np.float64)
    for k in range(len(t)):
        out += t[k] * xp[pos + k]
    return np.moveaxis(out, 0, axis)


def downsample_420_filter(plane: np.ndarray, filt: int = 0) -> np.ndarray:
    """4:4:4 -> 4:2:0 chroma with the selected reference filter (reference
    downsampling(), PCCInternalColorConverter.cpp:645-668): the odd-phase
    taps horizontally to half width, the even-phase taps vertically to half
    height; float64, without the reference's integer rounding bias."""
    odd, even, _, shift = DOWN_FILTERS[int(filt)]
    scale = 1.0 / (1 << shift)
    h = _conv_phase(plane, odd, len(odd) // 2, axis=1, phase=0) * scale
    return _conv_phase(h, even, len(even) // 2 - 1, axis=0, phase=0) * scale


def upsample_420_filter(plane: np.ndarray, filt: int = 0) -> np.ndarray:
    """4:2:0 -> 4:4:4 chroma with the selected reference filter (reference
    upsampling(), PCCInternalColorConverter.cpp:670-696): chroma sits
    co-sited horizontally and interstitial vertically, so the vertical pass
    interpolates at -1/4 and +1/4 (kernels 1 and 3) and the horizontal pass
    at 0 and +1/2 (kernels 0 and 2); float64."""
    p0, p1, p2, p3, _, shift = UP_FILTERS[int(filt)]
    scale = 1.0 / (1 << shift)

    def up_axis(x, taps_even, c_even, taps_odd, c_odd, axis):
        x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
        n = x.shape[0]
        out = np.zeros((2 * n,) + x.shape[1:], np.float64)
        for sl, taps, center in ((slice(0, None, 2), taps_even, c_even),
                                 (slice(1, None, 2), taps_odd, c_odd)):
            t = np.asarray(taps, np.float64)
            xp = _edge_padded(x, len(t), center)
            acc = np.zeros_like(x)
            for k in range(len(t)):
                acc += t[k] * xp[np.arange(n) + k]
            out[sl] = acc * scale
        return np.moveaxis(out, 0, axis)

    v = up_axis(plane, p1, len(p1) // 2, p3, len(p3) // 2 - 1, axis=0)
    return up_axis(v, p0, len(p0) - 1, p2, len(p2) // 2 - 1, axis=1)
