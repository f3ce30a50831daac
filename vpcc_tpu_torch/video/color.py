"""Color conversion RGB <-> YCbCr, full range, BT.709 (the decoder's half of
vpcc_tpu/video/color.py).

Both directions are float32 and must round exactly as the JAX reference
does: the inter-layer attribute reference (`hevc.rgb_refs`) is derived from
these values on both the encoder and the decoder side.  The reference runs
on XLA's CPU backend, which fuses multiply-adds and multiplies by the
float32 reciprocal of a constant divisor; the formulas below are written in
that fused form (`device.fma_f32`, `device.recip_f32`), each remaining op
being one float32 rounding.  They are the plain versions of kernel Q
(csrc/color_convert.cu, `hevc.rgb_to_planes` / `_int_planes_to_rgb`),
which the video path runs on the card.
"""

from __future__ import annotations

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
