"""Video substream coders (vpcc_tpu/video/codecs.py): the occupancy and
EOM plane coders, the geometry and attribute substream encoders, and the
substream decoders.

At geometryQP <= 4 (attributeQP <= 4) a substream is coded losslessly, as
the reference's `_lossless_geo` / `_lossless_attr` branches code it: zlib
over a row-delta predictor (`video/lossless.py`), D1 (T1) as the delta
from the decoded D0 (T0).  The lossless geometry plane is background-filled
first (the reference's `intra.fill_plane_host`: push-pull on kernel L,
rounded half to even).

The reflectance attribute (attribute index 1, the AVD unit at map index
REFL_MAP_INDEX) is coded intra, frame by frame: its two 16-bit layer planes
verbatim through zlib at attributeQP <= 4, else at 10-bit precision (the
samples shifted right by 6) through the wavefront codec.

Substream coders are stateful: in random-access GOFs a P-frame predicts
from its reference frame, so each coder keeps its last decoded reference
planes on the device (`GeometrySubstreamEncoder.ref`,
`GeometrySubstreamDecoder.ref`, `AttributeSubstreamEncoder.refs`,
`AttributeSubstreamDecoder.refs`).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.ops import padding
from vpcc_tpu_torch.video import entropy, hevc, lossless

_UNSET = object()  # sentinel: caller did not override the temporal ref

_LEGACY = (
    "legacy 8x8 intra codec payloads (CODEC_TPU_INTRA): no encoder emits "
    "them; ROADMAP leaves video/intra.py out of the port"
)


def encode_occupancy(occ_video: np.ndarray, cfg: VPCCConfig) -> bytes:
    """Occupancy video frame (lossless, intra, context arithmetic coder)."""
    h, w = occ_video.shape
    return struct.pack("<HH", h, w) + entropy.encode_binary_plane(occ_video)


def decode_occupancy(payload: bytes, cfg: VPCCConfig) -> np.ndarray:
    h, w = struct.unpack("<HH", payload[:4])
    return entropy.decode_binary_plane(payload[4:], h, w)


def encode_eom_plane(eom: np.ndarray) -> bytes:
    """EOM bit-code plane (mostly zero): adaptive arithmetic coefficient
    blocks over 64-pixel runs (cbf skips empty blocks)."""
    h, w = eom.shape
    flat = eom.astype(np.int32).reshape(-1)
    nb = (flat.size + 63) // 64
    blocks = np.zeros((nb, 64), np.int32)
    blocks.reshape(-1)[:flat.size] = flat
    return struct.pack("<HH", h, w) + entropy.encode_coeffs(blocks)


def decode_eom_plane(payload: bytes) -> np.ndarray:
    h, w = struct.unpack("<HH", payload[:4])
    nb = (h * w + 63) // 64
    blocks = entropy.decode_coeffs(payload[4:], nb)
    return blocks.reshape(-1)[:h * w].reshape(h, w).astype(np.int32)


REFL_MAP_INDEX = 8  # AVD map_index of the reflectance attribute


def encode_reflectance(r0: torch.Tensor, r1: torch.Tensor, occ: np.ndarray, cfg: VPCCConfig,
                       qp_offset: int = 0):
    """(H, W) int32 layer planes on the device -> (payload, decoded planes
    dec0, dec1 (H, W) int32 on the same device), as the reference's
    `encode_reflectance` (codecs.py:81-100).  Lossless (attributeQP <= 4):
    byte 0, then zlib of the (H, W, 2) uint16 planes.  Lossy: byte 1, then
    the wavefront codec over (r0 >> 6, r1 >> 6) with maxval 1023, QP
    min(attributeQP + qp_offset, 51) for both planes, the background filled
    and the RD weighted by `occ` (the atlas occupancy), deblocked, intra;
    the decoded planes shifted back by 6.  (The reference's
    `not intra.AVAILABLE` branch never runs: its legacy codec is always
    available.)"""
    d = r0.device
    if cfg.attributeQP <= 4:
        h0 = r0.cpu().numpy().astype(np.uint16)
        h1 = r1.cpu().numpy().astype(np.uint16)
        payload = b"\x00" + lossless.encode_plane(np.stack([h0, h1], -1))
        return (payload, torch.as_tensor(h0.astype(np.int32), device=d),
                torch.as_tensor(h1.astype(np.int32), device=d))
    occ_t = torch.as_tensor(np.ascontiguousarray(occ, np.uint8), device=d)
    qp = min(cfg.attributeQP + qp_offset, 51)
    pay, rec = hevc.encode_planes(torch.stack([r0 >> 6, r1 >> 6]), [qp, qp], [1023, 1023],
                                  occ=occ_t, weight=occ_t, deblock=True)
    return b"\x01" + pay, rec[0] << 6, rec[1] << 6


def decode_reflectance(payload: bytes, device: torch.device):
    """payload -> (dec0, dec1) (H, W) int32 planes on `device` (reference
    `decode_reflectance`, codecs.py:103-115)."""
    if payload[0] == 0:
        both = lossless.decode_plane(payload[1:])
        return (torch.as_tensor(both[..., 0].astype(np.int32), device=device),
                torch.as_tensor(both[..., 1].astype(np.int32), device=device))
    rec = hevc.decode_planes(payload[1:], device=device)
    return rec[0] << 6, rec[1] << 6


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class GeometrySubstreamEncoder:
    def __init__(self, cfg: VPCCConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ref: Optional[torch.Tensor] = None  # (H, W) int32 last decoded plane

    def encode(self, geo, occ=None, layer_ref=None, weight=None,
               temporal_ref=_UNSET, qp_offset: int = 0):
        """(H, W) geometry map -> (payload, decoded (H, W) int32 plane on the
        device), as the reference's `GeometrySubstreamEncoder.encode`.
        `layer_ref` (the decoded D0) makes D1 an inter-layer plane;
        otherwise `temporal_ref` (default: the last decoded plane; None
        forces intra) makes a motion-searched P-plane.  `occ` drives the
        background fill, `weight` (the decoded occupancy) the RD weights,
        `qp_offset` the hierarchical QP cascade."""
        cfg = self.cfg
        d = self.device
        as_t = lambda a: (a if torch.is_tensor(a) else torch.as_tensor(
            np.asarray(a).astype(np.int32))).to(device=d, dtype=torch.int32)
        geo_t = as_t(geo)
        if cfg.geometryQP <= 4:
            return self._encode_lossless(geo_t, occ, layer_ref, as_t)
        maxval = (1 << cfg.geometryBitDepth2D) - 1
        t_ref = self.ref if temporal_ref is _UNSET else temporal_ref
        ref = None
        motion = False
        if layer_ref is not None and tuple(layer_ref.shape) == tuple(geo_t.shape):
            ref = as_t(layer_ref)
        elif t_ref is not None and tuple(t_ref.shape) == tuple(geo_t.shape):
            ref = as_t(t_ref)
            motion = True
        payload, rec = hevc.encode_planes(
            geo_t[None], [min(cfg.geometryQP + qp_offset, 51)], [maxval],
            refs=None if ref is None else ref[None],
            occ=None if occ is None else as_t(occ).to(torch.uint8),
            deblock=False,
            weight=None if weight is None else as_t(weight),
            motion=motion,
        )
        self.ref = rec[0]
        return bytes([v3c.CODEC_TPU_HEVC]) + payload, rec[0]

    @staticmethod
    def _encode_lossless(geo_t, occ, layer_ref, as_t):
        """The reference's lossless branch (codecs.py:145-156): push-pull
        fill under `occ` (kernel L), then zlib of the plane, or of its
        difference from the decoded D0 modulo 2^16.  No temporal state."""
        if occ is not None:
            geo_t = padding.push_pull_round(geo_t, as_t(occ).to(torch.uint8))
        geo = geo_t.cpu().numpy().astype(np.uint16)
        if layer_ref is not None and tuple(layer_ref.shape) == geo.shape:
            delta = (geo.astype(np.int32) - _host(layer_ref).astype(np.int32)) % 65536
            payload = bytes([v3c.CODEC_LOSSLESS_DELTA]) + lossless.encode_plane(
                delta.astype(np.uint16))
        else:
            payload = bytes([v3c.CODEC_LOSSLESS_ZLIB]) + lossless.encode_plane(geo)
        return payload, as_t(geo)


class AttributeSubstreamEncoder:
    def __init__(self, cfg: VPCCConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        # (y (1, H, W), cbcr (2, H/2, W/2)) int32 planes of the last
        # decoded attribute frame
        self.refs = None

    def encode(self, attr, layer_ref=None, weight=None, temporal_ref=_UNSET,
               qp_offset: int = 0):
        """(H, W, 3) background-filled RGB (integer 0..255) -> (payload,
        decoded (H, W, 3) uint8 RGB on the device), as the reference's
        `AttributeSubstreamEncoder.encode` (codecs.py:222-270) with
        occ=None: at attributeQP <= 4 the lossless branch (zlib of the
        image, or of its difference from the decoded T0 modulo 256).  `layer_ref` (the decoded T0) makes T1 an inter-layer
        frame; otherwise `temporal_ref` (default: the last decoded planes;
        None forces intra) makes a motion-searched P-frame.  `weight` (the
        decoded occupancy) drives the RD weights, `qp_offset` the
        hierarchical QP cascade (no cap on attributes)."""
        cfg = self.cfg
        attr = torch.as_tensor(attr, device=self.device)
        if cfg.attributeQP <= 4:
            rgb = attr.cpu().numpy().astype(np.uint8)
            if layer_ref is not None and tuple(layer_ref.shape) == rgb.shape:
                delta = (rgb.astype(np.int16) - _host(layer_ref).astype(np.int16)) % 256
                payload = bytes([v3c.CODEC_LOSSLESS_DELTA]) + lossless.encode_plane(
                    delta.astype(np.uint8))
            else:
                payload = bytes([v3c.CODEC_LOSSLESS_ZLIB]) + lossless.encode_plane(rgb)
            return payload, torch.as_tensor(rgb, device=self.device)
        t_refs = self.refs if temporal_ref is _UNSET else temporal_ref
        refs = None
        motion = False
        if layer_ref is not None and tuple(layer_ref.shape[:2]) == tuple(attr.shape[:2]):
            refs = hevc.rgb_refs(torch.as_tensor(layer_ref, device=self.device))
        elif t_refs is not None and tuple(t_refs[0].shape[1:]) == tuple(attr.shape[:2]):
            refs = t_refs
            motion = True
        payload, rgb, self.refs = hevc.encode_rgb(
            attr, qp=min(cfg.attributeQP + qp_offset, 51), refs=refs,
            weight=weight, motion=motion)
        return bytes([v3c.CODEC_TPU_HEVC]) + payload, rgb


class GeometrySubstreamDecoder:
    def __init__(self, cfg: VPCCConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ref: Optional[torch.Tensor] = None  # (H, W) int32

    def decode(self, payload: bytes, layer_ref=None, temporal_ref=_UNSET):
        """-> decoded plane: (H, W) int32 tensor for the wavefront codec,
        (H, W) uint16 numpy for the lossless codecs."""
        codec = payload[0]
        if codec == v3c.CODEC_LOSSLESS_ZLIB:
            return lossless.decode_plane(payload[1:])
        if codec == v3c.CODEC_LOSSLESS_DELTA:
            delta = lossless.decode_plane(payload[1:])
            return ((delta.astype(np.int32) + _host(layer_ref).astype(np.int32))
                    % 65536).astype(np.uint16)
        if codec != v3c.CODEC_TPU_HEVC:
            raise NotImplementedError(_LEGACY)
        h, w = struct.unpack("<HH", payload[1:5])
        t_ref = self.ref if temporal_ref is _UNSET else temporal_ref
        ref = None
        if layer_ref is not None and tuple(layer_ref.shape) == (h, w):
            ref = (layer_ref if torch.is_tensor(layer_ref) else
                   torch.as_tensor(np.asarray(layer_ref).astype(np.int32))).to(
                       device=self.device, dtype=torch.int32)
        elif t_ref is not None and tuple(t_ref.shape) == (h, w):
            ref = t_ref
        rec = hevc.decode_planes(
            payload[1:], refs=None if ref is None else ref[None],
            device=self.device,
        )
        self.ref = rec[0]
        return rec[0]


class AttributeSubstreamDecoder:
    def __init__(self, cfg: VPCCConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        # (y (1, H, W), cbcr (2, H/2, W/2)) int32 reference planes
        self.refs = None

    def decode(self, payload: bytes, layer_ref=None, temporal_ref=_UNSET):
        """-> decoded RGB: (H, W, 3) uint8 tensor for the wavefront codec,
        numpy for the lossless codecs."""
        codec = payload[0]
        if codec == v3c.CODEC_LOSSLESS_ZLIB:
            return lossless.decode_plane(payload[1:])
        if codec == v3c.CODEC_LOSSLESS_DELTA:
            delta = lossless.decode_plane(payload[1:])
            return ((delta.astype(np.int16) + _host(layer_ref).astype(np.int16))
                    % 256).astype(np.uint8)
        if codec != v3c.CODEC_TPU_HEVC:
            raise NotImplementedError(_LEGACY)
        h, w = hevc.peek_rgb_dims(payload[1:])
        t_refs = self.refs if temporal_ref is _UNSET else temporal_ref
        refs = None
        if layer_ref is not None and tuple(layer_ref.shape[:2]) == (h, w):
            lr = layer_ref if torch.is_tensor(layer_ref) else torch.as_tensor(
                np.asarray(layer_ref, np.uint8))
            refs = hevc.rgb_refs(lr.to(self.device))
        elif t_refs is not None and tuple(t_refs[0].shape[1:]) == (h, w):
            refs = t_refs
        dec_rgb, new_refs = hevc.decode_rgb(payload[1:], refs=refs,
                                            device=self.device)
        self.refs = new_refs
        return dec_rgb
