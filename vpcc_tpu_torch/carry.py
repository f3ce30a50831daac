"""State the codec carries from frame to frame, and how to seed it.

V-PCC has no learned weights.  What a decoder carries is its configuration
and its reference planes:
* `GeometrySubstreamDecoder.ref` — the last decoded geometry map, (H, W)
  int32;
* `AttributeSubstreamDecoder.refs` — (y (1, H, W), cbcr (2, H/2, W/2))
  int32 planes of the last decoded attribute frame;
* the decoder's hierarchical banks of those, per reference frame.

What the encoder carries is each tree parent's patch list (a P-frame
matches its patches against it and reuses their placements), the GOF's
height ratchet (with several tiles, one a tile, and the tiles' rows),
and on the geometry side each substream encoder's last decoded plane
(`GeometrySubstreamEncoder.ref`) and the bank of tree parents' decoded D0
planes (`geo_bank`, frame index -> (H, W) int32); on
the attribute side each substream encoder's last decoded planes
(`AttributeSubstreamEncoder.refs`, (y (1, H, W), cbcr (2, H/2, W/2))
int32) and the bank of tree parents' decoded T0 planes (`attr_bank`, frame
index -> such a pair).

These helpers build them from plain Python / numpy values, e.g. state saved
by the JAX package (`dataclasses.asdict(VPCCConfig)`, `np.asarray(plane)`,
`dataclasses.asdict(patch)`).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.utils.config import VPCCConfig


def config_from_dict(d: dict) -> VPCCConfig:
    """`dataclasses.asdict(VPCCConfig)` (either package's) -> the port's
    config.  Unknown keys raise."""
    names = {f.name for f in dataclasses.fields(VPCCConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise KeyError(f"unknown VPCCConfig fields: {unknown}")
    cfg = VPCCConfig()
    for k, v in d.items():
        setattr(cfg, k, copy.deepcopy(v))
    return cfg


def refs_from_numpy(planes, device=None):
    """Reference planes as numpy -> int32 tensors on the port's device.

    `planes` is one array (a geometry reference, (H, W) or (P, H, W)) or a
    tuple of arrays (an attribute reference (y, cbcr)); the result has the
    same structure."""
    d = dev.resolve_device(device)
    if isinstance(planes, (tuple, list)):
        return tuple(refs_from_numpy(p, d) for p in planes)
    return torch.as_tensor(np.asarray(planes).astype(np.int32), device=d)


def patches_from_dicts(dicts) -> list:
    """`dataclasses.asdict` of either package's patches (numpy maps) -> the
    port's `Patch`es, e.g. a tree parent's patch list saved by the JAX
    encoder, to seed the port's P-frame packing.  Unknown keys raise."""
    from vpcc_tpu_torch.core.patch import Patch

    names = {f.name for f in dataclasses.fields(Patch)}
    out = []
    for d in dicts:
        unknown = sorted(set(d) - names)
        if unknown:
            raise KeyError(f"unknown Patch fields: {unknown}")
        out.append(Patch(**copy.deepcopy(d)))
    return out


def seed_height_hint(encoder, height: int) -> None:
    """Set the encoder's GOF height ratchet (the largest atlas height of the
    GOF so far), e.g. to the JAX encoder's `_height_hint`."""
    encoder._height_hint = int(height)


def seed_tile_state(encoder, hints, rows) -> None:
    """Set the encoder's multi-tile state: each tile's height ratchet
    (`_tile_hints`) and the tiles' first block rows of the last packed frame
    (`_tile_rows`), e.g. to the JAX encoder's.  A seeded P-frame's tree
    parent patches must carry their `tile_assigned`."""
    encoder._tile_hints = [int(h) for h in hints]
    encoder._tile_rows = [int(r) for r in rows]


def seed_geometry_streams(streams: dict, planes: dict, device=None) -> dict:
    """Set each geometry substream encoder's last decoded plane
    (`streams[name].ref`) from numpy, e.g. the JAX encoder's
    `streams["geo0"].ref`; `planes` maps stream names to (H, W) arrays.
    Returns `streams`."""
    for name, plane in planes.items():
        streams[name].ref = refs_from_numpy(plane, device)
    return streams


def geo_bank_from_numpy(bank: dict, device=None) -> dict:
    """The reference's decoded-D0 bank (frame index -> (H, W) plane) as
    int32 tensors on the port's device: a P-frame's temporal reference for
    `Encoder.encode_frame_geometry` (`temporal_refs={"geo": bank[parent]}`)."""
    return {int(k): refs_from_numpy(v, device) for k, v in bank.items()}


def seed_attribute_streams(streams: dict, refs: dict, device=None) -> dict:
    """Set each attribute substream encoder's last decoded planes
    (`streams[name].refs`) from numpy, e.g. the JAX encoder's
    `streams["attr0"].refs`; `refs` maps stream names to (y, cbcr) pairs.
    Returns `streams`."""
    for name, planes in refs.items():
        streams[name].refs = refs_from_numpy(tuple(planes), device)
    return streams


def attr_bank_from_numpy(bank: dict, device=None) -> dict:
    """The reference's decoded-T0 bank (frame index -> (y, cbcr)) as int32
    tensors on the port's device: a P-frame's temporal reference for
    `Encoder.encode_frame` (`temporal_refs={"attr": bank[parent], ...}`)."""
    return {int(k): refs_from_numpy(tuple(v), device) for k, v in bank.items()}
