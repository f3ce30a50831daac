"""PccAppParser equivalent on the port: print a V3C stream's structure.

Reference: source/app/PccAppParser/PccAppParser.cpp:50-90; the port of
vpcc_tpu/apps/parser.py, over the port's `bitstream/v3c.py` and
`BitReader` (host code only: it runs no kernel).  The stream is what
`apps/encode.py` writes: each GOF's sample stream behind an 8-byte
big-endian length.  For each GOF it prints the units with their bytes, the
VPS's size, frame count, maps and profile/tier/level, and the atlas
substream's ASPS size, tile layers, patches, hash-SEI verdict, prefix SEIs
and AAPS.  With --annexBPath it lists the NAL units of an annex-B
HEVC/AVC elementary stream instead (`parse_annexb`).

Usage:
    python -m vpcc_tpu_torch.apps.parser --compressedStreamPath=in.vpcc
    python -m vpcc_tpu_torch.apps.parser --annexBPath=in.bin [--videoType=hevc|avc]
"""

from __future__ import annotations

import sys
from pathlib import Path

from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.utils.config import VPCCConfig

_UNIT_NAMES = {
    v3c.V3C_VPS: "V3C_VPS",
    v3c.V3C_AD: "V3C_AD",
    v3c.V3C_OVD: "V3C_OVD",
    v3c.V3C_GVD: "V3C_GVD",
    v3c.V3C_AVD: "V3C_AVD",
}

# HEVC (ISO/IEC 23008-2 Table 7-1) and AVC NAL type names (the
# PccLibHevcParser / PccLibAvcParser role)
_HEVC_NAL = {19: "IDR_W_RADL", 20: "IDR_N_LP", 21: "CRA", 32: "VPS",
             33: "SPS", 34: "PPS", 35: "AUD", 39: "PREFIX_SEI",
             40: "SUFFIX_SEI", 0: "TRAIL_N", 1: "TRAIL_R"}
_AVC_NAL = {1: "SLICE", 5: "IDR", 6: "SEI", 7: "SPS", 8: "PPS", 9: "AUD"}


def parse_annexb(data: bytes, codec: str = "hevc") -> list:
    """(offset, size, type, name) of each NAL unit behind an annex-B start
    code (0x000001) in `data` (reference: dependencies/PccLibHevcParser,
    PccAppParser.cpp:50-90).  The size runs to the next start code."""
    starts = []
    i = 0
    while i < len(data) - 3:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    starts.append(len(data) + 3)
    out = []
    for a, b in zip(starts[:-1], starts[1:]):
        size = (b - 3) - a
        if size <= 0:
            continue
        if codec == "avc":
            t = data[a] & 0x1F
            name = _AVC_NAL.get(t, f"nal_{t}")
        else:
            t = (data[a] >> 1) & 0x3F
            name = _HEVC_NAL.get(t, f"nal_{t}")
        out.append((a, size, t, name))
    return out


def _unit_line(utype: int, payload: bytes) -> str:
    line = f"  {_UNIT_NAMES.get(utype, f'unit_{utype}'):8s} {len(payload):9d} bytes"
    if utype == v3c.V3C_VPS:
        vps = v3c.V3CParameterSet.read(BitReader(payload))
        p = vps.ptl
        line += (f"  {vps.frame_width}x{vps.frame_height}, "
                 f"{vps.frame_count} frames, maps {vps.map_count_minus1 + 1}, "
                 f"PTL codec_group={p.profile_codec_group_idc} "
                 f"toolset={p.profile_toolset_idc} tier={p.tier_flag} "
                 f"level={p.level_idc}")
    elif utype == v3c.V3C_AD:
        asps, _, tiles, hash_ok, seis = v3c.read_atlas_substream(payload)
        n_patches = sum(len(t.patches) for t in tiles)
        line += (f"  ASPS {asps.frame_width}x{asps.frame_height}, "
                 f"{len(tiles)} ATLs, {n_patches} patches, "
                 f"hash SEI {'OK' if all(hash_ok) else 'MISMATCH'}")
        for ptype, sei in sorted(seis.items(), key=lambda kv: str(kv[0])):
            label = "AAPS" if ptype == "aaps" else f"prefix SEI {ptype}"
            line += f"\n    {label}: {sei}"
    return line


def main(argv=None) -> int:
    cfg = VPCCConfig.from_args(argv if argv is not None else sys.argv[1:])
    annexb = cfg.extra.get("annexBPath", "")
    if annexb:
        data = Path(annexb).read_bytes()
        codec = cfg.extra.get("videoType", "hevc")
        nals = parse_annexb(data, codec)
        for off, size, t, name in nals:
            print(f"  @{off:9d} {name:12s} ({t:2d}) {size:9d} bytes")
        print(f"{len(nals)} NAL units, {len(data)} bytes ({codec})")
        return 0
    if not cfg.compressedStreamPath:
        print("error: --compressedStreamPath or --annexBPath required", file=sys.stderr)
        return 1
    data = Path(cfg.compressedStreamPath).read_bytes()
    pos = gof = 0
    while pos < len(data):
        size = int.from_bytes(data[pos: pos + 8], "big")
        pos += 8
        units = v3c.read_sample_stream(data[pos: pos + size])
        pos += size
        print(f"GOF {gof}: {size} bytes, {len(units)} units")
        for utype, payload in units:
            print(_unit_line(utype, payload))
        gof += 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
