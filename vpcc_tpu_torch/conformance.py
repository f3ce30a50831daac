"""Decoder conformance logging + checking (the PccLibConformance equivalent).

Behavioral reference: `PCCConformance::check`
(source/lib/PccLibConformance/source/PCCConformance.cpp:49-307): encoder and
decoder both emit canonical per-frame key/value log files
(atlas / tile / pcframe / picture, see PCCLogger.h:43-86); the checker diffs
them key-by-key (compareLogFiles, :158) and validates V3C level limits
(checkLevelLimits, :210).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from vpcc_tpu_torch.utils.checksum import point_cloud_checksum
from vpcc_tpu_torch.utils.ply import PointCloudData

# Full V3C level tables (ISO/IEC 23090-5 Tables A-5 / A-6; reference:
# V3CLevelTable / ASPSLevelTable, PCCConfigurationFileParser.h:88-102, used
# by checkLevelLimits, PCCConformance.cpp:210-307).  level_idc = 30 * level
# (levels 1.0, 1.5, 2.0, 2.5, 3.0, 3.5 -> 30, 45, 60, 75, 90, 105).
V3C_LEVELS = (30, 45, 60, 75, 90, 105)

# Table A-5 per level: per-second and per-frame point budgets + counts
V3C_LEVEL_TABLE = {
    30:  dict(proj_pts_per_sec=30_000_000, eom_pts_per_sec=1_500_000,
              raw_pts_per_sec=1_500_000, proj_pts=1_000_000, eom_pts=50_000,
              raw_pts=50_000, map_count=2, attr_count=1, attr_dims=3),
    45:  dict(proj_pts_per_sec=60_000_000, eom_pts_per_sec=3_000_000,
              raw_pts_per_sec=3_000_000, proj_pts=2_000_000, eom_pts=100_000,
              raw_pts=100_000, map_count=2, attr_count=3, attr_dims=3),
    60:  dict(proj_pts_per_sec=120_000_000, eom_pts_per_sec=6_000_000,
              raw_pts_per_sec=6_000_000, proj_pts=4_000_000, eom_pts=200_000,
              raw_pts=200_000, map_count=4, attr_count=4, attr_dims=3),
    75:  dict(proj_pts_per_sec=240_000_000, eom_pts_per_sec=12_000_000,
              raw_pts_per_sec=12_000_000, proj_pts=8_000_000, eom_pts=400_000,
              raw_pts=400_000, map_count=4, attr_count=8, attr_dims=4),
    90:  dict(proj_pts_per_sec=480_000_000, eom_pts_per_sec=24_000_000,
              raw_pts_per_sec=24_000_000, proj_pts=16_000_000,
              eom_pts=800_000, raw_pts=800_000, map_count=8, attr_count=16,
              attr_dims=5),
    105: dict(proj_pts_per_sec=960_000_000, eom_pts_per_sec=48_000_000,
              raw_pts_per_sec=48_000_000, proj_pts=32_000_000,
              eom_pts=1_600_000, raw_pts=1_600_000, map_count=8,
              attr_count=24, attr_dims=6),
}

# Table A-6 per level: atlas-side budgets
ASPS_LEVEL_TABLE = {
    30:  dict(proj_patches=2048, raw_patches=32, eom_patches=32,
              cab_size=15_000, atlas_br=15_000, tiles=50,
              atlas_size=2_228_224, proj_patches_per_sec=65_536,
              raw_patches_per_sec=1024, eom_patches_per_sec=1024),
    45:  dict(proj_patches=4096, raw_patches=64, eom_patches=32,
              cab_size=30_000, atlas_br=30_000, tiles=50,
              atlas_size=2_228_224, proj_patches_per_sec=131_072,
              raw_patches_per_sec=2048, eom_patches_per_sec=1024),
    60:  dict(proj_patches=16_384, raw_patches=128, eom_patches=64,
              cab_size=120_000, atlas_br=120_000, tiles=200,
              atlas_size=8_912_896, proj_patches_per_sec=524_288,
              raw_patches_per_sec=4096, eom_patches_per_sec=2048),
    75:  dict(proj_patches=32_384, raw_patches=128, eom_patches=64,
              cab_size=240_000, atlas_br=240_000, tiles=200,
              atlas_size=8_912_896, proj_patches_per_sec=1_036_288,
              raw_patches_per_sec=4096, eom_patches_per_sec=2048),
    90:  dict(proj_patches=65_536, raw_patches=512, eom_patches=128,
              cab_size=480_000, atlas_br=480_000, tiles=500,
              atlas_size=35_651_584, proj_patches_per_sec=2_097_152,
              raw_patches_per_sec=16_384, eom_patches_per_sec=4096),
    105: dict(proj_patches=65_536, raw_patches=512, eom_patches=512,
              cab_size=480_000, atlas_br=480_000, tiles=500,
              atlas_size=35_651_584, proj_patches_per_sec=4_194_304,
              raw_patches_per_sec=32_768, eom_patches_per_sec=32_768),
}

# compact (max points per frame, max patches, max atlas size) view — the
# encoder's level derivation and the quick static check read this
LEVEL_LIMITS = {
    lv: (
        V3C_LEVEL_TABLE[lv]["proj_pts"] + V3C_LEVEL_TABLE[lv]["eom_pts"]
        + V3C_LEVEL_TABLE[lv]["raw_pts"],
        ASPS_LEVEL_TABLE[lv]["proj_patches"],
        ASPS_LEVEL_TABLE[lv]["atlas_size"],
    )
    for lv in V3C_LEVELS
}


def frame_log_entries(
    frame_index: int,
    pc: PointCloudData,
    patch_count: int,
    atlas_width: int,
    atlas_height: int,
) -> Dict[str, str]:
    """Canonical per-frame conformance record."""
    return {
        "FrameIdx": str(frame_index),
        "PointCount": str(pc.point_count),
        "PatchCount": str(patch_count),
        "AtlasWidth": str(atlas_width),
        "AtlasHeight": str(atlas_height),
        "Md5Geometry": point_cloud_checksum(PointCloudData(pc.positions)),
        "Md5Full": point_cloud_checksum(pc),
    }


def write_log(path: str | Path, frames: List[Dict[str, str]]) -> None:
    with open(path, "w") as f:
        for rec in frames:
            for k, v in rec.items():
                f.write(f"{k} = {v}\n")
            f.write("\n")


def read_log(path: str | Path) -> List[Dict[str, str]]:
    """A log `write_log` wrote (either package's): one dict a frame."""
    frames: List[Dict[str, str]] = []
    cur: Dict[str, str] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            if cur:
                frames.append(cur)
                cur = {}
            continue
        if "=" in line:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    if cur:
        frames.append(cur)
    return frames


def compare_logs(
    enc_log: List[Dict[str, str]], dec_log: List[Dict[str, str]]
) -> Tuple[bool, List[str]]:
    """Key-by-key MATCH/DIFF comparison (reference: compareLogFiles,
    PCCConformance.cpp:158-209): (whether they match, the differences)."""
    diffs: List[str] = []
    if len(enc_log) != len(dec_log):
        diffs.append(f"frame count differs: {len(enc_log)} vs {len(dec_log)}")
    for i, (a, b) in enumerate(zip(enc_log, dec_log)):
        for k in sorted(set(a) | set(b)):
            va, vb = a.get(k), b.get(k)
            if va != vb:
                diffs.append(f"frame {i}: {k}: {va} != {vb}")
    return (not diffs), diffs


def check_level_limits_dynamic(
    level: int,
    per_frame: List[Dict[str, int]],
    frame_rate: float = 30.0,
) -> List[str]:
    """Sliding-window per-second limit checks (reference: the dataWindow
    aggregation in checkLevelLimits, PCCConformance.cpp:210-307, against
    the *PerSec columns of Tables A-5/A-6).  `per_frame` entries may carry
    proj_pts / raw_pts / eom_pts / proj_patches / raw_patches /
    eom_patches counts; missing keys count as 0.  One error at most a key:
    the first window over its limit."""
    lv = level if level in V3C_LEVEL_TABLE else V3C_LEVELS[-1]
    caps = {
        "proj_pts": V3C_LEVEL_TABLE[lv]["proj_pts_per_sec"],
        "eom_pts": V3C_LEVEL_TABLE[lv]["eom_pts_per_sec"],
        "raw_pts": V3C_LEVEL_TABLE[lv]["raw_pts_per_sec"],
        "proj_patches": ASPS_LEVEL_TABLE[lv]["proj_patches_per_sec"],
        "raw_patches": ASPS_LEVEL_TABLE[lv]["raw_patches_per_sec"],
        "eom_patches": ASPS_LEVEL_TABLE[lv]["eom_patches_per_sec"],
    }
    win = max(int(frame_rate), 1)
    errs: List[str] = []
    for key, cap in caps.items():
        vals = [int(f.get(key, 0)) for f in per_frame]
        total = sum(vals[:win])
        for i in range(len(vals)):
            if i >= win:
                total += vals[i] - vals[i - win]
            if i >= win - 1 and total > cap:
                errs.append(f"{key} per-second aggregate {total} at frame {i} "
                            f"exceeds level {lv} limit {cap}")
                break
    return errs


def check_level_limits(
    level: int, point_count: int, patch_count: int, atlas_w: int, atlas_h: int
) -> List[str]:
    max_pts, max_patches, max_atlas = LEVEL_LIMITS.get(
        level, LEVEL_LIMITS[V3C_LEVELS[-1]]
    )
    errs = []
    if point_count > max_pts:
        errs.append(f"point count {point_count} exceeds level {level} limit {max_pts}")
    if patch_count > max_patches:
        errs.append(f"patch count {patch_count} exceeds level {level} limit {max_patches}")
    if atlas_w * atlas_h > max_atlas:
        errs.append(f"atlas {atlas_w}x{atlas_h} exceeds level {level} limit")
    return errs
