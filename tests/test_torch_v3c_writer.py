"""PyTorch port vs JAX reference: the writer half of the V3C syntax.

The port's copy of `vpcc_tpu/bitstream/v3c.py` must write the same bytes as
the reference for the same values: the VPS, ASPS, AFPS, AAPS, I- and
P-tiles (inter, merge and skip patch modes), every SEI the encoder's mux
emits, the video substreams and the sample stream.  The port's reader then
reads back what it wrote.
"""

import numpy as np
import pytest

from vpcc_tpu.bitstream import v3c as jv
from vpcc_tpu.bitstream.bitio import BitWriter as JWriter
from vpcc_tpu_torch.bitstream import v3c as tv
from vpcc_tpu_torch.bitstream.bitio import BitReader, BitWriter


def _both(make):
    """make(module) -> an object; (reference bytes, port bytes) of write."""
    out = []
    for mod, writer in ((jv, JWriter), (tv, BitWriter)):
        bw = writer()
        make(mod).write(bw)
        out.append(bw.getvalue())
    return out


@pytest.mark.parametrize("name", ["vps", "asps", "afps", "aaps", "video"])
def test_parameter_sets_and_video_substream(name):
    make = {
        "vps": lambda m: m.V3CParameterSet(
            ptl=m.ProfileTierLevel(level_idc=60), frame_width=1280, frame_height=1280,
            frame_count=8, occupancy_resolution=16, occupancy_precision=2,
            geometry_2d_bitdepth=8, geometry_3d_bitdepth=10, map_count_minus1=1,
            min_level=64),
        "asps": lambda m: m.AtlasSequenceParameterSet(
            frame_width=1280, frame_height=1280, log2_patch_packing_block_size=4,
            geometry_3d_bitdepth_minus1=9, geometry_2d_bitdepth_minus1=7,
            map_count_minus1=1, plr_block_threshold=9),
        "afps": lambda m: m.AtlasFrameParameterSet(num_tiles_minus1=0),
        "aaps": lambda m: m.AtlasAdaptationParameterSet(),
        "video": lambda m: m.VideoSubstream(m.V3C_AVD, 1, [b"\x04abc", b"", b"\x04" * 300]),
    }[name]
    ref, got = _both(make)
    assert got == ref
    if name == "vps":
        back = tv.V3CParameterSet.read(BitReader(got))
        assert (back.frame_width, back.frame_count, back.ptl.level_idc) == (1280, 8, 60)


def _patches(mod, rng, n, base=None):
    out = []
    for i in range(n):
        p = mod.PatchDataUnit(
            pos_x=int(rng.integers(0, 80)), pos_y=int(rng.integers(0, 80)),
            size_x_m1=int(rng.integers(0, 20)), size_y_m1=int(rng.integers(0, 20)),
            offset_u=int(rng.integers(0, 900)), offset_v=int(rng.integers(0, 900)),
            offset_d=int(rng.integers(0, 16)), range_d=int(rng.integers(0, 4)),
            projection_id=int(rng.integers(0, 6)), orientation=int(rng.integers(0, 2)),
            size_u=int(rng.integers(1, 300)), size_v=int(rng.integers(1, 300)))
        if base is not None and i < len(base) and i % 3 != 2:
            q = base[i]
            # matched patch: same projection; every third one identical (skip)
            p.projection_id, p.orientation = q.projection_id, q.orientation
            p.ref_index = i
            if i % 3 == 0:
                (p.pos_x, p.pos_y, p.size_x_m1, p.size_y_m1, p.offset_u, p.offset_v,
                 p.offset_d, p.range_d, p.size_u, p.size_v) = q.fields()
            elif i % 2:
                p.pos_x, p.pos_y = q.pos_x + 1, q.pos_y
        out.append(p)
    return out


def _atlas(mod):
    rng = np.random.default_rng(4)
    p0 = _patches(mod, rng, 12)
    p1 = _patches(mod, rng, 14, base=p0)
    tiles = [
        mod.AtlasTileLayer(frame_index=0, tile_id=0, patches=p0, geometry_bits=10,
                           tile_type=mod.TILE_I),
        mod.AtlasTileLayer(frame_index=1, tile_id=0, patches=p1, geometry_bits=10,
                           tile_type=mod.TILE_P, ref_patches=p0, ref_frame_delta=1),
    ]
    seis = [
        mod.SEIGeometrySmoothing(grid_size=8, threshold=64),
        mod.SEIComponentCodecMapping(),
        mod.SEIBufferingPeriod(initial_delay=3000),
        mod.SEIAtlasFrameTiming(),
        mod.SEIRecoveryPoint(recovery_afoc=0),
        mod.SEIActiveSubBitstreams(active_attributes=[0, 1], active_maps=[0, 1],
                                   raw_points_active_flag=0),
        mod.SEISceneObjectInformation(objects=[(0, (1, 2, 3, 500, 900, 300))]),
        mod.SEIObjectLabelInformation(labels=[(0, "pointcloud")]),
        mod.SEIVolumetricRectangleInformation(rectangles=[(0, 0, 16, 1264, 1248)]),
        mod.SEIAttributeTransformationParams(params=[(0, d, 65536, 2) for d in range(3)]),
    ]
    asps = mod.AtlasSequenceParameterSet(frame_width=1280, frame_height=1280)
    return mod.write_atlas_substream(tiles, asps, mod.AtlasFrameParameterSet(),
                                     prefix_seis=seis, aaps=mod.AtlasAdaptationParameterSet())


def test_atlas_substream_tiles_and_seis():
    ref, got = _atlas(jv), _atlas(tv)
    assert got == ref
    asps, _, tiles, hash_ok, seis = tv.read_atlas_substream(got)
    assert all(hash_ok) and len(tiles) == 2 and len(tiles[1].patches) == 14
    assert tv.SEI_GEOMETRY_SMOOTHING in seis and tv.SEI_VOLUMETRIC_RECTANGLE_INFORMATION in seis


def test_sample_stream():
    units = [(0, b"\x01" * 20), (1, b"\x02" * 70000), (4, b"")]
    assert tv.write_sample_stream(units) == jv.write_sample_stream(units)
    assert tv.read_sample_stream(tv.write_sample_stream(units)) == units
