"""PyTorch port vs JAX reference: the conformance, parser and color converter
apps (`vpcc_tpu_torch/apps/conformance.py`, `parser.py`,
`color_converter.py`) and what they run on.

Each app runs beside its JAX counterpart on the same inputs, on the CPU:
* conformance: `read_log`, `compare_logs` and `check_level_limits_dynamic`
  on seeded logs and per-frame counts (a match, a value mismatch, a missing
  key, a frame too many, a level breach), and the app's exit code and
  printed output;
* parser: the printed output on the committed fixture
  `person_vox10_r3_gof8.vpcc` (as `apps/encode.py` frames it: each GOF
  behind an 8-byte length; two GOFs), and `parse_annexb` on seeded HEVC and
  AVC annex-B streams;
* color_converter: rgb2ycc and ycc2rgb at 4:4:4 and 4:2:0 with filters 0
  and 1, and the filter banks on their own at every filter.
All comparisons are exact: the uint8 RGB, the float32 YCbCr (the port's
conversion follows XLA's float order, `video/color.py`), the float32 2x2
means and the float64 filter outputs.
"""

from pathlib import Path

import numpy as np
import pytest

from vpcc_tpu import conformance as jconf
from vpcc_tpu.apps import color_converter as jcc
from vpcc_tpu.apps import conformance as jconf_app
from vpcc_tpu.apps import parser as jparser
from vpcc_tpu.video import color as jcolor
from vpcc_tpu_torch import conformance as conf
from vpcc_tpu_torch.apps import color_converter as cc
from vpcc_tpu_torch.apps import conformance as conf_app
from vpcc_tpu_torch.apps import parser
from vpcc_tpu_torch.video import color

FIXTURE = Path(__file__).resolve().parent.parent / "vpcc_tpu_torch" / "data" / \
    "person_vox10_r3_gof8.vpcc"


def _log(rng, n: int):
    """n frames of `conformance.frame_log_entries`' keys with seeded values."""
    return [{"FrameIdx": str(i), "PointCount": str(int(rng.integers(1, 900_000))),
             "PatchCount": str(int(rng.integers(1, 300))), "AtlasWidth": "1280",
             "AtlasHeight": str(int(rng.choice([1280, 1536]))),
             "Md5Geometry": f"{int(rng.integers(1 << 62)):032x}",
             "Md5Full": f"{int(rng.integers(1 << 62)):032x}"} for i in range(n)]


def _logs(case: str):
    """(encoder log, decoder log) of a seeded 4-frame GOF under `case`."""
    rng = np.random.default_rng(22)
    enc = _log(rng, 4)
    dec = [dict(r) for r in enc]
    if case == "value":
        dec[2]["Md5Full"] = "0" * 32
    elif case == "missing_key":
        del dec[1]["PatchCount"]
    elif case == "extra_frame":
        dec.append(dict(enc[0], FrameIdx="4"))
    elif case == "level":
        for r in (enc, dec):
            r[3]["PointCount"] = "5000000"
    return enc, dec


CASES = ["match", "value", "missing_key", "extra_frame", "level"]


@pytest.mark.parametrize("case", CASES)
def test_read_and_compare_logs(tmp_path, case):
    enc, dec = _logs(case)
    conf.write_log(tmp_path / "enc.txt", enc)
    jconf.write_log(tmp_path / "dec.txt", dec)
    got = (conf.read_log(tmp_path / "enc.txt"), conf.read_log(tmp_path / "dec.txt"))
    want = (jconf.read_log(tmp_path / "enc.txt"), jconf.read_log(tmp_path / "dec.txt"))
    assert got == want == (enc, dec)
    assert conf.compare_logs(*got) == jconf.compare_logs(*want)
    assert conf.compare_logs(*got)[0] == (case in ("match", "level"))


@pytest.mark.parametrize("case", CASES)
def test_conformance_app(tmp_path, capsys, case):
    enc, dec = _logs(case)
    conf.write_log(tmp_path / "enc.txt", enc)
    conf.write_log(tmp_path / "dec.txt", dec)
    argv = [f"--encLog={tmp_path / 'enc.txt'}", f"--decLog={tmp_path / 'dec.txt'}",
            "--levelIdc=30"]
    rc = conf_app.main(argv)
    out = capsys.readouterr().out
    want_rc = jconf_app.main(argv)
    assert (rc, out) == (want_rc, capsys.readouterr().out)
    assert rc == (0 if case == "match" else 1)
    assert ("CONFORMANCE MATCH: 4 frames" in out) == (case == "match")


def test_conformance_app_needs_both_logs(capsys):
    assert conf_app.main(["--encLog=a.txt"]) == jconf_app.main(["--encLog=a.txt"]) == 1


@pytest.mark.parametrize("level", [30, 60, 105, 12])
def test_check_level_limits_dynamic(level):
    rng = np.random.default_rng(level)
    keys = ("proj_pts", "eom_pts", "raw_pts", "proj_patches", "raw_patches", "eom_patches")
    scale = dict(proj_pts=3_000_000, eom_pts=150_000, raw_pts=150_000, proj_patches=4000,
                 raw_patches=80, eom_patches=60)
    for n, rate in ((40, 30.0), (10, 30.0), (25, 12.5), (6, 1.0)):
        frames = [{k: int(rng.integers(0, scale[k])) for k in keys if rng.random() < 0.8}
                  for _ in range(n)]
        got = conf.check_level_limits_dynamic(level, frames, rate)
        assert got == jconf.check_level_limits_dynamic(level, frames, rate)
    assert conf.check_level_limits_dynamic(30, [dict(proj_pts=2_000_000)] * 40, 30.0)
    assert conf.check_level_limits_dynamic(60, [dict(proj_pts=2_000_000)] * 40, 30.0) == []


def test_parser_on_the_fixture(tmp_path, capsys):
    stream = FIXTURE.read_bytes()
    framed = (len(stream).to_bytes(8, "big") + stream) * 2
    path = tmp_path / "two_gofs.vpcc"
    path.write_bytes(framed)
    argv = [f"--compressedStreamPath={path}"]
    assert parser.main(argv) == 0
    got = capsys.readouterr().out
    assert jparser.main(argv) == 0
    want = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert got.count("hash SEI OK") == 2 and "8 ATLs" in got


def test_parser_needs_a_path(capsys):
    assert parser.main([]) == jparser.main([]) == 1


@pytest.mark.parametrize("codec", ["hevc", "avc"])
def test_parse_annexb(tmp_path, capsys, codec):
    rng = np.random.default_rng(5 if codec == "hevc" else 6)
    parts = []
    for _ in range(40):
        sc = b"\x00\x00\x00\x01" if rng.random() < 0.5 else b"\x00\x00\x01"
        head = int(rng.integers(0, 64)) << 1 if codec == "hevc" else int(rng.integers(0, 32))
        body = rng.integers(1, 256, int(rng.integers(0, 30))).astype(np.uint8).tobytes()
        parts.append(sc + bytes([head & 0xFF, 1]) + body)
    data = b"".join(parts) + b"\x00\x00\x01"
    assert parser.parse_annexb(data, codec) == jparser.parse_annexb(data, codec)
    path = tmp_path / "es.bin"
    path.write_bytes(data)
    argv = [f"--annexBPath={path}", f"--videoType={codec}"]
    assert parser.main(argv) == 0
    got = capsys.readouterr().out
    assert jparser.main(argv) == 0
    assert got == capsys.readouterr().out


def _rgb(seed: int = 3, h: int = 48, w: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _run_both(tmp_path, capsys, mode, inp, ext, extra=()):
    outs = []
    for name, app in (("port", cc), ("jax", jcc)):
        out = str(tmp_path / f"{name}{ext}")
        argv = [mode, str(inp), out, *extra] + (["--device=cpu"] if name == "port" else [])
        assert app.main(argv) == 0
        outs.append(np.load(out))
    capsys.readouterr()
    return outs


@pytest.mark.parametrize("f420,filt", [(0, 0), (1, 0), (1, 1)])
def test_color_converter_rgb2ycc(tmp_path, capsys, f420, filt):
    np.save(tmp_path / "rgb.npy", _rgb())
    extra = [f"--f420={f420}", f"--downsampleFilter={filt}"]
    got, want = _run_both(tmp_path, capsys, "rgb2ycc", tmp_path / "rgb.npy",
                          ".npz" if f420 else ".npy", extra)
    if not f420:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        return
    for k in ("y", "cb", "cr"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("f420,filt", [(0, 0), (1, 0), (1, 1)])
def test_color_converter_ycc2rgb(tmp_path, capsys, f420, filt):
    np.save(tmp_path / "rgb.npy", _rgb(4))
    # the JAX app's own forward output is the input of both backward runs
    fwd = str(tmp_path / ("ycc.npz" if f420 else "ycc.npy"))
    assert jcc.main(["rgb2ycc", str(tmp_path / "rgb.npy"), fwd, f"--f420={f420}",
                     f"--downsampleFilter={filt}"]) == 0
    got, want = _run_both(tmp_path, capsys, "ycc2rgb", fwd, ".npy",
                          [f"--upsampleFilter={filt}"])
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_color_converter_unknown_mode(tmp_path, capsys):
    np.save(tmp_path / "rgb.npy", _rgb())
    argv = ["yuv2xyz", str(tmp_path / "rgb.npy"), str(tmp_path / "o.npy")]
    assert cc.main(argv + ["--device=cpu"]) == jcc.main(argv) == 1


@pytest.mark.parametrize("filt", sorted(set(color.DOWN_FILTERS) | set(color.UP_FILTERS)))
def test_chroma_filter_banks(filt):
    plane = np.random.default_rng(filt).random((26, 38)) * 255
    if filt in color.DOWN_FILTERS:
        np.testing.assert_array_equal(color.downsample_420_filter(plane, filt),
                                      jcolor.downsample_420_filter(plane, filt))
    if filt in color.UP_FILTERS:
        np.testing.assert_array_equal(color.upsample_420_filter(plane, filt),
                                      jcolor.upsample_420_filter(plane, filt))
    assert color.DOWN_FILTERS == jcolor.DOWN_FILTERS and color.UP_FILTERS == jcolor.UP_FILTERS
