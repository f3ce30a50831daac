"""PyTorch port vs JAX reference: the producer's entry points
(`apps/encode`, `apps/metrics`, `apps/normal_generator`) and `read_ply`.

A 2-frame 6-bit person GOF (one frame per GOF, so that a run can stop
after GOF 1) in pytest's tmp_path; every option is an argument.  Checked:
* the port's `apps.encode.main([..., "--device=cpu"])` writes the JAX
  app's stream file, resume sidecar and conformance log byte for byte, and
  prints the same substream and metrics lines (the metrics within
  PSNR_ATOL_DB at their printed precision);
* a run cut after GOF 1 (a truncated tail, or a sidecar one GOF behind the
  stream) and resumed with --resumeEncoding=1 writes the same bytes;
* the port's `apps.metrics` (with and without --normalDataPath, with
  reflectances) and `apps.normal_generator` print the JAX apps' lines
  within PSNR_ATOL_DB, and the normals agree to NORMAL_ATOL;
* `read_ply` reads both packages' PLYs (binary and ascii) identically;
* under the CTC's lossless flags (raw points, EOM, the separate RAW/EOM
  video, lossless QPs) on a 7-bit cloud, the port's `apps.encode` writes
  the JAX app's stream and `apps.decode --device=cpu` gives the source
  back bit for bit.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from vpcc_tpu.apps import encode as j_encode, metrics as j_metrics
from vpcc_tpu.apps import normal_generator as j_normals
from vpcc_tpu.utils import ply as jply
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch.apps import decode as t_decode, encode as t_encode, metrics as t_metrics
from vpcc_tpu_torch.apps import normal_generator as t_normals
from vpcc_tpu_torch.utils import ply as tply

PSNR_ATOL_DB = 1e-4   # one unit of the printed precision
NORMAL_ATOL = 1e-5
OUTPUTS = ("out.vpcc", "out.vpcc.resume.json", "out.vpcc_enc_pcframe_log.txt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|inf", line)]


def _same_lines(got, want, prefixes=("frame", "mean")):
    """Lines starting with `prefixes` agree: the same words, every number
    within PSNR_ATOL_DB."""
    g = [ln for ln in got if ln.startswith(prefixes)]
    w = [ln for ln in want if ln.startswith(prefixes)]
    assert len(g) == len(w) and g, (got, want)
    for a, b in zip(g, w):
        assert re.sub(r"-?\d+\.\d+", "#", a) == re.sub(r"-?\d+\.\d+", "#", b), (a, b)
        assert np.allclose(_numbers(a), _numbers(b), rtol=0, atol=PSNR_ATOL_DB), (a, b)


def _encode_args(d, out_dir):
    return [f"--uncompressedDataPath={d}/src_%04d.ply", "--frameCount=2",
            "--groupOfFramesSize=1", "--geometry3dCoordinatesBitdepth=6", "--resolution=63",
            "--minimumImageWidth=64", "--minimumImageHeight=64", "--gridBasedSegmentation=1",
            "--occupancyPrecision=2", "--iterationCountRefineSegmentation=10",
            f"--compressedStreamPath={out_dir}/out.vpcc",
            f"--reconstructedDataPath={out_dir}/rec_%04d.ply"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The source PLYs and one run of each package's encode app; returns
    the directory and each run's stdout."""
    d = tmp_path_factory.mktemp("apps")
    for i, seed in enumerate((7, 8)):
        jply.write_ply(d / f"src_{i:04d}.ply", make_person_cloud(bits=6, n_samples=20000, seed=seed))
    out = {}
    for name, main, extra in (("jax", j_encode.main, []), ("port", t_encode.main, ["--device=cpu"])):
        (d / name).mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(_encode_args(d, d / name) + extra) == 0
        out[name] = buf.getvalue().splitlines()
    return d, out


def test_encode_app_matches_jax(runs):
    d, out = runs
    for f in OUTPUTS:
        assert (d / "port" / f).read_bytes() == (d / "jax" / f).read_bytes(), f
    for i in range(2):
        a = tply.read_ply(d / "port" / f"rec_{i:04d}.ply")
        b = jply.read_ply(d / "jax" / f"rec_{i:04d}.ply")
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.colors, b.colors)
    _same_lines(out["port"], out["jax"], ("frame", "substream"))
    assert out["port"][-1].startswith("encoded 2 frames") and "on cpu" in out["port"][-1]


@pytest.mark.parametrize("cut", ["truncated_tail", "sidecar_behind"])
def test_encode_app_resume(runs, tmp_path, capsys, cut):
    """GOF 1 on disk, GOF 2 cut: either its bytes are half written, or
    they are whole but the sidecar (written after the stream) still
    describes GOF 1 only and the resume rewinds to frame 1."""
    d, _ = runs
    full = (d / "port" / "out.vpcc").read_bytes()
    size1 = int.from_bytes(full[:8], "big")
    meta = json.loads((d / "port" / "out.vpcc.resume.json").read_text())
    meta["conf_log"] = meta["conf_log"][:1]
    stream = full[: 8 + size1 + 20] if cut == "truncated_tail" else full
    (tmp_path / "out.vpcc").write_bytes(stream)
    (tmp_path / "out.vpcc.resume.json").write_text(json.dumps(meta))
    capsys.readouterr()
    assert t_encode.main(_encode_args(d, tmp_path) + ["--resumeEncoding=1", "--device=cpu"]) == 0
    cap = capsys.readouterr()
    assert "resuming after 1 frames" in cap.out
    assert ("rewinding resume point to frame 1" in cap.err) == (cut == "sidecar_behind")
    for f in OUTPUTS:
        assert (tmp_path / f).read_bytes() == (d / "jax" / f).read_bytes(), f


def test_normal_generator_and_metrics_apps(runs, tmp_path, capsys):
    d, _ = runs
    src = f"--uncompressedDataPath={d}/src_%04d.ply"
    common = ["--frameCount=2", "--geometry3dCoordinatesBitdepth=6", "--resolution=63"]
    lines = {}
    for name, main, extra in (("jax", j_normals.main, []),
                              ("port", t_normals.main, ["--device=cpu"])):
        (tmp_path / name).mkdir()
        lines[name] = _run(main, [src, f"--normalDataPath={tmp_path}/{name}/nrm_%04d.ply",
                                  "--nnNormalEstimation=16", *common, *extra], capsys)
    assert [ln.split("->")[0] for ln in lines["port"]] == [ln.split("->")[0] for ln in lines["jax"]]
    for i in range(2):
        a = tply.read_ply(tmp_path / "port" / f"nrm_{i:04d}.ply")
        b = jply.read_ply(tmp_path / "jax" / f"nrm_{i:04d}.ply")
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.colors, b.colors)
        assert np.abs(a.normals - b.normals).max() <= NORMAL_ATOL

    # reflectances on both clouds exercise the R column
    rng = np.random.default_rng(4)
    for i in range(2):
        for kind, path in (("src", d / f"src_{i:04d}.ply"), ("rec", d / "jax" / f"rec_{i:04d}.ply")):
            pc = jply.read_ply(path)
            pc.reflectances = rng.integers(0, 65536, pc.point_count).astype(np.uint16)
            jply.write_ply(tmp_path / f"{kind}r_{i:04d}.ply", pc)
    cases = {
        "estimated normals": [src, f"--reconstructedDataPath={d}/jax/rec_%04d.ply"],
        "given normals": [src, f"--reconstructedDataPath={d}/jax/rec_%04d.ply",
                          f"--normalDataPath={tmp_path}/jax/nrm_%04d.ply"],
        "reflectance": [f"--uncompressedDataPath={tmp_path}/srcr_%04d.ply",
                        f"--reconstructedDataPath={tmp_path}/recr_%04d.ply"],
    }
    for case, args in cases.items():
        want = _run(j_metrics.main, args + common, capsys)
        got = _run(t_metrics.main, args + common + ["--device=cpu"], capsys)
        _same_lines(got, want)
        assert len(got) == 3 and (" R " in got[0]) == (case == "reflectance"), (case, got)


def test_read_ply_both_packages(tmp_path):
    rng = np.random.default_rng(6)
    n = 500
    pc = jply.PointCloudData(rng.integers(0, 1024, (n, 3)), rng.integers(0, 256, (n, 3)),
                             rng.standard_normal((n, 3)).astype(np.float32),
                             rng.integers(0, 65536, n))
    jply.write_ply(tmp_path / "bin.ply", pc)
    jply.write_ply(tmp_path / "ascii.ply", pc, ascii_format=True)
    tply.write_ply(tmp_path / "port.ply", tply.PointCloudData(
        pc.positions, pc.colors, pc.normals, pc.reflectances))
    for name in ("bin.ply", "ascii.ply", "port.ply"):
        a, b = tply.read_ply(tmp_path / name), jply.read_ply(tmp_path / name)
        for field in ("positions", "colors", "normals", "reflectances"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=name)
            assert getattr(a, field).dtype == getattr(b, field).dtype, (name, field)
            if name != "ascii.ply":  # ascii keeps 6 significant digits of a normal
                np.testing.assert_array_equal(getattr(a, field), getattr(pc, field), err_msg=name)


LOSSLESS_FLAGS = ["--geometryQP=-12", "--attributeQP=0", "--occupancyPrecision=1",
                  "--rawPointsPatch=1", "--maxAllowedDist2RawPointsSelection=0",
                  "--enhancedOccupancyMapCode=1", "--useRawPointsSeparateVideo=1",
                  "--flagGeometrySmoothing=0", "--gridSmoothing=0", "--flagColorPreSmoothing=0"]


def test_lossless_encode_decode_apps(tmp_path, capsys):
    src = make_person_cloud(bits=7, n_samples=12000, seed=3)
    jply.write_ply(tmp_path / "src_0000.ply", src)
    common = [f"--uncompressedDataPath={tmp_path}/src_%04d.ply", "--frameCount=1",
              "--geometry3dCoordinatesBitdepth=7", "--resolution=127",
              "--minimumImageWidth=128", "--minimumImageHeight=128",
              "--iterationCountRefineSegmentation=10", *LOSSLESS_FLAGS]
    for name, main, extra in (("jax", j_encode.main, []), ("port", t_encode.main, ["--device=cpu"])):
        (tmp_path / name).mkdir()
        _run(main, common + [f"--compressedStreamPath={tmp_path}/{name}/out.vpcc"] + extra, capsys)
    assert (tmp_path / "port" / "out.vpcc").read_bytes() == (tmp_path / "jax" / "out.vpcc").read_bytes()
    out = _run(t_decode.main, [f"--compressedStreamPath={tmp_path}/port/out.vpcc",
                               f"--reconstructedDataPath={tmp_path}/dec_%04d.ply", "--device=cpu"],
               capsys)
    assert out[-1].startswith("decoded 1 frames")
    dec = tply.read_ply(tmp_path / "dec_0000.ply")
    ks = np.lexsort(src.positions.astype(np.int64).T)
    kd = np.lexsort(dec.positions.astype(np.int64).T)
    assert dec.point_count == src.point_count
    np.testing.assert_array_equal(dec.positions[kd], src.positions.astype(dec.positions.dtype)[ks])
    np.testing.assert_array_equal(dec.colors[kd], src.colors[ks])
