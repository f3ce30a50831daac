"""PyTorch port vs JAX reference: the producer's apps on 11-bit geometry.

`apps/encode`, `apps/decode` and `apps/metrics` run with
--geometry3dCoordinatesBitdepth=11 --resolution=2047 and no other new
flag, on a 6-bit synthetic person moved into the 11-bit range (+1200), in
pytest's tmp_path; the port runs on the CPU (plain kernel versions).
"""

import re

import numpy as np
import pytest
import torch

from test_torch_vox11 import METRICS_PSNR_TOL_DB, SHIFT
from vpcc_tpu.apps import encode as j_encode, metrics as j_metrics
from vpcc_tpu.utils import ply as jply
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu.utils.synthetic import make_person_cloud
from vpcc_tpu_torch.apps import decode as t_decode, encode as t_encode
from vpcc_tpu_torch.apps import metrics as t_metrics
from vpcc_tpu_torch.utils import ply as tply


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vox11_apps_match_reference(tmp_path, capsys):
    """The producer's apps at --geometry3dCoordinatesBitdepth=11
    --resolution=2047 (no other flag): the port's encode app writes the
    JAX app's stream byte for byte, its decode app decodes it to the
    encoder's reconstruction, and its metrics app prints the JAX app's
    D1/D2/Y/U/V lines within METRICS_PSNR_TOL_DB."""
    base = make_person_cloud(bits=6, n_samples=20000, seed=7)
    jply.write_ply(tmp_path / "src_0000.ply",
                   PointCloudData(base.positions.astype(np.int32) + SHIFT, base.colors))
    common = ["--frameCount=1", "--geometry3dCoordinatesBitdepth=11", "--resolution=2047"]
    enc_args = lambda out: [f"--uncompressedDataPath={tmp_path}/src_%04d.ply", *common,
                            "--minimumImageWidth=64", "--minimumImageHeight=64",
                            "--gridBasedSegmentation=1", "--occupancyPrecision=2",
                            "--iterationCountRefineSegmentation=10",
                            f"--compressedStreamPath={out}/out.vpcc",
                            f"--reconstructedDataPath={out}/rec_%04d.ply"]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    assert j_encode.main(enc_args(tmp_path / "jax")) == 0
    assert t_encode.main(enc_args(tmp_path / "port") + ["--device=cpu"]) == 0
    stream = (tmp_path / "port" / "out.vpcc").read_bytes()
    assert stream == (tmp_path / "jax" / "out.vpcc").read_bytes()
    assert t_decode.main([f"--compressedStreamPath={tmp_path}/port/out.vpcc",
                          f"--reconstructedDataPath={tmp_path}/port/dec_%04d.ply",
                          "--device=cpu"]) == 0
    a = tply.read_ply(tmp_path / "port" / "dec_0000.ply")
    b = tply.read_ply(tmp_path / "port" / "rec_0000.ply")
    assert a.positions.max() > 1200
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.colors, b.colors)
    args = [f"--uncompressedDataPath={tmp_path}/src_%04d.ply",
            f"--reconstructedDataPath={tmp_path}/port/rec_%04d.ply", *common]
    capsys.readouterr()
    assert j_metrics.main(args) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame")]
    assert t_metrics.main(args + ["--device=cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame")]
    num = lambda ln: [float(x) for x in re.findall(r"-?\d+\.\d+|inf", ln)]
    assert len(got) == len(want) == 1
    assert np.allclose(num(got[0]), num(want[0]), rtol=0, atol=METRICS_PSNR_TOL_DB), (got, want)
