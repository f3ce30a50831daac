"""PyTorch port vs JAX reference: the decoder as a whole, its isolation from
JAX, its device policy, and the committed vox10 fixture.

The port runs with device="cpu" (plain PyTorch versions of the kernels) and
must give the JAX decoder's positions and colors exactly, in order.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vpcc_tpu.decoder import Decoder as JaxDecoder
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.utils.config import VPCCConfig as JCfg
from vpcc_tpu.utils.synthetic import make_sphere_cloud, make_torus_cloud
from vpcc_tpu_torch import carry
from vpcc_tpu_torch.bitstream import v3c
from vpcc_tpu_torch.bitstream.bitio import BitReader
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.utils.config import VPCCConfig

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "vpcc_tpu_torch" / "data" / "person_vox10_r3_gof8.vpcc"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(**kw):
    cfg = JCfg()
    cfg.geometry3dCoordinatesBitdepth = 7
    cfg.minimumImageWidth = 128
    cfg.minimumImageHeight = 128
    cfg.resolution = 127
    cfg.iterationCountRefineSegmentation = 10
    cfg.geometryQP = 22
    cfg.attributeQP = 30
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def assert_same_clouds(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.point_count == b.point_count > 0
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(b.colors, a.colors)


@pytest.mark.parametrize("make,dup", [(make_sphere_cloud, 1), (make_torus_cloud, 0)])
def test_single_frame_stream_matches_reference(make, dup):
    """1-frame stream, lossy wavefront video: identical points in order,
    with and without duplicate removal."""
    src = make(bits=7, n_samples=25000)
    stream, _ = Encoder(small_cfg()).encode_gof([src])
    args = [f"--removeDuplicatePoints={dup}"]
    ref = JaxDecoder(JCfg.from_args(args)).decode(stream)
    got = Decoder(VPCCConfig.from_args(args), device="cpu").decode(stream)
    assert_same_clouds(ref, got)


def test_fixture_stream_parses():
    """The committed vox10 fixture: 8 frames, hierarchical P-tiles, every
    atlas hash SEI verified by the port's V3C reader."""
    units = v3c.read_sample_stream(FIXTURE.read_bytes())
    vps = next(v3c.V3CParameterSet.read(BitReader(p)) for t, p in units if t == v3c.V3C_VPS)
    ad = next(p for t, p in units if t == v3c.V3C_AD)
    asps, _, tiles, hash_ok, seis = v3c.read_atlas_substream(ad)
    assert vps.frame_count == 8 and len(tiles) == 8
    assert vps.geometry_3d_bitdepth == 10 and vps.occupancy_precision == 2
    assert all(hash_ok) and len(hash_ok) == 8
    assert [t.tile_type for t in tiles] == [v3c.TILE_I] + [v3c.TILE_P] * 7
    assert v3c.SEI_GEOMETRY_SMOOTHING in seis
    digests = json.loads(FIXTURE.with_name(FIXTURE.stem + "_digests.json").read_text())
    assert len(digests["frames"]) == 8


def test_port_imports_no_jax():
    """The package, its decoder, its encoder, the metrics, the synthetic
    clouds and its CLIs import neither JAX nor vpcc_tpu."""
    code = (
        "import sys, vpcc_tpu_torch, vpcc_tpu_torch.decoder, "
        "vpcc_tpu_torch.apps.decode, vpcc_tpu_torch.carry, "
        "vpcc_tpu_torch.encoder, vpcc_tpu_torch.core.packing, "
        "vpcc_tpu_torch.utils.synthetic, vpcc_tpu_torch.ops.metrics, "
        "vpcc_tpu_torch.apps.encode, vpcc_tpu_torch.apps.metrics, "
        "vpcc_tpu_torch.apps.normal_generator, vpcc_tpu_torch.apps.bench, "
        "vpcc_tpu_torch.apps.video_codec, vpcc_tpu_torch.parallel.gof\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'vpcc_tpu' or m.startswith('vpcc_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_decoder_without_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Decoder() selects it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        carry.refs_from_numpy(np.zeros((4, 4), np.int32))
    assert Decoder(device="cpu").device == torch.device("cpu")


def test_config_from_dict_round_trip():
    j = JCfg.from_args(["--gridSize=4", "--thresholdSmoothing=16", "--foo=1"])
    cfg = carry.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j)
    with pytest.raises(KeyError):
        carry.config_from_dict({"noSuchOption": 1})


@pytest.mark.parametrize("seed", [0, 1])
def test_first_unique_rows_matches_remove_duplicates(seed):
    """Device duplicate removal keeps exactly the rows numpy's
    `PointCloudData.remove_duplicates` keeps (first instance, in order)."""
    from vpcc_tpu.utils.ply import PointCloudData as JPC
    from vpcc_tpu_torch.pipeline import first_unique_rows

    rng = np.random.default_rng(seed)
    pos = rng.integers(-3, 6, (5000, 3)).astype(np.int32)
    col = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    ref = JPC(pos, col).remove_duplicates()
    keep = first_unique_rows(torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(pos[keep], ref.positions)
    np.testing.assert_array_equal(col[keep], ref.colors)


def test_decode_cli_matches_reference_cli(tmp_path):
    """`python -m vpcc_tpu_torch.apps.decode --device=cpu` writes the same
    PLY frames and conformance log as the JAX package's decode app, on a
    stream in the encode app's container (8-byte size per GOF)."""
    from vpcc_tpu.apps import decode as jcli
    from vpcc_tpu_torch.apps import decode as tcli

    stream, _ = Encoder(small_cfg()).encode_gof([make_sphere_cloud(bits=7, n_samples=15000)])
    path = tmp_path / "s.vpcc"
    path.write_bytes(len(stream).to_bytes(8, "big") + stream)
    for name, cli, extra in (("j", jcli, []), ("t", tcli, ["--device=cpu"])):
        assert cli.main([f"--compressedStreamPath={path}",
                         f"--reconstructedDataPath={tmp_path}/{name}_%04d.ply"] + extra) == 0
        (tmp_path / f"{name}.log").write_bytes(
            (tmp_path / "s.vpcc_dec_pcframe_log.txt").read_bytes())
    # identical PLY bodies (the header comments name the writing package)
    body = lambda n: (tmp_path / f"{n}_0000.ply").read_bytes().split(b"end_header")[1]
    assert body("t") == body("j") and len(body("t")) > 10000
    assert (tmp_path / "t.log").read_bytes() == (tmp_path / "j.log").read_bytes()
