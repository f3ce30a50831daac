"""PyTorch port vs JAX reference: the CTC's lossless conditions (raw-points
patch, lossless video, RAW aux substreams).

On the CPU, from numpy seeds:
* `lossless.encode_plane` (uint8 / uint16, one or three channels) and the
  aux packers (`pack_raw_geometry`, `pack_aux_attribute`) give the
  reference's bytes, and the port's unpackers read them back as the
  reference's do;
* the lossless geometry fill (push-pull, kernel L's plain version, rounded
  half to even) equals the reference's `intra.fill_plane_host`;
* `Encoder.encode_gof(device="cpu")`, driven by the JAX encoder's
  partitions, writes the JAX encoder's stream byte for byte under the
  lossless condition of tests/test_e2e.py:118 (raw points in the atlas
  tile) and under the same with EOM and the separate RAW/EOM video (the
  configuration chip_smoke.py runs at full size); the port's decoder
  decodes the JAX stream to the JAX decoder's output, and that equals the
  source cloud bit for bit (positions and colors, sorted).
All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from vpcc_tpu.video import aux_video as jaux
from vpcc_tpu.video import intra as jintra
from vpcc_tpu.video import lossless as jlossless
from vpcc_tpu_torch.ops import padding as tpadding
from vpcc_tpu_torch.video import aux_video as taux
from vpcc_tpu_torch.video import lossless as tlossless

from test_torch_eom import encode_both

LOSSLESS = dict(rawPointsPatch=1, occupancyPrecision=1, geometryQP=-12, attributeQP=0,
                flagGeometrySmoothing=0, gridSmoothing=0,
                maxAllowedDist2RawPointsSelection=0.0)
CASES = {
    "raw_in_tile": LOSSLESS,                                      # tests/test_e2e.py:118
    "raw_eom_aux": dict(LOSSLESS, enhancedOccupancyMapCode=1, useRawPointsSeparateVideo=1,
                        flagColorPreSmoothing=0),                 # + :483
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernel versions run many small tensor ops; with several
    test workers on the machine, intra-op threads only contend, so this
    module runs them on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,dtype", [((48, 64), np.uint16), ((40, 64, 3), np.uint8),
                                         ((33, 17), np.uint8)])
def test_encode_plane_bytes(shape, dtype):
    rng = np.random.default_rng(len(shape))
    plane = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    plane[: shape[0] // 2] //= 7   # a smoother half: a compressible plane
    got = tlossless.encode_plane(plane)
    assert got == jlossless.encode_plane(plane)
    np.testing.assert_array_equal(tlossless.decode_plane(got), plane)


@pytest.mark.parametrize("n_raw,n_eom", [(0, 0), (1, 0), (130, 0), (0, 70), (130, 70)])
def test_aux_packers_bytes(n_raw, n_eom):
    rng = np.random.default_rng(n_raw + n_eom)
    pos = rng.integers(0, 1024, (n_raw, 3)).astype(np.int32) if n_raw else None
    rcol = rng.integers(0, 256, (n_raw, 3)).astype(np.uint8) if n_raw else None
    ecol = rng.integers(0, 256, (n_eom, 3)).astype(np.uint8) if n_eom else None
    geo = taux.pack_raw_geometry(pos)
    attr = taux.pack_aux_attribute(rcol, ecol)
    assert geo == jaux.pack_raw_geometry(pos)
    assert attr == jaux.pack_aux_attribute(rcol, ecol)
    for a, b in ((taux.unpack_raw_geometry(geo), jaux.unpack_raw_geometry(geo)),
                 *zip(taux.unpack_aux_attribute(attr), jaux.unpack_aux_attribute(attr))):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_lossless_geometry_fill():
    rng = np.random.default_rng(9)
    geo = rng.integers(0, 256, (64, 96)).astype(np.uint16)
    occ = (rng.random((64, 96)) < 0.3).astype(np.uint8)
    want = jintra.fill_plane_host(geo, occ)
    got = tpadding.push_pull_round(torch.as_tensor(geo.astype(np.int32)), torch.as_tensor(occ))
    np.testing.assert_array_equal(got.numpy().astype(np.uint16), want)


@pytest.mark.parametrize("case", list(CASES))
def test_encode_gof_lossless_bit_exact(case):
    src, jenc, jstream, enc, stream, recon = encode_both(7, 12000, CASES[case])
    e = enc.last_encoded[0]
    assert e.raw_positions is not None and len(e.raw_positions) > 50
    if case == "raw_eom_aux":
        assert e.eom_colors is not None and len(e.eom_colors) > 100
    assert enc.last_stream_stats == jenc.last_stream_stats
    assert stream == jstream
    from vpcc_tpu.decoder import Decoder as JDecoder
    from vpcc_tpu_torch.decoder import Decoder

    want = JDecoder().decode(jstream)[0]
    got = Decoder(device="cpu").decode(jstream)[0]
    for a in (got, recon[0]):
        np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(want.positions))
        np.testing.assert_array_equal(np.asarray(a.colors), np.asarray(want.colors))
    sort = lambda p: np.lexsort(np.asarray(p, np.int64).T)
    ks, kd = sort(src.positions), sort(got.positions)
    assert got.point_count == src.point_count
    np.testing.assert_array_equal(np.asarray(got.positions, np.int32)[kd],
                                  np.asarray(src.positions, np.int32)[ks])
    np.testing.assert_array_equal(np.asarray(got.colors)[kd], np.asarray(src.colors)[ks])
