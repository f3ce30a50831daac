"""The port's RD gate on the card: the r3 encode of the 8-frame bench GOF
against the JAX encoder's.

Needs an NVIDIA GPU and nvcc; skips without CUDA.  It imports neither JAX
nor vpcc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_rd_gate_cuda.py -q

The bench frames (`make_person_cloud(bits=10, n_samples=3_000_000)`, seeds
7..14) go through `Encoder(cfg, device="cuda").encode_gof` at the CTC r3
QPs, driven by the JAX encoder's refined partitions
(person_vox10_front_partitions.npz), so the atlas is the reference's; the
stream bytes and the mean D1/D2/Y PSNRs (`compute_metrics` with the
sources' estimated normals, as bench.py measures) must lie within
chip_smoke.py's RD_BYTES_TOL / RD_PSNR_TOL_DB of the JAX encoder's
(person_vox10_rd_reference.json, tests/torch_make_rd_reference.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import RD_BYTES_TOL, RD_PSNR_TOL_DB

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent.parent / "vpcc_tpu_torch" / "data"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_r3_rd_gate(cuda):
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import metrics
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    front = json.loads((DATA / "person_vox10_front_digests.json").read_text())
    ref = json.loads((DATA / "person_vox10_rd_reference.json").read_text())
    parts = np.load(DATA / "person_vox10_front_partitions.npz")
    cfg = VPCCConfig()
    for k, v in front["overrides"].items():
        setattr(cfg, k, v)
    cfg.geometryQP, cfg.attributeQP = ref["rate_qps"]["r3"]
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in front["seeds"]]
    enc = Encoder(cfg, device=cuda)
    segs = [Encoder.with_partition(enc.segment_dispatch(f), torch.as_tensor(
        parts[f"refined_{i}"].astype(np.int32))) for i, f in enumerate(frames)]
    stream, recon = enc.encode_gof(frames, segs=segs)
    got = []
    for f, r in zip(frames, recon):
        p = torch.as_tensor(np.asarray(f.positions, np.int32), device=cuda)
        c = torch.as_tensor(f.colors, device=cuda)
        nrm = metrics.estimate_normals(p, 10, device=cuda)
        got.append(metrics.compute_metrics(p, c, r.positions, r.colors, resolution=1023,
                                           src_normals=nrm, grid_bits=10, device=cuda))
    jr = ref["rates"]["r3"]
    d_bytes = len(stream) / jr["stream_bytes"] - 1.0
    mean = {"d1_db": np.mean([m.c2c_psnr for m in got]),
            "d2_db": np.mean([m.c2p_psnr for m in got]),
            "y_db": np.mean([m.color_psnr[0] for m in got])}
    deltas = {k: float(mean[k] - jr["mean"][k]) for k in mean}
    assert abs(d_bytes) <= RD_BYTES_TOL, (len(stream), jr["stream_bytes"])
    assert all(np.isfinite(v) and abs(v) <= RD_PSNR_TOL_DB for v in deltas.values()), deltas
