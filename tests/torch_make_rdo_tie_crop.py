"""Make the committed RDO tie crop for the PyTorch port's tests.

Not a test: a helper that writes

    vpcc_tpu_torch/data/rdo_tie_crop.npy

a (2, 64, 256) uint8 array: a 64x256 crop of the first D0 geometry plane of
the 8-frame bench GOF at CTC r3 (`make_person_cloud(bits=10,
n_samples=3_000_000)`, seed 7, driven by the committed JAX partitions, so
that its atlas is the JAX encoder's) after the push-pull background fill
(row 0), and the RD weights there (the decoded occupancy, row 1).  The crop
is the top-left 64x256 of the plane's codec tile 12 (rows 512.., columns
512..), which holds CU (1, 6): two of its angular modes (27 and 33) cost
the same unless the RDO's sums follow the reference's XLA order, and the
JAX encoder chooses 33.  The script checks that JAX's `encode_planes`
chooses it on the crop.

Run from the repository root (about a minute on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_rdo_tie_crop.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vpcc_tpu.video import hevc as jh  # noqa: E402
from vpcc_tpu_torch.encoder import Encoder  # noqa: E402
from vpcc_tpu_torch.ops import padding  # noqa: E402
from vpcc_tpu_torch.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu_torch.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu_torch.video import hevc as th  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "rdo_tie_crop.npy"
Y0, X0, H, W = 512, 512, 64, 256
CU = (1, 6)


def main() -> int:
    ref = json.loads((DATA / "person_vox10_front_digests.json").read_text())
    parts = np.load(DATA / "person_vox10_front_partitions.npz")
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    frame = make_person_cloud(bits=10, n_samples=3_000_000, seed=ref["seeds"][0])
    enc = Encoder(cfg, device="cpu")
    seg = Encoder.with_partition(enc.segment_dispatch(frame),
                                 torch.as_tensor(parts["refined_0"].astype(np.int32)))
    fr = enc.encode_frame_front(frame, seg=seg)
    filled = padding.push_pull_round_plain(
        torch.as_tensor(fr.frame.geometry0.astype(np.int32)),
        torch.as_tensor(np.ascontiguousarray(fr.frame.occupancy, np.uint8))).numpy()
    plane = filled[Y0:Y0 + H, X0:X0 + W]
    weight = (np.asarray(fr.occ_rec)[Y0:Y0 + H, X0:X0 + W] != 0).astype(np.int32)
    payload, _ = jh.encode_planes(plane[None], [cfg.geometryQP], [255], deblock=False,
                                  weight=weight)
    mode = int(th.parse_planes32(payload)["m32"][0, CU[0] * (W // 32) + CU[1]])
    if mode != 33:
        raise SystemExit(f"the JAX encoder chose mode {mode} at CU {CU}, not 33")
    np.save(OUT, np.stack([plane, weight]).astype(np.uint8))
    print(f"wrote {OUT.name}: JAX's mode at CU {CU} is {mode}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
