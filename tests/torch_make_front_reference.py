"""Make the committed encoder front-end reference data for the PyTorch port.

Not a test: a helper that runs the JAX package's `Encoder.encode_gof` on the
CPU over the 8 bench frames with the decode fixture's configuration
(`torch_make_smoke_stream.OVERRIDES`, the same encode that made
`person_vox10_r3_gof8.vpcc`) and records, per frame, by wrapping the
encoder's functions in this process (no file is edited):

* the voxel count, md5 of the segmentation k-NN's idx and d2 (valid rows);
* the initial and refined voxel partitions (into the .npz);
* md5 of the first patch round's connected-component labels;
* the patch count, md5 of the patch fields (`patches_md5`) and the
  placements (u0, v0, size_u0, size_v0, orientation, u1, v1, d1, view_id);
* width, height, md5 of the atlas occupancy, geometry0 and geometry1, of
  the occupancy video and of the block-to-patch map.

It writes

    vpcc_tpu_torch/data/person_vox10_front_digests.json
    vpcc_tpu_torch/data/person_vox10_front_partitions.npz

`chip_smoke.py` and tests/test_torch_patchgen.py hold the port against them.
Run from the repository root (several minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/torch_make_front_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_make_smoke_stream import OVERRIDES, SEEDS  # noqa: E402
from vpcc_tpu import encoder as enc_mod  # noqa: E402
from vpcc_tpu.core import atlas as jatlas  # noqa: E402
from vpcc_tpu.ops import cc as jcc, neighbors as jnb, voxelize as jvox  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu_torch.utils.checksum import array_md5, patches_md5  # noqa: E402

OUT_DIR = ROOT / "vpcc_tpu_torch" / "data"
DIGESTS = OUT_DIR / "person_vox10_front_digests.json"
PARTITIONS = OUT_DIR / "person_vox10_front_partitions.npz"


def placements(patches):
    return [[int(p.u0), int(p.v0), int(p.size_u0), int(p.size_v0), int(p.orientation),
             int(p.u1), int(p.v1), int(p.d1), int(p.view_id)] for p in patches]


def concrete(*xs) -> bool:
    return not any(isinstance(x, jax.core.Tracer) for x in xs)


class Recorder:
    """Wraps the JAX encoder's functions and keeps what each frame made."""

    def __init__(self):
        self.seg = []      # per dispatched frame
        self.front = []    # per encoded frame
        self.parts = {}
        self._seg = None
        self._front = None
        self._saved = []

    def __enter__(self):
        E = enc_mod.Encoder
        orig_dispatch, orig_frame = E.segment_dispatch, E.encode_frame
        orig_vox, orig_knn = jvox.voxelize, jnb.knn
        orig_init = enc_mod.initial_segmentation
        orig_cc = jcc.cc_labels_device
        orig_raster, orig_down = jatlas.rasterize_frame, jatlas.downsample_occupancy
        orig_btp = jatlas.derive_block_to_patch
        rec = self

        def segment_dispatch(self_, pc):
            rec._seg = {}
            out = orig_dispatch(self_, pc)
            fi = len(rec.seg)
            nv = rec._seg["voxels"]
            rec.parts[f"refined_{fi}"] = np.asarray(out[1])[:nv].astype(np.uint8)
            rec.parts[f"initial_{fi}"] = rec._seg.pop("initial")
            rec.seg.append(rec._seg)
            rec._seg = None
            return out

        def voxelize(positions, shift, bits):
            out = orig_vox(positions, shift, bits)
            if rec._seg is not None and concrete(out[2]):
                rec._seg["voxels"] = int(out[2])
            return out

        def knn(grid, positions, queries, k, **kw):
            idx, d2 = orig_knn(grid, positions, queries, k, **kw)
            if rec._seg is not None and "knn_idx_md5" not in rec._seg:
                nv = rec._seg["voxels"]
                rec._seg["knn_idx_md5"] = array_md5(np.asarray(idx)[:nv], "<i4")
                rec._seg["knn_d2_md5"] = array_md5(np.asarray(d2)[:nv], "<i4")
            return idx, d2

        def initial_segmentation(*a):
            part = orig_init(*a)
            rec._seg["initial"] = np.asarray(part)[: rec._seg["voxels"]].astype(np.uint8)
            return part

        def encode_frame(self_, *a, **kw):
            rec._front = {}
            out = orig_frame(self_, *a, **kw)
            rec.front.append(rec._front)
            rec._front = None
            return out

        def cc_labels_device(*a):
            lab = orig_cc(*a)
            if rec._front is not None and concrete(lab) and "cc0_md5" not in rec._front:
                nv = rec.seg[len(rec.front)]["voxels"]
                rec._front["cc0_md5"] = array_md5(np.asarray(lab)[:nv], "<i4")
            return lab

        def rasterize_frame(patches, width, height, cfg):
            fr = orig_raster(patches, width, height, cfg)
            rec._front.update(
                patches=len(patches), patches_md5=patches_md5(patches),
                width=int(width), height=int(height),
                occupancy_md5=array_md5(fr.occupancy, np.uint8),
                geometry0_md5=array_md5(fr.geometry0, "<u2"),
                geometry1_md5=array_md5(fr.geometry1, "<u2"),
                placements=placements(patches),
            )
            return fr

        def downsample_occupancy(occ, precision, threshold=0):
            ov = orig_down(occ, precision, threshold=threshold)
            if rec._front is not None and "occ_video_md5" not in rec._front:
                rec._front["occ_video_md5"] = array_md5(ov, np.uint8)
            return ov

        def derive_block_to_patch(occ, patches, width, height, res):
            btp = orig_btp(occ, patches, width, height, res)
            # the encoder's own call comes after the occupancy video
            if (rec._front is not None and "occ_video_md5" in rec._front
                    and "block_to_patch_md5" not in rec._front):
                rec._front["block_to_patch_md5"] = array_md5(btp, "<i4")
            return btp

        for obj, name, fn in (
            (E, "segment_dispatch", segment_dispatch), (E, "encode_frame", encode_frame),
            (jvox, "voxelize", voxelize), (jnb, "knn", knn),
            (enc_mod, "initial_segmentation", initial_segmentation),
            (jcc, "cc_labels_device", cc_labels_device),
            (jatlas, "rasterize_frame", rasterize_frame),
            (jatlas, "downsample_occupancy", downsample_occupancy),
            (jatlas, "derive_block_to_patch", derive_block_to_patch),
        ):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []


def main() -> int:
    cfg = VPCCConfig()
    for k, v in OVERRIDES.items():
        setattr(cfg, k, v)
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in SEEDS]
    t0 = time.perf_counter()
    with Recorder() as rec:
        enc_mod.Encoder(cfg).encode_gof(frames)
    dt = time.perf_counter() - t0
    parent, _ = enc_mod.Encoder(cfg).gof_structure(len(frames))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PARTITIONS, **rec.parts)
    DIGESTS.write_text(json.dumps({
        "seeds": SEEDS,
        "overrides": OVERRIDES,
        "source_points": [f.point_count for f in frames],
        "parents": parent,
        "encoder": "vpcc_tpu.Encoder(cfg).encode_gof on the CPU",
        "frames": [dict(**s, **f) for s, f in zip(rec.seg, rec.front)],
    }, indent=1) + "\n")
    print(f"recorded {len(rec.front)} frames in {dt:.1f}s; patches "
          f"{[f['patches'] for f in rec.front]}; voxels {[s['voxels'] for s in rec.seg]}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main())
