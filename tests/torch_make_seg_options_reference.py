"""Make the committed segmentation-options reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over the first two
bench frames (`make_person_cloud(bits=10, n_samples=3_000_000)`, seeds 7
and 8) as one GOF under six configurations, each the bench's r3 overrides
plus:

* "orient0", "orient2", "orient4": normalOrientation 0 (PCA normals
  unoriented), 2 (toward the viewpoint, the default (0, 0, 0)) and 4 (the
  spanning-tree flood);
* "hgs": highGradientSeparation=1;
* "roi": enablePointCloudPartitioning=1 with one cut along each of the two
  longest axes and rawPointsPatch=1 (the settings of
  tests/test_e2e.py::test_point_cloud_partitioning_roi);
* "tetris": packingStrategy=2 (matched patches of frame 1 keep their
  frame-0 place where the skyline allows).

It writes

    vpcc_tpu_torch/data/person_vox10_seg_options_partitions.npz
    vpcc_tpu_torch/data/person_vox10_seg_options_reference.json

The npz holds the JAX encoder's refined voxel partitions of each frame for
orient0/2/4 (`orient0_0`, ...), the voxel `alt` (int8) and `weak` (bool) of
`high_gradient_aux` for hgs (`hgs_alt_0`, `hgs_weak_0`, ...) and, for roi,
each chunk's refined voxel partitions in the order the encoder segments
them (`roi_<frame>_<chunk>`).  Partitions and `alt` are int8.

The JSON holds, per configuration: the overrides, the stream's md5, length
and bytes per substream, `last_stream_stats`, per frame the patch count,
the digests of the encoder's reconstruction and of the JAX decoder's
output, the mean D1/D2/Y PSNRs of the reconstruction (`compute_metrics`
with the source's `estimate_normals`, as tests/torch_make_rd_reference.py
measures), and the JAX-CPU wall seconds of the encode and the decode; for
hgs the separation's `n_moved` per patch round; for roi each chunk's point
count.  It checks that hgs and tetris segment both frames into the
partitions committed in person_vox10_front_partitions.npz (which drive
the port there).

Run from the repository root (about 8 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_seg_options_reference.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from torch_make_lossless_reference import unit_bytes  # noqa: E402
from torch_make_smoke_stream import OVERRIDES as R3_OVERRIDES, frame_digest  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.ops import metrics, segmentation, separation  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox10_seg_options_reference.json"
OUT_NPZ = DATA / "person_vox10_seg_options_partitions.npz"
FRONT_PARTITIONS = DATA / "person_vox10_front_partitions.npz"
N_SAMPLES = 3_000_000
SEEDS = [7, 8]
CONFIGS = {
    "orient0": dict(R3_OVERRIDES, normalOrientation=0),
    "orient2": dict(R3_OVERRIDES, normalOrientation=2),
    "orient4": dict(R3_OVERRIDES, normalOrientation=4),
    "hgs": dict(R3_OVERRIDES, highGradientSeparation=1),
    "roi": dict(R3_OVERRIDES, enablePointCloudPartitioning=1, numCutsAlong1stLongestAxis=1,
                numCutsAlong2ndLongestAxis=1, rawPointsPatch=1),
    "tetris": dict(R3_OVERRIDES, packingStrategy=2),
}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_seg_options_reference.py")


def run(name: str, overrides: dict, frames, normals, arrays: dict) -> dict:
    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    enc = Encoder(cfg)
    parts, aux, moved = [], [], []
    frame_of = []  # roi: the frame each chunk's segmentation belongs to
    real_fetch = enc.segment_fetch
    real_pregen = enc._partitioned_pregen
    real_aux = segmentation.high_gradient_aux
    real_sep = separation.separate_high_gradient

    def fetch(futures):
        out = real_fetch(futures)
        n = out[2]
        pv = np.asarray(out[1][3])[:n]
        nvox = int(pv.max()) + 1
        parts.append((np.asarray(out[1][0])[:nvox], n))
        return out

    def pregen_spy(pc):
        frame_of.append(len(frame_of))
        start = len(parts)
        res = real_pregen(pc)
        frame_of[-1] = (start, len(parts))
        return res

    def aux_spy(*a, **kw):
        out = real_aux(*a, **kw)
        aux.append((np.asarray(out[0]), np.asarray(out[1])))
        return out

    def sep_spy(*a, **kw):
        out = real_sep(*a, **kw)
        moved.append(int(out[1]))
        return out

    enc.segment_fetch = fetch
    enc._partitioned_pregen = pregen_spy
    segmentation.high_gradient_aux = aux_spy
    separation.separate_high_gradient = sep_spy
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        t_enc = time.perf_counter() - t0
    finally:
        segmentation.high_gradient_aux = real_aux
        separation.separate_high_gradient = real_sep
    t0 = time.perf_counter()
    decoded = Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    out = dict(overrides=overrides, seeds=SEEDS, n_samples=N_SAMPLES,
               stream_md5=hashlib.md5(stream).hexdigest(), stream_bytes=len(stream),
               unit_bytes=unit_bytes(stream), stream_stats=enc.last_stream_stats,
               jax_cpu_encode_s=t_enc, jax_cpu_decode_s=t_dec)
    if name in ("hgs", "tetris"):
        committed = np.load(FRONT_PARTITIONS)
        for i in range(len(frames)):
            if not np.array_equal(parts[i][0].astype(np.int8),
                                  committed[f"refined_{i}"].astype(np.int8)):
                raise AssertionError(f"{name}: frame {i}'s partitions differ from the "
                                     "committed ones")
    if name.startswith("orient"):
        for i, (p, _) in enumerate(parts):
            arrays[f"{name}_{i}"] = p.astype(np.int8)
    if name == "hgs":
        for i, ((p, _), (alt, weak)) in enumerate(zip(parts, aux)):
            arrays[f"hgs_alt_{i}"] = alt[:len(p)].astype(np.int8)
            arrays[f"hgs_weak_{i}"] = weak[:len(p)].astype(bool)
        out["n_moved"] = moved
    if name == "roi":
        out["chunk_points"] = [[n for _, n in parts[a:b]] for a, b in frame_of]
        for f, (a, b) in enumerate(frame_of):
            for c, (p, _) in enumerate(parts[a:b]):
                arrays[f"roi_{f}_{c}"] = p.astype(np.int8)
    fr = []
    psnr = {"d1_db": [], "d2_db": [], "y_db": []}
    for f, e, rc, dc, nrm in zip(frames, enc.last_encoded, recons, decoded, normals):
        m = metrics.compute_metrics(
            f.positions.astype(np.int32), f.colors, rc.positions.astype(np.int32), rc.colors,
            resolution=1023, src_normals=nrm, grid_bits=10)
        psnr["d1_db"].append(float(m.c2c_psnr))
        psnr["d2_db"].append(float(m.c2p_psnr))
        psnr["y_db"].append(float(m.color_psnr[0]))
        fd = dict(source_points=f.point_count, patches=len(e.patches),
                  recon_points=rc.point_count, recon_md5=frame_digest(rc.positions, rc.colors),
                  decoded_points=dc.point_count,
                  decoded_md5=frame_digest(dc.positions, dc.colors),
                  d1_db=float(m.c2c_psnr), d2_db=float(m.c2p_psnr),
                  y_db=float(m.color_psnr[0]))
        fr.append(fd)
        print(f"{name}: {fd}", flush=True)
    out["frames"] = fr
    out["mean"] = {k: float(np.mean(v)) for k, v in psnr.items()}
    print(f"{name}: {len(stream)} bytes, mean {out['mean']}, encode {t_enc:.1f}s", flush=True)
    return out


def main() -> int:
    frames = [make_person_cloud(bits=10, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    normals = [metrics.estimate_normals(f.positions.astype(np.int32), grid_bits=10)
               for f in frames]
    arrays: dict = {}
    configs = {name: run(name, ov, frames, normals, arrays) for name, ov in CONFIGS.items()}
    np.savez_compressed(OUT_NPZ, **arrays)
    OUT.write_text(json.dumps(dict(command=COMMAND, configs=configs), indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)} and {OUT_NPZ.relative_to(ROOT)} "
          f"({OUT_NPZ.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
