"""Make the committed GPA / multi-tile reference data for the PyTorch port.

Not a test: a helper that runs the JAX package on the CPU over the 8 bench
frames (`make_person_cloud(bits=10, n_samples=3_000_000)`, seeds 7..14) as
one GOF under two configurations, each the bench's r3 overrides plus:

* "gpa": globalPatchAllocation=1 (phase A segments, generates and packs
  every frame, phase B `pack_global` allocates the chains, then the
  data-adaptive choice);
* "tiles": numMaxTilePerFrame=2.

It writes

    vpcc_tpu_torch/data/person_vox10_gpa_tiles_reference.json

holding, per configuration: the overrides, the stream's md5, length and
bytes per substream, `last_stream_stats`, per frame the patch count, the
digests of the encoder's reconstruction and of the JAX decoder's output,
and the JAX-CPU wall seconds of the encode and the decode; for gpa the
digest of `pack_global`'s output on the phase-A patches (the port's
`packing.placement_digest`: every patch's u0, v0, orientation and chain,
and the size, taken as `pack_global` returns, whichever branch the choice
then takes), the per-frame maximum size of phase A and the branch taken;
for tiles the
encoder's `_tile_rows` and `_tile_hints` after the GOF and each frame's
patch count per tile.  It checks that every frame is segmented into the
partitions committed in person_vox10_front_partitions.npz (which drive the
port there).

Run from the repository root (about 15 minutes on a CPU):

    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python tests/torch_make_gpa_tiles_reference.py
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
from torch_make_smoke_stream import OVERRIDES as R3_OVERRIDES, SEEDS, frame_digest  # noqa: E402
from vpcc_tpu.core import packing  # noqa: E402
from vpcc_tpu.decoder import Decoder  # noqa: E402
from vpcc_tpu.encoder import Encoder  # noqa: E402
from vpcc_tpu.utils.config import VPCCConfig  # noqa: E402
from vpcc_tpu.utils.synthetic import make_person_cloud  # noqa: E402
from vpcc_tpu_torch.core.packing import placement_digest  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "person_vox10_gpa_tiles_reference.json"
FRONT_PARTITIONS = DATA / "person_vox10_front_partitions.npz"
N_SAMPLES = 3_000_000
CONFIGS = {
    "gpa": dict(R3_OVERRIDES, globalPatchAllocation=1),
    "tiles": dict(R3_OVERRIDES, numMaxTilePerFrame=2),
}
COMMAND = ("JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python "
           "tests/torch_make_gpa_tiles_reference.py")


def run(name: str, overrides: dict, frames) -> dict:
    cfg = VPCCConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    enc = Encoder(cfg)
    parts = []
    rec: dict = {"pf": []}
    real_fetch = enc.segment_fetch
    real_global, real_flexible = packing.pack_global, packing.pack_flexible

    def fetch(futures):
        out = real_fetch(futures)
        n = out[2]
        nvox = int(np.asarray(out[1][3])[:n].max()) + 1
        parts.append(np.asarray(out[1][0])[:nvox])
        return out

    def flexible_spy(patches, *a, **kw):
        out = real_flexible(patches, *a, **kw)
        if "global" not in rec:
            rec["pf"].append(out)
        return out

    def global_spy(frame_patches, *a, **kw):
        out = real_global(frame_patches, *a, **kw)
        rec["global"] = dict(digest=placement_digest(frame_patches, out), size=list(out),
                             patches=sum(len(ps) for ps in frame_patches),
                             chains=len({p.gpa_chain for ps in frame_patches for p in ps}))
        return out

    enc.segment_fetch = fetch
    packing.pack_flexible, packing.pack_global = flexible_spy, global_spy
    try:
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        t_enc = time.perf_counter() - t0
    finally:
        packing.pack_flexible, packing.pack_global = real_flexible, real_global
    committed = np.load(FRONT_PARTITIONS)
    for i in range(len(frames)):
        if not np.array_equal(parts[i].astype(np.int8), committed[f"refined_{i}"].astype(np.int8)):
            raise AssertionError(f"{name}: frame {i}'s partitions differ from the committed ones")
    t0 = time.perf_counter()
    decoded = Decoder().decode(stream)
    t_dec = time.perf_counter() - t0
    out = dict(overrides=overrides, seeds=SEEDS, n_samples=N_SAMPLES,
               stream_md5=hashlib.md5(stream).hexdigest(), stream_bytes=len(stream),
               unit_bytes=unit_bytes(stream), stream_stats=enc.last_stream_stats,
               jax_cpu_encode_s=t_enc, jax_cpu_decode_s=t_dec)
    if name == "gpa":
        g = rec["global"]
        pf = [max(w for w, _ in rec["pf"]), max(h for _, h in rec["pf"])]
        g["per_frame_size"] = pf
        g["choice"] = "per-frame" if g["size"][0] * g["size"][1] > pf[0] * pf[1] else "gpa"
        out["pack_global"] = g
    if name == "tiles":
        out["tile_rows"] = list(enc._tile_rows)
        out["tile_hints"] = list(enc._tile_hints)
    fr = []
    for f, e, rc, dc in zip(frames, enc.last_encoded, recons, decoded):
        fd = dict(source_points=f.point_count, patches=len(e.patches),
                  width=e.width, height=e.height,
                  recon_points=rc.point_count, recon_md5=frame_digest(rc.positions, rc.colors),
                  decoded_points=dc.point_count,
                  decoded_md5=frame_digest(dc.positions, dc.colors))
        if name == "tiles":
            fd["tile_patches"] = [sum(1 for p in e.patches if p.tile_assigned == t)
                                  for t in range(cfg.numMaxTilePerFrame)]
        fr.append(fd)
        print(f"{name}: {fd}", flush=True)
    out["frames"] = fr
    print(f"{name}: {len(stream)} bytes, stats {enc.last_stream_stats}, encode {t_enc:.1f}s, "
          f"{out.get('pack_global', '')}", flush=True)
    return out


def main() -> int:
    frames = [make_person_cloud(bits=10, n_samples=N_SAMPLES, seed=s) for s in SEEDS]
    configs = {name: run(name, ov, frames) for name, ov in CONFIGS.items()}
    OUT.write_text(json.dumps(dict(command=COMMAND, configs=configs), indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
