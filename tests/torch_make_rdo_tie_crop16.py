"""Make the committed two-level RDO tie crop for the PyTorch port's tests.

Not a test: a helper in two steps that writes

    vpcc_tpu_torch/data/rdo_tie_crop16.npz

with a 256x256 crop of a D0 geometry plane of the
vox11 GOF at geometryNominal2dBitdepth=11 and CTC r3 (the first vox11 frame,
`make_person_cloud(bits=11, n_samples=12_000_000)`, seed 7, driven by the
committed JAX partitions; every plane there takes the two-level 16/8
codec) after the push-pull background fill (`plane`, uint16), the RD
weights there (the decoded occupancy, `weight`, uint8) and the QP (`qp`).  On it the 16x16 and 8x8 RD decisions
of the two-level encoder equal the JAX encoder's only when the distortion
and rate sums follow the port's order (`video/hevc.py` `_rd_sum`: eight
lanes over the rows, as inside `_build_encode32`); the 32x32 row order,
a sequential sum and a pairwise tree each give other bytes.

1. `search OUTDIR`, on a machine with an NVIDIA GPU (no JAX needed): the
   port's front end on that frame, then its D0 plane through the plain
   two-level encoder on the card under the four orders; every codec tile
   holding a CU whose syntax differs between orders is written to OUTDIR
   (the filled samples, the weights, the QP).
2. `pick OUTDIR`, on a CPU with the JAX package: for each tile, its top
   256x256 crop (coded alone as one tile, its CUs decide as in the plane's
   tile) through `vpcc_tpu.video.hevc.encode_planes` and the port's plain
   encoder under each order; the first crop whose JAX payload equals the
   port's order only is written.

    python tests/torch_make_rdo_tie_crop16.py search tie16   (~1.5 min on an H100)
    JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR= python \\
        tests/torch_make_rdo_tie_crop16.py pick tie16        (~2 min)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vpcc_tpu_torch import device as dev  # noqa: E402
from vpcc_tpu_torch.video import hevc as th  # noqa: E402

DATA = ROOT / "vpcc_tpu_torch" / "data"
OUT = DATA / "rdo_tie_crop16.npz"
CROP = 256


def _sequential(x, n, square):
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        e = x[..., j]
        acc = dev.fma_f32(e, e, acc) if square else acc + e
    return acc


def _tree(x, n, square):
    y = x * x if square else x
    while y.shape[-1] > 1:
        y = y[..., 0::2] + y[..., 1::2]
    return y[..., 0]


ORDERS = {"port": th._rd_sum, "rows32": lambda x, n, square: th._row_sum(x, n, square),
          "sequential": _sequential, "tree": _tree}


def _with_order(name, fn, *a, **kw):
    """fn(*a, **kw) with the plain RDO's sums in order `name`."""
    saved = th._rd_sum
    th._rd_sum = ORDERS[name]
    try:
        return fn(*a, **kw)
    finally:
        th._rd_sum = saved


def search(outdir: Path) -> int:
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads((DATA / "person_vox11_geo11_reference.json").read_text())
    parts = np.load(DATA / "person_vox11_partitions.npz")
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    d = dev.resolve_device()
    frame = make_person_cloud(bits=11, n_samples=ref["n_samples"], seed=ref["seeds"][0])
    enc = Encoder(cfg, device=d)
    seg = Encoder.with_partition(enc.segment_dispatch(frame), torch.as_tensor(
        parts["refined_0"].astype(np.int32)))
    fr = enc.encode_frame_front(frame, seg=seg)
    occ = torch.as_tensor(np.ascontiguousarray(fr.frame.occupancy, np.uint8), device=d)
    geo = torch.as_tensor(fr.frame.geometry0.astype(np.int32), device=d)[None]
    wgt = torch.as_tensor(np.asarray(fr.occ_rec).astype(np.int32), device=d)
    from vpcc_tpu_torch.ops import padding
    filled = padding.push_pull_round(geo.contiguous(), occ.contiguous())[0].cpu().numpy()
    # the plain encoder on the card's tensors, so that the orders can differ
    th.wavefront_encode16 = th.wavefront_encode16_plain
    syn = {}
    for name in ORDERS:
        c = _with_order(name, th.encode_planes_dispatch, geo, [cfg.geometryQP], [2047], occ=occ,
                        weight=wgt, deblock=False)
        syn[name] = {k: c.syntax[k].cpu().numpy() for k in ("split", "modes", "coeffs")}
    ty, tx = c.ty, c.tx
    H, W = filled.shape
    Ht, Wt = H // ty, W // tx
    outdir.mkdir(parents=True, exist_ok=True)
    tiles = set()
    for name in ORDERS:
        for k in ("split", "modes", "coeffs"):
            a, b = syn[name][k], syn["port"][k]
            tiles |= set(np.nonzero((a != b).reshape(a.shape[0], -1).any(-1))[0].tolist())
    for t in sorted(tiles):
        y0, x0 = (t // tx) * Ht, (t % tx) * Wt
        np.savez(outdir / f"tile{t:03d}.npz", plane=filled[y0:y0 + Ht, x0:x0 + Wt],
                 weight=wgt[y0:y0 + Ht, x0:x0 + Wt].cpu().numpy(), qp=cfg.geometryQP)
    print(f"plane {H}x{W}, tiles {ty}x{tx}: {len(tiles)} tiles where the orders differ "
          f"-> {outdir}")
    return 0


def pick(indir: Path) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vpcc_tpu.video import hevc as jh

    for f in sorted(indir.glob("tile*.npz")):
        z = np.load(f)
        plane = z["plane"][:CROP, :CROP].astype(np.int32)
        weight = z["weight"][:CROP, :CROP].astype(np.int32)
        qp = int(z["qp"])
        want, _ = jh.encode_planes(plane[None], [qp], [2047], deblock=False, weight=weight)
        same = {name: _with_order(name, th.encode_planes, torch.as_tensor(plane[None]), [qp],
                                  [2047], deblock=False, weight=torch.as_tensor(weight))[0] == want
                for name in ORDERS}
        print(f"{f.name}: the crop's payload equals JAX's under {same}", flush=True)
        if same["port"] and not any(v for k, v in same.items() if k != "port"):
            np.savez_compressed(OUT, plane=plane.astype(np.uint16),
                                weight=weight.astype(np.uint8), qp=qp)
            print(f"wrote {OUT.name} from {f.name} (QP {qp})")
            return 0
    raise SystemExit("no crop where only the port's order gives JAX's payload")


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("search", "pick"):
        raise SystemExit(__doc__)
    raise SystemExit((search if sys.argv[1] == "search" else pick)(Path(sys.argv[2])))
