"""Kernel entries timed one by one on the card, on inputs captured from the
encoder and decoder, for the `vpcc_tpu_torch` of this checkout or of another.

    python vpcc_tpu_torch/apps/profile_entries.py --capture=IN.pt
    python vpcc_tpu_torch/apps/profile_entries.py --inputs=IN.pt \\
        [--root=CHECKOUT] [--runs=5] [--kernels=P,E,A]
    python vpcc_tpu_torch/apps/profile_entries.py --summarize LOG [LOG ...]

--capture encodes one bench frame (`make_person_cloud(bits=10,
n_samples=3_000_000, seed=7)` with the configuration of the committed
front-end reference data, segmented by the encoder itself) and saves the
largest call of
* kernel P: `pipeline.paint_attribute`, `group_dilate` and
  `gather_decoded_colors` (the scalar entries take the color inputs' first
  channel: the colors as samples, channel 0 of the two images widened to
  int32);
* kernel E: `neighbors.knn` for each k of the main path (segmentation k=16,
  recolor k=8 and k=1, pre-smoothing k=64), with the points of its grid.
  The unpacked and batched entries take inputs derived from the recolor
  call (k=8): its points and queries doubled into an 11-bit grid
  (`grid_knn_xyz`), and B = 3 frames of all, every second and every fourth
  of its points with the same queries (`grid_knn_batch`);
* kernel A: `hevc.wavefront_decode32` from the decode of the committed
  8-frame fixture (among the largest calls, the one that mixes inter and
  intra samples most evenly), and `hevc.wavefront_decode16` from the decode
  of that frame and the next bench frame encoded at
  geometryNominal2dBitdepth=11 (the two-level codec).
--inputs times the entries of the kernels named by --kernels, in the package
found under --root (default: this checkout), on those inputs, so that two
commits can be compared on one card, one process each, in turns (the grids
are built by each package from the saved points).  For each run and entry:
the call time (CUDA events over back-to-back calls, the wrapper's host work
included: 100 calls for P, 20 for E and A) and the device time (one call
captured in a CUDA graph and replayed as often).  Prints the card's name and
power limit, then one JSON line: per entry, the runs' call and device
milliseconds and the md5 of its output.  --summarize reads the JSON lines
of such runs (the logs of several processes) and prints, per checkout and
entry, the median and quartiles of the call and device milliseconds over
all runs, and whether the md5s of all runs agree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
P_ENTRIES = ("paint_attribute", "group_dilate", "gather_decoded_colors")
E_CALLS = {16: "grid_knn.segment_k16", 8: "grid_knn.recolor_k8", 1: "grid_knn.nearest_k1",
           64: "grid_knn.presmooth_k64"}
REPS = {"P": 100, "E": 20, "A": 20}


def time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one call of fn, replayed from a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return time_ms(g.replay, reps)


def _clone(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def _spy(mod, attr, before=None, after=None):
    """Wrap mod.attr: before(args, kw) ahead of each call, after(args, kw,
    out) behind it.  Returns the undo."""
    real = getattr(mod, attr)

    def call(*args, **kw):
        if before:
            before(args, kw)
        out = real(*args, **kw)
        if after:
            after(args, kw, out)
        return out

    setattr(mod, attr, call)
    return lambda: setattr(mod, attr, real)


def _mix(inter: int, total: int) -> int:
    return min(inter, total - inter)


def capture_encode(frame, cfg, device) -> tuple:
    """Encode one frame, keeping P's largest calls and E's largest call for
    each k with its grid's points.  Returns (P inputs, E inputs)."""
    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.ops import neighbors

    p_kept, e_kept, grids = {}, {}, {}

    def keep_p(name):
        def before(args, kw):
            if name not in p_kept or args[0].numel() > p_kept[name][0]:
                p_kept[name] = (args[0].numel(), _clone(args))
        return before

    def grid_built(args, kw, g):
        grids[id(g)] = args[0].clone()

    def keep_e(args, kw):
        grid, q = args[:2]
        k = kw.get("k")
        if k in E_CALLS and id(grid) in grids and (
                k not in e_kept or q.shape[0] > e_kept[k]["q"].shape[0]):
            e_kept[k] = dict(pos=grids[id(grid)], bits=grid.grid_bits, cell_bits=grid.cell_bits,
                             q=q.clone(), k=k, bucket=kw.get("bucket", 16))

    undo = [_spy(pipeline, name, before=keep_p(name)) for name in P_ENTRIES]
    undo += [_spy(neighbors, "build_grid", after=grid_built),
             _spy(neighbors, "knn", before=keep_e)]
    try:
        Encoder(cfg, device=device).encode_gof([frame])
    finally:
        for u in undo:
            u()
    missing = sorted(set(E_CALLS) - set(e_kept))
    if missing or len(p_kept) != len(P_ENTRIES):
        raise RuntimeError(f"calls not seen: k={missing}, P {sorted(p_kept)}")
    e_in = {E_CALLS[k]: c for k, c in e_kept.items()}
    fwd = e_kept[8]
    e_in["grid_knn_xyz"] = dict(pos=fwd["pos"] * 2, bits=fwd["bits"] + 1, cell_bits=None,
                                q=fwd["q"] * 2, k=8, bucket=fwd["bucket"])
    subsets = [fwd["pos"], fwd["pos"][::2], fwd["pos"][::4]]
    pad = torch.full((3, fwd["pos"].shape[0], 3), -(1 << 20), dtype=torch.int32,
                     device=fwd["pos"].device)
    for b, sub in enumerate(subsets):
        pad[b, :sub.shape[0]] = sub
    e_in["grid_knn_batch"] = dict(pos=pad, bits=fwd["bits"], cell_bits=None,
                                  q=fwd["q"][None].expand(3, -1, -1).contiguous(), k=8,
                                  bucket=fwd["bucket"])
    return {name: args for name, (_, args) in p_kept.items()}, e_in


def capture_decode(stream: bytes, name: str, device) -> list:
    """Decode `stream`, keeping kernel A's (`name`) largest call that mixes
    inter and intra samples most evenly."""
    from vpcc_tpu_torch.decoder import Decoder
    from vpcc_tpu_torch.video import hevc
    from vpcc_tpu_torch.video.hevc_tables import MODE_INTER

    kept = []

    def key(args):
        if name == "wavefront_decode32":
            s32, m32, s16, modes = (args[i] != 0 if i in (1, 4) else args[i]
                                    for i in (1, 2, 4, 5))
            inter = int(((~s32 & (m32 == MODE_INTER)).sum() * 1024
                         + (s32[..., None] & ~s16 & (modes[..., 0] == MODE_INTER)).sum() * 256
                         + ((s32[..., None] & s16)[..., None] & (modes == MODE_INTER)).sum()
                         * 64))
            total = args[1].numel() * 1024
        else:
            split, modes = args[1] != 0, args[2]
            inter = int((~split & (modes[..., 0] == MODE_INTER)).sum() * 256
                        + (split[..., None] & (modes == MODE_INTER)).sum() * 64)
            total = args[1].numel() * 256
        return (args[0].numel(), _mix(inter, total))

    def before(args, kw):
        k = key(args)
        if not kept or k > kept[0]:
            kept[:] = [k, _clone(args)]

    undo = _spy(hevc, name, before=before)
    try:
        Decoder(device=device).decode(stream)
    finally:
        undo()
    if not kept:
        raise RuntimeError(f"{name} was not called")
    return kept[1]


def capture(path: Path, device="cuda") -> None:
    """Encode and decode bench frames on `device` and save the inputs of
    kernels P, E and A."""
    from vpcc_tpu_torch import device as dev
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    data = ROOT / "vpcc_tpu_torch" / "data"
    ref = json.loads((data / "person_vox10_front_digests.json").read_text())
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    dev.build_kernels()
    frames = [make_person_cloud(bits=10, n_samples=3_000_000, seed=s) for s in ref["seeds"][:2]]
    p_in, e_in = capture_encode(frames[0], cfg, device)
    a_in = {"wavefront_decode32": capture_decode(
        (data / "person_vox10_r3_gof8.vpcc").read_bytes(), "wavefront_decode32", device)}
    cfg.geometryNominal2dBitdepth = 11
    stream, _ = Encoder(cfg, device=device).encode_gof(frames)
    a_in["wavefront_decode16"] = capture_decode(stream, "wavefront_decode16", device)
    cpu = lambda v: v.cpu() if torch.is_tensor(v) else v
    torch.save({"P": {n: [cpu(a) for a in args] for n, args in p_in.items()},
                "E": {n: {k: cpu(v) for k, v in c.items()} for n, c in e_in.items()},
                "A": {n: [cpu(a) for a in args] for n, args in a_in.items()}}, path)
    print(f"captured P {sorted(p_in)}: rows {p_in['paint_attribute'][0].shape[0]}; E "
          + ", ".join(f"{n} {tuple(c['q'].shape)} k={c['k']} bucket={c['bucket']}"
                      for n, c in e_in.items())
          + "; A " + ", ".join(f"{n} {tuple(a[0].shape)}" for n, a in a_in.items()))


def entry_calls(pkg: dict, inputs: dict, kernels: str, device="cuda") -> dict:
    """name -> (kernel letter, a call of that entry on the captured inputs)
    for the entries of `kernels`, with the modules of one checkout."""
    pipeline, neighbors, hevc = pkg["pipeline"], pkg["neighbors"], pkg["hevc"]
    on = lambda args: [a.to(device) if torch.is_tensor(a) else a for a in args]
    calls = {}
    if "P" in kernels:
        pix, layer, col, h, w = on(inputs["P"]["paint_attribute"])
        dilate = on(inputs["P"]["group_dilate"])
        gather = on(inputs["P"]["gather_decoded_colors"])
        val = col[:, 0].contiguous()
        g_pix, g_layer, a0, a1 = gather
        i0, i1 = (a[..., 0].to(torch.int32).contiguous() for a in (a0, a1))
        calls.update({
            "paint_attribute": lambda: pipeline.paint_attribute(pix, layer, col, h, w),
            "group_dilate": lambda: pipeline.group_dilate(*dilate),
            "gather_decoded_colors": lambda: pipeline.gather_decoded_colors(*gather),
            "paint_scalar": lambda: pipeline.paint_scalar(pix, layer, val, h, w),
            "gather_decoded_scalar": lambda: pipeline.gather_decoded_scalar(g_pix, g_layer, i0,
                                                                            i1),
        })
    if "E" in kernels:
        for name, c in inputs["E"].items():
            pos, q = c["pos"].to(device), c["q"].to(device)
            if name == "grid_knn_batch":
                grids = neighbors.build_grid_batch(pos, c["bits"])
                calls[name] = lambda g=grids, q=q, c=c: neighbors.knn_batch(g, q, c["k"],
                                                                            c["bucket"])
            else:
                grid = neighbors.build_grid(pos, c["bits"], c["cell_bits"])
                calls[name] = lambda g=grid, q=q, c=c: neighbors.knn(g, q, k=c["k"],
                                                                     bucket=c["bucket"])
    if "A" in kernels:
        for name, args in inputs["A"].items():
            calls[name] = lambda f=getattr(hevc, name), a=on(args): f(*a)
    letter = {n: "P" for n in calls}
    letter.update({n: "E" for n in inputs["E"] if n in calls})
    letter.update({n: "A" for n in inputs["A"] if n in calls})
    return {n: (letter[n], fn) for n, fn in calls.items()}


def md5(out) -> str:
    h = hashlib.md5()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def profile(inputs_path: Path, root: Path, runs: int, kernels: str) -> dict:
    sys.path.insert(0, str(root))
    from vpcc_tpu_torch import pipeline
    from vpcc_tpu_torch.ops import neighbors
    from vpcc_tpu_torch.video import hevc

    if Path(pipeline.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {pipeline.__file__}, not the package under {root}")
    calls = entry_calls({"pipeline": pipeline, "neighbors": neighbors, "hevc": hevc},
                        torch.load(inputs_path), kernels)
    res = {name: {"md5": md5(fn()), "call_ms": [], "device_ms": []}
           for name, (_, fn) in calls.items()}
    for _ in range(runs):
        for name, (letter, fn) in calls.items():
            res[name]["call_ms"].append(time_ms(fn, REPS[letter]))
            res[name]["device_ms"].append(graph_ms(fn, REPS[letter]))
    return res


def summarize(paths) -> dict:
    """root -> entry -> {call and device: (q1, median, q3), runs, md5s
    agree} over the JSON lines in `paths`."""
    import statistics

    runs = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                for name, e in r["entries"].items():
                    acc = runs.setdefault(r["root"], {}).setdefault(
                        name, {"call_ms": [], "device_ms": [], "md5": set()})
                    acc["call_ms"] += e["call_ms"]
                    acc["device_ms"] += e["device_ms"]
                    acc["md5"].add(e["md5"])
    q = lambda v: tuple(round(x, 4) for x in statistics.quantiles(v, n=4)) if len(v) > 1 \
        else (v[0],) * 3
    return {root: {name: {"call_ms": q(e["call_ms"]), "device_ms": q(e["device_ms"]),
                          "runs": len(e["call_ms"]), "md5_agree": len(e["md5"]) == 1,
                          "md5": sorted(e["md5"])[0]}
                   for name, e in entries.items()}
            for root, entries in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--capture", type=Path, help="encode and decode, save the inputs here")
    ap.add_argument("--inputs", type=Path, help="time the entries on these inputs")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose vpcc_tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--kernels", default="P,E,A", help="kernels whose entries are timed")
    ap.add_argument("--summarize", nargs="+", type=Path, help="logs of --inputs runs")
    a = ap.parse_args(argv)
    if a.summarize:
        for root, entries in summarize(a.summarize).items():
            for name, e in entries.items():
                print(f"{root} {name}: call ms (q1, median, q3) {e['call_ms']}, device ms "
                      f"{e['device_ms']}, {e['runs']} runs, md5 {e['md5']} "
                      f"{'agrees' if e['md5_agree'] else 'DIFFERS'} across runs")
        return 0
    if not torch.cuda.is_available():
        print("profile_entries: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    if a.capture:
        sys.path.insert(0, str(ROOT))
        capture(a.capture)
        return 0
    if not a.inputs:
        ap.error("give --capture or --inputs")
    res = profile(a.inputs, a.root, a.runs, a.kernels)
    print(json.dumps({"root": str(a.root), "card": smi, "entries": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
