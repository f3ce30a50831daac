"""Kernel P's five entries timed one by one on the card, on inputs captured
from the encoder, for the `vpcc_tpu_torch` of this checkout or of another.

    python vpcc_tpu_torch/apps/profile_attr_image.py --capture=IN.pt
    python vpcc_tpu_torch/apps/profile_attr_image.py --inputs=IN.pt \\
        [--root=CHECKOUT] [--runs=5]

--capture encodes one bench frame (`make_person_cloud(bits=10,
n_samples=3_000_000, seed=7)` with the configuration of the committed
front-end reference data, segmented by the encoder itself) and saves the
largest call of `pipeline.paint_attribute`, `group_dilate` and
`gather_decoded_colors`.  --inputs times the entries of the package found
under --root (default: this checkout) on those inputs, so that two commits
can be compared on one card, one process each, in turns.  The scalar entries
take the color inputs' first channel (the colors as samples, channel 0 of
the two images widened to int32).  For each run and entry: the call time
(CUDA events over 100 back-to-back calls, the wrapper's host work included)
and the device time (one call captured in a CUDA graph and replayed 50
times).  Prints the card's name and power limit, then one JSON line: per
entry, the runs' call and device milliseconds and the md5 of its output.
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
ENTRIES = ("paint_attribute", "group_dilate", "gather_decoded_colors", "paint_scalar",
           "gather_decoded_scalar")


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


def capture(path: Path) -> None:
    """Encode one bench frame on the card and save P's largest inputs."""
    from vpcc_tpu_torch import device as dev, pipeline
    from vpcc_tpu_torch.encoder import Encoder
    from vpcc_tpu_torch.utils.config import VPCCConfig
    from vpcc_tpu_torch.utils.synthetic import make_person_cloud

    ref = json.loads((ROOT / "vpcc_tpu_torch" / "data"
                      / "person_vox10_front_digests.json").read_text())
    cfg = VPCCConfig()
    for k, v in ref["overrides"].items():
        setattr(cfg, k, v)
    dev.build_kernels()
    kept = {}
    real = {name: getattr(pipeline, name) for name in ENTRIES[:3]}

    def spy(name):
        def call(*args):
            size = args[0].numel()
            if name not in kept or size > kept[name][0]:
                kept[name] = (size, [a.clone() if torch.is_tensor(a) else a for a in args])
            return real[name](*args)
        return call

    for name in real:
        setattr(pipeline, name, spy(name))
    try:
        frame = make_person_cloud(bits=10, n_samples=3_000_000, seed=ref["seeds"][0])
        Encoder(cfg, device="cuda").encode_gof([frame])
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(pipeline, name, fn)
    torch.save({name: [a.cpu() if torch.is_tensor(a) else a for a in args]
                for name, (_, args) in kept.items()}, path)
    print(f"captured {sorted(kept)}: rows {kept['paint_attribute'][1][0].shape[0]}, "
          f"planes {tuple(kept['group_dilate'][1][0].shape)}")


def entry_calls(pipeline, inputs: dict) -> dict:
    """name -> a call of that entry on the captured inputs."""
    cuda = lambda args: [a.cuda() if torch.is_tensor(a) else a for a in args]
    paint = cuda(inputs["paint_attribute"])
    dilate = cuda(inputs["group_dilate"])
    gather = cuda(inputs["gather_decoded_colors"])
    pix, layer, col, h, w = paint
    val = col[:, 0].contiguous()
    g_pix, g_layer, a0, a1 = gather
    i0, i1 = (a[..., 0].to(torch.int32).contiguous() for a in (a0, a1))
    return {
        "paint_attribute": lambda: pipeline.paint_attribute(pix, layer, col, h, w),
        "group_dilate": lambda: pipeline.group_dilate(*dilate),
        "gather_decoded_colors": lambda: pipeline.gather_decoded_colors(*gather),
        "paint_scalar": lambda: pipeline.paint_scalar(pix, layer, val, h, w),
        "gather_decoded_scalar": lambda: pipeline.gather_decoded_scalar(g_pix, g_layer, i0, i1),
    }


def md5(out) -> str:
    h = hashlib.md5()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def profile(inputs_path: Path, root: Path, runs: int) -> dict:
    sys.path.insert(0, str(root))
    from vpcc_tpu_torch import pipeline

    if Path(pipeline.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {pipeline.__file__}, not the package under {root}")
    calls = entry_calls(pipeline, torch.load(inputs_path))
    res = {name: {"md5": md5(fn()), "call_ms": [], "device_ms": []}
           for name, fn in calls.items()}
    for _ in range(runs):
        for name, fn in calls.items():
            res[name]["call_ms"].append(time_ms(fn, 100))
            res[name]["device_ms"].append(graph_ms(fn, 50))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--capture", type=Path, help="encode a frame and save P's inputs here")
    ap.add_argument("--inputs", type=Path, help="time the entries on these inputs")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose vpcc_tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attr_image: CUDA is not available", file=sys.stderr)
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
    res = profile(a.inputs, a.root, a.runs)
    print(json.dumps({"root": str(a.root), "card": smi, "entries": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
