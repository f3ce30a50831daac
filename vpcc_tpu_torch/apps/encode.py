"""PccAppEncoder equivalent on the PyTorch/CUDA port: the encoder's command line.

Reference: source/app/PccAppEncoder/PccAppEncoder.cpp:1015-1170; the port of
vpcc_tpu/apps/encode.py — parse options, loop over GOFs, encode, write the
sample stream (each GOF's stream behind an 8-byte big-endian length),
checkpoint after every GOF, optional reconstruction PLYs, conformance log
and metrics.

Usage:
    python -m vpcc_tpu_torch.apps.encode --config=<cfg> \
        --uncompressedDataPath=path_%04d.ply --compressedStreamPath=out.vpcc \
        --frameCount=N [--startFrameNumber=K] [--resumeEncoding=1] \
        [--device=cuda|cpu]

--device defaults to cuda; without a card the encoder refuses to start
unless --device=cpu is given.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from vpcc_tpu_torch import conformance
from vpcc_tpu_torch.encoder import Encoder
from vpcc_tpu_torch.ops.metrics import compute_metrics
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import read_ply, write_ply


def format_frame_path(template: str, index: int) -> str:
    if "%" in template:
        return template % index
    return template


def split_device(argv):
    """(--device value or None, the other arguments)."""
    device, rest = None, []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def main(argv=None) -> int:
    device, rest = split_device(list(argv if argv is not None else sys.argv[1:]))
    cfg = VPCCConfig.from_args(rest)
    cfg.report_ignored()
    if not cfg.uncompressedDataPath:
        print("error: --uncompressedDataPath required", file=sys.stderr)
        return 1
    out_path = cfg.compressedStreamPath or "out.vpcc"

    t0 = time.perf_counter()
    all_stream = bytearray()
    enc = Encoder(cfg, device=device)
    gof = cfg.groupOfFramesSize
    n_frames = cfg.frameCount
    stats = []  # every encoded frame's EncoderStats, over the GOFs of this run
    conf_log = []
    fidx = cfg.startFrameNumber
    done = 0
    # GOF-granular checkpoint/resume: each GOF is a self-contained
    # length-prefixed sample stream; --resumeEncoding=1 skips the GOFs
    # already on disk.  A sidecar records the GOF size and start frame the
    # checkpoints were written with (a resume under another configuration
    # starts over) and the conformance log of the frames written.
    sidecar = Path(out_path + ".resume.json")
    if int(cfg.extra.get("resumeEncoding", "0")) and Path(out_path).exists():
        meta = None
        if sidecar.exists():
            meta = json.loads(sidecar.read_text())
        if meta is None or meta.get("gof") != gof or meta.get("start") != fidx:
            print(
                "resume sidecar missing or gof/start mismatch "
                f"({meta}); re-encoding from scratch", file=sys.stderr,
            )
        else:
            existing = Path(out_path).read_bytes()
            pos = 0
            while pos + 8 <= len(existing):
                size = int.from_bytes(existing[pos: pos + 8], "big")
                if pos + 8 + size > len(existing):
                    break  # truncated tail: re-encode from here
                pos += 8 + size
                skip = min(gof, n_frames - done)
                done += skip
                fidx += skip
            all_stream.extend(existing[:pos])
            if done:
                prior = meta.get("conf_log", [])
                if len(prior) < done:
                    # the stream is checkpointed before the sidecar: a crash
                    # between the two leaves the sidecar a GOF behind, so
                    # re-encode the GOFs its log does not cover
                    covered = (len(prior) // gof) * gof
                    print(
                        f"resume sidecar conformance log covers only "
                        f"{len(prior)}/{done} frames; rewinding resume "
                        f"point to frame {covered}", file=sys.stderr,
                    )
                    uncovered = done - covered
                    done = covered
                    fidx -= uncovered
                    # drop the stream bytes of the uncovered GOFs
                    pos = 0
                    for _ in range(0, covered, gof):
                        size = int.from_bytes(existing[pos: pos + 8], "big")
                        pos += 8 + size
                    all_stream = bytearray(existing[:pos])
                print(f"resuming after {done} frames ({pos} bytes on disk); "
                      "conformance log covers resumed frames from the sidecar")
                conf_log.extend(prior[:done])
    while done < n_frames:
        count = min(gof, n_frames - done)
        frames = [read_ply(format_frame_path(cfg.uncompressedDataPath, fidx + i))
                  for i in range(count)]
        stream, recons = enc.encode_gof(frames)
        stats.extend(enc.stats)
        all_stream.extend(len(stream).to_bytes(8, "big"))
        all_stream.extend(stream)
        Path(out_path).write_bytes(bytes(all_stream))  # checkpoint per GOF
        entries = [conformance.frame_log_entries(fidx + i, r, len(e.patches), e.width, e.height)
                   for i, (r, e) in enumerate(zip(recons, enc.last_encoded))]
        sidecar.write_text(json.dumps({
            "gof": gof, "start": cfg.startFrameNumber,
            "conf_log": conf_log + entries,
        }))
        print("substream bytes: " + "  ".join(
            f"{k}={v}" for k, v in enc.last_stream_stats.items()))
        conf_log.extend(entries)
        if cfg.reconstructedDataPath:
            for i, r in enumerate(recons):
                write_ply(format_frame_path(cfg.reconstructedDataPath, fidx + i), r)
        if cfg.computeMetrics:
            for i, (src, rec) in enumerate(zip(frames, recons)):
                m = compute_metrics(
                    src.positions.astype(np.int32), src.colors,
                    rec.positions.astype(np.int32), rec.colors,
                    resolution=cfg.resolution,
                    grid_bits=cfg.geometryBitDepth3D,
                    with_d2=True,
                    device=enc.device,
                )
                print(f"frame {fidx + i}: {m.summary()}")
        done += count
        fidx += count

    Path(out_path).write_bytes(bytes(all_stream))
    if cfg.computeChecksum:
        conformance.write_log(out_path + "_enc_pcframe_log.txt", conf_log)
    dt = time.perf_counter() - t0
    total_pts = sum(s.point_count for s in stats)
    print(f"encoded {n_frames} frames, {len(all_stream)} bytes "
          f"({len(all_stream) * 8 / max(total_pts, 1):.3f} bpp), {dt:.1f}s wall "
          f"on {enc.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
