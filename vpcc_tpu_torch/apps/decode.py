"""PccAppDecoder equivalent on the PyTorch/CUDA port.

Reference: source/app/PccAppDecoder/PccAppDecoder.cpp:279-409; the port of
vpcc_tpu/apps/decode.py.

Usage:
    python -m vpcc_tpu_torch.apps.decode --compressedStreamPath=in.vpcc \
        --reconstructedDataPath=dec_%04d.ply [--startFrameNumber=K] \
        [--device=cuda|cpu]

--device defaults to cuda; without a card the decoder refuses to start
unless --device=cpu is given.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from vpcc_tpu_torch import conformance
from vpcc_tpu_torch.apps.encode import split_device
from vpcc_tpu_torch.decoder import Decoder
from vpcc_tpu_torch.utils.config import VPCCConfig
from vpcc_tpu_torch.utils.ply import write_ply


def main(argv=None) -> int:
    device, rest = split_device(list(argv if argv is not None else sys.argv[1:]))
    cfg = VPCCConfig.from_args(rest)
    cfg.report_ignored()
    if not cfg.compressedStreamPath:
        print("error: --compressedStreamPath required", file=sys.stderr)
        return 1

    data = Path(cfg.compressedStreamPath).read_bytes()
    t0 = time.perf_counter()
    dec = Decoder(cfg, device=device)
    fidx = cfg.startFrameNumber
    pos = 0
    total = 0
    conf_log = []
    while pos < len(data):
        size = int.from_bytes(data[pos: pos + 8], "big")
        pos += 8
        frames = dec.decode(data[pos: pos + size])
        pos += size
        for f, info in zip(frames, dec.frame_info[-len(frames):]):
            if cfg.reconstructedDataPath:
                tmpl = cfg.reconstructedDataPath
                write_ply(tmpl % fidx if "%" in tmpl else tmpl, f)
            conf_log.append(conformance.frame_log_entries(
                fidx, f, info["patch_count"], info["width"], info["height"]))
            fidx += 1
            total += 1
    dt = time.perf_counter() - t0
    if cfg.computeChecksum:
        conformance.write_log(cfg.compressedStreamPath + "_dec_pcframe_log.txt", conf_log)
    print(f"decoded {total} frames in {dt:.1f}s on {dec.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
