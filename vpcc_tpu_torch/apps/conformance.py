"""PccAppConformance equivalent on the port: diff the encoder's and the
decoder's conformance logs.

Reference: source/app/PccAppConformance/PccAppConformance.cpp:87 ->
PCCConformance::check (PCCConformance.cpp:49); the port of
vpcc_tpu/apps/conformance.py.  The logs are the `*_pcframe_log.txt` files
`apps/encode.py` and `apps/decode.py` write with --computeChecksum=1 (the
default).  Host code only: it runs no kernel.

Usage:
    python -m vpcc_tpu_torch.apps.conformance --encLog=out.vpcc_enc_pcframe_log.txt \
        --decLog=out.vpcc_dec_pcframe_log.txt [--levelIdc=30]

Prints "CONFORMANCE MATCH: N frames" and exits 0 when the logs agree key by
key and every decoded frame is within the level's limits; else prints the
differences and exits 1.
"""

from __future__ import annotations

import sys

from vpcc_tpu_torch import conformance
from vpcc_tpu_torch.utils.config import VPCCConfig


def main(argv=None) -> int:
    cfg = VPCCConfig.from_args(argv if argv is not None else sys.argv[1:])
    enc_path = cfg.extra.get("encLog")
    dec_path = cfg.extra.get("decLog")
    if not enc_path or not dec_path:
        print("error: need --encLog and --decLog", file=sys.stderr)
        return 1
    enc_log = conformance.read_log(enc_path)
    dec_log = conformance.read_log(dec_path)
    ok, diffs = conformance.compare_logs(enc_log, dec_log)
    level = int(cfg.extra.get("levelIdc", 30))
    for rec in dec_log:
        errs = conformance.check_level_limits(
            level, int(rec.get("PointCount", 0)), int(rec.get("PatchCount", 0)),
            int(rec.get("AtlasWidth", 0)), int(rec.get("AtlasHeight", 0)))
        diffs.extend(errs)
        ok = ok and not errs
    if ok:
        print(f"CONFORMANCE MATCH: {len(enc_log)} frames")
        return 0
    for d in diffs[:50]:
        print("DIFF:", d)
    print(f"CONFORMANCE FAILED: {len(diffs)} differences")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
