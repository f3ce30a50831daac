"""Make the committed log2 tables of the PyTorch port's encoder.

Not a test: a helper that evaluates, with the JAX package's XLA CPU
backend,

* the rate term of a quantised level that `vpcc_tpu.video.hevc._rd_choose`
  computes, where(lv > 0, 3 + 2 * log2(1 + lv), 0) for lv = 0 .. 32767,
  into vpcc_tpu_torch/data/rd_bits_xla.npy (float32 (32768,));
* the entropy term of color pre-smoothing that `vpcc_tpu.ops.smoothing.
  _presmooth_vote` computes, -log2(max(cnt / n, 1e-12)) for
  1 <= cnt <= n <= 64, into vpcc_tpu_torch/data/presmooth_log2_xla.npy
  (float32 (65, 65), entry [n, cnt], zero elsewhere).

XLA's log2 is not correctly rounded (a third of the rate terms and about a
tenth of the entropy terms differ from round(log2) in the last bit), so the
port reads these tables in place of computing log2 itself.  Run from the
repository root:

    JAX_PLATFORMS=cpu python tests/torch_make_encode_tables.py
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

LEVEL_MAX = 32767


def main() -> None:
    lv = np.arange(LEVEL_MAX + 1, dtype=np.float32)
    f = jax.jit(lambda v: jnp.where(v > 0, 3.0 + 2.0 * jnp.log2(1.0 + v), 0.0))
    table = np.asarray(f(lv), np.float32)
    out = ROOT / "vpcc_tpu_torch" / "data" / "rd_bits_xla.npy"
    np.save(out, table)
    print(f"wrote {out} ({table.nbytes} bytes)")

    n, cnt = np.meshgrid(np.arange(65), np.arange(65), indexing="ij")
    ok = (cnt >= 1) & (cnt <= n)
    g = jax.jit(lambda c, m: -jnp.log2(jnp.maximum(c / m, 1e-12)))
    ent = np.asarray(g(cnt.astype(np.float32), np.maximum(n, 1).astype(np.float32)))
    ent = np.where(ok, ent, 0.0).astype(np.float32)
    out = ROOT / "vpcc_tpu_torch" / "data" / "presmooth_log2_xla.npy"
    np.save(out, ent)
    print(f"wrote {out} ({ent.nbytes} bytes)")


if __name__ == "__main__":
    main()
