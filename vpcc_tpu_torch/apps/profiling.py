"""Helpers of the profiling apps: synchronised stage timers and a device
trace of one call (CUDA)."""

from __future__ import annotations

import collections
import contextlib
import time

import torch


@contextlib.contextmanager
def timed_stages(acc, patches):
    """Within the block, wrap every (object, attribute, stage name) of
    `patches` so that each call adds its host seconds, bracketed by
    `torch.cuda.synchronize()`, to acc[stage name]."""
    saved = []
    for obj, attr, name in patches:
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))

        def wrap(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            acc[_name] += time.perf_counter() - t0
            return out

        setattr(obj, attr, wrap)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def device_trace(fn):
    """Run fn() once, unsynchronised, under torch.profiler.  Returns (wall
    s, device busy s, {event name: [device us, count]}) over device-side
    events only (kernels, memcpys, memsets): the CPU op entries carry their
    kernels' device time a second time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    items = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            items[e.key][0] += t
            items[e.key][1] += e.count
    busy = sum(v[0] for v in items.values()) / 1e6
    return wall, busy, dict(items)


def print_trace(wall, busy, items, what: str, top: int = 15) -> None:
    """Print a `device_trace` result: busy and idle shares, then the `top`
    events by device time."""
    print(f"device trace of {what}: wall {wall:.3f}s, device busy {busy:.4f}s = "
          f"{100 * busy / wall:.2f}% (idle {100 * (1 - busy / wall):.2f}%)")
    for k, (us, cnt) in sorted(items.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3:9.3f} ms  x{cnt:5d}  {k[:90]}")
