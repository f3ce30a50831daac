"""Device policy, CUDA kernel build/load, and kernel launch counters.

Policy (set once, at import):
* TF32 is off for matmuls and cuDNN: nothing in the port may round a float32
  product to 10 mantissa bits.
* Entry points run on CUDA unless the caller asks for the CPU.  Without a
  card and without an explicit device they raise: the port never drops to
  the CPU on its own.
* Sorts are stable (`stable=True` at every call site).

Kernels are CUDA C++ sources under `csrc/`, one shared library per source
with a plain C interface, compiled with `nvcc` for `sm_90a` into `_build/`
at first use and loaded with ctypes.  `build_kernels()` starts one `nvcc`
per source, all at once.  Libraries are named by a hash of their source and
flags, so an edited source never loads a stale build.

Every kernel wrapper calls `count_launch(name, n)` where it launches its
kernel (n = kernel launches in that call) and nowhere else; the counts show
that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
REPO_DIR = PKG_DIR.parent

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# kernel name -> extra nvcc flags.  The kernels that reproduce float32
# rounding operation by operation forbid multiply-add contraction (their
# fused multiply-adds are explicit __fmaf_rn calls).
KERNELS: Dict[str, list] = {
    "wavefront_decode32": [],
    "half_pel_mc": [],
    "generate_points": [],
    "grid_smooth": ["--fmad=false"],
    "grid_knn": [],
    "segment": ["--fmad=false"],
    "cc_labels": [],
    "coverage": [],
    "wavefront_encode32": ["--fmad=false"],
    "motion_search": ["--fmad=false"],
    "sao": ["--fmad=false"],
    "push_pull": ["--fmad=false"],
    "recolor": ["--fmad=false"],
    "presmooth": ["--fmad=false"],
    "deblock": [],
    "attr_image": [],
    "color_convert": ["--fmad=false"],
    "metrics": ["--fmad=false"],
    "eom_colors": [],
    "color_smooth": ["--fmad=false"],
    "pbf": ["--fmad=false"],
    "plr": [],
    "bg_fill": ["--fmad=false"],
    "orient": ["--fmad=false"],
}

# entries of a kernel's library counted apart from it: the unpacked-table
# k-NN of kernel E (grids above 10 bits), kernel C with EOM layers and with
# PLR layers, kernel V's RDO, kernel W's dilation and its harmonic (and
# smoothed push-pull) fill, kernel P's five entries (paint, group
# dilation, gather, scalar paint and gather; nothing counts as
# "attr_image"), kernel X's viewpoint orientation (its flood counts as
# "orient"), kernel F's high-gradient aux, the frame-batched entries of
# kernels E and M (the level-batched GOF path), and the two-level (16/8)
# wavefront encode and decode of kernels I and A (planes above 10 bits)
ENTRIES = ("grid_knn_xyz", "generate_points_eom", "generate_points_plr", "plr_rdo",
           "bg_dilate", "bg_harmonic", "attr_paint", "attr_group_dilate",
           "attr_gather", "attr_paint_scalar", "attr_gather_scalar", "orient_viewpoint",
           "high_gradient_aux", "grid_knn_batch", "recolor_exact_batch", "recolor_blend_batch",
           "wavefront_encode16", "wavefront_decode16")
LAUNCHES: Dict[str, int] = {k: 0 for k in (*KERNELS, *ENTRIES)}
# ptxas resource lines of each build (registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise.  Raises when CUDA is absent and no device was given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vpcc_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] += n


def stream_handle() -> ctypes.c_void_p:
    """The current CUDA stream of the current device, as
    torch.cuda.current_stream() names it, read by PyTorch's raw getter: the
    wrappers call this once a launch, and current_stream() builds a Stream
    object each call, which costs more host time than a short kernel."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device, ndim: Optional[int] = None) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device`."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


_scratch: Dict[tuple, torch.Tensor] = {}


def scratch(key: str, device: torch.device, ints: int) -> torch.Tensor:
    """Kernel `key`'s int32 scratch on `device`, grown to `ints` and never
    shrunk, zero when it grows (kernel R's ticket starts at 0 and its last
    block sets it back; the other kernels set what they read of it); calls
    run in stream order."""
    buf = _scratch.get((key, device))
    if buf is None or buf.numel() < ints:
        buf = _scratch[(key, device)] = torch.zeros(ints, dtype=torch.int32, device=device)
    return buf


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# ---------------------------------------------------------------------------
# float32 rounding as the reference computes it
#
# XLA's CPU backend contracts a multiply feeding an add into one fused
# multiply-add, and turns a division by a constant into a multiplication by
# the constant's float32 reciprocal (which it then fuses too).  The port
# reproduces those roundings where the reference relies on them (color
# conversion, grid smoothing, normals and segmentation) with `fma_f32`;
# everywhere else each torch op rounds once, as an unfused float32
# operation.

def _f32_operand(x, like: torch.Tensor) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.float32, device=like.device)
    return x.to(torch.float32).double()


def fma_f32(a, b, c) -> torch.Tensor:
    """round_to_float32(a * b + c) with a single rounding, like a hardware
    float32 FMA.  Operands are float32 tensors or Python floats (taken as
    their float32 value).  The product is exact in float64; the sum's
    rounding error is recovered exactly (TwoSum) and used to break the one
    case where rounding through float64 could differ: a float64 sum that
    lands exactly halfway between two float32 values."""
    like = next(x for x in (a, b, c) if torch.is_tensor(x))
    a64, b64, c64 = (_f32_operand(x, like) for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    rd = r.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where((s == (rd + up.double()) * 0.5) & (err > 0), up, r)
    return torch.where((s == (rd + dn.double()) * 0.5) & (err < 0), dn, r)


def recip_f32(k: float) -> float:
    """The float32 reciprocal of the float32 constant k (what XLA multiplies
    by in place of dividing by k)."""
    return float(np.float32(1.0) / np.float32(k))


# ---------------------------------------------------------------------------
# builds

def _digest(paths: Iterable[Path], flags: list) -> str:
    h = hashlib.sha1()
    for p in paths:
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _kernel_lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + KERNELS[name]
    return BUILD_DIR / f"lib{name}-{_digest([src, *sorted(CSRC_DIR.glob('*.cuh'))], flags)}.so"


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one `nvcc` process per source, all started together.  Returns the
    wall seconds of the whole build per kernel (0.0 when it was cached)."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _kernel_lib_path(name)
        if out.exists():
            continue
        tmp = Path(tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")[1])
        cmd = [nvcc_path(), *NVCC_FLAGS, *KERNELS[name], "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _kernel_lib_path(name)
            if not path.exists():
                build_kernels([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def kernel_fn(name: str, entry: str, argtypes: list):
    """The C entry `entry` of kernel `name`'s library with its argument and
    result types set once (ctypes rebuilds its converters each time they
    are set, a visible share of a short call)."""
    fn = _fns.get((name, entry))
    if fn is None:
        fn = getattr(load_kernel(name), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _fns[(name, entry)] = fn
    return fn


def build_host_library(src: Path, stem: str) -> Path:
    """Compile host C++ `src` with g++ into `_build/` (once per source
    content) and return the library path."""
    flags = ["-O3", "-shared", "-fPIC"]
    out = BUILD_DIR / f"lib{stem}-{_digest([src], flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")[1])
    try:
        subprocess.check_call(["g++", *flags, str(src), "-o", str(tmp)])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
