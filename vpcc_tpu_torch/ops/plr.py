"""PLR, point local reconstruction (kernel V).

Behavioral reference: decoder-side point generation `PCCCodec::generatePoints`
(source/lib/PccLibCommon/source/PCCCodec.cpp:474-498) with
`getDeltaNeighbors` (:240-267), the encoder's mode RDO
`pointLocalReconstructionSearch` (PCCEncoder.cpp:5379-5545) and the default
mode table `g_pointLocalReconstructionMode` (PCCEncoderParameters.cpp:40),
as the JAX package computes them (vpcc_tpu/ops/plr.py): a single geometry
map is coded, and each block's mode says how many points (`dmag` <= 3)
to add above D0, and whether to fill the depths in between.

Kernel V (csrc/plr.cu) has two entries:
* the code plane: per pixel, the masked 3x3 and 5x5 maxima of the depth
  deltas in [1, 4] over the edge-padded decoded D0 (`interp_deltas`), the
  pixel's block mode from the block mode map, its `dmag` and fill flag from
  the mode table (`mode_planes`), written as a 3-bit code whose bit j - 1
  says that the layer at D0 + j exists.  Kernel C's EOM entry turns the code
  into the PLR layers (depth D0 + j, tag 2), in the reference's row order;
* the RDO (encoder only, `rdo`): per block and mode the forward and
  backward squared depth-set errors and the source and generated counts,
  the block's mode (the first minimum of max(fwd / src, bwd / gen)), then
  per patch the sums pooled over its blocks in raster order, the patch's
  mode, whether it is small (<= block_threshold blocks), and the final
  block modes; two launches, the four results read back in one packed
  buffer.

Float order: the reference sums integer errors in float32.  A float32 sum
of non-negative integers is exact, whatever its order, while it stays below
2^24; the port sums the blocks exactly (int64) and reports the blocks (and
the small patches' pools) whose sums reach 2^24 (`Rdo.inexact`), where
XLA's reduce order would decide the rounding.  The pools are summed
sequentially in block raster order, XLA's scatter-add order.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev

THRESHOLD = 4   # g_neighborThreshold (PCCCommon.h:130)
MAX_DELTA = 3   # after the reference's deltaMax - 1 step: <= THRESHOLD - 1
N_LAYERS = MAX_DELTA  # extra reconstruction layers when PLR is on
EXACT_LIMIT = 1 << 24

# (interpolate, filling, minD1, neighbor) rows; plrlNumberOfModes selects a
# prefix (reference g_pointLocalReconstructionMode)
MODE_TABLE = np.array(
    [
        [0, 0, 0, 1], [1, 0, 0, 1], [1, 1, 0, 1], [1, 0, 0, 2], [1, 1, 0, 2],
        [0, 0, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [1, 0, 1, 2], [1, 1, 1, 2],
    ],
    np.int32,
)


class Rdo(NamedTuple):
    """The RDO's result, on the host (the kernel's one packed read; the plain
    version's copied there), as its one caller, the encoder, reads it."""
    block_modes: torch.Tensor   # (nbH, nbW) int32
    patch_level: torch.Tensor   # (P,) bool: one patch-level mode
    patch_modes: torch.Tensor   # (P,) int32
    inexact: int                # blocks / small patches whose sums reach 2^24


# ---------------------------------------------------------------------------
# plain versions

def interp_deltas_plain(geo):
    """(d1, d2) int32 (H, W): the 'interpolate' delta for the 3x3 and 5x5
    windows over the decoded relative D0 plane (edge pixels duplicate the
    border; reference `interp_deltas`)."""
    g = geo.to(torch.int32)
    h, w = g.shape
    ys = torch.arange(-2, h + 2, device=g.device).clamp(0, h - 1)
    xs = torch.arange(-2, w + 2, device=g.device).clamp(0, w - 1)
    gp = g[ys][:, xs]

    def masked(dy, dx):
        dd = gp[2 + dy:2 + dy + h, 2 + dx:2 + dx + w] - g
        return torch.where((dd >= 1) & (dd <= THRESHOLD), dd, torch.zeros_like(dd))

    raw1 = torch.zeros_like(g)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            if dy or dx:
                raw1 = torch.maximum(raw1, masked(dy, dx))
    raw2 = raw1
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if max(abs(dy), abs(dx)) == 2:
                raw2 = torch.maximum(raw2, masked(dy, dx))
    return (raw1 - 1).clamp(min=0), (raw2 - 1).clamp(min=0)


def _per_mode_planes(geo, mode_tbl):
    d1, d2 = interp_deltas_plain(geo)
    t = mode_tbl.long()
    interp, mind1, neigh = (t[:, k][:, None, None] for k in (0, 2, 3))
    base = torch.where(interp == 1, torch.where(neigh == 2, d2[None], d1[None]),
                       torch.zeros_like(d1)[None])
    return torch.maximum(base, mind1).to(torch.int32), mode_tbl[:, 1] == 1


def mode_planes_plain(geo, block_modes, mode_tbl, res: int):
    """(dmag (H, W) int32, fill (H, W) bool) of the pixels' block modes
    (reference `mode_planes` over the block map upsampled by `res`)."""
    dmag_all, fill_flags = _per_mode_planes(geo, mode_tbl)
    m = block_modes.long().clamp(0, mode_tbl.shape[0] - 1)
    m = m.repeat_interleave(res, 0).repeat_interleave(res, 1)
    return torch.gather(dmag_all, 0, m[None])[0], fill_flags[m]


def code_plane_plain(geo, block_modes, mode_tbl, res: int):
    """(H, W) int32 PLR codes: bit j - 1 set where the layer at D0 + j
    exists (dmag == j, or the fill flag and dmag > j)."""
    dmag, fill = mode_planes_plain(geo, block_modes, mode_tbl, res)
    code = torch.zeros_like(dmag)
    for j in range(1, N_LAYERS + 1):
        code = code | (((dmag == j) | (fill & (dmag > j))).to(torch.int32) << (j - 1))
    return code


def rdo_plain(geo0_dec, geo0_true, geo1_true, occ, btp, mode_tbl, res: int,
              block_threshold: int, p_max: int) -> Rdo:
    """Plain PyTorch version of kernel V's RDO (reference `rdo`).  geo
    planes (H, W) int32, occ (H, W) uint8 or bool decoded occupancy, btp
    (H/res, W/res) int32, mode_tbl (M, 4) int32.  The result on the host."""
    d = geo0_dec.device
    g0d, g0t, g1t = (t.to(torch.int64) for t in (geo0_dec, geo0_true, geo1_true))
    occ_b = occ != 0
    h, w = g0d.shape
    m = mode_tbl.shape[0]
    dmag_all, fill_flags = _per_mode_planes(geo0_dec, mode_tbl)
    ks = torch.arange(1, N_LAYERS + 1, device=d)[None, :, None, None]
    dm = dmag_all[:, None].long()
    valid_k = (ks == dm) | (fill_flags[:, None, None, None] & (ks < dm))   # (M,K,H,W)
    gen = g0d[None, None] + ks
    big = 1 << 20
    has_d1 = g1t != g0t

    def fwd(t):
        e0 = (t - g0d) ** 2
        ek = torch.where(valid_k, (t[None, None] - gen) ** 2, torch.full_like(gen, big))
        return torch.minimum(e0[None], ek.min(dim=1).values)

    fwd_err = fwd(g0t) + torch.where(has_d1, fwd(g1t), torch.zeros_like(g0t))
    src_cnt = (1 + has_d1.long()) * occ_b
    bwd = torch.minimum((gen - g0t[None, None]) ** 2, (gen - g1t[None, None]) ** 2)
    bwd_err = torch.where(valid_k, bwd, torch.zeros_like(bwd)).sum(1)
    gen_cnt = (1 + valid_k.long().sum(1)) * occ_b[None]
    nbh, nbw = h // res, w // res

    def bsum(x):  # exact block sums
        return x.reshape(x.shape[0], nbh, res, nbw, res).sum(dim=(2, 4))

    bfwd_i, bbwd_i = bsum(fwd_err * occ_b[None]), bsum(bwd_err * occ_b[None])
    inexact = int(((bfwd_i >= EXACT_LIMIT) | (bbwd_i >= EXACT_LIMIT)).any(0).sum())
    bfwd, bbwd = bfwd_i.to(torch.float32), bbwd_i.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=d)
    bsrc = torch.maximum(bsum(src_cnt[None]).to(torch.float32), one)    # (1, nbh, nbw)
    bgen = torch.maximum(bsum(gen_cnt).to(torch.float32), one)
    bcost = torch.maximum(bfwd / bsrc, bbwd / bgen)
    block_arg = torch.argmin(bcost, dim=0).to(torch.int32)              # first minimum

    # pooled per patch, block raster order
    pid = btp.reshape(-1).long()
    nb = pid.shape[0]
    cols = [x.reshape(x.shape[0], -1).T for x in (bfwd, bbwd, bgen, bsrc.expand_as(bfwd))]
    pools = [torch.zeros((p_max + 1, m), dtype=torch.float32, device=d) for _ in cols]
    # add each patch's r-th block for r = 0, 1, ...: sequential per patch,
    # in raster order (the pool of index 0, no patch, is never read)
    pcount = torch.bincount(pid, minlength=p_max + 1)
    owned = (pid > 0).nonzero()[:, 0]
    if owned.numel():
        po = pid[owned]
        order = torch.sort(po, stable=True).indices
        pc = torch.bincount(po, minlength=p_max + 1)
        rank = torch.empty_like(po)
        rank[order] = torch.arange(po.shape[0], device=d) - (torch.cumsum(pc, 0) - pc)[po[order]]
        by_rank = torch.sort(rank, stable=True).indices
        lo = 0
        for hi in torch.cumsum(torch.bincount(rank), 0).tolist():
            sel = owned[by_rank[lo:hi]]
            for pool, col in zip(pools, cols):
                pool[pid[sel]] = pool[pid[sel]] + col[sel]
            lo = hi
    pfwd, pbwd, pgen, psrc = pools
    pcost = torch.maximum(pfwd / torch.maximum(psrc, one), pbwd / torch.maximum(pgen, one))
    patch_modes = torch.argmin(pcost, dim=1).to(torch.int32)[1:]
    patch_level = pcount[1:] <= block_threshold
    inexact += int((patch_level & ((pfwd[1:] >= EXACT_LIMIT) | (pbwd[1:] >= EXACT_LIMIT))
                    .any(1)).sum())
    sel = (pid - 1).clamp(min=0)
    lvl_b = (pid > 0) & patch_level[sel]
    modes = torch.where(lvl_b, patch_modes[sel], block_arg.reshape(-1))
    block_modes = torch.where(pid > 0, modes, torch.zeros_like(modes)).reshape(nbh, nbw)
    return Rdo(block_modes.to(torch.int32).cpu(), patch_level.cpu(), patch_modes.cpu(), inexact)


# ---------------------------------------------------------------------------
# kernel V

_CODE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_RDO_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [
    ctypes.POINTER(ctypes.c_int)]


_PINNED: list = []


def _pinned(n: int):
    """(n int32 of page-locked host memory for the RDO's packed result, a
    numpy view of the whole buffer): one buffer, grown and never shrunk;
    the caller copies out of it."""
    if not _PINNED or _PINNED[0].numel() < n:
        buf = torch.empty(max(n, 1 << 14), dtype=torch.int32, pin_memory=True)
        _PINNED[:] = [buf, buf.numpy()]
    return _PINNED[0][:n], _PINNED[1]


def _check_table(mode_tbl, d):
    dev.check_tensor(mode_tbl, "mode_tbl", torch.int32, d, 2)
    if mode_tbl.shape[1] != 4 or not 1 <= mode_tbl.shape[0] <= 16:
        raise ValueError(f"plr: mode table {tuple(mode_tbl.shape)}")


def code_plane(geo, block_modes, mode_tbl, res: int):
    """Kernel V, code plane: `code_plane_plain` on the card, one thread per
    pixel.  geo (H, W) int32 decoded D0, block_modes (H/res, W/res) int32,
    mode_tbl (M, 4) int32."""
    if geo.device.type == "cpu":
        return code_plane_plain(geo, block_modes, mode_tbl, res)
    d = geo.device
    dev.check_tensor(geo, "geo", torch.int32, d, 2)
    dev.check_tensor(block_modes, "block_modes", torch.int32, d, 2)
    _check_table(mode_tbl, d)
    h, w = geo.shape
    if h % res or w % res or block_modes.shape != (h // res, w // res):
        raise ValueError(f"plr code plane: geo {tuple(geo.shape)}, modes "
                         f"{tuple(block_modes.shape)}, res {res}")
    out = torch.empty_like(geo)
    rc = dev.kernel_fn("plr", "plr_code", _CODE_ARGS)(
        dev.ptr(geo), dev.ptr(block_modes), dev.ptr(mode_tbl), mode_tbl.shape[0], h, w, res,
        dev.ptr(out), dev.stream_handle())
    dev.count_launch("plr", 1 if h * w else 0)
    dev.check_launch("plr", rc)
    return out


def rdo(geo0_dec, geo0_true, geo1_true, occ, btp, mode_tbl, res: int,
        block_threshold: int, p_max: int) -> Rdo:
    """Kernel V, RDO: `rdo_plain` on the card, its result on the host.  One
    launch gives each block a thread block, a thread a pixel, whose warps
    sum every mode's errors and counts exactly and pick the block's mode;
    a second gives each patch index (0 = none) a thread block, which lists
    its blocks in raster order, pools them sequentially along the list,
    picks the patch's mode and writes its blocks' final modes.  Block
    modes, patch levels, patch modes and the inexact count come back in
    one packed buffer, read once.  occ (H, W) uint8.  The launches count
    as the RDO entry's (`plr_rdo`)."""
    if geo0_dec.device.type == "cpu":
        return rdo_plain(geo0_dec, geo0_true, geo1_true, occ, btp, mode_tbl, res,
                         block_threshold, p_max)
    d = geo0_dec.device
    for name, t in (("geo0_dec", geo0_dec), ("geo0_true", geo0_true),
                    ("geo1_true", geo1_true)):
        dev.check_tensor(t, name, torch.int32, d, 2)
    dev.check_tensor(occ, "occ", torch.uint8, d, 2)
    dev.check_tensor(btp, "btp", torch.int32, d, 2)
    _check_table(mode_tbl, d)
    h, w = geo0_dec.shape
    if any(t.shape != (h, w) for t in (geo0_true, geo1_true, occ)) or h % res or w % res \
            or btp.shape != (h // res, w // res) or res * res > 1024:
        raise ValueError("plr rdo: inconsistent shapes")
    m = mode_tbl.shape[0]
    nbh, nbw = h // res, w // res
    nb = nbh * nbw
    n = 1 + nb + 2 * p_max
    scratch = dev.scratch("plr_rdo", d, nb * (3 * m + 3) + n)
    packed = scratch[nb * (3 * m + 3):]
    launched = ctypes.c_int(0)
    # pointers as ints (ctypes converts them for the c_void_p arguments)
    rc = dev.kernel_fn("plr", "plr_rdo", _RDO_ARGS)(
        geo0_dec.data_ptr(), geo0_true.data_ptr(), geo1_true.data_ptr(), occ.data_ptr(),
        btp.data_ptr(), mode_tbl.data_ptr(), m, h, w, res, int(block_threshold), p_max,
        scratch.data_ptr(), packed.data_ptr(), dev.stream_handle(), ctypes.byref(launched))
    dev.count_launch("plr_rdo", launched.value)
    dev.check_launch("plr", rc)
    pinned, view = _pinned(n)
    pinned.copy_(packed[:n])   # the one host read: waits for the two launches
    host = view[:n].copy()
    return Rdo(torch.from_numpy(host[1:1 + nb].reshape(nbh, nbw)),
               torch.from_numpy(host[1 + nb:1 + nb + p_max] != 0),
               torch.from_numpy(host[1 + nb + p_max:]), int(host[0]))


# ---------------------------------------------------------------------------
# host code: the patches' PLR syntax

def upsample_modes(block_modes, res: int):
    """(nbH, nbW) int32 -> (nbH*res, nbW*res) by block repetition."""
    return np.repeat(np.repeat(np.asarray(block_modes), res, 0), res, 1)


def assign_patch_plr(patches: List, block_modes: np.ndarray, btp: np.ndarray,
                     patch_level: np.ndarray, patch_modes: np.ndarray) -> None:
    """Attach the PLR syntax elements to each Patch: level flag, patch mode
    and (level 0) the per-block mode list in patch-space raster order
    (reference setPLRData, PCCEncoder.cpp:7886-7925)."""
    from vpcc_tpu_torch.core.atlas import _block_to_canvas

    for i, p in enumerate(patches):
        p.plr_level = int(patch_level[i]) if i < len(patch_level) else 1
        p.plr_mode = int(patch_modes[i]) if i < len(patch_modes) else 0
        if p.plr_level:
            p.plr_block_modes = None
            continue
        bu, bv = np.meshgrid(np.arange(p.size_u0), np.arange(p.size_v0))
        bx, by = _block_to_canvas(p, bu.ravel(), bv.ravel())
        owned = btp[by, bx] == (i + 1)
        p.plr_block_modes = np.where(owned, block_modes[by, bx], 0).astype(np.int32)


def block_modes_from_patches(patches: List, btp: np.ndarray, nbh: int, nbw: int) -> np.ndarray:
    """Decoder side of assign_patch_plr: the canvas block-mode map (later
    patches overwrite, like block-to-patch)."""
    from vpcc_tpu_torch.core.atlas import _block_to_canvas

    out = np.zeros((nbh, nbw), np.int32)
    for i, p in enumerate(patches):
        bu, bv = np.meshgrid(np.arange(p.size_u0), np.arange(p.size_v0))
        bx, by = _block_to_canvas(p, bu.ravel(), bv.ravel())
        owned = btp[by, bx] == (i + 1)
        if getattr(p, "plr_level", 1):
            out[by[owned], bx[owned]] = getattr(p, "plr_mode", 0)
        elif getattr(p, "plr_block_modes", None) is not None:
            modes = np.asarray(p.plr_block_modes, np.int32).ravel()
            sel = owned & (modes[: len(owned)] > 0)
            out[by[sel], bx[sel]] = modes[: len(owned)][sel]
    return out
