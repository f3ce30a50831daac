"""PBF, patch border filtering of the decoded occupancy (kernel U).

Behavioral reference: `PatchBlockFiltering::patchBorderFiltering`
(source/lib/PccLibCommon/source/PCCPatch.cpp:851-976), driven from
`PCCCodec::generatePointCloud` (PCCCodec.cpp:543-556), as the JAX package
computes it on the canvas (vpcc_tpu/ops/pbf.py `count_border`,
`pbf_filter_occupancy`):
1. border pixels: occupied pixels of a patch with an empty or foreign cell
   in the 12-cell cross + diagonal neighbourhood (neighbours outside the
   canvas count as empty);
2. each border pixel of a non-45-degree patch becomes its D0 point; every
   other patch's projection of it lands on a pixel of that patch, where the
   key (|depth - pixel depth| << 12) | depth of the nearest such projection
   within threshold = log2Threshold^2 is kept (a scatter-min);
3. `passes` filter passes: a pixel with 4 occupied same-patch 4-neighbours
   stays, one with none goes, and a pixel in between stays when no
   neighbour projection lies in its oriented window or the window's summed
   3D distance to its one-step-eroded position is at least that to the
   pixel itself.
The reference's documented deviation (the per-patch maps' margin, see
vpcc_tpu/ops/pbf.py:31-36) and its defect (LOD scaling is ignored: the
patch (u, v) of a border pixel is not scaled by the patch's LOD, ROADMAP
F3) are kept for parity.

Kernel U (csrc/pbf.cu) has three entries: the border stencil (count and
compaction of the border pixels), the (border point x patch) projections
(an integer atomicMin: exact and order-free) and one launch per filter
pass.  The float32 window sums add correctly rounded square roots of exact
integers in the reference's window order, so they are exact too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vpcc_tpu_torch import device as dev
from vpcc_tpu_torch.ops.reconstruct import (
    _AXIS45, _BA, _D1, _MODE, _NA, _OR, _SU0, _SV0, _TA, _U0, _U1, _V0, _V1,
    _canvas_to_patch_uv,
)

# boundary-orientation lookup (index = 8-neighbourhood occupancy byte;
# reference g_orientation, PCCPatch.cpp:40-47)
G_ORIENTATION = np.array([
    0, 0, 6, 0, 0, 0, 0, 6, 4, 0, 0, 5, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 7, 7,
    0, 0, 0, 0, 0, 0, 0, 6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, 5, 0, 0, 0, 5,
    0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0, 5, 2, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 4, 3, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 7, 7, 0, 0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 7,
    0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 3, 0, 0, 0, 4,
    1, 0, 0, 0, 1, 0, 1, 0, 2, 3, 0, 0, 1, 2, 0, 0,
], np.int32)

# unit dilation steps per orientation (x, y) (reference g_dilate)
G_DILATE = np.array(
    [[1, 0], [1, 1], [0, 1], [-1, 1], [-1, 0], [-1, -1], [0, -1], [1, -1]],
    np.int32,
)

UNDEF = 1 << 29     # no neighbour projection (scatter-min initial key)
DSHIFT = 12         # depth payload bits of the key
# the 12-cell border neighbourhood (PCCPatch.cpp:858-864) and the
# 8-neighbourhood byte's cells, bit 7 first (OCC macro: tl t tr l r bl b br)
OFFS12 = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2), (2, 0), (-2, 0),
          (1, 1), (1, -1), (-1, 1), (-1, -1))
OFFS8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def pbf_passes(cfg) -> int:
    """Auto pass count (reference PCCEncoderParameters.cpp:1129)."""
    if cfg.pbfPassesCount:
        return int(cfg.pbfPassesCount)
    p = cfg.occupancyPrecision
    return 1 if p <= 2 else (2 if p == 4 else 4)


def pbf_filter_size(cfg) -> int:
    """Auto filter size (reference PCCEncoderParameters.cpp:1130)."""
    return int(cfg.pbfFilterSize or cfg.occupancyPrecision)


def _forward_uv_to_canvas(u, v, su, sv, orient):
    """patch (u, v) -> canvas-local (x, y) (reference PCCPatch.cpp:192-251;
    the inverse of ops/reconstruct._canvas_to_patch_uv)."""
    cases = ((u, v), (v, u), (sv - 1 - v, u), (su - 1 - u, sv - 1 - v),
             (v, su - 1 - u), (su - 1 - u, v), (sv - 1 - v, su - 1 - u),
             (u, sv - 1 - v))
    x, y = u, v
    for i, (cx, cy) in enumerate(cases):
        x = torch.where(orient == i, cx, x)
        y = torch.where(orient == i, cy, y)
    return x, y


def _window(filter_size: int):
    fs_v = filter_size >> 1
    return [(i, j) for i in range(-filter_size, filter_size + 1)
            for j in range(-fs_v, fs_v + 1)]


# ---------------------------------------------------------------------------
# plain versions

def _shift(a, dy: int, dx: int, fill):
    """out[y, x] = a[y - dy, x - dx], `fill` outside."""
    h, w = a.shape
    out = torch.full_like(a, fill)
    ys, ye = max(dy, 0), h + min(dy, 0)
    xs, xe = max(dx, 0), w + min(dx, 0)
    if ys < ye and xs < xe:
        out[ys:ye, xs:xe] = a[ys - dy:ye - dy, xs - dx:xe - dx]
    return out


def _pixel_patch(occ, btp, res: int):
    pid = btp.repeat_interleave(res, 0).repeat_interleave(res, 1) - 1
    return pid, (occ != 0) & (pid >= 0)


def _neighbour(cur, pid, dy: int, dx: int):
    """Same-patch occupied neighbour at (y + dy, x + dx)."""
    return _shift(cur, -dy, -dx, False) & (_shift(pid, -dy, -dx, -2) == pid)


def _border(occp, pid):
    full = torch.ones_like(occp)
    for dy, dx in OFFS12:
        full = full & _neighbour(occp, pid, dy, dx)
    return occp & ~full


def count_border_plain(occ, btp, res: int) -> int:
    """Number of patch-border pixels (reference `count_border`)."""
    pid, occp = _pixel_patch(occ, btp, res)
    return int(_border(occp, pid).sum())


def pbf_filter_occupancy_plain(occ, geo0, btp, patch_tbl, res: int, passes: int = 2,
                               filter_size: int = 4, threshold: int = 4,
                               chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of kernel U.  occ (H, W) uint8 or bool, geo0
    (H, W) int32 decoded D0, btp (H/res, W/res) int32 (0 = none), patch_tbl
    (P, >= 13) int32 (core/atlas.py PATCH_FIELDS).  Returns the filtered
    (H, W) bool occupancy.  Every border point is projected (the
    reference's bucket holds them all)."""
    d = occ.device
    h, w = occ.shape
    ys = torch.arange(h, device=d, dtype=torch.int32)[:, None].expand(h, w)
    xs = torch.arange(w, device=d, dtype=torch.int32)[None, :].expand(h, w)
    pid, occp = _pixel_patch(occ, btp, res)
    border = _border(occp, pid)

    # border pixel -> 3D point (D0, non-45-degree patches)
    prm = patch_tbl[pid.clamp(min=0).long()]
    col = lambda k: prm[..., k]
    dabs = torch.where(col(_MODE) == 0, col(_D1) + geo0, (col(_D1) - geo0).clamp(min=0))
    uu, vv = _canvas_to_patch_uv(xs - col(_U0) * res, ys - col(_V0) * res,
                                 col(_SU0) * res, col(_SV0) * res, col(_OR))
    vals = (dabs, uu + col(_U1), vv + col(_V1))
    axes = (col(_NA), col(_TA), col(_BA))
    world = torch.stack([sum(torch.where(axes[k] == c, vals[k], torch.zeros_like(dabs))
                             for k in range(3)) for c in range(3)], -1)
    sel = (border & (col(_AXIS45) == 0)).reshape(-1).nonzero()[:, 0]
    bpos = world.reshape(-1, 3)[sel]
    bpid = pid.reshape(-1)[sel]

    # neighbour depth: every (border point, patch) projection, scatter-min
    dmap = torch.where(occp, geo0, torch.zeros_like(geo0))
    dflat = dmap.reshape(-1)
    btp_flat = btp.reshape(-1)
    bw = btp.shape[1]
    tb = patch_tbl
    P = tb.shape[0]
    pids = torch.arange(P, device=d, dtype=torch.int32)[None, :]
    psu, psv = (tb[:, _SU0] * res)[None, :], (tb[:, _SV0] * res)[None, :]
    nd_key = torch.full((h * w + 1,), UNDEF, dtype=torch.int32, device=d)
    for c0 in range(0, bpos.shape[0], chunk):
        cpos, cpid = bpos[c0:c0 + chunk], bpid[c0:c0 + chunk]
        comp = lambda ax: torch.gather(cpos, 1, ax[None, :].expand(cpos.shape[0], P).long())
        pd1 = tb[:, _D1][None, :]
        dd = torch.where(tb[:, _MODE][None, :] == 0, comp(tb[:, _NA]) - pd1,
                         pd1 - comp(tb[:, _NA]))
        pu = comp(tb[:, _TA]) - tb[:, _U1][None, :]
        pv = comp(tb[:, _BA]) - tb[:, _V1][None, :]
        lx, ly = _forward_uv_to_canvas(pu, pv, psu, psv, tb[:, _OR][None, :])
        px = lx + (tb[:, _U0] * res)[None, :]
        py = ly + (tb[:, _V0] * res)[None, :]
        pxc, pyc = px.clamp(0, w - 1), py.clamp(0, h - 1)
        diff = (dd - dflat[(pyc * w + pxc).long()]).abs()
        ok = ((cpid[:, None] != pids) & (tb[:, _SU0][None, :] > 0)
              & (tb[:, _AXIS45][None, :] == 0)
              & (pu >= 0) & (pu < psu) & (pv >= 0) & (pv < psv)
              & (dd >= 0) & (dd < (1 << DSHIFT))
              & (btp_flat[((pyc // res) * bw + pxc // res).long()] - 1 == pids)
              & (diff <= threshold))
        flat = (py * w + px).long()
        flat = torch.where(ok & (flat >= 0) & (flat < h * w), flat, torch.full_like(flat, h * w))
        key = (diff << DSHIFT) | dd
        nd_key.scatter_reduce_(0, flat.reshape(-1), key.reshape(-1), "amin")
    nd_key = nd_key[:h * w]
    nd = torch.where(nd_key >= UNDEF, torch.full_like(nd_key, -(1 << 20)),
                     nd_key & ((1 << DSHIFT) - 1))

    # oriented filter passes
    g_or = torch.as_tensor(G_ORIENTATION, device=d)
    gdx = torch.as_tensor(G_DILATE, device=d)
    gdy = torch.as_tensor(G_DILATE[(np.arange(8) + 2) % 8], device=d)
    dP = dmap.to(torch.float32)
    zero = torch.zeros((h, w), dtype=torch.float32, device=d)
    cur = occp
    for _ in range(passes):
        n4 = sum(_neighbour(cur, pid, dy, dx).to(torch.int32)
                 for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)))
        pat = torch.zeros((h, w), dtype=torch.int32, device=d)
        for bit, (dy, dx) in zip(range(7, -1, -1), OFFS8):
            pat = pat | (_neighbour(cur, pid, dy, dx).to(torch.int32) << bit)
        o = g_or[pat.long()].long()
        dx0, dx1 = gdx[o][..., 0], gdx[o][..., 1]
        dy0, dy1 = gdy[o][..., 0], gdy[o][..., 1]
        ex, ey = (xs - dx0).clamp(0, w - 1), (ys - dx1).clamp(0, h - 1)
        dE = dflat[(ey * w + ex).long()].to(torch.float32)
        sum_p, sum_e = zero.clone(), zero.clone()
        cnt = torch.zeros((h, w), dtype=torch.int32, device=d)
        for i, j in _window(filter_size):
            du = i * dx0 + j * dy0
            dv = i * dx1 + j * dy1
            xx, yy = xs + du, ys + dv
            inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = nd[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()]
            m = inb & (v >= 0)
            duf, dvf, vf = du.to(torch.float32), dv.to(torch.float32), v.to(torch.float32)
            sum_p = sum_p + torch.where(
                m, torch.sqrt(duf * duf + dvf * dvf + (vf - dP) * (vf - dP)), zero)
            ax, ay, az = duf + dx0.to(torch.float32), dvf + dx1.to(torch.float32), vf - dE
            sum_e = sum_e + torch.where(m, torch.sqrt(ax * ax + ay * ay + az * az), zero)
            cnt = cnt + m.to(torch.int32)
        keep = (cnt == 0) | (sum_e >= sum_p)
        cur = cur & ((n4 == 4) | ((n4 > 0) & keep))
    return cur


# ---------------------------------------------------------------------------
# kernel U

_BORDER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
_PROJECT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
_PASS_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _fn(name: str, args):
    fn = getattr(dev.load_kernel("pbf"), name)
    fn.argtypes, fn.restype = args, ctypes.c_int
    return fn


def _check(occ, btp, res: int, geo0=None, patch_tbl=None):
    d = occ.device
    dev.check_tensor(occ, "occ", torch.uint8, d, 2)
    dev.check_tensor(btp, "btp", torch.int32, d, 2)
    h, w = occ.shape
    if h % res or w % res or btp.shape != (h // res, w // res):
        raise ValueError(f"pbf: occ {tuple(occ.shape)}, btp {tuple(btp.shape)}, res {res}")
    if geo0 is not None:
        dev.check_tensor(geo0, "geo0", torch.int32, d, 2)
        dev.check_tensor(patch_tbl, "patch_tbl", torch.int32, d, 2)
        if geo0.shape != (h, w) or patch_tbl.shape[1] != 16:
            raise ValueError(f"pbf: geo0 {tuple(geo0.shape)}, patch_tbl {tuple(patch_tbl.shape)}")


def _border_launch(occ, btp, res: int, geo0=None, tbl=None):
    """Entry 1: the stencil.  Returns (counts (2,) int32 on the device:
    border pixels, compacted border points; the compacted pixel indices,
    the (H, W) int32 depth map, the (H, W) uint8 occupied-in-a-patch
    plane), the last three None without geo0."""
    d = occ.device
    h, w = occ.shape
    counts = torch.zeros(2, dtype=torch.int32, device=d)
    null = ctypes.c_void_p(0)
    lst = dmap = cur = None
    if geo0 is not None:
        lst = torch.empty(h * w, dtype=torch.int32, device=d)
        dmap = torch.empty((h, w), dtype=torch.int32, device=d)
        cur = torch.empty((h, w), dtype=torch.uint8, device=d)
    p = lambda t: null if t is None else dev.ptr(t)
    rc = _fn("pbf_border", _BORDER_ARGS)(
        dev.ptr(occ), dev.ptr(btp), p(geo0), h, w, res,
        0 if tbl is None else tbl.shape[0], p(tbl), dev.ptr(counts), p(lst), p(dmap), p(cur),
        dev.stream_handle())
    dev.count_launch("pbf", 1 if h * w else 0)
    dev.check_launch("pbf", rc)
    return counts, lst, dmap, cur


def count_border(occ, btp, res: int) -> int:
    """Kernel U, stencil entry: `count_border_plain` on the card (one
    scalar read back)."""
    if occ.device.type == "cpu":
        return count_border_plain(occ, btp, res)
    _check(occ, btp, res)
    return int(_border_launch(occ, btp, res)[0][0])


def pbf_filter_occupancy(occ, geo0, btp, patch_tbl, res: int, passes: int = 2,
                         filter_size: int = 4, threshold: int = 4) -> torch.Tensor:
    """Kernel U (csrc/pbf.cu): `pbf_filter_occupancy_plain` on the card.
    The stencil entry counts and compacts the border points (the count is
    read back to size the next launch, as the reference reads it to size
    its bucket), the projection entry runs one thread per (border point,
    patch) pair, then one launch per filter pass.  occ (H, W) uint8."""
    if occ.device.type == "cpu":
        return pbf_filter_occupancy_plain(occ, geo0, btp, patch_tbl, res, passes,
                                          filter_size, threshold)
    _check(occ, btp, res, geo0, patch_tbl)
    d = occ.device
    h, w = occ.shape
    counts, lst, dmap, cur = _border_launch(occ, btp, res, geo0, patch_tbl)
    if h * w == 0:
        return cur.bool()
    n_pts = int(counts[1])
    P = patch_tbl.shape[0]
    nd_key = torch.full((h, w), UNDEF, dtype=torch.int32, device=d)
    if n_pts and P:
        rc = _fn("pbf_project", _PROJECT_ARGS)(
            dev.ptr(lst), dev.ptr(geo0), dev.ptr(btp), dev.ptr(patch_tbl), dev.ptr(dmap),
            n_pts, P, h, w, res, int(threshold), dev.ptr(nd_key), dev.stream_handle())
        dev.count_launch("pbf")
        dev.check_launch("pbf", rc)
    nxt = torch.empty_like(cur)
    fn = _fn("pbf_pass", _PASS_ARGS)
    for _ in range(passes):
        rc = fn(dev.ptr(cur), dev.ptr(btp), dev.ptr(dmap), dev.ptr(nd_key), dev.ptr(nxt),
                h, w, res, int(filter_size), dev.stream_handle())
        dev.count_launch("pbf")
        dev.check_launch("pbf", rc)
        cur, nxt = nxt, cur
    return cur.bool()
