"""Connected components over the same-partition k-NN graph (K5, kernel G).

Behavioral reference: `vpcc_tpu/ops/cc.py` (the reference's BFS flood fill
over k-NN adjacency restricted to equal partitions, discarding components
below minPointCountPerCC, PCCPatchSegmenter.cpp:804-841).  Label = the
minimum active index in each component, which is unique: kernel G's
union-find, the plain scatter-min propagation below and the reference all
give the same labels.

The port keeps exact sizes: the inactive sentinel is the row count V (the
reference's voxel capacity), and `cc_round_voxel_compact` labels the
active subgraph in place instead of compacting it.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from vpcc_tpu_torch import device as dev


def cc_labels_plain(nn_idx, nn_valid, partition, active):
    """Plain PyTorch version of kernel G: the reference's scatter-min
    hooking + pointer jumping until nothing changes (cc.py:48-92)."""
    n = nn_idx.shape[0]
    d = nn_idx.device
    idx = torch.arange(n, dtype=torch.int64, device=d)
    nb_idx = nn_idx.long()
    edge_ok = (nn_valid & active[:, None] & active[nb_idx]
               & (partition[:, None] == partition[nb_idx]))
    tgt = torch.where(edge_ok, nb_idx, idx[:, None])
    sentinel = torch.full_like(idx, n)
    lab = torch.where(active, idx, sentinel)
    while True:
        nb = lab[tgt]
        m = torch.minimum(lab, torch.where(edge_ok, nb, n).min(1).values)
        safe = lab.clamp(max=n - 1)
        new = m.scatter_reduce(0, safe, torch.where(active, m, sentinel), "amin")
        push = torch.where(edge_ok, m[:, None], n).reshape(-1)
        new = new.scatter_reduce(0, nb.clamp(max=n - 1).reshape(-1), push, "amin")
        new = torch.where(active, new, sentinel)
        for _ in range(10):
            new = torch.where(new >= n, new, torch.minimum(new, new[new.clamp(max=n - 1)]))
        if torch.equal(new, lab):
            return lab.to(torch.int32)
        lab = new


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def cc_labels_device(nn_idx, nn_valid, partition, active):
    """(V,) int32 label per row = min active index of its component;
    inactive rows get V.  Kernel G on CUDA; the plain version for a CPU
    tensor."""
    if nn_idx.device.type == "cpu":
        return cc_labels_plain(nn_idx, nn_valid, partition, active)
    d = nn_idx.device
    V, K = nn_idx.shape
    dev.check_tensor(nn_idx, "nn_idx", torch.int32, d, 2)
    dev.check_tensor(nn_valid, "nn_valid", torch.bool, d, 2)
    dev.check_tensor(partition, "partition", torch.int32, d, 1)
    dev.check_tensor(active, "active", torch.bool, d, 1)
    parent = torch.empty(V, dtype=torch.int32, device=d)
    labels = torch.empty(V, dtype=torch.int32, device=d)
    fn = dev.kernel_fn("cc_labels", "cc_labels", _ARGS)
    rc = fn(nn_idx.data_ptr(), nn_valid.data_ptr(), partition.data_ptr(), active.data_ptr(),
            V, K, V, parent.data_ptr(), labels.data_ptr(), dev.stream_handle())
    dev.count_launch("cc_labels", (3 if K else 2) if V else 0)
    dev.check_launch("cc_labels", rc)
    return labels


def round_stats(cov_sel, cov_det, point_vox, valid_pt, vcap: int):
    """Per-round bookkeeping (reference cc.py:179-190): seeds per point,
    the active-voxel scatter-OR, and the active-voxel count."""
    act_point = ~cov_sel & valid_pt
    act_vox = torch.zeros(vcap, dtype=torch.bool, device=cov_sel.device)
    act_vox[point_vox.long().clamp(0, vcap - 1)[act_point]] = True
    seeds = ~cov_det & valid_pt
    return seeds, act_vox, int(act_vox.sum())


def cc_round_voxel_compact(nn_idx, nn_valid, partition, act_vox):
    """Components restricted to the active voxels (reference cc.py:193-221).
    Returns (sub_vox, labels): the active voxel ids in increasing order and
    their labels in the original id space (min active voxel id of the
    component).  The reference compacts the active subgraph first; since
    `sub_vox` increases, the minimum compact id maps to the minimum original
    id, so labelling the full graph under the active mask gives the same
    pair."""
    lab = cc_labels_device(nn_idx, nn_valid, partition, act_vox)
    sub_vox = torch.nonzero(act_vox)[:, 0].to(torch.int32)
    return sub_vox, lab[sub_vox.long()]


def _round_voxel(labels_fn, nn_idx, nn_valid, partition, point_vox, act_point):
    vcap = nn_idx.shape[0]
    pv = point_vox.long().clamp(0, vcap - 1)
    act_vox = torch.zeros(vcap, dtype=torch.uint8, device=nn_idx.device)
    act_vox = act_vox.scatter_reduce(0, pv, act_point.to(torch.uint8), "amax")
    return labels_fn(nn_idx, nn_valid, partition, act_vox.bool())[pv]


def cc_round_voxel(nn_idx, nn_valid, partition, point_vox, act_point):
    """One patch-generation round on the full voxel graph (reference
    cc.py:224-235, the vox11 path): the per-point active mask scatter-ORed
    to the voxels, components of the active voxels (kernel G on CUDA), and
    each point's voxel label.  Returns (N,) int32; inactive -> V."""
    return _round_voxel(cc_labels_device, nn_idx, nn_valid, partition, point_vox, act_point)


def cc_round_voxel_plain(nn_idx, nn_valid, partition, point_vox, act_point):
    """`cc_round_voxel` with the plain version of kernel G on any device."""
    return _round_voxel(cc_labels_plain, nn_idx, nn_valid, partition, point_vox, act_point)


def components_from_labels(
    labels: np.ndarray,   # (N,) int32 from cc_labels_device
    seeds: np.ndarray,    # (N,) bool
    min_size: int,
    sentinel: "int | None" = None,
) -> List[np.ndarray]:
    """Group labeled points into components >= min_size containing a seed,
    sorted descending by size (host numpy; a copy of the reference's)."""
    n = labels.shape[0]
    act = labels < (n if sentinel is None else sentinel)
    uniq, inv = np.unique(labels[act], return_inverse=True)
    sizes = np.bincount(inv, minlength=len(uniq))
    has_seed = np.zeros(len(uniq), bool)
    np.logical_or.at(has_seed, inv, seeds[act])
    keep = np.nonzero((sizes >= min_size) & has_seed)[0]
    order = keep[np.argsort(-sizes[keep], kind="stable")]
    comp_of = np.full(len(uniq), -1, np.int64)
    comp_of[order] = np.arange(len(order))
    pt_idx = np.nonzero(act)[0]
    pt_comp = comp_of[inv]
    sel = pt_comp >= 0
    pt_idx, pt_comp = pt_idx[sel], pt_comp[sel]
    srt = np.argsort(pt_comp, kind="stable")
    pt_idx, pt_comp = pt_idx[srt], pt_comp[srt]
    bounds = np.searchsorted(pt_comp, np.arange(len(order) + 1))
    return [pt_idx[bounds[i]: bounds[i + 1]] for i in range(len(order))]
