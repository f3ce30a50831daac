"""Voxel-grid nearest-neighbour search (K4; kernel E for the query).

Behavioral reference: `vpcc_tpu/ops/neighbors.py` (the KD-tree replacement
of the reference's nanoflann queries, PCCKdTree.h:85).  Points are binned
into a dense table of cells (4^3 voxels up to 10-bit grids, 2^(bits-8)
voxels an axis beyond: one stable sort + one count); each query scans the
3x3x3 neighbouring cells as 9 runs of 3 z-contiguous cells, at most
`3 * bucket` candidates per run, and keeps the k nearest, ties to the
earlier candidate.

The sorted coordinates are packed into one int32 word (10 bits an axis) up
to 10-bit grids and kept as (N, 3) int32 rows beyond (vox11), as the
reference's `_build` does.  The grid build is plain PyTorch on every device,
as the reference leaves it to a library sort: `torch.sort(stable=True)`
gives `jnp.argsort`'s order.  The query is kernel E (csrc/grid_knn.cu, one
entry per table layout) on CUDA and `knn_plain` on the CPU.

The level-batched GOF path (`parallel/gof.py`, reference
`parallel/gof.py` `_knn_fwd_batch` / `_nearest_bwd_batch`) queries B
frames at once: `build_grid_batch` builds the B packed grids of (B, N, 3)
point sets in one stable sort (rows padded out of the grid, at -2^20, fall
to the end of their frame and are never candidates), and `knn_batch` runs
kernel E's `grid_knn_batch` entry, one launch for every frame, each query
reading its own frame's grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from vpcc_tpu_torch import device as dev

MAX_DIST2 = 0x7FFFFFF0

_OFFSETS9 = np.array(
    [[dx, dy] for dx in (-1, 0, 1) for dy in (-1, 0, 1)], np.int32
)  # (9, 2) — the xy offsets; z is covered by the 3-cell contiguous window


@dataclasses.dataclass(frozen=True)
class NeighborGrid:
    """Dense cell table over a voxel grid.

    order:  (N,) int32 — point indices sorted by cell id (stable).
    starts: (G^3 + 1,) int32 — exclusive prefix offsets into `order` per
            cell; starts[G^3] == number of in-grid points.
    table:  (N,) int32 packed sorted coordinates (grid_bits <= 10), else
            (N, 3) int32 sorted coordinates.
    """

    order: torch.Tensor
    starts: torch.Tensor
    table: torch.Tensor
    grid_bits: int
    cell_bits: int

    @property
    def cells_per_axis(self) -> int:
        return 1 << (self.grid_bits - self.cell_bits)

    @property
    def packed(self) -> bool:
        return self.table.ndim == 1


def default_cell_bits(grid_bits: int) -> int:
    """4^3-voxel cells up to 10-bit grids; coarser beyond."""
    return max(2, grid_bits - 8)


def _cell_ids(positions: torch.Tensor, grid_bits: int, cell_bits: int) -> torch.Tensor:
    """Linear cell id per point; out-of-grid points -> G^3 (they sort to the
    end of `order` and are never inside a valid cell window)."""
    g = 1 << (grid_bits - cell_bits)
    c = (positions >> cell_bits).long()
    in_grid = ((positions >= 0) & (positions < (1 << grid_bits))).all(-1)
    cid = (c[:, 0] * g + c[:, 1]) * g + c[:, 2]
    return torch.where(in_grid, cid, torch.full_like(cid, g * g * g))


def build_grid(positions: torch.Tensor, grid_bits: int, cell_bits: int | None = None) -> NeighborGrid:
    """positions (N, 3) int32 -> the grid (reference `_build`,
    neighbors.py:86-106): packed table up to 10 bits, unpacked beyond."""
    if cell_bits is None:
        cell_bits = default_cell_bits(grid_bits)
    g = 1 << (grid_bits - cell_bits)
    n_cells = g * g * g + 1
    cid = _cell_ids(positions, grid_bits, cell_bits)
    order = torch.sort(cid, stable=True).indices
    # index_add_, not bincount: bincount reads the ids' extent on the host
    counts = torch.zeros(n_cells, dtype=torch.int64, device=positions.device).index_add_(
        0, cid, torch.ones_like(cid))
    starts = torch.zeros(n_cells, dtype=torch.int64, device=positions.device)
    starts[1:] = torch.cumsum(counts, 0)[:-1]
    b = grid_bits
    p = positions.to(torch.int32)
    if b <= 10:
        table = ((p[:, 0] << (2 * b)) | (p[:, 1] << b) | p[:, 2])[order]
    else:
        table = p[order]
    return NeighborGrid(order=order.to(torch.int32), starts=starts.to(torch.int32),
                        table=table.contiguous(), grid_bits=grid_bits,
                        cell_bits=cell_bits)


@dataclasses.dataclass(frozen=True)
class NeighborGridBatch:
    """B packed grids of equal sizes, frame b in row b: order (B, N) int32
    (indices within the frame), starts (B, G^3 + 1) int32, table (B, N)
    int32."""

    order: torch.Tensor
    starts: torch.Tensor
    table: torch.Tensor
    grid_bits: int
    cell_bits: int

    def frame(self, b: int) -> NeighborGrid:
        return NeighborGrid(self.order[b], self.starts[b], self.table[b], self.grid_bits,
                            self.cell_bits)


def build_grid_batch(positions: torch.Tensor, grid_bits: int) -> NeighborGridBatch:
    """positions (B, N, 3) int32 -> B packed grids, each equal to
    `build_grid(positions[b])` (grid_bits <= 10): one stable sort of the
    frame-offset cell ids, one count."""
    if grid_bits > 10:
        raise ValueError("build_grid_batch: packed tables need grid_bits <= 10")
    B, N, _ = positions.shape
    cell_bits = default_cell_bits(grid_bits)
    g = 1 << (grid_bits - cell_bits)
    n_cells = g * g * g + 1
    d = positions.device
    cid = _cell_ids(positions.reshape(-1, 3), grid_bits, cell_bits).view(B, N)
    key = cid + torch.arange(B, device=d)[:, None] * n_cells
    order = torch.sort(key.flatten(), stable=True).indices.view(B, N)
    counts = torch.zeros(B * n_cells, dtype=torch.int64, device=d).index_add_(
        0, key.flatten(), torch.ones_like(key.flatten())).view(B, n_cells)
    starts = torch.cumsum(counts, 1) - counts
    order = order - torch.arange(B, device=d)[:, None] * N
    b = grid_bits
    p = positions.to(torch.int32)
    packed = (p[..., 0] << (2 * b)) | (p[..., 1] << b) | p[..., 2]
    table = torch.gather(packed, 1, order)
    return NeighborGridBatch(order.to(torch.int32).contiguous(),
                             starts.to(torch.int32).contiguous(), table.contiguous(),
                             grid_bits, cell_bits)


def _knn_chunk_plain(grid: NeighborGrid, q: torch.Tensor, k: int, win: int):
    d = q.device
    g = grid.cells_per_axis
    m = q.shape[0]
    qc = q >> grid.cell_bits
    off = torch.as_tensor(_OFFSETS9, device=d)
    ncx = qc[:, 0:1] + off[None, :, 0]  # (M, 9)
    ncy = qc[:, 1:2] + off[None, :, 1]
    zlo = (qc[:, 2:3] - 1).clamp(min=0)
    zhi = (qc[:, 2:3] + 1).clamp(max=g - 1)
    ok = ((ncx >= 0) & (ncx < g) & (ncy >= 0) & (ncy < g)
          & (qc[:, 2:3] >= 0) & (qc[:, 2:3] < g))
    base = (ncx.long() * g + ncy) * g
    sentinel = g * g * g  # starts[sentinel] == n_in_grid; e == s -> no slot
    clo = torch.where(ok, base + zlo, torch.full_like(base, sentinel))
    chi1 = torch.where(ok, base + zhi + 1, torch.full_like(base, sentinel))
    starts = grid.starts.long()
    s = starts[clo]
    cnt = (starts[chi1] - s).clamp(0, win)                     # (M, 9)
    lane = torch.arange(win, device=d)
    valid = (lane[None, None, :] < cnt[:, :, None]).reshape(m, 9 * win)
    slot = (s[:, :, None] + lane[None, None, :]).reshape(m, 9 * win)
    slot = torch.where(valid, slot, torch.zeros_like(slot))
    if grid.packed:
        pk = grid.table[slot]
        b = grid.grid_bits
        mask = (1 << b) - 1
        px, py, pz = pk >> (2 * b), (pk >> b) & mask, pk & mask
    else:
        px, py, pz = (grid.table[:, j][slot] for j in range(3))
    dx = px - q[:, 0:1]
    dy = py - q[:, 1:2]
    dz = pz - q[:, 2:3]
    d2 = torch.where(valid, dx * dx + dy * dy + dz * dz,
                     torch.full_like(dx, MAX_DIST2))
    # top-k by (d2, candidate position): the keys are unique, so the
    # selection and its order are those of lax.top_k's lower-index-first ties
    c = 9 * win
    key = d2.long() * c + torch.arange(c, device=d)[None, :]
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    pos = top % c
    d2_k = (top // c).to(torch.int32)
    idx = grid.order[torch.gather(slot, 1, pos)]
    return torch.where(d2_k < MAX_DIST2, idx, torch.zeros_like(idx)), d2_k


def knn_plain(grid: NeighborGrid, queries: torch.Tensor, k: int, bucket: int = 16,
              chunk: int = 1 << 15) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel E: the reference's candidate buffer
    and top-k, in query chunks of `chunk` rows."""
    win = 3 * bucket
    outs = [_knn_chunk_plain(grid, queries[i:i + chunk], k, win)
            for i in range(0, queries.shape[0], chunk)]
    if not outs:
        e = torch.zeros((0, k), dtype=torch.int32, device=queries.device)
        return e, e.clone()
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3


def knn(grid: NeighborGrid, queries: torch.Tensor, k: int,
        bucket: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours (an identical point / self included).

    Returns (idx (M, k) int32, dist2 (M, k) int32); missing neighbours have
    dist2 == MAX_DIST2 and idx == 0.  Kernel E on CUDA (entry `grid_knn`
    for a packed table, `grid_knn_xyz` for an unpacked one); the plain
    version for a CPU tensor."""
    if not 1 <= k <= 64:
        raise ValueError(f"knn: k={k} outside 1..64")
    if queries.device.type == "cpu":
        return knn_plain(grid, queries, k, bucket)
    d = queries.device
    dev.check_tensor(queries, "queries", torch.int32, d, 2)
    dev.check_tensor(grid.order, "order", torch.int32, d, 1)
    dev.check_tensor(grid.starts, "starts", torch.int32, d, 1)
    dev.check_tensor(grid.table, "table", torch.int32, d, 1 if grid.packed else 2)
    entry = "grid_knn" if grid.packed else "grid_knn_xyz"
    M = queries.shape[0]
    idx = torch.empty((M, k), dtype=torch.int32, device=d)
    d2 = torch.empty((M, k), dtype=torch.int32, device=d)
    fn = getattr(dev.load_kernel("grid_knn"), entry)
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    rc = fn(dev.ptr(grid.starts), dev.ptr(grid.table), dev.ptr(grid.order),
            dev.ptr(queries), M, grid.grid_bits, grid.cell_bits, 3 * bucket, k,
            dev.ptr(idx), dev.ptr(d2), dev.stream_handle())
    dev.count_launch(entry, 1 if M else 0)
    dev.check_launch(entry, rc)
    return idx, d2


def nearest(grid: NeighborGrid, queries: torch.Tensor,
            bucket: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single nearest neighbour (reference `nearest`,
    neighbors.py:215): `knn` with k=1.  Returns (idx (M,), dist2 (M,))
    int32."""
    idx, d2 = knn(grid, queries, k=1, bucket=bucket)
    return idx[:, 0].contiguous(), d2[:, 0].contiguous()


def knn_batch_plain(grids: NeighborGridBatch, queries: torch.Tensor, k: int,
                    bucket: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel E's batched entry: `knn_plain` frame by
    frame.  queries (B, M, 3) -> (idx, d2) (B, M, k) int32."""
    outs = [knn_plain(grids.frame(b), queries[b], k, bucket) for b in range(queries.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


_BATCH_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3


def knn_batch(grids: NeighborGridBatch, queries: torch.Tensor, k: int,
              bucket: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each frame's queries among that frame's
    points: (idx, d2) (B, M, k) int32, per frame as `knn`.  Kernel E's
    `grid_knn_batch` entry (one launch for all frames) on CUDA; the plain
    version for a CPU tensor."""
    if not 1 <= k <= 64:
        raise ValueError(f"knn_batch: k={k} outside 1..64")
    if queries.device.type == "cpu":
        return knn_batch_plain(grids, queries, k, bucket)
    d = queries.device
    dev.check_tensor(queries, "queries", torch.int32, d, 3)
    dev.check_tensor(grids.order, "order", torch.int32, d, 2)
    dev.check_tensor(grids.starts, "starts", torch.int32, d, 2)
    dev.check_tensor(grids.table, "table", torch.int32, d, 2)
    B, M, _ = queries.shape
    N, S = grids.order.shape[1], grids.starts.shape[1]
    if grids.order.shape[0] != B or grids.table.shape != grids.order.shape or queries.shape[2] != 3:
        raise ValueError(f"knn_batch: grids of {tuple(grids.order.shape)}, queries "
                         f"{tuple(queries.shape)}")
    idx = torch.empty((B, M, k), dtype=torch.int32, device=d)
    d2 = torch.empty((B, M, k), dtype=torch.int32, device=d)
    fn = dev.load_kernel("grid_knn").grid_knn_batch
    fn.argtypes, fn.restype = _BATCH_ARGS, ctypes.c_int
    rc = fn(dev.ptr(grids.starts), dev.ptr(grids.table), dev.ptr(grids.order),
            dev.ptr(queries), B, M, N, S, grids.grid_bits, grids.cell_bits, 3 * bucket, k,
            dev.ptr(idx), dev.ptr(d2), dev.stream_handle())
    dev.count_launch("grid_knn_batch", 1 if B * M else 0)
    dev.check_launch("grid_knn_batch", rc)
    return idx, d2
