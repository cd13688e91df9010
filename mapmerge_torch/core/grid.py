"""The cell grid under the grid engine (ops/grid.py) and the kernels that
read it in place (kernels/spfh.spfh_grid; kernels/grid.py: G-K): the
(H, C) cell tensor, its build, and `grid_query`, the plain sweep the
engine's tile_fns and those kernels' plain versions run.

Points are binned by WRAPPED integer cell coordinates (cell edge >= the
query radius, coordinates taken modulo static grid dims) into a dense
(H, C) cell tensor, and all queries of one bucket share one candidate set:
the blocks of its 27 neighbour buckets.

Contracts kept from the reference (mapmerge_tpu/ops/grid.py):
  - cell edge >= radius puts every true neighbour in one of the 27
    neighbour cells; wrap collisions only add candidates, which the exact
    distance test removes; neighbour ids duplicated by wrapping on tiny
    grids are masked out, so nothing counts twice;
  - points beyond `cap` in one bucket are dropped at build time and
    counted (`overflow`, `raw_max`); queries dropped by the query-side cap
    come back with the op's default and are counted too, masked queries
    (`q_mask`) excepted;
  - an index >= n (an empty slot) maps to 0 with valid = False.

`grid_query` is re-decided for the card. The reference scans all H buckets
in tiles under lax.scan and skips empty tiles with lax.cond; a Python loop
over the tiles would be thousands of launches per pass, and one pass over
every bucket at once does not fit (65,536 x 128 x 3,456 pairs is 116 GB a
float32 plane). Instead one host read (`nonzero`) selects the buckets that
hold a query; they go through `tile_fn` in chunks of at most
`PAIRS_PER_CHUNK` (query, candidate) pairs, and each chunk's rows are
scattered back to query order through a sacrificial row `nq`, where the
unused slots land (the only repeated index of the scatter).

Every sum adds in a fixed order (dense reductions, bmm) and every scatter
writes distinct rows apart from the discarded sacrificial one, so a query
repeats bit for bit on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mapmerge_torch.core.cloud import FAR

#: squared-distance value used to exclude masked or absent candidates
BIG = 1.0e12
#: (query, candidate) pairs per grid_query chunk: one float32 plane of such
#: a chunk is 256 MB, and the heaviest plain tile_fn (moments) holds ~10 of
#: them (the SPFH kernel holds no plane and takes no chunks)
PAIRS_PER_CHUNK = 1 << 26

#: the 27 neighbour-cell offsets, x fastest (the reference's _OFFSETS)
_OFFSETS = [
    (dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
]


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Points scattered into a dense (H, C) cell tensor."""

    cell_xyz: torch.Tensor  # (H, C, 3) float32; empty slots parked at FAR
    cell_idx: torch.Tensor  # (H, C) int64 original index; empty slots = n
    cell_ok: torch.Tensor  # (H, C) bool: slot holds a valid point
    count: torch.Tensor  # (H,) int32 stored (capped) bucket sizes
    raw_max: torch.Tensor  # () int32 fullest bucket BEFORE capping
    overflow: torch.Tensor  # () int32 valid points dropped by the cap
    cell_size: float
    dims: tuple  # (Gx, Gy, Gz)
    cap: int  # C


def _f32(x: float) -> float:
    """`x` rounded to float32, as the reference's jnp.float32 constants."""
    return float(torch.tensor(x, dtype=torch.float32))


def default_dims(n: int) -> tuple[int, int, int]:
    """Grid dims with H = Gx*Gy*Gz ~ max(4096, n/16), power-of-two axes;
    z gets at most 4 wrap cells (robot maps are flat-ish), x and y the
    rest (reference grid.py:78-95)."""
    h_target = 4096
    while h_target < min(max(n // 16, 4096), 1 << 18):
        h_target <<= 1
    e = h_target.bit_length() - 1
    ez = min(2, e // 3)
    ex = (e - ez + 1) // 2
    ey = e - ez - ex
    return (1 << ex, 1 << ey, 1 << ez)


def _cells(xyz: torch.Tensor, cell_size: float) -> torch.Tensor:
    """floor(xyz * float32(1 / cell)) as int64: the reference's product by
    the float32 reciprocal, then an exact cast (no int32 wrap for parked
    points)."""
    inv = torch.tensor(1.0 / cell_size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz * inv).to(torch.int64)


def _bucket_of(cells: torch.Tensor, dims: tuple) -> torch.Tensor:
    gx, gy, gz = dims
    bx = torch.remainder(cells[..., 0], gx)
    by = torch.remainder(cells[..., 1], gy)
    bz = torch.remainder(cells[..., 2], gz)
    return (bz * gy + by) * gx + bx


def _neighbor_buckets(b: torch.Tensor, dims: tuple) -> torch.Tensor:
    """(..., 27) wrapped bucket ids of the 27 neighbour cells of bucket b."""
    gx, gy, gz = dims
    off = torch.tensor(_OFFSETS, dtype=b.dtype, device=b.device)
    bx = torch.remainder(b, gx)
    by = torch.remainder(b // gx, gy)
    bz = b // (gx * gy)
    nx = torch.remainder(bx[..., None] + off[:, 0], gx)
    ny = torch.remainder(by[..., None] + off[:, 1], gy)
    nz = torch.remainder(bz[..., None] + off[:, 2], gz)
    return (nz * gy + ny) * gx + nx


def _candidates(grid: CellGrid, buckets: torch.Tensor):
    """The candidate blocks of the 27 neighbours of each bucket:
    (nbr (B, 27), cand_xyz (B, 27C, 3), cand_ok (B, 27C), cand_idx (B, 27C)).
    Ids repeated by wrapping on tiny grids are sorted together and all but
    the first copy masked out."""
    nbr, _ = torch.sort(_neighbor_buckets(buckets, grid.dims), dim=-1)
    dup = torch.zeros_like(nbr, dtype=torch.bool)
    dup[:, 1:] = nbr[:, 1:] == nbr[:, :-1]
    b, m = nbr.shape[0], 27 * grid.cap
    cand_xyz = grid.cell_xyz[nbr].reshape(b, m, 3)
    cand_ok = (grid.cell_ok[nbr] & ~dup[..., None]).reshape(b, m)
    cand_idx = grid.cell_idx[nbr].reshape(b, m)
    return nbr, cand_xyz, cand_ok, cand_idx


def build_grid(
    xyz: torch.Tensor,
    mask: torch.Tensor | None,
    cell_size: float,
    dims: tuple | None = None,
    cap: int = 128,
) -> CellGrid:
    """Scatter points into the dense cell tensor: one stable sort."""
    n = xyz.shape[0]
    dev = xyz.device
    if dims is None:
        dims = default_dims(n)
    h = dims[0] * dims[1] * dims[2]
    bucket = _bucket_of(_cells(xyz, cell_size), dims)
    if mask is not None:
        bucket = torch.where(mask, bucket, h)  # invalid points to a spill bucket

    # rank within the bucket: the sorted order is bucket-major, so rank =
    # position - start of the bucket. The sort is stable (as jnp.argsort),
    # which decides the points a full bucket keeps and the slot order
    order = torch.argsort(bucket, stable=True)
    bucket_s = bucket[order]
    counts_all = torch.bincount(bucket_s, minlength=h + 1)
    start = torch.cumsum(counts_all, 0) - counts_all
    rank = torch.arange(n, device=dev) - start[bucket_s]
    keep = (rank < cap) & (bucket_s < h)
    slot = torch.where(keep, bucket_s * cap + rank, h * cap)  # spill slot

    cell_xyz = torch.full((h * cap + 1, 3), FAR, dtype=torch.float32, device=dev)
    cell_xyz[slot] = xyz[order]
    cell_idx = torch.full((h * cap + 1,), n, dtype=torch.int64, device=dev)
    cell_idx[slot] = order
    cell_ok = torch.zeros((h * cap + 1,), dtype=torch.bool, device=dev)
    cell_ok[slot] = keep
    counts = counts_all[:h]
    return CellGrid(
        cell_xyz=cell_xyz[:-1].reshape(h, cap, 3),
        cell_idx=cell_idx[:-1].reshape(h, cap),
        cell_ok=cell_ok[:-1].reshape(h, cap),
        count=counts.clamp_max(cap).to(torch.int32),
        raw_max=counts.max().to(torch.int32),
        overflow=(counts - cap).clamp_min(0).sum().to(torch.int32),
        cell_size=float(cell_size),
        dims=tuple(dims),
        cap=cap,
    )


def max_bucket_count(grid: CellGrid) -> torch.Tensor:
    """Fullest bucket BEFORE capping: above grid.cap, points were dropped
    (grid.overflow counts them); callers surface it."""
    return grid.raw_max


def masked_query_grid(grid: CellGrid, q_mask: torch.Tensor, n: int) -> CellGrid:
    """The query grid of "the grid's own points, restricted to q_mask",
    without a second sort: the same slots, occupancy and-ed with the mask.

    Its overflow counts only q_mask points dropped at build time: drops
    outside q_mask were never queried."""
    dev = q_mask.device
    mask_pad = torch.cat([q_mask, torch.zeros((1,), dtype=torch.bool, device=dev)])
    cell_ok = grid.cell_ok & mask_pad[grid.cell_idx]
    kept = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    kept[torch.where(grid.cell_ok, grid.cell_idx, n).reshape(-1)] = True
    overflow = (q_mask[:n] & ~kept[:n]).sum().to(torch.int32)
    return dataclasses.replace(
        grid, cell_ok=cell_ok, count=cell_ok.sum(dim=1).to(torch.int32),
        overflow=overflow,
    )


def _pad_rows(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.zeros((1,) + v.shape[1:], dtype=v.dtype, device=v.device)])


def grid_query(
    q: torch.Tensor,
    grid: CellGrid,
    tile_fn: Callable,
    out_defaults,
    q_mask: torch.Tensor | None = None,
    q_values: torch.Tensor | None = None,
    p_values: torch.Tensor | None = None,
    qg: CellGrid | None = None,
):
    """Bucket-grouped query processing: (outputs, query-overflow count).

    Bins the queries into the layout and bucket cap of `grid` (or takes the
    prebuilt query grid `qg`, e.g. from masked_query_grid), runs
        tile_fn(q_block (B, Cq, 3), cand_xyz (B, M, 3), cand_ok (B, M),
                cand_idx (B, M)[, q_vals (B, Cq, ...), p_vals (B, M, ...)])
    -> a tensor or tuple of tensors (B, Cq, ...) over the buckets that hold
    a query, in chunks (module docstring), and scatters the rows back to
    query order. `q_values` / `p_values` are per-query / per-point channel
    tensors (N, ...), gathered into the cell layout once. `out_defaults`
    (one scalar per output, filling its rows) is the output of queries the
    query-side cap dropped."""
    if qg is None:
        qg = build_grid(q, q_mask, grid.cell_size, grid.dims, grid.cap)
    nq = q.shape[0]
    m = 27 * grid.cap
    q_cells = None if q_values is None else _pad_rows(q_values)[qg.cell_idx]
    p_cells = None if p_values is None else _pad_rows(p_values)[grid.cell_idx]

    active = torch.nonzero(qg.count > 0).flatten()  # the one host read
    chunk = max(1, PAIRS_PER_CHUNK // (qg.cap * m))
    single = not isinstance(out_defaults, tuple)
    defaults = (out_defaults,) if single else out_defaults
    outs = None
    # at least one pass, an empty chunk where no bucket holds a query, to
    # learn the outputs' row shapes and dtypes from tile_fn
    for s in range(0, max(active.numel(), 1), chunk):
        b = active[s : s + chunk]
        nbr, cand_xyz, cand_ok, cand_idx = _candidates(grid, b)
        extras = []
        if q_cells is not None:
            extras.append(q_cells[b])
        if p_cells is not None:
            extras.append(p_cells[nbr].reshape((b.numel(), m) + p_cells.shape[2:]))
        res = tile_fn(qg.cell_xyz[b], cand_xyz, cand_ok, cand_idx, *extras)
        res = (res,) if single else res
        if outs is None:
            outs = [
                torch.full((nq + 1,) + o.shape[2:], default, dtype=o.dtype, device=o.device)
                for default, o in zip(defaults, res)
            ]
        # occupancy-gated scatter: masked-out slots of a derived query grid
        # still hold real points; they go to the sacrificial row
        slots = torch.where(qg.cell_ok[b], qg.cell_idx[b], nq).reshape(-1)
        for acc, o in zip(outs, res):
            acc[slots] = o.reshape((-1,) + o.shape[2:])
    outs = tuple(a[:nq] for a in outs)
    return (outs[0] if single else outs), qg.overflow


def _d2(q_block: torch.Tensor, cand_xyz: torch.Tensor) -> torch.Tensor:
    """(B, Cq, 3) x (B, M, 3) -> (B, Cq, M) squared distances, summed over
    x, y, z in that order (the reference's sum of d * d)."""
    d2 = None
    for c in range(3):
        d = q_block[:, :, c : c + 1] - cand_xyz[:, None, :, c]
        d = d * d
        d2 = d if d2 is None else d2.add_(d)
    return d2
