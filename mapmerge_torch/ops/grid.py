"""Cell-grid neighbour engine (port of mapmerge_tpu/ops/grid.py).

The dense engine (ops/neighbors.py) streams a (tile, P) distance slab per
query tile; at a million points one radius pass is ~1e12 pair distances.
Here the points go into the cell grid of core/grid.py (its contracts are the
reference's), and every query of a bucket meets the candidates of the 27
neighbour buckets of its own.

The bounded 1-NN, the radius moments, the radius count, the Gaussian
smoothing, the k nearest of a large query set and the radius reduce
(grid_nn_query, grid_neighbor_moments, grid_radius_count,
grid_gaussian_smooth, the big-Q branch of grid_radius_neighbors and
grid_radius_reduce and grid_reduce_query) run kernels G, H, I, J, K and L
(kernels/grid.py), which read both grids in place with no host read;
FPFH's SPFH sweep reads the grid so too (kernels/spfh.spfh_grid).
radius_reduce's small-Q path is L's list route, a warp a query over its 27
neighbour blocks; the small-Q path of radius_neighbors gathers them
directly. grid_nn_query and grid_reduce_query take a target grid built
before, so that a caller that queries one grid many times (ICP, Harris)
sorts its points once.

The grid's own names (CellGrid, build_grid, grid_query, ...) are those of
core/grid.py, taken in here so that this module offers the reference
module's whole surface.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.grid import (
    BIG,
    CellGrid,
    _bucket_of,
    _candidates,
    _cells,
    _d2,
    _f32,
    build_grid,
    default_dims,
    grid_query,
    masked_query_grid,
    max_bucket_count,
)
from mapmerge_torch.kernels import grid as grid_kernels

__all__ = [
    "BIG", "SMALL_Q_THRESHOLD", "CellGrid", "build_grid",
    "default_dims", "grid_query", "masked_query_grid", "max_bucket_count",
    "grid_radius_count", "grid_radius_neighbors", "grid_nearest_neighbor",
    "grid_nn_query", "grid_radius_reduce", "grid_reduce_query", "grid_neighbor_moments",
    "grid_gaussian_smooth",
]

#: query count at or below which the radius ops gather each query's 27
#: neighbour blocks directly (the small-Q paths) instead of sweeping cells
SMALL_Q_THRESHOLD = 4096


# ----------------------------------------------------------------- public ops
def grid_radius_count(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    p_mask: torch.Tensor | None = None,
    include_self: bool = True,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid twin of neighbors.radius_count: (counts (Q,) int32, overflow),
    exact up to scan_cap; `overflow` counts the queries the query-side cap
    dropped (their count is 0). Kernel I (kernels/grid.count)."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    counts = grid_kernels.count(grid, qg, q, _f32(radius * radius), include_self)
    return counts, qg.overflow


def _topk_nearest(d2, cand_idx, k: int, r2: float, exclude_self: bool):
    """The k smallest of d2 (..., M) nearest first: (idx int32, d2, valid),
    padded to width k (the small-Q path). One top-k over the 27 C
    candidates: the same set as the reference's two-stage top-k, the order
    of ties unspecified."""
    if exclude_self:
        d2 = torch.where(d2 <= 1e-12, BIG, d2)
    k_eff = min(k, d2.shape[-1])
    d2k, pos = torch.topk(d2, k_eff, dim=-1, largest=False, sorted=True)
    idx = torch.gather(cand_idx.expand(d2.shape), -1, pos)
    valid = d2k <= r2
    if k_eff < k:
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2k = torch.nn.functional.pad(d2k, (0, pad), value=BIG)
        valid = torch.nn.functional.pad(valid, (0, pad))
    return idx.to(torch.int32), d2k, valid


def _radius_neighbors_smallq(
    q: torch.Tensor,
    grid: CellGrid,
    n_p: int,
    radius: float,
    k: int,
    exclude_self: bool,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query-centric radius_neighbors for SMALL query sets (keypoint
    neighbourhoods): each query's 27 neighbour blocks gathered into a
    (Q, 27C) candidate slab and top-k'd; no query-side bucketing, so every
    query is answered (a query parked at FAR fails every distance test,
    whatever bucket its coordinates hash to)."""
    r2 = _f32(radius * radius)
    bucket = _bucket_of(_cells(q, grid.cell_size), grid.dims)
    outs = []
    for s in range(0, q.shape[0], chunk):
        _, cand_xyz, cand_ok, cand_idx = _candidates(grid, bucket[s : s + chunk])
        d2 = _d2(q[s : s + chunk, None, :], cand_xyz)[:, 0]
        d2 = torch.where(cand_ok, d2, BIG)
        outs.append(_topk_nearest(d2, cand_idx, k, r2, exclude_self))
    idx, d2k, valid = (torch.cat(parts) for parts in zip(*outs))
    idx = torch.where(idx >= n_p, 0, idx)
    return idx, d2k, valid


def grid_radius_neighbors(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    k: int,
    p_mask: torch.Tensor | None = None,
    exclude_self: bool = False,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid twin of neighbors.radius_neighbors: up to k nearest within
    radius, nearest first, indices in the original point order: (idx, d2,
    valid, overflow). At most SMALL_Q_THRESHOLD queries take the small-Q
    path (overflow 0 there); more take kernel K (kernels/grid.knn: ties to
    the first candidate position, entries at BIG as (0, BIG, False))."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    r2 = _f32(radius * radius)
    if q.shape[0] <= SMALL_Q_THRESHOLD:
        idx, d2k, valid = _radius_neighbors_smallq(
            q, grid, p.shape[0], radius, k, exclude_self
        )
        return idx, d2k, valid, torch.zeros((), dtype=torch.int32, device=q.device)
    qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    idx, d2k, valid = grid_kernels.knn(grid, qg, q, p.shape[0], k, r2, exclude_self)
    return idx, d2k, valid, qg.overflow


def grid_nearest_neighbor(
    q: torch.Tensor,
    p: torch.Tensor,
    bound: float,
    p_mask: torch.Tensor | None = None,
    scan_cap: int = 128,
    dims: tuple | None = None,
    q_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bounded 1-NN: (idx, d2, overflow), d2 = BIG where nothing lies
    within `bound`; exact for consumers that discard matches beyond the
    bound (ICP, the transform score), up to the query-side cap."""
    grid = build_grid(p, p_mask, bound, dims, scan_cap)
    return grid_nn_query(grid, q, p.shape[0], q_mask=q_mask)


def grid_nn_query(
    grid: CellGrid,
    q: torch.Tensor,
    n_p: int,
    q_mask: torch.Tensor | None = None,
    boxes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bounded 1-NN against a PREBUILT grid whose cell edge is the bound
    (ICP builds its target grid once, and kernel G's tile boxes of it once:
    kernels/grid.boxes; None makes them in the call). Queries outside `q_mask`
    stay out of the overflow count; dropped queries come back unmatched (d2
    = BIG). Ties go to the first candidate slot, as argmin does. Kernel G
    (kernels/grid.nn_query)."""
    qg = build_grid(q, q_mask, grid.cell_size, grid.dims, grid.cap)
    idx, best = grid_kernels.nn_query(grid, qg, q, n_p, boxes=boxes)
    return idx, best, qg.overflow


def grid_radius_reduce(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    values: torch.Tensor,
    p_mask: torch.Tensor | None = None,
    reduce: str = "sum",
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid twin of neighbors.radius_reduce: (count, sum or max of values,
    query-overflow count). Builds the target grid, then grid_reduce_query."""
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce: {reduce}")
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    return grid_reduce_query(grid, q, values, reduce)


def grid_reduce_query(
    grid: CellGrid,
    q: torch.Tensor,
    values: torch.Tensor,
    reduce: str = "sum",
    qg: CellGrid | None = None,
    boxes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """radius_reduce against a PREBUILT target grid whose cell edge is the
    radius (Harris builds its grids once an extraction): (count, sum or
    max of `values` (P, C) of each query's members, query-overflow count).
    At most SMALL_Q_THRESHOLD queries take the small-Q path (every query
    answered, overflow 0 there: kernel L's list route, kernels/grid.
    reduce_list, given the target's tile boxes `boxes` where made before);
    more take the query grid `qg` (build_grid(q, None, the grid's cell,
    dims and cap) where None, or a grid of its slots, e.g.
    masked_query_grid's: the rows of the others keep the defaults, count 0
    and 0 or -BIG) and kernel L's sweep route (kernels/grid.reduce)."""
    r2 = _f32(grid.cell_size * grid.cell_size)
    values = values.contiguous()
    if q.shape[0] <= SMALL_Q_THRESHOLD:
        count, out = grid_kernels.reduce_list(grid, q, values, r2, reduce, boxes=boxes)
        return count, out, torch.zeros((), dtype=torch.int32, device=q.device)
    if qg is None:
        qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    count, out = grid_kernels.reduce(grid, qg, q, values, r2, reduce)
    return count, out, qg.overflow


def grid_neighbor_moments(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    p_mask: torch.Tensor | None = None,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid twin of neighbors.neighbor_moments: (count, mean, cov,
    query-overflow count). Candidates are centred on the query before the
    moment sums, so the covariance has no large-coordinate cancellation.
    Kernel H (kernels/grid.moments)."""
    grid = build_grid(p, p_mask, radius, dims, scan_cap)
    qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    s0, mean, cov = grid_kernels.moments(grid, qg, q, _f32(radius * radius))
    return s0, mean, cov, qg.overflow


def grid_gaussian_smooth(
    q: torch.Tensor,
    p: torch.Tensor,
    values: torch.Tensor,
    sigmas: list[float],
    p_mask: torch.Tensor | None = None,
    scan_cap: int = 128,
    dims: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian-weighted means of `values` (P,) at every sigma: ((Q, S),
    query-overflow count), the neighbourhood bounded at 3 max(sigmas) (PCL's
    SIFT scale-space truncation). Backs the grid branch of SIFT's scale
    space. Kernel J (kernels/grid.smooth)."""
    r_bound = 3.0 * max(sigmas)
    grid = build_grid(p, p_mask, r_bound, dims, scan_cap)
    qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    out = grid_kernels.smooth(grid, qg, q, values, sigmas, _f32(r_bound * r_bound))
    return out, qg.overflow
