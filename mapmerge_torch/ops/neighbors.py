"""Neighbour queries, dense tiled engine and dispatch (port of
mapmerge_tpu/ops/neighbors.py).

Every dense neighbourhood query is an exact distance computation, tiled over
the query axis so only a (tile, P) slab exists at a time. Squared distances
are taken on inputs centred on the valid mean of p (see `sq_dists`). Exact
1-NN goes through the hand-written kernel (kernels/nn.py). Every reduction
here sums in a fixed order (matmuls and dense reductions, no atomics), so a
query repeats bit for bit on one card.

Each op dispatches to the cell-grid engine (ops/grid.py) as the reference
does: engine="grid", or "auto" at or above the capacity thresholds below
(`_resolve_engine`). Those thresholds are the reference's, so both packages
choose the same engine.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from mapmerge_torch.kernels import nn as nn_kernel
from mapmerge_torch.ops import grid
from mapmerge_torch.ops.grid import BIG, _f32

#: capacity at which "auto" takes the cell grid for radius queries
#: (mapmerge_tpu/ops/neighbors.py:34)
GRID_AUTO_THRESHOLD = 131072
#: capacity at which "auto" takes the cell grid for bounded 1-NN
#: (mapmerge_tpu/ops/neighbors.py:37)
GRID_NN_THRESHOLD = 49152


def _resolve_engine(engine: str, p_count: int, threshold: int | None = None) -> str:
    """"dense" or "grid": "auto" takes the grid at `threshold` points or
    more (GRID_AUTO_THRESHOLD when None, read at call time).
    MAPMERGE_ENGINE=dense|grid in the environment forces one engine
    everywhere (the reference's override)."""
    forced = os.environ.get("MAPMERGE_ENGINE", "")
    if forced in ("dense", "grid"):
        return forced
    if engine not in ("auto", "dense", "grid"):
        raise ValueError(f"unknown neighbor engine: {engine!r}")
    if engine != "auto":
        return engine
    cut = GRID_AUTO_THRESHOLD if threshold is None else threshold
    return "grid" if p_count >= cut else "dense"


def _center(q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None):
    """Shift both point sets by the (valid-)mean of p."""
    mean = _mean(p, p_mask)
    return q - mean, p - mean


def sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) x (P, 3) -> (..., Q, P) squared distances, by the direct
    expansion sum_c (q_c - p_c)^2.

    The reference uses the identity |q|^2 + |p|^2 - 2 q.p. PyTorch's matmul
    rounds q.p differently from |q|^2, leaving up to ~1e-6 m^2 for a point
    and itself (measured on the CPU), where the reference's CPU path gives
    exactly 0; FPFH's zero-distance self-hit test (dist > 1e-9) then weights
    the self SPFH by ~1e3. The direct expansion is exact for coincident
    points and at least as accurate elsewhere."""
    d2 = torch.zeros(q.shape[:-1] + (p.shape[0],), dtype=q.dtype, device=q.device)
    for c in range(3):
        dc = q[..., c : c + 1] - p[:, c]
        d2 += dc * dc
    return d2


def tiled_query(
    q: torch.Tensor, tile_fn: Callable, tile: int = 1024
):
    """Run `tile_fn` over (tile, 3) query slabs and concatenate the results
    (a tensor or a tuple of tensors with leading dim = slab rows)."""
    outs = [tile_fn(q[s : s + tile]) for s in range(0, q.shape[0], tile)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def radius_count(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    p_mask: torch.Tensor | None = None,
    tile: int = 1024,
    include_self: bool = True,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[torch.Tensor, int | torch.Tensor]:
    """Counts of p-points within `radius` of each query: ((Q,) int32,
    overflow). `overflow` counts the queries the grid engine dropped at its
    query-side bucket cap (0 on the dense engine); callers surface it."""
    if _resolve_engine(engine, p.shape[0]) == "grid":
        return grid.grid_radius_count(
            q, p, radius, p_mask=p_mask, include_self=include_self,
            scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = _f32(radius * radius)

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if p_mask is not None:
            within = within & p_mask[None, :]
        return within.sum(dim=-1).to(torch.int32)

    counts = tiled_query(qc, tile_fn, tile)
    if not include_self:
        counts = counts - 1
    return counts, 0


def radius_neighbors(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    k: int,
    p_mask: torch.Tensor | None = None,
    tile: int = 1024,
    exclude_self: bool = False,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int | torch.Tensor]:
    """Up to `k` nearest p-points within `radius` per query, nearest first:
    (idx (Q, k) int32, d2 (Q, k), valid (Q, k) bool, overflow; 0 on the
    dense engine).

    The order of equal distances is unspecified (it differs from
    lax.top_k's)."""
    if _resolve_engine(engine, p.shape[0]) == "grid":
        return grid.grid_radius_neighbors(
            q, p, radius, k, p_mask=p_mask, exclude_self=exclude_self,
            scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = _f32(radius * radius)
    k_eff = min(k, p.shape[0])

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        if p_mask is not None:
            d2 = torch.where(p_mask[None, :], d2, BIG)
        if exclude_self:
            d2 = torch.where(d2 <= 1e-12, BIG, d2)
        d2k, idx = torch.topk(d2, k_eff, dim=-1, largest=False, sorted=True)
        return idx.to(torch.int32), d2k, d2k <= r2

    idx, d2k, valid = tiled_query(qc, tile_fn, tile)
    if k_eff < k:  # pad back to the requested fixed width
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2k = torch.nn.functional.pad(d2k, (0, pad), value=BIG)
        valid = torch.nn.functional.pad(valid, (0, pad))
    return idx, d2k, valid, 0


def nearest_neighbor(
    q: torch.Tensor,
    p: torch.Tensor,
    p_mask: torch.Tensor | None = None,
    bound: float | None = None,
    engine: str = "auto",
    scan_cap: int = 128,
    q_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int | torch.Tensor]:
    """Exact 1-NN: (idx (Q,) int32, squared distance (Q,), overflow).

    The dense engine runs the hand-written kernel (kernels/nn.py), the port
    of the reference's Pallas path: direct (q-p)^2 expansion, masked targets
    at d2 + BIG, ties to the first occurrence; overflow 0. With `bound`
    given, targets of GRID_NN_THRESHOLD points or more take the grid engine
    under "auto": matches beyond the bound come back at d2 = BIG, and
    `overflow` counts the queries in `q_mask` that the query-side bucket cap
    dropped."""
    if bound is not None and (
        _resolve_engine(engine, p.shape[0], GRID_NN_THRESHOLD) == "grid"
    ):
        return grid.grid_nearest_neighbor(
            q, p, bound=bound, p_mask=p_mask, scan_cap=scan_cap, q_mask=q_mask,
        )
    idx, d2 = nn_kernel.nearest_neighbor(
        q.contiguous(), p.contiguous(),
        None if p_mask is None else p_mask.contiguous(),
    )
    return idx, d2, 0


def radius_reduce(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    values: torch.Tensor,
    p_mask: torch.Tensor | None = None,
    tile: int = 1024,
    reduce: str = "sum",
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, int | torch.Tensor]:
    """Reduce `values` (P, C) over each query's radius neighborhood:
    (count (Q,) int32, sums or maxes (Q, C), overflow; 0 on the dense
    engine).

    "sum" is one matmul of the {0,1} within-radius matrix per tile; "max"
    masks out-of-radius values with -BIG (a query with no neighbour gets
    -BIG)."""
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce: {reduce}")
    if _resolve_engine(engine, p.shape[0]) == "grid":
        return grid.grid_radius_reduce(
            q, p, radius, values, p_mask=p_mask, reduce=reduce,
            scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = _f32(radius * radius)

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if p_mask is not None:
            within = within & p_mask[None, :]
        count = within.sum(dim=-1).to(torch.int32)
        if reduce == "sum":
            out = within.to(torch.float32) @ values
        else:
            out = torch.where(within[:, :, None], values[None], -BIG).amax(dim=1)
        return count, out

    count, out = tiled_query(qc, tile_fn, tile)
    return count, out, 0


def neighbor_moments(
    q: torch.Tensor,
    p: torch.Tensor,
    radius: float,
    p_mask: torch.Tensor | None = None,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int | torch.Tensor]:
    """Count (Q,), mean (Q, 3) and covariance (Q, 3, 3) of each query's
    radius neighborhood, as matmuls of the {0,1} within-radius matrix, and
    the overflow (0 on the dense engine)."""
    if _resolve_engine(engine, p.shape[0]) == "grid":
        return grid.grid_neighbor_moments(
            q, p, radius, p_mask=p_mask, scan_cap=scan_cap
        )
    qc, pc = _center(q, p, p_mask)
    r2 = _f32(radius * radius)
    pp = (pc[:, :, None] * pc[:, None, :]).reshape(-1, 9)

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if p_mask is not None:
            within = within & p_mask[None, :]
        w = within.to(torch.float32)
        s0 = w.sum(dim=-1)
        denom = s0.clamp_min(1.0)[:, None]
        mean = (w @ pc) / denom
        e_outer = (w @ pp) / denom
        cov = e_outer.reshape(-1, 3, 3) - mean[:, :, None] * mean[:, None, :]
        return s0, mean, cov

    count, mean, cov = tiled_query(qc, tile_fn, tile)
    # un-centre the mean back to the input frame
    return count, mean + _mean(p, p_mask), cov, 0


def _mean(p: torch.Tensor, p_mask: torch.Tensor | None) -> torch.Tensor:
    if p_mask is None:
        return p.mean(dim=0)
    w = p_mask.to(p.dtype)
    return (p * w[:, None]).sum(dim=0) / w.sum().clamp_min(1.0)
