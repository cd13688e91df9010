"""Iterative Closest Point refinement (port of mapmerge_tpu/ops/icp.py).

Point-to-point ICP seeded by an initial guess. The correspondence bound
anneals from `max_correspondence_distance` by `anneal` per iteration down to
`min_correspondence_distance`; each iteration fits on the bounded exact 1-NN
correspondences, rejects pairs whose residual under that fit exceeds
`outlier_rejection_threshold`, and refits on the rest. It stops when the
transform change is below `transform_epsilon`, the relative MSE change below
1e-4 and the bound at its floor, or after `max_iterations`. The loop runs on
the host with one device-to-host read of the stop flag per iteration.

The correspondences are the bounded exact 1-NN: the nearest-neighbour kernel
on the dense engine, or, for targets of GRID_NN_THRESHOLD points or more, a
cell grid of the target at the correspondence bound, built once before the
loop (the target never moves) and queried every iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.grid import build_grid, grid_nn_query
from mapmerge_torch.ops.neighbors import (
    GRID_NN_THRESHOLD,
    _resolve_engine,
    nearest_neighbor,
)
from mapmerge_torch.ops.rigid import kabsch


def icp_refine(
    source: PointCloud,
    target: PointCloud,
    initial: torch.Tensor,
    max_correspondence_distance: float,
    outlier_rejection_threshold: float,
    max_iterations: int,
    transform_epsilon: float,
    anneal: float = 0.85,
    min_correspondence_distance: float | None = None,
    scan_cap: int = 256,
) -> tuple[torch.Tensor, bool, torch.Tensor]:
    """Refine `initial` (source -> target). Returns (transform, converged,
    scan_overflow).

    `converged` is False when no iteration found >= 3 bounded
    correspondences; callers then keep the unrefined transform.
    `scan_overflow` is the worst per-iteration count of valid source points
    the grid's query-side bucket cap dropped (they lose their
    correspondence); 0 on the dense engine."""
    f32 = np.float32
    d_hi = f32(max_correspondence_distance)
    d_lo = f32(
        min_correspondence_distance
        if min_correspondence_distance is not None
        else max_correspondence_distance / 8.0
    )
    reject2 = float(f32(outlier_rejection_threshold) ** 2)
    eps = float(f32(transform_epsilon))

    t = initial.to(torch.float32)
    dev = t.device
    prev_mse = torch.tensor(1.0e30, dtype=torch.float32, device=dev)
    ever_ok = torch.zeros((), dtype=torch.bool, device=dev)
    worst = torch.zeros((), dtype=torch.int32, device=dev)
    grid = None
    if _resolve_engine("auto", target.capacity, GRID_NN_THRESHOLD) == "grid":
        grid = build_grid(
            target.xyz, target.mask, float(max_correspondence_distance),
            cap=scan_cap,
        )
    for it in range(max_iterations):
        ladder = d_hi * f32(anneal) ** f32(it)
        dist = max(ladder, d_lo)
        moved = tf.apply(t, source.xyz)
        if grid is not None:
            idx, d2, overflow = grid_nn_query(
                grid, moved, target.capacity, q_mask=source.mask
            )
            worst = torch.maximum(worst, overflow)
        else:
            idx, d2, _ = nearest_neighbor(
                moved, target.xyz, p_mask=target.mask,
                bound=float(max_correspondence_distance),
            )
        w = (source.mask & (d2 <= float(dist * dist))).to(torch.float32)
        matched = target.xyz[idx.to(torch.int64)]
        delta, ok = kabsch(moved, matched, w)
        if outlier_rejection_threshold > 0:
            # trimmed refit on the pairs the first fit calls inliers
            resid2 = ((tf.apply(delta, moved) - matched) ** 2).sum(dim=-1)
            delta2, ok2 = kabsch(moved, matched, w * (resid2 <= reject2))
            delta = torch.where(ok2, delta2, delta)
            ok = ok | ok2
        t_new = torch.where(ok, tf.compose(delta, t), t)
        change = torch.sqrt(((t_new - t) ** 2).sum())
        mse = torch.where(w > 0, d2, 0.0).sum() / w.sum().clamp_min(1.0)
        rel_mse = (mse - prev_mse).abs() / prev_mse.clamp_min(1e-12)
        at_floor = bool(anneal >= 1.0 or ladder <= d_lo)
        done = torch.where(
            ok, (change < eps) & (rel_mse < 1e-4) & at_floor, True
        )
        t, prev_mse, ever_ok = t_new, mse, ever_ok | ok
        if bool(done):
            break
    return t, bool(ever_ok), worst
