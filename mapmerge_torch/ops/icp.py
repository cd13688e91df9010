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
loop (the target never moves), with the tile boxes kernel G culls by, and
queried every iteration.

With a leading pair axis (clouds (B, N, ...), `initial` (B, 4, 4)) the
same loop runs every pair of a batch on the dense engine, the counterpart of
the reference's while_loop under vmap: every pair steps together, each with
its own transform, previous MSE and flags, on the iteration index that sets
the shared annealing ladder; a pair that has stopped is frozen with
`torch.where`, so it ends with the transform it would have ended with alone.
One launch of the batched 1-NN serves every pair of an iteration, and the
loop reads one flag an iteration (is any pair still running?) for the whole
batch.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.kernels import grid as grid_kernels
from mapmerge_torch.ops.grid import build_grid, grid_nn_query
from mapmerge_torch.ops.matching import take
from mapmerge_torch.ops.neighbors import (
    GRID_NN_THRESHOLD,
    _resolve_engine,
    nearest_neighbor,
    nearest_neighbor_batch,
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
    info_out: dict | None = None,
) -> tuple[torch.Tensor, bool | torch.Tensor, torch.Tensor]:
    """Refine `initial` (source -> target). Returns (transform, converged,
    scan_overflow).

    `converged` is False when no iteration found >= 3 bounded
    correspondences; callers then keep the unrefined transform.
    `scan_overflow` is the worst per-iteration count of valid source points
    the grid's query-side bucket cap dropped (they lose their
    correspondence); 0 on the dense engine.

    With a leading pair axis (`initial` (B, 4, 4)), every field has it:
    transforms (B, 4, 4), converged (B,) bool, scan_overflow (B,) zeros;
    targets that would take the grid raise (`nearest_neighbor_batch`).
    `info_out`, when given, receives the iterations each pair ran
    ("iterations", int32 of the lead shape)."""
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
    batched = t.dim() == 3
    dev, lead = t.device, t.shape[:-2]
    prev_mse = torch.full(lead, 1.0e30, dtype=torch.float32, device=dev)
    ever_ok = torch.zeros(lead, dtype=torch.bool, device=dev)
    running = torch.ones(lead, dtype=torch.bool, device=dev)
    iterations = torch.zeros(lead, dtype=torch.int32, device=dev)
    worst = torch.zeros(lead, dtype=torch.int32, device=dev)
    grid = boxes = None
    if not batched and (
        _resolve_engine("auto", target.capacity, GRID_NN_THRESHOLD) == "grid"
    ):
        grid = build_grid(
            target.xyz, target.mask, float(max_correspondence_distance),
            cap=scan_cap,
        )
        boxes = grid_kernels.boxes(grid)  # kernel G's, made once: the grid stays
    for it in range(max_iterations):
        ladder = d_hi * f32(anneal) ** f32(it)
        dist = max(ladder, d_lo)
        moved = tf.apply(t, source.xyz)
        if grid is not None:
            idx, d2, overflow = grid_nn_query(
                grid, moved, target.capacity, q_mask=source.mask, boxes=boxes
            )
            worst = torch.maximum(worst, overflow)
        else:
            nn = nearest_neighbor_batch if batched else nearest_neighbor
            idx, d2, _ = nn(
                moved, target.xyz, p_mask=target.mask,
                bound=float(max_correspondence_distance),
            )
        w = (source.mask & (d2 <= float(dist * dist))).to(torch.float32)
        matched = take(target.xyz, idx.to(torch.int64), batched)
        delta, ok = kabsch(moved, matched, w)
        if outlier_rejection_threshold > 0:
            # trimmed refit on the pairs the first fit calls inliers
            resid2 = ((tf.apply(delta, moved) - matched) ** 2).sum(dim=-1)
            delta2, ok2 = kabsch(moved, matched, w * (resid2 <= reject2))
            delta = torch.where(ok2[..., None, None], delta2, delta)
            ok = ok | ok2
        t_new = torch.where(ok[..., None, None], tf.compose(delta, t), t)
        change = torch.sqrt(((t_new - t) ** 2).sum(dim=(-2, -1)))
        mse = torch.where(w > 0, d2, 0.0).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)
        rel_mse = (mse - prev_mse).abs() / prev_mse.clamp_min(1e-12)
        at_floor = bool(anneal >= 1.0 or ladder <= d_lo)
        done = torch.where(
            ok, (change < eps) & (rel_mse < 1e-4) & at_floor, True
        )
        # a stopped pair keeps what it had: its own loop ended before this step
        t = torch.where(running[..., None, None], t_new, t)
        prev_mse = torch.where(running, mse, prev_mse)
        ever_ok = ever_ok | (running & ok)
        iterations = iterations + running.to(torch.int32)
        running = running & ~done
        if not bool(running.any()):
            break
    if info_out is not None:
        info_out["iterations"] = iterations
    return t, ever_ok if batched else bool(ever_ok), worst
