"""Transform validation score (port of mapmerge_tpu/ops/score.py).

pcl::registration::TransformationValidationEuclidean: mean squared
nearest-neighbour distance from the moved source to the target over pairs
closer than `max_range` (MAX_SCORE when none). Coverage is the fraction of
valid source points with such a pair. Confidence = 1 / score, or
coverage^2 / score in the robust variant. The bound max_range lets targets
of GRID_NN_THRESHOLD points or more take the grid engine. Clouds with a
leading pair axis score each pair of the batch through one launch of the
batched 1-NN (dense engine only).
"""

from __future__ import annotations

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.neighbors import _f32, nearest_neighbor, nearest_neighbor_batch

MAX_SCORE = 1.0e30


def transform_score(
    source: PointCloud,
    target: PointCloud,
    transform: torch.Tensor,
    max_range: float,
    scan_cap: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, int | torch.Tensor]:
    """Returns (score, coverage) as 0-d float32 tensors and the grid
    engine's scan overflow: valid source points its query-side bucket cap
    dropped, scored as unmatched (0 on the dense engine). Batched clouds
    (B, N, ...) and transforms (B, 4, 4) give (B,) scores and coverages."""
    moved = tf.apply(transform, source.xyz)
    if source.xyz.dim() == 3:
        _, d2, overflow = nearest_neighbor_batch(
            moved, target.xyz, p_mask=target.mask, bound=float(max_range)
        )
    else:
        _, d2, overflow = nearest_neighbor(
            moved, target.xyz, p_mask=target.mask, bound=float(max_range),
            scan_cap=scan_cap, q_mask=source.mask,
        )
    r2 = _f32(max_range * max_range)
    within = source.mask & (d2 <= r2)
    num = torch.where(within, d2, 0.0).sum(dim=-1)
    cnt = within.sum(dim=-1)
    total = source.mask.sum(dim=-1).clamp_min(1)
    score = torch.where(cnt > 0, num / cnt.clamp_min(1), MAX_SCORE)
    return score, (cnt / total).to(torch.float32), overflow


def confidence(
    score: torch.Tensor, coverage: torch.Tensor | None = None
) -> torch.Tensor:
    """Edge confidence for the merge graph: 1 / score, times coverage^2 when
    `coverage` is given."""
    inv = torch.reciprocal(score.clamp_min(1.0 / MAX_SCORE))
    if coverage is None:
        return inv
    return inv * coverage * coverage
