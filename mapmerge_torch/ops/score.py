"""Transform validation score (port of mapmerge_tpu/ops/score.py).

pcl::registration::TransformationValidationEuclidean: mean squared
nearest-neighbour distance from the moved source to the target over pairs
closer than `max_range` (MAX_SCORE when none). Coverage is the fraction of
valid source points with such a pair. Confidence = 1 / score, or
coverage^2 / score in the robust variant.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.neighbors import _f32, nearest_neighbor

MAX_SCORE = 1.0e30


def transform_score(
    source: PointCloud,
    target: PointCloud,
    transform: torch.Tensor,
    max_range: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (score, coverage) as 0-d float32 tensors."""
    moved = tf.apply(transform, source.xyz)
    _, d2, _ = nearest_neighbor(
        moved, target.xyz, p_mask=target.mask, bound=float(max_range)
    )
    r2 = _f32(max_range * max_range)
    within = source.mask & (d2 <= r2)
    num = torch.where(within, d2, 0.0).sum()
    cnt = within.sum()
    total = source.mask.sum().clamp_min(1)
    score = torch.where(cnt > 0, num / cnt.clamp_min(1), MAX_SCORE)
    return score, (cnt / total).to(torch.float32)


def confidence(
    score: torch.Tensor, coverage: torch.Tensor | None = None
) -> torch.Tensor:
    """Edge confidence for the merge graph: 1 / score, times coverage^2 when
    `coverage` is given."""
    inv = torch.reciprocal(score.clamp_min(1.0 / MAX_SCORE))
    if coverage is None:
        return inv
    return inv * coverage * coverage
