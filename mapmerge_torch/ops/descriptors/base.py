"""Descriptor result container (port of mapmerge_tpu/ops/descriptors/base.py).

One fixed-shape (K, D) tensor with a validity mask: an invalid descriptor
stands for a keypoint the reference drops.
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_torch.ops.neighbors import radius_neighbors


@dataclasses.dataclass(frozen=True)
class Descriptors:
    data: torch.Tensor  # (K, D) float32
    valid: torch.Tensor  # (K,) bool


def keypoint_neighborhoods(
    cloud, normals, keypoints, radius: float, max_neighbors: int, tile: int,
    engine: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The nearest `max_neighbors` valid surface points within `radius` of
    each keypoint: (idx (K, M) int64, d2 (K, M), in-radius mask (K, M),
    False for an empty keypoint slot)."""
    idx, d2, nmask, _ = radius_neighbors(
        keypoints.xyz, cloud.xyz, radius, max_neighbors,
        p_mask=cloud.mask & normals.valid, tile=tile, engine=engine,
    )
    return idx.to(torch.int64), d2, nmask & keypoints.mask[:, None]
