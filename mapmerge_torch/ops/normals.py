"""Surface normals and curvature (port of mapmerge_tpu/ops/normals.py).

pcl::NormalEstimation: PCA over each point's radius neighborhood; the normal
is the smallest-eigenvalue eigenvector flipped towards the viewpoint,
curvature = l0 / (l0 + l1 + l2). A plane fit needs at least 3 in-radius
points (the query counts).
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.eigh3 import smallest_eigenpair3
from mapmerge_torch.ops.neighbors import neighbor_moments


@dataclasses.dataclass(frozen=True)
class SurfaceNormals:
    """Per-point normals aligned index for index with their cloud."""

    normals: torch.Tensor  # (N, 3) float32, unit length (or +z placeholder)
    curvature: torch.Tensor  # (N,) float32
    valid: torch.Tensor  # (N,) bool


def compute_surface_normals(
    cloud: PointCloud,
    radius: float,
    viewpoint: tuple[float, float, float] = (0.0, 0.0, 0.0),
    tile: int = 1024,
    engine: str = "auto",
) -> SurfaceNormals:
    count, _, cov, _ = neighbor_moments(
        cloud.xyz, cloud.xyz, radius, p_mask=cloud.mask, tile=tile,
        engine=engine,
    )
    lam, normal, ok = smallest_eigenpair3(cov)
    valid = cloud.mask & ok & (count >= 3.0)

    vp = torch.tensor(viewpoint, dtype=torch.float32, device=cloud.device)
    flip = (normal * (vp[None, :] - cloud.xyz)).sum(dim=-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)

    lam_sum = lam[..., 0] + lam[..., 1] + lam[..., 2]
    curvature = torch.where(
        lam_sum > 1e-12, lam[..., 0] / lam_sum.clamp_min(1e-12), 0.0
    )
    curvature = torch.where(valid, curvature, 0.0)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=cloud.device)
    normal = torch.where(valid[:, None], normal, up)
    return SurfaceNormals(normals=normal, curvature=curvature, valid=valid)
