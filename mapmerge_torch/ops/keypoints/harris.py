"""Harris3D keypoints (port of mapmerge_tpu/ops/keypoints/harris.py).

pcl::HarrisKeypoint3D as the reference configures it (features.cpp:64-83):
the HARRIS response of the covariance of the valid surface normals in the
search radius, C = sum n n^T, r = det(C) - 0.04 tr(C)^2 (one radius_reduce
sum of the 9 outer-product channels); non-max suppression as a radius_reduce
max; the top `max_keypoints` survivors above the threshold; then a fixed 3
refinement solves sum(n n^T) x = sum(n n^T p).
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import FAR, PointCloud
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import BIG, _f32, radius_reduce
from mapmerge_torch.ops.normals import SurfaceNormals
from mapmerge_torch.ops.rigid import _det3

_HARRIS_K = 0.04
_REFINE_ITERS = 3  # HarrisKeypoint3D refine on (features.cpp:64-83)


def _outer(normals: SurfaceNormals) -> torch.Tensor:
    """(P, 3, 3) n n^T of the valid normals (zero elsewhere)."""
    n = torch.where(normals.valid[:, None], normals.normals, 0.0)
    return n[:, :, None] * n[:, None, :]


def harris_response(
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int = 1024,
    engine: str = "auto",
) -> torch.Tensor:
    """HARRIS corner response per cloud point; -BIG at invalid slots."""
    ok = cloud.mask & normals.valid
    _, sums, _ = radius_reduce(
        cloud.xyz, cloud.xyz, radius, _outer(normals).reshape(-1, 9),
        p_mask=ok, tile=tile, engine=engine,
    )
    c = sums.reshape(-1, 3, 3)
    trace = c[:, 0, 0] + c[:, 1, 1] + c[:, 2, 2]
    resp = _det3(c) - _HARRIS_K * trace * trace
    return torch.where(ok, resp, -BIG)


def _refine_step(
    kp_xyz: torch.Tensor,
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int,
    engine: str = "auto",
) -> torch.Tensor:
    """One corner-refinement solve sum(n n^T) x = sum(n n^T p) by the
    adjugate. An ill-conditioned system, or a solution that moves more than
    `radius`, keeps the point."""
    outer = _outer(normals)
    nntp = (outer * cloud.xyz[:, None, :]).sum(dim=-1)  # (P, 3)
    values = torch.cat([outer.reshape(-1, 9), nntp], dim=-1)  # (P, 12)
    _, sums, _ = radius_reduce(
        kp_xyz, cloud.xyz, radius, values, p_mask=cloud.mask & normals.valid,
        tile=tile, engine=engine,
    )
    a = sums[:, :9].reshape(-1, 3, 3)
    b = sums[:, 9:]
    det = _det3(a)
    adj = torch.stack(
        [
            a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1],
            a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2],
            a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1],
            a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2],
            a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0],
            a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2],
            a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0],
            a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1],
            a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0],
        ],
        dim=-1,
    ).reshape(-1, 3, 3)
    trace = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    well = det.abs() > 1e-9 * trace.clamp_min(1e-9) ** 3
    x = (adj * b[:, None, :]).sum(dim=-1) / torch.where(well, det, 1.0)[:, None]
    moved2 = ((x - kp_xyz) ** 2).sum(dim=-1)
    keep_new = well & (moved2 <= _f32(radius * radius))
    return torch.where(keep_new[:, None], x, kp_xyz)


def detect_keypoints_harris(
    cloud: PointCloud,
    normals: SurfaceNormals,
    threshold: float,
    radius: float,
    max_keypoints: int,
    tile: int = 1024,
    engine: str = "auto",
) -> Keypoints:
    """Reference features.cpp:64-83: non-max suppression on, refine on.

    Slots beyond the survivors are masked and parked at FAR; the order of
    equal responses is unspecified (it differs from lax.top_k's)."""
    resp = harris_response(cloud, normals, radius, tile=tile, engine=engine)
    ok = cloud.mask & normals.valid
    # non-max suppression: the own response must equal the neighborhood max
    _, nmax, _ = radius_reduce(
        cloud.xyz, cloud.xyz, radius, resp[:, None], p_mask=ok, tile=tile,
        reduce="max", engine=engine,
    )
    keep = ok & (resp >= nmax[:, 0]) & (resp > threshold)

    score = torch.where(keep, resp, -BIG)
    k = min(max_keypoints, score.shape[0])
    top_scores, top_idx = torch.topk(score, k)
    kp_mask = top_scores > -BIG / 2
    kp_xyz = cloud.xyz[top_idx]
    for _ in range(_REFINE_ITERS):
        kp_xyz = _refine_step(kp_xyz, cloud, normals, radius, tile, engine)
    return Keypoints(
        xyz=torch.where(kp_mask[:, None], kp_xyz, FAR),
        response=torch.where(kp_mask, top_scores, 0.0),
        mask=kp_mask,
        truncated=(keep.sum().to(torch.int32) - k).clamp_min(0),
    )
