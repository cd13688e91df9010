"""FPFH-33 descriptors, dense engine (port of
mapmerge_tpu/ops/descriptors/fpfh.py).

pcl::FPFHEstimation: an SPFH histogram (11 theta, 11 alpha, 11 phi bins,
each block summing to 100) at every neighbour of every keypoint, over ALL
valid in-radius points of the cloud (the SPFH sweep kernel,
kernels/spfh.py); then FPFH(keypoint) = sum over its nearest `max_neighbors`
in-radius neighbours j at distance > 0 of SPFH_j / d_j, each 11-bin block
renormalised to 100. Keypoints with no weighted neighbour are invalid.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.kernels import spfh as spfh_kernel
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import check_dense
from mapmerge_torch.ops.normals import SurfaceNormals

_BINS = 11


def _spfh_dense(
    q_xyz: torch.Tensor,  # (K, M, 3)
    q_nrm: torch.Tensor,  # (K, M, 3)
    q_ok: torch.Tensor,  # (K, M)
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH (K, M, 33) at the given oriented query points + validity (K, M).

    Shared-candidate sweep: every query sees the whole cloud. Masked-out
    queries are swept too; their FAR coordinates fail every radius test."""
    p_ok = cloud.mask & normals.valid
    spfh, total = spfh_kernel.spfh_tile(
        q_xyz.contiguous(), q_nrm.contiguous(),
        cloud.xyz[None].contiguous(), normals.normals[None].contiguous(),
        p_ok[None].contiguous(), r2=float(radius) * float(radius),
    )
    return spfh, q_ok & (total > 0)


def compute_fpfh(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
) -> Descriptors:
    """FPFH-33 at each keypoint over the cloud surface."""
    check_dense(engine, cloud.capacity)
    idx, d2, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine
    )
    # SPFH only at the gathered neighbour points (PCL computeSPFHSignatures);
    # duplicates are recomputed
    spfh, spfh_ok = _spfh_dense(
        cloud.xyz[idx], normals.normals[idx], nmask, cloud, normals, radius,
    )

    dist = torch.sqrt(d2.clamp_min(0.0))
    w = torch.where(
        nmask & spfh_ok & (dist > 1e-9),
        torch.reciprocal(dist.clamp_min(1e-9)),
        0.0,
    )  # (K, M)
    fpfh = torch.einsum("km,kmd->kd", w, spfh)

    # renormalise each 11-bin block to sum 100
    blocks = fpfh.reshape(-1, 3, _BINS)
    sums = blocks.sum(dim=-1, keepdim=True)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=cloud.device)
    blocks = torch.where(sums > 0, blocks * (hundred / sums.clamp_min(1e-9)), 0.0)
    data = blocks.reshape(-1, 3 * _BINS)

    valid = keypoints.mask & (w.sum(dim=-1) > 0)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
