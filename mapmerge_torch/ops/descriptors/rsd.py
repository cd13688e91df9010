"""RSD, the radius-based surface descriptor (port of
mapmerge_tpu/ops/descriptors/rsd.py).

pcl::RSDEstimation -> PrincipalRadiiRSD: from d(alpha) ~= 2 r sin(alpha/2)
between a neighbour's distance d and the angle alpha between its normal and
the keypoint's, the neighbours are binned by angle; the least distance per
bin gives a radius estimate, and the extremes over the occupied bins give
(r_min, r_max), clamped at PCL's default plane radius of 0.2 m
(near-parallel normals: locally planar). A keypoint with no occupied bin
gets that radius for both.
"""

from __future__ import annotations

import math

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.descriptors.darboux import bin_index
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals

_ANGLE_BINS = 5  # PCL nr_subdiv default
_PLANE_RADIUS = 0.2  # PCL plane_radius default
_BIG = 1.0e12


def compute_rsd(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """(r_min, r_max) at each keypoint; valid with at least 3 neighbours."""
    idx, d2, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine,
        scan_cap=scan_cap,
    )
    dist = torch.sqrt(d2.clamp_min(0.0))  # (K, M)
    dev = dist.device

    nbr_nrm = normals.normals[idx]  # (K, M, 3)
    # the keypoint's normal: its nearest surface point's (a refined keypoint
    # need not sit on a cloud point)
    kp_nrm = nbr_nrm[:, 0, :]
    cos_a = (kp_nrm[:, None, :] * nbr_nrm).sum(dim=-1).abs().clamp(0.0, 1.0)
    half_pi = math.pi / 2.0
    abin = bin_index(torch.arccos(cos_a), 0.0, half_pi, _ANGLE_BINS)

    bins = torch.arange(_ANGLE_BINS, device=dev)
    in_bin = nmask[..., None] & (abin[..., None] == bins)  # (K, M, A)
    dmin = torch.where(in_bin, dist[..., None], _BIG).amin(dim=1)  # (K, A)
    bin_has = dmin < _BIG / 2

    five = torch.tensor(float(_ANGLE_BINS), device=dev)
    centers = (bins.to(torch.float32) + 0.5) / five * half_pi
    two = torch.tensor(2.0, device=dev)
    r_est = dmin / (2.0 * torch.sin(centers / two)).clamp_min(1e-6)[None, :]
    r_est = r_est.clamp(0.0, _PLANE_RADIUS)

    # nanmin / nanmax over the occupied bins, the plane radius where none is
    any_bin = bin_has.any(dim=-1)
    r_min = torch.where(bin_has, r_est, torch.inf).amin(dim=-1)
    r_max = torch.where(bin_has, r_est, -torch.inf).amax(dim=-1)
    r_min = torch.where(any_bin, r_min, _PLANE_RADIUS)
    r_max = torch.where(any_bin, r_max, _PLANE_RADIUS)

    valid = keypoints.mask & (nmask.sum(dim=-1) >= 3)
    data = torch.stack([r_min, r_max], dim=-1)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
