"""3D shape context, ShapeContext1980 (port of
mapmerge_tpu/ops/descriptors/sc3d.py).

pcl::ShapeContext3DEstimation as the reference chooses it
(dispatch_descriptors.h:47-48): a spherical grid around each keypoint, 12
azimuth x 11 elevation x 15 log-spaced radial bins = 1980, each neighbour
weighted by 1 / (local density * cbrt(bin volume)), with min_radius = 0.1 *
radius and density radius = radius / 5 (PCL's defaults). As in the
reference, the grid sits in SHOT's repeatable local reference frame (the
Unique Shape Context construction) instead of PCL's random azimuth.

The weights are fractional, so they are summed in one fixed order
(shot._fixed_order_hist): a descriptor is the same bits on every run.
"""

from __future__ import annotations

import math

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.descriptors.shot import (
    _cbrt,
    _const,
    _dot,
    _fixed_order_hist,
    _local_reference_frames,
)
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import radius_count
from mapmerge_torch.ops.normals import SurfaceNormals

_AZIMUTH = 12
_ELEVATION = 11
_RADIAL = 15
SC3D_DIM = _AZIMUTH * _ELEVATION * _RADIAL  # 1980


def compute_sc3d(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """SC3D-1980 at each keypoint; valid with a frame and >= 5 neighbours."""
    # 1980 bins need a denser sample than the default gather cap (PCL uses
    # every in-radius neighbour): at least 128
    max_neighbors = max(max_neighbors * 2, 128)
    min_radius = 0.1 * radius
    dev = cloud.device

    # local point density of every surface point (PCL computePointDensity);
    # the reference leaves this query on its default engine
    density, _ = radius_count(
        cloud.xyz, cloud.xyz, radius / 5.0, p_mask=cloud.mask, tile=tile
    )
    idx, d2, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine,
        scan_cap=scan_cap,
    )
    nbr_xyz = cloud.xyz[idx]
    dist = torch.sqrt(d2.clamp_min(0.0))

    x_ax, y_ax, z_ax, lrf_ok = _local_reference_frames(
        keypoints.xyz, nbr_xyz, nmask, radius
    )
    off = nbr_xyz - keypoints.xyz[:, None, :]
    lx, ly, lz = _dot(off, x_ax), _dot(off, y_ax), _dot(off, z_ax)

    pa = (torch.atan2(ly, lx) + math.pi) / _const(2 * math.pi, dev) * _AZIMUTH
    a_bin = torch.floor(pa).clamp(0, _AZIMUTH - 1).to(torch.int64)
    r_xy = torch.sqrt((lx * lx + ly * ly).clamp_min(1e-12))
    pe = torch.atan2(r_xy, lz) / _const(math.pi, dev) * _ELEVATION  # from +z
    e_bin = torch.floor(pe).clamp(0, _ELEVATION - 1).to(torch.int64)

    # log-spaced shells between min_radius and radius; neighbours inside
    # min_radius land in shell 0, as in PCL
    log_ratio = torch.log(_const(radius / min_radius, dev))
    min_r = _const(min_radius, dev)
    r_cont = torch.log(dist.clamp_min(1e-9) / min_r) / log_ratio * _RADIAL
    r_bin = torch.floor(r_cont).clamp(0, _RADIAL - 1).to(torch.int64)

    steps = torch.arange(_RADIAL + 1, device=dev).to(torch.float32)
    edges = min_radius * torch.exp(steps / _const(_RADIAL, dev) * log_ratio)
    shell_vol = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    bin_vol = shell_vol / _const(_AZIMUTH * _ELEVATION, dev)
    cbrt_vol = _cbrt(bin_vol.clamp_min(1e-12))
    one = _const(1.0, dev)
    w_vol = one / cbrt_vol[r_bin]
    w_den = one / density.to(torch.float32).clamp_min(1.0)[idx]
    w = w_vol * w_den * nmask.to(torch.float32)

    joint = (a_bin * _ELEVATION + e_bin) * _RADIAL + r_bin  # (K, M)
    hist = _fixed_order_hist(joint, w, SC3D_DIM)
    data = hist / torch.sqrt((hist * hist).sum(dim=-1).clamp_min(1e-12))[:, None]

    valid = keypoints.mask & lrf_ok & (nmask.sum(dim=-1) >= 5)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
