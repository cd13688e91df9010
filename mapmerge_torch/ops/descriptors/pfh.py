"""PFH-125 and PFHRGB-250 descriptors (port of
mapmerge_tpu/ops/descriptors/pfh.py).

pcl::PFHEstimation, the reference's default descriptor (map_merging.h:35):
every pair of points in a keypoint's capped neighbourhood (the nearest
`max_neighbors` within the radius) gives Darboux features that go into a
joint 5 x 5 x 5 histogram, bin f1 + 5 f2 + 25 f3, scaled to sum 100. Each
unordered pair is counted twice, which the scaling cancels. PFHRGB appends a
second joint histogram of the per-channel colour ratios c1 / c2 over [0, 2).

The histograms are scatter-adds of 0/1 pair weights into a flat (K * 125)
index (the reference's one-hot einsum would be a (K, M*M, 125) tensor): the
sums are exact integers, so the result is the same bits in any order.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.descriptors.darboux import bin_index, pair_features
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals

_SPLIT = 5  # PCL nr_split_
_PI = 3.141592653589793


def _scaled_hist(joint: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, 125) histogram of joint bins (K, ...) weighted by w, each row
    scaled to sum 100 (all zero where nothing was counted)."""
    k = joint.shape[0]
    hist = torch.zeros((k, _SPLIT**3), dtype=torch.float32, device=w.device)
    hist.scatter_add_(1, joint.reshape(k, -1).to(torch.int64), w.reshape(k, -1))
    total = hist.sum(dim=-1, keepdim=True)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=w.device)
    return torch.where(total > 0, hist * (hundred / total.clamp_min(1e-9)), 0.0)


def _joint(b1: torch.Tensor, b2: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    return b1 + _SPLIT * b2 + _SPLIT * _SPLIT * b3


def _geometry_hist(cloud, normals, idx, nmask):
    """The PFH-125 histograms and the (K, M, M) pair weights."""
    pts = cloud.xyz[idx]  # (K, M, 3)
    nrm = normals.normals[idx]
    theta, alpha, phi, _, ok = pair_features(
        pts[:, :, None, :], nrm[:, :, None, :], pts[:, None, :, :],
        nrm[:, None, :, :],
    )
    w = (nmask[:, :, None] & nmask[:, None, :] & ok).to(torch.float32)
    joint = _joint(
        bin_index(theta, -_PI, _PI, _SPLIT),
        bin_index(alpha, -1.0, 1.0, _SPLIT),
        bin_index(phi, -1.0, 1.0, _SPLIT),
    )
    return _scaled_hist(joint, w), w


def compute_pfh(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
) -> Descriptors:
    """PFH-125 at each keypoint; valid with at least 2 neighbours."""
    idx, _, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine
    )
    hist, _ = _geometry_hist(cloud, normals, idx, nmask)
    valid = keypoints.mask & (nmask.sum(dim=-1) >= 2)
    return Descriptors(data=torch.where(valid[:, None], hist, 0.0), valid=valid)


def compute_pfhrgb(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
) -> Descriptors:
    """PFHRGB-250: PFH-125, then the colour-ratio histogram (PCL
    computeRGBPairFeatures) under the same pair weights."""
    idx, _, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine
    )
    geo, w = _geometry_hist(cloud, normals, idx, nmask)
    cols = cloud.rgb[idx]  # (K, M, 3)
    ratio = cols[:, :, None, :] / cols[:, None, :, :].clamp_min(1e-4)
    b = bin_index(ratio, 0.0, 2.0, _SPLIT)  # (K, M, M, 3)
    color = _scaled_hist(_joint(b[..., 0], b[..., 1], b[..., 2]), w)
    data = torch.cat([geo, color], dim=-1)
    valid = keypoints.mask & (nmask.sum(dim=-1) >= 2)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
