"""Voxel-grid downsampling (port of mapmerge_tpu/ops/downsample.py).

pcl::VoxelGrid: each occupied `resolution`-cube becomes the centroid of its
points, RGB included. Points are sorted lexicographically by integer voxel
key (x first, then y, then z; ties keep input order), runs of equal keys
become segments, and centroids come from segment sums. Occupied voxels are
compacted to the front; voxels past `out_capacity` in key order are dropped
and, with `with_stats`, counted.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import FAR, PointCloud

_KEY_SENTINEL = torch.iinfo(torch.int32).max


def _lexsort(kx: torch.Tensor, ky: torch.Tensor, kz: torch.Tensor):
    """Permutation sorting by (kx, ky, kz) with kx most significant, ties in
    input order: jnp.lexsort((kz, ky, kx)) as three stable sorts, least
    significant key first."""
    order = torch.argsort(kz, stable=True)
    order = order[torch.argsort(ky[order], stable=True)]
    return order[torch.argsort(kx[order], stable=True)]


def voxel_downsample(
    cloud: PointCloud,
    resolution: float,
    out_capacity: int | None = None,
    with_stats: bool = False,
) -> PointCloud | tuple[PointCloud, torch.Tensor]:
    """One centroid per occupied `resolution`-cube; see the module docstring.

    Segment sums use index_add_, whose order of additions on CUDA varies from
    run to run (atomics): centroids agree with the reference to float
    tolerance, not bit for bit."""
    n = cloud.capacity
    cap = out_capacity or n
    inv = float(torch.tensor(1.0 / resolution, dtype=torch.float32))
    dev = cloud.device

    mask = cloud.mask
    xyz_safe = torch.where(mask[:, None], cloud.xyz, 0.0)
    keys = torch.floor(xyz_safe * inv).to(torch.int32)
    kx, ky, kz = (
        torch.where(mask, keys[:, c], _KEY_SENTINEL) for c in range(3)
    )
    order = _lexsort(kx, ky, kz)
    kx, ky, kz = kx[order], ky[order], kz[order]
    xyz = cloud.xyz[order]
    rgb = cloud.rgb[order]
    w = mask[order].to(torch.float32)

    # segment boundaries: the first element, or any key component change
    boundary = torch.ones((n,), dtype=torch.bool, device=dev)
    boundary[1:] = (kx[1:] != kx[:-1]) | (ky[1:] != ky[:-1]) | (kz[1:] != kz[:-1])
    seg = torch.cumsum(boundary.to(torch.int32), dim=0) - 1
    overflow = seg >= cap
    seg_ids = torch.where(overflow, cap, seg).to(torch.int64)  # cap = scrap

    # one index_add_ over the 7 channels [w, x*w, y*w, z*w, r*w, g*w, b*w];
    # masked rows carry w = 0 (and their FAR coordinates * 0 = 0)
    vals = torch.cat([w[:, None], xyz * w[:, None], rgb * w[:, None]], dim=1)
    sums = torch.zeros((cap + 1, 7), dtype=torch.float32, device=dev)
    sums.index_add_(0, seg_ids, vals)
    sums = sums[:cap]
    wsum = sums[:, 0]
    denom = wsum.clamp_min(1.0)[:, None]

    out_mask = wsum > 0.0
    out_xyz = torch.where(out_mask[:, None], sums[:, 1:4] / denom, FAR)
    out_rgb = torch.where(out_mask[:, None], sums[:, 4:7] / denom, 0.0)
    out = PointCloud(xyz=out_xyz, rgb=out_rgb, mask=out_mask)
    if with_stats:
        dropped = torch.where(overflow, w, 0.0).sum().to(torch.int32)
        return out, dropped
    return out
