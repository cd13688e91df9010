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


def _segment_sums(
    vals: torch.Tensor,
    boundary: torch.Tensor,
    seg_ids: torch.Tensor,
    cap: int,
    live: torch.Tensor,
) -> torch.Tensor:
    """(cap, C) sums of the contiguous segments of `vals` (N, C) that
    `boundary` (N,) starts; segment ids at or past `cap` are dropped. Rows
    outside `live` must be zero; they do not set the depth of the scan (the
    masked rows form one long segment at the end of the key order).

    A segmented inclusive scan by doubling: step k adds the running sum
    2^k rows back when that row lies in the same segment, so every segment
    adds its rows in one fixed order and the sums are the same bits on
    every run (a CUDA index_add_ adds by float atomics, in an order that
    varies from run to run). The last row of each segment holds its sum."""
    n = vals.shape[0]
    dev = vals.device
    rows = torch.arange(n, device=dev)
    start = torch.cummax(torch.where(boundary, rows, 0), dim=0).values
    pos = rows - start  # rank of each row inside its segment
    longest = int(torch.where(live, pos, 0).max()) + 1 if n else 0
    scan, step = vals, 1
    while step < longest:
        back = torch.nn.functional.pad(scan[:-step], (0, 0, step, 0))
        scan = scan + torch.where((pos >= step)[:, None], back, 0.0)
        step *= 2
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = boundary[1:]
    # each kept segment's last row writes its own slot once; every other row
    # goes to the scrap slot `cap`
    sums = torch.zeros((cap + 1, vals.shape[1]), dtype=vals.dtype, device=dev)
    sums[torch.where(last, seg_ids, cap)] = scan
    return sums[:cap]


def voxel_downsample(
    cloud: PointCloud,
    resolution: float,
    out_capacity: int | None = None,
    with_stats: bool = False,
) -> PointCloud | tuple[PointCloud, torch.Tensor]:
    """One centroid per occupied `resolution`-cube; see the module docstring.

    Segment sums add in one fixed order (`_segment_sums`), so a cloud gives
    the same centroids bit for bit on every run; they agree with the
    reference's scatter-add to float tolerance."""
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

    # the 7 channels [w, x*w, y*w, z*w, r*w, g*w, b*w]; masked rows carry
    # w = 0 (and their FAR coordinates * 0 = 0)
    vals = torch.cat([w[:, None], xyz * w[:, None], rgb * w[:, None]], dim=1)
    sums = _segment_sums(vals, boundary, seg_ids, cap, live=w > 0)
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
