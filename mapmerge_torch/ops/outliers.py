"""Radius outlier removal (port of mapmerge_tpu/ops/outliers.py).

pcl::RadiusOutlierRemoval: points with fewer than `min_neighbors` points
within `radius` (the point itself included) lose their mask bit.
"""

from __future__ import annotations

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.neighbors import radius_count


def remove_outliers(
    cloud: PointCloud,
    radius: float,
    min_neighbors: int,
    tile: int = 1024,
    engine: str = "auto",
) -> PointCloud:
    counts, _ = radius_count(
        cloud.xyz, cloud.xyz, radius, p_mask=cloud.mask, tile=tile,
        include_self=True, engine=engine,
    )
    keep = cloud.mask & (counts >= min_neighbors)
    return PointCloud(xyz=cloud.xyz, rgb=cloud.rgb, mask=keep).park_invalid()
