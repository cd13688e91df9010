"""Descriptor dispatch registry (port of mapmerge_tpu/ops/descriptors).

Only FPFH-33 is ported; any other descriptor raises NotImplementedError.
"""

from __future__ import annotations

from typing import Callable

from mapmerge_tpu.core.enums import Descriptor
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.descriptors.fpfh import compute_fpfh
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals

_REGISTRY: dict[Descriptor, Callable] = {Descriptor.FPFH: compute_fpfh}


def compute_descriptors(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    kind: Descriptor,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
) -> Descriptors:
    """`kind` descriptors at the keypoints over the `cloud` surface."""
    fn = _REGISTRY.get(kind)
    if fn is None:
        raise NotImplementedError(
            f"descriptor {kind} is not ported to mapmerge_torch; available: "
            f"{sorted(k.value for k in _REGISTRY)}"
        )
    return fn(
        cloud, normals, keypoints, radius, max_neighbors=max_neighbors,
        tile=tile, engine=engine,
    )


__all__ = ["Descriptors", "compute_descriptors"]
