"""Descriptor dispatch registry (port of mapmerge_tpu/ops/descriptors).

One call surface for the reference's six descriptors
(dispatch_descriptors.h:28-121), chosen by enum, or by the dimensionality
of the data itself (the reference recovers the type from the field name,
matching.cpp:96-107).
"""

from __future__ import annotations

from typing import Callable

from mapmerge_tpu.core.enums import DESCRIPTOR_DIMS, Descriptor
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.descriptors.fpfh import compute_fpfh
from mapmerge_torch.ops.descriptors.pfh import compute_pfh, compute_pfhrgb
from mapmerge_torch.ops.descriptors.rsd import compute_rsd
from mapmerge_torch.ops.descriptors.sc3d import compute_sc3d
from mapmerge_torch.ops.descriptors.shot import compute_shot
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals

_REGISTRY: dict[Descriptor, Callable] = {
    Descriptor.FPFH: compute_fpfh,
    Descriptor.PFH: compute_pfh,
    Descriptor.PFHRGB: compute_pfhrgb,
    Descriptor.RSD: compute_rsd,
    Descriptor.SHOT: compute_shot,
    Descriptor.SC3D: compute_sc3d,
}


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
    """`kind` descriptors at the keypoints over the `cloud` surface
    (reference features.cpp:152-166)."""
    fn = _REGISTRY.get(kind)
    if fn is None:
        raise ValueError(f"unknown descriptor type: {kind}")
    return fn(
        cloud, normals, keypoints, radius, max_neighbors=max_neighbors,
        tile=tile, engine=engine,
    )


def descriptor_kind_from_dim(dim: int) -> Descriptor:
    """The descriptor type of `dim`-wide data."""
    for kind, d in DESCRIPTOR_DIMS.items():
        if d == dim:
            return kind
    raise ValueError(f"no descriptor type with dimensionality {dim}")


__all__ = ["Descriptors", "compute_descriptors", "descriptor_kind_from_dim"]
