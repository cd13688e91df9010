"""State carried across from the JAX package.

Turns the JAX package's arrays, as numpy, into the port's dataclasses, so
that an intermediate made by `mapmerge_tpu` can feed a port stage (for
example JAX features into the port's `estimate_transform`). Takes any
object with the reference's attribute names, e.g. the output of
`jax.tree_util.tree_map(np.asarray, features)`; nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals
from mapmerge_torch.pipeline.features import CloudFeatures


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def cloud_from_numpy(cloud, device="cpu") -> PointCloud:
    """A padded cloud (xyz, rgb, mask kept as they are, parking included)."""
    return PointCloud(
        xyz=_t(cloud.xyz, device), rgb=_t(cloud.rgb, device),
        mask=_t(cloud.mask, device),
    )


def features_from_numpy(features, device="cpu") -> CloudFeatures:
    """A full CloudFeatures from the reference's CloudFeatures as numpy."""
    n, k, d = features.normals, features.keypoints, features.descriptors
    return CloudFeatures(
        cloud=cloud_from_numpy(features.cloud, device),
        normals=SurfaceNormals(
            normals=_t(n.normals, device), curvature=_t(n.curvature, device),
            valid=_t(n.valid, device),
        ),
        keypoints=Keypoints(
            xyz=_t(k.xyz, device), response=_t(k.response, device),
            mask=_t(k.mask, device), truncated=_t(k.truncated, device),
        ),
        descriptors=Descriptors(
            data=_t(d.data, device), valid=_t(d.valid, device)
        ),
        dropped_points=_t(features.dropped_points, device),
    )
