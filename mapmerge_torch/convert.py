"""State carried across from the JAX package.

Turns the JAX package's arrays, as numpy, and its parameters into the
port's dataclasses, so that an intermediate made by `mapmerge_tpu` can feed
a port stage (for example JAX features into the port's
`estimate_transform`). Takes any object with the reference's attribute
names, e.g. the output of `jax.tree_util.tree_map(np.asarray, features)`;
nothing here imports either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.device import resolve
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.normals import SurfaceNormals
from mapmerge_torch.pipeline.features import CloudFeatures


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_reference(p) -> MergeParams:
    """The port's MergeParams with the field values of `p`, any object with
    the reference's field names (enum members become the port's)."""
    return MergeParams(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(MergeParams)}
    )


def cloud_from_numpy(cloud, device=None) -> PointCloud:
    """A padded cloud (xyz, rgb, mask kept as they are, parking included),
    on `device` (the current CUDA device when None)."""
    device = resolve(device)
    return PointCloud(
        xyz=_t(cloud.xyz, device), rgb=_t(cloud.rgb, device),
        mask=_t(cloud.mask, device),
    )


def features_from_numpy(features, device=None) -> CloudFeatures:
    """A full CloudFeatures from the reference's CloudFeatures as numpy, on
    `device` (the current CUDA device when None)."""
    device = resolve(device)
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
        scan_overflow=_t(features.scan_overflow, device),
    )
