"""Per-cloud feature stage, dense engine (port of
mapmerge_tpu/pipeline/features.py).

The reference's stage order (map_merging.cpp:211-242): voxel downsample ->
outlier removal -> normals -> keypoints -> descriptors, with keypoint
radius = normal_radius, SIFT min_scale = resolution, descriptor radius =
descriptor_radius. Each stage is its own eager call, so the reference's
separately-staged big-cloud path needs no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_tpu.core.params import MergeParams
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors import Descriptors, compute_descriptors
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.keypoints import Keypoints, detect_keypoints
from mapmerge_torch.ops.neighbors import check_dense
from mapmerge_torch.ops.normals import SurfaceNormals, compute_surface_normals
from mapmerge_torch.ops.outliers import remove_outliers


@dataclasses.dataclass(frozen=True)
class CloudFeatures:
    """Everything the pairwise stage needs about one cloud."""

    cloud: PointCloud  # registration-resolution cloud (padded, masked)
    normals: SurfaceNormals
    keypoints: Keypoints
    descriptors: Descriptors
    #: valid input points dropped because the voxel grid overflowed
    #: `max_points`; surfaced as a warning by estimate_maps_transforms
    dropped_points: torch.Tensor


def extract_features(cloud: PointCloud, params: MergeParams) -> CloudFeatures:
    """Reference stage order map_merging.cpp:211-242."""
    resized, dropped = voxel_downsample(
        cloud,
        params.resolution,
        # a voxel grid never grows the cloud; don't pad past the input
        out_capacity=min(cloud.capacity, params.max_points),
        with_stats=True,
    )
    engine = params.neighbor_engine
    check_dense(engine, resized.capacity)
    resized = remove_outliers(
        resized, params.descriptor_radius, params.outliers_min_neighbours,
        tile=params.neighbor_tile, engine=engine,
    )
    normals = compute_surface_normals(
        resized, params.normal_radius, tile=params.neighbor_tile, engine=engine,
    )
    keypoints = detect_keypoints(
        resized,
        normals,
        params.keypoint_type,
        threshold=params.keypoint_threshold,
        radius=params.normal_radius,  # map_merging.cpp:233
        resolution=params.resolution,
        max_keypoints=params.max_keypoints,
        tile=params.neighbor_tile,
        sift_octaves=params.sift_octaves,
        sift_scales_per_octave=params.sift_scales_per_octave,
        engine=engine,
    )
    descriptors = compute_descriptors(
        resized,
        normals,
        keypoints,
        params.descriptor_type,
        params.descriptor_radius,
        max_neighbors=params.max_neighbors,
        tile=params.neighbor_tile,
        engine=engine,
    )
    # the reference drops keypoints whose descriptors are invalid
    # (features.cpp:118-141); masks keep the tensors aligned here
    keypoints = dataclasses.replace(
        keypoints, mask=keypoints.mask & descriptors.valid
    )
    return CloudFeatures(
        cloud=resized,
        normals=normals,
        keypoints=keypoints,
        descriptors=descriptors,
        dropped_points=dropped,
    )
