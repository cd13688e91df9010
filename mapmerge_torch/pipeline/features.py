"""Per-cloud feature stage (port of mapmerge_tpu/pipeline/features.py).

The reference's stage order (map_merging.cpp:211-242): voxel downsample ->
outlier removal -> normals -> keypoints -> descriptors, with keypoint
radius = normal_radius, SIFT min_scale = resolution, descriptor radius =
descriptor_radius. Each stage is its own eager call, one after another, so
the reference's `extract_features_staged` (separately jitted stages, which
exist because one fused XLA program ran out of memory at 1M points) needs
no counterpart here: `extract_features` is the big-cloud path too.
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.ops.descriptors import Descriptors, compute_descriptors
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.grid import build_grid, max_bucket_count
from mapmerge_torch.ops.keypoints import Keypoints, detect_keypoints
from mapmerge_torch.ops.neighbors import _resolve_engine
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
    #: under the grid engine: how far the fullest hash bucket exceeds its
    #: cap (0 = every neighbour query was exact); surfaced as a warning
    scan_overflow: torch.Tensor


def overflow_probe(resized: PointCloud, params: MergeParams) -> torch.Tensor:
    """The grid engine's bucket overflow on the pre-outlier cloud: the
    fullest bucket of a descriptor-radius grid over grid_scan_cap, and of a
    correspondence-radius grid over registration_scan_cap, whichever is
    larger (0 on the dense engine). The outlier pass queries this cloud and
    every later stage a subset of it, so it bounds them all."""
    if _resolve_engine(params.neighbor_engine, resized.capacity) != "grid":
        return torch.zeros((), dtype=torch.int32, device=resized.device)
    probe_f = build_grid(resized.xyz, resized.mask, params.descriptor_radius)
    probe_r = build_grid(
        resized.xyz, resized.mask, params.max_correspondence_distance
    )
    return torch.maximum(
        (max_bucket_count(probe_f) - params.grid_scan_cap).clamp_min(0),
        (max_bucket_count(probe_r) - params.registration_scan_cap).clamp_min(0),
    )


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
    scan_cap = params.grid_scan_cap
    scan_overflow = overflow_probe(resized, params)
    resized = remove_outliers(
        resized, params.descriptor_radius, params.outliers_min_neighbours,
        tile=params.neighbor_tile, engine=engine, scan_cap=scan_cap,
    )
    normals = compute_surface_normals(
        resized, params.normal_radius, tile=params.neighbor_tile, engine=engine,
        scan_cap=scan_cap,
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
        scan_cap=scan_cap,
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
        scan_cap=scan_cap,
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
        scan_overflow=scan_overflow,
    )
