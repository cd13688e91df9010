"""Keypoint detection (port of mapmerge_tpu/ops/keypoints): the
reference's switch between SIFT (`sift.py`) and Harris3D (`harris.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.enums import Keypoint
from mapmerge_torch.ops.normals import SurfaceNormals


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """Fixed-capacity keypoint set with detector responses
    (mapmerge_tpu/ops/keypoints/harris.py:34)."""

    xyz: torch.Tensor  # (K, 3) float32
    response: torch.Tensor  # (K,) float32
    mask: torch.Tensor  # (K,) bool
    #: above-threshold detections beyond `max_keypoints` that the top-k cut
    #: dropped; surfaced as a warning by estimate_maps_transforms
    truncated: torch.Tensor


def detect_keypoints(
    cloud: PointCloud,
    normals: SurfaceNormals,
    kind: Keypoint,
    threshold: float,
    radius: float,
    resolution: float,
    max_keypoints: int,
    tile: int = 1024,
    sift_octaves: int = 3,
    sift_scales_per_octave: int = 3,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Keypoints:
    """The reference switch (features.cpp:85-97): SIFT(min_scale=resolution,
    octaves, scales, min_contrast=threshold) or HARRIS(threshold, radius)
    with non-max suppression and refinement."""
    if kind == Keypoint.HARRIS:
        from mapmerge_torch.ops.keypoints.harris import detect_keypoints_harris

        return detect_keypoints_harris(
            cloud, normals, threshold=threshold, radius=radius,
            max_keypoints=max_keypoints, tile=tile, engine=engine,
            scan_cap=scan_cap,
        )
    if kind == Keypoint.SIFT:
        from mapmerge_torch.ops.keypoints.sift import detect_keypoints_sift

        return detect_keypoints_sift(
            cloud,
            min_scale=resolution,
            octaves=sift_octaves,
            scales_per_octave=sift_scales_per_octave,
            min_contrast=threshold,
            max_keypoints=max_keypoints,
            tile=tile,
            engine=engine,
            scan_cap=scan_cap,
        )
    raise ValueError(f"unknown keypoint type: {kind}")
