"""Shared inputs for the parity tests of mapmerge_torch against mapmerge_tpu.

Inputs are made with numpy from a seed and handed to both packages as
arrays; nothing here decides anything about devices.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_torch.core.cloud import PointCloud as TorchCloud
from mapmerge_torch.testing.scene import (
    make_scene,
    overlapping_views,
    rotation_z,
    se3,
)

#: the slice test's configuration (SIFT + FPFH, dense engine, small caps)
SLICE_PARAMS = MergeParams(
    keypoint_type="SIFT",
    keypoint_threshold=3.0,
    descriptor_type="FPFH",
    refine_transform=True,
    max_iterations=50,
    max_points=8192,
    max_keypoints=256,
    max_neighbors=48,
    ransac_hypotheses=512,
    neighbor_tile=512,
)


def both_clouds(xyz, rgb=None, capacity=None):
    """The same padded cloud in both packages."""
    return (
        JaxCloud.from_arrays(xyz, rgb, capacity=capacity),
        TorchCloud.from_numpy(xyz, rgb, capacity=capacity),
    )


def small_scene():
    """The slice test's scene (tests/test_oracle_parity.py:39-44):
    ((a_xyz, a_rgb), (b_xyz, b_rgb), capacity, truth)."""
    xyz, rgb = make_scene(
        np.random.default_rng(7), n_boxes=6, extent=8.0, density=60.0
    )
    truth = se3(rotation_z(0.4), [1.5, -0.7, 0.2])
    va, vb, cap = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    return va, vb, cap, truth


def t(a) -> torch.Tensor:
    """numpy / jax array -> torch tensor (a copy)."""
    return torch.from_numpy(np.array(a, copy=True))


def rel_pose(transforms) -> np.ndarray:
    return np.linalg.inv(transforms[0]) @ transforms[1]
