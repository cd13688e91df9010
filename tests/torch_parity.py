"""Shared inputs for the parity tests of mapmerge_torch against mapmerge_tpu.

Inputs are made with numpy from a seed and handed to both packages as
arrays; the port's side is put on the CPU by name (its entry points default
to the card), and is handed the port's own MergeParams (`port_params`).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_torch import convert
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch CPU work on one intra-op thread, restored after
    the module (an autouse fixture for the port's test files that import
    it). The suite runs six test processes at once, and torch's default of
    a thread a core in each of them oversubscribes the host: on an 8-core
    host six concurrent copies of a node test that takes ~8 s alone took
    ~690 s each, and ~45 s with one thread each. Tolerances and bit-for-bit
    comparisons within a module hold under either setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_native():
    """mapmerge_tpu.native with its library loaded. That package builds the
    library in place on first use, so a test process that loads it while
    another process builds it gets None, and the package then takes its
    pure-Python path for the rest of the process: wait for the other build
    instead (a minute at most), so the JAX side is its default, native path."""
    from mapmerge_tpu import native

    for _ in range(60):
        if native.get_lib() is not None:
            return native
        native._tried = False
        time.sleep(1.0)
    raise RuntimeError("mapmerge_tpu's native library did not build (g++?)")


def both_clouds(xyz, rgb=None, capacity=None):
    """The same padded cloud in both packages."""
    return (
        JaxCloud.from_arrays(xyz, rgb, capacity=capacity),
        TorchCloud.from_numpy(xyz, rgb, capacity=capacity, device="cpu"),
    )


def port_params(p):
    """The port's MergeParams with the field values of the reference's `p`."""
    return convert.params_from_reference(p)


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
