"""The slice as a whole: estimate_maps_transforms + compose_maps of the port
against mapmerge_tpu's on the small SIFT+FPFH scene, against the ground
truth, and the reference's contracts for empty, single and failed inputs;
then the other operating points on the same scene: HARRIS+FPFH, SIFT+PFH
and the reference's defaults, `MergeParams()` with no overrides.

Gate (tests/test_oracle_parity.py:37-64): the relative pose within 1 deg /
0.1 m of the reference pipeline's and of the ground truth. RANSAC draws
differ between the packages (jax.random against torch.Generator), so the
comparison is at the pose level.
"""

import warnings

import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.pipeline.merging import compose_maps as j_compose
from mapmerge_tpu.pipeline.merging import estimate_maps_transforms as j_estimate
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import PointCloud as TorchCloud
from mapmerge_torch.parallel.mesh import make_mesh
from mapmerge_torch.pipeline.merging import compose_maps as t_compose
from mapmerge_torch.pipeline.merging import estimate_maps_transforms as t_estimate
from mapmerge_torch.pipeline.merging import pair_generator

from torch_parity import SLICE_PARAMS, port_params, rel_pose, small_scene
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def scene():
    va, vb, cap, truth = small_scene()
    jax_clouds = [JaxCloud.from_arrays(*v, capacity=cap) for v in (va, vb)]
    torch_clouds = [
        TorchCloud.from_numpy(*v, capacity=cap, device="cpu") for v in (va, vb)
    ]
    return jax_clouds, torch_clouds, truth


@pytest.fixture(scope="module")
def merged(scene):
    jax_clouds, torch_clouds, _ = scene
    info = {}
    ours = t_estimate(torch_clouds, port_params(SLICE_PARAMS), seed=0, info_out=info)
    theirs = j_estimate(jax_clouds, SLICE_PARAMS, seed=0)
    return ours, theirs, info


class TestSlice:
    def test_poses_match_reference_and_truth(self, scene, merged):
        ours, theirs, info = merged
        assert len(ours) == len(theirs) == 2
        assert all(t.shape == (4, 4) and t.dtype == np.float32 for t in ours)
        assert np.isfinite(np.stack(ours)).all()
        rot, trans = ttf.pose_error(rel_pose(ours), rel_pose(theirs))
        assert rot < 1.0 and trans < 0.1, (rot, trans)
        rot, trans = ttf.pose_error(rel_pose(ours), scene[2])
        assert rot < 1.0 and trans < 0.1, (rot, trans)
        assert info == {
            "n_pairs": 1, "n_failed": 0, "n_ambiguous": 0, "ambiguous_pairs": []
        }

    def test_compose_maps_matches_reference(self, scene, merged):
        jax_clouds, torch_clouds, _ = scene
        transforms = merged[1]  # the same transforms into both
        jm = j_compose(jax_clouds, transforms, SLICE_PARAMS.output_resolution)
        tm = t_compose(torch_clouds, transforms, SLICE_PARAMS.output_resolution)
        assert tm.capacity == jm.capacity
        jmask, tmask = np.asarray(jm.mask), tm.mask.numpy()
        # voxel keys of points on a voxel face may round either way
        assert abs(int(tmask.sum()) - int(jmask.sum())) <= 0.002 * jmask.sum()
        if tmask.sum() == jmask.sum():
            np.testing.assert_allclose(
                tm.xyz.numpy()[tmask], np.asarray(jm.xyz)[jmask], atol=0.06
            )
        # a zero transform drops its cloud (map_merging.cpp:293-295)
        zero = [transforms[0], np.zeros((4, 4), np.float32)]
        one = t_compose(torch_clouds, zero, 0.05)
        alone = t_compose(torch_clouds[:1], transforms[:1], 0.05)
        assert torch.equal(one.mask, alone.mask)
        assert torch.equal(one.xyz, alone.xyz)

    def test_pair_generator_is_keyed_on_seed_and_pair(self):
        a = torch.rand(4, generator=pair_generator(0, 0, "cpu"))
        b = torch.rand(4, generator=pair_generator(0, 0, "cpu"))
        c = torch.rand(4, generator=pair_generator(0, 1, "cpu"))
        d = torch.rand(4, generator=pair_generator(1, 0, "cpu"))
        assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


#: the operating points beside the slice's SIFT+FPFH
OPERATING_POINTS = {
    # tests/test_oracle_parity.py:38-64
    "harris_fpfh": MergeParams.strict_parity(
        keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=50, max_points=16384,
        max_keypoints=256, max_neighbors=48, ransac_hypotheses=512,
        neighbor_tile=512,
    ),
    "sift_pfh": SLICE_PARAMS.replace(descriptor_type="PFH"),
    # SIFT + PFH-125 + MATCHING at the reference's caps (K 1024, M 64)
    "defaults": MergeParams(),
}


@pytest.mark.parametrize("name", sorted(OPERATING_POINTS))
def test_operating_point_matches_reference_and_truth(scene, name):
    """The relative pose within 1 deg / 0.1 m of the reference pipeline's
    and of the truth; where the reference fails (a zero matrix), the port
    fails too."""
    jax_clouds, torch_clouds, truth = scene
    params = OPERATING_POINTS[name]
    ours = t_estimate(torch_clouds, port_params(params), seed=0)
    theirs = j_estimate(jax_clouds, params, seed=0)
    assert len(ours) == len(theirs) == 2
    assert [t.any() for t in ours] == [bool(np.asarray(t).any()) for t in theirs]
    assert ours[1].any(), "registration failed"
    rot, trans = ttf.pose_error(rel_pose(ours), rel_pose(theirs))
    assert rot < 1.0 and trans < 0.1, (rot, trans)
    rot, trans = ttf.pose_error(rel_pose(ours), truth)
    assert rot < 1.0 and trans < 0.1, (rot, trans)


class TestContracts:
    """The reference's contracts (map_merging.h:81-84, cpp:188-305), held
    against mapmerge_tpu on the same inputs."""

    def test_empty_and_single(self, scene):
        jax_clouds, torch_clouds, _ = scene
        params = port_params(SLICE_PARAMS)
        assert t_estimate([], params) == j_estimate([], SLICE_PARAMS) == []
        ours = t_estimate(torch_clouds[:1], params)
        assert len(ours) == 1
        np.testing.assert_array_equal(ours[0], np.eye(4, dtype=np.float32))
        np.testing.assert_array_equal(
            ours[0], j_estimate(jax_clouds[:1], SLICE_PARAMS)[0]
        )
        assert t_compose([], [], 0.1) is None
        with pytest.raises(ValueError):
            t_compose(torch_clouds, [np.eye(4)], 0.1)
        empty = t_compose(torch_clouds, [np.zeros((4, 4))] * 2, 0.1)
        assert empty.capacity == 1 and not empty.mask.any()
        # the mesh is ported: a single cloud is the identity there too
        mesh = make_mesh(["cpu"])
        np.testing.assert_array_equal(
            t_estimate(torch_clouds[:1], params, mesh=mesh)[0], ours[0]
        )

    def test_clouds_without_keypoints(self, rng):
        """Uniform colour: SIFT finds nothing, no pair is generated, and
        the result is [] in both packages."""
        xyz = (rng.random((600, 3)) * 3).astype(np.float32)
        rgb = np.full((600, 3), 0.5, np.float32)
        ours = t_estimate(
            [TorchCloud.from_numpy(xyz, rgb, device="cpu")] * 2,
            port_params(SLICE_PARAMS),
        )
        theirs = j_estimate([JaxCloud.from_arrays(xyz, rgb)] * 2, SLICE_PARAMS)
        assert ours == theirs == []

    def test_failed_registration_and_warnings(self, scene):
        """An inlier threshold no pair can meet: RANSAC fails, the pair's
        transform is the zero matrix, and the merged result marks the
        unregistered map with a zero matrix as the reference does. A
        keypoint cap below the detections warns."""
        jax_clouds, torch_clouds, _ = scene
        params = SLICE_PARAMS.replace(inlier_threshold=1e-6, max_keypoints=16)
        info = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ours = t_estimate(torch_clouds, port_params(params), info_out=info)
        assert any("keypoint cap" in str(w.message) for w in caught)
        theirs = j_estimate(jax_clouds, params)
        assert info["n_failed"] == 1
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.any() == b.any()
        assert not all(t.any() for t in ours)
