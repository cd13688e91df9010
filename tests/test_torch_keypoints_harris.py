"""Harris3D parity: the response, non-max suppression, the top-K cut with
its `truncated` count and the refinement, against mapmerge_tpu on the same
cloud and normals, and the keypoint dispatch of both detectors."""

import numpy as np
import pytest
import torch

from mapmerge_tpu.core.enums import Keypoint
from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
from mapmerge_tpu.ops.keypoints import harris as jh
from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
from mapmerge_torch import convert
from mapmerge_torch.ops.keypoints import detect_keypoints
from mapmerge_torch.ops.keypoints import harris as th
from mapmerge_torch.ops.keypoints.sift import detect_keypoints_sift
from mapmerge_torch.ops.normals import SurfaceNormals

from torch_parity import SLICE_PARAMS, both_clouds, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

RADIUS = SLICE_PARAMS.normal_radius  # features.py: Harris radius = normal_radius


@pytest.fixture(scope="module")
def surface():
    """The slice scene's view A after the reference's downsample, outlier
    removal and normals, in both packages."""
    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, _ = both_clouds(a_xyz, a_rgb, capacity=cap)
    p = SLICE_PARAMS
    jc = j_voxel(jc, p.resolution, out_capacity=min(cap, p.max_points))
    jc = j_outliers(jc, p.descriptor_radius, p.outliers_min_neighbours, tile=512)
    jn = j_normals(jc, p.normal_radius, tile=512)
    tn = SurfaceNormals(
        normals=t(jn.normals), curvature=t(jn.curvature), valid=t(jn.valid)
    )
    return jc, jn, convert.cloud_from_numpy(jc, "cpu"), tn


def test_response_matches_reference(surface):
    """rtol 1e-4, plus an absolute 1e-6 of the largest response: det - k tr^2
    cancels, so a small response keeps the rounding of the large terms."""
    jc, jn, tc, tn = surface
    jr = np.asarray(jh.harris_response(jc, jn, RADIUS, tile=512))
    tr = th.harris_response(tc, tn, RADIUS, tile=512).numpy()
    ok = np.asarray(jc.mask & jn.valid)
    assert ok.sum() > 1000
    np.testing.assert_array_equal(tr[~ok], jr[~ok])  # -BIG at invalid slots
    np.testing.assert_allclose(
        tr[ok], jr[ok], rtol=1e-4, atol=1e-6 * np.abs(jr[ok]).max()
    )


@pytest.mark.parametrize("max_keypoints", [256, 8])
def test_keypoints_match_reference(surface, max_keypoints):
    """The same keypoints as a set (slot order at equal responses is
    unspecified), refined positions within 1e-5 m, responses to rtol 1e-4,
    and the same `truncated` count (8 keypoints cut the survivors)."""
    jc, jn, tc, tn = surface
    jk = jh.detect_keypoints_harris(jc, jn, 1.0, RADIUS, max_keypoints, tile=512)
    tk = th.detect_keypoints_harris(tc, tn, 1.0, RADIUS, max_keypoints, tile=512)
    assert tk.xyz.shape == (max_keypoints, 3)
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tm.sum() == jm.sum() > 5
    assert int(tk.truncated) == int(jk.truncated)
    assert (int(tk.truncated) > 0) == (max_keypoints == 8)
    jx, tx = np.asarray(jk.xyz)[jm], tk.xyz.numpy()[tm]
    gap = np.abs(jx[:, None, :] - tx[None, :, :]).max(axis=-1)
    nearest = gap.argmin(axis=1)
    assert gap.min(axis=1).max() <= 1e-5
    assert len(set(nearest)) == len(nearest)  # one to one
    np.testing.assert_allclose(
        tk.response.numpy()[tm][nearest], np.asarray(jk.response)[jm], rtol=1e-4
    )
    # empty slots: parked at FAR with zero response
    assert (tk.xyz.numpy()[~tm] == 1e8).all() and not tk.response[~tk.mask].any()


def test_grid_engine_keypoints_match_reference(surface):
    """On the grid engine (the response and the suppression sweep the cell
    grid, kernel L's sweep route on a card; the refinement's few queries
    take the small-Q path, L's list route): the same keypoints as the
    reference's grid engine, refined positions within 1e-5 m, responses to
    rtol 1e-4."""
    jc, jn, tc, tn = surface
    jk = jh.detect_keypoints_harris(jc, jn, 1.0, RADIUS, 256, tile=512, engine="grid")
    tk = th.detect_keypoints_harris(tc, tn, 1.0, RADIUS, 256, tile=512, engine="grid")
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tm.sum() == jm.sum() > 5
    assert int(tk.truncated) == int(jk.truncated)
    jx, tx = np.asarray(jk.xyz)[jm], tk.xyz.numpy()[tm]
    gap = np.abs(jx[:, None, :] - tx[None, :, :]).max(axis=-1)
    nearest = gap.argmin(axis=1)
    assert gap.min(axis=1).max() <= 1e-5
    assert len(set(nearest)) == len(nearest)  # one to one
    np.testing.assert_allclose(
        tk.response.numpy()[tm][nearest], np.asarray(jk.response)[jm], rtol=1e-4
    )


def test_refine_step_guards(surface):
    """A well-conditioned corner moves by the adjugate solve as in the
    reference; a point on a plane (singular system) and a solution further
    than the radius both keep the point."""
    jc, jn, tc, tn = surface
    ok = np.flatnonzero(np.asarray(jc.mask & jn.valid))
    kp = np.asarray(jc.xyz)[ok[::40]]
    kp = np.concatenate([kp, [[0.0, 0.0, 50.0]]]).astype(np.float32)
    import jax.numpy as jnp

    jx = np.asarray(jh._refine_step(jnp.asarray(kp), jc, jn, RADIUS, 512))
    tx = th._refine_step(t(kp), tc, tn, RADIUS, 512).numpy()
    np.testing.assert_allclose(tx, jx, atol=1e-5)
    moved = np.abs(tx - kp).max(axis=1) > 0
    assert moved.any() and not moved.all()
    np.testing.assert_array_equal(tx[-1], kp[-1])  # no neighbours: kept


def test_dispatch(surface):
    """detect_keypoints takes the reference's signature and routes HARRIS
    (radius = the normal radius) and SIFT (min scale = resolution)."""
    _, _, tc, tn = surface
    harris = detect_keypoints(tc, tn, Keypoint.HARRIS, 1.0, RADIUS, 0.1, 64, tile=512)
    direct = th.detect_keypoints_harris(tc, tn, 1.0, RADIUS, 64, tile=512)
    assert torch.equal(harris.xyz, direct.xyz) and torch.equal(harris.mask, direct.mask)
    sift = detect_keypoints(tc, tn, "SIFT", 3.0, RADIUS, 0.1, 64, tile=512,
                            sift_octaves=1, sift_scales_per_octave=2)
    direct = detect_keypoints_sift(tc, 0.1, 1, 2, 3.0, 64, tile=512)
    assert torch.equal(sift.xyz, direct.xyz) and torch.equal(sift.mask, direct.mask)
    with pytest.raises(ValueError, match="keypoint type"):
        detect_keypoints(tc, tn, "ISS", 1.0, RADIUS, 0.1, 64)
