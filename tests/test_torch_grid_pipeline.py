"""The port's pipeline on the cell-grid engine against the JAX package's:
FPFH's grid branch (its SPFH sweep through the kernel's grid entry, here
its plain version), every descriptor's keypoint neighbourhoods, Harris +
FPFH through extract_features, a two-map merge, and the town fixture of
eval config #2.

Tolerances are those of the dense parity tests of the same stages
(test_torch_features.py, test_torch_descriptors_more.py), stated at each
test: the grid gathers the same candidates as the reference's grid, and
what differs is the rounding of atan2 and of sums.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_configs
import synthetic
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.ops.descriptors import compute_descriptors as j_desc
from mapmerge_tpu.ops.descriptors import fpfh as jfpfh
from mapmerge_tpu.pipeline.features import extract_features as j_features
from mapmerge_tpu.pipeline.merging import estimate_maps_transforms as j_merge
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.ops import descriptors as tdesc
from mapmerge_torch.ops.descriptors import fpfh as tfpfh
from mapmerge_torch.ops.descriptors.base import keypoint_neighborhoods
from mapmerge_torch.ops.grid import build_grid
from mapmerge_torch.pipeline.features import extract_features as t_features
from mapmerge_torch.pipeline.merging import estimate_maps_transforms as t_merge
from mapmerge_torch.testing import scene
from test_torch_descriptors_more import N_KP, RADIUS, SLOTS, surface  # noqa: F401
from torch_parity import both_clouds, port_params, rel_pose, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

#: the two-map grid merge of tests/test_grid.py:276-287, Harris + FPFH
GRID_PARAMS = MergeParams(
    keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
    refine_transform=True, max_iterations=30, max_points=8192,
    max_keypoints=256, max_neighbors=48, ransac_hypotheses=512,
    neighbor_tile=512, neighbor_engine="grid",
)


def test_spfh_grid_matches_reference(surface):  # noqa: F811
    """The grid SPFH sweep at every 5th valid point: pair counts exactly,
    histograms to 1e-3 except on at most 1% of rows (an atan2 rounded
    otherwise can cross a bin edge, test_torch_features.py)."""
    (jc, jn, _), (tc, tn, _) = surface
    ok = np.asarray(jc.mask & jn.valid)
    needed = np.zeros_like(ok)
    needed[np.flatnonzero(ok)[::5]] = True
    jh, jtot = jfpfh._spfh_grid(jc, jn, needed, RADIUS, 128)
    grid = build_grid(tc.xyz, tc.mask & tn.valid, RADIUS, None, 128)
    th, ttot = tfpfh._spfh_grid(tc, tn, t(needed), RADIUS, grid)
    np.testing.assert_array_equal(ttot.numpy()[needed], np.asarray(jtot)[needed])
    assert (ttot.numpy()[needed] > 0).mean() > 0.9
    assert not ttot.numpy()[~needed].any() and not th.numpy()[~needed].any()
    bad = np.abs(th.numpy() - np.asarray(jh))[needed].max(axis=1) > 1e-3
    assert bad.mean() <= 0.01, f"{bad.sum()} rows differ"


@pytest.mark.parametrize("kind", ["PFH", "PFHRGB", "RSD", "SHOT", "SC3D"])
def test_keypoint_neighborhoods_on_the_grid(surface, kind):  # noqa: F811
    """The small-Q grid path gathers the dense engine's neighbourhoods (the
    keypoints are chosen clear of the radius and of near-ties at the caps),
    so every descriptor built on them matches the JAX grid's."""
    (jc, jn, jk), (tc, tn, tk) = surface
    m = 128 if kind == "SC3D" else 48
    gi, gd, gm = keypoint_neighborhoods(tc, tn, tk, RADIUS, m, 512, "grid")
    di, dd, dm = keypoint_neighborhoods(tc, tn, tk, RADIUS, m, 512, "dense")
    assert torch.equal(gm, dm) and bool(gm[:N_KP].any(1).all())
    for row in range(SLOTS):
        assert set(gi[row][gm[row]].tolist()) == set(di[row][dm[row]].tolist())
    np.testing.assert_allclose(gd[gm].numpy(), dd[dm].numpy(), rtol=1e-3, atol=1e-5)

    td = tdesc.compute_descriptors(tc, tn, tk, kind, RADIUS, max_neighbors=48,
                                   tile=512, engine="grid")
    jd = j_desc(jc, jn, jk, kind, RADIUS, max_neighbors=48, tile=512, engine="grid")
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    got, ref = td.data.numpy()[:N_KP], np.asarray(jd.data)[:N_KP]
    if kind in ("SHOT", "SC3D"):  # test_torch_descriptors_more.py's tolerances
        np.testing.assert_allclose(got, ref, atol=1e-4)
    else:
        bad = np.abs(got - ref).max(axis=1) > (1e-4 if kind == "RSD" else 1e-3)
        assert bad.mean() <= 0.01, f"{bad.sum()} rows differ"


def test_fpfh_grid_matches_reference(surface):  # noqa: F811
    """FPFH through the grid branch, both packages: >= 95% of descriptors
    agree to 0.5 (blocks sum to 100), as the dense FPFH test allows."""
    (jc, jn, jk), (tc, tn, tk) = surface
    td = tfpfh.compute_fpfh(tc, tn, tk, RADIUS, max_neighbors=48, engine="grid")
    jd = jfpfh.compute_fpfh(jc, jn, jk, RADIUS, max_neighbors=48, engine="grid")
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert td.valid[:N_KP].all() and not td.valid[N_KP:].any()
    err = np.abs(td.data.numpy() - np.asarray(jd.data)).max(axis=1)
    assert (err[:N_KP] <= 0.5).mean() >= 0.95, np.sort(err)[-5:]
    # the dense branch gives the same descriptors (its SPFH sweep is the
    # shared-candidate mode of the same kernel)
    dd = tfpfh.compute_fpfh(tc, tn, tk, RADIUS, max_neighbors=48, engine="dense")
    assert (np.abs(td.data.numpy() - dd.data.numpy()).max(axis=1) <= 0.5).mean() >= 0.95


@pytest.fixture(scope="module")
def features_both():
    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, tc = both_clouds(a_xyz, a_rgb, capacity=cap)
    return j_features(jc, GRID_PARAMS), t_features(tc, port_params(GRID_PARAMS))


def test_extract_features_on_the_grid_matches_reference(features_both):
    """Harris + FPFH on the grid: the same keypoints (1e-5 m), the same
    counters, and descriptor rows within 0.5 on >= 95% of them."""
    jf, tf_ = features_both
    assert int(tf_.scan_overflow) == int(jf.scan_overflow)
    assert int(tf_.dropped_points) == int(jf.dropped_points)
    jm, tm = np.asarray(jf.keypoints.mask), tf_.keypoints.mask.numpy()
    assert tm.sum() == jm.sum() > 5
    jk, tk = np.asarray(jf.keypoints.xyz)[jm], tf_.keypoints.xyz.numpy()[tm]
    gap = np.abs(tk[:, None, :] - jk[None]).max(-1)  # (port, reference)
    match = gap.argmin(axis=1)
    assert (gap.min(axis=1) < 1e-5).all() and len(set(match)) == len(match)
    err = np.abs(
        tf_.descriptors.data.numpy()[tm] - np.asarray(jf.descriptors.data)[jm][match]
    ).max(axis=1)
    assert (err <= 0.5).mean() >= 0.95, np.sort(err)[-5:]


def test_two_map_merge_on_the_grid():
    """The grid merge of tests/test_grid.py:260-306 in both packages: the
    port within 0.5 deg / 0.05 m of the JAX grid pipeline's pose, and both
    inside the 2 deg / 0.15 m truth gate."""
    va, vb, cap, truth = small_scene()
    (ja, ta), (jb, tb) = both_clouds(*va, capacity=cap), both_clouds(*vb, capacity=cap)
    got = rel_pose(t_merge([ta, tb], port_params(GRID_PARAMS), seed=0))
    want = rel_pose(j_merge([ja, jb], GRID_PARAMS, seed=0))
    for rel in (got, want):
        rot, trans = ttf.pose_error(rel, truth)
        assert rot < 2.0 and trans < 0.15, (rot, trans)
    rot, trans = ttf.pose_error(got, want)
    assert rot < 0.5 and trans < 0.05, (rot, trans)


@pytest.mark.parametrize("fixture", ["make_town", "n_overlapping_views", "town_views"])
def test_town_fixture_matches_reference(fixture):
    """The port's jax-free copies draw the same numbers in the same order:
    equal arrays at a small target (3,000 points a view)."""
    if fixture == "town_views":
        got, got_t = scene.town_views(3, 3000)
        want, want_t = bench_configs.town_views(3, 3000)
        assert all(np.array_equal(a, b) for a, b in zip(got_t, want_t))
    else:
        xyz, rgb = scene.make_town(np.random.default_rng(3), 5000)
        ref = synthetic.make_town(np.random.default_rng(3), 5000)
        got, want = [(xyz, rgb)], [ref]
        if fixture == "n_overlapping_views":
            truths = [np.eye(4, dtype=np.float32), scene.se3(scene.rotation_z(0.3), [1, 2, 0])]
            got = scene.n_overlapping_views(np.random.default_rng(4), xyz, rgb, truths)
            want = synthetic.n_overlapping_views(np.random.default_rng(4), *ref, truths)
    assert len(got) == len(want) > 0
    for (gx, gr), (wx, wr) in zip(got, want):
        assert gx.shape[0] > 1000
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gr, wr)
