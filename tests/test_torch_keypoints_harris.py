"""Harris3D parity: the response, non-max suppression, the top-K cut with
its `truncated` count and the refinement, against mapmerge_tpu on the same
cloud and normals, and the keypoint dispatch of both detectors. On the grid
engine, an extraction's two grids (GridRoute: one target grid, one query
grid) against the per-call composition they replace (every radius_reduce
call building its own grids): the same keypoints bit for bit, 2 sorts in
place of 7, the 6-channel response within REDUCE_RTOL of the 9-channel
one, and the threshold-masked suppression's `keep` the full one's."""

import numpy as np
import pytest
import torch

from mapmerge_tpu.core.enums import Keypoint
from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
from mapmerge_tpu.ops.keypoints import harris as jh
from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
from mapmerge_torch import convert
from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.ops import grid as tg
from mapmerge_torch.ops.keypoints import Keypoints, detect_keypoints
from mapmerge_torch.ops.keypoints import harris as th
from mapmerge_torch.ops.keypoints.sift import detect_keypoints_sift
from mapmerge_torch.ops.neighbors import BIG, radius_reduce
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


# ---- the grid engine's one grid an extraction ----


def per_call_harris(cloud, normals, threshold, radius, max_keypoints, scan_cap=128):
    """The grid extraction as each radius_reduce call composed it before
    GridRoute: the response on all 9 channels, the suppression over every
    query and the refinement on 12 channels, each call building its own
    target grid (and, above SMALL_Q_THRESHOLD queries, its query grid)."""
    ok = cloud.mask & normals.valid
    _, sums, _ = radius_reduce(cloud.xyz, cloud.xyz, radius, th._outer(normals).reshape(-1, 9),
                               p_mask=ok, engine="grid", scan_cap=scan_cap)
    resp = th._response(sums.reshape(-1, 3, 3), ok)
    _, nmax, _ = radius_reduce(cloud.xyz, cloud.xyz, radius, resp[:, None], p_mask=ok,
                               reduce="max", engine="grid", scan_cap=scan_cap)
    keep = ok & (resp >= nmax[:, 0]) & (resp > threshold)
    score = torch.where(keep, resp, -BIG)
    k = min(max_keypoints, score.shape[0])
    top_scores, top_idx = torch.topk(score, k)
    kp_mask = top_scores > -BIG / 2
    kp_xyz = cloud.xyz[top_idx]
    for _ in range(th._REFINE_ITERS):
        kp_xyz = th._refine_step(kp_xyz, cloud, normals, radius, 1024, "grid", scan_cap)
    return Keypoints(
        xyz=torch.where(kp_mask[:, None], kp_xyz, FAR),
        response=torch.where(kp_mask, top_scores, 0.0),
        mask=kp_mask,
        truncated=(keep.sum().to(torch.int32) - k).clamp_min(0),
    ), resp


def counting_sorts(monkeypatch):
    """Count build_grid calls, by grid kind, wherever Harris's grids are
    built: GridRoute (ops/keypoints/harris) and each radius_reduce call
    (ops/grid)."""
    seen = []

    def make(fn):
        def wrapper(xyz, mask, *args, **kwargs):
            seen.append("query" if mask is None else "target")
            return fn(xyz, mask, *args, **kwargs)

        return wrapper

    monkeypatch.setattr(th, "build_grid", make(th.build_grid))
    monkeypatch.setattr(tg, "build_grid", make(tg.build_grid))
    return seen


@pytest.mark.parametrize("max_keypoints", [256, 8])
def test_grid_extraction_sorts_twice_and_keeps_the_per_call_bits(surface, monkeypatch,
                                                                 max_keypoints):
    """A grid Harris extraction of the slice cloud (4,568 slots: the
    response and the suppression take the query grid) builds one target
    grid and one query grid, where the per-call composition built seven
    (five target grids, two query grids); its keypoints, responses and
    `truncated` are that composition's, bit for bit, on the CPU."""
    _, _, tc, tn = surface
    assert tc.xyz.shape[0] > tg.SMALL_Q_THRESHOLD
    sorts = counting_sorts(monkeypatch)
    got = th.detect_keypoints_harris(tc, tn, 1.0, RADIUS, max_keypoints, engine="grid")
    assert sorted(sorts) == ["query", "target"]
    sorts.clear()
    want, _ = per_call_harris(tc, tn, 1.0, RADIUS, max_keypoints)
    assert sorts.count("target") == 5 and sorts.count("query") == 2
    assert int(got.mask.sum()) > 5 and (int(got.truncated) > 0) == (max_keypoints == 8)
    for field in ("xyz", "response", "mask", "truncated"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_six_channel_response_is_within_the_sum_limit_of_nine(surface):
    """The response sums the upper triangle of n n^T (6 channels) and
    mirrors it: each entry within REDUCE_RTOL of the 9-channel sum of that
    entry (the members' sum of |v| the scale), and so the same response."""
    _, _, tc, tn = surface
    ok = tc.mask & tn.valid
    route = th.GridRoute(tc, ok, RADIUS, 128)
    outer = th._outer(tn).reshape(-1, 9)
    upper = outer[:, list(th.UPPER)]
    _, six, _ = tg.grid_reduce_query(route.grid, tc.xyz, upper, "sum", qg=route.qg)
    _, nine, _ = tg.grid_reduce_query(route.grid, tc.xyz, outer, "sum", qg=route.qg)
    _, scale, _ = tg.grid_reduce_query(route.grid, tc.xyz, outer.abs(), "sum", qg=route.qg)
    mirrored = th._mirror(six).reshape(-1, 9)
    assert int((scale > 0).sum()) > 1000
    assert kgrid.reduce_error(mirrored, nine, scale) <= kgrid.REDUCE_RTOL
    assert torch.equal(route.response(tn, ok), th._response(nine.reshape(-1, 3, 3), ok))


@pytest.mark.parametrize("scan_cap", [128, 8])
def test_threshold_masked_suppression_keeps_what_the_full_one_keeps(surface, scan_cap):
    """The suppression over the queries above the threshold gives `keep`
    bit for bit as the suppression over every query: with a NaN response
    at some points and the query grid dropping valid queries (caps 128 and
    8); the maxes of the queries swept are the full sweep's, bit for bit
    (NaN where NaN)."""
    _, _, tc, tn = surface
    ok = tc.mask & tn.valid
    route = th.GridRoute(tc, ok, RADIUS, scan_cap)
    # the query grid drops valid queries at both caps (the town's buckets
    # hold more than 128 points), more of them at 8
    answered = torch.zeros_like(ok)
    answered[route.qg.cell_idx[route.qg.cell_ok]] = True
    assert int(route.qg.overflow) > 0 and bool((ok & ~answered).any())
    resp = route.response(tn, ok)
    resp[torch.arange(0, resp.shape[0], 997)] = float("nan")
    threshold = float(resp[ok & ~resp.isnan()].quantile(0.25))
    masked = route.suppression(resp, threshold)
    _, full, _ = tg.grid_reduce_query(route.grid, tc.xyz, resp[:, None], "max", qg=route.qg)
    full = full[:, 0]
    keep_masked = ok & (resp >= masked) & (resp > threshold)
    keep_full = ok & (resp >= full) & (resp > threshold)
    assert torch.equal(keep_masked, keep_full) and int(keep_full.sum()) > 5
    swept = resp > threshold
    a, b = masked[swept], full[swept]
    assert bool(((a == b) | (a.isnan() & b.isnan())).all()) and bool(a.isnan().any())
    assert bool((masked[~swept] == -BIG).all())
