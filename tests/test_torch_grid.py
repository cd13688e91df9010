"""The port's cell-grid engine (mapmerge_torch/ops/grid.py) against the JAX
package's (mapmerge_tpu/ops/grid.py) and against the port's dense engine,
on the same seeded numpy inputs (tests/test_grid.py's sizes: 3,000 points
in a 4 m cube, 10% masked and parked at FAR, 500 queries, radius 0.35).

Tolerances against the JAX grid: counts, neighbour index sets, valid masks,
overflow counters and the grids themselves exactly; floats (sums, maxes,
moments, smoothed values) within rtol 1e-5 / atol 1e-6, since the two
packages add in other orders; squared distances within 1e-6 relative, since
XLA's CPU code rounds the sum of three squares otherwise (1e-8 m^2 seen).
Against the dense engine, the tolerances of tests/test_grid.py.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.ops import grid as jg
from mapmerge_torch.core import grid as core_grid
from mapmerge_torch.ops import grid as tg
from mapmerge_torch.ops import neighbors as tn
from torch_parity import t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

RADIUS = 0.35
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = 1.0e8  # parked like PointCloud.park_invalid
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    vals = rng.random((3000, 4)).astype(np.float32)
    needed = rng.random(3000) > 0.7
    return dict(p=p, mask=mask, q=q, vals=vals, needed=needed)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_grids_equal(tgrid, jgrid):
    for f in ("cell_xyz", "cell_idx", "cell_ok", "count", "raw_max", "overflow"):
        np.testing.assert_array_equal(_np(getattr(tgrid, f)), _np(getattr(jgrid, f)), f)
    assert (tgrid.cell_size, tgrid.dims, tgrid.cap) == (
        jgrid.cell_size, jgrid.dims, jgrid.cap
    )


def _assert_neighbor_sets_equal(ti, td, tv, ji, jd, jv, rtol=1e-6, atol=1e-9):
    """Same valid masks, the same index set per row, distances close."""
    ti, td, tv, ji, jd, jv = map(_np, (ti, td, tv, ji, jd, jv))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td[tv], jd[jv], rtol=rtol, atol=atol)
    for row in range(tv.shape[0]):
        assert set(ti[row][tv[row]]) == set(ji[row][jv[row]]), row


# cases: name -> (cell size, dims, cap, coordinate shift)
GRID_CASES = {
    "default": (RADIUS, None, 128, 0.0),
    "capped buckets": (RADIUS, None, 8, 0.0),
    "tiny dims that wrap": (RADIUS, (2, 2, 2), 128, 0.0),
    "negative coordinates": (RADIUS, None, 128, -2.0),
    "wide cells": (1.0, None, 256, 0.0),
}


class TestBuildGrid:
    @pytest.mark.parametrize("case", list(GRID_CASES))
    def test_matches_reference(self, data, case):
        cell, dims, cap, shift = GRID_CASES[case]
        p = np.where(data["mask"][:, None], data["p"] + shift, data["p"])
        p = p.astype(np.float32)
        tgrid = tg.build_grid(t(p), t(data["mask"]), cell, dims, cap)
        jgrid = jg.build_grid(jnp.asarray(p), jnp.asarray(data["mask"]), cell, dims, cap)
        _assert_grids_equal(tgrid, jgrid)
        if case == "capped buckets":
            assert int(tgrid.overflow) > 0 and int(tgrid.raw_max) > cap

    @pytest.mark.parametrize("cap", [128, 8])
    def test_masked_query_grid_matches_reference(self, data, cap):
        """The derived query grid: occupancy and-ed with the mask; only
        masked-in points dropped by the cap count as overflow."""
        p, mask, needed = data["p"], data["mask"], data["needed"]
        tq = tg.masked_query_grid(
            tg.build_grid(t(p), t(mask), RADIUS, None, cap), t(needed & mask), 3000
        )
        jq = jg.masked_query_grid(
            jg.build_grid(jnp.asarray(p), jnp.asarray(mask), RADIUS, None, cap),
            jnp.asarray(needed & mask), 3000,
        )
        _assert_grids_equal(tq, jq)
        assert (int(tq.overflow) > 0) == (cap == 8)

    @pytest.mark.parametrize("n", [100, 3000, 1 << 20, 1 << 21, 1 << 23])
    def test_default_dims(self, n):
        assert tg.default_dims(n) == jg.default_dims(n)


def _call(pkg, op, d, path):
    """One grid op of package `pkg` ("torch" or "jax") on the fixture's
    arrays: a dict of numpy outputs."""
    g, conv = (tg, t) if pkg == "torch" else (jg, jnp.asarray)
    p, mask, q, vals = conv(d["p"]), conv(d["mask"]), conv(d["q"]), conv(d["vals"])
    if op == "count":
        c, o = g.grid_radius_count(q, p, RADIUS, p_mask=mask)
        return dict(count=c, overflow=o)
    if op == "count self":
        # queries are every slot, FAR-parked ones too: they pile into one
        # bucket past the query-side cap
        c, o = g.grid_radius_count(p, p, RADIUS, p_mask=mask, include_self=False)
        return dict(count=c, overflow=o)
    if op in ("neighbors", "neighbors self"):
        qq, excl = (p, True) if op == "neighbors self" else (q, False)
        i, d2, v, o = g.grid_radius_neighbors(
            qq, p, RADIUS, 16, p_mask=mask, exclude_self=excl
        )
        return dict(idx=i, d2=d2, valid=v, overflow=o)
    if op in ("nn", "nn q_mask"):
        qq, qm = (p, mask) if op == "nn q_mask" else (q, None)
        i, d2, o = g.grid_nearest_neighbor(qq, p, RADIUS, p_mask=mask, q_mask=qm)
        return dict(nn_idx=i, nn_d2=d2, overflow=o)
    if op in ("sum", "max"):
        c, s, o = g.grid_radius_reduce(q, p, RADIUS, vals, p_mask=mask, reduce=op)
        return dict(count=c, values=s, overflow=o)
    if op == "moments":
        c, m, cov, o = g.grid_neighbor_moments(q, p, RADIUS, p_mask=mask)
        return dict(count=c, mean=m, cov=cov, overflow=o)
    assert op == "gaussian"
    out, o = g.grid_gaussian_smooth(q, p, vals[:, 0], [0.1, 0.15, 0.2], p_mask=mask)
    return dict(values=out, overflow=o)


OPS = [
    ("count", None), ("count self", None), ("neighbors", "small-Q"),
    ("neighbors", "sweep"), ("neighbors self", "sweep"), ("nn", None),
    ("nn q_mask", None), ("sum", "small-Q"), ("sum", "sweep"),
    ("max", "small-Q"), ("max", "sweep"), ("moments", None), ("gaussian", None),
]


def _sweep_everything(monkeypatch):
    """Send every query set through the cell sweep (no small-Q path) in
    both packages."""
    monkeypatch.setattr(tg, "SMALL_Q_THRESHOLD", 0)
    monkeypatch.setattr(jg, "SMALL_Q_THRESHOLD", 0)


class TestGridMatchesReference:
    @pytest.mark.parametrize("op,path", OPS)
    def test_op(self, data, op, path, monkeypatch):
        if path == "sweep":
            _sweep_everything(monkeypatch)
        got = {k: _np(v) for k, v in _call("torch", op, data, path).items()}
        want = {k: _np(v) for k, v in _call("jax", op, data, path).items()}
        assert int(got["overflow"]) == int(want["overflow"])
        if op in ("count self",):
            assert int(got["overflow"]) > 0  # the FAR-parked slots
        if "count" in got:
            np.testing.assert_array_equal(got["count"], want["count"])
        if "idx" in got:
            _assert_neighbor_sets_equal(
                got["idx"], got["d2"], got["valid"],
                want["idx"], want["d2"], want["valid"],
            )
            assert (got["idx"] >= 0).all() and (got["idx"] < 3000).all()
        if "nn_idx" in got:
            np.testing.assert_array_equal(got["nn_idx"], want["nn_idx"])
            np.testing.assert_allclose(got["nn_d2"], want["nn_d2"], rtol=1e-6)
        for k in ("values", "mean", "cov"):
            if k in got:
                np.testing.assert_allclose(got[k], want[k], **FLOAT_TOL)

    @pytest.mark.parametrize("op", ["count", "neighbors", "moments", "sum"])
    def test_chunking_changes_nothing(self, data, op, monkeypatch):
        """Chunks of 16 buckets give what chunks of 151 do."""
        _sweep_everything(monkeypatch)
        whole = _call("torch", op, data, "sweep")
        monkeypatch.setattr(core_grid, "PAIRS_PER_CHUNK", 16 * 128 * 27 * 128)
        for k, v in _call("torch", op, data, "sweep").items():
            assert torch.equal(v, whole[k]), k


class TestGridMatchesDense:
    """The port's grid against the port's dense engine: exact up to the
    bucket cap, which this cloud never reaches (tests/test_grid.py)."""

    @pytest.fixture
    def both(self, data):
        p, mask, q = t(data["p"]), t(data["mask"]), t(data["q"])
        return p, mask, q, t(data["vals"])

    def test_radius_count(self, both):
        p, mask, q, _ = both
        got, _ = tn.radius_count(q, p, RADIUS, p_mask=mask, engine="grid")
        want, _ = tn.radius_count(q, p, RADIUS, p_mask=mask, engine="dense")
        assert torch.equal(got, want)

    @pytest.mark.parametrize("path", ["small-Q", "sweep"])
    def test_radius_neighbors(self, both, path, monkeypatch):
        if path == "sweep":
            _sweep_everything(monkeypatch)
        p, mask, q, _ = both
        gi, gd, gv, _ = tn.radius_neighbors(q, p, RADIUS, 16, p_mask=mask, engine="grid")
        di, dd, dv, _ = tn.radius_neighbors(q, p, RADIUS, 16, p_mask=mask, engine="dense")
        # the dense engine subtracts centred coordinates: another rounding
        _assert_neighbor_sets_equal(gi, gd, gv, di, dd, dv, rtol=1e-3, atol=1e-5)

    def test_nearest_neighbor_bounded(self, both):
        p, mask, q, _ = both
        gi, gd, _ = tn.nearest_neighbor(q, p, p_mask=mask, bound=RADIUS, engine="grid")
        di, dd, _ = tn.nearest_neighbor(q, p, p_mask=mask)
        within = dd <= RADIUS * RADIUS * 0.99
        assert torch.equal(gi[within], di[within])
        np.testing.assert_allclose(gd[within], dd[within], rtol=1e-6)
        assert (gd[~within] > 1e11).all()

    @pytest.mark.parametrize("reduce", ["sum", "max"])
    @pytest.mark.parametrize("path", ["small-Q", "sweep"])
    def test_radius_reduce(self, both, reduce, path, monkeypatch):
        if path == "sweep":
            _sweep_everything(monkeypatch)
        p, mask, q, vals = both
        gc, gs, _ = tn.radius_reduce(q, p, RADIUS, vals, p_mask=mask, reduce=reduce, engine="grid")
        dc, ds, _ = tn.radius_reduce(q, p, RADIUS, vals, p_mask=mask, reduce=reduce, engine="dense")
        assert torch.equal(gc, dc)
        np.testing.assert_allclose(gs, ds, rtol=1e-5, atol=1e-4)

    def test_neighbor_moments(self, both):
        p, mask, q, _ = both
        gc, gm, gcov, _ = tn.neighbor_moments(q, p, RADIUS, p_mask=mask, engine="grid")
        dc, dm, dcov, _ = tn.neighbor_moments(q, p, RADIUS, p_mask=mask, engine="dense")
        assert torch.equal(gc, dc)
        sel = dc > 0
        np.testing.assert_allclose(gm[sel], dm[sel], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gcov[sel], dcov[sel], rtol=1e-3, atol=1e-5)

    def test_gaussian_smooth_against_numpy(self, data):
        """The dense oracle of tests/test_grid.py: 3 sigma_max truncation."""
        p, mask, q, vals = data["p"], data["mask"], data["q"], data["vals"][:, 0]
        sigmas = [0.1, 0.15, 0.2]
        got, _ = tg.grid_gaussian_smooth(t(q), t(p), t(vals), sigmas, p_mask=t(mask))
        r = 3.0 * max(sigmas)
        d2 = ((q[:, None, :] - p[None]) ** 2).sum(-1)
        inb = (d2 <= r * r) & mask[None, :]
        for i, s in enumerate(sigmas):
            w = np.exp(-d2 / (2 * s * s)) * inb
            want = (w @ vals) / np.maximum(w.sum(1), 1e-12)
            np.testing.assert_allclose(got[:, i].numpy(), want, rtol=2e-4, atol=2e-4)


class TestEngineChoice:
    @pytest.mark.parametrize(
        "env,engine,n,threshold,want",
        [
            ("", "auto", tn.GRID_AUTO_THRESHOLD - 1, tn.GRID_AUTO_THRESHOLD, "dense"),
            ("", "auto", tn.GRID_AUTO_THRESHOLD, tn.GRID_AUTO_THRESHOLD, "grid"),
            ("", "auto", tn.GRID_NN_THRESHOLD, tn.GRID_NN_THRESHOLD, "grid"),
            ("", "grid", 10, tn.GRID_AUTO_THRESHOLD, "grid"),
            ("", "dense", 1 << 22, tn.GRID_AUTO_THRESHOLD, "dense"),
            ("grid", "dense", 10, tn.GRID_AUTO_THRESHOLD, "grid"),
            ("dense", "auto", 1 << 22, tn.GRID_AUTO_THRESHOLD, "dense"),
        ],
    )
    def test_matches_reference(self, env, engine, n, threshold, want, monkeypatch):
        from mapmerge_tpu.ops.neighbors import _resolve_engine as j_resolve

        monkeypatch.setenv("MAPMERGE_ENGINE", env)
        assert tn._resolve_engine(engine, n, threshold) == want
        assert j_resolve(engine, n, threshold) == want

    def test_unknown_engine_raises(self):
        with pytest.raises(ValueError, match="unknown neighbor engine"):
            tn._resolve_engine("kdtree", 10)


class TestOverflowDetection:
    """tests/test_grid.py's overflow cases, port against the JAX grid."""

    def test_capped_scan_undercounts_but_is_detectable(self):
        rng = np.random.default_rng(1)
        p = (rng.random((600, 3)) * 0.2).astype(np.float32)  # one cell
        got, _ = tg.grid_radius_count(t(p[:8]), t(p), 0.3, scan_cap=32)
        want, _ = jg.grid_radius_count(p[:8], p, 0.3, scan_cap=32)
        assert torch.equal(got, t(want)) and (got <= 32 * 27).all()
        grid = tg.build_grid(t(p), None, cell_size=0.3)
        assert int(tg.max_bucket_count(grid)) >= 500
        assert int(tg.build_grid(t(p), None, 0.3, cap=32).overflow) == 600 - 32

    @pytest.mark.parametrize("masked", [False, True])
    def test_query_side_overflow_counted(self, masked):
        """Queries denser than the query-side cap come back unmatched and
        are counted; queries outside q_mask are not counted."""
        rng = np.random.default_rng(2)
        p = (rng.random((50, 3)) * 4.0).astype(np.float32)
        q = (rng.random((600, 3)) * 0.2).astype(np.float32)  # a one-cell blob
        q_mask = (np.arange(600) % 2 == 0) if masked else None
        ti, td, to = tg.grid_nearest_neighbor(
            t(q), t(p), bound=0.5, scan_cap=32,
            q_mask=None if q_mask is None else t(q_mask),
        )
        ji, jd, jo = jg.grid_nearest_neighbor(q, p, bound=0.5, scan_cap=32, q_mask=q_mask)
        assert int(to) == int(jo) == (300 if masked else 600) - 32
        assert torch.equal(ti, t(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-6)
        assert int((td > 1.0e11).sum()) >= int(to)

    def test_icp_surfaces_source_query_overflow(self, monkeypatch):
        """ICP queries the moved source against the target's grid: a source
        denser than its buckets loses correspondences, and says so."""
        monkeypatch.setenv("MAPMERGE_ENGINE", "grid")
        from mapmerge_tpu.core.cloud import PointCloud as JCloud
        from mapmerge_tpu.ops.icp import icp_refine as j_icp
        from mapmerge_torch.core.cloud import PointCloud as TCloud
        from mapmerge_torch.ops.icp import icp_refine as t_icp

        rng = np.random.default_rng(3)
        tgt = (rng.random((400, 3)) * 4.0).astype(np.float32)
        src = (rng.random((600, 3)) * 0.2).astype(np.float32)
        kw = dict(max_correspondence_distance=0.5, outlier_rejection_threshold=0.0,
                  max_iterations=2, transform_epsilon=1e-5)
        _, _, tover = t_icp(
            TCloud.from_numpy(src, device="cpu"), TCloud.from_numpy(tgt, device="cpu"),
            torch.eye(4), **kw,
        )
        _, _, jover = j_icp(
            JCloud.from_arrays(src), JCloud.from_arrays(tgt), np.eye(4, dtype=np.float32), **kw,
        )
        assert int(tover) == int(jover) > 0

    def test_pair_stage_overflow_warns(self):
        from mapmerge_torch.pipeline.merging import _warn_pair_overflow

        with pytest.warns(UserWarning, match="query-side bucket cap"):
            _warn_pair_overflow(np.array([0, 44]))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _warn_pair_overflow(np.array([0, 0]))
            _warn_pair_overflow(np.array([], dtype=np.int64))

    def test_feature_stage_overflow_warns(self):
        from mapmerge_torch.pipeline.merging import _warn_feature_caps

        zero = np.zeros(2, np.int64)
        with pytest.warns(UserWarning, match="exceeds grid_scan_cap by 7"):
            _warn_feature_caps(zero, np.array([0, 7]), zero)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _warn_feature_caps(zero, zero, zero)

    def test_registration_gates_overflow_on_failure(self, monkeypatch):
        """A failed pair scores a zero transform (every source point in the
        origin's bucket): that must not count as overflow."""
        monkeypatch.setenv("MAPMERGE_ENGINE", "grid")
        from mapmerge_torch.core.cloud import PointCloud
        from mapmerge_torch.core.params import MergeParams
        from mapmerge_torch.pipeline.features import extract_features
        from mapmerge_torch.pipeline.registration import estimate_transform

        rng = np.random.default_rng(4)
        a = (rng.random((400, 3)) * 3.0).astype(np.float32)
        b = (rng.random((400, 3)) * 3.0 + 50.0).astype(np.float32)
        params = MergeParams(
            keypoint_type="HARRIS", keypoint_threshold=-1.0e9,
            descriptor_type="FPFH", refine_transform=False,
            max_points=1024, max_keypoints=32, ransac_hypotheses=32,
        )
        fa = extract_features(PointCloud.from_numpy(a, capacity=1024, device="cpu"), params)
        fb = extract_features(PointCloud.from_numpy(b, capacity=1024, device="cpu"), params)
        est = estimate_transform(fa, fb, params, generator=torch.Generator().manual_seed(0))
        assert not bool(est.ok)
        assert int(est.scan_overflow) == 0


class TestGridEdgeCases:
    def test_empty_mask(self, data):
        p = np.full((100, 3), 1.0e8, np.float32)
        mask = np.zeros(100, bool)
        got, over = tg.grid_radius_count(t(data["q"]), t(p), RADIUS, p_mask=t(mask))
        want, jover = jg.grid_radius_count(data["q"], p, RADIUS, p_mask=mask)
        assert (got == 0).all() and torch.equal(got, t(want))
        assert int(over) == int(jover) == 0

    def test_negative_coordinates(self):
        rng = np.random.default_rng(5)
        p = (rng.random((2000, 3)) * 6.0 - 3.0).astype(np.float32)
        q = (rng.random((200, 3)) * 6.0 - 3.0).astype(np.float32)
        got, _ = tg.grid_radius_count(t(q), t(p), RADIUS)
        assert torch.equal(got, t(jg.grid_radius_count(q, p, RADIUS)[0]))
        assert torch.equal(got, tn.radius_count(t(q), t(p), RADIUS, engine="dense")[0])

    def test_tiny_dims_wrap_without_double_counting(self, data):
        """On a 2 x 2 x 2 grid the 27 neighbour ids repeat; each bucket is
        scanned once, so counts stay exact."""
        p, mask, q = t(data["p"]), t(data["mask"]), t(data["q"])
        got, _ = tg.grid_radius_count(q, p, RADIUS, p_mask=mask, scan_cap=2048, dims=(2, 2, 2))
        want, _ = tn.radius_count(q, p, RADIUS, p_mask=mask, engine="dense")
        assert torch.equal(got, want)
        j, _ = jg.grid_radius_count(
            data["q"], data["p"], RADIUS, p_mask=data["mask"], scan_cap=2048,
            dims=(2, 2, 2), tile=8,  # the reference's tile must divide H = 8
        )
        assert torch.equal(got, t(j))

    def test_far_parked_queries_on_the_small_q_path(self, data):
        """Padded keypoint slots parked at FAR hash to some bucket that may
        hold real points; the distance test, not the bucket, answers them."""
        q = data["q"].copy()
        q[::3] = 1.0e8
        p, mask = data["p"], data["mask"]
        ti, td, tv = tg._radius_neighbors_smallq(
            t(q), tg.build_grid(t(p), t(mask), RADIUS), 3000, RADIUS, 16, False
        )
        ji, jd, jv = jg._radius_neighbors_smallq(
            jnp.asarray(q), jg.build_grid(jnp.asarray(p), jnp.asarray(mask), RADIUS),
            3000, RADIUS, 16, False,
        )
        assert not tv[::3].any() and tv.any()
        _assert_neighbor_sets_equal(ti, td, tv, ji, jd, jv)
        assert ((ti >= 0) & (ti < 3000)).all()
