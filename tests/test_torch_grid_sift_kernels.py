"""SIFT's grid octaves in mapmerge_torch (kernels J and K: kernels/grid.py
`smooth` and `knn`, csrc/grid.cu) on their plain versions, against the JAX
package's grid_gaussian_smooth and the big-Q branch of
grid_radius_neighbors.

Both kernels answer a query slot from the filled slots of the distinct
wrapped neighbour buckets in ascending bucket id, then slot order, as G-I
do, and cull tiles of them exactly (tests/test_torch_grid_select.py and
tests/test_torch_grid_radius_cull.py model their schedules). Here: the plain versions
and ops/grid's two functions (which take them on the CPU) against the JAX
package on the same seeded numpy inputs (tests/test_torch_grid.py's cloud:
3,000 points in a 4 m cube, 10% masked and parked at FAR), on the big-Q
path, with caps that overflow on both sides, tiny dims whose neighbour ids
repeat, a cloud too sparse for k candidates, exclude_self both ways and
masked points among the queries; a numpy model of K's selection (the k
smallest d2 over the candidates, ties to the first candidate position,
entries at BIG or beyond as (0, BIG)) against knn_ref under hypothesis, on
lattice clouds with duplicated points (ties everywhere); the routes of
ops/grid and of the wrappers (the meta device stands in for the card).

Tolerances against the JAX package: K's valid flags and the index set of
each row's valid entries exactly, their d2 within 1e-6 relative (XLA's CPU
code may round the sum of three squares otherwise, tests/test_torch_grid.py)
and the overflow exactly: the JAX package orders ties as lax.top_k does,
which is unspecified, so sets are compared. J within SCALE_SPACE_RTOL (1e-5)
of the field's largest magnitude, kernel C's tolerance: the two packages
round exp and add in other orders; the overflow exactly.

The `cuda` cases hold J within SCALE_SPACE_RTOL of smooth_ref at 1, 6 and
64 sigmas (repeating bit for bit, unanswered rows 0) and K bit for bit
against knn_ref, on adversarial inputs (a bucket full at a cap above 128
among them), and skip here; on a machine with a GPU: `python -m
pytest tests/test_torch_grid_sift_kernels.py -m cuda --noconftest`.
"""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.kernels import sift as ksift
from mapmerge_torch.ops import grid as tg

from test_torch_grid_kernels import (  # noqa: F401 (card_path: a fixture)
    TINY_DIMS, _grids, _meta_grid, _to, card_path, neighbours,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

RADIUS = 0.35
#: SIFT's list: the 25-NN and the point itself
K = 26
BIG = np.float32(tg.BIG)

#: name -> (cell size, dims, cap, coordinate shift, points kept, the JAX
#: grid_query's tile, which must divide H)
CASES = {
    "default": (RADIUS, None, 32, 0.0, 3000, 16),
    "caps that overflow": (RADIUS, None, 3, 0.0, 3000, 16),
    "tiny dims that wrap": (RADIUS, (2, 2, 1), 256, 0.0, 3000, 4),
    "fewer than k candidates": (RADIUS, None, 32, 0.0, 200, 16),
    "negative coordinates": (RADIUS, None, 32, -2.0, 3000, 16),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    vals = (rng.random(3000) * 255.0).astype(np.float32)
    return dict(p=p, mask=mask, q=q, vals=vals)


def _case(data, name, queries):
    """(p, mask, q, vals, cell, dims, cap, tile) of a case, numpy; q the
    other queries or the points themselves (masked ones parked at FAR)."""
    cell, dims, cap, shift, n, tile = CASES[name]
    mask = data["mask"][:n]
    p = np.where(mask[:, None], data["p"][:n] + shift, data["p"][:n]).astype(np.float32)
    q = p if queries == "the points" else (data["q"] + shift).astype(np.float32)
    return p, mask, q, data["vals"][:n], cell, dims, cap, tile


def sigmas_for(cell: float) -> list[float]:
    """SIFT's six sigmas of an octave (base 2^(s/3)) whose 3 sigma_max is
    the cell."""
    base = cell / (3.0 * 2.0 ** (5.0 / 3.0))
    return [base * 2.0 ** (s / 3.0) for s in range(6)]


def assert_neighbor_sets_equal(got, want):
    """tests/test_torch_grid.py's rule: the same valid flags, the same index
    set on each row's valid entries, their d2 within 1e-6 relative."""
    ti, td, tv = (np.asarray(a) for a in got)
    ji, jd, jv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td[tv], jd[jv], rtol=1e-6, atol=1e-9)
    for row in range(tv.shape[0]):
        assert set(ti[row][tv[row]]) == set(ji[row][jv[row]]), row


def field_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the field's largest magnitude (kernel
    C's measure, chip_smoke._scale_space_compare)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)


# ---- the plain versions against the JAX package ----


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("queries", ["other queries", "the points"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_ref_matches_jax_grid_radius_neighbors(data, name, queries, exclude_self,
                                                  monkeypatch):
    """knn_ref and ops/grid.grid_radius_neighbors's big-Q branch (which
    takes it on the CPU) against the JAX package's on the same grid: the
    valid flags and index sets exactly, d2 within 1e-6 relative, the
    overflow exactly; entries at BIG carry index 0; rows nearest first."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    monkeypatch.setattr(tg, "SMALL_Q_THRESHOLD", 0)
    monkeypatch.setattr(jg, "SMALL_Q_THRESHOLD", 0)
    p, mask, q, _, cell, dims, cap, tile = _case(data, name, queries)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    r2 = tg._f32(cell * cell)
    got = kgrid.knn_ref(grid, qg, tq, len(p), K, r2, exclude_self)
    *via_ops, over = tg.grid_radius_neighbors(
        tq, torch.from_numpy(p), cell, K, p_mask=torch.from_numpy(mask),
        exclude_self=exclude_self, scan_cap=cap, dims=dims)
    for a, b in zip(got, via_ops):
        assert torch.equal(a, b)
    assert torch.equal(over, qg.overflow)
    *want, jover = jg.grid_radius_neighbors(
        jnp.asarray(q), jnp.asarray(p), cell, K, p_mask=jnp.asarray(mask), tile=tile,
        exclude_self=exclude_self, scan_cap=cap, dims=dims)
    assert_neighbor_sets_equal(got, want)
    assert int(over) == int(jover)
    idx, d2, valid = got
    assert idx.shape == d2.shape == valid.shape == (len(q), K)
    assert bool((idx[d2 >= BIG] == 0).all()) and bool((d2 <= BIG).all())
    assert bool((d2[:, 1:] >= d2[:, :-1]).all())
    if name == "fewer than k candidates":
        assert bool((~valid[:, -1]).all()) and bool(valid.any())
    if name == "caps that overflow":
        assert int(over) > 0 and int(grid.overflow) > 0
    if queries == "the points":
        # the masked points, parked at FAR, share one bucket past its cap
        assert int(over) >= int((~mask).sum()) - cap
        assert bool((d2[:, 0] == 0.0).any()) != exclude_self


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("queries", ["other queries", "the points"])
def test_smooth_ref_matches_jax_grid_gaussian_smooth(data, name, queries):
    """smooth_ref and ops/grid.grid_gaussian_smooth (which takes it on the
    CPU) against the JAX package's on the same grid: within
    SCALE_SPACE_RTOL of the field, the overflow exactly, the rows the
    query-side cap drops 0."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, vals, cell, dims, cap, tile = _case(data, name, queries)
    sigmas = sigmas_for(cell)
    r_bound = 3.0 * max(sigmas)
    grid, qg, tq = _grids(p, mask, q, None, r_bound, dims, cap)
    got = kgrid.smooth_ref(grid, qg, tq, torch.from_numpy(vals), sigmas,
                           tg._f32(r_bound * r_bound))
    via_ops, over = tg.grid_gaussian_smooth(
        tq, torch.from_numpy(p), torch.from_numpy(vals), sigmas,
        p_mask=torch.from_numpy(mask), scan_cap=cap, dims=dims)
    assert torch.equal(got, via_ops) and torch.equal(over, qg.overflow)
    want, jover = jg.grid_gaussian_smooth(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(vals), sigmas,
        p_mask=jnp.asarray(mask), tile=tile, scan_cap=cap, dims=dims)
    assert got.shape == (len(q), len(sigmas))
    assert field_error(got, torch.tensor(np.asarray(want))) <= ksift.SCALE_SPACE_RTOL
    assert int(over) == int(jover)
    answered = torch.zeros(len(q), dtype=torch.bool)
    answered[qg.cell_idx[qg.cell_ok]] = True
    assert bool((got[~answered] == 0).all()) and bool((got[answered] != 0).any())


# ---- a numpy model of K's selection ----


def knn_model(grid, qg, nq: int, n_p: int, k: int, r2: float, exclude_self: bool):
    """csrc/grid.cu's K in numpy float32, query slot by query slot: the
    candidates are the filled slots of neighbours(b) in that order, d2 =
    ((q - p)_x^2 + (q - p)_y^2) + (q - p)_z^2; with exclude_self those at
    d2 <= 1e-12 leave, as do those at d2 >= BIG; the first k by (d2,
    candidate position), padded with (0, BIG); idx >= n_p -> 0; valid = d2
    <= r2 on the answered rows, False on the others."""
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    idx = np.zeros((nq, k), np.int32)
    d2 = np.full((nq, k), BIG, np.float32)
    valid = np.zeros((nq, k), bool)
    for b in np.flatnonzero(q_ok.any(axis=1)):
        ids = neighbours(int(b), grid.dims)
        cand = np.concatenate([t_xyz[i, : t_count[i]] for i in ids]).reshape(-1, 3)
        where = [(i, s) for i in ids for s in range(t_count[i])]
        for s in np.flatnonzero(q_ok[b]):
            row = q_idx[b, s]
            d = q_xyz[b, s][None, :] - cand
            dd = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            keep = dd < BIG
            if exclude_self:
                keep &= ~(dd <= np.float32(1e-12))
            order = sorted(np.flatnonzero(keep), key=lambda j: (dd[j], j))[:k]
            for i, j in enumerate(order):
                r = t_idx[where[j]]
                idx[row, i] = 0 if r >= n_p else r
                d2[row, i] = dd[j]
            valid[row] = d2[row] <= np.float32(r2)
    return [torch.from_numpy(a) for a in (idx, d2, valid)]


def tie_case(seed: int, n: int, nq: int, dup: float, masked: float):
    """Points on a 1/8 m lattice over 1.5 m (squared distances exact, ties
    everywhere), a share of them duplicated (equal points at other
    positions), a share masked and half of those parked at FAR; queries
    half the points themselves, half lattice points over 2.5 m, every fifth
    parked at FAR. numpy: (p, mask, q)."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(-6, 7, (n, 3)) * 0.125).astype(np.float32)
    twins = p[rng.integers(0, n, int(dup * n))]
    p = np.concatenate([p, twins])[rng.permutation(n + len(twins))]
    mask = rng.random(len(p)) >= masked
    p[~mask & (rng.random(len(p)) < 0.5)] = FAR
    q = np.concatenate([p[rng.integers(0, len(p), nq // 2)],
                        rng.integers(-10, 11, (nq - nq // 2, 3)) * 0.125]).astype(np.float32)
    q[::5] = FAR
    return p, mask, q


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(TINY_DIMS),
       cap=st.sampled_from([1, 2, 5, 16, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 120), nq=st.integers(2, 60), k=st.sampled_from([1, 5, 26]),
       dup=st.sampled_from([0.0, 0.5]), masked=st.sampled_from([0.0, 0.3, 1.0]),
       exclude_self=st.booleans())
def test_knn_model_equals_knn_ref(seed, dims, cap, cell, n, nq, k, dup, masked,
                                  exclude_self):
    """The model of K's selection equals knn_ref bit for bit in every
    column: on duplicated lattice points (ties of d2 within and across
    buckets), wrapped tiny dims, caps that drop points on both sides,
    all-masked targets, parked queries and lists shorter than k."""
    p, mask, q = tie_case(seed, n, nq, dup, masked)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    r2 = tg._f32(cell * cell)
    want = kgrid.knn_ref(grid, qg, tq, len(p), k, r2, exclude_self)
    got = knn_model(grid, qg, nq, len(p), k, r2, exclude_self)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_knn_ties_go_to_the_first_candidate_position():
    """Two points at one place, in buckets 0 and 1 of a (2, 1, 1) grid, and
    a query between them: K keeps the point of the lower bucket first,
    whatever their order in the cloud; the same point twice in one bucket
    keeps slot order (the cloud's order, build_grid's stable sort)."""
    q = np.array([[0.5, 0.125, 0.125]], np.float32)
    for p, first in (([[0.375, 0.125, 0.125], [0.625, 0.125, 0.125]], 0),
                     ([[0.625, 0.125, 0.125], [0.375, 0.125, 0.125]], 1),
                     ([[0.25, 0.125, 0.125], [0.375, 0.125, 0.125],
                       [0.375, 0.125, 0.125]], 1)):
        p = np.asarray(p, np.float32)
        grid, qg, tq = _grids(p, np.ones(len(p), bool), q, None, 0.5, (2, 1, 1), 4)
        idx, d2, _ = kgrid.knn_ref(grid, qg, tq, len(p), 2, 0.25)
        assert int(idx[0, 0]) == first and float(d2[0, 0]) == float(d2[0, 1])
        assert torch.equal(idx, knn_model(grid, qg, 1, len(p), 2, 0.25, False)[0])


# ---- the routes ----


def test_ops_route_big_q_through_the_wrappers(data, monkeypatch):
    """grid_gaussian_smooth calls kernels/grid.smooth once; the big-Q branch
    of grid_radius_neighbors calls kernels/grid.knn once and the small-Q
    path never (the wrappers are looked up at call time)."""
    calls = []

    def counted(name):
        fn = getattr(kgrid, name)
        return lambda *a, **kw: calls.append(name) or fn(*a, **kw)

    monkeypatch.setattr(kgrid, "smooth", counted("smooth"))
    monkeypatch.setattr(kgrid, "knn", counted("knn"))
    p, mask, q, vals = (torch.from_numpy(data[k]) for k in ("p", "mask", "q", "vals"))
    tg.grid_gaussian_smooth(q, p, vals, sigmas_for(RADIUS), p_mask=mask, scan_cap=32)
    tg.grid_radius_neighbors(q, p, RADIUS, K, p_mask=mask, scan_cap=32)
    assert calls == ["smooth"]
    monkeypatch.setattr(tg, "SMALL_Q_THRESHOLD", 0)
    tg.grid_radius_neighbors(q, p, RADIUS, K, p_mask=mask, scan_cap=32)
    assert calls == ["smooth", "knn"]


def test_kernels_import_no_neighbour_engine():
    """The kernels' modules import nothing of the neighbour engines that
    call them, ops/neighbors.py and ops/grid.py (kernels/sift.py takes BIG,
    sq_dists and tiled_query from core/, as radius.py and grid.py do)."""
    engines = ("mapmerge_torch.ops.neighbors", "mapmerge_torch.ops.grid")
    root = pathlib.Path(kgrid.__file__).parent
    for path in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            assert not any(n.startswith(engines) for n in names), (path.name, names)


def _small(data):
    p, mask, q, vals, cell, dims, cap, _ = _case(data, "default", "other queries")
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    return grid, qg, tq, torch.from_numpy(vals), len(p), tg._f32(cell * cell)


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere(data):
    """On CPU tensors `smooth` and `knn` are their plain versions (no launch
    counted); a tensor on another device than the CPU or a card raises."""
    grid, qg, tq, vals, n_p, r2 = _small(data)
    sigmas = sigmas_for(RADIUS)
    before = (kgrid.SMOOTH_KERNEL.launches, kgrid.KNN_KERNEL.launches)
    assert torch.equal(kgrid.smooth(grid, qg, tq, vals, sigmas, r2),
                       kgrid.smooth_ref(grid, qg, tq, vals, sigmas, r2))
    for a, b in zip(kgrid.knn(grid, qg, tq, n_p, K, r2, True),
                    kgrid.knn_ref(grid, qg, tq, n_p, K, r2, True)):
        assert torch.equal(a, b)
    assert (kgrid.SMOOTH_KERNEL.launches, kgrid.KNN_KERNEL.launches) == before
    meta = tq.to("meta")
    for name, call in (("grid_smooth", lambda: kgrid.smooth(grid, qg, meta, vals, sigmas, r2)),
                       ("grid_knn", lambda: kgrid.knn(grid, qg, meta, n_p, K, r2))):
        with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
            call()


ENTRIES = {"smooth": (kgrid.SMOOTH_KERNEL, "mm_grid_smooth"),
           "knn": (kgrid.KNN_KERNEL, "mm_grid_knn")}


def _call(entry, q, n_sigma=6, k=K):
    grid = _meta_grid()
    if entry == "smooth":
        vals = torch.empty((64,), device="meta")
        return kgrid.smooth(grid, _meta_grid(), q, vals, [0.1] * n_sigma, 0.25)
    return kgrid.knn(grid, _meta_grid(), q, 64, k, 0.25)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_card_path_launches_once_and_raises_on_a_failure(card_path, entry):
    """On the card's path a call launches its kernel once, with no host
    read; a launch that returns a CUDA error raises under the kernel's
    name; a failed build raises. No route gives the plain version."""
    kernel, fn = ENTRIES[entry]
    q = torch.empty((64, 3), device="meta")
    seen = []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: seen.append(args) or 0}))
    before = kernel.launches
    _call(entry, q)
    assert kernel.launches == before + 1 and len(seen) == 1
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(**{fn: lambda *args: 700}))
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed with error 700"):
        _call(entry, q)

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    card_path.setattr(build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _call(entry, q)


@pytest.mark.parametrize("entry,bad", [("smooth", dict(n_sigma=0)),
                                       ("smooth", dict(n_sigma=kgrid.MAX_SIGMAS + 1)),
                                       ("knn", dict(k=0)), ("knn", dict(k=kgrid.MAX_K + 1))])
def test_card_path_raises_on_sizes_it_cannot_take(card_path, entry, bad):
    """No sigma or more than MAX_SIGMAS (J), a k outside 1..MAX_K (K) raise
    before any launch."""
    card_path.setattr(build, "load", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match=ENTRIES[entry][0].name):
        _call(entry, torch.empty((64, 3), device="meta"), **bad)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_cloud():
    """The fixture's cloud regenerated: (p, mask, vals), numpy."""
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    rng = np.random.default_rng(2)
    return p, mask, (rng.random(3000) * 255.0).astype(np.float32)


def card_case(case):
    """(grid, qg, q, vals, n_p, cell) on the CPU, the grids at the cell:
    the fixture's cloud regenerated and queried at its own points (masked
    ones parked at FAR, a bucket over its cap), duplicated lattice points
    over wrapped dims (ties within and across buckets), all-masked targets,
    a query bucket over its cap, unmatched and parked queries, capped
    targets, a cloud too sparse for k candidates, one bucket full at a cap
    of 160 among empty ones."""
    p, mask, vals = card_cloud()
    q = p.copy()
    rng = np.random.default_rng(1)
    cell, dims, cap = RADIUS, None, 128
    if case == "lattice ties over wrapped dims":
        p, mask, q = tie_case(3, 2000, 400, 0.5, 0.2)
        vals = (rng.random(len(p)) * 255.0).astype(np.float32)
        cell, dims, cap = 0.375, (4, 2, 1), 256
    elif case == "all masked":
        mask = np.zeros_like(mask)
    elif case == "query bucket over its cap":
        q = (rng.random((500, 3)) * 4.0).astype(np.float32)
        q[:300] = q[0]
        cap = 64
    elif case == "unmatched and parked":
        q = (rng.random((500, 3)) * 4.0).astype(np.float32)
        q[::2] += 30.0
        q[1::4] = FAR
    elif case == "capped targets":
        cap = 8
    elif case == "fewer than k candidates":
        p, mask, q, vals = p[:200], mask[:200], q[:200], vals[:200]
    elif case == "a bucket full at a cap above 128":
        crowd = (rng.integers(0, 4, (300, 3)) * 0.125).astype(np.float32)
        near = (rng.integers(-4, 8, (60, 3)) * 0.125).astype(np.float32)
        p = np.concatenate([crowd, near])
        mask = np.ones(len(p), bool)
        q = np.concatenate([crowd[::3], near[::2]]).astype(np.float32)
        vals = (rng.random(len(p)) * 255.0).astype(np.float32)
        cell, dims, cap = 0.5, (4, 4, 4), 160
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    return grid, qg, tq, torch.from_numpy(vals), len(p), cell


CARD_CASES = ["the points", "lattice ties over wrapped dims", "all masked",
              "query bucket over its cap", "unmatched and parked", "capped targets",
              "fewer than k candidates", "a bucket full at a cap above 128"]


def card_sigmas(cell: float, n_sigma: int) -> list[float]:
    """sigmas_for(cell) at 6, else n sigmas down from the same largest (3
    sigma_max the cell) evenly to a quarter of it: J's 1 and 64."""
    if n_sigma == 6:
        return sigmas_for(cell)
    top = cell / 3.0
    return [top * (1.0 - 0.75 * s / max(n_sigma - 1, 1)) for s in range(n_sigma)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("n_sigma", [6, 1, 64])
def test_smooth_kernel_within_tolerance_and_repeating(cuda, case, n_sigma):
    """Kernel J at 1, 6 and 64 sigmas: within SCALE_SPACE_RTOL of
    smooth_ref's field, the rows of unanswered queries exactly 0, bit for
    bit again on a second launch, one launch a call."""
    grid, qg, q, vals, _, cell = card_case(case)
    sigmas = card_sigmas(cell, n_sigma)
    r2 = tg._f32(cell * cell)
    want = kgrid.smooth_ref(grid, qg, q, vals, sigmas, r2)
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda), vals.to(cuda))
    before = kgrid.SMOOTH_KERNEL.launches
    got = kgrid.smooth(*on_card, sigmas, r2).cpu()
    again = kgrid.smooth(*on_card, sigmas, r2).cpu()
    assert kgrid.SMOOTH_KERNEL.launches == before + 2
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert field_error(got, want) <= ksift.SCALE_SPACE_RTOL
    answered = torch.zeros(q.shape[0], dtype=torch.bool)
    answered[qg.cell_idx[qg.cell_ok]] = True
    assert bool((got[~answered] == 0).all()) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("k,exclude_self", [(K, False), (K, True), (9, False)])
def test_knn_kernel_equals_the_plain_version(cuda, case, k, exclude_self):
    """Kernel K bit for bit knn_ref in every column (idx, d2, valid), one
    launch a call, and again on a second launch."""
    grid, qg, q, _, n_p, cell = card_case(case)
    r2 = tg._f32(cell * cell)
    want = kgrid.knn_ref(grid, qg, q, n_p, k, r2, exclude_self)
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda))
    before = kgrid.KNN_KERNEL.launches
    got = [a.cpu() for a in kgrid.knn(*on_card, n_p, k, r2, exclude_self)]
    again = [a.cpu() for a in kgrid.knn(*on_card, n_p, k, r2, exclude_self)]
    assert kgrid.KNN_KERNEL.launches == before + 2
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_sift_grid_octave_through_the_kernels(cuda, monkeypatch):
    """ops/grid's two SIFT calls on the card, as ops/keypoints/sift.py makes
    them on a grid octave (the points as queries, masked ones parked; every
    query set on the big-Q path), go through J and K once each and give the
    plain versions' results: J within SCALE_SPACE_RTOL, K bit for bit."""
    monkeypatch.setattr(tg, "SMALL_Q_THRESHOLD", 0)
    p, mask, vals = (torch.from_numpy(a) for a in card_cloud())
    cell = RADIUS
    sigmas = sigmas_for(cell)
    before = (kgrid.SMOOTH_KERNEL.launches, kgrid.KNN_KERNEL.launches)
    field, _ = tg.grid_gaussian_smooth(p.to(cuda), p.to(cuda), vals.to(cuda), sigmas,
                                       p_mask=mask.to(cuda))
    nbrs = tg.grid_radius_neighbors(p.to(cuda), p.to(cuda), cell, K, p_mask=mask.to(cuda))
    assert (kgrid.SMOOTH_KERNEL.launches, kgrid.KNN_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want_field, _ = tg.grid_gaussian_smooth(p, p, vals, sigmas, p_mask=mask)
    want_nbrs = tg.grid_radius_neighbors(p, p, cell, K, p_mask=mask)
    assert field_error(field.cpu(), want_field) <= ksift.SCALE_SPACE_RTOL
    for a, b in zip(nbrs, want_nbrs):
        assert torch.equal(a.cpu(), b)
