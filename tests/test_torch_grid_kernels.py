"""The cell-grid engine's sweeps of mapmerge_torch (kernels G, H and I:
kernels/grid.py, csrc/grid.cu) on their plain versions, against the JAX
package's grid_nn_query, grid_neighbor_moments and grid_radius_count.

Each kernel answers a query slot from the filled slots of the distinct
wrapped neighbour buckets in ascending bucket id, then slot order (G, H
and I cull tiles of them exactly: tests/test_torch_grid_select.py,
tests/test_torch_grid_radius_cull.py and tests/test_torch_grid_count_cull.py
model their schedules). Here: the plain versions and
ops/grid's three functions (which take them on the CPU) against the JAX
package, on tests/test_torch_grid.py's cloud (3,000 points in a 4 m cube,
10% masked and parked at FAR, 500 queries, radius 0.35) and its grid cases;
a numpy model of that visit rule (G: strict <, the first candidate's index
where nothing is within the bound; H: each query's members summed in
visit order in float32; I: the member count) against the plain versions
under hypothesis, on lattice clouds (ties everywhere) over tiny wrapped
dims, small caps, masks, parked points and unmatched queries; the target
slots the kernels read (s < count) against cell_ok; the wrappers' routes
(the meta device stands in for the card: one launch, a raise on a failed
launch, on an unsupported device and on grids the kernels cannot index).

Tolerances against the JAX package: indices, counts and overflow exactly;
G's d2 within 1e-6 relative (XLA's CPU code may round the sum of three
squares otherwise, tests/test_torch_grid.py); moments within rtol 1e-5 /
atol 1e-6 (tests/test_torch_grid.py's FLOAT_TOL: another summation order).

The `cuda` cases hold the kernels against their plain versions (G and I bit
for bit, H within MOMENTS_RTOL, bit for bit the model of the sweep's order
and repeating), duplicated points and a bucket full at a cap above 128
among them, and skip here; on a machine with a GPU: `python -m pytest
tests/test_torch_grid_kernels.py -m cuda --noconftest`.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.kernels import radius as kradius
from mapmerge_torch.ops import grid as tg

from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

RADIUS = 0.35
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
BIG = np.float32(tg.BIG)

#: name -> (cell size, dims, cap, coordinate shift, the JAX grid_query's
#: tile, which must divide H); no bucket of this cloud holds 32 points, so
#: a cap of 32 keeps every point as 128 would, at a quarter of the planes
GRID_CASES = {
    "default": (RADIUS, None, 32, 0.0, 16),
    "capped buckets": (RADIUS, None, 2, 0.0, 16),
    "tiny dims that wrap": (RADIUS, (2, 2, 1), 256, 0.0, 4),
    "negative coordinates": (RADIUS, None, 32, -2.0, 16),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    q_mask = rng.random(500) > 0.2
    return dict(p=p, mask=mask, q=q, q_mask=q_mask)


def _case(data, name):
    """(p, mask, q, q_mask, cell, dims, cap, tile) of a grid case, numpy."""
    cell, dims, cap, shift, tile = GRID_CASES[name]
    p = np.where(data["mask"][:, None], data["p"] + shift, data["p"]).astype(np.float32)
    q = (data["q"] + shift).astype(np.float32)
    return p, data["mask"], q, data["q_mask"], cell, dims, cap, tile


def _grids(p, mask, q, q_mask, cell, dims, cap):
    """The port's target and query grids (build_grid, as ops/grid builds
    them) of numpy inputs, and q as a tensor."""
    grid = tg.build_grid(torch.from_numpy(p), torch.from_numpy(mask), cell, dims, cap)
    tq = torch.from_numpy(q)
    qm = None if q_mask is None else torch.from_numpy(q_mask)
    return grid, tg.build_grid(tq, qm, grid.cell_size, grid.dims, grid.cap), tq


# ---- the plain versions against the JAX package ----


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_nn_query_ref_matches_jax_grid_nn_query(data, name):
    """nn_query_ref and ops/grid.grid_nn_query (which takes it on the CPU)
    against the JAX package's grid_nn_query on the same grid: indices and
    overflow exactly, d2 within 1e-6 relative; the unmatched queries at
    BIG."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, q_mask, cell, dims, cap, tile = _case(data, name)
    grid, qg, tq = _grids(p, mask, q, q_mask, cell, dims, cap)
    idx, d2 = kgrid.nn_query_ref(grid, qg, tq, 3000)
    oi, od, over = tg.grid_nn_query(grid, tq, 3000, q_mask=torch.from_numpy(q_mask))
    assert torch.equal(idx, oi) and torch.equal(d2, od) and torch.equal(over, qg.overflow)
    jgrid = jg.build_grid(jnp.asarray(p), jnp.asarray(mask), cell, dims, cap)
    ji, jd, jo = jg.grid_nn_query(jgrid, jnp.asarray(q), 3000, tile=tile,
                                  q_mask=jnp.asarray(q_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), rtol=1e-6)
    assert int(over) == int(jo)
    assert (d2 == BIG).any() and (d2 < BIG).any()
    if name == "capped buckets":
        assert int(over) > 0


@pytest.mark.parametrize("name", list(GRID_CASES))
@pytest.mark.parametrize("include_self", [True, False])
def test_count_ref_matches_jax_grid_radius_count(data, name, include_self):
    """count_ref and ops/grid.grid_radius_count against the JAX package's
    grid_radius_count: counts and overflow exactly."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, _, cell, dims, cap, tile = _case(data, name)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    got = kgrid.count_ref(grid, qg, tq, tg._f32(cell * cell), include_self)
    oc, over = tg.grid_radius_count(tq, torch.from_numpy(p), cell,
                                    p_mask=torch.from_numpy(mask),
                                    include_self=include_self, scan_cap=cap, dims=dims)
    assert torch.equal(got, oc) and torch.equal(over, qg.overflow)
    want, jo = jg.grid_radius_count(jnp.asarray(q), jnp.asarray(p), cell,
                                    p_mask=jnp.asarray(mask), tile=tile,
                                    include_self=include_self, scan_cap=cap, dims=dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(over) == int(jo)


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_moments_ref_matches_jax_grid_neighbor_moments(data, name):
    """moments_ref and ops/grid.grid_neighbor_moments against the JAX
    package's grid_neighbor_moments: counts and overflow exactly, mean and
    covariance within FLOAT_TOL."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, _, cell, dims, cap, tile = _case(data, name)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    got = kgrid.moments_ref(grid, qg, tq, tg._f32(cell * cell))
    op = tg.grid_neighbor_moments(tq, torch.from_numpy(p), cell,
                                  p_mask=torch.from_numpy(mask), scan_cap=cap, dims=dims)
    for a, b in zip(got, op[:3]):
        assert torch.equal(a, b)
    assert torch.equal(op[3], qg.overflow)
    jc, jm, jcov, jo = jg.grid_neighbor_moments(
        jnp.asarray(q), jnp.asarray(p), cell, p_mask=jnp.asarray(mask), tile=tile,
        scan_cap=cap, dims=dims)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jc))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jm), **FLOAT_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jcov), **FLOAT_TOL)
    assert int(op[3]) == int(jo) and (got[0] > 0).any()


def test_grid_nearest_neighbor_matches_jax(data):
    """The transform score's entry (a grid built per call, bound = cell),
    through nn_query on the CPU, against the JAX package's."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, q_mask = data["p"], data["mask"], data["q"], data["q_mask"]
    ti, td, to = tg.grid_nearest_neighbor(
        torch.from_numpy(q), torch.from_numpy(p), RADIUS, p_mask=torch.from_numpy(mask),
        scan_cap=16, q_mask=torch.from_numpy(q_mask))
    ji, jd, jo = jg.grid_nearest_neighbor(
        jnp.asarray(q), jnp.asarray(p), RADIUS, p_mask=jnp.asarray(mask), scan_cap=16,
        q_mask=jnp.asarray(q_mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert int(to) == int(jo)


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_kernels_read_filled_slots_which_are_cell_ok(data, name):
    """The kernels read the target slots s < count[h]: for a grid from
    build_grid that is cell_ok exactly (filled slots first, in order)."""
    p, mask, q, q_mask, cell, dims, cap, _ = _case(data, name)
    for g in _grids(p, mask, q, q_mask, cell, dims, cap)[:2]:
        filled = torch.arange(g.cap)[None, :] < g.count[:, None].long()
        assert torch.equal(filled, g.cell_ok)


# ---- a numpy model of the kernels' visit rule ----

_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def neighbours(b: int, dims) -> list[int]:
    """The distinct wrapped neighbour buckets of bucket b, ascending."""
    gx, gy, gz = dims
    bx, by, bz = b % gx, (b // gx) % gy, b // (gx * gy)
    return sorted({(((bz + dz) % gz) * gy + (by + dy) % gy) * gx + (bx + dx) % gx
                   for dx, dy, dz in _OFFSETS})


def _seq(x):
    """The float32 sum of x in order, one rounding a step."""
    return np.cumsum(x, dtype=np.float32)[-1] if len(x) else np.float32(0.0)


def sweep_model(grid, qg, nq: int, r2: float, op: str, n_p: int = 0,
                include_self: bool = True):
    """csrc/grid.cu's visit rule in numpy float32, query slot by query
    slot: the candidates are the filled slots of neighbours(b) in that
    order, a member has ((q - p)_x^2 + (q - p)_y^2) + (q - p)_z^2 <= r2.
    op "nn": (idx, d2), the first smallest member, else (the first
    candidate position's index, BIG), idx >= n_p -> 0; "count": the member
    count (- 1 without include_self); "moments": (count, mean, cov) of the
    members' offsets p - q summed in visit order, the plain epilogue."""
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    r2 = np.float32(r2)
    sub = 0 if include_self else 1
    out = {"nn": [np.zeros(nq, np.int32), np.full(nq, BIG, np.float32)],
           "count": [np.full(nq, -sub, np.int32)],
           "moments": [np.zeros(nq, np.float32), np.zeros((nq, 3), np.float32),
                       np.zeros((nq, 3, 3), np.float32)]}[op]
    for b in np.flatnonzero(q_ok.any(axis=1)):
        ids = neighbours(int(b), grid.dims)
        cand = np.concatenate([t_xyz[i, : t_count[i]] for i in ids]).reshape(-1, 3)
        where = [(i, s) for i in ids for s in range(t_count[i])]
        for s in np.flatnonzero(q_ok[b]):
            q, row = q_xyz[b, s], q_idx[b, s]
            d = q[None, :] - cand
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            member = np.flatnonzero(d2 <= r2)
            if op == "nn":
                if len(member):
                    j = member[np.argmin(d2[member])]  # the first smallest
                    i, slot = where[j]
                    out[1][row] = d2[j]
                else:
                    i, slot = ids[0], 0
                r = t_idx[i, slot]
                out[0][row] = 0 if r >= n_p else r
            elif op == "count":
                out[0][row] = len(member) - sub
            else:
                rel = cand[member] - q[None, :]
                n = np.float32(len(member))
                s1 = np.array([_seq(rel[:, c]) for c in range(3)], np.float32)
                s2 = np.array([[_seq(rel[:, a] * rel[:, c]) for c in range(3)]
                               for a in range(3)], np.float32)
                denom = np.maximum(n, np.float32(1.0))
                m = s1 / denom
                out[0][row] = n
                out[1][row] = m + q
                out[2][row] = s2 / denom - m[:, None] * m[None, :]
    return [torch.from_numpy(a) for a in out]


TINY_DIMS = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1), (4, 4, 2), (8, 4, 2)]


def lattice_case(seed: int, n: int, nq: int, masked: float, parked: float):
    """Points on a 1/8 m lattice over 1.5 m (squared distances exact, ties
    everywhere), a share masked and a share of those parked at FAR; queries
    half the points themselves, half lattice points over 2.5 m (some beyond
    every target: unmatched), every fifth parked at FAR, a share outside
    q_mask. numpy: (p, mask, q, q_mask)."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(-6, 7, (n, 3)) * 0.125).astype(np.float32)
    mask = rng.random(n) >= masked
    p[~mask & (rng.random(n) < parked)] = FAR
    q = np.concatenate([p[rng.integers(0, n, nq // 2)],
                        (rng.integers(-10, 11, (nq - nq // 2, 3)) * 0.125)]).astype(np.float32)
    q[::5] = FAR
    return p, mask, q, rng.random(nq) >= 0.2


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(TINY_DIMS),
       cap=st.sampled_from([1, 2, 5, 16, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 150), nq=st.integers(2, 60),
       masked=st.sampled_from([0.0, 0.3, 1.0]), parked=st.sampled_from([0.0, 0.5]))
def test_visit_model_equals_the_plain_versions(seed, dims, cap, cell, n, nq, masked, parked):
    """The model of G's visit rule equals nn_query_ref bit for bit, I's
    count_ref, and H's sums in visit order sit within MOMENTS_RTOL of
    moments_ref with the same counts: on wrapped tiny dims, ties across
    buckets, query and target buckets over their cap, all-masked targets,
    parked points and unmatched queries."""
    p, mask, q, q_mask = lattice_case(seed, n, nq, masked, parked)
    grid, qg, tq = _grids(p, mask, q, q_mask, cell, dims, cap)
    assert torch.equal(torch.arange(cap)[None, :] < grid.count[:, None].long(), grid.cell_ok)
    want = kgrid.nn_query_ref(grid, qg, tq, n)
    got = sweep_model(grid, qg, nq, tg._f32(cell * cell), "nn", n_p=n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    r2 = tg._f32(cell * cell)
    for include_self in (True, False):
        assert torch.equal(sweep_model(grid, qg, nq, r2, "count", include_self=include_self)[0],
                           kgrid.count_ref(grid, qg, tq, r2, include_self))
    model = sweep_model(grid, qg, nq, r2, "moments")
    ref = kgrid.moments_ref(grid, qg, tq, r2)
    assert torch.equal(model[0], ref[0])
    assert kradius.moments_error(model, ref, tq)[1] <= kradius.MOMENTS_RTOL


def test_visit_model_default_is_the_first_candidate_position():
    """A query with no member within the bound gets d2 = BIG and the index
    of the first candidate position, cell_idx[smallest neighbour, 0], which
    is a real point when that slot is filled: argmin over a row of BIG."""
    p = np.array([[0.1, 0.1, 0.1], [0.9, 0.9, 0.1]], np.float32)  # buckets 0, 3
    q = np.array([[0.6, 0.4, 0.1]], np.float32)  # bucket 1, nothing within 0.3
    grid, qg, tq = _grids(p, np.ones(2, bool), q, None, 0.5, (2, 2, 1), 4)
    for idx, d2 in (kgrid.nn_query_ref(grid, qg, tq, 2),
                    sweep_model(grid, qg, 1, tg._f32(0.25), "nn", n_p=2)):
        assert int(idx[0]) == 0 and float(d2[0]) == float(BIG)
    grid, qg, tq = _grids(p[::-1].copy(), np.ones(2, bool), q, None, 0.5, (2, 2, 1), 4)
    assert int(kgrid.nn_query_ref(grid, qg, tq, 2)[0][0]) == 1  # point 1 in bucket 0


# ---- the wrappers' routes ----


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere(data):
    """On CPU tensors the wrappers are their plain versions (no launch
    counted); a tensor on another device than the CPU or a card raises."""
    p, mask, q, q_mask, cell, dims, cap, _ = _case(data, "default")
    grid, qg, tq = _grids(p, mask, q, q_mask, cell, dims, cap)
    kernels = (kgrid.NN_KERNEL, kgrid.MOMENTS_KERNEL, kgrid.COUNT_KERNEL)
    before = [k.launches for k in kernels]
    r2 = tg._f32(cell * cell)
    for a, b in zip(kgrid.nn_query(grid, qg, tq, 3000), kgrid.nn_query_ref(grid, qg, tq, 3000)):
        assert torch.equal(a, b)
    for a, b in zip(kgrid.moments(grid, qg, tq, r2), kgrid.moments_ref(grid, qg, tq, r2)):
        assert torch.equal(a, b)
    assert torch.equal(kgrid.count(grid, qg, tq, r2, False),
                       kgrid.count_ref(grid, qg, tq, r2, False))
    assert [k.launches for k in kernels] == before
    meta = tq.to("meta")
    for name, call in (("grid_nn", lambda: kgrid.nn_query(grid, qg, meta, 3000)),
                       ("grid_moments", lambda: kgrid.moments(grid, qg, meta, r2)),
                       ("grid_count", lambda: kgrid.count(grid, qg, meta, r2))):
        with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
            call()


def _meta_grid(h=8, cap=4, dims=(2, 2, 2), **changes):
    meta = torch.device("meta")
    g = tg.CellGrid(
        cell_xyz=torch.empty((h, cap, 3), device=meta),
        cell_idx=torch.empty((h, cap), dtype=torch.int64, device=meta),
        cell_ok=torch.empty((h, cap), dtype=torch.bool, device=meta),
        count=torch.empty((h,), dtype=torch.int32, device=meta),
        raw_max=torch.empty((), dtype=torch.int32, device=meta),
        overflow=torch.empty((), dtype=torch.int32, device=meta),
        cell_size=0.5, dims=dims, cap=cap)
    return g if not changes else dataclasses.replace(g, **changes)


ENTRIES = {"nn": ("grid_nn", "mm_grid_nn"), "moments": ("grid_moments", "mm_grid_moments"),
           "count": ("grid_count", "mm_grid_count")}


def _call(entry, grid, qg, q):
    if entry == "nn":
        return kgrid.nn_query(grid, qg, q, 100)
    return getattr(kgrid, entry)(grid, qg, q, 0.25)


@pytest.fixture
def card_path(monkeypatch):
    """The card's path stood in for by the meta device (no data): the
    device check, the device context and the stream accept it."""
    monkeypatch.setattr(build, "cuda_device", lambda kernel, x: x.device)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    return monkeypatch


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_card_path_launches_once_and_raises_on_a_failure(card_path, entry):
    """On the card's path a call launches its kernel once, with no host
    read; a launch that returns a CUDA error raises under the kernel's
    name; a failed build raises. No route gives the plain version."""
    name, fn = ENTRIES[entry]
    kernel = {"nn": kgrid.NN_KERNEL, "moments": kgrid.MOMENTS_KERNEL,
              "count": kgrid.COUNT_KERNEL}[entry]
    q = torch.empty((64, 3), device="meta")
    seen = []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: seen.append(args) or 0}))
    before = kernel.launches
    _call(entry, _meta_grid(), _meta_grid(), q)
    assert kernel.launches == before + 1 and len(seen) == 1
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(**{fn: lambda *args: 700}))
    with pytest.raises(RuntimeError, match=f"{name}: CUDA launch failed with error 700"):
        _call(entry, _meta_grid(), _meta_grid(), q)

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    card_path.setattr(build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _call(entry, _meta_grid(), _meta_grid(), q)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("bad", ["dims", "query cap", "H", "dtype"])
def test_card_path_raises_on_grids_it_cannot_index(card_path, entry, bad):
    """Grids the kernel cannot index raise before any launch: a query grid
    of other dims or cap, H != Gx Gy Gz, a cell_idx that is not int64."""
    card_path.setattr(build, "load", lambda *a: pytest.fail("launched"))
    grid, qg = _meta_grid(), _meta_grid()
    if bad == "dims":
        qg = _meta_grid(dims=(4, 2, 1))
    elif bad == "query cap":
        qg = _meta_grid(cap=8)
    elif bad == "H":
        grid = qg = _meta_grid(dims=(2, 2, 1))
    else:
        grid = _meta_grid(cell_idx=torch.empty((8, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=ENTRIES[entry][0]):
        _call(entry, grid, qg, torch.empty((64, 3), device="meta"))


def test_moments_error_scales_by_each_querys_second_moment():
    """moments_error about the queries (kernels/radius.py, H's origin): the
    covariance's difference over the largest entry of |cov + m m^T| (m =
    mean - q), the mean's, less one float32 step, over its square root; 0
    where both agree, inf where only the scale is 0."""
    q = torch.tensor([[10.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    ref = (torch.tensor([2.0, 0.0]), torch.tensor([[11.0, 0.0, 0.0], [0.0, 0.0, 0.0]]),
           torch.zeros((2, 3, 3)))
    ref[2][0, 1, 1] = 3.0  # second moments about query 0: xx 1, yy 3
    got = (ref[0], ref[1].clone(), ref[2].clone())
    got[2][0, 0, 0] += 6e-5
    assert kradius.moments_error(got, ref, q) == (pytest.approx(6e-5), pytest.approx(2e-5))
    got[2][0, 0, 0] -= 6e-5
    got[1][0, 0] = torch.nextafter(torch.tensor(11.0), torch.tensor(12.0))  # one step
    assert kradius.moments_error(got, ref, q)[1] == 0.0
    got[1][1, 2] = 1e-9
    assert kradius.moments_error(got, ref, q)[1] == float("inf")


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_case(case):
    """(grid, qg, q, n_p, r2) on the CPU: the fixture's cloud regenerated,
    lattice ties over wrapped dims, all-masked targets, a query bucket over
    its cap, unmatched and parked queries, capped targets, duplicated
    lattice points (some parked at FAR) over wrapped dims, one bucket full
    at a cap of 160 among empty ones."""
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    q_mask = rng.random(500) > 0.2
    cell, dims, cap = RADIUS, None, 128
    if case == "wrapped lattice ties":
        p, mask, q, q_mask = lattice_case(3, 2000, 400, 0.2, 0.5)
        cell, dims, cap = 0.375, (4, 2, 1), 256
    elif case == "all masked":
        mask = np.zeros_like(mask)
    elif case == "query bucket over its cap":
        q[:300] = q[0]
        cap = 64
    elif case == "unmatched and parked":
        q[::2] += 30.0
        q[1::4] = FAR
    elif case == "capped targets":
        cap = 8
    elif case == "duplicated points":
        p, mask, q, q_mask = lattice_case(5, 1500, 400, 0.2, 0.5)
        p, mask = np.concatenate([p, p[:700]]), np.concatenate([mask, mask[:700]])
        cell, dims, cap = 0.375, (4, 4, 2), 128
    elif case == "a bucket full at a cap above 128":
        rng = np.random.default_rng(5)
        crowd = (rng.integers(0, 4, (300, 3)) * 0.125).astype(np.float32)
        near = (rng.integers(-4, 8, (60, 3)) * 0.125).astype(np.float32)
        p = np.concatenate([crowd, near])
        mask = np.ones(len(p), bool)
        q = np.concatenate([crowd[::3], near[::2]]).astype(np.float32)
        q_mask = np.ones(len(q), bool)
        cell, dims, cap = 0.5, (4, 4, 4), 160
    grid, qg, tq = _grids(p, mask, q, q_mask, cell, dims, cap)
    return grid, qg, tq, len(p), tg._f32(cell * cell)


CARD_CASES = ["random", "wrapped lattice ties", "all masked", "query bucket over its cap",
              "unmatched and parked", "capped targets", "duplicated points",
              "a bucket full at a cap above 128"]


def _to(grid, dev):
    return dataclasses.replace(grid, **{
        f: getattr(grid, f).to(dev) for f in
        ("cell_xyz", "cell_idx", "cell_ok", "count", "raw_max", "overflow")})


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_nn_and_count_kernels_equal_the_plain_versions(cuda, case):
    """Kernels G and I bit for bit nn_query_ref and count_ref, one launch
    a call."""
    grid, qg, q, n_p, r2 = card_case(case)
    want_nn = kgrid.nn_query_ref(grid, qg, q, n_p)
    want_count = kgrid.count_ref(grid, qg, q, r2, False)
    grid, qg, q = _to(grid, cuda), _to(qg, cuda), q.to(cuda)
    before = (kgrid.NN_KERNEL.launches, kgrid.COUNT_KERNEL.launches)
    got_nn = kgrid.nn_query(grid, qg, q, n_p)
    got_count = kgrid.count(grid, qg, q, r2, False)
    assert (kgrid.NN_KERNEL.launches, kgrid.COUNT_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got_nn, want_nn):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got_count.cpu(), want_count)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_moments_kernel_within_tolerance_and_repeating(cuda, case):
    """Kernel H: moments_ref's count exactly, mean and covariance within
    MOMENTS_RTOL, bit for bit the float32 model of its visit order and bit
    for bit again on a second launch."""
    grid, qg, q, n_p, r2 = card_case(case)
    want = kgrid.moments_ref(grid, qg, q, r2)
    model = sweep_model(grid, qg, q.shape[0], r2, "moments")
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda))
    got = [a.cpu() for a in kgrid.moments(*on_card, r2)]
    again = [a.cpu() for a in kgrid.moments(*on_card, r2)]
    assert torch.equal(got[0], want[0])
    assert kradius.moments_error(got, want, q)[1] <= kradius.MOMENTS_RTOL
    for a, b, c in zip(got, again, model):
        assert torch.equal(a, b) and torch.equal(a, c)
