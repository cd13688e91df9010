"""The grid radius kernels of mapmerge_torch, kernel H (the neighbourhood
moments, kernels/grid.py `moments`) and kernel J (SIFT's grid scale space,
`smooth`), as csrc/grid.cu schedules them: the pre-pass of G and K
(kernels/grid.pack_ref: the box of every run of 32 slots of each target
bucket, and units of up to 32 answered slots of one query bucket, a lane a
query); a unit walks the tiles of its bucket's distinct neighbours in
candidate order (ascending neighbour id, then tile), skips a tile whose box
lies beyond r2 of the box of its queries, and on each tile it visits every
lane whose own box bound is within r2 adds its members in slot order. A
member is a point within the fixed radius and nothing else adds to a sum,
so the culling leaves each lane the sweep's terms in the sweep's order.

Here: a numpy float32 model of that schedule (`radius_model`) held under
hypothesis, on wrapped grids (axes of 1 and 2 cells, a 4-cell z axis under
a cloud 8 cells tall), duplicated lattice points, empty target buckets,
masked points and queries parked at FAR: its member lists equal the
sweep's (every filled slot of the distinct neighbours in candidate order,
count_ref's counts) exactly; H's sums equal the float32 model of the
sweep's order (tests/test_torch_grid_kernels.sweep_model) bit for bit and
moments_ref within MOMENTS_RTOL with the same counts; J's field within
SCALE_SPACE_RTOL of smooth_ref at 1, 6 and 64 sigmas, unanswered rows 0;
the same on a bucket full at caps above 128; the model against the JAX
package's grid_neighbor_moments and grid_gaussian_smooth on a seeded cloud
(tests/test_torch_grid_kernels.py's and tests/test_torch_grid_sift_kernels.py's
tolerances), where it compares fewer pairs than the sweep; the wrappers' card path (the meta
device stands in for the card: one C call a call, the pre-pass counted as
"grid_pack" with it, no plane of values in the grid's layout).

The `cuda` cases hold H bit for bit against the model (and its count
against moments_ref), J within SCALE_SPACE_RTOL of smooth_ref, both
repeating, and the kernels' counters (pairs compared, tiles visited,
units, answered, members) equal to the model's; they skip here. On a
machine with a GPU: `python -m pytest tests/test_torch_grid_radius_cull.py
-m cuda --noconftest`.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.kernels import radius as kradius
from mapmerge_torch.kernels import sift as ksift
from mapmerge_torch.ops import grid as tg

from test_torch_grid_kernels import (  # noqa: F401 (card_path: a fixture)
    FLOAT_TOL, _grids, _meta_grid, _seq, _to, card_path, neighbours, sweep_model,
)
from test_torch_grid_select import DIMS, box_bound, boxes_bound, crowded_case, select_case
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = kgrid.TILE


def sigmas_for(cell: float, n: int = 6) -> list[float]:
    """n sigmas whose 3 sigma_max is the cell: SIFT's spacing 2^(s/3) for
    n = 6, else down from the largest evenly to a quarter of it."""
    top = cell / 3.0
    if n == 6:
        return [top * 2.0 ** ((s - 5) / 3.0) for s in range(6)]
    return [top * (1.0 - 0.75 * s / max(n - 1, 1)) for s in range(n)]


def _d2(q, pts, offsets: bool):
    """Each point's squared distance to q in float32, as the kernel's member
    test rounds it: H from the offsets p - q, J from q - p (sq_dist)."""
    d = pts - q[None, :] if offsets else q[None, :] - pts
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def radius_model(grid, qg, q, r2: float, values=None, sigmas=None):
    """csrc/grid.cu's H (values None) or J (the values (P,) at `sigmas`), a
    lane a query, in numpy float32, unit by unit of pack_ref's list: (the
    outputs of kernels/grid.moments or smooth, each answered row's members
    as the point indices its lane added, in order, and the counters
    {pairs_compared, tiles_visited, units, answered, members})."""
    boxes, units = (a.numpy() for a in kgrid.pack_ref(grid, qg, q))
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    h, cap = t_idx.shape
    n_tiles, gmax = -(-cap // TILE), -(-cap // 32)
    r2 = np.float32(r2)
    nq = q.shape[0]
    smooth = values is not None
    if smooth:
        vals = values.numpy()
        recips = np.array(kgrid._recips(sigmas), np.float32)
        out = [np.zeros((nq, len(sigmas)), np.float32)]
    else:
        out = [np.zeros(nq, np.float32), np.zeros((nq, 3), np.float32),
               np.zeros((nq, 3, 3), np.float32)]
    members = {}
    counts = {"pairs_compared": 0, "tiles_visited": 0, "units": 0, "answered": 0,
              "members": 0}
    for code in units[1 : units[0] + 1]:
        b, group = divmod(int(code), gmax)
        slots = np.flatnonzero(q_ok[b])[group * 32 : (group + 1) * 32]
        counts["units"] += 1
        counts["answered"] += len(slots)
        if not len(slots):
            continue
        qs = q_xyz[b, slots]
        qlo, qhi = qs.min(axis=0), qs.max(axis=0)
        added = [[] for _ in slots]  # each lane's members: (bucket, slot)
        for nb in neighbours(b, grid.dims):  # candidate order
            c = min(int(t_count[nb]), cap)
            for t in range(-(-c // TILE)):
                lo, hi = boxes[nb * n_tiles + t, 0, :3], boxes[nb * n_tiles + t, 1, :3]
                if not boxes_bound(qlo, qhi, lo, hi) <= r2:
                    continue  # beyond the radius of the queries' box: not issued
                reach = [bool(box_bound(qv, lo, hi) <= r2) for qv in qs]
                if not any(reach):
                    continue
                pts = t_xyz[nb, t * TILE : min(c, (t + 1) * TILE)]
                counts["tiles_visited"] += 1
                counts["pairs_compared"] += sum(reach) * len(pts)
                for s, qv in enumerate(qs):
                    if reach[s]:
                        hit = np.flatnonzero(_d2(qv, pts, not smooth) <= r2)
                        added[s].extend((nb, t * TILE + int(j)) for j in hit)
        for s, slot in enumerate(slots):
            row, qv = q_idx[b, slot], qs[s]
            members[int(row)] = [int(t_idx[i, j]) for i, j in added[s]]
            counts["members"] += len(added[s])
            pts = np.array([t_xyz[i, j] for i, j in added[s]], np.float32).reshape(-1, 3)
            if smooth:  # C's arithmetic: exp of -d2 c, sums in order
                neg = -_d2(qv, pts, False)
                v = vals[members[int(row)]].astype(np.float32)
                for k, c in enumerate(recips):
                    w = np.exp(neg * c).astype(np.float32)
                    out[0][row, k] = _seq(w * v) / np.maximum(_seq(w), np.float32(1e-12))
                continue
            rel = pts - qv[None, :]
            n = np.float32(len(rel))
            s1 = np.array([_seq(rel[:, a]) for a in range(3)], np.float32)
            s2 = np.array([[_seq(rel[:, a] * rel[:, c]) for c in range(3)] for a in range(3)],
                          np.float32)
            denom = np.maximum(n, np.float32(1.0))
            m = s1 / denom
            out[0][row], out[1][row] = n, m + qv
            out[2][row] = s2 / denom - m[:, None] * m[None, :]
    return [torch.from_numpy(a) for a in out], members, counts


def sweep_members(grid, qg, r2: float, offsets: bool) -> dict:
    """Each answered row's members as the one-thread-a-slot sweep met them:
    every filled slot of the distinct neighbours in candidate order, those
    within r2."""
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    out = {}
    for b in np.flatnonzero(q_ok.any(axis=1)):
        ids = neighbours(int(b), grid.dims)
        cand = np.concatenate([t_xyz[i, : t_count[i]] for i in ids]).reshape(-1, 3)
        idx = np.concatenate([t_idx[i, : t_count[i]] for i in ids]).astype(np.int64)
        for s in np.flatnonzero(q_ok[b]):
            hit = _d2(q_xyz[b, s], cand, offsets) <= np.float32(r2)
            out[int(q_idx[b, s])] = [int(i) for i in idx[hit]]
    return out


def hold_moments(grid, qg, tq, r2):
    """H's model: the sweep's members, the float32 sweep model's bits,
    moments_ref's counts and MOMENTS_RTOL. Returns the model's counters."""
    got, members, counts = radius_model(grid, qg, tq, r2)
    assert members == sweep_members(grid, qg, r2, True)
    ref = kgrid.moments_ref(grid, qg, tq, r2)
    answered = sorted(members)
    assert [len(members[r]) for r in answered] == ref[0][answered].long().tolist()
    assert counts["members"] == int(kgrid.count_ref(grid, qg, tq, r2).long().sum())
    for a, b in zip(got, sweep_model(grid, qg, tq.shape[0], r2, "moments")):
        assert torch.equal(a, b)
    assert torch.equal(got[0], ref[0])
    assert kradius.moments_error(got, ref, tq)[1] <= kradius.MOMENTS_RTOL
    return counts


def field_error(got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)


def hold_smooth(grid, qg, tq, vals, sigmas, r2):
    """J's model: the sweep's members, smooth_ref within SCALE_SPACE_RTOL,
    the unanswered rows 0. Returns the model's counters."""
    (got,), members, counts = radius_model(grid, qg, tq, r2, vals, sigmas)
    assert members == sweep_members(grid, qg, r2, False)
    want = kgrid.smooth_ref(grid, qg, tq, vals, sigmas, r2)
    assert got.shape == want.shape
    assert field_error(got, want) <= ksift.SCALE_SPACE_RTOL
    answered = torch.zeros(tq.shape[0], dtype=torch.bool)
    answered[qg.cell_idx[qg.cell_ok]] = True
    assert bool((got[~answered] == 0).all())
    return counts


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([1, 5, 16, 40, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 140), nq=st.integers(2, 50), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans())
def test_moments_model_keeps_the_sweeps_members_and_bits(seed, dims, cap, cell, n, nq, dup,
                                                         masked, tall):
    """H's culled schedule adds each query's members, and only them, in
    candidate order: the sweep's member lists exactly, its float32 sums bit
    for bit, moments_ref within MOMENTS_RTOL with the same counts; on
    wrapped dims, duplicated lattice points (ties within and across
    buckets), empty and all-masked targets, parked queries."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    hold_moments(grid, qg, tq, tg._f32(cell * cell))


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([1, 5, 16, 40, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 140), nq=st.integers(2, 50), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans(),
       n_sigma=st.sampled_from([1, 6, 64]))
def test_smooth_model_keeps_the_sweeps_members(seed, dims, cap, cell, n, nq, dup, masked,
                                               tall, n_sigma):
    """J's culled schedule adds each query's members in candidate order:
    the sweep's member lists exactly, smooth_ref within SCALE_SPACE_RTOL at
    1, 6 and 64 sigmas, the unanswered rows 0."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    vals = (np.random.default_rng(seed).random(len(p)) * 255.0).astype(np.float32)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    hold_smooth(grid, qg, tq, torch.from_numpy(vals), sigmas_for(cell, n_sigma),
                tg._f32(cell * cell))


@pytest.mark.parametrize("cap", [136, 160, 200, 256])
def test_models_hold_a_bucket_full_at_a_cap_above_128(cap):
    """H's and J's models keep the sweep's members where one bucket is full
    at a cap above 128 (300 points in one cell: five to eight tiles, the
    last partial at 136 and 200, points dropped) and most buckets are
    empty."""
    p, mask, q = crowded_case(300)
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), cap)
    assert int(grid.count.max()) == cap and int(grid.overflow) > 0
    assert int((grid.count == 0).sum()) > 32
    r2 = tg._f32(0.25)
    hold_moments(grid, qg, tq, r2)
    vals = torch.from_numpy((np.arange(len(p)) % 97).astype(np.float32))
    hold_smooth(grid, qg, tq, vals, sigmas_for(0.5), r2)


def seeded_cloud():
    """tests/test_torch_grid_kernels.py's cloud: 3,000 points in a 4 m cube,
    10% masked and parked at FAR, 500 queries, values in [0, 255)."""
    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    vals = (rng.random(3000) * 255.0).astype(np.float32)
    return p, mask, q, vals


def test_models_match_the_jax_package():
    """H's model against mapmerge_tpu's grid_neighbor_moments (counts
    exactly, mean and covariance within FLOAT_TOL) and J's against its
    grid_gaussian_smooth (within SCALE_SPACE_RTOL of the field) on one
    seeded cloud, as tests/test_torch_grid_kernels.py and
    tests/test_torch_grid_sift_kernels.py hold the plain versions; the
    schedule compares fewer pairs than the sweep visits."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, vals = seeded_cloud()
    cell, cap = 0.35, 32
    grid, qg, tq = _grids(p, mask, q, None, cell, None, cap)
    r2 = tg._f32(cell * cell)
    got, _, counts = radius_model(grid, qg, tq, r2)
    jc, jm, jcov, _ = jg.grid_neighbor_moments(
        jnp.asarray(q), jnp.asarray(p), cell, p_mask=jnp.asarray(mask), tile=16, scan_cap=cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jc))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jm), **FLOAT_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jcov), **FLOAT_TOL)
    assert (got[0] > 0).any()
    visited = sum(len(c) for c in sweep_members(grid, qg, np.inf, True).values())
    assert 0 < counts["pairs_compared"] < visited

    sigmas = sigmas_for(cell)
    r_bound = 3.0 * max(sigmas)
    grid, qg, tq = _grids(p, mask, q, None, r_bound, None, cap)
    (field,), _, _ = radius_model(grid, qg, tq, tg._f32(r_bound * r_bound),
                                  torch.from_numpy(vals), sigmas)
    want, _ = jg.grid_gaussian_smooth(jnp.asarray(q), jnp.asarray(p), jnp.asarray(vals),
                                      sigmas, p_mask=jnp.asarray(mask), tile=16, scan_cap=cap)
    assert field_error(field, torch.tensor(np.asarray(want))) <= ksift.SCALE_SPACE_RTOL
    assert bool((field != 0).any())


# ---- the wrappers' card path ----


class _Outputs(TorchDispatchMode):
    """The (op, shape, dtype) of every tensor an op makes while active."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.made.append((str(func), tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("entry", ["moments", "smooth", "count"])
def test_card_path_launches_the_pre_pass_with_the_kernel(card_path, entry):
    """On the card's path a call of moments, smooth or count is one C call
    that launches the pre-pass and the kernel, both counted once (the
    kernel's name and "grid_pack"), with the boxes and units buffers and no
    counters; smooth passes the values as given, no (h, cap) plane of
    values (no gather, no tensor of that shape is made); a failed launch
    raises under the kernel's name."""
    fn = {"moments": "mm_grid_moments", "smooth": "mm_grid_smooth",
          "count": "mm_grid_count"}[entry]
    kernel = {"moments": kgrid.MOMENTS_KERNEL, "smooth": kgrid.SMOOTH_KERNEL,
              "count": kgrid.COUNT_KERNEL}[entry]
    seen = []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: seen.append(args) or 0}))
    grid, qg, q = _meta_grid(), _meta_grid(), torch.empty((64, 3), device="meta")
    vals = torch.empty((100,), device="meta")

    def call():
        if entry == "moments":
            return kgrid.moments(grid, qg, q, 0.25)
        if entry == "count":
            return kgrid.count(grid, qg, q, 0.25)
        return kgrid.smooth(grid, qg, q, vals, [0.1] * 6, 0.25)

    before = (kernel.launches, kgrid.PACK_KERNEL.launches)
    with _Outputs() as outputs:
        call()
    assert (kernel.launches, kgrid.PACK_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert len(seen) == 1
    args = seen[0]
    assert args[-3:-1] == (None, 0)  # no counters
    made = {shape for _, shape, _ in outputs.made}
    assert (8, 2, 4) in made and (kgrid.units_max(64, 8),) in made  # boxes, units
    assert (8, 4) not in made and not any("index" in op for op, _, _ in outputs.made)
    if entry == "smooth":
        assert args[3] == vals.data_ptr() and len(args) == 23
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: 700}))
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed"):
        call()


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_radius_case(case):
    """(grid, qg, q, vals, cell) on the CPU: duplicated lattice points over
    a tall wrapped grid, a bucket full at a cap of 160 among empty ones, the
    seeded cloud."""
    if case == "crowded":
        p, mask, q = crowded_case()
        vals = (np.arange(len(p)) % 97).astype(np.float32)
        cell, dims, cap = 0.5, (4, 4, 4), 160
    elif case == "tall lattice ties":
        p, mask, q = select_case(7, 3000, 600, 0.3, 0.2, True)
        vals = (np.random.default_rng(7).random(len(p)) * 255.0).astype(np.float32)
        cell, dims, cap = 0.375, (8, 4, 4), 256
    else:
        p, mask, q, vals = seeded_cloud()
        cell, dims, cap = 0.35, None, 128
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    return grid, qg, tq, torch.from_numpy(vals), cell


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crowded", "tall lattice ties", "seeded cloud"])
def test_radius_kernels_follow_the_model(cuda, case):
    """Kernel H bit for bit the model (the sweep's float32 order) with
    moments_ref's counts, J within SCALE_SPACE_RTOL of smooth_ref at 1, 6
    and 64 sigmas, both repeating; each kernel's counters equal the model's
    (the same tiles culled, the same pairs compared, every member added)."""
    grid, qg, q, vals, cell = card_radius_case(case)
    r2 = tg._f32(cell * cell)
    model, _, counts = radius_model(grid, qg, q, r2)
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda))
    got = [a.cpu() for a in kgrid.moments(*on_card, r2)]
    again = [a.cpu() for a in kgrid.moments(*on_card, r2)]
    for a, b, c in zip(got, again, model):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got[0], kgrid.moments_ref(grid, qg, q, r2)[0])
    card = kgrid.select_counters("grid_moments", *on_card, r2)
    assert {k: card[k] for k in counts} == counts
    for n_sigma in (1, 6, 64):
        sigmas = sigmas_for(cell, n_sigma)
        want = kgrid.smooth_ref(grid, qg, q, vals, sigmas, r2)
        field = kgrid.smooth(*on_card, vals.to(cuda), sigmas, r2).cpu()
        assert torch.equal(field, kgrid.smooth(*on_card, vals.to(cuda), sigmas, r2).cpu())
        assert field_error(field, want) <= ksift.SCALE_SPACE_RTOL
        groups = -(-n_sigma // kgrid.SIGMA_GROUP)
        card = kgrid.select_counters("grid_smooth", *on_card, vals.to(cuda), sigmas, r2)
        assert {k: card[k] for k in counts} == {k: v * groups for k, v in counts.items()}
