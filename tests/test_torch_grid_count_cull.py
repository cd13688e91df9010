"""The grid radius count of mapmerge_torch, kernel I (kernels/grid.py
`count`), as csrc/grid.cu schedules it: the pre-pass of G-K
(kernels/grid.pack_ref: the box of every run of 32 slots of each target
bucket, and units of up to 32 answered slots of one query bucket, a lane a
query); a unit walks the tiles of its bucket's distinct neighbours, skips
a tile whose box lies beyond r2 of the box of its queries, and on each tile
it visits each lane bounds its own query against the tile's box
(box_bound): beyond r2 the query takes nothing there; within, it
straddles the radius, and its members there are counted either by a warp
step for it with the lanes on the tile's slots or, where the tile's
straddling queries are many against its filled slots, by its own lane
looping over the slots. A count is an integer, exact in any order, so the
culling leaves each query count_ref's count.

Here: a numpy float32 model of that schedule (`count_model`) held under
hypothesis bit for bit against count_ref, with its counters (tiles
visited, straddling pairs, warp steps, tiles counted a lane a query,
units, answered, members), on wrapped grids (axes of 1 and 2 cells), caps
of 32-256, masked targets, queries parked at FAR, include_self both ways
and empty buckets; points exactly at the radius from their queries and
one float32 step either side of it in one coordinate; a point with a NaN
coordinate; the model against the JAX package's grid_radius_count on a
seeded cloud;
the wrapper's card path (the meta device stands in for the card: one C
call, the pre-pass counted as "grid_pack" with it, the counters' buffer).

The `cuda` cases hold I bit for bit against count_ref and repeating, its
counters equal to the model's, and a units buffer reused by back-to-back
pre-passes (the pre-pass zeroes nothing before it: its tickets return to 0
at the end of each launch); they skip here. On a machine with a GPU:
`python -m pytest tests/test_torch_grid_count_cull.py -m cuda --noconftest`.
"""

import itertools
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.ops import grid as tg

from test_torch_grid_kernels import (  # noqa: F401 (card_path: a fixture)
    _grids, _meta_grid, _to, card_path, neighbours,
)
from test_torch_grid_radius_cull import seeded_cloud
from test_torch_grid_select import box_bound, boxes_bound, crowded_case, select_case, sq_dist
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = kgrid.TILE
#: dims of 1 and 2 cells on an axis (neighbours wrap and repeat) and larger
DIMS = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (1, 2, 2), (4, 2, 1), (4, 4, 4), (8, 4, 4)]
COUNTERS = ("pairs_compared", "tiles_visited", "units", "answered", "members",
            "straddling", "steps", "looped")


def count_model(grid, qg, q, r2: float, include_self: bool = True):
    """csrc/grid.cu's I, a unit at a time over pack_ref's list, in numpy
    float32: (kernels/grid.count's output, the counters of
    kernels/grid.select_counters("grid_count"))."""
    boxes, units = (a.numpy() for a in kgrid.pack_ref(grid, qg, q))
    t_xyz, t_count = grid.cell_xyz.numpy(), grid.count.numpy()
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    h, cap = q_ok.shape
    n_tiles, gmax = -(-cap // TILE), -(-cap // 32)
    r2 = np.float32(r2)
    sub = 0 if include_self else 1
    out = np.full(q.shape[0], -sub, np.int32)
    counts = dict.fromkeys(COUNTERS, 0)
    for code in units[1 : units[0] + 1]:
        b, group = divmod(int(code), gmax)
        slots = np.flatnonzero(q_ok[b])[group * 32 : (group + 1) * 32]
        counts["units"] += 1
        counts["answered"] += len(slots)
        if not len(slots):
            continue
        qs = q_xyz[b, slots]
        qlo, qhi = qs.min(axis=0), qs.max(axis=0)
        found = np.zeros(len(slots), np.int64)
        for nb in neighbours(b, grid.dims):
            c = min(int(t_count[nb]), cap)
            for t in range(-(-c // TILE)):
                lo, hi = boxes[nb * n_tiles + t, 0, :3], boxes[nb * n_tiles + t, 1, :3]
                if not boxes_bound(qlo, qhi, lo, hi) <= r2:
                    continue  # beyond the radius of the queries' box: not issued
                pts = t_xyz[nb, t * TILE : min(c, (t + 1) * TILE)]
                straddle = [s for s, qv in enumerate(qs) if box_bound(qv, lo, hi) <= r2]
                for s in straddle:
                    found[s] += int((sq_dist(qs[s], pts) <= r2).sum())
                k = len(straddle)
                loop = k * 10 > len(pts) * kgrid.LOOP_TENTHS
                counts["tiles_visited"] += 1
                counts["straddling"] += k
                counts["pairs_compared"] += k * len(pts)
                counts["steps"] += 1 + (0 if k == 0 else (len(pts) if loop else k))
                counts["looped"] += k > 0 and loop
        out[q_idx[b, slots]] = found - sub
        counts["members"] += int(found.sum())
    return torch.from_numpy(out), counts


def visited_pairs(grid, qg) -> int:
    """The (query, candidate) pairs of the one-thread-a-slot sweep: every
    answered slot against every filled slot of its distinct neighbours."""
    t_count, q_ok = grid.count.numpy(), qg.cell_ok.numpy()
    cap = q_ok.shape[1]
    return sum(int(q_ok[b].sum()) * sum(min(int(t_count[i]), cap)
                                        for i in neighbours(int(b), grid.dims))
               for b in np.flatnonzero(q_ok.any(axis=1)))


def hold_count(grid, qg, tq, r2, include_self=True):
    """The model equals count_ref bit for bit; its counters are consistent:
    members the counts' sum, a step a tile at least, no more pairs compared
    than the sweep visits. Returns the counters."""
    got, counts = count_model(grid, qg, tq, r2, include_self)
    want = kgrid.count_ref(grid, qg, tq, r2, include_self)
    assert torch.equal(got, want)
    sub = 0 if include_self else 1
    answered = qg.cell_idx[qg.cell_ok]
    assert counts["answered"] == int(qg.cell_ok.sum())
    assert counts["members"] == int((want[answered].long() + sub).sum())
    assert counts["steps"] >= counts["tiles_visited"] + (counts["straddling"] > 0)
    assert counts["pairs_compared"] <= visited_pairs(grid, qg)
    return counts


def sphere_offsets(r: float) -> np.ndarray:
    """(m, 3) float32 offsets of length exactly r: r on each axis, both
    signs, and where r is 5 / 2^k the 3-4-5 triangle (3 r / 5, 4 r / 5, 0)
    in every axis order and sign; every square and sum of these is exact
    in float32."""
    legs = [(r, 0.0, 0.0)]
    if r in (0.3125, 0.625):
        legs.append((r * 3 / 5, r * 4 / 5, 0.0))
    out = {tuple(float(leg[i] * sg) for i, sg in zip(perm, signs))
           for leg in legs for perm in itertools.permutations(range(3))
           for signs in itertools.product((1, -1), repeat=3)}
    return np.array(sorted(out), np.float32)


def on_the_sphere(p, q, r: float, seed: int, share: float = 0.4):
    """q with a share of its rows moved to exactly r from a point of p
    (p on a lattice of 1/8 m: the sums are exact), and half of those moved
    one float32 step in one coordinate, inwards or outwards."""
    rng = np.random.default_rng(seed)
    q = q.copy()
    rows = np.flatnonzero(rng.random(len(q)) < share)
    offsets = sphere_offsets(r)
    q[rows] = p[rng.integers(0, len(p), len(rows))] + offsets[rng.integers(0, len(offsets),
                                                                            len(rows))]
    nudged = rows[rng.random(len(rows)) < 0.5]
    axis = rng.integers(0, 3, len(nudged))
    away = np.where(rng.random(len(nudged)) < 0.5, -FAR, FAR).astype(np.float32)
    q[nudged, axis] = np.nextafter(q[nudged, axis], away)
    return q.astype(np.float32)


#: radii: lattice multiples and two of the form 5 / 2^k (3-4-5 offsets)
CELLS = [0.25, 0.3125, 0.5, 0.625]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([32, 40, 64, 128, 160, 256]), cell=st.sampled_from(CELLS),
       n=st.integers(1, 160), nq=st.integers(2, 60), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans(),
       include_self=st.booleans(), sphere=st.booleans())
def test_count_model_equals_count_ref(seed, dims, cap, cell, n, nq, dup, masked, tall,
                                      include_self, sphere):
    """I's schedule counts each query's members exactly: count_ref bit for
    bit on wrapped dims, caps of 32-256, duplicated lattice points (ties
    within and across buckets), empty and all-masked targets, queries parked
    at FAR, include_self both ways, and queries exactly at the radius from
    points and a float32 step either side of it."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    if sphere:
        q = on_the_sphere(p, q, cell, seed)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    hold_count(grid, qg, tq, tg._f32(cell * cell), include_self)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("include_self", [True, False])
def test_count_model_on_the_sphere(cell, include_self):
    """Points at exactly the radius from their queries are members (d2 ==
    r2 in float32), a step further out in one coordinate may not be: the
    model keeps count_ref's count for each, on a lattice whose every query
    sits on or beside the sphere of some point."""
    p, mask, q = select_case(11, 400, 200, 0.2, 0.0, False)
    q = on_the_sphere(p, q, cell, 11, share=1.0)
    grid, qg, tq = _grids(p, mask, q, None, cell, (4, 4, 4), 64)
    r2 = tg._f32(cell * cell)
    d2 = ((tq[:, None, :] - torch.from_numpy(p)[None, :, :]) ** 2).sum(-1)
    assert bool((d2 == r2).any())  # exact pairs at the radius are exercised
    hold_count(grid, qg, tq, r2, include_self)


@pytest.mark.parametrize("cap", [136, 160, 200, 256])
def test_count_model_holds_a_bucket_full_at_a_cap_above_128(cap):
    """The model keeps count_ref's counts where one bucket is full at a cap
    above 128 (300 points in one cell: five to eight tiles, the last partial
    at 136 and 200, points dropped) and most buckets are empty; the crowd's
    tiles are counted a lane a query, the sparse neighbours' by steps."""
    p, mask, q = crowded_case(300)
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), cap)
    assert int(grid.count.max()) == cap and int(grid.overflow) > 0
    assert int((grid.count == 0).sum()) > 32
    counts = hold_count(grid, qg, tq, tg._f32(0.25), include_self=False)
    assert 0 < counts["looped"] < counts["tiles_visited"]


@pytest.mark.parametrize("include_self", [True, False])
def test_count_model_counts_no_nan_point(include_self):
    """A point with a NaN coordinate (valid in the mask, so build_grid
    keeps it) lies within no radius: count_ref counts it nowhere, the
    boxes leave its coordinate out, and the model keeps count_ref's counts
    where the point's tile is full of members of the queries around it."""
    p, mask, q = crowded_case(300)
    p = np.concatenate([p, np.array([[0.125, np.nan, 0.25], [np.nan] * 3], np.float32)])
    mask = np.ones(len(p), bool)
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), 512)
    assert int(grid.cell_xyz[grid.cell_ok].isnan().any(dim=1).sum()) == 2
    assert not bool(kgrid.boxes_ref(grid)[:, :, :3].isnan().any())
    counts = hold_count(grid, qg, tq, tg._f32(0.25), include_self)
    assert counts["straddling"] > 0


@pytest.mark.parametrize("include_self", [True, False])
def test_count_model_matches_the_jax_package(include_self):
    """The model against mapmerge_tpu's grid_radius_count on a seeded cloud
    (3,000 points in a 4 m cube, 10% masked and parked at FAR, 500
    queries; radius 0.35, cap 32): counts and overflow exactly, as
    tests/test_torch_grid_kernels.py holds count_ref; the schedule compares
    fewer pairs than the sweep visits."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, q, _ = seeded_cloud()
    cell, cap = 0.35, 32
    grid, qg, tq = _grids(p, mask, q, None, cell, None, cap)
    got, counts = count_model(grid, qg, tq, tg._f32(cell * cell), include_self)
    want, over = jg.grid_radius_count(jnp.asarray(q), jnp.asarray(p), cell,
                                      p_mask=jnp.asarray(mask), tile=16,
                                      include_self=include_self, scan_cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(qg.overflow) == int(over)
    assert bool((got > 0).any())
    assert 0 < counts["pairs_compared"] < visited_pairs(grid, qg)


# ---- the wrapper's card path ----


def test_card_path_passes_the_pre_pass_buffers_and_counters(card_path):
    """On the card's path count() is one C call of mm_grid_count, counted
    as "grid_count" and "grid_pack", with the boxes and units buffers, the
    subtraction and no counters; select_counters passes a buffer of 8
    counts a warp; a failed launch raises under the kernel's name."""
    seen = []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_grid_count=lambda *args: seen.append(args) or 0))
    grid, q = _meta_grid(), torch.empty((64, 3), device="meta")
    before = (kgrid.COUNT_KERNEL.launches, kgrid.PACK_KERNEL.launches)
    out = kgrid.count(grid, _meta_grid(), q, 0.25, include_self=False)
    assert (kgrid.COUNT_KERNEL.launches, kgrid.PACK_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == (64,) and out.dtype == torch.int32 and len(seen) == 1
    args = seen[0]
    assert len(args) == 20 and args[12] == 1  # sub
    assert args[15] == kgrid.units_max(64, 8) - 1  # the units' capacity
    assert args[-3:-1] == (None, 0)  # no counters
    counters = torch.empty((8 * 4 * 5,), dtype=torch.int64, device="meta")
    kgrid._radius(kgrid.COUNT_KERNEL, grid, _meta_grid(), q, 0.25, counters=counters)
    assert seen[-1][-3:-1] == (counters.data_ptr(), 8 * 4 * 5)
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_grid_count=lambda *args: 700))
    with pytest.raises(RuntimeError, match="grid_count: CUDA launch failed"):
        kgrid.count(grid, _meta_grid(), q, 0.25)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_count_case(case):
    """(grid, qg, q, cell) on the CPU: a bucket full at a cap of 160 among
    empty ones, duplicated lattice points over a tall wrapped grid, the
    seeded cloud, queries on and beside the sphere of a point, a crowd
    with a point whose coordinate is NaN."""
    if case == "crowded":
        p, mask, q = crowded_case()
        cell, dims, cap = 0.5, (4, 4, 4), 160
    elif case == "tall lattice ties":
        p, mask, q = select_case(7, 3000, 600, 0.3, 0.2, True)
        cell, dims, cap = 0.375, (8, 4, 4), 256
    elif case == "a NaN point":
        p, mask, q = crowded_case(300)
        p = np.concatenate([p, np.array([[0.125, np.nan, 0.25]], np.float32)])
        mask = np.ones(len(p), bool)
        cell, dims, cap = 0.5, (4, 4, 4), 512
    elif case == "on the sphere":
        p, mask, q = select_case(9, 3000, 900, 0.2, 0.1, False)
        q = on_the_sphere(p, q, 0.625, 9, share=0.8)
        cell, dims, cap = 0.625, (2, 4, 4), 128
    else:
        p, mask, q, _ = seeded_cloud()
        cell, dims, cap = 0.35, None, 128
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    return grid, qg, tq, cell


CARD_CASES = ["crowded", "tall lattice ties", "on the sphere", "a NaN point", "seeded cloud"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("include_self", [True, False])
def test_count_kernel_equals_count_ref_and_repeats(cuda, case, include_self):
    """Kernel I bit for bit count_ref, and again on a second call; one
    launch of I and one of the pre-pass a call."""
    grid, qg, q, cell = card_count_case(case)
    r2 = tg._f32(cell * cell)
    want = kgrid.count_ref(grid, qg, q, r2, include_self)
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda))
    before = (kgrid.COUNT_KERNEL.launches, kgrid.PACK_KERNEL.launches)
    got = kgrid.count(*on_card, r2, include_self).cpu()
    assert (kgrid.COUNT_KERNEL.launches, kgrid.PACK_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(kgrid.count(*on_card, r2, include_self).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_count_kernel_counters_equal_the_model(cuda, case):
    """Kernel I's counters (pairs compared, tiles visited, units, answered,
    members, straddling pairs, warp steps, tiles counted a lane a query)
    equal the model's: the same tiles culled, the same queries straddling,
    the same way of counting each tile."""
    grid, qg, q, cell = card_count_case(case)
    r2 = tg._f32(cell * cell)
    _, counts = count_model(grid, qg, q, r2, False)
    card = kgrid.select_counters("grid_count", _to(grid, cuda), _to(qg, cuda), q.to(cuda),
                                 r2, False)
    assert {k: card[k] for k in COUNTERS} == counts


@pytest.mark.cuda
def test_a_reused_units_buffer_gives_the_same_counts(cuda):
    """mm_grid_count called back to back with one units buffer (filled with
    junk first, then holding the last call's list), on two query grids of
    one target: each call count_ref's counts, and the list pack_ref's
    (as a set: its runs are placed in atomic order), its length first: the
    pre-pass zeroes nothing before it."""
    grid, qg, q, cell = card_count_case("tall lattice ties")
    r2 = tg._f32(cell * cell)
    other = q.flip(0)[: q.shape[0] // 2].contiguous()
    qg2 = tg.build_grid(other, None, grid.cell_size, grid.dims, grid.cap)
    dims = (grid.cell_idx.shape[0], grid.cap, *grid.dims)
    nq = q.shape[0]
    units = torch.full((kgrid.units_max(nq, dims[0]),), 987654, dtype=torch.int32, device=cuda)
    boxes = kgrid._empty_boxes(grid, cuda)
    g = _to(grid, cuda)
    lib = build.load()
    for query_grid, queries in ((qg, q), (qg2, other), (qg, q)):
        qc = _to(query_grid, cuda)
        out = torch.full((queries.shape[0],), -1, dtype=torch.int32, device=cuda)
        err = lib.mm_grid_count(
            g.cell_xyz.data_ptr(), g.count.data_ptr(), qc.cell_xyz.data_ptr(),
            qc.cell_idx.data_ptr(), qc.cell_ok.data_ptr(), qc.count.data_ptr(), *dims, r2, 1,
            boxes.data_ptr(), units.data_ptr(), units.numel() - 1, out.data_ptr(), None, 0,
            build.stream_handle(units.device))
        assert err == 0
        assert torch.equal(out.cpu(), kgrid.count_ref(grid, query_grid, queries, r2, False))
        want = kgrid.pack_ref(grid, query_grid, queries)[1]
        n = int(want[0])
        got = units.cpu()
        assert int(got[0]) == n
        assert torch.equal(got[1 : n + 1].sort().values, want[1 : n + 1].sort().values)
