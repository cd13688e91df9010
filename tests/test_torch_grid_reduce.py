"""The grid radius reduce of mapmerge_torch, kernel L (kernels/grid.py
`reduce` and `reduce_list`, csrc/grid.cu), behind Harris's response,
suppression and corner refinement on the grid engine.

The sweep route (more than SMALL_Q_THRESHOLD queries) runs on the pre-pass
of G-K (kernels/grid.pack_ref: the box of every run of 32 slots of each
target bucket, and units of up to 32 answered slots of one query bucket, a
lane a query): a unit walks the tiles of its bucket's distinct neighbours
in candidate order (ascending neighbour id, then tile), skips a tile whose
box lies beyond r2 of the box of its queries, and on each tile it visits
every lane whose own box bound is within r2 adds its members' values in
slot order (the sum, each channel on its own); the max runs on kernel I's
schedule (order-free: its counters are I's, `count_model`'s). The list
route (at most SMALL_Q_THRESHOLD queries, each answered) is a warp a query:
lane l takes the filled slots l, l + 32, ... of each distinct neighbour in
turn, skipping a tile of 32 slots whose box lies beyond r2 of the query,
and the lanes' parts meet in a fixed butterfly (xor 16, 8, 4, 2, 1). Both
are built for 1, 6 and 9 channels (REDUCE_WIDTHS) and for any C up to 16.

Here: numpy float32 models of both routes (`sweep_model`, `list_model`),
held under hypothesis (1-2-cell dims, caps of 32-256, masked targets,
parked queries, queries exactly at the radius and a float32 step either
side, a masked subset of the query grid's slots, 1, 6, 9 and 12 channels,
sum and max): the count and the max bit for bit the plain versions
(reduce_ref, reduce_list_ref), the sum within REDUCE_RTOL of the members'
sum of |v|, and each model's culled schedule bit for bit the same adds in
candidate order unculled; the plain versions against the JAX package's
grid_radius_reduce on both branches; the wrappers' card path (the meta
device stands in for the card: one C call, the sweep route's pre-pass
counted as "grid_pack" with it, the list route's only where it is given no
boxes, no gather of the values into the grid's layout, the counters'
buffer, a raise on an unsupported channel count or a failed launch).

The `cuda` cases hold both routes at each width bit for bit against the
models (sum) or the plain versions (count, max), repeating, and the sweep
route's counters equal to the model's (the max's to count_model's); they
skip here. On a machine with a GPU: `python -m pytest
tests/test_torch_grid_reduce.py -m cuda --noconftest`.
"""

import math
import signal
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core import grid as cgrid
from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.ops import grid as tg

from test_torch_grid_count_cull import (
    CARD_CASES, CELLS, card_count_case, count_model, on_the_sphere,
)
from test_torch_grid_kernels import (  # noqa: F401 (card_path: a fixture)
    _grids, _meta_grid, _to, card_path, neighbours,
)
from test_torch_grid_radius_cull import seeded_cloud
from test_torch_grid_select import DIMS, box_bound, boxes_bound, crowded_case, select_case, sq_dist
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = kgrid.TILE
BIG = np.float32(cgrid.BIG)
COUNTERS = ("pairs_compared", "tiles_visited", "units", "answered", "members")
#: seconds a test of this module may take here (six test processes share
#: the host)
TIME_LIMIT_S = 240


@pytest.fixture(autouse=True)
def time_limit():
    """Fail a test that runs past TIME_LIMIT_S."""
    def expired(signum, frame):
        raise TimeoutError(f"past this module's limit of {TIME_LIMIT_S} s")

    before = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, before)


# ---- the numpy models of the two routes ----


def nan_max(a, b):
    """The larger of a and b, NaN where either is NaN: amax's rule, which
    csrc/grid.cu's nan_max keeps with max.NaN.f32 (the values agree; a
    zero's sign may not)."""
    return np.where((a > b) | np.isnan(a), a, b).astype(np.float32)


def _combine(op: str):
    return nan_max if op == "max" else (lambda a, b: (a + b).astype(np.float32))


def _start(op: str, c: int):
    return np.full(c, -np.inf if op == "max" else 0.0, np.float32)


def _finish(acc, found: int, candidates: int, op: str):
    """The max of a query with fewer members than candidate positions
    meets a non-member's -BIG, as the plain version's where() gives it."""
    return nan_max(acc, np.full_like(acc, -BIG)) if op == "max" and found < candidates else acc


def sweep_model(grid, qg, q, values, r2: float, op: str, cull: bool = True):
    """csrc/grid.cu's L on its sweep route, a lane a query, in numpy float32,
    unit by unit of pack_ref's list: (count, out, counters). Each member's
    values meet the lane's accumulators in candidate order, one rounding an
    add; `cull` False visits every tile (the same adds, unculled)."""
    boxes, units = (a.numpy() for a in kgrid.pack_ref(grid, qg, q))
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    vals = values.numpy()
    h, cap = t_idx.shape
    n_tiles, gmax = -(-cap // TILE), -(-cap // 32)
    r2 = np.float32(r2)
    c = vals.shape[1]
    combine = _combine(op)
    count = np.zeros(q.shape[0], np.int32)
    out = np.full((q.shape[0], c), 0.0 if op == "sum" else -BIG, np.float32)
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
        acc = [_start(op, c) for _ in slots]
        found = [0] * len(slots)
        for nb in neighbours(b, grid.dims):  # candidate order
            filled = min(int(t_count[nb]), cap)
            for t in range(-(-filled // TILE)):
                lo, hi = boxes[nb * n_tiles + t, 0, :3], boxes[nb * n_tiles + t, 1, :3]
                if cull and not boxes_bound(qlo, qhi, lo, hi) <= r2:
                    continue  # beyond the radius of the queries' box: not issued
                reach = [not cull or bool(box_bound(qv, lo, hi) <= r2) for qv in qs]
                if not any(reach):
                    continue
                first = t * TILE
                pts = t_xyz[nb, first : min(filled, first + TILE)]
                counts["tiles_visited"] += 1
                counts["pairs_compared"] += sum(reach) * len(pts)
                for s, qv in enumerate(qs):
                    if not reach[s]:
                        continue
                    for j in np.flatnonzero(sq_dist(qv, pts) <= r2):
                        found[s] += 1
                        acc[s] = combine(acc[s], vals[t_idx[nb, first + j]])
        for s, slot in enumerate(slots):
            row = q_idx[b, slot]
            count[row] = found[s]
            out[row] = _finish(acc[s], found[s], 27 * cap, op)
            counts["members"] += found[s]
    return torch.from_numpy(count), torch.from_numpy(out), counts


def list_model(grid, q, values, r2: float, op: str, cull: bool = True):
    """csrc/grid.cu's L on its list route in numpy float32, a query at a
    time: (count, out). Lane l adds (or maxes) the members among the filled
    slots l, l + 32, ... of each distinct neighbour of the query's bucket
    in turn, a tile of 32 slots skipped where its box (boxes_ref) lies
    beyond r2 of the query (`cull` False: none skipped, the same adds);
    then at each step of the butterfly (o = 16, 8, 4, 2, 1) lane l meets
    lane l ^ o; lane 0's result is the row's."""
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    boxes = kgrid.boxes_ref(grid).numpy()
    vals = values.numpy()
    cap = t_idx.shape[1]
    n_tiles = -(-cap // TILE)
    r2 = np.float32(r2)
    c = vals.shape[1]
    combine = _combine(op)
    buckets = cgrid._bucket_of(cgrid._cells(q, grid.cell_size), grid.dims).numpy()
    qn = q.numpy()
    count = np.zeros(q.shape[0], np.int32)
    out = np.zeros((q.shape[0], c), np.float32)
    for i, b in enumerate(buckets):
        acc = [_start(op, c) for _ in range(32)]
        found = [0] * 32
        for nb in neighbours(int(b), grid.dims):
            filled = min(int(t_count[nb]), cap)
            for t in range(-(-filled // TILE)):
                lo, hi = boxes[nb * n_tiles + t, 0, :3], boxes[nb * n_tiles + t, 1, :3]
                if cull and not box_bound(qn[i], lo, hi) <= r2:
                    continue  # no member of this query in the tile
                first = t * TILE
                pts = t_xyz[nb, first : min(filled, first + TILE)]
                for j in np.flatnonzero(sq_dist(qn[i], pts) <= r2):
                    found[j] += 1
                    acc[j] = combine(acc[j], vals[t_idx[nb, first + j]])
        for o in (16, 8, 4, 2, 1):
            acc = [combine(acc[lane], acc[lane ^ o]) for lane in range(32)]
            found = [found[lane] + found[lane ^ o] for lane in range(32)]
        count[i] = found[0]
        out[i] = _finish(acc[0], found[0], 27 * cap, op)
    return torch.from_numpy(count), torch.from_numpy(out)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where NaN (a zero's sign aside)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def hold(got, want, scale, op: str) -> float:
    """The count exactly; the max bit for bit; the sum within REDUCE_RTOL of
    the members' sum of |v|. Returns the sum's error."""
    assert torch.equal(got[0], want[0])
    if op == "max":
        assert same_bits(got[1], want[1])
        return 0.0
    err = kgrid.reduce_error(got[1], want[1], scale)
    assert err <= kgrid.REDUCE_RTOL, err
    return err


def make_values(seed: int, n: int, c: int, ties: bool = False) -> torch.Tensor:
    """(n, c) float32 values of both signs from a seed; with `ties` on a
    coarse lattice, so maxes tie across members."""
    v = np.random.default_rng(seed + 1).standard_normal((n, c)).astype(np.float32)
    if ties:
        v = np.round(v * 2.0) / 2.0
    return torch.from_numpy(v.astype(np.float32))


def hold_sweep(grid, qg, tq, values, r2, op):
    """The sweep model against reduce_ref, and its culled schedule bit for
    bit its unculled adds. Returns the model's (count, out) and the
    kernel's counters as the models give them: the sum's the sweep
    model's, the max's count_model's (I's schedule, whose members are the
    count's)."""
    count, out, counts = sweep_model(grid, qg, tq, values, r2, op)
    want = kgrid.reduce_ref(grid, qg, tq, values, r2, op)
    scale = kgrid.reduce_ref(grid, qg, tq, values.abs(), r2, "sum")[1]
    hold((count, out), want, scale, op)
    full = sweep_model(grid, qg, tq, values, r2, op, cull=False)
    assert torch.equal(full[0], count) and same_bits(full[1], out)
    assert counts["members"] == int(want[0].long().sum())
    if op == "max":
        counted, counts = count_model(grid, qg, tq, r2)
        assert torch.equal(counted, count)
    return count, out, counts


def hold_list(grid, tq, values, r2, op):
    """The list model against reduce_list_ref, its culled tiles the
    unculled adds' bits."""
    got = list_model(grid, tq, values, r2, op)
    want = kgrid.reduce_list_ref(grid, tq, values, r2, op)
    scale = kgrid.reduce_list_ref(grid, tq, values.abs(), r2, "sum")[1]
    hold(got, want, scale, op)
    full = list_model(grid, tq, values, r2, op, cull=False)
    assert torch.equal(full[0], got[0]) and same_bits(full[1], got[1])


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([32, 40, 64, 128, 256]), cell=st.sampled_from(CELLS),
       n=st.integers(1, 140), nq=st.integers(2, 50), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans(), sphere=st.booleans(),
       channels=st.sampled_from([1, 6, 9, 12]), op=st.sampled_from(["sum", "max"]),
       subset=st.sampled_from([0.0, 0.5]))
def test_sweep_model_against_reduce_ref(seed, dims, cap, cell, n, nq, dup, masked, tall,
                                        sphere, channels, op, subset):
    """L's sweep route adds each query's members, and only them, in
    candidate order: reduce_ref's counts and maxes bit for bit, its sums
    within REDUCE_RTOL, the culled schedule the unculled adds' bits; on
    wrapped dims, duplicated lattice points, empty and all-masked targets,
    parked queries, queries exactly at the radius, and a query grid of a
    subset of the slots (masked_query_grid, as Harris's suppression sweeps
    the queries above its threshold)."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    if sphere:
        q = on_the_sphere(p, q, cell, seed)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    if subset:
        keep = np.random.default_rng(seed + 2).random(len(q)) >= subset
        qg = tg.masked_query_grid(qg, torch.from_numpy(keep), len(q))
    values = make_values(seed, len(p), channels, ties=op == "max")
    hold_sweep(grid, qg, tq, values, tg._f32(cell * cell), op)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([32, 40, 64, 128, 256]), cell=st.sampled_from(CELLS),
       n=st.integers(1, 140), nq=st.integers(1, 40), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans(), sphere=st.booleans(),
       channels=st.sampled_from([1, 6, 9, 12]), op=st.sampled_from(["sum", "max"]))
def test_list_model_against_reduce_list_ref(seed, dims, cap, cell, n, nq, dup, masked, tall,
                                            sphere, channels, op):
    """L's list route answers every query: reduce_list_ref's counts and
    maxes bit for bit, its sums within REDUCE_RTOL, on the same inputs; the
    tiles it skips by their boxes change no bit."""
    p, mask, q = select_case(seed, n, max(nq, 2), dup, masked, tall)
    if sphere:
        q = on_the_sphere(p, q, cell, seed)
    grid, _, tq = _grids(p, mask, q[:nq], None, cell, dims, cap)
    values = make_values(seed, len(p), channels, ties=op == "max")
    hold_list(grid, tq, values, tg._f32(cell * cell), op)


@pytest.mark.parametrize("cap", [136, 256])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_models_hold_a_full_bucket_and_a_nan_point(cap, op):
    """Both models where one bucket is full at a cap above 128 (300 points
    in one cell, points dropped) and a point has a NaN coordinate (kept by
    build_grid, a member of no query)."""
    p, mask, q = crowded_case(300)
    p = np.concatenate([p, np.array([[0.125, np.nan, 0.25]], np.float32)])
    mask = np.ones(len(p), bool)
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), cap)
    assert int(grid.count.max()) == cap and int(grid.overflow) > 0
    values = make_values(3, len(p), 9, ties=op == "max")
    r2 = tg._f32(0.25)
    counts = hold_sweep(grid, qg, tq, values, r2, op)[2]
    assert counts["members"] > 0
    hold_list(grid, tq, values, r2, op)


@pytest.mark.parametrize("route", ["sweep", "list"])
def test_max_propagates_a_nan_value_and_keeps_a_value_below_minus_big(route):
    """A member's NaN value makes its query's max NaN, as amax does; a
    member's value below -BIG gives -BIG where the query has a non-member
    candidate (an empty slot), as the plain version's where() does."""
    p, mask, q = select_case(4, 120, 40, 0.0, 0.0, False)
    grid, qg, tq = _grids(p, mask, q, None, 0.375, (4, 4, 4), 32)
    values = make_values(4, len(p), 2)
    values[::7, 0] = float("nan")
    values[:, 1] = -4.0e12
    r2 = tg._f32(0.375 * 0.375)
    if route == "sweep":
        count, got, _ = sweep_model(grid, qg, tq, values, r2, "max")
        want = kgrid.reduce_ref(grid, qg, tq, values, r2, "max")
    else:
        count, got = list_model(grid, tq, values, r2, "max")
        want = kgrid.reduce_list_ref(grid, tq, values, r2, "max")
    assert torch.equal(count, want[0]) and same_bits(got, want[1])
    assert bool(got[:, 0].isnan().any()) and bool((got[:, 1] == -BIG).all())


def test_sum_limit_tells_float32_from_tf32_and_bfloat16():
    """REDUCE_RTOL holds the sweep model's sums and fails the plain version
    with its values rounded to TF32 or bfloat16 first."""
    p, mask, q, _ = seeded_cloud()
    grid, qg, tq = _grids(p, mask, q, None, 0.5, None, 128)
    values = make_values(0, len(p), 9)
    r2 = tg._f32(0.25)
    want = kgrid.reduce_ref(grid, qg, tq, values, r2, "sum")
    scale = kgrid.reduce_ref(grid, qg, tq, values.abs(), r2, "sum")[1]
    _, got, _ = sweep_model(grid, qg, tq, values, r2, "sum")
    assert kgrid.reduce_error(got, want[1], scale) <= kgrid.REDUCE_RTOL
    tf32 = (values.view(torch.int32) + 0x1000 & ~0x1FFF).view(torch.float32)
    for rounded in (tf32, values.to(torch.bfloat16).float()):
        control = kgrid.reduce_ref(grid, qg, tq, rounded, r2, "sum")[1]
        assert kgrid.reduce_error(control, want[1], scale) > kgrid.REDUCE_RTOL


# ---- the plain versions against the JAX package ----


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("branch", ["small-Q", "sweep"])
def test_plain_versions_match_the_jax_package(op, branch):
    """reduce_list_ref (1,000 queries) and reduce_ref (5,000 queries, more
    than SMALL_Q_THRESHOLD), through ops/grid.grid_radius_reduce on the
    CPU, against mapmerge_tpu's grid_radius_reduce on the same seeded cloud
    (3,000 points in a 4 m cube, 10% masked and parked at FAR; radius 0.35,
    cap 32): counts, maxes and the overflow exactly, sums within
    REDUCE_RTOL of the members' sum of |v|."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    p, mask, _, _ = seeded_cloud()
    nq = 1000 if branch == "small-Q" else 5000
    q = (np.random.default_rng(2).random((nq, 3)) * 4.0).astype(np.float32)
    q[::9] = FAR
    values = make_values(2, len(p), 9, ties=op == "max")
    cell, cap = 0.35, 32
    got = tg.grid_radius_reduce(torch.from_numpy(q), torch.from_numpy(p), cell, values,
                                torch.from_numpy(mask), reduce=op, scan_cap=cap)
    want = jg.grid_radius_reduce(jnp.asarray(q), jnp.asarray(p), cell, jnp.asarray(values),
                                 p_mask=jnp.asarray(mask), reduce=op, scan_cap=cap)
    want = [torch.from_numpy(np.array(a)) for a in want]
    scale = tg.grid_radius_reduce(torch.from_numpy(q), torch.from_numpy(p), cell,
                                  values.abs(), torch.from_numpy(mask), scan_cap=cap)[1]
    hold(got[:2], want[:2], scale, op)
    assert int(got[2]) == int(want[2])
    assert bool((got[0] > 0).any())


# ---- the wrappers' card path ----


def test_card_path_passes_the_pre_pass_buffers_and_counters(card_path):
    """On the card's path reduce() is one C call of mm_grid_reduce, counted
    as "grid_reduce" and "grid_pack", with the values as given (no gather
    into the grid's layout), their channels, the max flag, the boxes and
    units buffers and no counters; select_counters passes a buffer of 5
    counts a warp for the sum, of 8 for the max (I's schedule);
    reduce_list() is one call of mm_grid_reduce_list, counted as
    "grid_reduce_list" alone where it is given the target's boxes, with the
    pre-pass's boxes first (mm_grid_pack, "grid_pack") where it is not; an
    unsupported channel count or a failed launch raises under the kernel's
    name."""
    seen, packs = [], []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_grid_reduce=lambda *args: seen.append(args) or 0,
        mm_grid_reduce_list=lambda *args: seen.append(args) or 0,
        mm_grid_pack=lambda *args: packs.append(args) or 0))
    grid, q = _meta_grid(), torch.empty((64, 3), device="meta")
    values = torch.empty((100, 9), device="meta")
    kernels = (kgrid.REDUCE_KERNEL, kgrid.REDUCE_LIST_KERNEL, kgrid.PACK_KERNEL)
    before = [k.launches for k in kernels]
    count, out = kgrid.reduce(grid, _meta_grid(), q, values, 0.25, "max")
    assert [k.launches for k in kernels] == [before[0] + 1, before[1], before[2] + 1]
    assert count.shape == (64,) and count.dtype == torch.int32 and out.shape == (64, 9)
    args = seen[-1]
    assert len(args) == 24 and args[3] == values.data_ptr() and args[4:6] == (9, 1)
    assert args[18] == kgrid.units_max(64, 8) - 1  # the units' capacity
    assert args[-3:-1] == (None, 0)  # no counters
    for op, width in (("sum", 5), ("max", 8)):
        counters = torch.empty((width * 4 * 5,), dtype=torch.int64, device="meta")
        kgrid._radius(kgrid.REDUCE_KERNEL, grid, _meta_grid(), q, 0.25, values,
                      counters=counters, op=op)
        assert seen[-1][-3:-1] == (counters.data_ptr(), width * 4 * 5)
        assert seen[-1][5] == int(op == "max")
    boxes = torch.empty((8, 2, 4), device="meta")
    before = [k.launches for k in kernels]
    count, out = kgrid.reduce_list(grid, q, values, 0.25, "sum", boxes=boxes)
    assert [k.launches for k in kernels] == [before[0], before[1] + 1, before[2]] and not packs
    args = seen[-1]
    assert len(args) == 19 and args[3:9] == (boxes.data_ptr(), values.data_ptr(), 9, 0,
                                             q.data_ptr(), 64)
    assert args[14] == cgrid._f32(1.0 / grid.cell_size) and out.shape == (64, 9)
    kgrid.reduce_list(grid, q, values, 0.25, "sum")
    assert [k.launches for k in kernels] == [before[0], before[1] + 2, before[2] + 1]
    assert len(packs) == 1 and seen[-1][3] is not None
    with pytest.raises(ValueError, match="grid_reduce_list: boxes has shape"):
        kgrid.reduce_list(grid, q, values, 0.25, "sum", boxes=boxes[:4])
    for wide in (torch.empty((100, 17), device="meta"), torch.empty((100, 0), device="meta")):
        with pytest.raises(ValueError, match="grid_reduce: unsupported channel count"):
            kgrid.reduce(grid, _meta_grid(), q, wide, 0.25, "sum")
        with pytest.raises(ValueError, match="grid_reduce_list: unsupported channel count"):
            kgrid.reduce_list(grid, q, wide, 0.25, "sum")
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_grid_reduce=lambda *args: 700, mm_grid_reduce_list=lambda *args: 700))
    with pytest.raises(RuntimeError, match="grid_reduce: CUDA launch failed"):
        kgrid.reduce(grid, _meta_grid(), q, values, 0.25, "sum")
    with pytest.raises(RuntimeError, match="grid_reduce_list: CUDA launch failed"):
        kgrid.reduce_list(grid, q, values, 0.25, "sum", boxes=boxes)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors reduce and reduce_list are reduce_ref and
    reduce_list_ref (no launch counted); an unknown op raises at
    grid_radius_reduce, the one place that checks it."""
    p, mask, q, _ = seeded_cloud()
    grid, qg, tq = _grids(p, mask, q, None, 0.35, None, 32)
    values = make_values(5, len(p), 12)
    r2 = tg._f32(0.35 * 0.35)
    kernels = (kgrid.REDUCE_KERNEL, kgrid.REDUCE_LIST_KERNEL)
    before = [k.launches for k in kernels]
    for op in ("sum", "max"):
        for a, b in zip(kgrid.reduce(grid, qg, tq, values, r2, op),
                        kgrid.reduce_ref(grid, qg, tq, values, r2, op)):
            assert torch.equal(a, b)
        for a, b in zip(kgrid.reduce_list(grid, tq, values, r2, op),
                        kgrid.reduce_list_ref(grid, tq, values, r2, op)):
            assert torch.equal(a, b)
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError, match="unknown reduce: mean"):
        tg.grid_radius_reduce(tq, torch.from_numpy(p), 0.35, values, torch.from_numpy(mask),
                              reduce="mean", scan_cap=32)


def test_reduce_error_never_passes_a_nan_on_one_side():
    """reduce_error is infinite where one side holds a NaN and the other
    does not, or where the two differ over a scale of 0; equal entries, NaN
    on both sides included, agree. A NaN must not compare within
    REDUCE_RTOL, nor hide the error of another row."""
    want = torch.tensor([[1.0, 2.0], [3.0, float("nan")], [float("inf"), 0.0]])
    scale = torch.tensor([[2.0, 4.0], [6.0, 1.0], [1.0, 0.0]])
    assert kgrid.reduce_error(want.clone(), want, scale) == 0.0
    for row, col, bad in ((0, 0, float("nan")), (1, 1, 5.0), (2, 1, 1e-30)):
        got = want.clone()
        got[row, col] = bad
        assert kgrid.reduce_error(got, want, scale) == math.inf
    got = want.clone()
    got[0, 0] = float("nan")
    got[1, 0] += 1.0
    assert not kgrid.reduce_error(got, want, scale) <= kgrid.REDUCE_RTOL
    got[0, 0] = 1.0
    assert kgrid.reduce_error(got, want, scale) == pytest.approx(1.0 / 6.0)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")




@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("channels", [1, 6, 9, 12])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_sweep_route_follows_the_model_and_repeats(cuda, case, channels, op):
    """L's sweep route at each width it is built for (12: the generic
    instantiation): the count and the max bit for bit reduce_ref, the sum
    bit for bit the model (and within REDUCE_RTOL of reduce_ref), a second
    call the same bits; one launch of L and one of the pre-pass; its
    counters equal the model's (the max's count_model's: I's schedule)."""
    grid, qg, q, cell = card_count_case(case)
    r2 = tg._f32(cell * cell)
    values = make_values(channels, grid.cell_idx.numel(), channels, ties=op == "max")
    values = values[: int(grid.cell_idx.max()) + 1].contiguous()
    count, out, counts = hold_sweep(grid, qg, q, values, r2, op)
    on_card = (_to(grid, cuda), _to(qg, cuda), q.to(cuda), values.to(cuda))
    before = (kgrid.REDUCE_KERNEL.launches, kgrid.PACK_KERNEL.launches)
    got = [a.cpu() for a in kgrid.reduce(*on_card, r2, op)]
    assert (kgrid.REDUCE_KERNEL.launches, kgrid.PACK_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    again = [a.cpu() for a in kgrid.reduce(*on_card, r2, op)]
    assert torch.equal(got[0], count) and same_bits(got[1], out)
    assert torch.equal(again[0], got[0]) and same_bits(again[1], got[1])
    want = kgrid.reduce_ref(grid, qg, q, values, r2, op)
    scale = kgrid.reduce_ref(grid, qg, q, values.abs(), r2, "sum")[1]
    hold(got, want, scale, op)
    card = kgrid.select_counters("grid_reduce", *on_card, r2, op)
    assert {k: card[k] for k in counts} == counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("channels", [1, 6, 9, 12])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_list_route_follows_the_model_and_repeats(cuda, case, channels, op):
    """L's list route at each width on the case's first 4,096 queries and
    on its first one: the count and the max bit for bit reduce_list_ref,
    the sum bit for bit the model, a second call the same bits; given the
    target's boxes one launch a call and no pre-pass, given none the
    pre-pass's boxes first, the same bits."""
    grid, _, q, cell = card_count_case(case)
    r2 = tg._f32(cell * cell)
    values = make_values(channels, grid.cell_idx.numel(), channels, ties=op == "max")
    values = values[: int(grid.cell_idx.max()) + 1].contiguous()
    card_grid = _to(grid, cuda)
    boxes = kgrid.boxes(card_grid)
    for tq in (q[:4096].contiguous(), q[:1].contiguous()):
        count, out = list_model(grid, tq, values, r2, op)
        on_card = (card_grid, tq.to(cuda), values.to(cuda))
        before = (kgrid.REDUCE_LIST_KERNEL.launches, kgrid.PACK_KERNEL.launches)
        got = [a.cpu() for a in kgrid.reduce_list(*on_card, r2, op, boxes=boxes)]
        assert (kgrid.REDUCE_LIST_KERNEL.launches, kgrid.PACK_KERNEL.launches) == (
            before[0] + 1, before[1])
        again = [a.cpu() for a in kgrid.reduce_list(*on_card, r2, op)]
        assert kgrid.PACK_KERNEL.launches == before[1] + 1
        assert torch.equal(got[0], count) and same_bits(got[1], out)
        assert torch.equal(again[0], got[0]) and same_bits(again[1], got[1])
        want = kgrid.reduce_list_ref(grid, tq, values, r2, op)
        scale = kgrid.reduce_list_ref(grid, tq, values.abs(), r2, "sum")[1]
        hold(got, want, scale, op)
