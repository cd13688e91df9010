"""The grid selection kernels of mapmerge_torch, kernel G (the bounded 1-NN,
kernels/grid.py `nn_query`) and kernel K (SIFT's grid 26-NN, `knn`), as
csrc/grid.cu schedules them: a pre-pass writes the box of every run of 32
slots (a tile) of each target bucket and lists the units of the query grid
(up to 32 answered slots of one bucket, a lane a query); a unit sweeps its
own bucket's tiles first, then the other neighbours' tiles nearest first
from the box of its queries (256 scan positions ordered at once), through
a ring of four stages, culling a tile whose box bound, paired with its
first slot, does not come before a query's threshold in (d2, slot) order,
and stopping where the next tile lies past the loosest threshold; G keeps
the first (d2, slot) member, K a sorted list of 26.

Here: a numpy float32 model of that schedule (`select_model`: the boxes
and units of kernels/grid.pack_ref, the neighbours in the kernels' order,
the rounded box bound, the ring's order of scans and visits, the
thresholds) held bit for bit against nn_query_ref and knn_ref under
hypothesis, on wrapped grids (an axis of 1 or 2 cells; a 4-cell z axis
under a cloud 8 cells tall), duplicated lattice points (ties within and
across buckets), queries parked at FAR, exclude_self both ways, k = 1 and
k = 26, empty target buckets and a bucket full at caps above 128; the model
against the JAX package's grid_nn_query and big-Q grid_radius_neighbors on
a seeded cloud (G's d2 within 1e-6 relative and its indices exactly, K's
valid flags and index sets exactly, as tests/test_torch_grid_kernels.py
and tests/test_torch_grid_sift_kernels.py hold the plain versions); the
float32 box bound against every point of its box; pack_ref's units and
boxes; the wrappers' card path (the meta device stands in for the card:
the pre-pass counted with each launch, boxes made once and passed back);
ICP making its target's boxes once and passing them to every query.

The `cuda` cases hold G and K bit for bit against their plain versions,
G with its boxes made in the call and passed back, the pre-pass against
pack_ref, and skip here; on a machine with a GPU: `python -m pytest
tests/test_torch_grid_select.py -m cuda --noconftest`.
"""

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
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

BIG = np.float32(tg.BIG)
INT_MAX = 2**31 - 1
#: K's list (csrc/grid.cu: kK), the ring's stages, and the scan positions
#: the kernels order at once (kBatch)
K_LIST, STAGES, BATCH = 26, 4, 256
TILE = kgrid.TILE


def before(da, ia, db, ib) -> bool:
    """(da, ia) before (db, ib): by d2, then by slot (cull.cuh)."""
    return bool(da < db or (da == db and ia < ib))


def sq_dist(q, p):
    """((q - p)_x^2 + (q - p)_y^2) + (q - p)_z^2 in float32, p (n, 3)."""
    d = q[None, :] - p
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def box_bound(q, lo, hi):
    """q clamped into [lo, hi], then sq_dist to that point (cull.cuh)."""
    return sq_dist(q, np.minimum(np.maximum(q, lo), hi)[None, :])[0]


def boxes_bound(qlo, qhi, lo, hi):
    """The rounded gap between the queries' box and a tile's, squared and
    summed as sq_dist (cull.cuh: boxes_bound)."""
    gap = np.where(qhi < lo, lo - qhi, np.where(hi < qlo, qlo - hi, np.float32(0)))
    gap = gap.astype(np.float32)
    return (gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]


def visit_order(b: int, dims) -> list[int]:
    """The neighbours of bucket b in the kernels' order: the 27 offsets in
    order (x fastest) where every axis has 3 cells or more, else the
    distinct ids ascending."""
    if min(dims) < 3:
        return neighbours(b, dims)
    gx, gy, gz = dims
    bx, by, bz = b % gx, (b // gx) % gy, b // (gx * gy)
    return [(((bz + dz) % gz) * gy + (by + dy) % gy) * gx + (bx + dx) % gx
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def select_model(grid, qg, q, n_p: int, knn=None):
    """csrc/grid.cu's G (knn None) or K (knn (k, r2, exclude_self)), a lane
    a query, in numpy float32, unit by unit of pack_ref's list: the outputs
    of kernels/grid.nn_query or knn."""
    boxes, units = (a.numpy() for a in kgrid.pack_ref(grid, qg, q))
    t_xyz, t_idx, t_count = (a.numpy() for a in (grid.cell_xyz, grid.cell_idx, grid.count))
    q_xyz, q_idx, q_ok = (a.numpy() for a in (qg.cell_xyz, qg.cell_idx, qg.cell_ok))
    h, cap = t_idx.shape
    n_tiles, qpw = -(-cap // TILE), 32
    gmax = -(-cap // qpw)
    nq = q.shape[0]
    r2 = np.float32(tg._f32(grid.cell_size * grid.cell_size) if knn is None else knn[1])
    if knn is None:
        out = [np.zeros(nq, np.int32), np.full(nq, BIG, np.float32)]
    else:
        k, _, exclude = knn
        out = [np.zeros((nq, k), np.int32), np.full((nq, k), BIG, np.float32),
               np.zeros((nq, k), bool)]
    for code in units[1 : units[0] + 1]:
        b, group = divmod(int(code), gmax)
        ids = visit_order(b, grid.dims)
        cnt = {i: min(int(t_count[i]), cap) for i in ids}
        positions = [(i, t) for i in ids if i != b for t in range(-(-cnt[i] // TILE))]
        slots = np.flatnonzero(q_ok[b])[group * qpw : (group + 1) * qpw]
        qs = [q_xyz[b, s] for s in slots]
        qlo = np.min(qs, axis=0) if qs else None
        qhi = np.max(qs, axis=0) if qs else None
        if knn is None:
            lane = [(BIG, -1) for _ in slots]  # each query's first member
        else:
            lane = [[(BIG, INT_MAX)] * K_LIST for _ in slots]

        def bound(s):
            """The query's threshold (d2, slot): G its first member, K its
            26th entry."""
            return lane[s] if knn is None else lane[s][-1]

        def reaches(bb, g0, d, i):
            return (knn is not None or bb <= r2) and before(bb, g0, d, i)

        def tile(nb, t):
            code = nb * n_tiles + t
            lo, hi = boxes[code, 0, :3], boxes[code, 1, :3]
            return lo, hi, nb * cap + t * TILE, min(TILE, cnt[nb] - t * TILE)

        def consume(nb, t):
            lo, hi, g0, n = tile(nb, t)
            bounds = [bound(s) for s in range(len(slots))]
            if not any(reaches(box_bound(qs[s], lo, hi), g0, *bounds[s])
                       for s in range(len(slots))):
                return
            pts = t_xyz[nb, t * TILE : t * TILE + n]
            for s in range(len(slots)):
                d2 = sq_dist(qs[s], pts)
                for j in range(n):
                    if knn is None:
                        if d2[j] <= r2 and before(d2[j], g0 + j, *lane[s]):
                            lane[s] = (d2[j], g0 + j)
                        continue
                    # against the query's 26th at the tile's start, then
                    # as it is then
                    if (d2[j] < BIG and not (exclude and d2[j] <= np.float32(1e-12))
                            and before(d2[j], g0 + j, *bounds[s])
                            and before(d2[j], g0 + j, *lane[s][-1])):
                        lst = lane[s] + [(d2[j], g0 + j)]
                        lane[s] = sorted(lst, key=lambda e: (e[0], e[1]))[:K_LIST]

        def ring(next_tile):
            issued = []
            for _ in range(STAGES - 1):
                t = next_tile()
                if t is not None:
                    issued.append(t)
            done = 0
            while done < len(issued):
                t = next_tile()
                if t is not None:
                    issued.append(t)
                consume(*issued[done])
                done += 1

        own = iter([(b, t) for t in range(-(-cnt[b] // TILE))])
        ring(lambda: next(own, None))
        scan = {"base": -BATCH, "left": []}

        def next_other():
            """The other tiles nearest first from the queries' box, a batch
            of BATCH scan positions at a time, while within the loosest
            threshold; a tile is visited when some query reaches it."""
            while True:
                bounds = [bound(s) for s in range(len(slots))]
                worst = max(((min(d, r2) if knn is None else d) for d, _ in bounds),
                            default=-np.inf)
                left = scan["left"]
                if not left or not left[0][0] <= worst:
                    scan["base"] += BATCH
                    if scan["base"] >= len(positions):
                        return None
                    batch = range(scan["base"], min(scan["base"] + BATCH, len(positions)))
                    scan["left"] = sorted(
                        (boxes_bound(qlo, qhi, *tile(*positions[p])[:2]), p) for p in batch)
                    continue
                _, p = left.pop(0)
                lo, hi, g0, _ = tile(*positions[p])
                reach = [reaches(box_bound(qs[s], lo, hi), g0, *bounds[s])
                         for s in range(len(slots))]
                # the queries' box bound is looser than every query's: the
                # tiles past it are reached by none
                assert all(not any(
                    reaches(box_bound(qs[s], *tile(*positions[r])[:2]), tile(*positions[r])[2],
                            *bounds[s]) for s in range(len(slots)))
                    for lb, r in left if not lb <= worst)
                if any(reach):
                    return positions[p]

        ring(next_other)
        for s, slot in enumerate(slots):
            row = q_idx[b, slot]
            if knn is None:
                d, i = bound(s)
                r = t_idx[min(ids), 0] if i < 0 else t_idx.reshape(-1)[i]
                out[0][row] = 0 if r >= n_p else r
                out[1][row] = d
                continue
            for j, (d, i) in enumerate(lane[s][:k]):
                r = 0 if d >= BIG else t_idx.reshape(-1)[i]
                out[0][row, j] = 0 if r >= n_p else r
                out[1][row, j] = d
                out[2][row, j] = d <= r2
    return [torch.from_numpy(a) for a in out]


def select_case(seed: int, n: int, nq: int, dup: float, masked: float, tall: bool):
    """Points on a 1/8 m lattice (squared distances exact, ties
    everywhere) over 1.5 m, or over 4 m in z where `tall` (taller than a
    4-cell z axis of cells up to 0.5 m: buckets hold points of cells far
    apart), a share duplicated at other positions, a share masked and half
    of those parked at FAR; queries half the points, half lattice points
    over 2.5 m, every fifth parked at FAR. numpy: (p, mask, q)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-6, 7, (n, 3))
    if tall:
        p[:, 2] = rng.integers(-16, 17, n)
    p = (p * 0.125).astype(np.float32)
    twins = p[rng.integers(0, n, int(dup * n))]
    p = np.concatenate([p, twins])[rng.permutation(n + len(twins))]
    mask = rng.random(len(p)) >= masked
    p[~mask & (rng.random(len(p)) < 0.5)] = FAR
    q = np.concatenate([p[rng.integers(0, len(p), nq // 2)],
                        rng.integers(-10, 11, (nq - nq // 2, 3)) * 0.125]).astype(np.float32)
    q[::5] = FAR
    return p, mask, q


#: wrapped dims: axes of 1 and 2 cells, and a 4-cell z axis
DIMS = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (4, 2, 1), (4, 4, 4), (8, 4, 4)]


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([1, 5, 16, 40, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 140), nq=st.integers(2, 50), dup=st.sampled_from([0.0, 0.5]),
       masked=st.sampled_from([0.0, 0.3, 1.0]), tall=st.booleans())
def test_nn_model_equals_nn_query_ref(seed, dims, cap, cell, n, nq, dup, masked, tall):
    """The model of G's schedule equals nn_query_ref bit for bit: ties of
    d2 within and across buckets go to the first candidate position
    whatever the order of the visits, an unmatched query gets the first
    candidate's index."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    want = kgrid.nn_query_ref(grid, qg, tq, len(p))
    got = select_model(grid, qg, tq, len(p))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), dims=st.sampled_from(DIMS),
       cap=st.sampled_from([1, 5, 16, 40, 64]), cell=st.sampled_from([0.25, 0.375, 0.5]),
       n=st.integers(1, 140), nq=st.integers(2, 40), k=st.sampled_from([1, 5, 26]),
       dup=st.sampled_from([0.0, 0.5]), masked=st.sampled_from([0.0, 0.3, 1.0]),
       tall=st.booleans(), exclude_self=st.booleans())
def test_knn_model_equals_knn_ref(seed, dims, cap, cell, n, nq, k, dup, masked, tall,
                                  exclude_self):
    """The model of K's schedule equals knn_ref bit for bit in every
    column: lists culled against their 26th, entries at BIG or beyond (0,
    BIG), lists shorter than k."""
    p, mask, q = select_case(seed, n, nq, dup, masked, tall)
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    r2 = tg._f32(cell * cell)
    want = kgrid.knn_ref(grid, qg, tq, len(p), k, r2, exclude_self)
    got = select_model(grid, qg, tq, len(p), (k, r2, exclude_self))
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def crowded_case(n_crowd: int = 200):
    """A bucket full at a cap of 160 (n_crowd points in one 0.5 m cell, 40
    dropped at 200), its neighbours sparse, most buckets of the (4, 4, 4)
    grid empty; the queries the crowd's points and points around it."""
    rng = np.random.default_rng(5)
    crowd = (rng.integers(0, 4, (n_crowd, 3)) * 0.125).astype(np.float32)
    near = ((rng.integers(-4, 8, (60, 3))) * 0.125).astype(np.float32)
    p = np.concatenate([crowd, near])
    q = np.concatenate([crowd[::3], near[::2]]).astype(np.float32)
    return p, np.ones(len(p), bool), q


@pytest.mark.parametrize("cap", [136, 160, 200, 256])
def test_models_hold_a_bucket_full_at_a_cap_above_128(cap):
    """G's and K's models equal their plain versions where one bucket is
    full at a cap above 128 (300 points in one cell; five to eight tiles,
    the last partial at 136 and 200, and points dropped) and most target
    buckets are empty."""
    p, mask, q = crowded_case(300)
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), cap)
    assert int(grid.count.max()) == cap and int(grid.overflow) > 0
    assert int((grid.count == 0).sum()) > 32
    for a, b in zip(select_model(grid, qg, tq, len(p)),
                    kgrid.nn_query_ref(grid, qg, tq, len(p))):
        assert torch.equal(a, b)
    for exclude_self in (False, True):
        knn = (K_LIST, tg._f32(0.25), exclude_self)
        for a, b in zip(select_model(grid, qg, tq, len(p), knn),
                        kgrid.knn_ref(grid, qg, tq, len(p), *knn)):
            assert torch.equal(a, b)


def test_model_matches_the_jax_package(monkeypatch):
    """The model of G against mapmerge_tpu's grid_nn_query and of K
    against its big-Q grid_radius_neighbors on one seeded cloud (3,000
    points in a 4 m cube, 10% masked and parked at FAR; 500 queries, 20%
    outside the query mask for G): G's indices exactly and d2 within 1e-6
    relative; K's valid flags and each row's index set exactly (the JAX
    package orders ties as lax.top_k does), their d2 within 1e-6."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import grid as jg

    rng = np.random.default_rng(0)
    p = (rng.random((3000, 3)) * 4.0).astype(np.float32)
    mask = rng.random(3000) > 0.1
    p[~mask] = FAR
    q = (rng.random((500, 3)) * 4.0).astype(np.float32)
    q_mask = rng.random(500) > 0.2
    cell, cap = 0.35, 32
    grid, qg, tq = _grids(p, mask, q, q_mask, cell, None, cap)
    got = select_model(grid, qg, tq, len(p))
    jgrid = jg.build_grid(jnp.asarray(p), jnp.asarray(mask), cell, None, cap)
    jidx, jd2, _ = jg.grid_nn_query(jgrid, jnp.asarray(q), len(p), q_mask=jnp.asarray(q_mask),
                                    tile=16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jd2), rtol=1e-6)

    monkeypatch.setattr(jg, "SMALL_Q_THRESHOLD", 0)  # its big-Q branch
    grid, qg, tq = _grids(p, mask, q, None, cell, None, cap)
    r2 = tg._f32(cell * cell)
    idx, d2, valid = select_model(grid, qg, tq, len(p), (K_LIST, r2, False))
    jidx, jd2, jvalid, _ = jg.grid_radius_neighbors(
        jnp.asarray(q), jnp.asarray(p), cell, K_LIST, p_mask=jnp.asarray(mask), tile=16,
        scan_cap=cap)
    jidx, jd2, jvalid = (np.asarray(a) for a in (jidx, jd2, jvalid))
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(d2.numpy()[jvalid], jd2[jvalid], rtol=1e-6, atol=1e-9)
    assert bool(valid.any())
    for row in range(len(q)):
        assert set(idx[row][valid[row]].tolist()) == set(jidx[row][jvalid[row]].tolist())


@settings(max_examples=200, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.sampled_from([1e-3, 1.0, 37.0, 1e4, 1e8]),
       n=st.integers(1, 32), shift=st.floats(-1e3, 1e3, width=32))
def test_box_bound_is_below_every_point_of_its_box(seed, scale, n, shift):
    """The float32 box bound (the query clamped into the box, then sq_dist
    in the same rounded operations) is <= sq_dist to every point of the
    box, with no epsilon, queries inside, beside and far from it; and the
    queries' box bound is <= each query's."""
    rng = np.random.default_rng(seed)
    pts = ((rng.random((n, 3)) - 0.5) * scale + shift).astype(np.float32)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    qs = ((rng.random((8, 3)) - 0.5) * scale * 3.0 + shift).astype(np.float32)
    qs[0] = pts[0]
    for qv in qs:
        assert box_bound(qv, lo, hi) <= sq_dist(qv, pts).min()
        assert boxes_bound(qs.min(axis=0), qs.max(axis=0), lo, hi) <= box_bound(qv, lo, hi)


def test_pack_ref_lists_every_answered_slot_once_and_boxes_the_tiles():
    """pack_ref's units cover each answered query slot once (a unit a
    group of 32 answered slots of one bucket) and number at most
    units_max; each box holds its tile's filled slots and is empty past
    them."""
    p, mask, q = crowded_case()
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), 160)
    boxes, units = kgrid.pack_ref(grid, qg, tq)
    gmax = -(-160 // 32)
    n = int(units[0])
    assert units.numel() == kgrid.units_max(len(q), 64) and n < units.numel()
    covered = torch.zeros((64, 160), dtype=torch.int32)
    for code in units[1 : n + 1].tolist():
        b, j = divmod(code, gmax)
        covered[b, j * 32 : (j + 1) * 32] += 1
    assert torch.equal(covered[qg.cell_ok], torch.ones(int(qg.cell_ok.sum()),
                                                     dtype=torch.int32))
    assert int(covered.sum()) >= int(qg.cell_ok.sum())
    tiles = boxes.view(64, 5, 2, 4)
    for b in range(64):
        c = int(grid.count[b])
        for t in range(5):
            lo, hi = tiles[b, t, 0, :3], tiles[b, t, 1, :3]
            pts = grid.cell_xyz[b, t * TILE : min(c, (t + 1) * TILE)]
            if len(pts):
                assert torch.equal(lo, pts.amin(0)) and torch.equal(hi, pts.amax(0))
            else:
                assert bool((lo == torch.inf).all() and (hi == -torch.inf).all())


# ---- the wrappers' card path ----


@pytest.mark.parametrize("entry", ["nn", "knn"])
def test_card_path_counts_the_pre_pass_and_keeps_the_boxes(card_path, entry):
    """On the card's path a call of nn_query or knn is one C call that
    launches the pre-pass and the kernel (both counted once) and has the
    target's boxes made; boxes() is one pre-pass launch of the boxes alone
    (no query counts, no units), and nn_query passes boxes it is given to
    the kernel as made, after checking their shape; a failed launch raises;
    pack() launches the pre-pass alone."""
    fn = "mm_grid_nn" if entry == "nn" else "mm_grid_knn"
    kernel = kgrid.NN_KERNEL if entry == "nn" else kgrid.KNN_KERNEL
    seen = []
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: seen.append((fn, args)) or 0,
           "mm_grid_pack": lambda *args: seen.append(("mm_grid_pack", args)) or 0}))
    grid, q = _meta_grid(), torch.empty((64, 3), device="meta")

    def call(**boxes):
        if entry == "nn":
            return kgrid.nn_query(grid, _meta_grid(), q, 100, **boxes)
        return kgrid.knn(grid, _meta_grid(), q, 100, K_LIST, 0.25)

    before = (kernel.launches, kgrid.PACK_KERNEL.launches)
    call()
    assert (kernel.launches, kgrid.PACK_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert [name for name, _ in seen] == [fn]
    if entry == "nn":
        made = kgrid.boxes(grid)  # (8 buckets x 1 tile, 2, 4)
        assert made.shape == (8, 2, 4) and seen[-1][0] == "mm_grid_pack"
        assert seen[-1][1][2] is None and seen[-1][1][9] is None  # no query counts, no units
        call(boxes=made)
        assert [args[15] for name, args in seen if name == fn] == [0, 1]  # boxes_ready
        with pytest.raises(ValueError, match="grid_nn: boxes"):
            call(boxes=made[:4])
        assert kernel.launches == before[0] + 2
        assert kgrid.PACK_KERNEL.launches == before[1] + 3
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: 700}))
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed"):
        call()
    card_path.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_grid_pack=lambda *args: seen.append(("mm_grid_pack", args)) or 0))
    before = kgrid.PACK_KERNEL.launches
    kgrid.pack(grid, _meta_grid(), q)
    assert kgrid.PACK_KERNEL.launches == before + 1
    assert seen[-1][1][2] is not None and seen[-1][1][9] is not None


def test_pack_takes_pack_ref_on_the_cpu():
    """On CPU tensors pack() is pack_ref (no launch counted)."""
    p, mask, q = crowded_case()
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), 160)
    before = kgrid.PACK_KERNEL.launches
    for a, b in zip(kgrid.pack(grid, qg, tq), kgrid.pack_ref(grid, qg, tq)):
        assert torch.equal(a, b)
    assert kgrid.PACK_KERNEL.launches == before


def test_boxes_take_boxes_ref_on_the_cpu():
    """On a CPU grid boxes() is boxes_ref (no launch counted), pack_ref's
    boxes, and nn_query gives the same bits with them as without."""
    p, mask, q = crowded_case()
    grid, qg, tq = _grids(p, mask, q, None, 0.5, (4, 4, 4), 160)
    before = kgrid.PACK_KERNEL.launches
    made = kgrid.boxes(grid)
    assert torch.equal(made, kgrid.boxes_ref(grid))
    assert torch.equal(made, kgrid.pack_ref(grid, qg, tq)[0])
    assert kgrid.PACK_KERNEL.launches == before
    for a, b in zip(kgrid.nn_query(grid, qg, tq, len(p), boxes=made),
                    kgrid.nn_query(grid, qg, tq, len(p))):
        assert torch.equal(a, b)


def test_icp_makes_its_targets_boxes_once(monkeypatch):
    """ICP on the grid engine makes its target grid's boxes once, before
    its loop, and passes the same boxes to every iteration's grid 1-NN; its
    result is the bits of a run whose queries make their own."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.ops import icp

    rng = np.random.default_rng(3)
    target = (rng.random((600, 3)) * 3.0).astype(np.float32)
    source = (target[rng.permutation(600)[:400]] + 0.02).astype(np.float32)
    monkeypatch.setattr(icp, "GRID_NN_THRESHOLD", 1)  # the grid engine at this size
    made, passed = [], []
    boxes_fn, query_fn = kgrid.boxes, icp.grid_nn_query

    def boxes_spy(grid):
        made.append(boxes_fn(grid))
        return made[-1]

    def query_spy(*args, boxes=None, **kwargs):
        passed.append(boxes)
        return query_fn(*args, boxes=boxes, **kwargs)

    def run():
        return icp.icp_refine(
            PointCloud.from_numpy(source, device="cpu"),
            PointCloud.from_numpy(target, device="cpu"),
            tf.identity(device="cpu"), max_correspondence_distance=0.2,
            outlier_rejection_threshold=0.1, max_iterations=5, transform_epsilon=1e-9)

    monkeypatch.setattr(kgrid, "boxes", boxes_spy)
    monkeypatch.setattr(icp, "grid_nn_query", query_spy)
    got = run()
    assert len(made) == 1 and len(passed) >= 2 and all(b is made[0] for b in passed)
    monkeypatch.setattr(kgrid, "boxes", lambda grid: None)
    want = run()
    assert torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
    assert int(got[2]) == int(want[2])


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_select_case(case):
    """(grid, qg, q, n_p, cell) on the CPU: ties on a tall wrapped lattice,
    a bucket full at a cap of 160 among empty ones, parked queries."""
    if case == "crowded":
        p, mask, q = crowded_case()
        cell, dims, cap = 0.5, (4, 4, 4), 160
    else:
        p, mask, q = select_case(7, 3000, 600, 0.3, 0.2, True)
        cell, dims, cap = 0.375, (8, 4, 4), 256
    grid, qg, tq = _grids(p, mask, q, None, cell, dims, cap)
    return grid, qg, tq, len(p), cell


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crowded", "tall lattice ties"])
def test_select_kernels_equal_the_plain_versions(cuda, case):
    """Kernels G and K bit for bit nn_query_ref and knn_ref (k = 26 and 1,
    exclude_self both ways), G with the target's boxes made in the call and
    passed back from boxes(), repeating; the pre-pass's boxes of the filled
    tiles equal pack_ref's and its units are the same set."""
    grid, qg, q, n_p, cell = card_select_case(case)
    r2 = tg._f32(cell * cell)
    want_nn = kgrid.nn_query_ref(grid, qg, q, n_p)
    want_knn = {(k, ex): kgrid.knn_ref(grid, qg, q, n_p, k, r2, ex)
                for k in (K_LIST, 1) for ex in (False, True)}
    ref_boxes, ref_units = kgrid.pack_ref(grid, qg, q)
    grid, qg, q = _to(grid, cuda), _to(qg, cuda), q.to(cuda)
    made = kgrid.boxes(grid)
    for _ in range(2):
        for boxes in (None, made):
            for a, b in zip(kgrid.nn_query(grid, qg, q, n_p, boxes=boxes), want_nn):
                assert torch.equal(a.cpu(), b)
        for (k, ex), want in want_knn.items():
            for a, b in zip(kgrid.knn(grid, qg, q, n_p, k, r2, ex), want):
                assert torch.equal(a.cpu(), b)
    boxes, units = (a.cpu() for a in kgrid.pack(grid, qg, q))
    n = int(units[0])
    filled = kgrid.filled_tiles(grid).cpu()
    assert bool((boxes[filled] == ref_boxes[filled]).all()) and n == int(ref_units[0])
    assert bool((made.cpu()[filled] == ref_boxes[filled]).all())
    assert torch.equal(units[1 : n + 1].sort().values, ref_units[1 : n + 1].sort().values)
    counts = kgrid.select_counters("grid_nn", grid, qg, q, n_p)
    assert counts["units"] == n and counts["answered"] == int(qg.cell_ok.sum())
