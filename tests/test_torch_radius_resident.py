"""The two routes of the dense radius sweeps of mapmerge_torch (kernels E
and F: kernels/radius.py, csrc/radius.cu), as the kernels schedule them.

A cloud of up to RESIDENT_MAX_POINTS points takes the resident route: every
CTA holds the cloud in the caller's order, folds the mask into x (NaN),
builds the box of each tile of TILE points and sweeps its queries. A larger
cloud takes the streamed route: the order pre-pass (`order_ref` its plain
version) sorts each chunk of ORDER_CHUNK points by the Morton code of its
cells of r / ORDER_CELLS, then the sweep reads the tiles of that order. In
both a warp's TILE // LANES queries visit a tile when the box of their
queries and one query's clamped-box bound reach it, and lane g of a query
takes the points j = g (mod LANES) of each tile, F's sums in the route's
order, the lanes' parts in a fixed tree.

Here: a numpy float32 model of that schedule (`route_model`) held under
hypothesis against count_ref and moments_ref (E exactly, F's count exactly
and its mean and covariance within MOMENTS_RTOL) on both routes, and
against the JAX package's dense radius_count and neighbor_moments;
order_ref's invariants (a permutation within each chunk, valid points
first, each tile's box that of its valid points); the adversarial cases
(P at the cutoff and one either side, P not a multiple of 32, every point
masked, queries parked at FAR, points exactly on the radius); the card path
with the meta device standing in for the card (one C call a call, the
order pre-pass counted on the streamed route only, a failure raises).

The `cuda` cases hold each route against the plain versions (E bit for bit,
F bit for bit the model and within MOMENTS_RTOL of moments_ref, repeating)
and the pre-pass against order_ref bit for bit; they skip here. On a
machine with a GPU: `python -m pytest tests/test_torch_radius_resident.py
-m cuda --noconftest`.
"""

import contextlib
import re
import signal
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import radius as kradius
from mapmerge_torch.kernels import tiles as ktiles
from mapmerge_torch.ops import neighbors as tn

from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

T = kradius.TILE
CUTOFF = kradius.RESIDENT_MAX_POINTS
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


# ---- the plain model of the schedule ----


def route_points(pc, mask, r2):
    """The points as the route of P = len(pc) holds them: xyz (P', 3)
    float32 with x = NaN where masked or absent. Resident: the caller's
    order, padded to whole tiles; streamed: order_ref's."""
    if kradius.route(pc.shape[0]) == "resident":
        pts, _ = ktiles.pack_ref(pc, None, mask)
        return pts[:, :3].contiguous()
    pts, _, _ = kradius.order_ref(pc, mask, r2)
    return pts[:, :3].contiguous()


def tile_boxes(xyz):
    """The box of each tile's valid points (x not NaN), as the resident CTA
    builds it (and order_ref writes it): (n_tiles, 2, 3)."""
    t = xyz.view(-1, T, 3)
    v = ~t[..., :1].isnan() & ~t.isnan()
    return torch.stack([torch.where(v, t, torch.inf).amin(1),
                        torch.where(v, t, -torch.inf).amax(1)], 1)


def visited(qc, boxes, r2, per_warp):
    """(Q, n_tiles) bool: the tiles each query's warp visits (per_warp
    consecutive queries a warp; the box of the warp's queries within r2 of
    the tile's, squared as sq_dists squares, and one query's clamped-box
    bound too). The super-tiles' culling skips no such tile: a super-tile
    holds its tiles' boxes, and the bounds are monotone."""
    lo, hi = boxes[:, 0], boxes[:, 1]
    d = qc[:, None] - torch.minimum(torch.maximum(qc[:, None], lo), hi)
    reach = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2] <= r2
    pad = -qc.shape[0] % per_warp  # idle lanes: no query, no box
    qw = torch.cat([qc, qc[-1:].expand(pad, 3)]).view(-1, per_warp, 3)
    qlo, qhi = qw.amin(1)[:, None], qw.amax(1)[:, None]
    gap = torch.where(qhi < lo, lo - qhi, torch.where(hi < qlo, qlo - hi, 0.0))
    box = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    rw = torch.cat([reach, reach.new_zeros((pad, reach.shape[1]))])
    warp = (box <= r2) & rw.view(-1, per_warp, reach.shape[1]).any(1)
    return warp.repeat_interleave(per_warp, 0)[: qc.shape[0]]


def route_model(qc, pc, mask, r2):
    """Kernels E and F as their route schedules them, in float32 numpy:
    each query's members among the points of the tiles its warp visits;
    lane g sums, in the route's point order, its members j = g (mod lanes =
    LANES) (x, y, z and the products p_i * p_j, each rounded once);
    the parts are added in the kernel's tree; then denom = max(count, 1), mean = s1 /
    denom, cov = s2 / denom - mean_i * mean_j. Returns (count int32,
    (count, mean, cov), the pairs compared: visited tiles x TILE over the
    queries)."""
    lanes = kradius.LANES
    xyz = route_points(pc, mask, r2)
    seen = visited(qc, tile_boxes(xyz), r2, T // lanes)
    tile_of = torch.arange(xyz.shape[0]) // T
    within = tn.sq_dists(qc, xyz) <= r2  # NaN x: never
    taken = (within & seen[:, tile_of]).numpy()
    p = np.nan_to_num(xyz.numpy())
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    terms = (x, y, z, x * x, x * y, x * z, y * y, y * z, z * z)
    # lane g's part: its points j = g (mod lanes), summed in order
    nq, zero = taken.shape[0], np.float32(0.0)
    shape = (nq, len(p) // lanes, lanes)
    parts = [np.add.accumulate(np.where(taken, v[None], zero).reshape(shape), axis=1,
                               dtype=np.float32)[:, -1] for v in terms]
    while parts[0].shape[1] > 1:  # lane g adds lane g ^ o's part: o = 1, 2, 4, ...
        parts = [a[:, 0::2] + a[:, 1::2] for a in parts]
    s = [a[:, 0] for a in parts]
    n = taken.sum(1)
    nf = n.astype(np.float32)
    denom = np.maximum(nf, np.float32(1.0))
    m = np.stack([s[k] / denom for k in range(3)], 1)
    slot = ((3, 4, 5), (4, 6, 7), (5, 7, 8))
    cov = np.stack([np.stack([s[slot[i][j]] / denom - m[:, i] * m[:, j] for j in range(3)], 1)
                    for i in range(3)], 1)
    moments = (torch.from_numpy(nf), torch.from_numpy(m), torch.from_numpy(cov))
    return torch.from_numpy(n.astype(np.int32)), moments, int(seen.sum()) * T


def check_model(qc, pc, mask, r2):
    """route_model against count_ref and moments_ref; returns the model."""
    count, moments, pairs = route_model(qc, pc, mask, r2)
    assert torch.equal(count, kradius.count_ref(qc, pc, mask, r2, 256))
    want = kradius.moments_ref(qc, pc, mask, r2, 256)
    assert torch.equal(moments[0], want[0])
    assert kradius.moments_error(moments, want)[1] <= kradius.MOMENTS_RTOL
    return count, moments, pairs


# ---- clouds ----


def surface_cloud(n, seed=0, masked=0.1, parked=0):
    """n points on three planes and a box over 6 x 6 m at 0.1 m voxels,
    sorted by voxel (x, then y, then z) as the feature stage leaves them; a
    share `masked` masked in place, the last `parked` masked and moved to
    FAR. (xyz, mask) float32 / bool torch tensors."""
    rng = np.random.default_rng(seed)
    p = rng.random((n, 3)).astype(np.float32) * np.float32(6.0)
    third = n // 3
    p[:third, 2] = np.round(p[:third, 2] / 3.0) * 3.0
    p[third : 2 * third, 0] = np.round(p[third : 2 * third, 0] / 2.0) * 2.0
    p = np.round(p / np.float32(0.1)).astype(np.float32) * np.float32(0.1)
    key = np.floor(p / np.float32(0.1)).astype(np.int64)
    p = p[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]
    mask = rng.random(n) >= masked
    if parked:
        mask[n - parked :] = False
        p[n - parked :] = FAR
    return torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(mask)


def centred(p, mask, q=None):
    qc, pc = tn._center(p if q is None else q, p, mask)
    return qc.contiguous(), pc.contiguous()


@st.composite
def route_cases(draw):
    """A cloud of 1-300 points (voxel order or shuffled, a ragged mask, a
    masked tail parked at FAR), on a 0.25 m lattice with a radius of 1-3
    steps (pairs exactly on it) or at random; queries: some of the points,
    some at FAR, some new; the route forced streamed by a cutoff below P
    (or not), with chunks of 64 points (or 1,024)."""
    n = draw(st.integers(1, 300))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if draw(st.booleans()):
        p = rng.integers(-6, 6, size=(n, 3)).astype(np.float32) * np.float32(0.25)
        r2 = float(np.float32(0.25 * draw(st.integers(1, 3))) ** 2)
    else:
        p = (rng.normal(size=(n, 3)) * draw(st.sampled_from([0.3, 1.0, 4.0]))).astype(np.float32)
        r2 = tn._f32(draw(st.floats(0.01, 4.0)))
    if draw(st.booleans()):
        key = np.floor(p / np.float32(0.25)).astype(np.int64)
        p = p[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]
    else:
        p = p[rng.permutation(n)]
    mask = rng.random(n) < draw(st.floats(0.3, 1.0))
    tail = draw(st.integers(0, n // 3))
    mask[n - tail :] = False
    p[n - tail :] = FAR
    q = np.concatenate([p[: draw(st.integers(0, n))],
                        np.full((draw(st.integers(0, 5)), 3), FAR, np.float32),
                        rng.normal(size=(draw(st.integers(0, 9)), 3)).astype(np.float32)])
    return (torch.from_numpy(q).reshape(-1, 3), torch.from_numpy(p), torch.from_numpy(mask),
            r2, draw(st.sampled_from(["resident", "streamed"])),
            draw(st.sampled_from([64, 1024])))


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(route_cases())
def test_route_model_keeps_exactly_the_dense_members(case):
    """On either route the tiles the warps visit hold every member: the
    model's count equals count_ref, F's model has moments_ref's count and
    its mean and covariance within MOMENTS_RTOL; parked queries count 0."""
    q, p, mask, r2, route, chunk = case
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kradius, "ORDER_CHUNK", chunk)
        if route == "streamed":
            mp.setattr(kradius, "RESIDENT_MAX_POINTS", 0)
        assert kradius.route(p.shape[0]) == route
        count, _, _ = check_model(q, p, mask, r2)
    parked = q.abs().amax(-1) >= FAR / 2
    assert not bool(count[parked].any())


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(route_cases())
def test_order_ref_sorts_each_chunk_and_boxes_its_tiles(case):
    """order_ref: each chunk's rows are that chunk's points (a permutation;
    valid ones, in Morton order of their cells, before masked and absent
    ones), x = NaN exactly where masked or absent, w = 0, and each tile's
    and each chunk's box is the least and largest coordinates of its valid
    points."""
    _, p, mask, r2, _, chunk = case
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kradius, "ORDER_CHUNK", chunk)
        pts, boxes, supers = kradius.order_ref(p, mask, r2)
    n = p.shape[0]
    npad = -(-n // chunk) * chunk
    assert pts.shape == (npad, 4) and boxes.shape == (npad // T, 2, 4)
    assert supers.shape == (npad // chunk, 2, 4)
    assert not bool(pts[:, 3].any()) and not bool(boxes[..., 3].any())
    assert not bool(supers[..., 3].any())
    valid = torch.cat([mask, torch.zeros(npad - n, dtype=torch.bool)])
    xyz = torch.cat([p, torch.zeros((npad - n, 3))])
    for c in range(npad // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        got, vin = pts[rows], valid[rows]
        live = ~got[:, 0].isnan()
        k = int(vin.sum())
        assert int(live.sum()) == k and bool(live[:k].all())  # valid first
        want = xyz[rows][vin]
        order = torch.from_numpy(np.lexsort(want.numpy().T[::-1].copy()))
        have = got[:k, :3]
        have = have[torch.from_numpy(np.lexsort(have.numpy().T[::-1].copy()))]
        assert torch.equal(have, want[order])
    assert torch.equal(boxes[..., :3], tile_boxes(pts[:, :3].contiguous()))
    chunks = boxes[..., :3].view(-1, chunk // T, 2, 3)
    assert torch.equal(supers[:, 0, :3], chunks[:, :, 0].amin(1))
    assert torch.equal(supers[:, 1, :3], chunks[:, :, 1].amax(1))


def test_order_ref_follows_the_morton_code_of_the_cells():
    """On a shuffled 4 x 4 x 4 lattice of 0.125 m cells (r = 1 m: cells of
    r / 8, every coordinate and cell exact in float32), the valid points
    come out in Morton order of their (x, y, z) cells, x the most
    significant axis of each triple of bits; masked points last, in place
    order."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    perm = np.random.default_rng(3).permutation(64)
    p = torch.from_numpy(g[perm].astype(np.float32) * np.float32(0.125) + np.float32(0.0625))
    mask = torch.ones(64, dtype=torch.bool)
    mask[:5] = False
    pts, _, _ = kradius.order_ref(p, mask, 1.0)
    cells = ((pts[:59, :3] - pts[:59, :3].amin(0)) * 8).long()
    code = sum(((cells[:, a] >> b) & 1) << (3 * b + 2 - a) for b in range(2) for a in range(3))
    assert bool((code[1:] > code[:-1]).all())
    assert bool(pts[59:64, 0].isnan().all()) and bool(pts[64:, 0].isnan().all())
    assert torch.equal(pts[59:64, 1:3], p[:5, 1:3])


@pytest.mark.parametrize("n", [CUTOFF - 1, CUTOFF, CUTOFF + 1])
def test_the_cutoff_splits_the_routes(n):
    """P at the cutoff takes the resident route, one more the streamed
    route, which alone needs a workspace (its points, tile boxes and chunk
    boxes, P rounded up to ORDER_CHUNK); the model holds on either side (300
    of the cloud's points as queries)."""
    p, mask = surface_cloud(n, seed=n, parked=37)
    qc, pc = centred(p, mask)
    assert kradius.route(n) == ("resident" if n <= CUTOFF else "streamed")
    npad = -(-n // kradius.ORDER_CHUNK) * kradius.ORDER_CHUNK
    assert kradius.work_floats(n) == npad * 4 + npad // T * 8 + npad // kradius.ORDER_CHUNK * 8
    sample = qc[:: max(1, n // 300)].contiguous()
    check_model(sample, pc, mask, tn._f32(0.36))


def test_compact_order_compares_fewer_pairs():
    """On a voxel-ordered surface cloud the streamed route's tiles are
    compact: forced onto it, the warps compare fewer pairs than in voxel
    order, with the same counts."""
    p, mask = surface_cloud(6000, seed=4)
    qc, pc = centred(p, mask)
    r2 = tn._f32(0.64)
    resident = route_model(qc, pc, mask, r2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kradius, "RESIDENT_MAX_POINTS", 0)
        streamed = route_model(qc, pc, mask, r2)
    assert torch.equal(resident[0], streamed[0])
    assert streamed[2] < 0.85 * resident[2]


@pytest.mark.parametrize("case", ["not a multiple of 32", "all masked", "parked queries",
                                  "on the radius"])
@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_adversarial_cases_on_both_routes(case, route):
    """The model on both routes on the cases the culling must keep exact:
    P = 1,001 (a ragged last tile), every point masked (no member
    anywhere), half the queries parked at FAR (their warps visit no tile),
    a 0.25 m lattice at r = 0.5 m (members exactly on the radius)."""
    r2 = tn._f32(0.36)
    if case == "on the radius":
        g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(3),
                                 indexing="ij"), -1).reshape(-1, 3)
        pc = torch.from_numpy((g.astype(np.float32) - 8.0) * np.float32(0.25))
        mask, qc, r2 = torch.ones(pc.shape[0], dtype=torch.bool), pc, 0.25
        assert int((tn.sq_dists(pc, pc) == r2).sum()) > 1000
    else:
        p, mask = surface_cloud(1001, seed=7)
        qc, pc = centred(p, mask)
        if case == "all masked":
            mask = torch.zeros_like(mask)
        if case == "parked queries":
            qc = torch.where((torch.arange(1001) % 2 == 0)[:, None], qc, FAR)
    with pytest.MonkeyPatch.context() as mp:
        if route == "streamed":
            mp.setattr(kradius, "RESIDENT_MAX_POINTS", 0)
            mp.setattr(kradius, "ORDER_CHUNK", 256)
        count, moments, pairs = check_model(qc, pc, mask, r2)
    if case == "all masked":
        assert not bool(count.any()) and not bool(moments[2].any())
    if case == "parked queries":
        assert not bool(count[1::2].any())
    if case == "on the radius":
        assert int(count.min()) >= 11


def test_route_model_against_the_jax_package():
    """The model on both routes against the JAX package's dense
    radius_count (exactly) and neighbor_moments (counts exactly, mean to
    1e-5, covariance to 1e-4: tests/test_torch_neighbors.py's tolerances)
    on the queries clear of the radius, which its matmul expansion of d^2
    may put on the other side."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import neighbors as jn

    p, mask = surface_cloud(3000, seed=9, parked=40)
    qc, pc = centred(p, mask)
    mean = tn._mean(p, mask)
    xyz = p.numpy()
    for r in (0.8, 0.55):
        r2 = tn._f32(r * r)
        d2 = ((xyz[:, None].astype(np.float64) - xyz[None]) ** 2).sum(-1)
        ok = ~((np.abs(d2 - r * r) < 1e-3) & mask.numpy()[None]).any(1)
        assert ok.mean() > 0.8
        jcount, _ = jn.radius_count(jnp.asarray(xyz), jnp.asarray(xyz), r,
                                    p_mask=jnp.asarray(mask.numpy()), tile=512)
        jc, jm, jcov, _ = jn.neighbor_moments(jnp.asarray(xyz), jnp.asarray(xyz), r,
                                              p_mask=jnp.asarray(mask.numpy()), tile=512)
        for route in ("resident", "streamed"):
            with pytest.MonkeyPatch.context() as mp:
                if route == "streamed":
                    mp.setattr(kradius, "RESIDENT_MAX_POINTS", 0)
                count, (c, m, cov), _ = route_model(qc, pc, mask, r2)
            np.testing.assert_array_equal(count.numpy()[ok], np.asarray(jcount)[ok])
            np.testing.assert_array_equal(c.numpy()[ok], np.asarray(jc)[ok])
            np.testing.assert_allclose((m + mean).numpy()[ok], np.asarray(jm)[ok], atol=1e-5)
            np.testing.assert_allclose(cov.numpy()[ok], np.asarray(jcov)[ok], atol=1e-4)


def test_cutoff_and_order_constants_are_the_kernels():
    """The Python constants of the routes are csrc/radius.cu's."""
    src = (build.CSRC / "radius.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([0-9.]+)f?;", src).group(1)

    assert int(const("kResidentMax")) == kradius.RESIDENT_MAX_POINTS
    assert int(const("kSuper")) == kradius.SUPER
    assert "constexpr int kChunk = kSuper * kT;" in src
    assert kradius.ORDER_CHUNK == kradius.SUPER * T
    assert float(const("kCells")) == kradius.ORDER_CELLS
    assert int(const("kCodeBits")) == kradius.ORDER_CODE_BITS
    assert int(const("kLanes")) == kradius.LANES


# ---- the card path, the meta device standing in for the card ----


@pytest.mark.parametrize("entry", ["count", "moments"])
@pytest.mark.parametrize("n", [CUTOFF, CUTOFF + 1])
def test_card_path_is_one_c_call_on_either_route(monkeypatch, entry, n):
    """A call on the card is one C call with the points, the mask and the
    queries: no workspace at or below the cutoff (one launch, the order
    pre-pass not counted), one of work_floats(P) floats above (the pre-pass
    counted with the kernel); an error it returns raises under the kernel's
    name; no route falls back."""
    meta = torch.device("meta")
    p = torch.empty((n, 3), device=meta)
    mask = torch.ones((n,), dtype=torch.bool, device=meta)
    q = torch.empty((100, 3), device=meta)
    kernel = {"count": kradius.COUNT_KERNEL, "moments": kradius.MOMENTS_KERNEL}[entry]
    calls = []

    def fn(*args):
        calls.append(args)
        return rc

    monkeypatch.setattr(build, "cuda_device", lambda kernel, x: x.device)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{f"mm_radius_{entry}": fn}))
    streamed = n > CUTOFF
    rc = 0
    before = (kernel.launches, kradius.ORDER_KERNEL.launches, ktiles.PACK_KERNEL.launches)
    out = getattr(kradius, entry)(q, p, mask, 0.36)
    assert len(calls) == 1 and (calls[0][7] is not None) == streamed
    assert calls[0][2] == n and calls[0][4] == 100
    assert (kernel.launches, kradius.ORDER_KERNEL.launches, ktiles.PACK_KERNEL.launches) == (
        before[0] + 1, before[1] + int(streamed), before[2])
    if entry == "moments":
        assert [a.shape for a in out] == [(100,), (100, 3), (100, 3, 3)]
    rc = 700
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed with error 700"):
        getattr(kradius, entry)(q, p, mask, 0.36)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: queries of a card case (the model's planes are queries x points)
QUERIES = 1536


def card_case(case):
    """(qc, pc, mask, r2) on the CPU: surface clouds either side of the
    cutoff and the adversarial cases on each route."""
    r2 = tn._f32(0.64)
    sizes = {"resident at the cutoff": CUTOFF, "streamed one past it": CUTOFF + 1,
             "resident, ragged": 4001, "streamed, ragged": 20001}
    if case in sizes:
        n = sizes[case]
        p, mask = surface_cloud(n, seed=11, parked=333)
        qc, pc = centred(p, mask)
        return qc[n // 2 : n // 2 + QUERIES].contiguous(), pc, mask, r2
    route, what = case.split(" ", 1)
    n = 4096 if route == "resident" else 24576
    p, mask = surface_cloud(n, seed=12)
    qc, pc = centred(p, mask)
    if what == "all masked":
        mask = torch.zeros_like(mask)
    elif what == "parked queries":
        qc = torch.where((torch.arange(n) % 3 == 0)[:, None], qc, FAR)
    elif what == "other queries":
        qc = qc[::5] + torch.tensor([0.05, -0.03, 0.01])
    elif what == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(2).permutation(n))
        pc, mask, qc = pc[perm].contiguous(), mask[perm], qc[perm]
    elif what == "no mask":
        mask = None
    return qc[:QUERIES].contiguous(), pc, mask, r2


CARD_CASES = ["resident at the cutoff", "streamed one past it", "resident, ragged",
              "streamed, ragged"] + [f"{r} {w}" for r in ("resident", "streamed")
                                     for w in ("all masked", "parked queries",
                                               "other queries", "shuffled", "no mask")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_routes_on_the_card(cuda, case):
    """E bit for bit count_ref; F's count exactly, its mean and covariance
    bit for bit the route's model and within MOMENTS_RTOL of moments_ref,
    repeating; the order pre-pass launched (and counted) on the streamed
    route only."""
    qc, pc, m, r2 = card_case(case)
    want = kradius.count_ref(qc, pc, m, r2)
    model = route_model(qc, pc, torch.ones(pc.shape[0], dtype=torch.bool) if m is None else m,
                        r2)[1]
    ref = kradius.moments_ref(qc, pc, m, r2)
    streamed = kradius.route(pc.shape[0]) == "streamed"
    qd, pd = qc.to(cuda), pc.to(cuda)
    md = None if m is None else m.to(cuda)
    before = kradius.ORDER_KERNEL.launches
    got = kradius.count(qd, pd, md, r2)
    moments = [a.cpu() for a in kradius.moments(qd, pd, md, r2)]
    again = [a.cpu() for a in kradius.moments(qd, pd, md, r2)]
    assert kradius.ORDER_KERNEL.launches == before + 3 * int(streamed)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(moments[0], ref[0])
    assert kradius.moments_error(moments, ref)[1] <= kradius.MOMENTS_RTOL
    for a, b, c in zip(moments, again, model):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 20001])
def test_order_on_the_card_is_order_ref(cuda, n):
    """The order pre-pass alone equals order_ref: the same values, NaN
    where NaN."""
    p, mask = surface_cloud(n, seed=n, parked=n // 10)
    _, pc = centred(p, mask)
    want = kradius.order_ref(pc, mask, tn._f32(0.36))
    got = [a.cpu() for a in kradius.order(pc.to(cuda), mask.to(cuda), tn._f32(0.36))]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())
