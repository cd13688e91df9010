"""The culling of SIFT's dense-octave kernels C and D (mapmerge_torch/
kernels/sift.py, csrc/sift.cu), on its plain versions.

The kernels skip a tile of TILE consecutive points when the clamped-box
bound of every query of a warp exceeds its threshold: r2_bound for C, the
query's current 26th (d2, index) for D. Here: the pre-pass's plain version
(`pack_ref`) against its definition; a property test that the box bound
(`tile_bound`) and the warp's query-box bound that the kernels test first
are <= sq_dists for every valid member of every tile; a plain model of D's
visit rule (any tile order, lexicographic merge, culling against the 26th)
against `knn_ref` index for index; and a plain model of C's culling that
takes exactly `scale_space_ref`'s in-bound pairs. Clouds in voxel order (as
the octaves come out of the voxel grid), shuffled, and on lattice ties.

The `cuda` cases hold the kernels against their plain versions on the same
kinds of inputs and skip here; on a machine with a GPU: `python -m pytest
tests/test_torch_sift_cull.py -m cuda --noconftest`.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import sift as ksift
from mapmerge_torch.kernels import tiles as ktiles
from mapmerge_torch.ops import neighbors as tn

from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

T = ktiles.TILE
NO_MASKED = 2**31 - 1


def surface_cloud(seed, n=2000, masked_tail=300, leaf=0.125, shuffle=False):
    """n slots: points on three planes over 8 x 8 m, voxel-downsampled
    the way ops/downsample.py orders them (one point a leaf-cube, sorted by
    the integer key x, then y, then z), snapped to the leaf lattice (many
    equal distances), the last `masked_tail` slots masked at FAR; optionally
    shuffled. Returns centred (xyz, mask, vals) as the octave's kernels get
    them."""
    rng = np.random.default_rng(seed)
    raw = rng.random((4 * n, 3)) * 8.0
    raw[:, 2] = np.round(raw[:, 2] / 3.0) * 3.0
    key = np.floor(raw / leaf).astype(np.int64)
    key = np.unique(key, axis=0)[: n - masked_tail]  # lexicographic: x, y, z
    xyz = (key.astype(np.float32) + 0.5) * np.float32(leaf)
    m = len(xyz)
    xyz = np.concatenate([xyz, np.full((n - m, 3), FAR, np.float32)])
    mask = np.arange(n) < m
    if shuffle:
        perm = rng.permutation(n)
        xyz, mask = xyz[perm], mask[perm]
    vals = np.where(mask, rng.random(n) * 255.0, 0.0).astype(np.float32)
    qc, pc = tn._center(torch.from_numpy(xyz), torch.from_numpy(xyz),
                        torch.from_numpy(mask))
    return qc, pc, torch.from_numpy(mask), torch.from_numpy(vals)


def lexicographic_top(d, i, k):
    """The k smallest (d, i) pairs of each row, by d, then by i."""
    o = torch.argsort(i, dim=1, stable=True)
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.argsort(d, dim=1, stable=True)
    return d.gather(1, o)[:, :k], i.gather(1, o)[:, :k]


def knn_visit_model(q, p, mask, k, r2, order):
    """Kernel D's rule for every query: tiles in `order` (each query's own
    sequence, (Q, n_tiles)); a tile is visited when a valid point of it may
    come before the query's current 26th (tile_bound <= d26) or it holds a
    masked point and (BIG, its first masked index) comes before the 26th;
    a visited tile's points (masked at BIG) merge into the list by (d2,
    index). Returns (idx, valid, visited (Q, n_tiles))."""
    nq, np_ = q.shape[0], p.shape[0]
    _, boxes = ktiles.pack_ref(p, None, mask)
    n_tiles = boxes.shape[0]
    bound = ktiles.tile_bound(q, boxes)
    first_masked = boxes[:, 0, 3].contiguous().view(torch.int32).long()
    d2_all = tn.sq_dists(q, p)
    if mask is not None:
        d2_all = torch.where(mask[None], d2_all, tn.BIG)
    dist = torch.full((nq, ksift.MAX_K), torch.inf)
    idx = torch.full((nq, ksift.MAX_K), NO_MASKED, dtype=torch.long)
    visited = torch.zeros((nq, n_tiles), dtype=torch.bool)
    rows = torch.arange(nq)
    for step in range(n_tiles):
        t = order[:, step]
        d26, i26 = dist[:, -1], idx[:, -1]
        fm = first_masked[t]
        reach = (bound[rows, t] <= d26) | (
            (fm != NO_MASKED) & ((tn.BIG < d26) | ((tn.BIG == d26) & (fm < i26)))
        )
        visited[rows, t] = reach
        if not reach.any():
            continue
        r = rows[reach]
        cand_i = t[reach, None] * T + torch.arange(T)[None]
        inside = cand_i < np_
        cand_d = torch.where(inside, d2_all[r[:, None], cand_i.clamp_max(np_ - 1)],
                             torch.inf)
        cand_i = torch.where(inside, cand_i, NO_MASKED)
        dist[r], idx[r] = lexicographic_top(torch.cat([dist[r], cand_d], 1),
                                            torch.cat([idx[r], cand_i], 1), ksift.MAX_K)
    return idx[:, :k].to(torch.int32), dist[:, :k] <= r2, visited


def kernel_order(nq, np_):
    """The kernel's order for each query: its warp's own tile (where its
    first query sits among the points) and the tiles either side of it in
    index order first, then every other tile in index order."""
    n_tiles = -(-np_ // T)
    own = torch.clamp((torch.arange(nq) // 32 * 32) * np_ // nq // T, max=n_tiles - 1)
    rows = []
    for o in own.tolist():
        window = [o] + [t for t in (o - 1, o + 1) if 0 <= t < n_tiles]
        rows.append(window + [t for t in range(n_tiles) if t not in window])
    return torch.tensor(rows)


# ---- the pre-pass ----


@pytest.mark.parametrize("np_,with_vals,with_mask", [
    (70, True, True), (64, False, True), (1, True, False), (33, False, False)])
def test_pack_ref_matches_its_definition(np_, with_vals, with_mask):
    """pts: (x, y, z, value) a point, x NaN where masked, value 0 without
    vals, rows past P (NaN, 0, 0, 0); boxes: per tile of TILE points the
    least and largest coordinates of its valid points (+inf / -inf with
    none), its first masked index (int bits, 2^31 - 1 with none) and its
    first point index (int bits)."""
    rng = np.random.default_rng(np_)
    p = rng.normal(size=(np_, 3)).astype(np.float32) * 50
    vals = rng.random(np_).astype(np.float32) if with_vals else None
    mask = rng.random(np_) < 0.7 if with_mask else None
    if with_mask and np_ >= 64:
        mask[32:64] = False  # a tile with no valid point
    pts, boxes = ktiles.pack_ref(torch.from_numpy(p),
                                None if vals is None else torch.from_numpy(vals),
                                None if mask is None else torch.from_numpy(mask))
    n_tiles = -(-np_ // T)
    assert pts.shape == (n_tiles * T, 4) and boxes.shape == (n_tiles, 2, 4)
    pts, boxes = pts.numpy(), boxes.numpy()
    valid = np.ones(np_, bool) if mask is None else mask
    for j in range(n_tiles * T):
        if j < np_:
            want = [p[j, 0] if valid[j] else np.nan, p[j, 1], p[j, 2],
                    0.0 if vals is None else vals[j]]
        else:
            want = [np.nan, 0.0, 0.0, 0.0]
        np.testing.assert_array_equal(pts[j], np.float32(want))
    for t in range(n_tiles):
        members = [j for j in range(t * T, min(np_, t * T + T))]
        live = [j for j in members if valid[j]]
        lo = p[live].min(0) if live else np.full(3, np.inf, np.float32)
        hi = p[live].max(0) if live else np.full(3, -np.inf, np.float32)
        np.testing.assert_array_equal(boxes[t, 0, :3], lo)
        np.testing.assert_array_equal(boxes[t, 1, :3], hi)
        masked = [j for j in members if not valid[j]]
        assert boxes[t, 0, 3:].view(np.int32)[0] == (masked[0] if masked else NO_MASKED)
        assert boxes[t, 1, 3:].view(np.int32)[0] == t * T


# ---- the bounds ----


@st.composite
def clouds_and_queries(draw):
    """A cloud of 1-100 points at a drawn scale (negative and large
    coordinates, all points equal, single-point tiles), a ragged mask with a
    masked tail, and queries: some of the points, some at FAR, some new."""
    n = draw(st.integers(1, 100))
    scale = draw(st.sampled_from([1e-3, 1.0, 1e3, 1e6]))
    offset = draw(st.floats(-1e6, 1e6, width=32))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    p = (rng.normal(size=(n, 3)) * scale + offset).astype(np.float32)
    if draw(st.booleans()):
        p[:] = p[0]  # every tile's points equal
    if draw(st.booleans()):
        p = np.round(p / np.float32(scale)) * np.float32(scale)  # lattice ties
    mask = rng.random(n) < draw(st.floats(0.0, 1.0))
    tail = draw(st.integers(0, n))
    mask[n - tail:] = False
    p[n - tail:] = FAR
    q = np.concatenate([p[: draw(st.integers(0, n))],
                        np.full((draw(st.integers(0, 3)), 3), FAR, np.float32),
                        (rng.normal(size=(3, 3)) * scale + offset).astype(np.float32)])
    return torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(mask)


def query_box_bound(q, boxes):
    """The bound the kernels test first for a warp: the gap between the box
    of its queries `q` and each tile's box, squared and summed as sq_dists
    does: (n_tiles,)."""
    qlo, qhi = q.amin(0), q.amax(0)
    lo, hi = boxes[:, 0, :3], boxes[:, 1, :3]
    gap = torch.where(qhi < lo, lo - qhi, torch.where(hi < qlo, qlo - hi, 0.0))
    return (gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1]) + gap[:, 2] * gap[:, 2]


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(clouds_and_queries())
def test_box_bounds_never_exceed_sq_dists(case):
    """For every query, every tile and every valid member of it, the
    clamped-box bound is <= sq_dists, and the query-box bound of all the
    queries together is <= every query's clamped-box bound: rounding is
    monotone, so skipping a tile on either bound drops no point."""
    q, p, mask = case
    _, boxes = ktiles.pack_ref(p, None, mask)
    bound = ktiles.tile_bound(q, boxes)  # (Q, n_tiles)
    d2 = tn.sq_dists(q, p)
    tile_of = torch.arange(p.shape[0]) // T
    member = bound[:, tile_of]
    assert bool(((member <= d2) | ~mask[None]).all())
    assert bool((query_box_bound(q, boxes)[None] <= bound).all())


# ---- kernel D's visit rule ----


def _knn_cases():
    return {
        "voxel order": surface_cloud(1),
        "shuffled": surface_cloud(2, shuffle=True),
        "lattice ties": surface_cloud(3, leaf=0.5),
    }


@pytest.mark.parametrize("case", ["voxel order", "shuffled", "lattice ties"])
def test_knn_visit_rule_matches_knn_ref(case):
    """The model of D's visit rule equals knn_ref index for index and flag
    for flag whatever the tile order (the kernel's, reversed, random): the
    lexicographic merge and culling against the 26th keep the result
    independent of the order. In voxel order the kernel's order visits a
    small share of the tiles; shuffled, culling stays exact."""
    qc, pc, mask, _ = _knn_cases()[case]
    r2 = tn._f32(0.25)
    want_idx, want_valid = ksift.knn_ref(qc, pc, mask, 26, r2, 512)
    nq, n_tiles = qc.shape[0], -(-pc.shape[0] // T)
    rng = np.random.default_rng(5)
    orders = {
        "kernel": kernel_order(nq, pc.shape[0]),
        "reversed": torch.arange(n_tiles - 1, -1, -1)[None].expand(nq, n_tiles),
        "random": torch.from_numpy(
            np.stack([rng.permutation(n_tiles) for _ in range(nq)])),
    }
    shares = {}
    for name, order in orders.items():
        idx, valid, visited = knn_visit_model(qc, pc, mask, 26, r2, order)
        assert torch.equal(idx, want_idx), name
        assert torch.equal(valid, want_valid), name
        shares[name] = float(visited.double().mean())
    if case == "voxel order":
        assert shares["kernel"] < 0.5, shares


def test_knn_visit_rule_short_k_and_parked_queries():
    """k < 26 and queries parked at FAR (their lists are the masked targets
    in index order): the model equals knn_ref, and in the kernel's order a
    parked query whose own tile holds 26 masked targets visits at most five
    tiles."""
    qc, pc, mask, _ = surface_cloud(4, n=600, masked_tail=100)
    for k in (1, 7, 26):
        want_idx, want_valid = ksift.knn_ref(qc, pc, mask, k, tn._f32(1e12), 512)
        idx, valid, visited = knn_visit_model(qc, pc, mask, k, tn._f32(1e12),
                                              kernel_order(qc.shape[0], pc.shape[0]))
        assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)
    parked = qc.abs().amax(-1) >= FAR / 2
    assert bool((idx[parked] == torch.nonzero(~mask).flatten()[:26].to(torch.int32)).all())
    # a parked query whose own tile fills its list with masked targets then
    # visits, past its own tile and the two beside it, only the tiles where
    # the masked tail starts
    own = kernel_order(qc.shape[0], pc.shape[0])[:, 0]
    masked_in_own = torch.stack([(~mask[t * T : t * T + T]).sum() for t in own])
    full = parked & (masked_in_own >= 26)
    assert int(full.sum()) >= 32 and int(visited[full].sum(-1).max()) <= 5


# ---- kernel C's culling ----


@pytest.mark.parametrize("case,warp", [("voxel order", 32), ("voxel order", 5),
                                       ("shuffled", 16), ("one tile", 32)])
def test_scale_space_culling_takes_exactly_the_pairs_in_bound(case, warp):
    """A warp of `warp` queries visits a tile when the clamped-box bound of
    any of its queries is <= r2_bound (G lanes a query: 32 // G queries a
    warp). The pairs within the bound in the visited tiles are exactly
    scale_space_ref's (d2 <= r2_bound, valid), so its field comes out the
    same; in voxel order most tiles are skipped."""
    if case == "one tile":
        qc, pc, mask, vals = surface_cloud(6, n=T, masked_tail=5)
    else:
        qc, pc, mask, vals = surface_cloud(7, shuffle=case == "shuffled")
    sigmas = [0.125 * 2.0 ** (s / 3) for s in range(6)]
    r2 = tn._f32((3.0 * max(sigmas)) ** 2)
    _, boxes = ktiles.pack_ref(pc, vals, mask)
    reach = ktiles.tile_bound(qc, boxes) <= r2  # (Q, n_tiles)
    nq, n_tiles = reach.shape
    pad = -nq % warp
    by_warp = torch.cat([reach, torch.zeros((pad, n_tiles), dtype=torch.bool)])
    by_warp = by_warp.view(-1, warp, n_tiles).any(1).repeat_interleave(warp, 0)[:nq]
    tile_of = torch.arange(pc.shape[0]) // T
    in_bound = (tn.sq_dists(qc, pc) <= r2) & mask[None]
    taken = in_bound & by_warp[:, tile_of]
    assert torch.equal(taken, in_bound)
    assert torch.equal(in_bound & reach[:, tile_of], in_bound)
    parked = qc.abs().amax(-1) >= FAR / 2
    assert not bool(reach[parked].any())
    if case == "voxel order":
        assert float(by_warp.double().mean()) < 0.6


def test_lanes_per_query_fill_small_octaves():
    """The lanes of kernel D that share a query (each a share of every
    tile's points; kernel C always takes 8): 4 up to 32,768 queries, 2 at
    config5_big's 58,254, one at 2^19; a power of two that depends on Q
    alone."""
    for nq in (2048, 4096, 10922, 32768):
        assert ksift._lanes_per_query(nq, *ksift._D_LANES) == 4
    assert ksift._lanes_per_query(58254, *ksift._D_LANES) == 2
    assert ksift._lanes_per_query(2**19, *ksift._D_LANES) == 1
    for nq in (1, 100, 4096, 10922, 2**19):
        g = ksift._lanes_per_query(nq, *ksift._D_LANES)
        assert g in (1, 2, 4) and g <= ksift._D_LANES[0]


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card(case, dev):
    """(qc, pc, mask, vals) on the card for an adversarial case."""
    if case == "all masked":
        qc, pc, mask, vals = surface_cloud(11, n=3000)
        mask = torch.zeros_like(mask)
        vals = torch.zeros_like(vals)
    elif case == "parked queries":
        qc, pc, mask, vals = surface_cloud(12, n=3000, masked_tail=1200)
    elif case == "small Q":
        qc, pc, mask, vals = surface_cloud(13, n=20000, masked_tail=2000)
        qc = qc[::97].contiguous()
    elif case == "one tile":
        qc, pc, mask, vals = surface_cloud(14, n=T, masked_tail=6)
    else:
        qc, pc, mask, vals = surface_cloud(15, n=5000, shuffle=case == "shuffled")
    return tuple(a.to(dev) for a in (qc, pc, mask, vals))


CARD_CASES = ["voxel order", "shuffled", "all masked", "parked queries", "small Q",
              "one tile"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_pack_kernel_equals_pack_ref(cuda, case):
    """The pre-pass: the same values (NaN where NaN) and the int bits of
    the fourth columns exactly; one launch."""
    _, pc, mask, vals = _card(case, cuda)
    before = ktiles.PACK_KERNEL.launches
    pts, boxes = ktiles.pack(pc, vals, mask)
    assert ktiles.PACK_KERNEL.launches == before + 1
    rpts, rboxes = ktiles.pack_ref(pc, vals, mask)
    same = (pts == rpts) | (pts.isnan() & rpts.isnan())
    assert bool(same.all())
    assert torch.equal(boxes[..., :3], rboxes[..., :3])
    assert torch.equal(boxes[..., 3].contiguous().view(torch.int32),
                       rboxes[..., 3].contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("k", [26, 9])
def test_knn_kernel_exact_on_adversarial_inputs(cuda, case, k):
    """Kernel D bit for bit knn_ref: shuffled clouds, every target masked,
    many queries parked at FAR, a small Q against a large P, one tile, and
    k < 26."""
    qc, pc, mask, _ = _card(case, cuda)
    k = min(k, pc.shape[0])
    for r2 in (tn._f32(1e12), 0.3):
        idx, valid = ksift.knn(qc, pc, mask, k, r2)
        ridx, rvalid = ksift.knn_ref(qc, pc, mask, k, r2)
        assert torch.equal(idx, ridx) and torch.equal(valid, rvalid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_scale_space_kernel_on_adversarial_inputs(cuda, case):
    """Kernel C within SCALE_SPACE_RTOL of scale_space_ref on the same
    inputs, exactly 0 at the parked queries, the same bits again."""
    qc, pc, mask, vals = _card(case, cuda)
    sigmas = [0.125 * 2.0 ** (s / 3) for s in range(6)]
    r2 = tn._f32((3.0 * max(sigmas)) ** 2)
    got = ksift.scale_space(qc, pc, vals, mask, sigmas, r2)
    ref = ksift.scale_space_ref(qc, pc, vals, mask, sigmas, r2)
    err = float((got - ref).abs().max())
    assert err <= ksift.SCALE_SPACE_RTOL * max(float(ref.abs().max()), 1e-30)
    parked = qc.abs().amax(-1) >= FAR / 2
    assert bool((got[:, parked] == 0).all())
    assert torch.equal(got, ksift.scale_space(qc, pc, vals, mask, sigmas, r2))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_on_one_shared_buffer(cuda, case):
    """As SIFT runs them: one pre-pass with C's values, C and D both on its
    buffer; the same bits as each with its own pre-pass, and one pre-pass
    launch in all."""
    qc, pc, mask, vals = _card(case, cuda)
    sigmas = [0.125 * 2.0 ** (s / 3) for s in range(6)]
    r2 = tn._f32((3.0 * max(sigmas)) ** 2)
    k = min(26, pc.shape[0])
    before = ktiles.PACK_KERNEL.launches
    packed = ktiles.pack(pc, vals, mask)
    field = ksift.scale_space(qc, pc, vals, mask, sigmas, r2, packed=packed)
    idx, valid = ksift.knn(qc, pc, mask, k, tn._f32(1e12), packed=packed)
    assert ktiles.PACK_KERNEL.launches == before + 1
    assert torch.equal(field, ksift.scale_space(qc, pc, vals, mask, sigmas, r2))
    ridx, rvalid = ksift.knn(qc, pc, mask, k, tn._f32(1e12))
    assert torch.equal(idx, ridx) and torch.equal(valid, rvalid)
