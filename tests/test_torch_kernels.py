"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode: without a GPU the tests marked `cuda`
skip. Run them on a machine with one: `python -m pytest
tests/test_torch_kernels.py -m cuda --noconftest` (tests/conftest.py
configures jax, which these tests do not use). The shared SPFH sweep's cell
binning is Python and is tested here on the CPU too.
"""

import numpy as np
import pytest
import torch

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.kernels import nn as knn
from mapmerge_torch.kernels import spfh as kspfh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nn_kernel_matches_plain_version(cuda):
    """Both round every operation alike: indices and d2 bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.rand((3001, 3), generator=g, device=cuda) * 8
    p = torch.rand((5003, 3), generator=g, device=cuda) * 8
    mask = torch.rand((5003,), generator=g, device=cuda) > 0.3
    before = knn.KERNEL.launches
    got = knn.nearest_neighbor(q, p, mask)
    assert knn.KERNEL.launches == before + 1
    ref = knn.nearest_neighbor_ref(q, p, mask)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    idx, d2 = knn.nearest_neighbor(q[:7], torch.zeros((2500, 3), device=cuda))
    assert bool((idx == 0).all()) and bool((d2 > 0).all())  # first on ties
    _, d2 = knn.nearest_neighbor(q[:9], p, torch.zeros_like(mask))
    assert bool((d2 >= 1e11).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nq,np_", [(1, 1), (513, 257), (14397, 14397), (600, 70001)])
def test_nn_kernel_ragged_sizes_and_splits(cuda, nq, np_):
    """Q and P that are multiples of no tile or split, with a mask, on
    clustered points (many near-ties); bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(nq + np_)
    q = torch.round(torch.rand((nq, 3), generator=g, device=cuda) * 40) / 8
    p = torch.round(torch.rand((np_, 3), generator=g, device=cuda) * 40) / 8
    mask = torch.rand((np_,), generator=g, device=cuda) > 0.25
    got = knn.nearest_neighbor(q, p, mask)
    ref = knn.nearest_neighbor_ref(q, p, mask)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_nn_kernel_ties_across_splits_and_all_masked(cuda):
    """Every target equidistant over many splits: index 0; a tie between
    two split ranges keeps the earlier; all targets masked: the penalty."""
    q = torch.zeros((5, 3), device=cuda)
    p = torch.ones((40000, 3), device=cuda)  # ~157 splits of 256
    idx, d2 = knn.nearest_neighbor(q, p)
    assert bool((idx == 0).all()) and bool((d2 == 3.0).all())
    p[30000] = p[9000] = 0.5  # two equal minima, far apart
    idx, _ = knn.nearest_neighbor(q, p)
    assert bool((idx == 9000).all())
    mask = torch.zeros((40000,), dtype=torch.bool, device=cuda)
    idx, d2 = knn.nearest_neighbor(q, p, mask)
    ref = knn.nearest_neighbor_ref(q, p, mask)
    assert torch.equal(idx, ref[0]) and torch.equal(d2, ref[1])
    assert bool((d2 >= 1e12).all())


@pytest.mark.cuda
def test_nn_kernel_rejects_bad_operands(cuda):
    q = torch.rand((10, 3), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        knn.nearest_neighbor(q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        knn.nearest_neighbor(q, torch.rand((3, 10), device=cuda).T)
    with pytest.raises(ValueError, match="on cpu"):
        knn.nearest_neighbor(q, q.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_spfh_kernel_matches_plain_version(cuda, shared):
    """Shared mode on one candidate cloud; grid mode (shared=False) on a
    cell grid of the same kind of points."""
    g = torch.Generator(device=cuda).manual_seed(1)
    if not shared:
        grid, q_ok, nrm = _grid_case(seed=1, n=4000, extent=2.0, needed=0.2,
                                     radius=0.6, device=cuda)
        before = kspfh.KERNEL.launches
        h, tot = kspfh.spfh_grid(grid, q_ok, nrm, r2=0.36)
        assert kspfh.KERNEL.launches == before + 1
        rh, rtot = kspfh.spfh_grid_ref(grid, q_ok, nrm, r2=0.36)
        assert torch.equal(tot, rtot) and bool((tot > 0).any())
        assert float((h - rh).abs().max()) <= 1e-4
        return
    b, cq, m = 6, 40, 700
    cand = torch.rand((1, m, 3), generator=g, device=cuda) * 2
    nrm = torch.nn.functional.normalize(
        torch.randn((1, m, 3), generator=g, device=cuda), dim=-1
    )
    ok = torch.rand((1, m), generator=g, device=cuda) > 0.2
    pick = torch.randint(0, m, (b, cq), generator=g, device=cuda)
    args = (cand[0, pick], nrm[0, pick], cand, nrm, ok)
    before = kspfh.KERNEL.launches
    h, tot = kspfh.spfh_tile(*args, r2=0.36)
    assert kspfh.KERNEL.launches == before + 1
    rh, rtot = kspfh.spfh_ref(*args, r2=0.36)
    assert torch.equal(tot, rtot)
    assert float((h - rh).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_spfh_tile_takes_one_candidate_cloud_on_the_card(cuda):
    """Per-bucket candidates (Bc = B) have no kernel behind spfh_tile: the
    grid engine's sweep goes through spfh_grid."""
    args = _spfh_case(seed=7, b=6, cq=50, m=900, extent=2.0, per_cell=True,
                      device=cuda)
    before = kspfh.KERNEL.launches
    with pytest.raises(ValueError, match="spfh_grid"):
        kspfh.spfh_tile(*args, r2=0.64)
    assert kspfh.KERNEL.launches == before


def _spfh_case(seed, b, cq, m, extent, dense=0, far=0.0, masked=False,
               per_cell=False, device="cpu"):
    """Seeded SPFH inputs: candidates on a few planes over `extent` m, the
    first `dense` of them packed into one 0.3 m cube, queries drawn from
    the candidates (self pairs occur), a share `far` parked at FAR."""
    rng = np.random.default_rng(seed)
    bc = b if per_cell else 1
    xyz = rng.uniform(0, extent, (bc, m, 3)).astype(np.float32)
    xyz[..., 2] = np.round(xyz[..., 2] / 2) * 2 + rng.normal(0, 0.01, (bc, m))
    xyz[:, :dense] = rng.uniform(1.0, 1.3, (bc, dense, 3))
    nrm = rng.normal(0, 0.2, (bc, m, 3)).astype(np.float32)
    nrm[..., 2] += 1
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ok = rng.random((bc, m)) > 0.1
    if masked:
        ok[:] = False
    pick = rng.integers(0, m, (b, cq))
    src = np.zeros((b, 1), int) if not per_cell else np.arange(b)[:, None]
    q_xyz, q_nrm = xyz[src, pick], nrm[src, pick]
    q_xyz[rng.random((b, cq)) < far] = FAR
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (q_xyz, q_nrm, xyz, nrm, ok)
    )


SPFH_EDGES = {
    # queries of one keypoint's rows, some parked at FAR
    "far_queries": dict(seed=2, b=64, cq=48, m=6000, extent=6.0, far=0.3),
    "all_masked": dict(seed=3, b=8, cq=48, m=3000, extent=4.0, masked=True),
    # 18k candidates over a 1 km cube: more cells than buckets, collisions
    "collisions": dict(seed=4, b=32, cq=48, m=20000, extent=1000.0, dense=2000),
    # one cell far denser than one shared-memory stage (512)
    "dense_cell": dict(seed=5, b=16, cq=48, m=5000, extent=3.0, dense=3000),
    "ragged_group": dict(seed=6, b=5, cq=100, m=4000, extent=3.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPFH_EDGES))
def test_spfh_kernel_edges_bit_exact(cuda, case):
    args = _spfh_case(**SPFH_EDGES[case], device=cuda)
    before = kspfh.KERNEL.launches
    h, tot = kspfh.spfh_tile(*args, r2=0.64)
    assert kspfh.KERNEL.launches == before + 1
    rh, rtot = kspfh.spfh_ref(*args, r2=0.64)
    assert torch.equal(tot, rtot) and torch.equal(h, rh)
    if case == "all_masked":
        assert not bool(tot.any()) and not bool(h.any())
    else:
        assert bool((tot > 0).any())


def _cells(xyz: np.ndarray, cell: np.float32) -> np.ndarray:
    """csrc/spfh.cu:cell_of in numpy: floor(x / cell) in float32, clamped."""
    return np.clip(np.floor(xyz / cell), -(2.0**30), 2.0**30).astype(np.int64)


def _buckets(c: np.ndarray) -> np.ndarray:
    """csrc/spfh.cu:bucket_of in numpy (uint32 products, low 15 bits)."""
    u = c.astype(np.uint32)
    h = u[..., 0] * np.uint32(73856093) ^ u[..., 1] * np.uint32(19349663)
    return (h ^ u[..., 2] * np.uint32(83492791)) & np.uint32(kspfh._TABLE - 1)


@pytest.mark.parametrize("case", ["far_queries", "collisions", "dense_cell"])
def test_spfh_cell_hash_covers_every_in_radius_pair(case):
    """The shared sweep's cells and buckets, mirrored in numpy: every pair
    the plain version counts lies in the 27 cells around its query, so in
    one of the buckets the kernel stages for that query; in the collisions
    case distinct cells share buckets."""
    r2 = 0.64
    cell = np.float32(np.sqrt(r2) * kspfh._CELL_MARGIN)
    q_xyz, _, xyz, _, ok = (a.numpy() for a in _spfh_case(**SPFH_EDGES[case]))
    q, c, ok = q_xyz.reshape(-1, 3), xyz[0], ok[0]
    qc, cc = _cells(q, cell), _cells(c, cell)
    # in-radius pairs as the plain version counts them (float32)
    d = c[None, :, :] - q[:, None, :]
    dist2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    dist = np.sqrt(np.maximum(dist2, np.float32(1e-12)))
    pair = ok[None, :] & (dist2 > 1e-12) & (dist * dist <= np.float32(r2))
    assert int(pair.sum()) > 100
    qi, ci = np.nonzero(pair)
    assert int(np.abs(qc[qi] - cc[ci]).max()) <= 1
    off = np.stack(np.meshgrid(*(np.arange(-1, 2),) * 3, indexing="ij"), -1)
    qb = _buckets(qc[:, None, :] + off.reshape(27, 3)[None])  # (Q, 27)
    assert bool((qb[qi] == _buckets(cc[ci])[:, None]).any(1).all())
    if case == "collisions":
        live = cc[ok]
        assert len(np.unique(live, axis=0)) > len(np.unique(_buckets(live)))


def _grid_case(seed, n, extent, cap=128, dims=None, dense=0, needed=0.01,
               forced=0, radius=0.8, device="cpu"):
    """Seeded inputs of the grid sweep: n points on planes 3 m apart over
    `extent` m, the first `dense` packed into one 0.3 m cube (more than
    `cap` of them fill a bucket to the cap), 5% masked, a share `needed` of
    the points and the first `forced` needed. Returns (grid at `radius`,
    the needed slots, normals), as fpfh._spfh_grid hands them over."""
    from mapmerge_torch.ops import grid as tg

    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    xyz[:, 2] = np.round(xyz[:, 2] / 3) * 3 + rng.normal(0, 0.01, n)
    xyz[:dense] = rng.uniform(2.0, 2.3, (dense, 3))
    nrm = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    nrm[:, 2] += 1
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ok = rng.random(n) > 0.05
    need = rng.random(n) < needed
    need[:forced] = True
    xyz, nrm, ok, need = (torch.from_numpy(a).to(device) for a in (xyz, nrm, ok, need))
    grid = tg.build_grid(xyz, ok, radius, dims, cap)
    return grid, tg.masked_query_grid(grid, need & ok, n).cell_ok, nrm


GRID_CASES = {
    # config #2's shape in small: a sparse needed set, so most buckets hold
    # no needed slot, and one bucket full to the cap
    "sparse_needed_full_bucket": dict(seed=8, n=40000, extent=12.0, dense=400,
                                      needed=0.01, forced=4),
    # an axis of 1 or 2 cells: the 27 wrapped neighbour ids repeat
    "tiny_dims": dict(seed=9, n=400, extent=2.0, cap=512, dims=(2, 1, 2),
                      needed=0.3),
    # more needed slots in one bucket than a block takes: several blocks a
    # bucket
    "two_groups_a_bucket": dict(seed=10, n=3000, extent=6.0, cap=256,
                                dense=300, needed=0.1, forced=200),
    "all_unneeded": dict(seed=11, n=5000, extent=6.0, needed=0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_spfh_grid_kernel_bit_exact(cuda, case):
    """The grid sweep against its plain version (grid_query over spfh_ref's
    per-bucket form) bit for bit: one launch, none where no slot is needed,
    and zero rows at every point in no needed slot."""
    grid, q_ok, nrm = _grid_case(**GRID_CASES[case], device=cuda)
    before = kspfh.KERNEL.launches
    h, tot = kspfh.spfh_grid(grid, q_ok, nrm, r2=0.64)
    assert kspfh.KERNEL.launches == before + int(bool(q_ok.any()))
    rh, rtot = kspfh.spfh_grid_ref(grid, q_ok, nrm, r2=0.64)
    assert torch.equal(tot, rtot) and torch.equal(h, rh)
    rows = torch.zeros_like(tot, dtype=torch.bool)
    rows[grid.cell_idx[q_ok]] = True
    assert not bool(tot[~rows].any()) and not bool(h[~rows].any())
    if case == "all_unneeded":
        assert not bool(q_ok.any())
        return
    assert bool((tot[rows] > 0).all())
    per_bucket = q_ok.sum(dim=1)
    if case == "sparse_needed_full_bucket":
        assert int(grid.raw_max) > grid.cap and bool((grid.count == grid.cap).any())
        assert int((per_bucket > 0).sum()) < grid.count.numel() // 4
    if case == "two_groups_a_bucket":
        assert int(per_bucket.max()) > 2 * kspfh._GRID_GROUP
