"""The dense radius sweeps of mapmerge_torch (kernels E and F: kernels/
radius.py, csrc/radius.cu) on their plain versions, against the JAX
package's dense `radius_count` and `neighbor_moments`.

Kernel E counts, kernel F sums the moments of, each query's members: the
valid points with sq_dists <= r2. Both skip a tile of TILE consecutive
points when neither the box of the warp's queries nor any of its queries
reaches the tile's box (kernels/tiles.tile_bound). Here: the plain versions
against the JAX package on a voxel-ordered cloud with masked, padded and
parked rows; a hypothesis property that a plain model of the cull keeps
exactly the dense members (shuffled and voxel-ordered clouds, lattice
points exactly on the radius), and that a float32 model of F's summation
order (each lane's members in point order, the lanes' parts in a fixed
tree) stays within MOMENTS_RTOL of moments_ref (the resident route's
schedule: tests/test_torch_radius_resident.py models both routes); the
wrappers' card path (stood in for by the meta device: one C call that runs
the order pre-pass and the kernel above the cutoff, and a failure raises);
the outlier and normal stages against the JAX package's on a small scene;
the build key over the headers of csrc/.

The `cuda` cases hold the kernels against their plain versions (E bit for
bit, F within MOMENTS_RTOL and bit for bit the model) and skip here; on a
machine with a GPU: `python -m pytest tests/test_torch_radius_kernels.py -m
cuda --noconftest`.
"""

import contextlib
import shutil
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.core.cloud import PointCloud as TorchCloud
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import radius as kradius
from mapmerge_torch.kernels import tiles as ktiles
from mapmerge_torch.ops import neighbors as tn
from mapmerge_torch.ops.downsample import voxel_downsample

from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

T = ktiles.TILE
#: csrc/radius.cu: lanes that share a query, and so queries a warp
LANES = kradius.LANES
PER_WARP = 32 // LANES


def voxel_cloud(seed=0, n_raw=3000, capacity=4096, masked=150, parked=100):
    """A cloud as the feature stage makes it: points on three planes and a
    box over 6 x 6 m, voxel-downsampled at 0.1 m by the port's own
    voxel_downsample (voxel order, the padding at FAR at the end), then
    `masked` valid points masked in place and `parked` others masked and
    moved to FAR. Returns (xyz, mask) as numpy float32 / bool."""
    rng = np.random.default_rng(seed)
    raw = rng.random((n_raw, 3)).astype(np.float32) * 6.0
    raw[: n_raw // 2, 2] = np.round(raw[: n_raw // 2, 2] / 3.0) * 3.0
    raw[n_raw // 2 :, 0] = np.round(raw[n_raw // 2 :, 0] / 2.0) * 2.0
    cloud = voxel_downsample(TorchCloud.from_numpy(raw, capacity=n_raw, device="cpu"),
                             0.1, out_capacity=capacity)
    xyz, mask = cloud.xyz.numpy().copy(), cloud.mask.numpy().copy()
    live = np.flatnonzero(mask)
    assert len(live) > masked + parked and len(live) < capacity  # padding too
    pick = rng.permutation(live)
    mask[pick[:masked]] = False
    mask[pick[masked : masked + parked]] = False
    xyz[pick[masked : masked + parked]] = FAR
    return xyz, mask


def centred(xyz, mask, q=None):
    """(qc, pc, mask) as torch tensors, centred as ops/neighbors centres."""
    p, m = torch.from_numpy(xyz), torch.from_numpy(mask)
    qc, pc = tn._center(p if q is None else torch.from_numpy(q), p, m)
    return qc.contiguous(), pc.contiguous(), m


def boundary_free(q, p, mask, r, tol=1e-3):
    """Queries with no valid point within `tol` of the radius in d^2: the
    JAX package's matmul expansion of d^2 may put such a pair on the other
    side of it."""
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    return ~((np.abs(d2 - r * r) < tol) & mask[None, :]).any(axis=1)


# ---- the plain versions against the JAX package ----


@pytest.mark.parametrize("r", [0.75, 0.35])
def test_count_ref_matches_jax_radius_count(r):
    """count_ref on the centred cloud, and radius_count (which takes it on
    the CPU), equal the JAX package's dense radius_count exactly on the
    queries clear of the radius (most: the centroids of points on
    voxel-aligned planes), the parked and padded rows 0."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import neighbors as jn

    xyz, mask = voxel_cloud()
    qc, pc, m = centred(xyz, mask)
    got = kradius.count_ref(qc, pc, m, tn._f32(r * r), 256).numpy()
    op, over = tn.radius_count(torch.from_numpy(xyz), torch.from_numpy(xyz), r,
                               p_mask=m, tile=256)
    want, _ = jn.radius_count(jnp.asarray(xyz), jnp.asarray(xyz), r,
                              p_mask=jnp.asarray(mask), tile=256)
    ok = boundary_free(xyz, xyz, mask, r)
    assert ok.mean() > 0.9 and over == 0
    np.testing.assert_array_equal(got, op.numpy())
    np.testing.assert_array_equal(got[ok], np.asarray(want)[ok])
    far = np.abs(xyz).max(-1) >= FAR / 2
    assert far.sum() > 100 and (got[far] == 0).all()


def test_moments_ref_matches_jax_neighbor_moments():
    """moments_ref plus the valid mean, and neighbor_moments (which takes
    it on the CPU), against the JAX package's dense neighbor_moments on the
    queries clear of the radius: counts exactly, mean to 1e-5, covariance to
    1e-4 (tests/test_torch_neighbors.py's tolerances)."""
    import jax.numpy as jnp

    from mapmerge_tpu.ops import neighbors as jn

    r = 0.55
    xyz, mask = voxel_cloud(1)
    qc, pc, m = centred(xyz, mask)
    count, mean, cov = kradius.moments_ref(qc, pc, m, tn._f32(r * r), 256)
    mean = mean + tn._mean(torch.from_numpy(xyz), m)
    op = tn.neighbor_moments(torch.from_numpy(xyz), torch.from_numpy(xyz), r, p_mask=m,
                             tile=256)
    for a, b in zip((count, mean, cov), op[:3]):
        assert torch.equal(a, b)
    jc, jm, jcov, _ = jn.neighbor_moments(jnp.asarray(xyz), jnp.asarray(xyz), r,
                                          p_mask=jnp.asarray(mask), tile=256)
    ok = boundary_free(xyz, xyz, mask, r)
    assert ok.mean() > 0.9 and op[3] == 0
    np.testing.assert_array_equal(count.numpy()[ok], np.asarray(jc)[ok])
    np.testing.assert_allclose(mean.numpy()[ok], np.asarray(jm)[ok], atol=1e-5)
    np.testing.assert_allclose(cov.numpy()[ok], np.asarray(jcov)[ok], atol=1e-4)


# ---- plain models of the kernels ----


def cull_model(qc, pc, mask, r2):
    """The tiles each query's warp visits, (Q, n_tiles) bool: PER_WARP
    consecutive queries a warp; a tile is visited when the gap between the
    box of the warp's queries and the tile's box (squared and summed as
    sq_dists does) is <= r2 and the clamped-box bound of one of its queries
    is too (csrc/radius.cu `members`)."""
    _, boxes = ktiles.pack_ref(pc, None, mask)
    bound = ktiles.tile_bound(qc, boxes)  # (Q, n_tiles)
    lo, hi = boxes[:, 0, :3], boxes[:, 1, :3]
    visited = torch.zeros_like(bound, dtype=torch.bool)
    for w in range(0, qc.shape[0], PER_WARP):
        q = qc[w : w + PER_WARP]
        qlo, qhi = q.amin(0), q.amax(0)
        gap = torch.where(qhi < lo, lo - qhi, torch.where(hi < qlo, qlo - hi, 0.0))
        box = (gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1]) + gap[:, 2] * gap[:, 2]
        visited[w : w + PER_WARP] = (box <= r2) & (bound[w : w + PER_WARP] <= r2).any(0)
    return visited, bound


def members(qc, pc, mask, r2):
    within = tn.sq_dists(qc, pc) <= r2
    return within if mask is None else within & mask[None]


def moments_model(qc, pc, mask, r2):
    """Kernel F's arithmetic in float32 numpy on the members of the tiles
    cull_model visits: lane g of a query sums, in point order, its members
    j = g (mod LANES) (x, y, z and the products p_i * p_j, each rounded
    once); the LANES parts are added in the kernel's tree; then denom =
    max(count, 1), mean = s1 / denom, cov = s2 / denom - mean_i * mean_j.
    Returns (count, mean, cov) as torch tensors."""
    visited, _ = cull_model(qc, pc, mask, r2)
    tile_of = torch.arange(pc.shape[0]) // T
    taken = (members(qc, pc, mask, r2) & visited[:, tile_of]).numpy()
    pad = -pc.shape[0] % T  # the last tile's rows past P: never members
    taken = np.pad(taken, ((0, 0), (0, pad)))
    p = np.pad(pc.numpy(), ((0, pad), (0, 0)))
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    terms = (x, y, z, x * x, x * y, x * z, y * y, y * z, z * z)
    # lane g's part: its points j = g (mod LANES), summed in order
    nq, zero = taken.shape[0], np.float32(0.0)
    shape = (nq, len(p) // LANES, LANES)
    parts = [np.add.accumulate(np.where(taken, v[None], zero).reshape(shape), axis=1,
                               dtype=np.float32)[:, -1] for v in terms]
    while parts[0].shape[1] > 1:  # lane g adds lane g ^ o's part: o = 1, 2, 4, ...
        parts = [a[:, 0::2] + a[:, 1::2] for a in parts]
    s = [a[:, 0] for a in parts]
    n = taken.sum(1).astype(np.float32)
    denom = np.maximum(n, np.float32(1.0))
    m = np.stack([s[k] / denom for k in range(3)], 1)
    slot = ((3, 4, 5), (4, 6, 7), (5, 7, 8))
    cov = np.stack([np.stack([s[slot[i][j]] / denom - m[:, i] * m[:, j] for j in range(3)], 1)
                    for i in range(3)], 1)
    return torch.from_numpy(n), torch.from_numpy(m), torch.from_numpy(cov)


@st.composite
def radius_cases(draw):
    """A cloud of 1-120 points, in voxel order (sorted by 0.25 m keys, x
    first) or shuffled, with a ragged mask and a masked tail parked at FAR;
    on a 0.25 m lattice with a radius of 1-3 steps (many pairs exactly on
    it) or at random with a random radius; queries: some of the points, some
    at FAR, some new."""
    n = draw(st.integers(1, 120))
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
            r2)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(radius_cases())
def test_cull_keeps_exactly_the_dense_members(case):
    """Every member lies in a tile that its query's clamped-box bound and
    its warp's query box both reach, so the tiles the kernels visit hold
    every pair count_ref counts: the model's count equals count_ref, and the
    model of F's summation order has moments_ref's count exactly and its
    mean and covariance within MOMENTS_RTOL of each query's largest second
    moment."""
    q, p, mask, r2 = case
    within = members(q, p, mask, r2)
    visited, bound = cull_model(q, p, mask, r2)
    tile_of = torch.arange(p.shape[0]) // T
    assert torch.equal(within & (bound[:, tile_of] <= r2), within)
    assert torch.equal(within & visited[:, tile_of], within)
    want = kradius.count_ref(q, p, mask, r2, 16)
    assert torch.equal((within & visited[:, tile_of]).sum(1).to(torch.int32), want)
    got, ref = moments_model(q, p, mask, r2), kradius.moments_ref(q, p, mask, r2, 16)
    assert torch.equal(got[0], ref[0])
    _, rel = kradius.moments_error(got, ref)
    assert rel <= kradius.MOMENTS_RTOL
    parked = q.abs().amax(-1) >= FAR / 2
    assert not bool((bound[parked] <= r2).any()) and not bool(want[parked].any())


@pytest.mark.parametrize("order", ["voxel order", "shuffled"])
def test_cull_model_on_a_lattice_on_the_radius(order):
    """A full 0.25 m lattice (12 x 12 x 3 points) at r = 0.5 m: every point
    has neighbours at d2 == r2 exactly, which count (d2 <= r2); in voxel
    order the warps visit a small share of the tiles, shuffled nearly all,
    and both models keep every member."""
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3), indexing="ij"), -1)
    p = (g.reshape(-1, 3).astype(np.float32) - 6.0) * np.float32(0.25)
    if order == "shuffled":
        p = p[np.random.default_rng(0).permutation(len(p))]
    p = torch.from_numpy(np.ascontiguousarray(p))
    mask = torch.ones(p.shape[0], dtype=torch.bool)
    r2 = 0.25
    d2 = tn.sq_dists(p, p)
    assert int((d2 == r2).sum()) > 1000
    want = kradius.count_ref(p, p, mask, r2, 64)
    assert torch.equal(want, (d2 <= r2).sum(1).to(torch.int32))
    assert int(want.min()) >= 11  # the point, 4-6 at 0.25 m, more at 0.35 and 0.5 m
    visited, _ = cull_model(p, p, mask, r2)
    share = float(visited.double().mean())
    assert (share < 0.5) if order == "voxel order" else (share > 0.8)
    got, ref = moments_model(p, p, mask, r2), kradius.moments_ref(p, p, mask, r2, 64)
    assert torch.equal(got[0], ref[0])
    assert kradius.moments_error(got, ref)[1] <= kradius.MOMENTS_RTOL


# ---- the wrappers ----


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere():
    """On CPU tensors `count` and `moments` are count_ref and moments_ref
    (the same bits, no launch counted); a tensor on another device than the
    CPU or a card raises, before any build; so do no points."""
    xyz, mask = voxel_cloud(2, n_raw=800, capacity=1024, masked=20, parked=20)
    qc, pc, m = centred(xyz, mask)
    launches = (kradius.COUNT_KERNEL.launches, kradius.MOMENTS_KERNEL.launches)
    r2 = tn._f32(0.36)
    assert torch.equal(kradius.count(qc, pc, m, r2, 128), kradius.count_ref(qc, pc, m, r2))
    for a, b in zip(kradius.moments(qc, pc, m, r2, 128), kradius.moments_ref(qc, pc, m, r2)):
        assert torch.equal(a, b)
    assert launches == (kradius.COUNT_KERNEL.launches, kradius.MOMENTS_KERNEL.launches)
    meta = [a.to("meta") for a in (qc, pc, m)]
    with pytest.raises(ValueError, match="radius_count: unsupported device meta"):
        kradius.count(*meta, r2)
    with pytest.raises(ValueError, match="radius_moments: unsupported device meta"):
        kradius.moments(*meta, r2)
    assert kradius.count(qc[:0], pc, m, r2).shape == (0,)
    assert [a.shape for a in kradius.moments(qc[:0], pc, m, r2)] == [(0,), (0, 3), (0, 3, 3)]


def test_moments_error_scales_by_each_querys_second_moment():
    """moments_error: the largest absolute difference, and each query's
    difference over its largest |cov + mean mean^T| entry of the reference
    (0 where both agree, inf where a query with no second moment differs)."""
    ref = (torch.tensor([2.0, 0.0]), torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]),
           torch.zeros((2, 3, 3)))
    ref[2][0, 1, 1] = 3.0  # second moments of query 0: xx 1, yy 3
    got = (ref[0], ref[1].clone(), ref[2].clone())
    got[2][0, 0, 0] += 6e-5
    assert kradius.moments_error(got, ref) == (pytest.approx(6e-5), pytest.approx(2e-5))
    got[1][1, 2] = 1e-9
    assert kradius.moments_error(got, ref)[1] == float("inf")


def test_moments_error_takes_the_mean_over_the_root_of_the_second_moment():
    """moments_error without an origin (F's centred frame): the mean's
    difference over the square root of |cov + mean mean^T|, in full (no
    float32 step is taken off: nothing was added to F's mean)."""
    ref = (torch.tensor([2.0]), torch.tensor([[2.0, 0.0, 0.0]]), torch.zeros((1, 3, 3)))
    got = (ref[0], ref[1] + torch.tensor([2.0**-14, 0.0, 0.0]), ref[2])  # S = 4
    assert kradius.moments_error(got, ref) == (2.0**-14, 2.0**-15)


@pytest.mark.parametrize("entry", ["count", "moments"])
def test_card_path_packs_then_launches_and_raises_on_a_failure(monkeypatch, entry):
    """On the card's path (stood in for by the meta device, no data) a call
    above the resident cutoff is one C call that runs E's and F's own order
    pre-pass and then the kernel: one launch of each counted, none of SIFT's
    tile pre-pass (tiles_pack); a C call that returns a CUDA error raises
    under the kernel's name; a failed build raises. No route gives the
    plain version."""
    meta = torch.device("meta")
    n = kradius.RESIDENT_MAX_POINTS + 1
    p = torch.empty((n, 3), device=meta)
    q = torch.empty((64, 3), device=meta)
    mask = torch.ones((n,), dtype=torch.bool, device=meta)
    kernel = {"count": kradius.COUNT_KERNEL, "moments": kradius.MOMENTS_KERNEL}[entry]
    fn = f"mm_radius_{entry}"

    def call():
        return getattr(kradius, entry)(q, p, mask, 0.36)

    monkeypatch.setattr(build, "cuda_device", lambda kernel, x: x.device)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: 0}))
    counts = (ktiles.PACK_KERNEL, kradius.ORDER_KERNEL, kernel)
    before = [k.launches for k in counts]
    call()
    assert [k.launches for k in counts] == [before[0], before[1] + 1, before[2] + 1]

    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        **{fn: lambda *args: 700}))
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed with error 700"):
        call()

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call()


# ---- the stages against the JAX package ----


def test_outliers_and_normals_match_the_jax_package():
    """remove_outliers and compute_surface_normals, which take kernels E and
    F's plain versions on the CPU, against the JAX package's on the small
    scene's voxel cloud: the outlier mask equal on the points clear of the
    radius; normals' valid flags within 0.2%, unit normals to 2e-3 up to
    sign (tests/test_torch_preprocess.py's tolerances)."""
    from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
    from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
    from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
    from mapmerge_torch.ops.normals import compute_surface_normals as t_normals
    from mapmerge_torch.ops.outliers import remove_outliers as t_outliers

    from torch_parity import both_clouds, small_scene

    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, tc = both_clouds(a_xyz, a_rgb, capacity=cap)
    jc, tc = j_voxel(jc, 0.1, out_capacity=4096), voxel_downsample(tc, 0.1, out_capacity=4096)
    r = 0.35
    jo, to = j_outliers(jc, r, 10, tile=512), t_outliers(tc, r, 10, tile=512)
    xyz, mask = tc.xyz.numpy(), tc.mask.numpy()
    ok = boundary_free(xyz, xyz, mask, r, tol=1e-4)  # centred float32: errors ~1e-6
    assert ok.mean() > 0.9 and 0.05 < (mask & ~to.mask.numpy()).sum() / mask.sum() < 0.5
    np.testing.assert_array_equal(to.mask.numpy()[ok], np.asarray(jo.mask)[ok])
    jn_, tn_ = j_normals(jo, 0.6, tile=512), t_normals(to, 0.6, tile=512)
    jv, tv = np.asarray(jn_.valid), tn_.valid.numpy()
    assert (jv != tv).mean() <= 0.002 and tv.sum() > 1000
    both = jv & tv
    dots = np.abs((tn_.normals.numpy()[both] * np.asarray(jn_.normals)[both]).sum(-1))
    np.testing.assert_allclose(dots, 1.0, atol=2e-3)


# ---- the build key ----


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """A kernel library's build key covers every csrc/*.cuh: on a copy of
    csrc/, an edit to cull.cuh moves the path of every .cu that may include
    it, and not the host library's; the radius kernels are registered."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    assert "radius.cu" in build.KERNEL_SOURCES
    assert set(build.SOURCES["radius.cu"]) == {"mm_radius_count", "mm_radius_moments",
                                               "mm_radius_order"}
    sources = build.KERNEL_SOURCES + build.HOST_SOURCES
    before = {s: build.library_path(s) for s in sources}
    header = csrc / "cull.cuh"
    header.write_bytes(header.read_bytes() + b"\n// an edit\n")
    after = {s: build.library_path(s) for s in sources}
    for s in build.KERNEL_SOURCES:
        assert after[s] != before[s] and after[s].parent == tmp_path / "build"
    for s in build.HOST_SOURCES:
        assert after[s] == before[s]
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert build.library_path("radius.cu") != after["radius.cu"]


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_case(case):
    """(qc, pc, mask, r2) on the CPU for an adversarial case."""
    r2 = tn._f32(0.64)
    if case == "lattice on the radius":
        g = np.stack(np.meshgrid(np.arange(40), np.arange(40), np.arange(3),
                                 indexing="ij"), -1).reshape(-1, 3)
        p = torch.from_numpy((g.astype(np.float32) - 20.0) * np.float32(0.25))
        return p, p.clone(), torch.ones(p.shape[0], dtype=torch.bool), 0.25
    xyz, mask = voxel_cloud(21, n_raw=6000, capacity=8192)
    if case == "shuffled":
        perm = np.random.default_rng(1).permutation(len(xyz))
        xyz, mask = xyz[perm], mask[perm]
    if case == "all masked":
        mask = np.zeros_like(mask)
    if case == "one tile":
        xyz, mask = xyz[:20], mask[:20]
    qc, pc, m = centred(xyz, mask)
    if case == "other queries":  # not the cloud's own points: a moved subset
        qc = (qc[::7] + torch.tensor([0.05, -0.03, 0.01])).contiguous()
    return qc, pc, m, r2


CARD_CASES = ["voxel order", "shuffled", "all masked", "one tile", "other queries",
              "lattice on the radius"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_count_kernel_equals_count_ref(cuda, case):
    """Kernel E bit for bit count_ref (parked queries 0), one launch a call
    and no pre-pass (these clouds take the resident route)."""
    qc, pc, m, r2 = card_case(case)
    want = kradius.count_ref(qc, pc, m, r2)
    qc, pc, m = (a.to(cuda) for a in (qc, pc, m))
    before = (kradius.COUNT_KERNEL.launches, ktiles.PACK_KERNEL.launches,
              kradius.ORDER_KERNEL.launches)
    got = kradius.count(qc, pc, m, r2)
    assert (kradius.COUNT_KERNEL.launches, ktiles.PACK_KERNEL.launches,
            kradius.ORDER_KERNEL.launches) == (before[0] + 1, before[1], before[2])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_moments_kernel_within_tolerance_and_repeating(cuda, case):
    """Kernel F: moments_ref's count exactly, mean and covariance within
    MOMENTS_RTOL, bit for bit the float32 model of its summation order and
    bit for bit again on a second launch."""
    qc, pc, m, r2 = card_case(case)
    want, model = kradius.moments_ref(qc, pc, m, r2), moments_model(qc, pc, m, r2)
    on_card = [a.to(cuda) for a in (qc, pc, m)]
    got = [a.cpu() for a in kradius.moments(*on_card, r2)]
    again = [a.cpu() for a in kradius.moments(*on_card, r2)]
    assert torch.equal(got[0], want[0])
    assert kradius.moments_error(got, want)[1] <= kradius.MOMENTS_RTOL
    for a, b, c in zip(got, again, model):
        assert torch.equal(a, b) and torch.equal(a, c)
