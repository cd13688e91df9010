"""The batched pair stage of mapmerge_torch against the JAX package's
`estimate_pairs_batch` and against the port's own one-pair path, on the CPU.

Tolerances: the batched plain 1-NN is `nearest_neighbor_ref` pair by pair,
bit for bit (on the card the kernel's batched entry is held bit for bit
against both, in the `cuda` case); `estimate_pairs_batch` on the reference's
features and hypothesis draws gives the reference's poses within 0.05 deg /
5 mm with equal flags (the tolerance of
test_torch_registration.py::test_reference_features_carried_across);
`icp_refine` over a pair axis gives its one-pair flags and iteration counts
and its poses within 1e-3 deg / 1e-4 m on pairs that converge; SAC-IA in a batch
gives the one-pair transforms within 1e-5 and the same flags and counts; a
merge dealt in several chunks over two thread ranks gives the single-rank
transforms and info_out bit for bit, and the one-pair route's ok flags and
poses within PAIR_TOL.
"""

import dataclasses
import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed import HashStore, ProcessGroupGloo

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.ops.matching import find_correspondences as j_match
from mapmerge_tpu.ops.ransac import _sample_hypotheses
from mapmerge_tpu.pipeline.features import extract_features as j_features
from mapmerge_tpu.pipeline.merging import estimate_pairs_batch as j_pairs_batch
from mapmerge_torch import convert
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.kernels import nn as knn
from mapmerge_torch.ops import icp, neighbors
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.sacia import sacia_transform
from mapmerge_torch.parallel import pair_shard
from mapmerge_torch.parallel.mesh import make_mesh
from mapmerge_torch.pipeline import merging
from mapmerge_torch.pipeline.registration import estimate_pairs_batch
from mapmerge_torch.testing.scene import make_scene, overlapping_views, rotation_z, se3

from torch_parity import SLICE_PARAMS, port_params, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

JOIN_S = 150.0
#: a pair's batched pose against its one-pair pose (deg, m). The two round
#: the 3x3 products of Kabsch and the sums over the points differently (bmm
#: against mm, a reduction over a batch row); an ICP that converges shrinks
#: that to ~1e-5 deg, one that runs to its iteration cap ends wherever its
#: oscillation stands, which the rounding moves. The largest gap seen is
#: 0.040 deg / 1.9 mm (config5's and config #4's first pairs on an H100,
#: chip_smoke.py) and 0.040 deg / 0.04 mm (this file's merge on the CPU); the
#: limit is a few times that, well under bench.py's 1 deg / 0.1 m pose
#: gate. chip_smoke.py holds the card's pairs to the same tolerance.
PAIR_TOL = (0.2, 0.02)


def _nn_case(rng, b=4, nq=37, np_=53):
    """Clustered points on a 1/8 lattice (many exact ties), ragged masks,
    the last pair's targets all masked."""
    q = np.round(rng.random((b, nq, 3)) * 24) / 8
    p = np.round(rng.random((b, np_, 3)) * 24) / 8
    mask = rng.random((b, np_)) > rng.random((b, 1))
    mask[-1] = False
    return (torch.from_numpy(q.astype(np.float32)), torch.from_numpy(p.astype(np.float32)),
            torch.from_numpy(mask))


def test_batched_plain_nn_is_the_one_pair_version_pair_by_pair(rng):
    q, p, mask = _nn_case(rng)
    before = knn.BATCHED_KERNEL.launches
    idx, d2 = knn.nearest_neighbor_batched(q, p, mask)
    assert knn.BATCHED_KERNEL.launches == before  # the CPU takes the plain version
    assert idx.shape == d2.shape == (4, 37) and idx.dtype == torch.int32
    for b in range(4):
        ri, rd = knn.nearest_neighbor_ref(q[b], p[b], mask[b])
        assert torch.equal(idx[b], ri) and torch.equal(d2[b], rd)
    assert bool((d2[-1] >= 1e11).all())  # a fully masked target: the penalty
    # ties: every target equidistant -> the first index
    ti, td = knn.nearest_neighbor_batched(torch.zeros((2, 5, 3)), torch.ones((2, 9, 3)))
    assert bool((ti == 0).all()) and bool((td == 3.0).all())
    # no mask is every target valid
    ui, ud = knn.nearest_neighbor_batched(q, p)
    assert torch.equal(ud[0], knn.nearest_neighbor_ref(q[0], p[0])[1])


def test_batched_dense_nn_refuses_the_grid(monkeypatch):
    q = torch.zeros((2, 4, 3))
    monkeypatch.setattr(neighbors, "GRID_NN_THRESHOLD", 4)
    with pytest.raises(ValueError, match="grid"):
        neighbors.nearest_neighbor_batch(q, q, bound=1.0)
    _, d2, over = neighbors.nearest_neighbor_batch(q, q)  # no bound: dense
    assert over == 0 and bool((d2 == 0).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_kernel_is_the_plain_version_and_the_single_kernel(cuda):
    """One launch for the batch; each pair's row bit for bit the plain
    version's and the unbatched kernel's on that pair alone."""
    rng = np.random.default_rng(5)
    for b, nq, np_ in ((3, 4100, 4099), (1, 513, 70001), (40, 257, 1023)):
        q, p, mask = (x.to(cuda) for x in _nn_case(rng, b, nq, np_))
        before = knn.BATCHED_KERNEL.launches
        idx, d2 = knn.nearest_neighbor_batched(q, p, mask)
        assert knn.BATCHED_KERNEL.launches == before + 1
        ri, rd = knn.nearest_neighbor_batched_ref(q, p, mask)
        assert torch.equal(idx, ri) and torch.equal(d2, rd)
        for k in range(b):
            si, sd = knn.nearest_neighbor(q[k], p[k], mask[k])
            assert torch.equal(idx[k], si) and torch.equal(d2[k], sd)
    with pytest.raises(ValueError):
        knn.nearest_neighbor_batched(q, p.cpu(), mask)


@pytest.fixture(scope="module")
def reference_pairs():
    """The slice scene's two views through the JAX feature stage, both
    directions registered by the JAX package's estimate_pairs_batch, and
    the port's estimate_pairs_batch on those features carried across, fed
    the reference's hypothesis draws for each pair's key."""
    va, vb, cap, truth = small_scene()
    jf = [j_features(JaxCloud.from_arrays(xyz, rgb, capacity=cap), SLICE_PARAMS)
          for xyz, rgb in (va, vb)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jf)
    src, tgt = [1, 0], [0, 1]
    keys = jax.random.split(jax.random.key(11), 2)
    jest = j_pairs_batch(stacked, jnp.asarray(src, jnp.int32), jnp.asarray(tgt, jnp.int32),
                         SLICE_PARAMS, keys)
    samples = []
    for k, (i, j) in enumerate(zip(src, tgt)):
        corr = j_match(
            jf[i].descriptors.data, jf[j].descriptors.data, SLICE_PARAMS.matching_k,
            jf[i].descriptors.valid & jf[i].keypoints.mask,
            jf[j].descriptors.valid & jf[j].keypoints.mask,
        )
        samples.append(np.asarray(
            _sample_hypotheses(keys[k], corr.valid, SLICE_PARAMS.ransac_hypotheses)))
    tf_ = convert.features_from_numpy(jax.tree_util.tree_map(np.asarray, stacked), "cpu")
    sources = merging.stack_features([_item(tf_, i) for i in src])
    targets = merging.stack_features([_item(tf_, j) for j in tgt])
    test = estimate_pairs_batch(sources, targets, port_params(SLICE_PARAMS),
                                samples=t(np.stack(samples)))
    return jest, test, truth


def _item(obj, b):
    """Item b of stacked features."""
    if torch.is_tensor(obj):
        return obj[b]
    return dataclasses.replace(obj, **{
        f.name: _item(getattr(obj, f.name), b) for f in dataclasses.fields(obj)
    })


def test_pairs_batch_matches_reference_estimate_pairs_batch(reference_pairs):
    """Both directions of the pair: the reference's poses within 0.05 deg /
    5 mm, the same ok and ambiguity flags and inlier counts, coverage to
    0.01, and each within 1 deg / 0.1 m of the truth."""
    jest, test, truth = reference_pairs
    assert test.transform.shape == (2, 4, 4) and test.ok.shape == (2,)
    np.testing.assert_array_equal(test.ok.numpy(), np.asarray(jest.ok))
    np.testing.assert_array_equal(test.inlier_count.numpy(), np.asarray(jest.inlier_count))
    np.testing.assert_array_equal(test.ambiguous().numpy(), np.asarray(jest.ambiguous()))
    np.testing.assert_allclose(test.coverage.numpy(), np.asarray(jest.coverage), atol=0.01)
    np.testing.assert_allclose(test.support.numpy(), np.asarray(jest.support), atol=1e-6)
    assert bool(test.ok.all())
    for k, want in enumerate((truth, np.linalg.inv(truth))):
        rot, trans = ttf.pose_error(test.transform[k].numpy(), np.asarray(jest.transform[k]))
        assert rot < 0.05 and trans < 0.005
        rot, trans = ttf.pose_error(test.transform[k].numpy(), want)
        assert rot < 1.0 and trans < 0.1


@pytest.fixture(scope="module")
def icp_clouds():
    """The slice scene's views downsampled as the feature stage does."""
    va, vb, cap, truth = small_scene()
    clouds = [voxel_downsample(PointCloud.from_numpy(x, r, capacity=cap, device="cpu"),
                               0.1, out_capacity=4096) for x, r in (va, vb)]
    return clouds, truth


#: the ladder's floor at 0.5 m: the starts below converge after 7, 13 and
#: 17 iterations
ICP_ARGS = dict(max_correspondence_distance=1.0, outlier_rejection_threshold=0.5,
                max_iterations=30, transform_epsilon=1e-2,
                min_correspondence_distance=0.5)


def test_icp_batch_is_icp_refine_pair_by_pair(icp_clouds, monkeypatch):
    """Starts at three distances from the truth and a zero guess: the pairs
    stop at different iterations, each with icp_refine's flag and
    iteration count, its pose within 1e-3 deg / 1e-4 m; the zero guess
    never converges and keeps its transform."""
    (ca, cb), truth = icp_clouds
    inits = [se3(rotation_z(0.4 + d), [1.5 - d, -0.7 + d, 0.2]) for d in (0.0, 0.08, 0.15)]
    inits = [torch.from_numpy(x) for x in inits] + [torch.zeros(4, 4)]
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return neighbors.nearest_neighbor(*args, **kwargs)

    monkeypatch.setattr(icp, "nearest_neighbor", counting)
    alone = []
    for init in inits:
        calls.clear()
        got, ok, _ = icp.icp_refine(cb, ca, init, **ICP_ARGS)
        alone.append((got, ok, len(calls)))
    n = len(inits)
    sources = merging.stack_features([cb] * n)
    targets = merging.stack_features([ca] * n)
    calls.clear()
    info = {}
    out, ok, over = icp.icp_refine(sources, targets, torch.stack(inits), info_out=info,
                                   **ICP_ARGS)
    iters = info["iterations"]
    assert out.shape == (n, 4, 4) and calls == [] and over.tolist() == [0] * n
    assert ok.tolist() == [a[1] for a in alone] == [True, True, True, False]
    assert iters.tolist() == [a[2] for a in alone]
    assert len(set(iters.tolist())) == 4  # they stop at different iterations
    for k in range(3):
        rot, trans = ttf.pose_error(out[k].numpy(), alone[k][0].numpy())
        assert rot < 1e-3 and trans < 1e-4
        rot, trans = ttf.pose_error(out[k].numpy(), truth)
        assert rot < 0.5 and trans < 0.05
    assert torch.equal(out[3], alone[3][0])


def test_sacia_batch_is_the_one_pair_call(rng):
    """Three pairs of keypoint sets with their own generators: each pair's
    draws, transform (1e-5), flag and inlier count of the one-pair call."""
    from mapmerge_torch.ops.descriptors.base import Descriptors
    from mapmerge_torch.ops.keypoints import Keypoints

    truth = se3(rotation_z(0.3), [0.5, -0.2, 0.1])  # the targets' frame

    def side(xyz, desc, valid):
        n = len(xyz)
        return (Keypoints(xyz=t(xyz), response=torch.ones(n), mask=t(valid),
                          truncated=torch.zeros((), dtype=torch.int32)),
                Descriptors(data=t(desc), valid=t(valid)))

    pairs = []
    for _ in range(3):
        xyz = (rng.random((60, 3)) * 8).astype(np.float32)
        desc = rng.random((60, 33)).astype(np.float32)
        moved = (xyz @ truth[:3, :3].T + truth[:3, 3]).astype(np.float32)
        valid = rng.random(60) > 0.15
        pairs.append((side(xyz, desc, valid), side(moved, desc, np.ones(60, bool))))
    args = dict(min_sample_distance=0.3, max_correspondence_distance=0.5, num_iterations=64)
    alone = [sacia_transform(*s, *d, generator=torch.Generator().manual_seed(k), **args)
             for k, (s, d) in enumerate(pairs)]
    stack = merging.stack_features
    skp, sd = stack([s[0] for s, _ in pairs]), stack([s[1] for s, _ in pairs])
    tkp, td = stack([d[0] for _, d in pairs]), stack([d[1] for _, d in pairs])
    out, ok, inl = sacia_transform(
        skp, sd, tkp, td, generator=[torch.Generator().manual_seed(k) for k in range(3)], **args)
    assert out.shape == (3, 4, 4)
    for k, (a_t, a_ok, a_inl) in enumerate(alone):
        assert bool(ok[k]) == bool(a_ok) and int(inl[k]) == int(a_inl)
        np.testing.assert_allclose(out[k].numpy(), a_t.numpy(), atol=1e-5)
    assert bool(ok.all())


#: three views of one box scene, registered with ICP
MERGE_PARAMS = MergeParams(
    keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
    refine_transform=True, max_iterations=15, max_points=4096, max_keypoints=128,
    max_neighbors=32, ransac_hypotheses=256, neighbor_tile=256,
)


@pytest.fixture(scope="module")
def three_clouds():
    """Views a, b (a moved by one pose) and c (a moved by another)."""
    xyz, rgb = make_scene(np.random.default_rng(7), n_boxes=6, extent=8.0, density=40.0)
    va, vb, _ = overlapping_views(np.random.default_rng(3), xyz, rgb,
                                  se3(rotation_z(0.35), [1.2, -0.5, 0.15]), overlap=0.65)
    _, vc, _ = overlapping_views(np.random.default_rng(4), xyz, rgb,
                                 se3(rotation_z(-0.2), [-0.8, 0.6, 0.0]), overlap=0.65)
    cap = max(len(x) for x, _ in (va, vb, vc))
    return [PointCloud.from_numpy(x, r, capacity=cap, device="cpu") for x, r in (va, vb, vc)]


def run_ranks(world, fn):
    store = HashStore()
    results, errors = [None] * world, []

    def rank(r):
        try:
            group = ProcessGroupGloo(store, r, world, datetime.timedelta(seconds=JOIN_S))
            results[r] = fn(r, group)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads), "a rank is stuck"
    if errors:
        raise errors[0]
    return results


def test_merge_in_several_chunks_is_bitwise_over_two_ranks(three_clouds, monkeypatch):
    """Chunks of two pairs (PAIR_CHUNK_POINTS cut to two clouds' points):
    three pairs in two chunks, batched once a chunk with one packed fetch;
    two thread ranks deal the chunks (one each) and both get the
    single-rank transforms and info_out bit for bit. The pairs also agree
    with the one-pair route (the grid threshold lowered so that every pair
    registers alone) in their ok flags and within PAIR_TOL."""
    monkeypatch.setattr(merging, "PAIR_CHUNK_POINTS", 2 * 4096)
    chunks = []
    real_chunk = merging.register_chunk

    def counted(sources, targets, params, seed, pairs):
        chunks.append([(i, j) for _, i, j in pairs])
        return real_chunk(sources, targets, params, seed, pairs)

    monkeypatch.setattr(merging, "register_chunk", counted)
    info = {}
    single = merging.estimate_maps_transforms(three_clouds, MERGE_PARAMS, info_out=info)
    assert chunks == [[(0, 1), (0, 2)], [(1, 2)]]
    assert info["n_pairs"] == 3 and info["n_failed"] == 0 and len(single) == 3

    def rank(r, group):
        out_info = {}
        out = merging.estimate_maps_transforms(
            three_clouds, MERGE_PARAMS, mesh=make_mesh(["cpu"], group), info_out=out_info)
        return out, out_info

    for r, (out, out_info) in enumerate(run_ranks(2, rank)):
        assert len(out) == len(single)
        for a, b in zip(out, single):
            np.testing.assert_array_equal(a, b)
        took = out_info.pop("mesh")
        assert out_info == info
        assert took["pairs"] == [[(0, 1), (0, 2)], [(1, 2)]][r]

    monkeypatch.setattr(merging, "GRID_NN_THRESHOLD", 1)  # the one-pair route
    chunks.clear()
    one_by_one = merging.estimate_maps_transforms(three_clouds, MERGE_PARAMS)
    assert chunks == []
    for a, b in zip(single, one_by_one):
        assert a.any() == b.any()
        if a.any():
            rot, trans = ttf.pose_error(a, b)
            assert rot <= PAIR_TOL[0] and trans <= PAIR_TOL[1]


def test_route_and_chunk_size(three_clouds, monkeypatch):
    """The chunk size follows the capacity and the params alone; the batch
    refuses clouds that take the grid 1-NN."""
    f = merging.extract_features_batch(three_clouds[:1], MERGE_PARAMS)
    assert f.cloud.xyz.shape == (1, 4096, 3)
    one = pair_shard.extract_features_sharded(three_clouds[:1], MERGE_PARAMS,
                                              make_mesh(["cpu"]))[0]
    assert torch.equal(f.descriptors.data[0], one.descriptors.data)  # the merge's stage
    # min(2^20 / 4096 points, 2^24 / (256 hypotheses x 128 keypoints))
    assert merging.pair_chunk_size(f, MERGE_PARAMS) == 256
    sacia = MERGE_PARAMS.replace(estimation_method="SAC_IA", sacia_hypotheses=4096)
    assert merging.pair_chunk_size(f, sacia) == 32
    batch = merging.extract_features_batch(three_clouds[:2], MERGE_PARAMS)
    monkeypatch.setattr(neighbors, "GRID_NN_THRESHOLD", 16)
    with pytest.raises(ValueError, match="grid"):
        estimate_pairs_batch(batch, batch, MERGE_PARAMS, generators=[None, None])
