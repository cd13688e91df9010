"""mapmerge_torch's mesh, sharded merge and multi-rank node against the
port's own single-rank path and mapmerge_tpu/parallel/, on the CPU.

Ranks are threads, each with a gloo process group built directly on one
shared HashStore (`device="cpu"`). Tolerances: a sharded merge gives the
transforms and `info_out` of the single-rank merge bit for bit, on every
rank (each pair draws from its own generator, keyed on its index in the
full enumeration); `pad_to_multiple` and `pad_pairs` equal the reference's
exactly. Every thread join has a timeout and every group a collective
timeout, so a stuck collective fails its test instead of hanging.
"""

import datetime
import threading

import numpy as np
import pytest
import torch
from torch.distributed import HashStore, ProcessGroupGloo

from mapmerge_tpu.parallel import mesh as j_mesh
from mapmerge_tpu.parallel import pair_shard as j_pair_shard
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import PointCloud, pad_cloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.io.pcd import write_pcd
from mapmerge_torch.parallel import multihost
from mapmerge_torch.parallel.mesh import make_mesh, pad_to_multiple
from mapmerge_torch.parallel.pair_shard import pad_pairs
from mapmerge_torch.pipeline.merging import estimate_maps_transforms
from mapmerge_torch.runtime.node import MapMergeNode
from mapmerge_torch.runtime.transport import DirectoryTransport
from mapmerge_torch.testing.scene import make_scene, overlapping_views, rotation_z, se3
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

#: tests/test_distributed_node.py's parameters
PARAMS = MergeParams(
    keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
    refine_transform=False, max_points=4096, max_keypoints=128,
    max_neighbors=32, ransac_hypotheses=256, neighbor_tile=256,
)
TRUTHS = (
    se3(rotation_z(0.35), [1.2, -0.5, 0.15]),
    se3(rotation_z(-0.2), [-0.8, 0.6, 0.0]),
)
#: a padded capacity far above the valid points (the JAX package's staged
#: threshold, features.STAGED_THRESHOLD)
BIG_CAPACITY = 1 << 19
JOIN_S = 150.0


@pytest.fixture(scope="module")
def views():
    """Three views of one box scene: a, b (a moved by TRUTHS[0]) and c (a
    moved by TRUTHS[1])."""
    xyz, rgb = make_scene(np.random.default_rng(7), n_boxes=6, extent=8.0, density=40.0)
    va, vb, _ = overlapping_views(np.random.default_rng(3), xyz, rgb, TRUTHS[0], overlap=0.65)
    _, vc, _ = overlapping_views(np.random.default_rng(4), xyz, rgb, TRUTHS[1], overlap=0.65)
    return [va, vb, vc]


def clouds_of(views, capacity=None):
    cap = capacity or max(len(x) for x, _ in views)
    return [PointCloud.from_numpy(x, r, capacity=cap, device="cpu") for x, r in views]


@pytest.fixture(scope="module")
def single(views):
    """The single-rank merge of the three views: (transforms, info_out)."""
    info = {}
    return estimate_maps_transforms(clouds_of(views), PARAMS, info_out=info), info


def run_ranks(world: int, fn) -> list:
    """fn(rank, group) on `world` threads, each a rank of one gloo group;
    the results in rank order. A rank's exception is raised here."""
    store = HashStore()
    results: list = [None] * world
    errors: list = []

    def rank(r: int):
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


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pad_helpers_match_reference():
    for n, d in ((0, 1), (1, 4), (7, 4), (8, 4), (10, 3)):
        assert pad_to_multiple(n, d) == j_mesh.pad_to_multiple(n, d)
    for pairs, d in (([], 2), ([(0, 1)], 4), ([(0, 1), (0, 2), (1, 2)], 2)):
        src, tgt, n = pad_pairs(list(pairs), d)
        j_src, j_tgt, j_n = j_pair_shard.pad_pairs(list(pairs), d)
        assert n == j_n and src.dtype == torch.int32
        np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))


def test_mesh_slots():
    """Item k goes to slot k % (world * n_local): rank slot // n_local,
    device local[slot % n_local]."""
    mesh = make_mesh(["cpu", "cpu"])
    assert (mesh.rank, mesh.world, mesh.size) == (0, 1, 2)
    assert mesh.mine(5) == [0, 1, 2, 3, 4]

    class Group:  # a stand-in with a process group's rank and size
        def __init__(self, rank):
            self._rank = rank

        def rank(self):
            return self._rank

        def size(self):
            return 3

    meshes = [make_mesh(["cpu", "cpu"], Group(r)) for r in range(3)]
    assert [m.size for m in meshes] == [6] * 3
    assert [m.owner(k) for m in meshes[:1] for k in range(8)] == [0, 0, 1, 1, 2, 2, 0, 0]
    assert [m.mine(8) for m in meshes] == [[0, 1, 6, 7], [2, 3], [4, 5]]
    assert [meshes[0].local_index(k) for k in range(8)] == [0, 1] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            make_mesh()


def test_launch_count_under_threads():
    """Rank threads add to one launch count: no launch is lost (more threads
    than cores, a short switch interval)."""
    import sys

    from mapmerge_torch.kernels.build import Kernel

    kernel = Kernel("k", "src", "ref")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [kernel.launched() for _ in range(2000)])
            for _ in range(16)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert kernel.launches == 16 * 2000


def test_multihost_single_process():
    """Alone: initialize is a no-op, the mesh has one rank, and the map
    exchange returns the local maps."""
    multihost.initialize(None, 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    mesh = multihost.global_mesh(["cpu"])
    assert (mesh.world, mesh.group, mesh.devices) == (1, None, (torch.device("cpu"),))
    local = {"r": (np.zeros((2, 3), np.float32), None)}
    assert multihost.allgather_robot_maps(local) == local


def test_sharded_merge_two_ranks_is_bitwise(views, single):
    """Two ranks: clouds 0, 2 on rank 0, cloud 1 on rank 1; the three
    pairs are one chunk of the batched pair stage (dense engine), dealt to
    rank 0; both get the single-rank transforms and info_out, bit for bit
    (tests/test_torch_pairs_batch.py deals several chunks)."""
    want, want_info = single

    def rank(r, group):
        info = {}
        out = estimate_maps_transforms(
            clouds_of(views), PARAMS, mesh=make_mesh(["cpu"], group), info_out=info
        )
        return out, info

    for r, (out, info) in enumerate(run_ranks(2, rank)):
        assert_same(out, want)
        took = info.pop("mesh")
        assert info == want_info
        assert took["rank"] == r and took["gather_s"] > 0
        assert took["clouds"] == [[0, 2], [1]][r]
        assert took["pairs"] == [[(0, 1), (0, 2), (1, 2)], []][r]
    assert want_info["n_pairs"] == 3 and want_info["n_failed"] == 0


def test_one_rank_two_local_devices_is_bitwise(views, single):
    """One rank with two local devices: a thread each, the same bits."""
    want, want_info = single
    info = {}
    out = estimate_maps_transforms(
        clouds_of(views), PARAMS, mesh=make_mesh(["cpu", "cpu"]), info_out=info
    )
    assert_same(out, want)
    took = info.pop("mesh")
    assert info == want_info
    assert took["clouds"] == [0, 1, 2] and took["gather_s"] == 0.0


def test_allgather_robot_maps_union():
    """The union on every rank; on equal names the later rank wins."""
    def rank(r, group):
        local = {f"robot_{r}": (np.full((r + 1, 3), r, np.float32), None),
                 "shared": (np.full((1, 3), r, np.float32), None)}
        if r == 1:
            local = {}  # a rank with nothing still joins
        return multihost.allgather_robot_maps(local, group=group)

    for got in run_ranks(3, rank):
        assert sorted(got) == ["robot_0", "robot_2", "shared"]
        assert got["robot_2"][0].shape == (3, 3)
        assert float(got["shared"][0][0, 0]) == 2.0


def stateless_node(watch, mesh=None):
    """A stateless node over the maps in `watch`, after one discovery, one
    estimation tick and one compositing: (its poses, its merged map's
    points)."""
    node = MapMergeNode(
        DirectoryTransport(str(watch)), PARAMS, mesh=mesh, seed=0, device="cpu"
    )
    node.discovery()
    node.transforms_estimation()
    node.map_compositing()
    return node.get_robots(), node.get_transforms(), int(node.get_merged_map().count)


def test_stateless_node_two_ranks_in_lockstep(views, tmp_path):
    """Per-rank ingest (tests/test_distributed_node.py): each rank's node
    sees one robot through its own DirectoryTransport; the ticks run in
    lockstep. Both ranks hold, bit for bit, the poses of one node that reads
    both maps, and merged maps of that node's size. The poses are gated at
    tests/test_distributed_node.py's 3 deg / 0.2 m for these parameters
    (RANSAC alone, no ICP)."""
    names = ["robot_a", "robot_b"]
    for r, name in enumerate(names):
        for watch in (tmp_path / f"rank{r}", tmp_path / "both"):
            watch.mkdir(exist_ok=True)
            write_pcd(watch / f"{name}.pcd", views[r])

    ranks = run_ranks(2, lambda r, group: stateless_node(
        tmp_path / f"rank{r}", make_mesh(["cpu"], group)))
    robots, alone, n_alone = stateless_node(tmp_path / "both")
    assert robots == names
    for r, (seen, poses, n) in enumerate(ranks):
        assert seen == [names[r]]
        assert sorted(poses) == names and n == n_alone > 1000
        for robot in names:
            np.testing.assert_array_equal(poses[robot], alone[robot])
    rot, trans = ttf.pose_error(np.linalg.inv(alone["robot_a"]) @ alone["robot_b"], TRUTHS[0])
    assert rot < 3.0 and trans < 0.2, (rot, trans)


def test_big_padded_capacity_two_ranks(views, single):
    """The reference's sharded path crashes on a multi-process mesh at the
    staged capacity (mapmerge_tpu/parallel/pair_shard.py:129, a device_put
    to a replicated sharding); here two ranks merge the three clouds padded
    to 2^19, few of whose points are valid, and both get the transforms of
    the unpadded single-rank merge (the voxel grid cuts both to max_points)."""
    clouds = [pad_cloud(c, BIG_CAPACITY) for c in clouds_of(views)]

    def rank(r, group):
        return estimate_maps_transforms(clouds, PARAMS, mesh=make_mesh(["cpu"], group))

    for out in run_ranks(2, rank):
        assert_same(out, single[0])
