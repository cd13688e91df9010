"""mapmerge_torch's online node and its launcher against mapmerge_tpu's
runtime/node.py and tools/node_cli.py, on the CPU (`device="cpu"`).

Tolerances: the capacity subsample draws the same indices exactly; the
launcher resolves the same MergeParams exactly; the stateless node gives
bit for bit the poses of the port's own estimate_maps_transforms on the
clouds it builds; the incremental stream (4 town views at max_points 4096,
through DirectoryTransport) puts every map within 2 deg / 0.2 m of the
truth, relative to the first map.
"""

import json
import threading

import numpy as np
import pytest
import torch

from mapmerge_tpu.core.params import MergeParams as JParams
from mapmerge_tpu.runtime.node import MapMergeNode as JNode
from mapmerge_tpu.runtime.transport import InProcTransport as JInProc
from mapmerge_tpu.tools import node_cli as jcli
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.io.pcd import write_pcd
from mapmerge_torch.pipeline.merging import estimate_maps_transforms
from mapmerge_torch.runtime.node import MapMergeNode
from mapmerge_torch.runtime.transport import DirectoryTransport, InProcTransport
from mapmerge_torch.testing.scene import town_views
from mapmerge_torch.tools import node_cli as tcli

from torch_parity import SLICE_PARAMS, port_params, rel_pose, small_scene


#: the stateless node's parameters: the slice test's with Harris + PFH at
#: max_points 4096 (SIFT's dense scale space is most of a CPU merge)
NODE_PARAMS = SLICE_PARAMS.replace(
    keypoint_type="HARRIS", keypoint_threshold=1.0, descriptor_type="PFH",
    max_points=4096, max_keypoints=128, ransac_hypotheses=256, max_iterations=20,
)


@pytest.fixture(scope="module")
def two_views():
    va, vb, _, truth = small_scene()
    return va, vb, truth


def test_fit_to_capacity_matches_reference(two_views):
    """Over capacity, the node keeps a uniform random subsample drawn from
    crc32(robot/seed): the reference's indices exactly, with every
    dropped point counted."""
    (ax, argb), _, _ = two_views
    order = np.argsort(ax[:, 0])  # a head cut would keep only low x
    ax, argb = ax[order], argb[order]
    for seed, robot in ((0, "robot_a"), (7, "r1")):
        t = MapMergeNode(InProcTransport(), seed=seed, device="cpu")
        j = JNode(JInProc(), seed=seed)
        got, ref = t._fit_to_capacity(ax, argb, 1000, robot), j._fit_to_capacity(ax, argb, 1000, robot)
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == ref[2] == len(ax) - 1000
        assert got[0][:, 0].max() > ax[:, 0].max() - 0.5
    x, r, n = t._fit_to_capacity(ax, None, len(ax), "r")
    assert x is ax and r is None and n == 0


def test_default_device_is_the_card():
    """Without a card, a node built with no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is that card")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        MapMergeNode(InProcTransport())


ARGV = [
    "--watch-dir", "maps", "--estimation-rate", "0.5", "--keypoint_type",
    "HARRIS", "--max_points", "2048", "--refine_transform", "false",
    "--matching_k", "0", "--unknown", "1",
]


@pytest.mark.parametrize("fmt", ["json", "yaml", None])
def test_resolve_config_matches_reference(tmp_path, fmt):
    """Flags override the config file, which overrides the defaults; the
    same argv and file give the same node settings and MergeParams."""
    argv = list(ARGV)
    if fmt is not None:
        cfg = {
            "output": "world.pcd", "compositing_rate": 2, "max_points": 4096,
            "descriptor_type": "FPFH", "resolution": 0.2, "matching_k": 3,
            "global_refinement": "no", "estimation_rate": 9.0,
        }
        path = tmp_path / f"node.{fmt}"
        if fmt == "json":
            path.write_text(json.dumps(cfg))
        else:
            path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
        argv += ["--config", str(path)]
    t_settings, t_params = tcli.resolve_config(argv)
    j_settings, j_params = jcli.resolve_config(argv)
    assert t_settings == j_settings
    assert t_params == port_params(j_params)
    assert str(t_params) == str(j_params)
    assert t_settings["estimation_rate"] == 0.5 and t_params.max_points == 2048
    if fmt is not None:
        assert t_settings["output"] == "world.pcd"
        assert t_params.descriptor_type.name == "FPFH" and not t_params.global_refinement


def test_params_surface_matches_reference():
    argv = ["--resolution", "0.3", "--estimation_method", "SAC_IA", "--icp_anneal"]
    assert MergeParams.from_command_line(argv) == port_params(JParams.from_command_line(argv))
    for kw in (dict(resolution=0.2), dict(resolution=0.05, inlier_threshold=0.4)):
        assert MergeParams.derived(**kw) == port_params(JParams.derived(**kw))
    d = {"keypoint_type": "HARRIS", "max_keypoints": "64", "matching_k": -1, "x": 1}
    assert MergeParams.from_dict(d) == port_params(JParams.from_dict(d))


def test_node_cli_requires_watch_dir(capsys):
    assert tcli.main([], device="cpu") == 1
    assert "--watch-dir is required" in capsys.readouterr().err


def _stateless_node(views, **kwargs):
    transport = InProcTransport()
    node = MapMergeNode(
        transport, port_params(NODE_PARAMS), seed=0, device="cpu", **kwargs
    )
    for i, (x, r) in enumerate(views):
        transport.publish(f"robot{i}", x, r)
    return transport, node


def test_stateless_node_is_estimate_maps_transforms(two_views, tmp_path):
    """One discovery, estimation and compositing tick: the poses are those
    of estimate_maps_transforms on the clouds the node builds, bit for bit;
    the pose callback, metrics, JSONL record and merged map follow."""
    va, vb, truth = two_views
    poses = {}
    log = tmp_path / "metrics.jsonl"
    _, node = _stateless_node(
        (va, vb), pose_callback=poses.__setitem__, metrics_log=str(log)
    )
    node.transforms_estimation()  # nothing discovered yet
    assert node.get_transforms() == {}
    node.discovery()
    node.transforms_estimation()
    got = node.get_transforms()
    params = port_params(NODE_PARAMS)
    cap = min(max(len(va[0]), len(vb[0])), params.max_points)
    clouds = [  # the node subsamples each view to the capacity
        PointCloud.from_numpy(
            *node._fit_to_capacity(*v, cap, f"robot{i}")[:2], capacity=cap, device="cpu"
        )
        for i, v in enumerate((va, vb))
    ]
    direct = estimate_maps_transforms(clouds, params, seed=0)
    for robot, t in zip(("robot0", "robot1"), direct):
        np.testing.assert_array_equal(got[robot], t)
        np.testing.assert_array_equal(poses[robot], t)
    rot, trans = ttf.pose_error(rel_pose(direct), truth)
    assert rot < 1.0 and trans < 0.1
    gauges = node.get_metrics()["gauges"]
    assert gauges["maps_registered"] == 2 and gauges["pairs_registered"] == 1
    rec = json.loads(log.read_text().splitlines()[-1])
    assert rec["mode"] == "stateless" and rec["maps_registered"] == 2
    node.map_compositing()
    merged = node.get_merged_map()
    assert merged is not None and int(merged.count) > 1000
    assert node.get_metrics()["gauges"]["merged_points"] == int(merged.count)


def test_compositing_uses_the_maps_of_the_last_estimation(two_views):
    """clouds.resize semantics (map_merge_node.cpp:114-116): a robot found
    after the last estimation waits for the next one."""
    va, vb, _ = two_views
    transport, node = _stateless_node((va,))
    node.map_compositing()
    assert node.get_merged_map() is None
    node.discovery()
    node.transforms_estimation()
    np.testing.assert_array_equal(node.get_transforms()["robot0"], np.eye(4))
    transport.publish("robot1", *vb)
    node.discovery()
    node.map_compositing()
    assert node.get_robots() == ["robot0", "robot1"]
    assert set(node.get_transforms()) == {"robot0"}
    assert 0 < int(node.get_merged_map().count) <= len(va[0])


def test_incremental_stream_through_directory_transport(tmp_path):
    """Four town views published as PCD files, localized one tick at a
    time against the world model at max_points 4096 (each view is
    subsampled to it): every map within 2 deg / 0.2 m of the truth; an
    unchanged map keeps its cached features; a republished one re-extracts."""
    views, truths = town_views(4, 4000, keep=0.8, seed=11)
    params = MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=10, max_points=4096,
        max_keypoints=128, max_neighbors=32, ransac_hypotheses=256,
        neighbor_tile=256,
    )
    node = MapMergeNode(
        DirectoryTransport(str(tmp_path)), params, seed=0, incremental=True,
        device="cpu",
    )
    for batch in ((0, 1), (2, 3)):
        for i in batch:
            write_pcd(tmp_path / f"r{i}.pcd", views[i])
        node.discovery()
        node.transforms_estimation()
    poses = node.get_transforms()
    assert sorted(poses) == ["r0", "r1", "r2", "r3"]
    for i in range(1, 4):
        rel = np.linalg.inv(poses["r0"]) @ poses[f"r{i}"]
        rot, trans = ttf.pose_error(rel, np.linalg.inv(truths[0]) @ truths[i])
        assert rot < 2.0 and trans < 0.2, (i, rot, trans)
    assert node.get_stats()["subsampled_points"] == sum(len(v[0]) - 4096 for v in views)
    assert node.get_metrics()["gauges"]["world_edges"] >= 3
    stamps = {r: s for r, (s, _) in node._feat_cache.items()}
    node.transforms_estimation()
    assert {r: s for r, (s, _) in node._feat_cache.items()} == stamps


def test_node_cli_main_writes_the_merged_map(tmp_path, two_views, monkeypatch):
    """The launcher runs the threaded node over a watch directory on the
    named device and writes the merged map; a stop request (the SIGINT
    handler it installs) ends it."""
    va, vb, _ = two_views
    maps = tmp_path / "maps"
    maps.mkdir()
    write_pcd(maps / "robot1.pcd", va)
    write_pcd(maps / "robot2.pcd", vb)
    out = tmp_path / "merged.pcd"
    handlers = []
    monkeypatch.setattr(tcli.signal, "signal", lambda sig, h: handlers.append(h))

    def stop_when_written():
        deadline = threading.Event()
        while not out.exists() and not deadline.wait(0.2):
            pass
        handlers[0]()

    watcher = threading.Thread(target=stop_when_written, daemon=True)
    watcher.start()
    cfg = {k: getattr(NODE_PARAMS, k) for k in (
        "keypoint_type", "keypoint_threshold", "descriptor_type", "max_points",
        "max_keypoints", "max_neighbors", "ransac_hypotheses", "neighbor_tile",
        "max_iterations",
    )}
    cfg = {k: getattr(v, "name", v) for k, v in cfg.items()}
    (tmp_path / "node.json").write_text(json.dumps(cfg))
    rc = tcli.main([
        "--watch-dir", str(maps), "--output", str(out), "--config",
        str(tmp_path / "node.json"), "--discovery-rate", "20",
        "--estimation-rate", "2", "--compositing-rate", "2",
        "--run-seconds", "300",
    ], device="cpu")
    watcher.join(timeout=10)
    assert rc == 0 and not watcher.is_alive()
    from mapmerge_torch.io.pcd import read_pcd_arrays

    xyz, _ = read_pcd_arrays(out)
    assert len(xyz) > 1000
