"""The eval configurations that chip_smoke.py's phases 14-16 run on the card
(bench_configs.py config3, config4, config5), checked on the CPU at the
parts that need no card: their params against the reference's, the
stateless node's parity rule over a growing robot set, and the rank job of
phase 15 at world 1.

Tolerances: params equal field for field; every pose and transform equal
bit for bit (the node and the direct call run the same registrations on
the same clouds with the same generators).
"""

import ast
import inspect
import json
import textwrap

import numpy as np
import pytest
import torch

import bench_configs
import chip_smoke
from mapmerge_tpu.core.params import MergeParams as JaxMergeParams
from mapmerge_torch import convert
from mapmerge_torch.pipeline.merging import estimate_maps_transforms
from mapmerge_torch.runtime.node import MapMergeNode
from mapmerge_torch.runtime.transport import InProcTransport
from mapmerge_torch.testing.scene import make_scene, overlapping_views, rotation_z, se3

CPU = torch.device("cpu")


def reference_params(fn) -> JaxMergeParams:
    """The one MergeParams(...) call in the source of bench_configs' `fn`,
    built with the reference's class (config5 builds its params inside the
    run, and _config4_fixture builds its clouds beside them)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "MergeParams"]
    assert len(calls) == 1
    return JaxMergeParams(**{k.arg: ast.literal_eval(k.value) for k in calls[0].keywords})


@pytest.mark.parametrize("phase_params, reference", [
    ("config3_params",
     lambda: bench_configs._big_params(1 << 20).replace(ransac_hypotheses=1024)),
    ("config4_params", lambda: reference_params(bench_configs._config4_fixture)),
    ("config5_params", lambda: reference_params(bench_configs.config5)),
])
def test_phase_params_match_reference(phase_params, reference):
    got = getattr(chip_smoke, phase_params)()
    want = convert.params_from_reference(reference())
    assert got.__dict__ == want.__dict__


@pytest.fixture(scope="module")
def views():
    """tests/test_torch_parallel.py's three views of one box scene."""
    xyz, rgb = make_scene(np.random.default_rng(7), n_boxes=6, extent=8.0, density=40.0)
    a, b, _ = overlapping_views(np.random.default_rng(3), xyz, rgb,
                                se3(rotation_z(0.35), [1.2, -0.5, 0.15]), overlap=0.65)
    _, c, _ = overlapping_views(np.random.default_rng(4), xyz, rgb,
                                se3(rotation_z(-0.2), [-0.8, 0.6, 0.0]), overlap=0.65)
    return [a, b, c]


def test_stateless_node_growing_set_is_the_direct_call(views):
    """Phase 16's parity rule at a small size: after each tick, as robots
    join, the node's poses are estimate_maps_transforms' on the clouds the
    node built, bit for bit."""
    _, _, params = chip_smoke.distributed_node_case()
    transport = InProcTransport()
    node = MapMergeNode(transport, params, seed=0, device=CPU)
    for joined in ([0, 1], [2]):
        for i in joined:
            transport.publish(f"robot_{i}", *views[i])
        node.discovery()
        node.transforms_estimation()
        robots, clouds = chip_smoke.stateless_clouds(node)
        assert robots == [f"robot_{i}" for i in range(joined[-1] + 1)]
        poses = node.get_transforms()
        direct = estimate_maps_transforms(clouds, params, seed=0)
        assert sorted(poses) == robots and len(direct) == len(robots)
        for robot, t in zip(robots, direct):
            np.testing.assert_array_equal(poses[robot], t)
        assert sum(1 for t in direct if t.any()) >= 2


def test_rank_job_at_world_one(views, tmp_path, capsys):
    """Phase 15's rank job alone (initialize is then a no-op): its JSON
    line parses, its transforms are the direct call's bit for bit, and its
    one rank ingests both robots."""
    node_views, _, params = chip_smoke.distributed_node_case()
    chip_smoke.rank_job(0, 1, None, CPU, tmp_path, (views, params), (node_views, params))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = estimate_maps_transforms(chip_smoke.raw_clouds(views, CPU), params, seed=0)
    got = [np.asarray(t, np.float32) for t in line["transforms"]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (line["rank"], line["world"], line["devices"]) == (0, 1, ["cpu"])
    assert line["mesh"]["clouds"] == [0, 1, 2] and line["info"]["n_pairs"] == 3
    assert line["node"]["robots"] == sorted(node_views) == sorted(line["node"]["poses"])
    assert line["node"]["merged_points"] > 1000 and line["peak_gib"] is None
    # each path's tree solves ran natively and were held against the plain
    # version
    assert sorted(line["graph"]) == ["config #4, rank 0", "node two processes, rank 0"]
    assert all(g["calls"] > 0 and g["max_abs_diff"] <= chip_smoke.GRAPH_TOL
               for g in line["graph"].values())
