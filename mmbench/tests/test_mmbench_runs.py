"""Whole runs at toy sizes on the CPU: both drivers, the judge, its control
and the faults it has to catch.

A toy cell is a copy of the benchmark's files with a toy configuration,
mix and limits added as files (the cells' own limits, for the numbers the
control and the faults are judged by; looser pose limits, since a town of
a few thousand points registers to a degree or two). `run.measure` drives
it as `python3 -m mmbench.run` drives a cell, without the look for a card.
"""

from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest
import torch

from mmbench import calibrate, harness, run

ROOT = harness.MMBENCH.parent
SEED = 11
TOY_PARAMS = {
    "descriptor_type": "FPFH", "refine_transform": True, "max_iterations": 10,
    "max_points": 16384, "max_keypoints": 32, "max_neighbors": 1024, "ransac_hypotheses": 256,
    "neighbor_tile": 256,
}
TOY_LIMITS = {"pose_rot_deg": 5.0, "pose_trans_m": 0.5}


#: a toy Harris town holds a handful of keypoints, too few to register
#: it; that cell is there for the keypoint and descriptor numbers
OPEN_POSES = {"pose_rot_deg": 180.0, "pose_trans_m": 1e3}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A checkout holding the toy cells toy.merge2 (SIFT), toy_harris.merge2
    and toy_node.stream3."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "mmbench", root / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "mmbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # the toys place no view: a town of a few thousand points registers to a
    # few degrees only from where its views lie
    merge2 = {"driver": "offline_merge", "maps": 2, "view_resized_target": 3000, "keep": 0.8,
              "scene_seeds": [5], "yaw_deg": 0.0, "shift_m": 0.0, "profile_steps": 1}
    stream3 = {"driver": "node_stream", "maps": 3, "view_resized_target": 2000, "keep": 0.8,
               "scene_seeds": [5], "yaw_deg": 0.0, "shift_m": 0.0, "maps_per_tick": 2,
               "profile_steps": 1}
    for name, base, detector, mix, traffic, poses in (
        ("toy", "town_harris_fpfh", "town_sift_fpfh_node", "merge2", merge2, TOY_LIMITS),
        ("toy_harris", "town_harris_fpfh", "town_harris_fpfh", "merge2", merge2, OPEN_POSES),
        ("toy_node", "town_sift_fpfh_node", "town_sift_fpfh_node", "stream3", stream3,
         TOY_LIMITS),
    ):
        config = json.loads((bench / "configs" / f"{base}.json").read_text())
        kind = json.loads((bench / "configs" / f"{detector}.json").read_text())["params"]
        params = {**TOY_PARAMS, **{k: kind[k] for k in ("keypoint_type", "keypoint_threshold")}}
        config.update(name=name, params=params, guarantees=poses)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        cell = "stream50" if mix == "stream3" else "merge5"
        # the limits of the cell that runs the same detector
        own = {"town_harris_fpfh": "merge5", "town_sift_fpfh_node": "stream50"}[detector]
        limits = json.loads((bench / "limits" / f"{detector}.{own}.json").read_text())
        # the CPU's plain neighbour sums are not the card's kernels: their
        # normals sit ~4e-4 deg and curvature ~3e-6 off float64 at this size
        limits.update(feature_clouds=2, normal_queries=256)
        limits["checks"].update(normal_p90_deg=5e-3, curvature_p90=2e-5)
        (bench / "limits" / f"{name}.{mix}.json").write_text(json.dumps(limits))
        spec["configs"].append({"name": name, "source": "https://example.org",
                                "file": f"mmbench/configs/{name}.json", "reduced": [],
                                "why": "toy"})
        spec["workloads"].append({"name": f"{name}.{mix}", "config": name, "traffic": mix,
                                  "chips": 1, "why": "toy"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and m["workloads"][0].endswith(cell):
                m["workloads"].append(f"{name}.{mix}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    torch.set_num_threads(min(8, torch.get_num_threads()))
    return harness.Registry(root, bench)


def _measure(reg, workload: str, trace: bool = False) -> dict:
    return run.measure(reg, workload, SEED, 0.01, trace, torch.device("cpu"),
                       time.perf_counter())


def test_a_toy_merge_passes_through_the_driver(toy):
    result = _measure(toy, "toy.merge2", trace=True)
    assert result["correct"], result["checks"]
    # a profiled, a counted and a spanned merge of two maps each
    assert result["attempted"] == 6 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    names = set(result["metrics"])
    assert {"features_ms.merge", "pairs_ms.merge", "graph_ms.merge"} <= names
    assert list(result)[-1] == "checks"


def test_a_toy_stream_passes_through_the_driver(toy):
    result = _measure(toy, "toy_node.stream3")
    assert set(result["metrics"]) == {"maps_per_min", "map_latency_p95_s", "setup_s"}
    assert result["attempted"] % 3 == 0 and result["attempted"] >= 3
    assert {"merged_mismatch", "normal_p90_deg", "pose_rot_deg"} <= set(result["checks"])


def _rotate_z(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    r = np.eye(4, dtype=np.float32)
    r[:2, :2] = [[c, -s], [s, c]]
    return r


def _state_unchanged(fn):
    """The graph solve hands back its seed poses, unchanged: identity."""
    def solve(estimates, params):
        n = len(fn(estimates, params))
        return [np.eye(4, dtype=np.float32)] * n
    return solve


def _half_the_batch(fn):
    """compose_maps over the first half of the maps alone."""
    def compose(clouds, transforms, resolution, out_capacity=None):
        half = max(1, len(clouds) // 2)
        return fn(clouds[:half], transforms[:half], resolution, out_capacity)
    return compose


def _pose_altered(fn):
    """The last map's pose turned by 10 deg where the graph solve makes it."""
    def solve(estimates, params):
        poses = fn(estimates, params)
        poses[-1] = (poses[-1] @ _rotate_z(10.0)).astype(np.float32)
        return poses
    return solve


def _normals_altered(fn):
    """Each normal tilted by 1 deg where the normal stage makes it."""
    def normals(cloud, *args, **kwargs):
        out = fn(cloud, *args, **kwargs)
        r = torch.as_tensor(_rotate_z(1.0)[:3, :3]).to(out.normals)
        tilted = out.normals @ r.T
        return type(out)(normals=tilted, curvature=out.curvature, valid=out.valid)
    return normals


def _bfloat16(fn):
    """The result (a field, or the descriptors' data) rounded to bfloat16
    where it is made."""
    def rounded(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return out.to(torch.bfloat16).to(out.dtype)
        return type(out)(data=out.data.to(torch.bfloat16).to(out.data.dtype), valid=out.valid)
    return rounded


@pytest.mark.parametrize("workload, target, fault, caught_by", [
    ("toy.merge2", "mapmerge_torch.pipeline.merging:_solve_graph", _state_unchanged,
     "pose_rot_deg"),
    ("toy.merge2", "mapmerge_torch.pipeline.merging:compose_maps", _half_the_batch,
     "merged_mismatch"),
    ("toy.merge2", "mapmerge_torch.pipeline.merging:_solve_graph", _pose_altered,
     "pose_rot_deg"),
    ("toy.merge2", "mapmerge_torch.pipeline.features:compute_surface_normals",
     _normals_altered, "normal_p90_deg"),
    ("toy_harris.merge2", "mapmerge_torch.ops.keypoints.harris:harris_response", _bfloat16,
     "harris_rel_max"),
    ("toy.merge2", "mapmerge_torch.ops.keypoints.sift:_scale_space", _bfloat16, "dog_max"),
    ("toy.merge2", "mapmerge_torch.pipeline.features:compute_descriptors", _bfloat16,
     "fpfh_p90"),
])
def test_a_fault_in_the_timed_path_is_not_correct(toy, workload, target, fault, caught_by):
    with harness.patched({target: fault}):
        result = _measure(toy, workload)
    assert not result["correct"]
    c = result["checks"][caught_by]
    assert c["value"] > c["limit"], result["checks"]


@pytest.mark.parametrize("workload", ["toy.merge2", "toy_harris.merge2"])
def test_the_control_is_not_correct(toy, workload):
    """The reference one precision below float32 (TF32) in the program's
    place fails the cell's limits; the program passes them."""
    numbers = calibrate.readings(toy, workload, SEED, True, torch.device("cpu"))
    limits = toy.limits(workload)["checks"]
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
    assert any(numbers[f"tf32:{k}"] > v for k, v in limits.items() if f"tf32:{k}" in numbers)
