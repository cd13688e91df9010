"""The harness finds a configuration, a traffic mix, a metric and a cell's
limits that are added as new files, with no edit to a file that is there."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from mmbench import harness

ROOT = harness.MMBENCH.parent


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "mmbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mmbench", tmp_path / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_every_named_file_is_found():
    reg = harness.Registry(ROOT)
    for w in reg.spec["workloads"]:
        config = reg.config(w["config"])
        traffic = reg.traffic(w["traffic"])
        assert reg.driver(traffic["driver"]).step
        assert "checks" in reg.limits(w["name"]) and config["guarantees"]
        for kind in ("end_to_end", "per_layer"):
            names = [m["name"] for m in reg.metrics_of(w["name"], kind)]
            assert names
            for name in names:
                assert callable(reg.metric(name).read)
        assert "setup_s" in [m["name"] for m in reg.metrics_of(w["name"], "end_to_end")]


def test_a_cell_added_as_files_alone(checkout):
    before = _digests(checkout)
    bench = checkout / "mmbench"
    config = json.loads((bench / "configs" / "town_harris_fpfh.json").read_text())
    config["name"] = "town_harris_fpfh_wide"
    (bench / "configs" / "town_harris_fpfh_wide.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "merge5.json").read_text())
    traffic.update(maps=2, view_resized_target=800000, keep=0.75)
    (bench / "traffic" / "pair2.json").write_text(json.dumps(traffic))
    (bench / "limits" / "town_harris_fpfh_wide.pair2.json").write_text(
        (bench / "limits" / "town_harris_fpfh.merge5.json").read_text())
    (bench / "metrics" / "pairs_share.pair2.py").write_text(
        "SPANS = ['mapmerge_torch.pipeline.merging:register_pair']\n\n"
        "def read(rec):\n    return 42.0\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "town_harris_fpfh_wide", "source": "https://example.org",
                            "file": "mmbench/configs/town_harris_fpfh_wide.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "town_harris_fpfh_wide.pair2",
                              "config": "town_harris_fpfh_wide", "traffic": "pair2",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("town_harris_fpfh_wide.pair2")
    spec["per_layer"].append({"name": "pairs_share.pair2", "unit": "%", "better": "lower",
                              "source": "program_span", "layer": "pair registration",
                              "moves": "merge_s", "workloads": ["town_harris_fpfh_wide.pair2"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = harness.Registry(checkout, checkout / "mmbench")
    w = reg.workload("town_harris_fpfh_wide.pair2")
    assert reg.config(w["config"])["name"] == "town_harris_fpfh_wide"
    assert reg.traffic(w["traffic"])["maps"] == 2
    assert reg.limits(w["name"])["checks"]
    layer = [m["name"] for m in reg.metrics_of(w["name"], "per_layer")]
    assert layer == ["pairs_share.pair2"]
    assert reg.metric("pairs_share.pair2").read(None) == 42.0
    assert [m["name"] for m in reg.metrics_of(w["name"], "end_to_end")] == ["merge_s", "setup_s"]
    after = _digests(checkout)
    assert all(after[p] == d for p, d in before.items())


def test_a_missing_file_is_an_error(checkout):
    reg = harness.Registry(checkout, checkout / "mmbench")
    with pytest.raises(FileNotFoundError):
        reg.metric("no_such_metric")
    with pytest.raises(KeyError):
        reg.workload("no.such_cell")


def test_a_per_layer_metric_lists_its_cells(checkout):
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = harness.Registry(checkout, checkout / "mmbench")
    with pytest.raises(ValueError, match="list no workloads"):
        reg.metrics_of(spec["workloads"][0]["name"], "per_layer")
