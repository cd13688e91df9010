"""What the benchmark may load: nothing of JAX or the JAX package anywhere
below mmbench.run, and nothing of the program in the reference."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from mmbench import harness

ROOT = harness.MMBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mapmerge_tpu"}
PROGRAM = "mapmerge_torch"

#: every module and file a run loads: the harness, its drivers and readers,
#: and the program's modules the drivers drive
LOAD_ALL = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import mmbench.run, mmbench.calibrate
from mmbench import harness
reg = harness.Registry(harness.MMBENCH.parent)
for w in reg.spec["workloads"]:
    reg.driver(reg.traffic(w["traffic"])["driver"])
for kind in ("end_to_end", "per_layer"):
    for m in reg.spec[kind]:
        reg.metric(m["name"])
import mapmerge_torch.pipeline.merging, mapmerge_torch.runtime.node
import mapmerge_torch.parallel.pair_shard, mapmerge_torch.pipeline.incremental
for target in __import__("mmbench.roofline").roofline.BYTES:
    harness.resolve(target)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str) -> set[str]:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level_modules(LOAD_ALL)
    assert PROGRAM in loaded  # compared whole: mapmerge_torch is not mapmerge_tpu
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import mmbench.reference, mmbench.judge; "
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    loaded = _top_level_modules(code)
    assert PROGRAM not in loaded and not loaded & FORBIDDEN


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("name", ["reference.py", "judge.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    assert _imports(harness.MMBENCH / name) <= {"__future__", "itertools", "numpy", "torch", "mmbench"}


def test_no_file_reads_the_tpu_benchmark():
    """No module of mmbench imports the JAX package's benchmark scripts or
    names their data (golden poses, BENCH_*.json) in its code."""
    for path in harness.MMBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        assert not _imports(path) & {"bench", "bench_configs", "chip_smoke", "mapmerge_tpu"}, path
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        for n in ast.walk(tree):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
                assert not any(s in n.value for s in ("golden", "BENCH_", "bench_configs")), path


def test_the_measured_path_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mmbench.run", "--workload",
                          "town_harris_fpfh.merge5", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and mmbench/, a run
    exits with an error and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mmbench", tmp_path / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "mmbench.run", "--workload",
                          "town_harris_fpfh.merge5", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
