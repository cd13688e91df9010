"""The harness: find a cell's files by name, run its window, read its metrics.

Data, not code, decides what a cell runs. `BENCHMARK.json` names a cell's
configuration and traffic mix; this module finds

- the configuration at the `file` its entry gives (sizes, parameters, the
  guarantees it states);
- the traffic mix at `traffic/<traffic>.json` (map count, scene recipe,
  arrivals), which names its driver, `drivers/<driver>.py`;
- each metric at `metrics/<name>.py`, a small reader;
- the cell's limits at `limits/<workload>.json`.

A later change adds a cell, a mix or a metric by adding files; it edits
none. Nothing here imports the program: the drivers do.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import time
from collections import Counter
from pathlib import Path
from types import ModuleType
from typing import Callable, Iterable

MMBENCH = Path(__file__).resolve().parent


# --------------------------------------------------------------- the loader
class Registry:
    """The files of one benchmark: `root` holds BENCHMARK.json, `bench` the
    directory of the harness's data files (configs, traffic, metrics,
    limits, drivers)."""

    def __init__(self, root: Path, bench: Path = MMBENCH):
        self.root = Path(root)
        self.bench = Path(bench)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json").read_text())

    def driver(self, name: str) -> ModuleType:
        return _load_file(self.bench / "drivers" / f"{name}.py", f"mmbench_driver_{name}")

    def metric(self, name: str) -> ModuleType:
        return _load_file(self.bench / "metrics" / f"{name}.py", f"mmbench_metric_{name}")

    def metrics_of(self, workload: str, kind: str) -> list[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics that `workload`
        reports: those that list it, and the end-to-end metrics that list no
        cell (`setup_s`). Every per-layer metric lists its cells."""
        if kind == "per_layer":
            unlisted = [m["name"] for m in self.spec[kind] if "workloads" not in m]
            if unlisted:
                raise ValueError(f"per-layer metrics list no workloads: {unlisted}")
        return [m for m in self.spec[kind] if workload in m.get("workloads", [workload])]


def _load_file(path: Path, module_name: str) -> ModuleType:
    """The module at `path`, loaded under `module_name` (a metric's file
    name holds dots, so it is no importable module name)."""
    if not path.is_file():
        raise FileNotFoundError(f"mmbench: no file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------- patching
def resolve(target: str):
    """(owner, attribute) of "package.module:Name.attr"."""
    module_name, _, path = target.partition(":")
    owner = importlib.import_module(module_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


@contextlib.contextmanager
def patched(wrappers: dict[str, Callable]):
    """Each target's function replaced by wrappers[target](function) for
    the block, restored in reverse order after it."""
    saved = []
    try:
        for target, wrap in wrappers.items():
            owner, attr = resolve(target)
            original = getattr(owner, attr)
            saved.append((owner, attr, original))
            setattr(owner, attr, wrap(original))
        yield
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)


def span_wrappers(targets: Iterable[str], spans: dict, sync: Callable) -> dict:
    """Wrappers that time each call of each target between two
    synchronisations, adding its ms and calls to spans[target]."""

    def make(target):
        def wrap(fn):
            def timed(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    sync()
                    s = spans.setdefault(target, {"ms": 0.0, "calls": 0})
                    s["ms"] += (time.perf_counter() - t0) * 1e3
                    s["calls"] += 1

            return timed

        return wrap

    return {t: make(t) for t in targets}


def hook_wrappers(hooks: dict[str, Callable], tally: dict, calls: dict) -> dict:
    """Wrappers that, before each call of a target, add 1 to calls[target]
    and hooks[target](*args, **kwargs) (a number, or a device count that
    is not read back) to tally[target]."""

    def make(target, measure):
        def wrap(fn):
            def counted(*args, **kwargs):
                calls[target] = calls.get(target, 0) + 1
                tally[target] = tally.get(target, 0) + measure(*args, **kwargs)
                return fn(*args, **kwargs)

            return counted

        return wrap

    return {t: make(t, m) for t, m in hooks.items()}


# -------------------------------------------------------------- the window
class Record:
    """What a phase of the window saw: counts and samples that the driver's
    steps return, the phase's seconds, and the spans or profile of a traced
    run."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.samples: dict[str, list] = {}
        self.seconds = 0.0
        self.spans: dict = {}
        self.profile: dict | None = None

    def add(self, step: dict) -> None:
        for k, v in step.get("counts", {}).items():
            self.counts[k] += v
        for k, v in step.get("samples", {}).items():
            self.samples.setdefault(k, []).extend(v)


def run_steps(step: Callable[[], dict], record: Record, deadline: float | None,
              n_steps: int | None = None) -> None:
    """Steps until `n_steps` are done or, after one at least, the deadline
    has passed: a step in flight at the deadline ends the phase."""
    t0 = time.perf_counter()
    done = 0
    while True:
        record.add(step())
        done += 1
        if n_steps is not None and done >= n_steps:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            break
    record.seconds += time.perf_counter() - t0


# ------------------------------------------------------- trace arithmetic
def interval_union(spans: Iterable[tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: kernels that
    overlap on the device are busy once (chip_smoke.device_busy's
    arithmetic)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(device: list[tuple[float, float]], t0: float, t1: float) -> list[tuple[float, float]]:
    """The gaps in [t0, t1] that no device interval covers."""
    gaps, cursor = [], t0
    for a, b in sorted(device):
        if a > cursor:
            gaps.append((cursor, min(a, t1)))
        cursor = max(cursor, b)
        if cursor >= t1:
            break
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(a, b) for a, b in gaps if b > a]


def quantile(values: list[float], q: float) -> float:
    """The q-quantile of `values` by linear interpolation between order
    statistics (numpy's default): the p95 of a latency list is
    quantile(v, 0.95)."""
    v = sorted(values)
    if not v:
        raise ValueError("quantile of no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
