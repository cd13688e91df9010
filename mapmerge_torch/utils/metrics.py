"""Structured runtime metrics (the port's copy of mapmerge_tpu/utils/metrics.py).

A thread-safe registry of counters, gauges and stage-timing summaries that
the online node (runtime/node.py) feeds every tick, snapshottable as one
dict and optionally streamed to a JSONL sink. Plain host Python: metrics
are control-plane data (tick durations, map counts, the pipeline's overflow
counters), never device tensors.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional


class TimingSummary:
    """Streaming summary of one named duration (count/total/min/max/last).

    Cheap enough to update at tick rate; no sample buffer is kept so the
    registry's memory is O(#metric names) regardless of uptime.
    """

    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)
        self.last = seconds

    def snapshot(self) -> dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "mean_s": round(mean, 6),
            "min_s": round(self.min, 6) if self.count else 0.0,
            "max_s": round(self.max, 6),
            "last_s": round(self.last, 6),
        }


class MetricsRegistry:
    """Thread-safe counters + gauges + timing summaries.

    - counters: monotonically-increasing integers (`inc`)
    - gauges: last-written values (`set_gauge`) — ints/floats/strings
    - timings: duration summaries (`observe` / `time_stage`)
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Any] = {}
        self._timings: dict[str, TimingSummary] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def set_gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            summary = self._timings.get(name)
            if summary is None:
                summary = self._timings[name] = TimingSummary()
            summary.add(seconds)

    @contextmanager
    def time_stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict[str, Any]:
        """One structured dict: {'counters': ..., 'gauges': ...,
        'timings': {name: {count,total,mean,min,max,last}}}."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": {
                    k: v.snapshot() for k, v in self._timings.items()
                },
            }


class JsonlMetricsSink:
    """Append-only JSONL metrics log: one `write(record)` = one line.

    The node writes one record per estimation tick (the expensive job);
    each record carries the tick's own measurements plus a full registry
    snapshot, so the log alone reconstructs the node's timeline.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()

    def write(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def read_jsonl(path: str) -> list[dict]:
    """Read a JSONL metrics/bench file, skipping blank lines."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def maybe_sink(path: Optional[str]) -> Optional[JsonlMetricsSink]:
    return JsonlMetricsSink(path) if path else None
