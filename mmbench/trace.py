"""The profiler phase of a traced run: torch.profiler over a fixed number of
steps, with no spans, read into the device's busy time, its launches, the
time of each device operation, the idle gaps by what the host was doing,
and the calls of the functions the cell's metrics hook; then the count
phase, as many steps again with no profiler, in which the hooks read their
numbers (`count_bytes`)."""

from __future__ import annotations

import bisect
import time
from typing import Callable

from mmbench import harness

#: prefix of the profiler ranges that mark the layer boundaries
LABEL = "mm:"
#: device events that are copies or fills, not kernel launches
NOT_LAUNCHES = ("Memcpy", "Memset")


def profiled(run: Callable[[], None], hooks: dict[str, Callable], labels: list[str],
             sync: Callable[[], None]) -> dict:
    """run() under torch.profiler, ending in sync(), with the calls of each
    of `hooks`' targets counted (on the host; the hooks themselves do not
    run) and each of `labels` (layer functions) inside a profiler range of
    its own."""
    from torch.profiler import DeviceType, ProfilerActivity, profile, record_function

    def label(target):
        def wrap(fn):
            def ranged(*args, **kwargs):
                with record_function(LABEL + target.rpartition(":")[2]):
                    return fn(*args, **kwargs)

            return ranged

        return wrap

    calls: dict = {}
    sync()
    with harness.patched({t: label(t) for t in labels}), \
            harness.patched(harness.hook_wrappers({t: _none for t in hooks}, {}, calls)), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    device, host, ranges = [], [], []
    # the raw events, without the tree of FunctionEvents (which takes minutes
    # to build for a stream's hundreds of thousands of launches)
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == DeviceType.CUDA
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if name.startswith(LABEL):
            # a layer range; its copy on the device's timeline is no device work
            if not on_device:
                ranges.append((name[len(LABEL):], a, b))
        elif on_device:
            device.append((a, b, name))
        else:
            host.append((name, a, b))
    return summarize(device, host, ranges, wall, calls)


def _none(*args, **kwargs) -> int:
    return 0


def count_bytes(run: Callable[[], None], hooks: dict[str, Callable],
                sync: Callable[[], None]) -> tuple[float, dict]:
    """run() with each of `hooks` adding its call's number: (the numbers'
    sum, read once at the end, and the calls of each target)."""
    tally: dict = {}
    calls: dict = {}
    with harness.patched(harness.hook_wrappers(hooks, tally, calls)):
        run()
    sync()
    return float(sum(tally.values())), calls


def summarize(device: list[tuple[float, float, str]], host: list, ranges: list,
              wall_s: float, calls: dict) -> dict:
    """The profile's numbers from its events (times in microseconds, as
    the profiler gives them)."""
    spans = [(a, b) for a, b, _ in device]
    by_name: dict[str, float] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    starts = [s for _, s, _ in host] + [s for _, s, _ in ranges] + [a for a, _ in spans]
    ends = [e for _, _, e in host] + [e for _, _, e in ranges] + [b for _, b in spans]
    gaps = harness.idle_gaps(spans, min(starts), max(ends)) if starts else []
    return {
        "wall_s": wall_s,
        "busy_s": harness.interval_union(spans) / 1e6,
        "launches": sum(1 for _, _, n in device if not n.startswith(NOT_LAUNCHES)),
        "device_s": by_name,
        "gaps_s": {k: v / 1e6 for k, v in gaps_by_layer(gaps, host, ranges).items()},
        "calls": calls,
    }


def _innermost(events: list, starts: list, t: float, depth: int = 512):
    """The name of the latest-starting of `events` (sorted by start) that
    covers t, among the `depth` that start last before it."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(events[max(0, i - depth):i]):
        if s <= t <= e:
            return name
    return None


def gaps_by_layer(gaps: list, host: list, ranges: list) -> dict[str, float]:
    """Each idle gap's length, put to "<layer> > <host op>": the innermost
    layer range and host operation running at its midpoint."""
    host = sorted(host, key=lambda e: e[1])
    ranges = sorted(ranges, key=lambda e: e[1])
    hs, rs = [e[1] for e in host], [e[1] for e in ranges]
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        key = f"{_innermost(ranges, rs, mid, len(ranges)) or '-'} > {_innermost(host, hs, mid) or 'host'}"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def top(d: dict[str, float], n: int = 10, width: int = 160) -> list:
    """The n largest entries as [name, value], names cut to `width`."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
