"""Stage timing and profiling (port of mapmerge_tpu/utils/profiling.py).

The reference tool's pcl::ScopeTime timers
(src/registration_visualisation.cpp:51-158) as a stage timer whose stages
end in `torch.cuda.synchronize(device)`, so a stage counts the device work it
queued, and an optional `torch.profiler` trace.

The JAX package reduces every result to a host scalar at a stage's end,
because its relay returned from `block_until_ready` before the work was
done; on the card the synchronisation is the barrier, and a stage needs no
handle on its results. `device_sync` keeps that package's call on a tree of
results: it synchronises the cards the tree's tensors live on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Iterator

import torch


def _on_card(device) -> bool:
    """Whether `device` is a card (None: the current card, if there is one)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def synchronize(device=None) -> None:
    """Wait for the work queued on `device` (None: the current card); there
    is nothing to wait for on the CPU."""
    if _on_card(device):
        torch.cuda.synchronize(device)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensor leaves of nested lists, tuples, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for field in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, field.name))


def device_sync(tree: Any) -> Any:
    """Wait for the work queued on every card that a tensor of `tree` (nested
    lists, tuples, dicts and dataclasses) lives on, and return `tree`. With
    no tensor on a card it does nothing."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


class StageTimes:
    """Named stage wall times in seconds, summed over repeated stages; each
    stage ends in `synchronize(device)`."""

    def __init__(self, device=None):
        self.device = device
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block up to the end of the device work it queued, add it
        to `times[name]` and print it."""
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        print(f"[stage] {name}: {dt * 1000.0:.1f} ms", flush=True)


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Profile the block with torch.profiler (host, and the card's kernels
    when `device` is a card; None: the current card, if there is one) and
    write a Chrome trace to `log_dir/trace.json`; a no-op when `log_dir` is
    None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _on_card(device):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
