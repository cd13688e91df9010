"""Clouds and pairs dealt over a mesh (port of mapmerge_tpu/parallel/pair_shard.py).

The reference's hot loop, sequential registration of every map pair
(map_merge_3d/src/map_merging.cpp:256-269), becomes: each rank extracts the
features of the clouds it owns, on the owning slot's device; every cloud's
`CloudFeatures` are gathered to every rank, bit for bit (the pair stage
reads them replicated); each rank registers the pairs it owns; the pair
results are gathered to every rank, which all run the same host graph
solve. Pairs are dealt in chunks (one pair each on the grid engine, a
batch each on the dense engine; `pipeline/merging.py`).

The JAX package pads clouds with empty ones and pairs with discarded
(0, 0) self-pairs, because `shard_map` needs equal shares; here shares may
be uneven and nothing is padded (`pad_pairs` stays for parity). The port's
feature stages already run eagerly, one after another, so the reference's
two feature entries (`extract_features_sharded` for small clouds and
`extract_features_staged_parallel`, its round-robin of big clouds over
local devices) are one function. A rank's local devices work at once, one
thread each.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import torch

from mapmerge_torch.core.cloud import PointCloud, pad_cloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.parallel.mesh import Mesh, pad_to_multiple
from mapmerge_torch.parallel.multihost import allgather_union
from mapmerge_torch.pipeline.features import CloudFeatures, extract_features

_HOST = torch.device("cpu")


def to_device(obj, device: torch.device):
    """`obj` (a tensor, or dataclasses, dicts, lists and tuples of them)
    with its tensors on `device`; a copy is exact."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def _on(device: torch.device):
    """Make `device` the current card for the block (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_local(mesh: Mesh, items: list[int], fn: Callable) -> dict:
    """{k: fn(k, device)} for the items this rank owns among `items`, each
    on its slot's device: the items of one device in order, each device on
    a thread of its own (on the calling thread when there is one)."""
    by_device: dict[int, list[int]] = {}
    for k in items:
        by_device.setdefault(mesh.local_index(k), []).append(k)

    def work(d: int) -> dict:
        dev = mesh.devices[d]
        with _on(dev):
            return {k: fn(k, dev) for k in by_device[d]}

    if len(by_device) <= 1:
        return {k: v for d in by_device for k, v in work(d).items()}
    with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
        parts = [pool.submit(work, d) for d in by_device]
        return {k: v for p in parts for k, v in p.result().items()}


def gather(mesh: Mesh, local: dict, stats: dict | None = None) -> dict:
    """The union of every rank's `local` {item: value} on every rank: tensors
    go through the host when the mesh spans ranks. The seconds spent here,
    waiting for the slowest rank included, are added to `stats["gather_s"]`."""
    if mesh.world == 1:
        return dict(local)
    t0 = time.perf_counter()
    merged = allgather_union(mesh.group, to_device(local, _HOST))
    if stats is not None:
        stats["gather_s"] = stats.get("gather_s", 0.0) + time.perf_counter() - t0
    return merged


def extract_features_sharded(
    clouds: list[PointCloud], params: MergeParams, mesh: Mesh,
    stats: dict | None = None,
) -> list[CloudFeatures]:
    """Every cloud's features on every rank: cloud k extracted by the rank
    and on the device of slot k, at the clouds' common capacity (as
    the reference's stacked batch has), then gathered. Each cloud's features lie on the
    device that made them, or on the host when they came from another rank.
    `stats["clouds"]` gets the clouds this rank extracted."""
    cap = max(c.capacity for c in clouds)
    mine = mesh.mine(len(clouds))
    if stats is not None:
        stats["clouds"] = mine
    local = run_local(
        mesh, mine,
        lambda k, dev: extract_features(pad_cloud(to_device(clouds[k], dev), cap), params),
    )
    merged = gather(mesh, local, stats)
    return [merged[k] for k in range(len(clouds))]


def estimate_pairs_sharded(
    features: list[CloudFeatures], pairs: list[tuple[int, int]],
    register: Callable, mesh: Mesh, stats: dict | None = None, chunk: int = 1,
) -> list:
    """Every pair of `pairs` ((source, target) cloud indices) registered on
    every rank, `chunk` pairs at a time: chunk c, pairs [c*chunk,
    (c+1)*chunk), is registered by the rank and on the device of slot c,
    as `register(c, its sources' features, its targets' features)` (lists,
    placed on that device), which returns one host result a pair; the
    results are gathered and returned in pair order. A chunk is the same
    pairs whatever the mesh, so each pair is computed in the same batch on
    one rank or many. `stats["pairs"]` gets the pairs this rank registered."""
    n_chunks = -(-len(pairs) // chunk)
    mine = mesh.mine(n_chunks)
    members = [pairs[c * chunk : (c + 1) * chunk] for c in range(n_chunks)]
    if stats is not None:
        stats["pairs"] = [p for c in mine for p in members[c]]
    on_device: dict = {}  # (cloud, device) -> features there

    def placed(i: int, dev: torch.device) -> CloudFeatures:
        key = (i, str(dev))
        if key not in on_device:
            on_device[key] = to_device(features[i], dev)
        return on_device[key]

    def one(c: int, dev: torch.device):
        return register(c, [placed(i, dev) for i, _ in members[c]],
                        [placed(j, dev) for _, j in members[c]])

    merged = gather(mesh, run_local(mesh, mine, one), stats)
    return [r for c in range(n_chunks) for r in merged[c]]


def pad_pairs(pairs: list[tuple[int, int]], n_devices: int):
    """The pair list padded to a device multiple with (0, 0) pairs, as the
    JAX package's shard_map needs: (src int32, tgt int32, real count). The
    sharded path here does not pad."""
    n = len(pairs)
    padded = pad_to_multiple(max(n, 1), n_devices)
    full = pairs + [(0, 0)] * (padded - n)
    src = torch.tensor([p[0] for p in full], dtype=torch.int32)
    tgt = torch.tensor([p[1] for p in full], dtype=torch.int32)
    return src, tgt, n
