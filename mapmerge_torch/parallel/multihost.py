"""Joining ranks into one job (port of mapmerge_tpu/parallel/multihost.py).

The reference leaves cross-host networking to external ROS packages
(doc/wiki.txt:14). Here processes join one `torch.distributed` job; each
process holds its local cards, and the pair axis of the registration graph
spans every rank's cards (`parallel/pair_shard.py`). Each host ingests its
own robots' maps (runtime/transport.py) and the ranks exchange them before
a global estimation tick (`allgather_robot_maps`).

Every collective here moves pickled host data through the process group's
own `allgather` on uint8 tensors: blobs padded to the largest, as the JAX
package's `process_allgather` exchange does. That runs on gloo in every
layout, two ranks on one card included (NCCL refuses a communicator whose
ranks share a card). `torch.distributed.all_gather_object` is not used: it
needs a registered group, and a group can be built directly from a store.
"""

from __future__ import annotations

import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from mapmerge_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    address: str | None = None, world_size: int | None = None,
    rank: int | None = None, timeout: float | None = None,
) -> None:
    """Join the job at `address` ("host:port" or "tcp://host:port") as
    `rank` of `world_size`, over gloo. A no-op if already joined or
    single-process, so it is safe to call unconditionally at start-up.

    `timeout` (seconds) bounds the join and every collective of the job, so
    a lost rank fails the others instead of holding them for gloo's default
    of 30 minutes."""
    if dist.is_initialized() or world_size is None or world_size <= 1:
        return
    if address is not None and "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        "gloo", init_method=address, world_size=world_size, rank=rank,
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout),
    )


def _world_group():
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def global_mesh(devices=None) -> Mesh:
    """A mesh over every rank of the job. Each rank brings `devices`: when
    None, every visible card if it runs alone, else its current card (one
    process per card: `torch.cuda.set_device(local_rank)` first)."""
    group = _world_group()
    if devices is None and group is not None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    return make_mesh(devices, group)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def allgather_objects(group, obj) -> list:
    """Every rank's `obj`, in rank order, on every rank (COLLECTIVE: every
    rank of `group` calls it in lockstep). `group` None: [obj]. The blobs
    are unpickled, so the group's ranks must be this job's own."""
    if group is None or group.size() == 1:
        return [obj]
    blob = torch.from_numpy(np.frombuffer(pickle.dumps(obj), np.uint8).copy())
    world = group.size()
    size = torch.tensor([blob.numel()], dtype=torch.int64)
    sizes = [torch.empty_like(size) for _ in range(world)]
    group.allgather([sizes], [size]).wait()
    longest = max(int(s) for s in sizes)
    padded = torch.zeros((longest,), dtype=torch.uint8)
    padded[: blob.numel()] = blob
    blobs = [torch.empty_like(padded) for _ in range(world)]
    group.allgather([blobs], [padded]).wait()
    return [
        pickle.loads(b[: int(s)].numpy().tobytes()) for b, s in zip(blobs, sizes)
    ]


def allgather_union(group, local: dict) -> dict:
    """The union of every rank's `local` dict, on every rank: the dicts
    merged with dict.update in rank order, so a later rank's entry wins on
    equal keys. COLLECTIVE, as allgather_objects."""
    merged: dict = {}
    for part in allgather_objects(group, dict(local)):
        merged.update(part)
    return merged


def allgather_robot_maps(local: dict, group=None) -> dict:
    """The union of every rank's latest robot maps, on every rank.

    `local` maps robot name -> (xyz, rgb | None) numpy arrays; `group` is
    the job's (the default group when None). A later rank's entry wins on
    equal names. COLLECTIVE: every rank calls it in lockstep, also with
    nothing to contribute."""
    return allgather_union(_world_group() if group is None else group, local)
