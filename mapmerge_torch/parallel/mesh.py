"""The device mesh of the pair axis (port of mapmerge_tpu/parallel/mesh.py).

The reference parallelises nothing (sequential loops over clouds and pairs,
map_merging.cpp:211-269); the JAX package shards the cloud axis and the
pair axis over a `jax.sharding.Mesh`. Here a mesh is this rank's local
devices plus an optional `torch.distributed` process group: the ranks of
the group each own their devices, and items (clouds or pairs) are dealt to
the global slots round-robin. Item k goes to slot k % (world * n_local),
which is device `slot % n_local` of rank `slot // n_local`. One mesh serves
both stages. Shares may be uneven: nothing is padded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from mapmerge_torch.core.device import default_device

PAIR_AXIS = "pairs"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's local devices, its process group (None: one rank alone),
    its rank and the group's size."""

    devices: tuple[torch.device, ...]
    group: Optional[object] = None  # a torch.distributed ProcessGroup
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Global slots: every rank's local devices."""
        return self.world * len(self.devices)

    def owner(self, k: int) -> int:
        """The rank of item k's slot."""
        return (k % self.size) // len(self.devices)

    def local_index(self, k: int) -> int:
        """The index in its owner's `devices` of item k's device."""
        return (k % self.size) % len(self.devices)

    def mine(self, n: int) -> list[int]:
        """The items of range(n) that this rank owns."""
        return [k for k in range(n) if self.owner(k) == self.rank]


def make_mesh(devices: Sequence | None = None, group=None) -> Mesh:
    """A mesh over `devices` (every visible card when None; raises without
    one) in `group` (None: world 1, as the JAX package's mesh over one
    host's chips)."""
    if devices is None:
        default_device()  # raises where there is no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    if group is None:
        return Mesh(devices)
    return Mesh(devices, group, rank=group.rank(), world=group.size())


def pad_to_multiple(n: int, devices: int) -> int:
    return -(-n // devices) * devices
