"""Pluggable map transport (the port's copy of mapmerge_tpu/runtime/transport.py).

The reference distributes maps over ROS pub/sub, each robot's map a
PointCloud2 topic discovered by name pattern (map_merge_node.cpp:57-100,
189-208). Here transport is an interface:

  - InProcTransport: robots are registered by code and push clouds; the
    node polls for new robots (discovery) and fetches each robot's latest
    cloud (the subscription callback's analog);
  - DirectoryTransport: watches a directory for `<robot>.pcd` or
    `<robot>/map.pcd` files (the analog of launch/from_pcds.launch).

Every method is thread-safe; `latest()` hands out an immutable snapshot.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from mapmerge_torch.io.pcd import read_pcd_arrays


class Transport:
    """Interface: discovery and latest-map fetch."""

    def discover(self) -> list[str]:
        """Names of all currently known robots."""
        raise NotImplementedError

    def latest(self, robot: str):
        """Latest (version, xyz, rgb) for `robot`, or None."""
        raise NotImplementedError


class InProcTransport(Transport):
    def __init__(self):
        self._lock = threading.Lock()
        self._maps: dict[str, tuple[int, np.ndarray, Optional[np.ndarray]]] = {}

    def publish(self, robot: str, xyz: np.ndarray, rgb=None) -> None:
        """Robot side: publish a new full map (robots republish their whole
        map each time, doc/wiki.txt:12-14)."""
        xyz = np.asarray(xyz, np.float32)
        with self._lock:
            version = self._maps.get(robot, (0, None, None))[0] + 1
            self._maps[robot] = (version, xyz, rgb)

    def discover(self) -> list[str]:
        with self._lock:
            return sorted(self._maps)

    def latest(self, robot: str):
        with self._lock:
            return self._maps.get(robot)


class DirectoryTransport(Transport):
    """Watches `root/<robot>.pcd` (or `root/<robot>/map.pcd`) files; a
    file's modification time is its version."""

    def __init__(self, root: str):
        self.root = root

    def _paths(self) -> dict[str, str]:
        out = {}
        if not os.path.isdir(self.root):
            return out
        for entry in sorted(os.listdir(self.root)):
            full = os.path.join(self.root, entry)
            if entry.endswith(".pcd") and os.path.isfile(full):
                out[entry[:-4]] = full
            elif os.path.isdir(full):
                mp = os.path.join(full, "map.pcd")
                if os.path.isfile(mp):
                    out[entry] = mp
        return out

    def discover(self) -> list[str]:
        return sorted(self._paths())

    def latest(self, robot: str):
        path = self._paths().get(robot)
        if path is None:
            return None
        version = int(os.stat(path).st_mtime_ns)
        xyz, rgb = read_pcd_arrays(path)
        return version, xyz, rgb
