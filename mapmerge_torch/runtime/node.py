"""Online merge node (port of mapmerge_tpu/runtime/node.py).

The reference's ROS node (class MapMerge3d, src/map_merge_node.cpp and
include/map_merge_3d/map_merge_node.h): three periodic jobs at their own
rates,

  - discovery (default 0.05 Hz): robots newly publishing on the transport
    (the topic-pattern scan, map_merge_node.cpp:57-100);
  - transforms estimation (default 0.01 Hz): stateless by default, a full
    re-estimation from the latest maps exactly as the reference does
    (map_merge_node.cpp:133-153); with `incremental=True`, new and updated
    maps are localized against a world model (pipeline/incremental.py);
  - map compositing (default 0.3 Hz): the latest maps composed with the
    latest transforms, over the maps known at the last estimation
    (clouds.resize, map_merge_node.cpp:114-116);

plus a pose callback (the tf broadcast, map_merge_node.cpp:231-249) that
receives (robot, 4x4 world pose), a zero pose for a failed map
(doc/wiki.txt:183). The transport snapshots under its own lock, results sit
under the node's lock, and the latest merged map stays latched for late
readers (map_merge_node.cpp:28).

The node's device is fixed when it is built: its jobs run on threads of
their own, whose current CUDA device is not the caller's, so every cloud
goes to `self.device` by name.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.device import resolve
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.parallel import multihost
from mapmerge_torch.pipeline.incremental import WorldModel, features_for
from mapmerge_torch.pipeline.merging import compose_maps, estimate_maps_transforms
from mapmerge_torch.runtime.transport import Transport
from mapmerge_torch.utils.metrics import MetricsRegistry, maybe_sink


def _crc(text: str) -> int:
    """A stable 31-bit hash of `text` (str hashes are salted per process)."""
    return zlib.crc32(text.encode()) & 0x7FFFFFFF


class MapMergeNode:
    def __init__(
        self,
        transport: Transport,
        params: Optional[MergeParams] = None,
        compositing_rate: float = 0.3,
        discovery_rate: float = 0.05,
        estimation_rate: float = 0.01,
        world_frame: str = "world",
        mesh=None,
        pose_callback: Optional[Callable[[str, np.ndarray], None]] = None,
        seed: int = 0,
        incremental: bool = False,
        max_robots: int = 64,
        metrics_log: Optional[str] = None,
        device=None,
    ):
        """`device`: where the node's clouds live (the current CUDA device
        when None; raises without a card). `mesh` (`parallel/mesh.Mesh`):
        the stateless estimation deals its clouds and pairs over the mesh,
        and when the mesh spans ranks every tick exchanges the robots' maps
        first (`_global_maps`). Incremental mode ignores it: its world model
        is per node."""
        self.device = resolve(device)
        self.mesh = mesh
        self.transport = transport
        self.params = params or MergeParams()
        self.rates = {
            "compositing": compositing_rate,
            "discovery": discovery_rate,
            "estimation": estimation_rate,
        }
        self.world_frame = world_frame
        self.pose_callback = pose_callback
        self.seed = seed
        #: incremental register-to-world mode; False = the reference's
        #: stateless re-estimation (map_merge_node.cpp:141-142)
        self.incremental = incremental
        self._world: Optional[WorldModel] = None
        self._max_robots = max_robots
        self._feat_cache: dict[str, tuple] = {}  # robot -> (version, features)

        self._lock = threading.Lock()
        self._robots: list[str] = []  # discovery order = node index order
        self._transforms: dict[str, np.ndarray] = {}
        self._estimated_robots: list[str] = []
        self._merged: Optional[PointCloud] = None
        self._merged_stamp: float = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._ticks = {"compositing": 0, "discovery": 0, "estimation": 0}
        self._stats = {"subsampled_points": 0}
        #: counters, gauges and per-job timings (utils/metrics.py); each
        #: estimation tick also writes one record to `metrics_log` (JSONL)
        self.metrics = MetricsRegistry()
        self._metrics_sink = maybe_sink(metrics_log)

    # ---- thread-safe accessors (map_merge_node.h:84-120) ----
    def get_robots(self) -> list[str]:
        with self._lock:
            return list(self._robots)

    def get_transforms(self) -> dict[str, np.ndarray]:
        with self._lock:
            return {k: v.copy() for k, v in self._transforms.items()}

    def get_merged_map(self) -> Optional[PointCloud]:
        with self._lock:
            return self._merged  # latched (map_merge_node.cpp:28-29)

    def get_metrics(self) -> dict:
        """Counters, gauges and per-job timing summaries."""
        return self.metrics.snapshot()

    def get_stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    # ---- periodic jobs ----
    def discovery(self) -> None:
        with self.metrics.time_stage("discovery"):
            found = self.transport.discover()
            with self._lock:
                for robot in found:
                    if robot not in self._robots:
                        self._robots.append(robot)
                        self.metrics.inc("robots_discovered")
                self._ticks["discovery"] += 1
                self.metrics.set_gauge("robots_known", len(self._robots))

    def _snapshot_clouds(self, robots: list[str]):
        """The latest map of each robot that has one: (robots, [(xyz, rgb)])."""
        clouds, kept = [], []
        for robot in robots:
            latest = self.transport.latest(robot)
            if latest is None:
                continue
            _, xyz, rgb = latest
            kept.append(robot)
            clouds.append((xyz, rgb))
        return kept, clouds

    def _global_maps(self, kept: list[str], raw: list):
        """The union of every rank's snapshot, by robot name, when the
        node's mesh spans ranks (per-rank ingest, one exchange, the same
        input on every rank; parallel/multihost.py); as given otherwise.

        COLLECTIVE when the mesh spans ranks: every rank's node drives its
        estimation and compositing ticks in lockstep (`start()`'s timers are
        for a node alone; a job ticks the jobs from its own loop)."""
        if self.mesh is None or self.mesh.world == 1:
            return kept, raw
        merged = multihost.allgather_robot_maps(
            dict(zip(kept, raw)), group=self.mesh.group
        )
        names = sorted(merged)
        return names, [merged[r] for r in names]

    def _fit_to_capacity(self, xyz, rgb, cap: int, robot: str):
        """Bound a raw cloud to `cap` points by a uniform random subsample
        (not a head cut, which keeps whatever came first: a spatially biased
        cut), drawn from the robot's name and the node's seed; returns
        (xyz, rgb, points dropped)."""
        n = len(xyz)
        if n <= cap:
            return xyz, rgb, 0
        rng = np.random.default_rng(_crc(f"{robot}/{self.seed}") or 1)
        keep = rng.choice(n, size=cap, replace=False)
        keep.sort()
        return xyz[keep], None if rgb is None else rgb[keep], n - cap

    def _cloud(self, xyz, rgb, cap: int) -> PointCloud:
        return PointCloud.from_numpy(xyz, rgb, capacity=cap, device=self.device)

    def _transforms_estimation_incremental(self) -> None:
        """Extract features only for new and updated maps, localize them
        against the world model, keep every other map's pose, then relax
        the world's edges."""
        if self._world is None:
            self._world = WorldModel(self.params, max_maps=self._max_robots)
        world = self._world

        robots = self.get_robots()
        cap = self.params.max_points
        updated: list[str] = []
        for robot in robots:
            latest = self.transport.latest(robot)
            if latest is None:
                continue
            stamp, xyz, rgb = latest
            cached = self._feat_cache.get(robot)
            if cached is not None and cached[0] == stamp:
                continue
            xyz, rgb, dropped = self._fit_to_capacity(xyz, rgb, cap, robot)
            if dropped:
                with self._lock:
                    self._stats["subsampled_points"] += dropped
            feats = features_for(self._cloud(xyz, rgb, cap), self.params)
            self._feat_cache[robot] = (stamp, feats)
            updated.append(robot)

        tick = self._ticks["estimation"]

        def _n_desc(robot: str) -> int:
            f = self._feat_cache[robot][1]
            return int((f.descriptors.valid & f.keypoints.mask).sum())

        seeded = None
        if not world.entries:
            # the first map anchors the world frame (identity): the most
            # featureful one (a featureless anchor strands everyone)
            candidates = [r for r in robots if r in self._feat_cache]
            if candidates:
                robot = max(candidates, key=_n_desc)
                world.add(
                    robot, self._feat_cache[robot][1],
                    np.eye(4, dtype=np.float32),
                )
                seeded = robot
        # localize every map not registered yet, and the updated ones
        pending = [
            r for r in robots
            if r in self._feat_cache
            and r != seeded
            and (r not in world or r in updated)
        ]
        # a map may register only after an earlier map of the same tick
        # joined the world (chains of views): retry while a round progresses
        still: list[str] = []
        for n_retry in range(max(2, len(pending))):
            still = []
            for robot in pending:
                feats = self._feat_cache[robot][1]
                res = world.localize(
                    feats, (self.seed, _crc(f"{robot}/{tick}/{n_retry}"))
                )
                if res is None:
                    still.append(robot)
                    continue
                world.add(robot, feats, res.pose)
                world.add_edges(robot, res.edges)
            if not still or len(still) == len(pending):
                break  # done, or no progress this round
            pending = still

        # a lone anchor that attracted nobody may itself be the problem (a
        # degenerate map that was the most featureful at seed time): while
        # the world holds one map, re-anchoring moves no other pose
        if (
            len(world.entries) == 1
            and still
            and max(map(_n_desc, still)) > _n_desc(world.entries[0].name)
        ):
            self._world = world = WorldModel(self.params, max_maps=self._max_robots)
            robot = max(still, key=_n_desc)
            world.add(
                robot, self._feat_cache[robot][1], np.eye(4, dtype=np.float32)
            )
            for other in [r for r in still if r != robot]:
                feats = self._feat_cache[other][1]
                res = world.localize(
                    feats, (self.seed, _crc(f"{other}/{tick}/reseed"))
                )
                if res is not None:
                    world.add(other, feats, res.pose)
                    world.add_edges(other, res.edges)

        # loop closure: relax the accumulated edges so stream drift is
        # corrected within the stream
        if self.params.global_refinement:
            world.refine(self.params.confidence_threshold)
        self.metrics.set_gauge("world_edges", len(world.edges))
        self.metrics.set_gauge(
            "world_edges_ambiguous", sum(1 for e in world.edges if e.ambiguous)
        )

        with self._lock:
            self._transforms = {
                r: (
                    world.pose_of(r).copy()
                    if r in world
                    else np.zeros((4, 4), np.float32)
                )
                for r in robots
            }
            self._estimated_robots = list(robots)
            self._ticks["estimation"] += 1
        self._publish_poses()

    def transforms_estimation(self) -> None:
        """One estimation tick; its wall time, map counts and registration
        outcomes go to `self.metrics` (and the JSONL sink when set)."""
        t0 = time.perf_counter()
        with self.metrics.time_stage("estimation"):
            if self.incremental:
                self._transforms_estimation_incremental()
            else:
                self._transforms_estimation_stateless()
        wall = time.perf_counter() - t0
        with self._lock:
            transforms = dict(self._transforms)
            tick = self._ticks["estimation"]
            subsampled = self._stats["subsampled_points"]
        registered = sum(1 for t in transforms.values() if t.any())
        failed = len(transforms) - registered
        self.metrics.set_gauge("maps_registered", registered)
        self.metrics.set_gauge("maps_failed", failed)
        if self._metrics_sink is not None:
            self._metrics_sink.write(
                {
                    "ts": time.time(),
                    "job": "estimation",
                    "tick": tick,
                    "wall_s": round(wall, 4),
                    "mode": "incremental" if self.incremental else "stateless",
                    "maps_in": len(transforms),
                    "maps_registered": registered,
                    "maps_failed": failed,
                    "subsampled_points": subsampled,
                }
            )

    def _transforms_estimation_stateless(self) -> None:
        """Full re-estimation from the latest maps (map_merge_node.cpp:141-142)."""
        kept, raw = self._snapshot_clouds(self.get_robots())
        # the exchange comes before the guard: every rank joins the
        # collective, also one that has no map yet
        kept, raw = self._global_maps(kept, raw)
        if not kept:
            return
        cap = min(max(len(x) for x, _ in raw), self.params.max_points)
        clouds = []
        dropped_total = 0
        for robot, (x, r) in zip(kept, raw):
            x, r, dropped = self._fit_to_capacity(x, r, cap, robot)
            dropped_total += dropped
            clouds.append(self._cloud(x, r, cap))
        if dropped_total:
            with self._lock:
                self._stats["subsampled_points"] += dropped_total
            print(
                f"[estimation] input exceeds max_points={self.params.max_points}; "
                f"randomly subsampled {dropped_total} points this tick",
                flush=True,
            )
        info: dict = {}
        transforms = estimate_maps_transforms(
            clouds, self.params, seed=self.seed, mesh=self.mesh, info_out=info
        )
        # registration-time ambiguity flags are an operator-visible condition
        self.metrics.set_gauge("pairs_registered", info.get("n_pairs", 0))
        self.metrics.set_gauge("pairs_ambiguous", info.get("n_ambiguous", 0))
        if info.get("n_ambiguous"):
            self.metrics.inc("ambiguous_registrations", info["n_ambiguous"])
        with self._lock:
            self._transforms = {
                robot: np.asarray(
                    transforms[i] if i < len(transforms)
                    else np.zeros((4, 4), np.float32),
                    np.float32,
                )
                for i, robot in enumerate(kept)
            }
            self._estimated_robots = kept
            self._ticks["estimation"] += 1
        self._publish_poses()

    def map_compositing(self) -> None:
        with self.metrics.time_stage("compositing"):
            self._map_compositing_impl()
        merged = self.get_merged_map()
        if merged is not None:
            self.metrics.set_gauge("merged_points", int(merged.count))

    def _map_compositing_impl(self) -> None:
        with self._lock:
            est_robots = list(self._estimated_robots)
            transforms = {r: self._transforms.get(r) for r in est_robots}
        kept, raw = self._snapshot_clouds(self.get_robots())
        kept, raw = self._global_maps(kept, raw)  # collective first, guards after
        if not est_robots:
            return
        have = dict(zip(kept, raw))
        # the maps known at the last estimation (map_merge_node.cpp:114-116)
        robots = [
            r for r in est_robots if r in have and transforms[r] is not None
        ]
        if not robots:
            return
        raw_sel = [have[r] for r in robots]
        cap = max(len(x) for x, _ in raw_sel)
        merged = compose_maps(
            [self._cloud(x, r, cap) for x, r in raw_sel],
            [transforms[r] for r in robots],
            self.params.output_resolution,
        )
        with self._lock:
            self._merged = merged
            self._merged_stamp = time.time()
            self._ticks["compositing"] += 1

    def _publish_poses(self) -> None:
        if self.pose_callback is None:
            return
        for robot, t in self.get_transforms().items():
            # a failed map's zero transform is published as is (wiki.txt:183)
            self.pose_callback(robot, t)

    # ---- lifecycle ----
    def start(self) -> None:
        def loop(name: str, fn: Callable[[], None]):
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)  # per thread
            period = 1.0 / self.rates[name]
            while not self._stop.is_set():
                t0 = time.time()
                try:
                    fn()
                except Exception as e:  # keep the loop alive (ROS spinner)
                    print(f"[{name}] error: {e!r}", flush=True)
                dt = time.time() - t0
                self._stop.wait(max(0.0, period - dt))

        jobs = {
            "discovery": self.discovery,
            "estimation": self.transforms_estimation,
            "compositing": self.map_compositing,
        }
        for name, fn in jobs.items():
            th = threading.Thread(
                target=loop, args=(name, fn), name=f"mapmerge-{name}",
                daemon=True,
            )
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30.0)
        self._threads.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
