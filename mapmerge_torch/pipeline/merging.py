"""High-level N-map merging API (port of mapmerge_tpu/pipeline/merging.py).

estimate_maps_transforms + compose_maps with the reference's contracts:
empty input -> [], a single cloud -> [identity], per-map failure -> zero
matrix; pairs are registered only where both keypoint sets are non-empty;
compose skips zero transforms and re-voxelizes at the output resolution.

The clouds and pairs are dealt over a mesh's devices and ranks
(`parallel/pair_shard.py`; without one, a mesh of the clouds' device alone,
which runs them in order there), then one host graph solve (`mapmerge_torch.graph`, numpy). That is the
reference's big-cloud path (merging.py:312-326, 404-410: per-cloud stages,
per-pair registration at a common capacity) at every size, so the port needs
no separate branch for it. `MergeParams` is importable from here.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.graph.merge_graph import (
    TransformEstimate,
    compute_global_transforms,
)
from mapmerge_torch.graph.pose_graph import refine_global_transforms
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.parallel import pair_shard
from mapmerge_torch.parallel.mesh import make_mesh
from mapmerge_torch.pipeline.features import CloudFeatures
from mapmerge_torch.pipeline.registration import estimate_transform


def seeded_generator(entropy: Sequence[int], device) -> torch.Generator:
    """A generator on `device` seeded from np.random.SeedSequence(entropy):
    the port's counterpart of folding integers into a JAX key (torch cannot
    replay JAX's key stream, so parity is checked at the pose level)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def pair_generator(seed: int, pair_index: int, device) -> torch.Generator:
    """RANSAC generator of one pair, keyed on (seed, the pair's index in the
    full i<j enumeration), so a pair draws the same hypotheses whichever
    other pairs are skipped."""
    return seeded_generator([seed, pair_index], device)


def _warn_feature_caps(
    dropped: np.ndarray, scan_overflow: np.ndarray, kp_truncated: np.ndarray
) -> None:
    """Surface the feature stage's caps: no silent caps."""
    if dropped.sum() > 0:
        per_cloud = ", ".join(
            f"cloud {i}: {int(d)}" for i, d in enumerate(dropped) if d > 0
        )
        warnings.warn(
            "voxel grid overflowed max_points and dropped valid points "
            f"({per_cloud}); raise MergeParams.max_points or coarsen "
            "resolution to keep all geometry",
            stacklevel=3,
        )
    if scan_overflow.max(initial=0) > 0:
        warnings.warn(
            "grid neighbor engine: fullest hash bucket exceeds "
            f"grid_scan_cap by {int(scan_overflow.max())} points — neighbor "
            "queries may be truncated; raise MergeParams.grid_scan_cap",
            stacklevel=3,
        )
    if kp_truncated.sum() > 0:
        per_cloud = ", ".join(
            f"cloud {i}: {int(d)}" for i, d in enumerate(kp_truncated) if d > 0
        )
        warnings.warn(
            "keypoint cap: above-threshold detections beyond max_keypoints "
            f"were dropped, keeping the top responses ({per_cloud}); the "
            "reference keeps every above-threshold keypoint — raise "
            "MergeParams.max_keypoints to match",
            stacklevel=3,
        )


def _warn_pair_overflow(overflow: np.ndarray) -> None:
    """Surface the pair stage's query-side grid overflow: ICP and the score
    query the moved SOURCE against the target's grid, and a source denser
    than the target's buckets loses correspondences there, which the
    per-cloud probe cannot see."""
    if overflow.max(initial=0) > 0:
        warnings.warn(
            "grid neighbor engine: up to "
            f"{int(overflow.max())} source query points per pair overflowed "
            "the target grid's query-side bucket cap during ICP/scoring — "
            "correspondences were dropped; raise MergeParams.grid_scan_cap "
            "or coarsen resolution",
            stacklevel=3,
        )


def register_pair(
    source: CloudFeatures, target: CloudFeatures, params: MergeParams,
    seed: int, i: int, j: int, pair_index: int,
) -> tuple[TransformEstimate, int]:
    """Register cloud i onto cloud j on the features' device, drawing from
    the pair's own generator: (the graph's estimate, the pair's scan
    overflow), both on the host."""
    est = estimate_transform(
        source, target, params,
        generator=pair_generator(seed, pair_index, source.cloud.device),
    )
    return TransformEstimate(
        source_idx=i,
        target_idx=j,
        transform=est.transform.cpu().numpy(),
        confidence=float(est.confidence),
        ambiguous=bool(est.ambiguous()),
    ), int(est.scan_overflow)


def estimate_maps_transforms(
    clouds: Sequence[PointCloud],
    params: MergeParams | None = None,
    seed: int = 0,
    mesh=None,
    info_out: dict | None = None,
) -> list[np.ndarray]:
    """Per-map SE(3) transforms into a common frame (reference
    estimateMapsTransforms, map_merging.cpp:188-275).

    Returns numpy (4, 4) float32 matrices; a zero matrix means "could not
    register". `info_out`, when given, receives the number of pairs
    registered, failed and flagged ambiguous.

    With `mesh` (`parallel/mesh.Mesh`), clouds and pairs are dealt over its
    slots (`parallel/pair_shard.py`): every rank of its group calls this with
    the same clouds, in lockstep, and every rank gets the transforms of the
    single-rank call, bit for bit. `info_out["mesh"]` then says what this
    rank took: its clouds, its pairs, and the seconds it spent in the
    gathers, waiting for the other ranks included."""
    params = params or MergeParams()
    clouds = list(clouds)
    if not clouds:
        return []
    if len(clouds) == 1:
        return [np.eye(4, dtype=np.float32)]

    stats: dict = {"rank": 0 if mesh is None else mesh.rank, "gather_s": 0.0}
    if info_out is not None and mesh is not None:
        info_out["mesh"] = stats
    mesh = mesh or make_mesh([clouds[0].device])
    features = pair_shard.extract_features_sharded(clouds, params, mesh, stats)
    kp_counts = [int(f.keypoints.mask.sum()) for f in features]
    _warn_feature_caps(
        np.array([int(f.dropped_points) for f in features]),
        np.array([int(f.scan_overflow) for f in features]),
        np.array([int(f.keypoints.truncated) for f in features]),
    )

    n = len(clouds)
    all_pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
    # reference pair generation: both keypoint sets non-empty
    # (map_merging.cpp:246-254); each pair keeps its index in all_pairs
    pairs = [
        (k, i, j) for k, (i, j) in enumerate(all_pairs)
        if kp_counts[i] > 0 and kp_counts[j] > 0
    ]

    def register(m: int, source: CloudFeatures, target: CloudFeatures):
        k, i, j = pairs[m]
        return register_pair(source, target, params, seed, i, j, k)

    results = pair_shard.estimate_pairs_sharded(
        features, [(i, j) for _, i, j in pairs], register, mesh, stats
    )
    estimates = [est for est, _ in results]
    _warn_pair_overflow(np.array([o for _, o in results], dtype=np.int64))
    if info_out is not None:
        info_out["n_pairs"] = len(estimates)
        info_out["n_failed"] = sum(1 for e in estimates if not e.transform.any())
        info_out["n_ambiguous"] = sum(1 for e in estimates if e.ambiguous)
        info_out["ambiguous_pairs"] = [
            (e.source_idx, e.target_idx) for e in estimates if e.ambiguous
        ]
    if not estimates:
        return []
    return _solve_graph(estimates, params)


def _solve_graph(estimates, params: MergeParams) -> list[np.ndarray]:
    """MST chaining (reference semantics) + optional all-edge relaxation."""
    global_t = compute_global_transforms(estimates, params.confidence_threshold)
    if params.global_refinement:
        global_t = refine_global_transforms(
            estimates, global_t, params.confidence_threshold
        )
    return global_t


def compose_maps(
    clouds: Sequence[PointCloud],
    transforms: Sequence[np.ndarray],
    resolution: float,
    out_capacity: int | None = None,
) -> PointCloud | None:
    """Transform and concatenate the full-resolution clouds, then voxelize
    at `resolution` (reference composeMaps, map_merging.cpp:277-305)."""
    clouds = list(clouds)
    if not clouds:
        return None
    if len(clouds) != len(transforms):
        raise ValueError(
            "composeMaps: clouds and transforms size must be the same."
        )
    parts = []
    for cloud, transform in zip(clouds, transforms):
        t = np.asarray(transform, np.float32)
        if not t.any():  # zero transform -> skip (map_merging.cpp:293-295)
            continue
        moved = tf.apply(torch.from_numpy(t).to(cloud.device), cloud.xyz)
        parts.append((moved, cloud.rgb, cloud.mask))
    if not parts:
        # all transforms zero: the reference returns an empty cloud
        return PointCloud.from_numpy(
            np.zeros((0, 3), np.float32), capacity=1, device=clouds[0].device
        )
    merged = PointCloud(
        xyz=torch.cat([p[0] for p in parts]),
        rgb=torch.cat([p[1] for p in parts]),
        mask=torch.cat([p[2] for p in parts]),
    ).park_invalid()
    return voxel_downsample(merged, resolution, out_capacity=out_capacity)
