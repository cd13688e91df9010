"""High-level N-map merging API (port of mapmerge_tpu/pipeline/merging.py).

estimate_maps_transforms + compose_maps with the reference's contracts:
empty input -> [], a single cloud -> [identity], per-map failure -> zero
matrix; pairs are registered only where both keypoint sets are non-empty;
compose skips zero transforms and re-voxelizes at the output resolution.

The clouds are dealt over a mesh's devices and ranks for the feature stage
(`parallel/pair_shard.py`; without one, a mesh of the clouds' device alone,
which runs them in order there), then the pairs, then one host graph solve
(`mapmerge_torch.graph`, numpy). The reference registers all pairs of a
small-cloud merge in one device program with one fetch
(`_merge_all_pairs_fused`, `estimate_pairs_batch`, merging.py:87-139,
327-380) and takes per-pair programs only at or above `STAGED_THRESHOLD`
(merging.py:312). Here the branch is re-decided for the card on the engine
the pair stage's 1-NN takes: when the registration clouds take the dense
engine (below GRID_NN_THRESHOLD points), the pairs register in chunks of
`pair_chunk_size` through `registration.estimate_pairs_batch`, one packed
host fetch a chunk, since one pair of a few thousand points leaves most of
the card idle; clouds that take the grid 1-NN register pair by pair
(`register_pair`). Chunk c is always pairs [c*C, (c+1)*C) of the registered
pair list, C set by the clouds' capacity and the params alone, so every
pair is computed in the same batch on one rank or many. `MergeParams` is
importable from here.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.enums import EstimationMethod
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.graph.merge_graph import (
    TransformEstimate,
    compute_global_transforms,
)
from mapmerge_torch.graph.pose_graph import refine_global_transforms
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.neighbors import GRID_NN_THRESHOLD, _resolve_engine
from mapmerge_torch.parallel import pair_shard
from mapmerge_torch.parallel.mesh import make_mesh
from mapmerge_torch.pipeline.features import CloudFeatures
from mapmerge_torch.pipeline.registration import (
    estimate_pairs_batch,
    estimate_transform,
)

#: registration-cloud points (sources) in one chunk of the batched pair
#: stage: a chunk's (C, N, 3) clouds and 1-NN planes stay small
PAIR_CHUNK_POINTS = 1 << 20
#: hypothesis x keypoint slots in one chunk: RANSAC's (C, H, S) planes
PAIR_CHUNK_SLOTS = 1 << 24


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


def stack_features(features: Sequence[CloudFeatures]) -> CloudFeatures:
    """Features of one capacity stacked on a leading axis, field by field."""

    def stack(parts):
        first = parts[0]
        if torch.is_tensor(first):
            return torch.stack(parts)
        return dataclasses.replace(first, **{
            f.name: stack([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)
        })

    return stack(list(features))


def extract_features_batch(
    clouds: Sequence[PointCloud], params: MergeParams
) -> CloudFeatures:
    """The feature stage of each cloud, in order, at the clouds' common
    capacity, stacked on a leading axis (the reference's lax.map over the
    stacked batch is sequential too). It is the merge's own feature stage
    on a mesh of the first cloud's device; the merge keeps the features
    unstacked and each chunk stacks its pairs' (`register_chunk`)."""
    mesh = make_mesh([clouds[0].device])
    return stack_features(pair_shard.extract_features_sharded(clouds, params, mesh))


def pair_chunk_size(features: CloudFeatures, params: MergeParams) -> int:
    """Pairs in one chunk of the batched pair stage: as many as fit
    PAIR_CHUNK_POINTS registration points and PAIR_CHUNK_SLOTS hypothesis
    x keypoint slots, at least one. It depends on the clouds' capacity and
    the params alone (a registration cloud holds min(capacity, max_points)
    slots), never on the pairs or the ranks."""
    hyp = (params.ransac_hypotheses
           if params.estimation_method == EstimationMethod.MATCHING
           else params.sacia_hypotheses)
    slots = hyp * features.keypoints.xyz.shape[-2]
    return max(1, min(PAIR_CHUNK_POINTS // features.cloud.capacity,
                      PAIR_CHUNK_SLOTS // slots))


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


def register_chunk(
    sources: Sequence[CloudFeatures], targets: Sequence[CloudFeatures],
    params: MergeParams, seed: int, pairs: Sequence[tuple[int, int, int]],
) -> list[tuple[TransformEstimate, int]]:
    """Register `pairs` ((index among all pairs, i, j) for each source
    onto its target) in one batch on the features' device, each pair drawing
    from its own generator: register_pair's results, fetched to the host in
    one packed copy."""
    dev = sources[0].cloud.device
    est = estimate_pairs_batch(
        stack_features(sources), stack_features(targets), params,
        generators=[pair_generator(seed, k, dev) for k, _, _ in pairs],
    )
    packed = torch.cat([
        est.transform.reshape(-1, 16),
        torch.stack([
            est.confidence, est.ambiguous().to(torch.float32),
            est.scan_overflow.to(torch.float32),
        ], dim=1),
    ], dim=1).cpu().numpy()
    return [
        (TransformEstimate(
            source_idx=i,
            target_idx=j,
            transform=packed[b, :16].reshape(4, 4).copy(),
            confidence=float(packed[b, 16]),
            ambiguous=bool(packed[b, 17]),
        ), int(packed[b, 18]))
        for b, (_, i, j) in enumerate(pairs)
    ]


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

    # the dense engine's pairs register in batches; the grid's one by one
    batched = _resolve_engine(
        "auto", features[0].cloud.capacity, GRID_NN_THRESHOLD
    ) == "dense"
    chunk = pair_chunk_size(features[0], params) if batched else 1

    def register(c: int, sources: list, targets: list):
        members = pairs[c * chunk : (c + 1) * chunk]
        if batched:
            return register_chunk(sources, targets, params, seed, members)
        (k, i, j), = members
        return [register_pair(sources[0], targets[0], params, seed, i, j, k)]

    results = pair_shard.estimate_pairs_sharded(
        features, [(i, j) for _, i, j in pairs], register, mesh, stats, chunk
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
