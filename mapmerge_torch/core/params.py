"""Merge pipeline configuration (the port's copy of mapmerge_tpu/core/params.py).

The reference's `MapMergingParams` (map_merge_3d/include/map_merge_3d/
map_merging.h:28-70): the same 16 tunables with the same defaults, plus the
capacity knobs of the JAX package, field for field with its defaults
(tests/test_torch_graph.py holds the two equal). The derived radii are
evaluated from the default resolution once: overriding `resolution` alone
does not re-derive them (map_merging.cpp:10-98). Enum fields accept their
names as strings.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from mapmerge_torch.core.enums import (
    Descriptor,
    EstimationMethod,
    Keypoint,
    from_string,
)

_DEFAULT_RESOLUTION = 0.1
_ENUM_FIELDS = (
    ("keypoint_type", Keypoint),
    ("descriptor_type", Descriptor),
    ("estimation_method", EstimationMethod),
)


@dataclasses.dataclass(frozen=True)
class MergeParams:
    """All tunables for N-map transform estimation and compositing."""

    # ---- reference tunables (map_merging.h:29-44) ----
    resolution: float = _DEFAULT_RESOLUTION
    descriptor_radius: float = _DEFAULT_RESOLUTION * 8.0
    outliers_min_neighbours: int = 50
    normal_radius: float = _DEFAULT_RESOLUTION * 6.0
    keypoint_type: Keypoint = Keypoint.SIFT
    keypoint_threshold: float = 5.0
    descriptor_type: Descriptor = Descriptor.PFH
    estimation_method: EstimationMethod = EstimationMethod.MATCHING
    refine_transform: bool = True
    inlier_threshold: float = _DEFAULT_RESOLUTION * 5.0
    max_correspondence_distance: float = _DEFAULT_RESOLUTION * 5.0 * 2.0
    max_iterations: int = 500
    matching_k: int = 5
    transform_epsilon: float = 1e-2
    confidence_threshold: float = 0.0
    output_resolution: float = 0.05

    # ---- capacities and options of the JAX package (no reference analog) ----
    #: padded per-cloud point capacity at registration resolution
    max_points: int = 65536
    #: padded keypoint / descriptor capacity per cloud
    max_keypoints: int = 1024
    #: neighbour cap of the descriptor neighbourhoods
    max_neighbors: int = 64
    #: RANSAC hypotheses drawn at once
    ransac_hypotheses: int = 1024
    #: SAC-IA hypotheses drawn at once (the reference's sequential
    #: max_iterations, matching.cpp:159-173)
    sacia_hypotheses: int = 4096
    #: query tile of the dense neighbour engine
    neighbor_tile: int = 1024
    #: merge-graph edges weighted by coverage^2/score instead of the
    #: reference's 1/score (map_merging.cpp:265-268)
    robust_confidence: bool = True
    #: SIFT scale space (features.cpp:92: 3 octaves x 3 scales)
    sift_octaves: int = 3
    sift_scales_per_octave: int = 3
    #: per-iteration shrink of ICP's correspondence bound; 1.0 = PCL's
    #: fixed bound
    icp_anneal: float = 0.85
    #: neighbour engine: "dense" (exact tiled sweeps), "grid" (the cell
    #: grid of ops/grid.py) or "auto" (the grid at ops/neighbors'
    #: GRID_AUTO_THRESHOLD points, at GRID_NN_THRESHOLD for bounded 1-NN)
    neighbor_engine: str = "auto"
    #: candidates read per hash bucket under the grid engine; overflow is
    #: counted and surfaced (CloudFeatures.scan_overflow)
    grid_scan_cap: int = 128
    #: relax all confident pair edges after the MST chaining
    #: (graph/pose_graph.py); False = the reference's MST chaining only
    global_refinement: bool = True

    def __post_init__(self):
        for name, enum_cls in _ENUM_FIELDS:
            value = getattr(self, name)
            if isinstance(value, str) and not isinstance(value, enum_cls):
                object.__setattr__(self, name, from_string(enum_cls, value))

    @classmethod
    def strict_parity(cls, **overrides: Any) -> "MergeParams":
        """Params with the three departures from the reference switched
        off: `robust_confidence`, `icp_anneal` and `global_refinement`."""
        base = dict(
            robust_confidence=False, icp_anneal=1.0, global_refinement=False
        )
        base.update(overrides)
        return cls(**base)

    @property
    def registration_scan_cap(self) -> int:
        """Bucket capacity of the pair-stage grids (ICP correspondences,
        transform score): their cells are max_correspondence_distance wide,
        wider than the feature stage's, so twice grid_scan_cap and never
        less than 256."""
        return max(256, self.grid_scan_cap * 2)

    @classmethod
    def derived(cls, resolution: float = _DEFAULT_RESOLUTION, **overrides: Any):
        """Params with the radii re-derived from `resolution` (the reference
        derives them from the default only, map_merging.h:29-38); explicit
        overrides still win."""
        derived_fields = dict(
            resolution=resolution,
            descriptor_radius=resolution * 8.0,
            normal_radius=resolution * 6.0,
            inlier_threshold=resolution * 5.0,
            max_correspondence_distance=resolution * 10.0,
        )
        if "inlier_threshold" in overrides and (
            "max_correspondence_distance" not in overrides
        ):
            derived_fields["max_correspondence_distance"] = (
                overrides["inlier_threshold"] * 2.0
            )
        derived_fields.update(overrides)
        return cls(**derived_fields)

    @classmethod
    def command_line_overrides(cls, argv: list[str]) -> dict[str, Any]:
        """The `--field value` overrides in argv (MapMergingParams::
        fromCommandLine, map_merging.cpp:10-54); matching_k only when > 0
        (map_merging.cpp:44-47)."""
        overrides: dict[str, Any] = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg.startswith("--"):
                name = arg[2:]
                if name in fields and i + 1 < len(argv):
                    overrides[name] = _parse_field(fields[name], argv[i + 1])
                    i += 2
                    continue
            i += 1
        if "matching_k" in overrides and overrides["matching_k"] <= 0:
            del overrides["matching_k"]
        return overrides

    @classmethod
    def from_command_line(cls, argv: list[str]) -> "MergeParams":
        """Params from `--field value` arguments (map_merging.cpp:10-54)."""
        return cls(**cls.command_line_overrides(argv))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MergeParams":
        """Params from a mapping (the ROS-params analog,
        map_merging.cpp:56-98); unknown keys are ignored."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        overrides = {
            k: _parse_field(fields[k], v) for k, v in d.items() if k in fields
        }
        if "matching_k" in overrides and overrides["matching_k"] <= 0:
            del overrides["matching_k"]
        return cls(**overrides)

    def replace(self, **overrides: Any) -> "MergeParams":
        return dataclasses.replace(self, **overrides)

    def __str__(self) -> str:
        # one "field: value" line each (operator<<, map_merging.cpp:100-123)
        return "\n".join(
            f"{f.name}: {getattr(self, f.name)}" for f in dataclasses.fields(self)
        )


def _parse_field(field: dataclasses.Field, raw: Any) -> Any:
    """`raw` (a string or a value) as the type of `field`."""
    if field.type in ("float", float):
        return float(raw)
    if field.type in ("int", int):
        return int(raw)
    if field.type in ("bool", bool):
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    for name, enum_cls in _ENUM_FIELDS:
        if field.name == name:
            return from_string(enum_cls, raw) if isinstance(raw, str) else raw
    return raw
