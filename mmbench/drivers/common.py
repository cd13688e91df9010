"""What the drivers share: the scenes, the parameters, the seeded sample of
outputs and its capture, and the hand-over to the judge."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mmbench import harness
from mmbench.traffic import scene as scene_views

#: the program's functions that compute a keypoint detector's field inside
#: a feature extraction -> (the field's name, the cloud's xyz it is of)
FIELDS = {
    "mapmerge_torch.ops.keypoints.harris:GridRoute.response":
        ("HARRIS", lambda route, *a, **k: route.q),
    "mapmerge_torch.ops.keypoints.harris:harris_response":
        ("HARRIS", lambda cloud, *a, **k: cloud.xyz),
    "mapmerge_torch.ops.keypoints.sift:_scale_space":
        ("SIFT", lambda cloud, *a, **k: cloud.xyz),
}


def placement(rng: np.random.Generator, yaw_deg: float, shift_m: float) -> np.ndarray:
    """A rigid placement drawn by `rng`: a yaw of up to `yaw_deg` either
    way and a horizontal shift of up to `shift_m` on each axis."""
    yaw = np.radians(yaw_deg)
    return scene_views.se3(scene_views.rotation_z(rng.uniform(-yaw, yaw)),
                           [*rng.uniform(-shift_m, shift_m, 2), 0.0])


def scenes(traffic: dict, seed: int) -> list[tuple[list, list, int]]:
    """The traffic's scenes, made from the seed: for each of the mix's
    towns (`scene_seeds`: the same layouts, so the same work, in every
    run), its views ((xyz, rgb) float32 host arrays), each moved by a
    placement drawn from the seed with its SE(3) truth following it, the
    truths, and the seed of the program's random draws (RANSAC, the
    node's) on that scene, drawn from the seed too."""
    out = []
    for k, town in enumerate(traffic["scene_seeds"]):
        views, truths = scene_views.town_views(traffic["maps"], traffic["view_resized_target"],
                                               keep=traffic["keep"], seed=town)
        rng = np.random.default_rng([seed, 13, k])
        placed, moved = [], []
        for (xyz, rgb), truth in zip(views, truths):
            # world = truth @ local, and the view is now place @ local
            place = placement(rng, traffic["yaw_deg"], traffic["shift_m"])
            placed.append(((xyz @ place[:3, :3].T + place[:3, 3]).astype(np.float32), rgb))
            moved.append((truth @ np.linalg.inv(place)).astype(np.float32))
        out.append((placed, moved, int(rng.integers(0, 2**31 - 1))))
    return out


class SceneOrder:
    """Which scene each unit takes: the scenes in rounds, each round in an
    order drawn from the seed, so that every scene takes its share."""

    def __init__(self, seed: int, n_scenes: int):
        self.rng = np.random.default_rng([seed, 11])
        self.n, self.queue = n_scenes, []

    def next(self) -> int:
        if not self.queue:
            self.queue = [int(k) for k in self.rng.permutation(self.n)]
        return self.queue.pop(0)


def next_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


def merge_params(config: dict):
    from mapmerge_torch.core.params import MergeParams

    return MergeParams(**config["params"])


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """One unit's outputs, drawn uniformly from the seed among all units
    (a reservoir of one): unit k replaces the kept one with probability
    1 / k. The draw is made before the unit runs, with the `judged` of its
    `maps` extractions whose features the judge reads, so that a unit that
    is not kept holds nothing."""

    def __init__(self, seed: int, judged: int):
        self.rng = np.random.default_rng([seed, 3])
        self.judged = judged
        self.offered = 0
        self.kept = None

    def draw(self, maps: int) -> set[int]:
        """The extractions of the next unit to capture: none where it is
        not kept."""
        self.offered += 1
        if self.rng.random() * self.offered >= 1.0:
            return set()
        return {int(i) for i in self.rng.choice(maps, size=min(self.judged, maps), replace=False)}


class Capture:
    """Within the block, the results of the chosen extractions of the
    feature stage's entry `target` (by call order) and the detector field
    (FIELDS) each computed on its own cloud inside them."""

    def __init__(self, target: str, chosen: set[int]):
        self.target, self.chosen = target, chosen
        self.calls, self.current = 0, None
        self.features: dict[int, object] = {}
        self.fields: dict[int, list] = {}

    def _entry(self, fn):
        def kept(*args, **kwargs):
            i = self.calls
            self.calls += 1
            self.current = i if i in self.chosen else None
            try:
                out = fn(*args, **kwargs)
            finally:
                self.current = None
            if i in self.chosen:
                self.features[i] = out
            return out

        return kept

    def _field(self, name, key):
        def wrap(fn):
            def kept(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.current is not None:
                    self.fields.setdefault(self.current, []).append(
                        (name, key(*args, **kwargs), out))
                return out

            return kept

        return wrap

    @contextlib.contextmanager
    def active(self):
        wrappers = {self.target: self._entry}
        if self.chosen:
            wrappers.update({t: self._field(*spec) for t, spec in FIELDS.items()})
        with harness.patched(wrappers):
            yield self

    def judged(self) -> list[tuple[int, object, tuple | None]]:
        """(extraction, features, (detector, field) of its own cloud or
        None) of each captured extraction."""
        out = []
        for i, f in sorted(self.features.items()):
            own = [(name, field) for name, xyz, field in self.fields.get(i, [])
                   if xyz is f.cloud.xyz]
            out.append((i, f, own[0] if own else None))
        return out


def outputs(state, kept: dict | None) -> dict:
    """The hand-over to the judge: every unit's final poses, the sampled
    unit's merged cloud and the feature-stage outputs of its captured
    clouds, the scenes' raw views and truths, and the maps attempted and
    failed (a map that ended its unit with a zero pose)."""
    p = state.params
    attempted = sum(len(unit["maps"]) for unit in state.units)
    failed = sum(1 for unit in state.units for pose in unit["poses"] if not np.asarray(pose).any())
    out = {
        "scenes": [{"views": views, "truths": truths} for views, truths, _ in state.scenes],
        "units": state.units,
        "attempted": attempted,
        "failed": failed,
        "params": {
            "resolution": p.resolution,
            "descriptor_radius": p.descriptor_radius,
            "outliers_min_neighbours": p.outliers_min_neighbours,
            "normal_radius": p.normal_radius,
            "output_resolution": p.output_resolution,
            "sift_scales_per_octave": p.sift_scales_per_octave,
            "descriptor_type": p.descriptor_type.name,
            "max_neighbors": p.max_neighbors,
        },
        "merged": None,
        "features": [],
    }
    if kept is None:
        return out
    merged = kept["merged"]
    if merged is not None:
        out["merged"] = {"scene": kept["scene"], "maps": kept["maps"], "poses": kept["poses"],
                         "xyz": merged.xyz[merged.mask]}
    for i, f, field in kept["features"]:
        out["features"].append({
            "scene": kept["scene"], "map": kept["maps"][i], "xyz": f.cloud.xyz,
            "rgb": f.cloud.rgb, "mask": f.cloud.mask, "normals": f.normals.normals,
            "curvature": f.normals.curvature, "valid": f.normals.valid,
            "keypoints": f.keypoints.xyz, "descriptors": f.descriptors.data,
            "descriptor_valid": f.descriptors.valid & f.keypoints.mask,
            "detector": None if field is None else field[0],
            "field": None if field is None else field[1],
            "scan_overflow": int(f.scan_overflow),
            "keypoints_truncated": int(f.keypoints.truncated),
            "dropped_points": int(f.dropped_points),
        })
    return out
