"""Offline merges in a closed loop: what `map_merge_tool` does over N maps.

A merge is `estimate_maps_transforms` over all the views of one scene,
then `compose_maps` at the configuration's output resolution, ending in a
synchronisation; the next starts when it has ended. A step is a round: one
merge of each of the mix's scenes, in an order drawn from the seed, so a
window holds whole rounds. RANSAC draws from the scene's seed, which the
run's seed draws (`common.scenes`).

Traffic parameters (`traffic/<mix>.json`): `maps`, `view_resized_target`
and `keep` (a town: `scene.town_views`), `scene_seeds` (the towns),
`yaw_deg` and `shift_m` (each view's placement), `profile_steps`.
"""

from __future__ import annotations

import numpy as np

from mmbench.drivers import common


#: the feature stage's entry in a merge: its results are the features judged
FEATURES = "mapmerge_torch.parallel.pair_shard:extract_features"


class State:
    def __init__(self, config: dict, traffic: dict, seed: int, device, judged: int):
        from mapmerge_torch.core.cloud import PointCloud

        self.device, self.seed = device, seed
        self.scenes = common.scenes(traffic, seed)
        cap = common.next_pow2(max(len(v[0]) for views, _, _ in self.scenes for v in views))
        self.params = common.merge_params(config)
        self.clouds = [[PointCloud.from_numpy(x, r, capacity=cap, device=device) for x, r in views]
                       for views, _, _ in self.scenes]
        self.order = common.SceneOrder(seed, len(self.scenes))
        self.units: list[dict] = []
        self.sample = common.Reservoir(seed, judged)


def setup(config: dict, traffic: dict, seed: int, device, judged: int,
          warm: bool = True) -> State:
    """The views on the device and (`warm`) one merge, which builds and
    warms every kernel and shape the window uses (the scenes share one
    capacity). The judge reads `judged` clouds of a sampled merge."""
    state = State(config, traffic, seed, device, judged)
    if warm:
        merge(state, 0, common.Capture(FEATURES, set()))
    return state


def merge(state: State, k: int, capture: common.Capture):
    """One merge of scene k: (poses, merged cloud)."""
    from mapmerge_torch.pipeline import merging

    clouds = state.clouds[k]
    with capture.active():
        poses = merging.estimate_maps_transforms(clouds, state.params, seed=state.scenes[k][2])
        # no pair registered: every map failed, as a zero pose each
        poses = list(poses) or [np.zeros((4, 4), np.float32)] * len(clouds)
        merged = merging.compose_maps(clouds, poses, state.params.output_resolution)
    common.synchronize(state.device)
    return poses, merged


def step(state: State) -> dict:
    """One round: a merge of each scene."""
    for _ in state.scenes:
        k = state.order.next()
        capture = common.Capture(FEATURES, state.sample.draw(len(state.clouds[k])))
        poses, merged = merge(state, k, capture)
        maps, poses = list(range(len(poses))), [np.asarray(p) for p in poses]
        state.units.append({"scene": k, "maps": maps, "poses": poses})
        if capture.chosen:
            state.sample.kept = {"scene": k, "maps": maps, "poses": poses, "merged": merged,
                                 "features": capture.judged()}
    n = len(state.scenes)
    return {"counts": {"merges": n, "maps": n * len(state.clouds[0])}}


def outputs(state: State) -> dict:
    """What the window produced, for the judge; the device state freed."""
    out = common.outputs(state, state.sample.kept)
    state.clouds = None
    return out
