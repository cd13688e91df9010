"""Online streams in a closed loop: robots join a mission and publish their
maps to one `MapMergeNode` in incremental register-to-world mode.

A step is one stream: a fresh node and transport; each tick publishes the
next `maps_per_tick` views, then the node runs `discovery` and
`transforms_estimation`, ending in a synchronisation; after the tick that
publishes the last view, `map_compositing` runs once. Streams repeat until
the window closes; the stream in flight at the close ends the window, so a
window holds whole streams. A map's latency runs from its publish to the
end of the tick that first gave it a non-zero pose.

Traffic parameters (`traffic/<mix>.json`): `maps`, `view_resized_target`
and `keep` (a town: `scene.town_views`), `scene_seeds` (the towns; the
streams take them in rounds, each in an order drawn from the seed),
`yaw_deg` and `shift_m` (each view's placement), `maps_per_tick`, `profile_steps`; the
node draws from the scene's seed, which the run's seed draws
(`common.scenes`); the configuration's `node` gives the node's options.
"""

from __future__ import annotations

import time

import numpy as np

from mmbench.drivers import common


#: the feature stage's entry in the node: its results are the features judged
FEATURES = "mapmerge_torch.runtime.node:features_for"


def robot(i: int) -> str:
    return f"robot_{i:02d}"


class State:
    def __init__(self, config: dict, traffic: dict, seed: int, device, judged: int):
        self.device, self.seed = device, seed
        self.scenes = common.scenes(traffic, seed)
        self.order = common.SceneOrder(seed, len(self.scenes))
        self.params = common.merge_params(config)
        self.node_options = config["node"]
        self.per_tick = traffic["maps_per_tick"]
        self.units: list[dict] = []
        self.sample = common.Reservoir(seed, judged)


def setup(config: dict, traffic: dict, seed: int, device, judged: int,
          warm: bool = True) -> State:
    """The views on the host and (`warm`) one whole stream, which builds
    and warms every kernel and shape the window uses. The judge reads
    `judged` maps of a sampled stream."""
    state = State(config, traffic, seed, device, judged)
    if warm:
        step(state)
        state.units.clear()
        state.sample = common.Reservoir(seed, judged)
        state.order = common.SceneOrder(seed, len(state.scenes))
    return state


def step(state: State) -> dict:
    """One whole stream of the next scene."""
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport

    k = state.order.next()
    views, _, scene_seed = state.scenes[k]
    n = len(views)
    capture = common.Capture(FEATURES, state.sample.draw(n))
    transport = InProcTransport()
    node = MapMergeNode(transport, state.params, seed=scene_seed, device=state.device,
                        **state.node_options)
    published: dict[int, float] = {}
    latency = []
    ticks = 0
    for first in range(0, n, state.per_tick):
        for i in range(first, min(first + state.per_tick, n)):
            transport.publish(robot(i), *views[i])
            published[i] = time.perf_counter()
        with capture.active():
            node.discovery()
            node.transforms_estimation()
        common.synchronize(state.device)
        end = time.perf_counter()
        ticks += 1
        poses = node.get_transforms()
        for i in list(published):
            if poses.get(robot(i), np.zeros(1)).any():
                latency.append(end - published.pop(i))
    node.map_compositing()
    common.synchronize(state.device)
    if capture.calls != n:
        raise RuntimeError(f"node_stream: {capture.calls} feature extractions for {n} maps")
    poses = node.get_transforms()
    final = [np.asarray(poses.get(robot(i), np.zeros((4, 4), np.float32))) for i in range(n)]
    maps = list(range(n))
    state.units.append({"scene": k, "maps": maps, "poses": final})
    if capture.chosen:
        state.sample.kept = {"scene": k, "maps": maps, "poses": final,
                             "merged": node.get_merged_map(), "features": capture.judged()}
    return {"counts": {"maps": n, "ticks": ticks, "streams": 1},
            "samples": {"map_latency_s": latency}}


def outputs(state: State) -> dict:
    """What the window produced, for the judge."""
    return common.outputs(state, state.sample.kept)
