"""The metric arithmetic on synthetic spans, ticks and traces (CPU)."""

from __future__ import annotations

import numpy as np
import pytest

from mmbench import harness, roofline, trace
from mmbench.drivers import node_stream


def test_interval_union_counts_overlap_once():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 10.0)]
    assert harness.interval_union(spans) == pytest.approx(4.0)
    assert harness.interval_union([]) == 0.0


def test_idle_gaps_are_the_uncovered_stretches():
    assert harness.idle_gaps([(1.0, 2.0), (1.5, 4.0), (6.0, 7.0)], 0.0, 10.0) == [
        (0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99])
def test_quantile_is_numpys_linear_quantile(q):
    values = list(np.random.default_rng(3).exponential(size=301))
    assert harness.quantile(values, q) == pytest.approx(float(np.quantile(values, q)))


def test_rates_per_window():
    reg = harness.Registry(harness.MMBENCH.parent)
    rec = harness.Record()
    rec.add({"counts": {"maps": 300, "merges": 80}})
    rec.seconds = 40.0
    assert reg.metric("maps_per_min").read(rec) == pytest.approx(450.0)
    assert reg.metric("merge_s").read(rec) == pytest.approx(0.5)
    assert reg.metric("merge_s").read(harness.Record()) is None


def test_profile_summary_on_synthetic_events():
    device = [(0.0, 10.0, "void grid_count_kernel<4>(float*)"), (5.0, 20.0, "aten_add"),
              (30.0, 40.0, "Memcpy DtoH (Device -> Pageable)")]
    host = [("aten::nonzero", 19.0, 31.0), ("aten::item", 36.0, 50.0)]
    ranges = [("extract_features", 0.0, 60.0)]
    p = trace.summarize(device, host, ranges, 60e-6, {"a": 10.0})
    assert p["busy_s"] == pytest.approx(30e-6)
    assert p["launches"] == 2
    assert p["gaps_s"] == {"extract_features > aten::nonzero": pytest.approx(10e-6),
                           "extract_features > aten::item": pytest.approx(20e-6)}
    assert p["device_s"]["aten_add"] == pytest.approx(15e-6)


def test_hand_kernel_names_and_share():
    assert roofline.is_hand_kernel("void grid_radius_kernel<ReduceOp<6> >(float const*)")
    assert roofline.is_hand_kernel("(anonymous namespace)::grid_pack_kernel(float const*)")
    assert not roofline.is_hand_kernel("void at::native::vectorized_elementwise_kernel<4>()")
    assert not roofline.is_hand_kernel("my_grid_pack_kernel")
    assert roofline.share_percent(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_percent(0.0, 1.0) is None and roofline.share_percent(1.0, 0.0) is None


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_stream_latency_p95_over_every_map_with_retries(monkeypatch):
    """A stub node that takes 1 s a tick and registers map i at the tick
    `register_at[i]` (maps 3 and 7 fail their first tick and register a
    tick later; map 9 never): each latency runs from the map's publish to
    the end of that tick, and the p95 is over every registered map."""
    import mapmerge_torch.runtime.node as node_module

    clock = _Clock()
    monkeypatch.setattr(node_stream.time, "perf_counter", clock)
    register_at = {i: i // 2 for i in range(10)}
    register_at.update({3: 2, 7: 4, 9: 99})

    class StubNode:
        def __init__(self, transport, params, **kwargs):
            self.transport, self.tick = transport, 0

        def discovery(self):
            pass

        def transforms_estimation(self):
            for _ in range(2):
                node_module.features_for(None, None)
            clock.t += 1.0
            self.tick += 1

        def get_transforms(self):
            return {node_stream.robot(i): np.eye(4) * (register_at[i] < self.tick)
                    for i in range(min(2 * self.tick, 10))}

        def map_compositing(self):
            pass

        def get_merged_map(self):
            return None

    monkeypatch.setattr(node_module, "MapMergeNode", StubNode)
    monkeypatch.setattr(node_module, "features_for", lambda cloud, params: object())
    state = node_stream.State.__new__(node_stream.State)
    state.scenes = [([(np.zeros((1, 3), np.float32), None)] * 10, [np.eye(4)] * 10, 0)]
    state.order = node_stream.common.SceneOrder(0, 1)
    state.params, state.node_options, state.per_tick = None, {}, 2
    state.units, state.device, state.seed = [], "cpu", 0
    state.sample = node_stream.common.Reservoir(0, 0)

    rec = harness.Record()
    harness.run_steps(lambda: node_stream.step(state), rec, None, 1)
    want = [1, 1, 1, 2, 1, 1, 1, 2, 1]  # map 9 never registers
    assert sorted(rec.samples["map_latency_s"]) == sorted(float(w) for w in want)
    reg = harness.Registry(harness.MMBENCH.parent)
    assert reg.metric("map_latency_p95_s").read(rec) == pytest.approx(
        float(np.quantile(want, 0.95)))
    assert rec.counts["maps"] == 10 and rec.counts["ticks"] == 5 and rec.counts["streams"] == 1
    assert [p.any() for p in state.units[0]["poses"]] == [True] * 9 + [False]
