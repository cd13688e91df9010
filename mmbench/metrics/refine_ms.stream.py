"""refine_ms.stream (ms/tick), layer: node. The span around
WorldModel.refine (the numpy pose graph over all the world's edges,
every tick), per tick. Moves: map_latency_p95_s."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.pipeline.incremental:WorldModel.refine"]


def read(rec):
    return span_per(rec, SPANS, "ticks")
