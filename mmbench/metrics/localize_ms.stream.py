"""localize_ms.stream (ms/map), layer: node. The span around
WorldModel.localize (the vote and the pair registrations against the
world), per map. Moves: maps_per_min."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.pipeline.incremental:WorldModel.localize"]


def read(rec):
    return span_per(rec, SPANS, "maps")
