"""graph_ms.merge (ms/merge), layer: entry and host graph. The spans around
the host graph solve (_solve_graph) and compose_maps, per merge. Moves:
merge_s."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.pipeline.merging:_solve_graph", "mapmerge_torch.pipeline.merging:compose_maps"]


def read(rec):
    return span_per(rec, SPANS, "merges")
