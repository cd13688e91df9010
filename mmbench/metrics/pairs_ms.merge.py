"""pairs_ms.merge (ms/merge), layer: pair registration. The span around
each pair's register_pair (or a chunk's register_chunk): matching,
RANSAC, ICP, the score, per merge. Moves: merge_s."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.pipeline.merging:register_pair", "mapmerge_torch.pipeline.merging:register_chunk"]


def read(rec):
    return span_per(rec, SPANS, "merges")
