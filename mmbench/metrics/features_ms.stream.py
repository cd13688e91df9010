"""features_ms.stream (ms/map), layer: feature stage. The span around the
node's features_for (downsample, outliers, normals, SIFT, FPFH), per
map. Moves: maps_per_min."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.runtime.node:features_for"]


def read(rec):
    return span_per(rec, SPANS, "maps")
