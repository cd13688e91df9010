"""features_ms.merge (ms/merge), layer: feature stage. The span around each
cloud's extract_features (voxel downsample, outliers, normals, Harris,
FPFH), per merge. Moves: merge_s."""

from mmbench.readers import span_per

SPANS = ["mapmerge_torch.parallel.pair_shard:extract_features"]


def read(rec):
    return span_per(rec, SPANS, "merges")
