"""launches.merge (launches/merge), layer: device. Kernel launches on the
device in the profiler phase (its events but copies and fills), per merge.
Moves: merge_s."""

from mmbench.readers import profile_per


def read(rec):
    return profile_per(rec, "launches", "merges")
