"""launches.stream (launches/map), layer: device. Kernel launches on the
device in the profiler phase (its events but copies and fills), per map.
Moves: maps_per_min."""

from mmbench.readers import profile_per


def read(rec):
    return profile_per(rec, "launches", "maps")
