"""idle_share.merge (%), layer: device. 100 x (1 - the union of the
device's event intervals over the profiled wall time) in the profiler
phase. Moves: merge_s."""


def read(rec):
    if rec.profile is None or rec.profile["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.profile["busy_s"] / rec.profile["wall_s"])
