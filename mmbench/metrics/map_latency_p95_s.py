"""map_latency_p95_s (s): the 95th percentile, over all maps registered in
the window, of the time from a map's publish to the end of the tick that
first gave it a non-zero pose (a map that failed its first tick carries
the wait)."""

from mmbench.harness import quantile


def read(rec):
    lat = rec.samples.get("map_latency_s")
    return quantile(lat, 0.95) if lat else None
