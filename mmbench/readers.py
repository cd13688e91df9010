"""What the metric readers share: a span's time per unit, a profile's
numbers per unit."""

from __future__ import annotations


def span_per(rec, targets: list[str], per: str) -> float | None:
    """The ms that the spans of `targets` took in the span phase, per unit
    of `per` ("merges", "maps", "ticks") done there; None where no span or
    no unit was seen."""
    seen = [rec.spans[t]["ms"] for t in targets if t in rec.spans]
    units = rec.counts.get(per, 0)
    if not seen or not units:
        return None
    return sum(seen) / units


def profile_per(rec, key: str, per: str) -> float | None:
    """A number of the profiler phase per unit of `per` done in it."""
    if rec.profile is None or not rec.profile["counts"].get(per):
        return None
    return rec.profile[key] / rec.profile["counts"][per]
