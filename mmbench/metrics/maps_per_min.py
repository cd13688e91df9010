"""maps_per_min (maps/min): maps whose estimation tick completed in the
window, per minute of the window."""


def read(rec):
    return 60.0 * rec.counts["maps"] / rec.seconds if rec.counts.get("maps") else None
