"""merge_s (s): the window's seconds over the merges completed in it; a
merge is estimate_maps_transforms over all the maps, then compose_maps,
ending in a synchronisation. Moves: itself."""


def read(rec):
    return rec.seconds / rec.counts["merges"] if rec.counts.get("merges") else None
