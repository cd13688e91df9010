"""kernels_roofline.stream (%), layer: hand kernels. The least time of the hand
kernels' launches in the profiler phase (their bytes over the chip's peak
bandwidth: mmbench/roofline.py, counted in the count phase that repeats
the profiled steps) over the device time of the kernels named below, in
percent; bounded by bytes. None where the two phases called the hooked
wrappers differently. Moves: maps_per_min."""

from mmbench import roofline

#: the wrappers whose calls are counted, and the csrc kernels whose device
#: time is summed
PROFILE_HOOKS = roofline.BYTES
KERNELS = roofline.KERNELS


def read(rec):
    if rec.profile is None or rec.profile.get("bytes_calls") != rec.profile["calls"]:
        return None
    device_s = sum(s for name, s in rec.profile["device_s"].items()
                   if roofline.is_hand_kernel(name, KERNELS))
    return roofline.share_percent(rec.profile["bytes"], device_s)
