"""String-typed config enums (the port's copy of mapmerge_tpu/core/enums.py).

The reference's ENUM_CLASS reflection (map_merge_3d/include/map_merge_3d/
enum.h:30-67) as StrEnums; `from_string` is its strict parse-or-throw.
Names and values are the reference's, so a member of either package
compares equal to the other's (tests/test_torch_graph.py holds them equal).
"""

from __future__ import annotations

import enum


class Keypoint(enum.StrEnum):
    """Keypoint detector (features.h `enum class Keypoint`)."""

    SIFT = "SIFT"
    HARRIS = "HARRIS"


class Descriptor(enum.StrEnum):
    """Local descriptor (features.h `enum class Descriptor`); RIFT is
    disabled in the reference (dispatch_descriptors.h:41-42) and omitted."""

    PFH = "PFH"
    PFHRGB = "PFHRGB"
    FPFH = "FPFH"
    RSD = "RSD"
    SHOT = "SHOT"
    SC3D = "SC3D"


#: descriptor -> feature width (dispatch_descriptors.h:38-48)
DESCRIPTOR_DIMS: dict[Descriptor, int] = {
    Descriptor.PFH: 125,
    Descriptor.PFHRGB: 250,
    Descriptor.FPFH: 33,
    Descriptor.RSD: 2,
    Descriptor.SHOT: 1344,
    Descriptor.SC3D: 1980,
}


class EstimationMethod(enum.StrEnum):
    """Initial transform estimation method (matching.h)."""

    MATCHING = "MATCHING"
    SAC_IA = "SAC_IA"


def from_string(enum_cls: type[enum.StrEnum], value: str):
    """Parse-or-throw (enum.h:43-61)."""
    try:
        return enum_cls(value.upper())
    except ValueError:
        valid = ", ".join(m.value for m in enum_cls)
        raise ValueError(
            f"{value!r} is not a valid {enum_cls.__name__} (expected one of: {valid})"
        ) from None
