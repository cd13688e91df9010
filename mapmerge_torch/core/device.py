"""The device an entry point runs on when its caller names none: the card."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device. Raises where there is no card: a run on the
    CPU is asked for with `device="cpu"`, never fallen back to."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mapmerge_torch runs on an NVIDIA GPU and none is available; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """`device` as given, or the default device where it is None."""
    return default_device() if device is None else torch.device(device)
