"""Descriptor result container (port of mapmerge_tpu/ops/descriptors/base.py).

One fixed-shape (K, D) tensor with a validity mask: an invalid descriptor
stands for a keypoint the reference drops.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Descriptors:
    data: torch.Tensor  # (K, D) float32
    valid: torch.Tensor  # (K,) bool
