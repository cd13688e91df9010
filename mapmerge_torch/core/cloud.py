"""Padded fixed-capacity point-cloud model (port of mapmerge_tpu/core/cloud.py).

A cloud is a `(capacity, ...)` tensor bundle with a validity mask. Masked-out
points park their coordinates at `FAR` so every distance-based op excludes
them even before the mask is applied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: parked coordinate for invalid points; squared distances stay finite in f32
FAR = 1.0e8


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A padded XYZRGB point cloud.

    Attributes:
      xyz:  (N, 3) float32 positions; invalid rows parked at FAR.
      rgb:  (N, 3) float32 colors in [0, 1]; invalid rows zero.
      mask: (N,)   bool validity.
    """

    xyz: torch.Tensor
    rgb: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def park_invalid(self) -> "PointCloud":
        """Copy with invalid xyz parked at FAR and rgb zeroed."""
        m = self.mask[..., None]
        return PointCloud(
            xyz=torch.where(m, self.xyz, FAR),
            rgb=torch.where(m, self.rgb, 0.0),
            mask=self.mask,
        )

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device="cpu",
    ) -> "PointCloud":
        """Padded cloud from host arrays of shape (n, 3)."""
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        if rgb is None:
            rgb = np.zeros((n, 3), dtype=np.float32)
        else:
            rgb = np.asarray(rgb, dtype=np.float32).reshape(-1, 3)
            if rgb.shape[0] != n:
                raise ValueError("rgb and xyz must have the same point count")
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pad = cap - n
        xyz_p = np.concatenate([xyz, np.full((pad, 3), FAR, np.float32)])
        rgb_p = np.concatenate([rgb, np.zeros((pad, 3), np.float32)])
        mask = np.concatenate([np.ones((n,), bool), np.zeros((pad,), bool)])
        return PointCloud(
            xyz=torch.from_numpy(xyz_p).to(device),
            rgb=torch.from_numpy(rgb_p).to(device),
            mask=torch.from_numpy(mask).to(device),
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Compacted host (xyz, rgb) arrays of the valid points only."""
        mask = self.mask.cpu().numpy()
        return self.xyz.cpu().numpy()[mask], self.rgb.cpu().numpy()[mask]


def stack_clouds(
    clouds: list[PointCloud], capacity: Optional[int] = None
) -> PointCloud:
    """Stack clouds into one batched (B, N, ...) cloud at a common capacity."""
    cap = capacity or max(c.capacity for c in clouds)
    padded = [pad_cloud(c, cap) for c in clouds]
    return PointCloud(
        xyz=torch.stack([c.xyz for c in padded]),
        rgb=torch.stack([c.rgb for c in padded]),
        mask=torch.stack([c.mask for c in padded]),
    )


def pad_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Pad (or validate) a cloud to `capacity` points."""
    n = cloud.capacity
    if capacity == n:
        return cloud
    if capacity < n:
        raise ValueError(f"capacity {capacity} < cloud capacity {n}")
    pad = capacity - n
    dev = cloud.device
    return PointCloud(
        xyz=torch.cat(
            [cloud.xyz, torch.full((pad, 3), FAR, dtype=torch.float32, device=dev)]
        ),
        rgb=torch.cat(
            [cloud.rgb, torch.zeros((pad, 3), dtype=torch.float32, device=dev)]
        ),
        mask=torch.cat(
            [cloud.mask, torch.zeros((pad,), dtype=torch.bool, device=dev)]
        ),
    )
