"""SE(3) rigid-transform helpers (port of mapmerge_tpu/core/transforms.py).

4x4 float32 matrices; the zero matrix is the in-band "could not register"
signal of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_torch.core.device import resolve


def identity(device=None) -> torch.Tensor:
    """On `device`, the current CUDA device when None."""
    return torch.eye(4, dtype=torch.float32, device=resolve(device))


def zero(device=None) -> torch.Tensor:
    """On `device`, the current CUDA device when None."""
    return torch.zeros((4, 4), dtype=torch.float32, device=resolve(device))


def is_zero(t: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """The reference's failure test (Eigen isZero, map_merging.cpp:293):
    (..., 4, 4) -> (...,) bool, whether every entry is within `tol` of 0."""
    return t.abs().amax(dim=(-2, -1)) <= tol


def from_rotation_translation(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=r.device
    ).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2).to(torch.float32)


def rotation(t: torch.Tensor) -> torch.Tensor:
    return t[..., :3, :3]


def translation(t: torch.Tensor) -> torch.Tensor:
    return t[..., :3, 3]


def rigid_inverse(t: torch.Tensor) -> torch.Tensor:
    """The exact inverse of rigid (..., 4, 4) transforms:
    [R|p]^-1 = [R^T | -R^T p]."""
    rt = rotation(t).transpose(-1, -2)
    return from_rotation_translation(rt, -(rt @ translation(t)[..., None])[..., 0])


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: apply b first, then a."""
    return a @ b


def apply(t: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3); broadcasts like the einsum
    "...ij,...nj->...ni" of the reference."""
    return xyz @ rotation(t).transpose(-1, -2) + translation(t)[..., None, :]


def rotation_geodesic_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between the rotation parts of two transforms."""
    m = rotation(a) @ rotation(b).transpose(-1, -2)
    cos = (m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def translation_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(translation(a) - translation(b), dim=-1)


def pose_error(estimate, truth) -> tuple[float, float]:
    """(degrees, metres) between two host 4x4 poses."""
    a = torch.from_numpy(np.array(estimate, dtype=np.float32))
    b = torch.from_numpy(np.array(truth, dtype=np.float32))
    return (
        float(rotation_geodesic_deg(a, b)),
        float(translation_error(a, b)),
    )

