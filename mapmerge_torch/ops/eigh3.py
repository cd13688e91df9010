"""Closed-form batched 3x3 symmetric eigendecomposition (port of
mapmerge_tpu/ops/eigh3.py).

The analytic trigonometric method: element-wise math over any batch of
3x3 matrices. The smallest eigenvector comes from the spectral projector
(A - l1 I)(A - l2 I), whose columns span the l3 eigenspace.
"""

from __future__ import annotations

import math

import torch

_EPS = 1.0e-12


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending: (..., 3)."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp_min(0.0))
    safe_p = p.clamp_min(_EPS)

    # det((A - qI)/p) / 2
    c00, c11, c22 = b00 / safe_p, b11 / safe_p, b22 / safe_p
    c01, c02, c12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    det_b = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = (det_b / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def best_column(m: torch.Tensor) -> torch.Tensor:
    """The column of (..., 3, 3) with the largest norm (first on ties)."""
    cols = m.transpose(-1, -2)  # (..., 3 cols, 3)
    best = (cols * cols).sum(dim=-1).argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    return torch.gather(cols, -2, idx)[..., 0, :]


def smallest_eigenpair3(
    a: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), smallest eigenvector (..., 3), ok).

    `ok` is False where the matrix is (near-)isotropic and the direction is
    arbitrary; the vector is +z there."""
    lam = eigvalsh3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m1 = a - lam[..., 2, None, None] * eye
    m2 = a - lam[..., 1, None, None] * eye
    vec = best_column(m1 @ m2)
    n2 = (vec * vec).sum(dim=-1, keepdim=True)
    ok = n2[..., 0] > _EPS
    vec = vec / torch.sqrt(n2.clamp_min(_EPS))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    return lam, torch.where(ok[..., None], vec, up), ok
