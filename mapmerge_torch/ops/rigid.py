"""Weighted rigid (SE(3)) alignment, batched and closed-form (port of
mapmerge_tpu/ops/rigid.py).

The same analytic solve as the reference, not an SVD: the 3x3
cross-covariance H is decomposed through the analytic eigensolver on H^T H,
and the third singular-vector pair is rebuilt by cross products, which makes
the solve exact for rank-2 cross-covariances (3-point samples) and gives
det(R) = +1. The `ok` flags (>= 3 effective pairs, non-collinear support,
a certified proper rotation) therefore agree with the reference's.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.ops.eigh3 import best_column, eigvalsh3

_EPS = 1.0e-12


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True).clamp_min(_EPS))


def _eigvecs_from_vals(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (as columns, ascending) of symmetric (..., 3, 3) from
    the spectral projectors prod_{j != i} (A - lam_j I)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)

    def projector_vec(l_a, l_b):
        m = (a - l_a[..., None, None] * eye) @ (a - l_b[..., None, None] * eye)
        return _normalize(best_column(m))

    v0 = projector_vec(lam[..., 1], lam[..., 2])  # smallest
    v2 = projector_vec(lam[..., 0], lam[..., 1])  # largest
    v1 = _normalize(torch.linalg.cross(v2, v0, dim=-1))
    return torch.stack([v0, v1, v2], dim=-1)


def _det3(r: torch.Tensor) -> torch.Tensor:
    return (
        r[..., 0, 0] * (r[..., 1, 1] * r[..., 2, 2] - r[..., 1, 2] * r[..., 2, 1])
        - r[..., 0, 1] * (r[..., 1, 0] * r[..., 2, 2] - r[..., 1, 2] * r[..., 2, 0])
        + r[..., 0, 2] * (r[..., 1, 0] * r[..., 2, 1] - r[..., 1, 1] * r[..., 2, 0])
    )


def kabsch(
    src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares rigid T with T @ src ~= dst.

    src, dst (..., N, 3); weights (..., N) >= 0. Returns (transform
    (..., 4, 4), ok (...)); the transform is the identity where not ok."""
    w = weights.to(torch.float32)
    wsum = w.sum(dim=-1, keepdim=True)
    denom = wsum.clamp_min(_EPS)
    mu_s = (src * w[..., None]).sum(dim=-2) / denom
    mu_d = (dst * w[..., None]).sum(dim=-2) / denom
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    h = (sc * w[..., None]).transpose(-1, -2) @ dc  # sum w sc dc^T

    hth = h.transpose(-1, -2) @ h
    lam = eigvalsh3(hth)
    v = _eigvecs_from_vals(hth, lam)

    u2n = _normalize((h @ v[..., 2:3])[..., 0])
    u1 = (h @ v[..., 1:2])[..., 0]
    u1 = u1 - (u1 * u2n).sum(dim=-1, keepdim=True) * u2n
    u1n = _normalize(u1)
    u0n = torch.linalg.cross(u2n, u1n, dim=-1)
    u = torch.stack([u2n, u1n, u0n], dim=-1)
    vv = torch.stack(
        [v[..., 2], v[..., 1], torch.linalg.cross(v[..., 2], v[..., 1], dim=-1)],
        dim=-1,
    )
    r = vv @ u.transpose(-1, -2)  # R = V U^T maximises tr(R H)

    t = mu_d - (r @ mu_s[..., None])[..., 0]
    transform = tf.from_rotation_translation(r, t)

    eff = (w > 0).sum(dim=-1) >= 3
    nondegenerate = lam[..., 1] / lam[..., 2].clamp_min(_EPS) > 1.0e-6
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    ortho_err = (r.transpose(-1, -2) @ r - eye3).abs().amax(dim=(-2, -1))
    proper = (ortho_err < 1.0e-2) & ((_det3(r) - 1.0).abs() < 1.0e-2)
    ok = eff & nondegenerate & (wsum[..., 0] > 0) & proper
    eye4 = torch.eye(4, dtype=torch.float32, device=r.device)
    return torch.where(ok[..., None, None], transform, eye4), ok
