"""Darboux-frame pair features (port of mapmerge_tpu/ops/descriptors/darboux.py).

pcl::computePairFeatures for broadcastable oriented point pairs, with PCL's
role swap: the point whose normal is better aligned with the connecting line
is the frame source. Written component by component, in the order the SPFH
kernel (csrc/spfh.cu) evaluates it, so the two round alike.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-12


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def pair_features(
    p1: torch.Tensor, n1: torch.Tensor, p2: torch.Tensor, n2: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """(theta, alpha, phi, dist, ok) for broadcastable (..., 3) point pairs.

    theta in [-pi, pi], alpha and phi in [-1, 1], dist >= 0. `ok` is False
    for coincident points or degenerate frames."""
    n1c, n2c = n1.unbind(-1), n2.unbind(-1)
    d = tuple(b - a for a, b in zip(p1.unbind(-1), p2.unbind(-1)))
    dist2 = _dot(d, d)
    dist = torch.sqrt(dist2.clamp_min(_EPS))
    ok = dist2 > _EPS
    dhat = tuple(c / dist for c in d)
    neg_dhat = tuple(-c for c in dhat)

    cos1 = _dot(n1c, dhat)
    cos2 = _dot(n2c, neg_dhat)
    swap = cos1.abs() < cos2.abs()

    ns = tuple(torch.where(swap, b, a) for a, b in zip(n1c, n2c))
    nt = tuple(torch.where(swap, a, b) for a, b in zip(n1c, n2c))
    dst = tuple(torch.where(swap, b, a) for a, b in zip(dhat, neg_dhat))
    phi = torch.where(swap, cos2, cos1)

    v = _cross(dst, ns)
    vnorm2 = _dot(v, v)
    frame_ok = vnorm2 > _EPS
    vn = torch.sqrt(vnorm2.clamp_min(_EPS))
    v = tuple(c / vn for c in v)
    w = _cross(ns, v)

    alpha = _dot(v, nt)
    theta = torch.atan2(_dot(w, nt), _dot(ns, nt))
    return theta, alpha, phi, dist, ok & frame_ok


def bin_index(
    value: torch.Tensor, lo: float, hi: float, bins: int
) -> torch.Tensor:
    """Uniform bin index in [0, bins-1] (PCL floor-and-clip binning).

    `lo` and the span are float32 tensors, so the division is a true division
    on every device (a Python-scalar divisor is a reciprocal multiply on
    CUDA), as in the kernel."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=value.device)
    span = torch.tensor(hi - lo, dtype=torch.float32, device=value.device)
    idx = torch.floor((value - lo_t) / span * bins).to(torch.int32)
    return idx.clamp(0, bins - 1)
