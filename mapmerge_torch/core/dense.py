"""The dense pairwise primitives under the neighbour ops (ops/neighbors.py)
and the plain versions of the kernels (kernels/): squared distances by the
direct expansion, and a query axis run in tiles so only a (tile, P) slab
exists at a time.
"""

from __future__ import annotations

from typing import Callable

import torch


def sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) x ([...,] P, 3) -> (..., Q, P) squared distances, by the
    direct expansion sum_c (q_c - p_c)^2 (p's leading axes broadcast
    against q's).

    The reference uses the identity |q|^2 + |p|^2 - 2 q.p. PyTorch's matmul
    rounds q.p differently from |q|^2, leaving up to ~1e-6 m^2 for a point
    and itself (measured on the CPU), where the reference's CPU path gives
    exactly 0; FPFH's zero-distance self-hit test (dist > 1e-9) then weights
    the self SPFH by ~1e3. The direct expansion is exact for coincident
    points and at least as accurate elsewhere."""
    d2 = torch.zeros(q.shape[:-1] + (p.shape[-2],), dtype=q.dtype, device=q.device)
    for c in range(3):
        dc = q[..., c : c + 1] - p[..., None, :, c]
        d2 += dc * dc
    return d2


def tiled_query(
    q: torch.Tensor, tile_fn: Callable, tile: int = 1024
):
    """Run `tile_fn` over (tile, 3) query slabs and concatenate the results
    (a tensor or a tuple of tensors with leading dim = slab rows)."""
    outs = [tile_fn(q[s : s + tile]) for s in range(0, q.shape[0], tile)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)
