"""Reciprocal k-NN descriptor matching (port of mapmerge_tpu/ops/matching.py).

The full (S, T) squared-distance matrix, the k nearest both ways, and the
reference's first-match-wins rule: source i walks its k nearest targets in
ascending distance and takes the FIRST target j whose own k nearest sources
include i (one match per source point). Descriptors may carry a leading
pair axis, (B, S, D) against (B, T, D): each pair is matched on its own.
"""

from __future__ import annotations

import dataclasses

import torch

BIG = 1.0e12


@dataclasses.dataclass(frozen=True)
class Correspondences:
    """One slot per source keypoint: target index, squared descriptor
    distance, and whether a reciprocal match exists."""

    target: torch.Tensor  # ([B,] S) int32
    distance: torch.Tensor  # ([B,] S) float32
    valid: torch.Tensor  # ([B,] S) bool


def take(x: torch.Tensor, idx: torch.Tensor, batched: bool) -> torch.Tensor:
    """x[idx] along x's first axis; with `batched`, x (B, N, ...) and idx
    (B, ...), each pair's rows at its own indices: (B, ...idx, ...x)."""
    if not batched:
        return x[idx]
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.view(-1, *([1] * (idx.dim() - 1))), idx]


def descriptor_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """([B,] S, D) x ([B,] T, D) -> ([B,] S, T) squared L2 distances."""
    aa = (a * a).sum(dim=-1, keepdim=True)
    bb = (b * b).sum(dim=-1, keepdim=True)
    return (aa + bb.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2))).clamp_min(0.0)


def find_correspondences(
    source_desc: torch.Tensor,
    target_desc: torch.Tensor,
    k: int,
    source_valid: torch.Tensor | None = None,
    target_valid: torch.Tensor | None = None,
) -> Correspondences:
    """Reciprocal k-NN cross-matching (reference matching.cpp:31-93), of
    one pair or of each pair of a batch."""
    s, t = source_desc.shape[-2], target_desc.shape[-2]
    k_eff = min(k, t)

    d2 = descriptor_sq_dists(source_desc, target_desc)
    if target_valid is not None:
        d2 = torch.where(target_valid[..., None, :], d2, BIG)
    if source_valid is not None:
        d2 = torch.where(source_valid[..., :, None], d2, BIG)

    fwd_d2, fwd_idx = torch.topk(d2, k_eff, dim=-1, largest=False)  # (S, k)
    _, back_idx = torch.topk(
        d2.transpose(-1, -2), min(k, s), dim=-1, largest=False
    )  # (T, kb)

    # back_idx[fwd_idx]: the k nearest sources of each forward hit
    lead, kb = fwd_idx.shape[:-2], back_idx.shape[-1]
    back = torch.gather(
        back_idx, -2,
        fwd_idx.reshape(*lead, s * k_eff, 1).expand(*lead, s * k_eff, kb),
    ).reshape(*lead, s, k_eff, kb)
    src_ids = torch.arange(s, device=d2.device)[:, None, None]
    reciprocal = (back == src_ids).any(dim=-1)  # (S, k)
    reciprocal = reciprocal & (fwd_d2 < BIG / 2)

    # first-match-wins: the earliest slot with a reciprocal hit (argmax of a
    # bool is not supported on every device; an int32 copy is)
    first = reciprocal.to(torch.int32).argmax(dim=-1, keepdim=True)
    target = torch.gather(fwd_idx, -1, first)[..., 0]
    dist = torch.gather(fwd_d2, -1, first)[..., 0]

    valid = reciprocal.any(dim=-1)
    if source_valid is not None:
        valid = valid & source_valid
    return Correspondences(
        target=target.to(torch.int32),
        distance=torch.where(valid, dist, BIG),
        valid=valid,
    )
