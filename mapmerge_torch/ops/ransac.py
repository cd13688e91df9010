"""Batched-hypothesis RANSAC over correspondences (port of
mapmerge_tpu/ops/ransac.py).

All hypotheses are drawn at once (3 distinct valid correspondences each, by a
Gumbel top-k), solved with the closed-form 3-point Kabsch, scored against
every correspondence, and the best (first on ties) is refit on its inliers.
Failure is a zero 4x4 and an empty inlier set. The consensus purity and
spread of the competitive hypotheses are the ambiguity evidence. Inputs may
carry a leading pair axis: each pair draws from its own generator and the
(B, H, S) hypothesis planes are scored at once.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.ops.matching import Correspondences, take
from mapmerge_torch.ops.neighbors import _f32
from mapmerge_torch.ops.rigid import kabsch

_NEG = -1.0e30


@dataclasses.dataclass(frozen=True)
class RansacResult:
    transform: torch.Tensor  # (4, 4) float32; zeros when not ok
    inliers: torch.Tensor  # (S,) bool
    inlier_count: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool
    #: fraction of competitive hypotheses whose pose agrees with the winner
    #: (mapmerge_tpu/ops/ransac.py RansacResult); 1 when not ok
    consensus_purity: torch.Tensor
    #: worst deviation from the winner among competitive hypotheses; 0 when
    #: not ok
    spread_deg: torch.Tensor
    spread_m: torch.Tensor


def sample_hypotheses(
    generator: torch.Generator,
    valid: torch.Tensor,
    num_hypotheses: int,
    sample_size: int = 3,
) -> torch.Tensor:
    """(H, sample_size) indices of distinct valid correspondences: top-k of
    iid Gumbel noise restricted to valid slots, drawn from `generator` (which
    must live on `valid`'s device)."""
    u = torch.rand(
        (num_hypotheses, valid.shape[0]), generator=generator,
        device=valid.device,
    )
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))
    g = torch.where(valid[None, :], g, _NEG)
    return torch.topk(g, sample_size, dim=1).indices.to(torch.int32)


def draw_hypotheses(generator, valid: torch.Tensor, num_hypotheses: int):
    """`sample_hypotheses` of one pair, or of each pair of a batch (valid
    (B, S)) from its own generator of the sequence `generator`: the draws
    each pair gets when registered alone."""
    if valid.dim() == 1:
        return sample_hypotheses(generator, valid, num_hypotheses)
    return torch.stack([
        sample_hypotheses(g, v, num_hypotheses) for g, v in zip(generator, valid)
    ])


def ransac_transform(
    source_kp: torch.Tensor,
    target_kp: torch.Tensor,
    corr: Correspondences,
    inlier_threshold: float,
    num_hypotheses: int,
    generator=None,
    samples: torch.Tensor | None = None,
) -> RansacResult:
    """Estimate T (source -> target) from putative correspondences, for one
    pair (keypoints (K, 3), correspondences (S,)) or each pair of a batch
    (keypoints (B, K, 3), correspondences (B, S); every field of the result
    then has the leading pair axis).

    The hypotheses come from `generator` (a sequence of one generator a pair
    for a batch), or from `samples` ([B,] H, 3) when given (the tests feed
    it the reference's own draws)."""
    batched = corr.valid.dim() == 2
    s = corr.target.shape[-1]
    src = source_kp[..., :s, :]  # (S, 3) aligned slots
    dst = take(target_kp, corr.target.to(torch.int64), batched)  # matched targets
    valid = corr.valid
    thr2 = _f32(inlier_threshold * inlier_threshold)
    dev = src.device

    if samples is None:
        samples = draw_hypotheses(generator, valid, num_hypotheses)
    samples = samples.to(device=dev, dtype=torch.int64)  # (H, 3)
    sample_ok = take(valid, samples, batched).all(dim=-1)  # (H,)
    hyp_t, hyp_ok = kabsch(
        take(src, samples, batched), take(dst, samples, batched),
        torch.ones(samples.shape, dtype=torch.float32, device=dev),
    )
    hyp_ok = hyp_ok & sample_ok

    moved = tf.apply(hyp_t, src[..., None, :, :])  # (H, S, 3)
    resid2 = ((moved - dst[..., None, :, :]) ** 2).sum(dim=-1)
    inlier_mat = (resid2 <= thr2) & valid[..., None, :]
    counts = inlier_mat.sum(dim=-1).to(torch.int32)
    counts = torch.where(hyp_ok, counts, -1)

    best = torch.argmax(counts, dim=-1)  # first occurrence
    best_count = take(counts, best, batched)
    best_inliers = take(inlier_mat, best, batched)

    refit_t, refit_ok = kabsch(src, dst, best_inliers.to(torch.float32))
    ok = (best_count >= 3) & refit_ok

    # consensus purity: competitive = within max(2, 15% of best) inliers of
    # the winner; agreement = rms displacement of the winner's inliers
    # within 2x the inlier threshold (reference ransac.py:120-151)
    bc = best_count.clamp_min(1).to(torch.float32)
    slack = torch.maximum(torch.tensor(2.0, device=dev), 0.15 * bc)
    competitive = hyp_ok & (counts.to(torch.float32) >= (bc - slack)[..., None])
    n_inl = best_inliers.sum(dim=-1).clamp_min(1).to(torch.float32)
    best_moved = take(moved, best, batched)
    disp2 = torch.where(
        best_inliers[..., None, :, None], (moved - best_moved[..., None, :, :]) ** 2, 0.0
    ).sum(dim=(-2, -1)) / n_inl[..., None]
    agree = competitive & (disp2 <= (2.0 * inlier_threshold) ** 2)
    purity = agree.sum(dim=-1) / competitive.sum(dim=-1).clamp_min(1)
    best_t = take(hyp_t, best, batched)
    rel_rot = best_t[..., None, :3, :3] @ hyp_t[..., :3, :3].transpose(-1, -2)
    tr = rel_rot[..., 0, 0] + rel_rot[..., 1, 1] + rel_rot[..., 2, 2]
    rot_dev = torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0)) * (180.0 / math.pi)
    trans_dev = torch.linalg.vector_norm(
        hyp_t[..., :3, 3] - best_t[..., None, :3, 3], dim=-1
    )
    spread_deg = torch.where(competitive, rot_dev, 0.0).amax(dim=-1)
    spread_m = torch.where(competitive, trans_dev, 0.0).amax(dim=-1)

    inliers = best_inliers & ok[..., None]
    return RansacResult(
        transform=torch.where(ok[..., None, None], refit_t, tf.zero(dev)),
        inliers=inliers,
        inlier_count=torch.where(ok, inliers.sum(dim=-1), 0).to(torch.int32),
        ok=ok,
        consensus_purity=torch.where(ok, purity, 1.0).to(torch.float32),
        spread_deg=torch.where(ok, spread_deg, 0.0),
        spread_m=torch.where(ok, spread_m, 0.0),
    )
