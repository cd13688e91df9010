"""Batched-hypothesis RANSAC over correspondences (port of
mapmerge_tpu/ops/ransac.py).

All hypotheses are drawn at once (3 distinct valid correspondences each, by a
Gumbel top-k), solved with the closed-form 3-point Kabsch, scored against
every correspondence, and the best (first on ties) is refit on its inliers.
Failure is a zero 4x4 and an empty inlier set. The consensus purity and
spread of the competitive hypotheses are the ambiguity evidence.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.ops.matching import Correspondences
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


def ransac_transform(
    source_kp: torch.Tensor,
    target_kp: torch.Tensor,
    corr: Correspondences,
    inlier_threshold: float,
    num_hypotheses: int,
    generator: torch.Generator | None = None,
    samples: torch.Tensor | None = None,
) -> RansacResult:
    """Estimate T (source -> target) from putative correspondences.

    The hypotheses come from `generator`, or from `samples` (H, 3) when
    given (the tests feed it the reference's own draws)."""
    src = source_kp[: corr.target.shape[0]]  # (S, 3) aligned slots
    dst = target_kp[corr.target.to(torch.int64)]  # (S, 3) matched targets
    valid = corr.valid
    thr2 = _f32(inlier_threshold * inlier_threshold)
    dev = src.device

    if samples is None:
        samples = sample_hypotheses(generator, valid, num_hypotheses)
    samples = samples.to(device=dev, dtype=torch.int64)
    sample_ok = valid[samples].all(dim=-1)  # (H,)
    hyp_t, hyp_ok = kabsch(
        src[samples], dst[samples],
        torch.ones(samples.shape, dtype=torch.float32, device=dev),
    )
    hyp_ok = hyp_ok & sample_ok

    moved = tf.apply(hyp_t, src)  # (H, S, 3)
    resid2 = ((moved - dst[None]) ** 2).sum(dim=-1)
    inlier_mat = (resid2 <= thr2) & valid[None, :]
    counts = inlier_mat.sum(dim=-1).to(torch.int32)
    counts = torch.where(hyp_ok, counts, -1)

    best = torch.argmax(counts)  # first occurrence
    best_count = counts[best]
    best_inliers = inlier_mat[best]

    refit_t, refit_ok = kabsch(src, dst, best_inliers.to(torch.float32))
    ok = (best_count >= 3) & refit_ok

    # consensus purity: competitive = within max(2, 15% of best) inliers of
    # the winner; agreement = rms displacement of the winner's inliers
    # within 2x the inlier threshold (reference ransac.py:120-151)
    bc = best_count.clamp_min(1).to(torch.float32)
    slack = torch.maximum(torch.tensor(2.0, device=dev), 0.15 * bc)
    competitive = hyp_ok & (counts.to(torch.float32) >= bc - slack)
    n_inl = best_inliers.sum().clamp_min(1).to(torch.float32)
    disp2 = torch.where(
        best_inliers[None, :, None], (moved - moved[best][None]) ** 2, 0.0
    ).sum(dim=(1, 2)) / n_inl
    agree = competitive & (disp2 <= (2.0 * inlier_threshold) ** 2)
    purity = agree.sum() / competitive.sum().clamp_min(1)
    best_t = hyp_t[best]
    rel_rot = best_t[:3, :3] @ hyp_t[:, :3, :3].transpose(-1, -2)
    tr = rel_rot[:, 0, 0] + rel_rot[:, 1, 1] + rel_rot[:, 2, 2]
    rot_dev = torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0)) * (180.0 / math.pi)
    trans_dev = torch.linalg.vector_norm(hyp_t[:, :3, 3] - best_t[:3, 3], dim=-1)
    spread_deg = torch.where(competitive, rot_dev, 0.0).amax()
    spread_m = torch.where(competitive, trans_dev, 0.0).amax()

    inliers = best_inliers & ok
    return RansacResult(
        transform=torch.where(ok, refit_t, tf.zero(dev)),
        inliers=inliers,
        inlier_count=torch.where(ok, inliers.sum(), 0).to(torch.int32),
        ok=ok,
        consensus_purity=torch.where(ok, purity, 1.0).to(torch.float32),
        spread_deg=torch.where(ok, spread_deg, 0.0),
        spread_m=torch.where(ok, spread_m, 0.0),
    )
