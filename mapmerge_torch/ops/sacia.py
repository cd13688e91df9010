"""SAC-IA, sample-consensus initial alignment (port of
mapmerge_tpu/ops/sacia.py).

pcl::SampleConsensusInitialAlignment as the reference configures it
(matching.cpp:142-194, 242-247): min_sample_distance = inlier_threshold,
with max_correspondence_distance and the iteration count from the params.
All hypotheses are drawn, solved and scored at once:
  1. the 10 nearest target keypoints of each source keypoint in descriptor
     space;
  2. 3 distinct valid source keypoints per hypothesis (Gumbel top-k); a
     hypothesis whose samples lie closer than the minimum sample distance
     is invalid (PCL draws again);
  3. one of the 10 feature matches per sampled keypoint, uniformly;
  4. a 3-point Kabsch per hypothesis, scored by PCL's truncated error: the
     sum over the valid source keypoints of min(nn distance,
     max_correspondence_distance), in chunks of 32 hypotheses;
  5. the least error wins (the first on ties).
Inputs may carry a leading pair axis: each pair draws from its own
generator, and all pairs' hypotheses are solved and scored at once.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.matching import descriptor_sq_dists, take
from mapmerge_torch.ops.neighbors import _f32, sq_dists
from mapmerge_torch.ops.ransac import sample_hypotheses
from mapmerge_torch.ops.rigid import kabsch

_BIG = 1.0e12
_K_FEATURES = 10  # PCL k_correspondences_ default
_CHUNK = 32


def _draws(generator, s_valid, num_iterations, k_eff, samples, pick):
    """One pair's (samples, pick): the given ones, or drawn from
    `generator`, samples first and picks second."""
    if samples is None:
        samples = sample_hypotheses(generator, s_valid, num_iterations)
    if pick is None:
        pick = torch.randint(
            0, k_eff, samples.shape, generator=generator, device=s_valid.device
        )
    return samples, pick


def sacia_transform(
    source_kp: Keypoints,
    source_desc: Descriptors,
    target_kp: Keypoints,
    target_desc: Descriptors,
    min_sample_distance: float,
    max_correspondence_distance: float,
    num_iterations: int,
    generator=None,
    samples: torch.Tensor | None = None,
    pick: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(transform (4, 4), ok (), inlier count ()): the count of valid source
    keypoints within max_correspondence_distance under the winner; a zero
    transform and count when no hypothesis is valid. Keypoints and
    descriptors with a leading pair axis (B, K, ...) register each pair of
    the batch, and every output then has that axis.

    The draws come from `generator` (a sequence of one generator a pair for
    a batch), samples first and picks second, or from `samples` ([B,] H, 3)
    source slots and `pick` ([B,] H, 3) feature-match ranks when given (the
    tests feed it the reference's own draws)."""
    batched = source_kp.mask.dim() == 2
    s_valid = source_kp.mask & source_desc.valid
    t_valid = target_kp.mask & target_desc.valid
    dev = source_kp.xyz.device

    # 1. feature-space k-NN, source -> target
    d2f = descriptor_sq_dists(source_desc.data, target_desc.data)
    d2f = torch.where(t_valid[..., None, :], d2f, _BIG)
    d2f = torch.where(s_valid[..., :, None], d2f, _BIG)
    k_eff = min(_K_FEATURES, target_desc.data.shape[-2])
    feat_nn = torch.topk(d2f, k_eff, dim=-1, largest=False).indices  # (S, k)

    # 2. three distinct valid source keypoints per hypothesis, and 3. one of
    # the k feature matches per sampled keypoint
    if not batched:
        samples, pick = _draws(generator, s_valid, num_iterations, k_eff, samples, pick)
    elif samples is None or pick is None:
        per_pair = [
            _draws(generator[b] if generator is not None else None, s_valid[b],
                   num_iterations, k_eff,
                   None if samples is None else samples[b],
                   None if pick is None else pick[b])
            for b in range(s_valid.shape[0])
        ]
        samples = torch.stack([d[0] for d in per_pair])
        pick = torch.stack([d[1] for d in per_pair])
    samples = samples.to(device=dev, dtype=torch.int64)
    pick = pick.to(device=dev, dtype=torch.int64)
    sample_valid = take(s_valid, samples, batched).all(dim=-1)
    src_pts = take(source_kp.xyz, samples, batched)  # (H, 3, 3)
    pd2 = ((src_pts[..., :, :, None, :] - src_pts[..., :, None, :, :]) ** 2).sum(dim=-1)
    eye = torch.eye(3, dtype=torch.bool, device=dev)
    min_ok = ((pd2 >= _f32(min_sample_distance**2)) | eye).all(dim=-1).all(dim=-1)

    match_idx = torch.gather(
        take(feat_nn, samples, batched), -1, pick[..., None]
    )[..., 0]
    dst_pts = take(target_kp.xyz, match_idx, batched)

    # 4. solve and score
    hyp_t, hyp_ok = kabsch(
        src_pts, dst_pts, torch.ones(samples.shape, dtype=torch.float32, device=dev)
    )
    hyp_ok = hyp_ok & sample_valid & min_ok

    err, inl = truncated_error(
        hyp_t, source_kp.xyz, s_valid, target_kp.xyz, t_valid,
        max_correspondence_distance,
    )
    err = torch.where(hyp_ok, err, _BIG)

    # 5. the best hypothesis
    best = torch.argmin(err, dim=-1)
    ok = take(hyp_ok, best, batched)
    transform = torch.where(ok[..., None, None], take(hyp_t, best, batched), tf.zero(dev))
    return transform, ok, torch.where(ok, take(inl, best, batched), 0)


def truncated_error(
    hyp_t: torch.Tensor,
    src: torch.Tensor,
    s_valid: torch.Tensor,
    tgt: torch.Tensor,
    t_valid: torch.Tensor,
    max_correspondence_distance: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PCL's truncated error of each hypothesis ([B,] H, 4, 4): the sum over
    the valid source points of min(nn distance,
    max_correspondence_distance), and the count of those nearer than it:
    (([B,] H), ([B,] H) int32), scored in chunks of 32 hypotheses (of each
    pair) to bound the (32, S, T) distance slab.

    The distances are the direct expansion: the reference's
    |a|^2 + |b|^2 - 2 a.b leaves ~1e-6 m^2 of cancellation, 1e-3 m after
    the square root."""
    mcd = _f32(max_correspondence_distance)
    errs, inls = [], []
    for s in range(0, hyp_t.shape[-3], _CHUNK):
        moved = tf.apply(hyp_t[..., s : s + _CHUNK, :, :], src[..., None, :, :])
        d2 = torch.where(
            t_valid[..., None, None, :], sq_dists(moved, tgt[..., None, :, :]), _BIG
        )
        nn = torch.sqrt(d2.amin(dim=-1))  # (h, S)
        errs.append(
            torch.where(s_valid[..., None, :], nn.clamp_max(mcd), 0.0).sum(dim=-1)
        )
        inls.append(((nn < mcd) & s_valid[..., None, :]).sum(dim=-1).to(torch.int32))
    return torch.cat(errs, dim=-1), torch.cat(inls, dim=-1)
