"""Pairwise transform estimation (port of mapmerge_tpu/pipeline/registration.py).

The reference's estimateTransform (matching.cpp:223-257): an initial pose by
MATCHING (reciprocal k-NN matching, then RANSAC + SVD) or by SAC_IA, then
optional ICP refinement and the transformScore confidence.
"""

from __future__ import annotations

import dataclasses

import torch

from mapmerge_tpu.core.enums import EstimationMethod
from mapmerge_tpu.core.params import MergeParams
from mapmerge_torch.core import transforms as tf
from mapmerge_torch.ops.icp import icp_refine
from mapmerge_torch.ops.matching import find_correspondences
from mapmerge_torch.ops.ransac import ransac_transform
from mapmerge_torch.ops.sacia import sacia_transform
from mapmerge_torch.ops.score import confidence as confidence_fn
from mapmerge_torch.ops.score import transform_score
from mapmerge_torch.pipeline.features import CloudFeatures

#: default ambiguity thresholds of the reference (PairEstimate.ambiguous)
AMBIGUITY_MIN_COVERAGE = 0.25
AMBIGUITY_MIN_PURITY = 0.6
AMBIGUITY_MIN_SUPPORT = 0.1


@dataclasses.dataclass(frozen=True)
class PairEstimate:
    transform: torch.Tensor  # (4, 4); zeros on failure
    ok: torch.Tensor  # () bool
    confidence: torch.Tensor  # () float32
    inlier_count: torch.Tensor  # () int32
    #: fraction of valid source points whose NN in the target lies within
    #: max_correspondence_distance under the final transform
    coverage: torch.Tensor
    #: RANSAC consensus purity (ops/ransac.py); 1 for failed estimates
    consensus_purity: torch.Tensor
    #: winning inlier count / putative correspondence count; 1 when failed
    support: torch.Tensor

    def ambiguous(
        self,
        min_coverage: float = AMBIGUITY_MIN_COVERAGE,
        min_purity: float = AMBIGUITY_MIN_PURITY,
        min_support: float = AMBIGUITY_MIN_SUPPORT,
    ) -> torch.Tensor:
        """A successful registration whose evidence is structurally weak:
        low coverage, split RANSAC consensus, or thin inlier support."""
        weak = (
            (self.coverage < min_coverage)
            | (self.consensus_purity < min_purity)
            | (self.support < min_support)
        )
        return self.ok & weak


def estimate_transform(
    source: CloudFeatures,
    target: CloudFeatures,
    params: MergeParams,
    generator: torch.Generator | None = None,
    samples: torch.Tensor | None = None,
    pick: torch.Tensor | None = None,
) -> PairEstimate:
    """Reference matching.cpp:223-257. RANSAC or SAC-IA draws from
    `generator`, or takes `samples` (H, 3) (and SAC-IA's `pick` (H, 3))
    when given."""
    if params.estimation_method == EstimationMethod.MATCHING:
        corr = find_correspondences(
            source.descriptors.data,
            target.descriptors.data,
            k=params.matching_k,
            source_valid=source.descriptors.valid & source.keypoints.mask,
            target_valid=target.descriptors.valid & target.keypoints.mask,
        )
        res = ransac_transform(
            source.keypoints.xyz,
            target.keypoints.xyz,
            corr,
            inlier_threshold=params.inlier_threshold,
            num_hypotheses=params.ransac_hypotheses,
            generator=generator,
            samples=samples,
        )
        transform, ok, inliers = res.transform, res.ok, res.inlier_count
        purity = res.consensus_purity
        support = inliers / corr.valid.sum().clamp_min(1)
    elif params.estimation_method == EstimationMethod.SAC_IA:
        # the reference's SAC_IA branch reports no consensus evidence
        # (registration.py:127), so a SAC_IA pair is never ambiguous: a
        # known fault of the reference, ported as is
        purity = support = torch.ones((), device=source.cloud.device)
        transform, ok, inliers = sacia_transform(
            source.keypoints,
            source.descriptors,
            target.keypoints,
            target.descriptors,
            min_sample_distance=params.inlier_threshold,
            max_correspondence_distance=params.max_correspondence_distance,
            num_iterations=params.sacia_hypotheses,
            generator=generator,
            samples=samples,
            pick=pick,
        )
    else:
        raise ValueError(f"unknown estimation method: {params.estimation_method}")

    if params.refine_transform:
        refined, icp_ok = icp_refine(
            source.cloud,
            target.cloud,
            initial=transform,
            max_correspondence_distance=params.max_correspondence_distance,
            outlier_rejection_threshold=params.inlier_threshold,
            max_iterations=params.max_iterations,
            transform_epsilon=params.transform_epsilon,
            anneal=params.icp_anneal,
            # coarse-to-fine floor: one registration voxel
            min_correspondence_distance=params.resolution,
        )
        transform = torch.where(ok & icp_ok, refined, transform)

    transform = torch.where(ok, transform, tf.zero(transform.device))
    score, coverage = transform_score(
        source.cloud, target.cloud, transform,
        params.max_correspondence_distance,
    )
    if params.robust_confidence:
        conf = confidence_fn(score, coverage) * inliers.clamp_min(1)
    else:
        conf = confidence_fn(score)
    return PairEstimate(
        transform=transform,
        ok=ok,
        confidence=conf.to(torch.float32),
        inlier_count=inliers,
        coverage=torch.where(ok, coverage, 0.0).to(torch.float32),
        consensus_purity=purity.to(torch.float32),
        support=torch.where(ok, support, 1.0).to(torch.float32),
    )
