"""SAC-IA parity: sacia_transform fed the reference's own draws (the samples
and feature-match picks jax.random gives for the same key, which torch
cannot reproduce), its truncated error per hypothesis, the minimum sample
distance, and the SAC_IA branch of estimate_transform with the reference's
features carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.ops.descriptors.base import Descriptors as JDesc
from mapmerge_tpu.ops.keypoints.harris import Keypoints as JKeypoints
from mapmerge_tpu.ops.sacia import sacia_transform as j_sacia
from mapmerge_tpu.pipeline.features import extract_features as j_features
from mapmerge_tpu.pipeline.registration import estimate_transform as j_estimate
from mapmerge_torch import convert
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.ops.descriptors.base import Descriptors
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.sacia import sacia_transform as t_sacia
from mapmerge_torch.ops.sacia import truncated_error
from mapmerge_torch.pipeline.registration import estimate_transform as t_estimate

from synthetic import rotation_z, se3
from torch_parity import small_scene, t

K_FEATURES = 10


def reference_draws(key, s_valid, num, k_eff):
    """The samples and picks the reference's sacia_transform draws for
    `key` (mapmerge_tpu/ops/sacia.py:74-94)."""
    key_samples, key_pick = jax.random.split(key)
    g = jax.random.gumbel(key_samples, (num, s_valid.shape[0]))
    g = jnp.where(jnp.asarray(s_valid)[None, :], g, -1.0e12)
    _, samples = jax.lax.top_k(g, 3)
    pick = jax.random.randint(key_pick, samples.shape, 0, k_eff)
    return t(samples), t(pick)


def _case(rng, s=90, slots=100):
    """Source keypoints, their moved and noisy copies as targets in another
    order, descriptors that rank the true match first among 10 near ones."""
    truth = se3(rotation_z(0.6), [1.2, -0.8, 0.3])
    src = (rng.random((slots, 3)) * 8).astype(np.float32)
    dst = src @ truth[:3, :3].T + truth[:3, 3]
    dst += rng.normal(size=dst.shape).astype(np.float32) * 0.01
    perm = rng.permutation(slots)
    tgt = np.empty_like(dst)
    tgt[perm] = dst
    desc = rng.random((slots, 33)).astype(np.float32) * 10
    tdesc = np.empty_like(desc)
    tdesc[perm] = desc + rng.normal(size=desc.shape).astype(np.float32) * 0.5
    mask = np.arange(slots) < s
    valid = rng.random(slots) > 0.05
    return truth, (src, desc, mask, valid), (tgt, tdesc, np.ones(slots, bool), valid[perm])


def _jax_side(xyz, desc, mask, valid):
    return (
        JKeypoints(xyz=jnp.asarray(xyz), response=jnp.zeros(len(xyz)), mask=jnp.asarray(mask)),
        JDesc(data=jnp.asarray(desc), valid=jnp.asarray(valid)),
    )


def _torch_side(xyz, desc, mask, valid):
    return (
        Keypoints(xyz=t(xyz), response=torch.zeros(len(xyz)), mask=t(mask),
                  truncated=torch.zeros((), dtype=torch.int32)),
        Descriptors(data=t(desc), valid=t(valid)),
    )


@pytest.mark.parametrize("min_distance", [0.5, 3.0, 100.0])
def test_matches_reference_on_its_own_draws(rng, min_distance):
    """The same winner as the reference: transform to 1e-4, ok and inlier
    count equal. At 3 m the minimum sample distance invalidates a share of
    the hypotheses; at 100 m every one, and both fail with a zero matrix."""
    truth, s_side, t_side = _case(rng)
    key = jax.random.key(4)
    num = 512
    kw = dict(min_sample_distance=min_distance, max_correspondence_distance=1.0,
              num_iterations=num)
    jt, jok, jinl = j_sacia(*_jax_side(*s_side), *_jax_side(*t_side), key=key, **kw)
    s_valid = s_side[2] & s_side[3]
    samples, pick = reference_draws(key, s_valid, num, K_FEATURES)
    tt, tok, tinl = t_sacia(*_torch_side(*s_side), *_torch_side(*t_side),
                            samples=samples, pick=pick, **kw)
    assert bool(tok) == bool(jok) == (min_distance < 100)
    assert int(tinl) == int(jinl)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    if bool(tok):  # a coarse aligner: most valid sources land within 1 m
        assert int(tinl) > 0.8 * s_valid.sum()
    else:
        assert not tt.any() and int(tinl) == 0
    if min_distance == 3.0:  # a share of the samples is too close
        pts = s_side[0][samples.numpy()]
        close = np.linalg.norm(pts[:, [0, 0, 1]] - pts[:, [1, 2, 2]], axis=-1).min(1)
        assert 0.2 < (close < 3.0).mean() < 0.9


def test_truncated_error_per_hypothesis(rng):
    """Each hypothesis's error against a float64 numpy evaluation to 1e-5
    relative (the direct expansion; the reference's matmul identity is off
    by up to 1e-3 m per point after the square root), the counts exactly
    away from the bound, and the argmin on a well-separated case."""
    truth, (src, _, mask, _), (tgt, _, tmask, _) = _case(rng)
    tmask = tmask.copy()
    tmask[::7] = False
    hyps = np.stack(
        [se3(rotation_z(0.6 + 0.05 * i), truth[:3, 3] + 0.02 * i) for i in range(-20, 21)]
    ).astype(np.float32)
    err, inl = truncated_error(t(hyps), t(src), t(mask), t(tgt), t(tmask), 1.0)
    moved = src[None] @ hyps[:, :3, :3].transpose(0, 2, 1).astype(np.float64) + hyps[:, None, :3, 3]
    d = np.sqrt(((moved[:, :, None] - tgt[None, None, tmask]) ** 2).sum(-1)).min(-1)
    ref_err = np.where(mask, np.minimum(d, 1.0), 0.0).sum(-1)
    np.testing.assert_allclose(err.numpy(), ref_err, rtol=1e-5)
    away = ~((np.abs(d - 1.0) < 1e-4) & mask).any(axis=-1)
    assert away.mean() > 0.8
    np.testing.assert_array_equal(
        inl.numpy()[away], ((d < 1.0) & mask).sum(-1)[away]
    )
    assert int(torch.argmin(err)) == 20  # the true pose
    assert err.numpy()[20] < 0.5 * np.sort(err.numpy())[1]


@pytest.fixture(scope="module")
def estimates():
    """The slice scene under HARRIS + FPFH + SAC_IA: the reference's
    estimate_transform for a key, the port's on the reference's features
    with the reference's draws for that key, the port's with its own
    generator, and the truth.

    With 13 and 15 keypoints SAC-IA lands on a 180-degree flip for some
    draws in both packages (8 of 8 draws succeed only from 2048
    hypotheses, measured on the CPU); the key and the seed here are draws
    on which each registers at 512."""
    va, vb, cap, truth = small_scene()
    params = MergeParams.strict_parity(
        keypoint_type="HARRIS", keypoint_threshold=1.0, descriptor_type="FPFH",
        estimation_method="SAC_IA", refine_transform=True, max_iterations=20,
        sacia_hypotheses=512, max_points=8192, max_keypoints=128,
        max_neighbors=32, neighbor_tile=512,
    )
    jf = [j_features(JaxCloud.from_arrays(*v, capacity=cap), params) for v in (va, vb)]
    key = jax.random.key(0)
    jest = j_estimate(jf[1], jf[0], params, key)
    s_valid = np.asarray(jf[1].keypoints.mask & jf[1].descriptors.valid)
    samples, pick = reference_draws(key, s_valid, params.sacia_hypotheses, K_FEATURES)
    tf_ = [convert.features_from_numpy(jax.tree_util.tree_map(np.asarray, f)) for f in jf]
    injected = t_estimate(tf_[1], tf_[0], params, samples=samples, pick=pick)
    own = t_estimate(tf_[1], tf_[0], params, generator=torch.Generator().manual_seed(3))
    return jest, injected, own, truth


def test_registration_sacia_branch(estimates):
    """JAX features -> convert -> the port's estimate_transform with the
    reference's draws: the same pose (0.05 deg / 5 mm; ICP's 1-NN rounding
    differs), flags, inlier count and coverage. With its own generator the
    port registers too."""
    jest, test, own, truth = estimates
    assert bool(test.ok) and bool(jest.ok)
    assert int(test.inlier_count) == int(jest.inlier_count)
    rot, trans = ttf.pose_error(test.transform.numpy(), np.asarray(jest.transform))
    assert rot < 0.05 and trans < 0.005
    np.testing.assert_allclose(float(test.coverage), float(jest.coverage), atol=0.01)
    for est in (test, own):
        assert bool(est.ok)
        rot, trans = ttf.pose_error(est.transform.numpy(), truth)
        assert rot < 1.0 and trans < 0.1


def test_sacia_reports_no_consensus_evidence_reference_fault(estimates):
    """Known fault of the reference, ported as is: the SAC_IA branch sets
    consensus purity = support = 1 (mapmerge_tpu/pipeline/registration.py:
    127), so a SAC_IA pair is never flagged ambiguous for a split consensus
    or thin support; only low coverage can flag it."""
    for est in estimates[:3]:
        assert float(est.consensus_purity) == 1.0 and float(est.support) == 1.0
        assert not bool(est.ambiguous())
        assert bool(est.ambiguous(min_coverage=1.01))
