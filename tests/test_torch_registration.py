"""Registration parity: reciprocal matching, the closed-form Kabsch (with its
degenerate inputs), RANSAC fed the reference's own hypothesis draws, ICP,
the transform score, and estimate_transform on the reference's features
carried across with mapmerge_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.ops.icp import icp_refine as j_icp
from mapmerge_tpu.ops.matching import Correspondences as JCorr
from mapmerge_tpu.ops.matching import find_correspondences as j_match
from mapmerge_tpu.ops.ransac import _sample_hypotheses
from mapmerge_tpu.ops.ransac import ransac_transform as j_ransac
from mapmerge_tpu.ops.rigid import kabsch as j_kabsch
from mapmerge_tpu.ops.score import confidence as j_conf
from mapmerge_tpu.ops.score import transform_score as j_score
from mapmerge_tpu.pipeline.features import extract_features as j_features
from mapmerge_tpu.pipeline.registration import estimate_transform as j_estimate
from mapmerge_torch import convert
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.ops.icp import icp_refine as t_icp
from mapmerge_torch.ops.matching import Correspondences as TCorr
from mapmerge_torch.ops.matching import find_correspondences as t_match
from mapmerge_torch.ops.ransac import ransac_transform as t_ransac
from mapmerge_torch.ops.ransac import sample_hypotheses
from mapmerge_torch.ops.rigid import kabsch as t_kabsch
from mapmerge_torch.ops.score import confidence as t_conf
from mapmerge_torch.ops.score import transform_score as t_score
from mapmerge_torch.pipeline.registration import estimate_transform as t_estimate

from synthetic import rotation_z, se3
from torch_parity import SLICE_PARAMS, both_clouds, port_params, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


def _pose_gap(a, b):
    return ttf.pose_error(np.asarray(a), np.asarray(b))


class TestMatching:
    def test_reciprocal_first_match_matches_reference(self, rng):
        src = rng.random((60, 33)).astype(np.float32) * 10
        # targets: noisy copies of a shuffled subset plus distractors
        perm = rng.permutation(60)[:40]
        tgt = np.concatenate([
            src[perm] + rng.normal(size=(40, 33)).astype(np.float32) * 0.3,
            rng.random((30, 33)).astype(np.float32) * 10,
        ])
        sv = rng.random(60) > 0.1
        tv = rng.random(70) > 0.1
        jc = j_match(jnp.asarray(src), jnp.asarray(tgt), 5,
                     jnp.asarray(sv), jnp.asarray(tv))
        tc = t_match(t(src), t(tgt), 5, t(sv), t(tv))
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        v = tc.valid.numpy()
        assert v.sum() > 20
        np.testing.assert_array_equal(tc.target.numpy()[v], np.asarray(jc.target)[v])
        # |a|^2 + |b|^2 - 2 a.b on 33-d descriptors: float32 cancellation
        np.testing.assert_allclose(tc.distance.numpy(), np.asarray(jc.distance),
                                   rtol=1e-4, atol=5e-3)
        assert tc.target.dtype == torch.int32

    def test_no_valid_targets(self, rng):
        src = rng.random((8, 33)).astype(np.float32)
        tc = t_match(t(src), t(src), 3, None, torch.zeros(8, dtype=torch.bool))
        assert not tc.valid.any() and (tc.distance == 1e12).all()


class TestKabsch:
    """The same analytic solve as the reference: transforms to 1e-4 and
    identical ok flags, including the degenerate inputs."""

    def test_random_rigid_recovered(self, rng):
        truth = se3(rotation_z(0.7), [0.3, -1.0, 2.0])
        src = rng.normal(size=(5, 50, 3)).astype(np.float32)
        dst = src @ truth[:3, :3].T + truth[:3, 3]
        w = (rng.random((5, 50)) > 0.2).astype(np.float32)
        jt, jok = j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        tt, tok = t_kabsch(t(src), t(dst), t(w))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tok.all()
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
        np.testing.assert_allclose(tt.numpy()[0], truth, atol=1e-4)

    def test_three_point_samples(self, rng):
        src = rng.normal(size=(64, 3, 3)).astype(np.float32)
        truth = se3(rotation_z(-0.3), [1.0, 0.5, 0.0])
        dst = src @ truth[:3, :3].T + truth[:3, 3]
        w = np.ones((64, 3), np.float32)
        jt, jok = j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        tt, tok = t_kabsch(t(src), t(dst), t(w))
        # a random 3-point sample can sit on the lam1/lam2 or orthogonality
        # threshold, where float32 rounding decides: allow 2 of 64
        tok, jok = tok.numpy(), np.asarray(jok)
        assert (tok != jok).sum() <= 2 and tok.sum() > 50
        # and an ill-conditioned sample amplifies rounding in its rotation:
        # 90% of the samples both accept agree to 1e-3
        both = tok & jok
        gap = np.abs(tt.numpy() - np.asarray(jt)).max(axis=(1, 2))
        assert (gap[both] <= 1e-3).mean() >= 0.9

    @pytest.mark.parametrize("case", ["two_pairs", "zero_weight", "collinear"])
    def test_degenerate_inputs(self, rng, case):
        src = rng.normal(size=(10, 3)).astype(np.float32)
        w = np.ones(10, np.float32)
        if case == "two_pairs":
            w[2:] = 0.0
        elif case == "zero_weight":
            w[:] = 0.0
        else:
            src = np.outer(np.linspace(-1, 1, 10), [1.0, 2.0, 0.5]).astype(np.float32)
        dst = src + np.float32(0.5)
        jt, jok = j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        tt, tok = t_kabsch(t(src), t(dst), t(w))
        assert not bool(tok) and not bool(jok)
        np.testing.assert_array_equal(tt.numpy(), np.eye(4, dtype=np.float32))

    def test_large_cloud_flags_match_reference(self):
        """Known fault of the reference, ported as is: on a cloud of tens of
        thousands of points the float32 eigenvectors of H^T H lose
        orthogonality and the proper-rotation check fails, so ICP stops at
        its first iteration on eval config #1. Both packages agree."""
        from mapmerge_torch.testing.scene import config1_scene

        (src, _), _, _, _ = config1_scene()
        truth = se3(rotation_z(0.01), [0.02, 0.01, 0.0])
        dst = src @ truth[:3, :3].T + truth[:3, 3]
        w = np.ones(len(src), np.float32)
        _, jok = j_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        _, tok = t_kabsch(t(src), t(dst), t(w))
        assert not bool(jok) and not bool(tok)


def _corr_case(rng, s=80, outliers=0.4):
    truth = se3(rotation_z(0.5), [1.0, -0.4, 0.3])
    src_kp = (rng.random((s, 3)) * 6).astype(np.float32)
    dst_kp = src_kp @ truth[:3, :3].T + truth[:3, 3]
    dst_kp += rng.normal(size=dst_kp.shape).astype(np.float32) * 0.02
    bad = rng.random(s) < outliers
    dst_kp[bad] = (rng.random((bad.sum(), 3)) * 6).astype(np.float32)
    perm = rng.permutation(s).astype(np.int32)
    tgt_kp = np.empty_like(dst_kp)
    tgt_kp[perm] = dst_kp
    valid = rng.random(s) > 0.1
    return src_kp, tgt_kp, perm, valid, truth


class TestRansac:
    def test_matches_reference_on_its_own_draws(self, rng):
        """RANSAC fed the hypotheses JAX draws for the same key: the same
        winner, inliers and purity; transforms to 1e-4."""
        src_kp, tgt_kp, perm, valid, truth = _corr_case(rng)
        key = jax.random.key(3)
        jcorr = JCorr(target=jnp.asarray(perm), distance=jnp.zeros(len(perm)),
                      valid=jnp.asarray(valid))
        jr = j_ransac(jnp.asarray(src_kp), jnp.asarray(tgt_kp), jcorr,
                      inlier_threshold=0.1, num_hypotheses=256, key=key)
        samples = np.asarray(_sample_hypotheses(key, jnp.asarray(valid), 256))
        tcorr = TCorr(target=t(perm), distance=torch.zeros(len(perm)),
                      valid=t(valid))
        tr = t_ransac(t(src_kp), t(tgt_kp), tcorr, inlier_threshold=0.1,
                      num_hypotheses=256, samples=t(samples))
        assert bool(tr.ok) and bool(jr.ok)
        np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
        assert int(tr.inlier_count) == int(jr.inlier_count)
        np.testing.assert_allclose(tr.transform.numpy(), np.asarray(jr.transform),
                                   atol=1e-4)
        np.testing.assert_allclose(tr.transform.numpy(), truth, atol=0.05)
        np.testing.assert_allclose(float(tr.consensus_purity),
                                   float(jr.consensus_purity), atol=1e-6)
        np.testing.assert_allclose(float(tr.spread_deg), float(jr.spread_deg),
                                   atol=0.05)
        np.testing.assert_allclose(float(tr.spread_m), float(jr.spread_m),
                                   atol=1e-3)

    def test_generator_draws_and_failure_contract(self, rng):
        src_kp, tgt_kp, perm, valid, truth = _corr_case(rng)
        g = torch.Generator().manual_seed(0)
        samples = sample_hypotheses(g, t(valid), 300)
        assert samples.shape == (300, 3)
        assert valid[samples.numpy()].all()  # only valid slots
        s = np.sort(samples.numpy(), axis=1)
        assert (np.diff(s, axis=1) > 0).all()  # distinct within a sample
        tcorr = TCorr(target=t(perm), distance=torch.zeros(len(perm)), valid=t(valid))
        tr = t_ransac(t(src_kp), t(tgt_kp), tcorr, 0.1, 300,
                      generator=torch.Generator().manual_seed(0))
        assert bool(tr.ok)
        np.testing.assert_allclose(tr.transform.numpy(), truth, atol=0.05)
        # fewer than 3 valid correspondences: zero matrix, empty inliers
        few = np.zeros_like(valid)
        few[:2] = True
        tcorr = TCorr(target=t(perm), distance=torch.zeros(len(perm)), valid=t(few))
        tr = t_ransac(t(src_kp), t(tgt_kp), tcorr, 0.1, 64,
                      generator=torch.Generator().manual_seed(0))
        assert not bool(tr.ok) and not tr.transform.any() and not tr.inliers.any()
        assert float(tr.consensus_purity) == 1.0


@pytest.fixture(scope="module")
def views():
    """The slice scene's two views, downsampled as the feature stage does,
    in both packages."""
    va, vb, cap, truth = small_scene()
    from mapmerge_tpu.ops.downsample import voxel_downsample as jv
    from mapmerge_torch.ops.downsample import voxel_downsample as tv

    out = []
    for xyz, rgb in (va, vb):
        jc, tc = both_clouds(xyz, rgb, capacity=cap)
        out.append((jv(jc, 0.1, out_capacity=4096), tv(tc, 0.1, out_capacity=4096)))
    return out, truth


class TestIcpAndScore:
    def test_icp_matches_reference(self, views):
        """Both converge to the same pose from a perturbed start (1e-3 deg /
        1e-4 m): the port's 1-NN is exact, the reference's CPU path uses the
        matmul identity, so a bounded pair may switch at the bound."""
        (ja, ta), (jb, tb) = views[0]
        truth = views[1]
        # source = view B (local frame), target = view A: truth maps B into A
        init = se3(rotation_z(0.4 + 0.02), [1.45, -0.66, 0.2])
        kw = dict(max_correspondence_distance=1.0, outlier_rejection_threshold=0.5,
                  max_iterations=50, transform_epsilon=1e-2,
                  min_correspondence_distance=0.1)
        jt, jok, _ = j_icp(jb, ja, jnp.asarray(init), tile=512, **kw)
        tt, tok, tover = t_icp(tb, ta, t(init), **kw)
        assert tok and bool(jok) and int(tover) == 0
        rot, trans = _pose_gap(tt.numpy(), np.asarray(jt))
        assert rot < 1e-3 and trans < 1e-4
        rot, trans = _pose_gap(tt.numpy(), truth)
        assert rot < 0.1 and trans < 0.01

    def test_icp_from_zero_guess_does_not_converge(self, views):
        (ja, ta), (jb, tb) = views[0]
        tt, tok, _ = t_icp(tb, ta, torch.zeros(4, 4), 1.0, 0.5, 20, 1e-2)
        _, jok, _ = j_icp(jb, ja, jnp.zeros((4, 4)), 1.0, 0.5, 20, 1e-2)
        assert tok == bool(jok) == False  # noqa: E712

    def test_score_and_confidence_match_reference(self, views):
        (ja, ta), (jb, tb) = views[0]
        for pose in (views[1], se3(rotation_z(0.3), [1.0, -0.5, 0.2])):
            js, jcov, _ = j_score(jb, ja, jnp.asarray(pose), 1.0)
            ts, tcov, tover = t_score(tb, ta, t(pose), 1.0)
            assert tover == 0
            np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
            np.testing.assert_allclose(float(tcov), float(jcov), atol=1e-3)
            np.testing.assert_allclose(
                float(t_conf(ts, tcov)), float(j_conf(js, jcov)), rtol=1e-3
            )
        far = np.eye(4, dtype=np.float32)
        far[:3, 3] = 100.0
        ts, tcov, _ = t_score(tb, ta, t(far), 1.0)
        assert float(ts) == float(np.float32(1e30)) and float(tcov) == 0.0


class TestEstimateTransform:
    def test_reference_features_carried_across(self):
        """JAX features -> convert -> the port's estimate_transform, with
        RANSAC fed the reference's draws for its key: the same pose as the
        reference's estimate_transform (0.05 deg / 5 mm; ICP's 1-NN
        rounding differs) and the same flags."""
        va, vb, cap, truth = small_scene()
        jf = [
            j_features(JaxCloud.from_arrays(xyz, rgb, capacity=cap), SLICE_PARAMS)
            for xyz, rgb in (va, vb)
        ]
        key = jax.random.key(11)
        jest = j_estimate(jf[1], jf[0], SLICE_PARAMS, key)
        jcorr = j_match(
            jf[1].descriptors.data, jf[0].descriptors.data, SLICE_PARAMS.matching_k,
            jf[1].descriptors.valid & jf[1].keypoints.mask,
            jf[0].descriptors.valid & jf[0].keypoints.mask,
        )
        samples = _sample_hypotheses(key, jcorr.valid, SLICE_PARAMS.ransac_hypotheses)
        tf_ = [convert.features_from_numpy(jax.tree_util.tree_map(np.asarray, f), "cpu")
               for f in jf]
        test = t_estimate(tf_[1], tf_[0], port_params(SLICE_PARAMS), samples=t(samples))
        assert bool(test.ok) and bool(jest.ok)
        assert int(test.inlier_count) == int(jest.inlier_count)
        rot, trans = _pose_gap(test.transform.numpy(), np.asarray(jest.transform))
        assert rot < 0.05 and trans < 0.005
        rot, trans = _pose_gap(test.transform.numpy(), truth)
        assert rot < 1.0 and trans < 0.1
        np.testing.assert_allclose(float(test.coverage), float(jest.coverage), atol=0.01)
        np.testing.assert_allclose(float(test.support), float(jest.support), atol=1e-6)
        assert bool(test.ambiguous()) == bool(jest.ambiguous())
