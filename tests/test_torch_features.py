"""Feature-stage parity: SIFT keypoints, the Darboux pair features, the plain
SPFH version of kernel B (kernels/spfh.py: spfh_ref) against the Pallas
kernel in interpret mode and against the reference's `_spfh_dense`, and
FPFH-33, each against mapmerge_tpu on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.ops.descriptors import darboux as jd
from mapmerge_tpu.ops.descriptors.fpfh import _spfh_dense as j_spfh_dense
from mapmerge_tpu.ops.descriptors.fpfh import compute_fpfh as j_fpfh
from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
from mapmerge_tpu.ops.keypoints.sift import detect_keypoints_sift as j_sift
from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
from mapmerge_tpu.pallas.spfh import spfh_tile_pallas
from mapmerge_torch import convert
from mapmerge_torch.kernels import spfh as kspfh
from mapmerge_torch.ops.descriptors import darboux as td
from mapmerge_torch.ops.descriptors.fpfh import _spfh_dense as t_spfh_dense
from mapmerge_torch.ops.descriptors.fpfh import compute_fpfh as t_fpfh
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.keypoints.sift import detect_keypoints_sift as t_sift
from mapmerge_torch.ops.normals import SurfaceNormals

from torch_parity import SLICE_PARAMS, both_clouds, small_scene, t


@pytest.fixture(scope="module")
def surface():
    """The slice scene's view A after the reference's downsample, outlier
    removal and normals: (jax cloud, jax normals), the same as torch."""
    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, _ = both_clouds(a_xyz, a_rgb, capacity=cap)
    p = SLICE_PARAMS
    jc = j_voxel(jc, p.resolution, out_capacity=min(cap, p.max_points))
    jc = j_outliers(jc, p.descriptor_radius, p.outliers_min_neighbours, tile=512)
    jn = j_normals(jc, p.normal_radius, tile=512)
    tc = convert.cloud_from_numpy(jc)
    tn = SurfaceNormals(
        normals=t(jn.normals), curvature=t(jn.curvature), valid=t(jn.valid)
    )
    return jc, jn, tc, tn


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestDarboux:
    def test_pair_features_and_bins_match_reference(self, rng):
        p1, p2 = rng.normal(size=(2, 500, 3)).astype(np.float32)
        p2[:5] = p1[:5]  # coincident pairs are not ok
        n1, n2 = _unit(rng, (500, 3)), _unit(rng, (500, 3))
        got = td.pair_features(t(p1), t(n1), t(p2), t(n2))
        ref = jd.pair_features(*(jnp.asarray(a) for a in (p1, n1, p2, n2)))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        assert not got[4][:5].any()
        ok = got[4].numpy()  # theta of a coincident pair is +-pi by rounding
        for g, r in zip(got[:4], ref[:4]):  # theta, alpha, phi, dist
            np.testing.assert_allclose(g.numpy()[ok], np.asarray(r)[ok], atol=2e-6)
        vals = np.linspace(-4, 4, 801).astype(np.float32)
        np.testing.assert_array_equal(
            td.bin_index(t(vals), -np.pi, np.pi, 11).numpy(),
            np.asarray(jd.bin_index(jnp.asarray(vals), -np.pi, np.pi, 11)),
        )


def _spfh_case(rng, b, cq, bc, m):
    q_xyz = rng.uniform(-1, 1, (b, cq, 3)).astype(np.float32)
    q_nrm = _unit(rng, (b, cq, 3))
    cand_xyz = rng.uniform(-1, 1, (bc, m, 3)).astype(np.float32)
    # identical coordinates exercise the zero-distance self-hit exclusion
    cand_xyz[:, :cq] = q_xyz[:bc]
    cand_nrm = _unit(rng, (bc, m, 3))
    cand_ok = rng.uniform(size=(bc, m)) > 0.2
    return q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok


class TestSpfhRef:
    """spfh_ref, the plain version of kernel B, mirroring
    tests/test_pallas.py:TestPallasSPFH. Pair counts exactly; histograms to
    2e-3, as there (the Pallas kernel bins theta by sector tests and uses
    rsqrt, so a pair on a bin edge may land in the neighbouring bin)."""

    @pytest.mark.parametrize("shared", [False, True])
    def test_parity_with_pallas(self, rng, shared):
        b, cq, m = 3, 16, 160
        case = _spfh_case(rng, b, cq, 1 if shared else b, m)
        ph, pt = spfh_tile_pallas(
            *(jnp.asarray(a) for a in case), r2=0.64, chunk=128, interpret=True
        )
        th, tt = kspfh.spfh_ref(*(t(a) for a in case), r2=0.64)
        assert th.shape == (b, cq, 33) and tt.shape == (b, cq)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(pt))
        np.testing.assert_allclose(th.numpy(), np.asarray(ph), atol=2e-3)
        sums = th.numpy().reshape(b, cq, 3, 11).sum(-1)
        np.testing.assert_allclose(sums[tt.numpy() > 0], 100.0, atol=1e-3)

    def test_chunking_does_not_change_results(self, rng, monkeypatch):
        case = [t(a) for a in _spfh_case(rng, 2, 20, 1, 300)]
        whole = kspfh.spfh_ref(*case, r2=1.0)
        monkeypatch.setattr(kspfh, "_PLANE", 300 * 3)  # 3-query chunks
        chunked = kspfh.spfh_ref(*case, r2=1.0)
        assert torch.equal(whole[1], chunked[1])
        np.testing.assert_allclose(whole[0].numpy(), chunked[0].numpy(), atol=1e-5)

    def test_wrapper_takes_plain_version_only_on_cpu(self, rng):
        case = [t(a) for a in _spfh_case(rng, 2, 8, 2, 50)]
        before = kspfh.KERNEL.launches
        h, tot = kspfh.spfh_tile(*case, r2=0.64)
        ref = kspfh.spfh_ref(*case, r2=0.64)
        assert kspfh.KERNEL.launches == before
        assert torch.equal(tot, ref[1])
        with pytest.raises(ValueError, match="unsupported device"):
            kspfh.spfh_tile(*(a.to("meta") for a in case), r2=0.64)

    def test_matches_reference_spfh_dense(self, surface):
        """The port's _spfh_dense (through spfh_ref) against the reference's
        XLA branch on a real surface: the same math, so pair counts match
        and histograms agree to 1e-3, except for rows where a pair sits on
        a bin edge, the r2 boundary or at zero distance (<= 1% of rows)."""
        jc, jn, tc, tn = surface
        idx = np.flatnonzero(np.asarray(jn.valid))[::7][:96]
        q_xyz, q_nrm = np.asarray(jc.xyz)[idx], np.asarray(jn.normals)[idx]
        q_ok = np.ones(len(idx), bool)
        jh, jok = j_spfh_dense(
            jnp.asarray(q_xyz), jnp.asarray(q_nrm), jnp.asarray(q_ok), jc, jn,
            radius=0.8, max_neighbors=48, tile=512,
        )
        th, tok = t_spfh_dense(
            t(q_xyz).reshape(8, 12, 3), t(q_nrm).reshape(8, 12, 3),
            t(q_ok).reshape(8, 12), tc, tn, radius=0.8,
        )
        th, tok = th.reshape(-1, 33).numpy(), tok.reshape(-1).numpy()
        np.testing.assert_array_equal(tok, np.asarray(jok))
        assert tok.all()
        bad = np.abs(th - np.asarray(jh)).max(axis=1) > 1e-3
        assert bad.mean() <= 0.01, f"{bad.sum()} rows differ"


class TestSift:
    def test_keypoints_match_reference(self, surface):
        """Same cloud into both detectors. The 25-NN sets and DoG values
        come from differently rounded float32 matmuls, so an extremum at a
        near-tie may flip: >= 95% of the reference's keypoints are found at
        the same point with the same response (1e-3 relative)."""
        jc, _, tc, _ = surface
        kw = dict(min_scale=0.1, octaves=3, scales_per_octave=3,
                  min_contrast=3.0, max_keypoints=256, tile=512)
        jk = j_sift(jc, **kw)
        tk = t_sift(tc, **kw)
        assert tk.xyz.shape == (256, 3) and tk.mask.dtype == torch.bool
        jm, tm = np.asarray(jk.mask), tk.mask.numpy()
        assert jm.sum() > 30
        assert abs(int(tm.sum()) - int(jm.sum())) <= max(2, 0.03 * jm.sum())
        assert abs(int(tk.truncated) - int(jk.truncated)) <= max(2, 0.03 * jm.sum())
        jxyz, txyz = np.asarray(jk.xyz)[jm], tk.xyz.numpy()[tm]
        jr, tr = np.asarray(jk.response)[jm], tk.response.numpy()[tm]
        # a point can be an extremum at several DoG levels: match on the
        # point and its response
        same = (np.abs(jxyz[:, None] - txyz[None]).max(-1) < 1e-6) & (
            np.abs(jr[:, None] - tr[None]) <= 1e-3 * jr[:, None]
        )
        assert same.any(axis=1).mean() >= 0.95
        # invalid slots: parked at FAR with zero response
        assert (tk.xyz.numpy()[~tm] == 1e8).all() and (tk.response.numpy()[~tm] == 0).all()


class TestFpfh:
    def test_descriptors_match_reference(self, surface):
        """FPFH on the same cloud, normals and keypoints. The 48 nearest
        in-radius neighbours can differ at equal or boundary distances, and
        an SPFH pair can change bin at an edge: >= 95% of descriptors agree
        to 0.5 (blocks sum to 100)."""
        jc, jn, tc, tn = surface
        rng = np.random.default_rng(5)
        valid = np.flatnonzero(np.asarray(jn.valid))
        pick = rng.choice(valid, 64, replace=False)
        kp_xyz = np.full((80, 3), 1e8, np.float32)
        kp_xyz[:64] = np.asarray(jc.xyz)[pick]
        kp_mask = np.arange(80) < 64
        from mapmerge_tpu.ops.keypoints.harris import Keypoints as JKeypoints

        jk = JKeypoints(xyz=jnp.asarray(kp_xyz), response=jnp.zeros(80),
                        mask=jnp.asarray(kp_mask))
        tk = Keypoints(xyz=t(kp_xyz), response=torch.zeros(80),
                       mask=t(kp_mask), truncated=torch.zeros((), dtype=torch.int32))
        jdsc = j_fpfh(jc, jn, jk, radius=0.8, max_neighbors=48, tile=512)
        tdsc = t_fpfh(tc, tn, tk, radius=0.8, max_neighbors=48, tile=512)
        assert tdsc.data.shape == (80, 33)
        np.testing.assert_array_equal(tdsc.valid.numpy(), np.asarray(jdsc.valid))
        assert tdsc.valid[:64].all() and not tdsc.valid[64:].any()
        err = np.abs(tdsc.data.numpy() - np.asarray(jdsc.data)).max(axis=1)
        assert (err[:64] <= 0.5).mean() >= 0.95, np.sort(err)[-5:]
        sums = tdsc.data.numpy()[:64].reshape(64, 3, 11).sum(-1)
        np.testing.assert_allclose(sums, 100.0, atol=1e-3)
