"""Preprocessing parity: voxel downsampling (order, centroids, RGB, the drop
order past the capacity cap), radius outlier removal, the closed-form 3x3
eigensolver and surface normals, against mapmerge_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
from mapmerge_tpu.ops.eigh3 import eigvalsh3 as j_eigvals
from mapmerge_tpu.ops.eigh3 import smallest_eigenpair3 as j_eigpair
from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
from mapmerge_torch.ops.downsample import _lexsort, _segment_sums
from mapmerge_torch.ops.downsample import voxel_downsample as t_voxel
from mapmerge_torch.ops.eigh3 import eigvalsh3 as t_eigvals
from mapmerge_torch.ops.eigh3 import smallest_eigenpair3 as t_eigpair
from mapmerge_torch.ops.normals import compute_surface_normals as t_normals
from mapmerge_torch.ops.outliers import remove_outliers as t_outliers

from torch_parity import both_clouds, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)


def _points(rng, n=3000, scale=3.0):
    # off-grid coordinates: no point sits on a voxel face, where float32
    # rounding of x / resolution decides the key
    xyz = (rng.random((n, 3)) * scale + 0.013).astype(np.float32)
    return xyz, rng.random((n, 3)).astype(np.float32)


def _cloud_arrays(c):
    return c.xyz.numpy(), c.rgb.numpy(), c.mask.numpy()


class TestVoxelDownsample:
    """Centroids to 1e-6 (sums of the same points in another order); keys,
    order, masks and the dropped count exactly."""

    def test_lexsort_matches_jnp(self, rng):
        keys = [t(rng.integers(-3, 4, 400).astype(np.int32)) for _ in range(3)]
        kx, ky, kz = keys
        ref = np.asarray(jnp.lexsort((jnp.asarray(kz.numpy()),
                                      jnp.asarray(ky.numpy()),
                                      jnp.asarray(kx.numpy()))))
        np.testing.assert_array_equal(_lexsort(kx, ky, kz).numpy(), ref)

    @pytest.mark.parametrize("out_capacity", [None, 2000, 300])
    def test_centroids_order_and_drops(self, rng, out_capacity):
        xyz, rgb = _points(rng)
        jc, tc = both_clouds(xyz, rgb, capacity=3500)
        jo, jd = j_voxel(jc, 0.25, out_capacity=out_capacity, with_stats=True)
        to, td = t_voxel(tc, 0.25, out_capacity=out_capacity, with_stats=True)
        txyz, trgb, tmask = _cloud_arrays(to)
        np.testing.assert_array_equal(tmask, np.asarray(jo.mask))
        np.testing.assert_allclose(txyz, np.asarray(jo.xyz), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(trgb, np.asarray(jo.rgb), atol=1e-6)
        assert int(td) == int(jd)
        if out_capacity == 300:  # the cap drops the tail of the key order
            assert int(td) > 0 and tmask.all()

    def test_masked_input_and_downsample_of_scene(self):
        (a_xyz, a_rgb), _, cap, _ = small_scene()
        jc, tc = both_clouds(a_xyz, a_rgb, capacity=cap)
        jo = j_voxel(jc, 0.1, out_capacity=4096)
        to = t_voxel(tc, 0.1, out_capacity=4096)
        np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
        np.testing.assert_allclose(
            to.xyz.numpy(), np.asarray(jo.xyz), rtol=1e-6, atol=1e-6
        )


    @pytest.mark.parametrize("cap", [400, 150])
    def test_segment_sums_fixed_order(self, rng, cap):
        """The segmented doubling scan against float64 sums, on segments of
        1 to 300 rows (9 doubling steps): rtol 1e-6 (each row takes part in
        at most log2(300) additions). Segments at or past `cap` are
        dropped; a zero tail outside `live` sums to zero."""
        lengths = np.concatenate([rng.integers(1, 8, 300), [300, 257, 1]])
        seg = np.repeat(np.arange(len(lengths)), lengths)
        n = seg.size
        vals = rng.random((n + 500, 4)).astype(np.float32)
        vals[n:] = 0.0  # a dead tail: one long segment of zeros
        seg = np.concatenate([seg, np.full(500, len(lengths))])
        boundary = np.ones(n + 500, bool)
        boundary[1:] = seg[1:] != seg[:-1]
        seg_ids = np.minimum(seg, cap)
        got = _segment_sums(
            t(vals), t(boundary), t(seg_ids).long(), cap,
            live=t(np.arange(n + 500) < n),
        ).numpy()
        want = np.zeros((cap + 1, 4))
        np.add.at(want, seg_ids, vals.astype(np.float64))
        assert got.shape == (cap, 4)
        np.testing.assert_allclose(got, want[:cap], rtol=1e-6)


class TestOutliers:
    def test_remove_outliers_matches_reference(self, rng):
        xyz, rgb = _points(rng, 1500, scale=4.0)
        jc, tc = both_clouds(xyz, rgb, capacity=1600)
        jo = j_outliers(jc, 0.4, 6, tile=256)
        to = t_outliers(tc, 0.4, 6, tile=256)
        jm, tm = np.asarray(jo.mask), to.mask.numpy()
        # membership can differ only for a point with a neighbour on the
        # radius (float32 rounding of either matmul): allow 0.5%
        assert (jm != tm).mean() <= 0.005
        assert 0.05 < tm[:1500].mean() < 0.95
        np.testing.assert_array_equal(
            to.xyz.numpy()[~tm], np.full(((~tm).sum(), 3), 1e8, np.float32)
        )


def _sym(rng, n):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return a @ np.swapaxes(a, 1, 2)


class TestEigh3:
    """Element-wise float32 formulas in the same order: eigenvalues to 1e-4
    relative of the largest."""

    def test_eigenvalues_match_reference_and_numpy(self, rng):
        a = _sym(rng, 200)
        tl = t_eigvals(t(a)).numpy()
        jl = np.asarray(j_eigvals(jnp.asarray(a)))
        scale = np.abs(jl).max(axis=1, keepdims=True)
        np.testing.assert_allclose(tl / scale, jl / scale, atol=1e-5)
        np.testing.assert_allclose(
            tl / scale, np.linalg.eigvalsh(a.astype(np.float64)) / scale, atol=1e-4
        )

    def test_smallest_eigenpair_and_degenerate_flag(self, rng):
        a = _sym(rng, 100)
        a[:5] = np.eye(3, dtype=np.float32) * 2.0  # isotropic: direction arbitrary
        tl, tv, tok = t_eigpair(t(a))
        jl, jv, jok = j_eigpair(jnp.asarray(a))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert not tok[:5].any()
        np.testing.assert_array_equal(tv.numpy()[:5], np.tile([0, 0, 1.0], (5, 1)))
        # eigenvectors up to sign
        dots = np.abs((tv.numpy() * np.asarray(jv)).sum(-1))[5:]
        np.testing.assert_allclose(dots, 1.0, atol=1e-3)


class TestNormals:
    def test_normals_curvature_validity_match_reference(self):
        (a_xyz, a_rgb), _, cap, _ = small_scene()
        jc, tc = both_clouds(a_xyz, a_rgb, capacity=cap)
        jc = j_voxel(jc, 0.1, out_capacity=4096)
        tc = t_voxel(tc, 0.1, out_capacity=4096)
        jn = j_normals(jc, 0.6, tile=512)
        tn = t_normals(tc, 0.6, tile=512)
        jv, tv = np.asarray(jn.valid), tn.valid.numpy()
        assert (jv != tv).mean() <= 0.002 and tv.sum() > 1000
        both = jv & tv
        # unit normals to 2e-3 (float32 PCA on neighbourhood moments from
        # differently rounded matmuls), up to sign where the viewpoint flip
        # is ill-conditioned: points whose plane passes through the
        # viewpoint (the z = 0 floor seen from the origin)
        tnrm, jnrm = tn.normals.numpy()[both], np.asarray(jn.normals)[both]
        np.testing.assert_allclose(np.abs((tnrm * jnrm).sum(-1)), 1.0, atol=2e-3)
        facing = np.abs((jnrm * -np.asarray(jc.xyz)[both]).sum(-1)) > 1e-3
        assert facing.mean() > 0.5
        np.testing.assert_allclose(tnrm[facing], jnrm[facing], atol=2e-3)
        np.testing.assert_allclose(
            tn.curvature.numpy()[both], np.asarray(jn.curvature)[both], atol=1e-3
        )
        assert torch.equal(tn.normals[~tn.valid], torch.tensor([0, 0, 1.0]).expand(
            int((~tn.valid).sum()), 3))
