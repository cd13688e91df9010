"""Dense neighbor engine parity (mapmerge_torch/ops/neighbors.py against
mapmerge_tpu/ops/neighbors.py), and the plain 1-NN version of kernel A
(kernels/nn.py: nearest_neighbor_ref) against the Pallas kernel in interpret
mode and a numpy oracle, mirroring tests/test_pallas.py:TestPallasNN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.ops import neighbors as jn
from mapmerge_tpu.pallas.nn import nearest_neighbor_pallas
from mapmerge_torch.kernels import nn as knn
from mapmerge_torch.ops import neighbors as tn

from torch_parity import t


def _oracle(q, p, mask=None):
    d = ((q[:, None, :].astype(np.float64) - p[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d[:, ~mask] = np.inf
    return d.argmin(1).astype(np.int32), d.min(1)


def _cloud(rng, n, scale=4.0, keep=0.8):
    xyz = (rng.random((n, 3)) * scale).astype(np.float32)
    mask = rng.random(n) < keep
    return xyz, mask


def _boundary_free(q, p, mask, r, tol=1e-3):
    """Queries with no valid target within `tol` of the radius (in d^2):
    elsewhere the float32 rounding of either package may put a pair on
    either side of the boundary."""
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    near = (np.abs(d2 - r * r) < tol) & mask[None, :]
    return ~near.any(axis=1)


class TestDenseEngine:
    """Float tolerances: both packages compute |q|^2 + |p|^2 - 2 q.p on
    centred float32 coordinates; their matmuls round differently, so d2
    agrees to ~1e-5 absolute at these extents."""

    def test_sq_dists_and_center(self, rng):
        q, _ = _cloud(rng, 70)
        p, mask = _cloud(rng, 90)
        jq, jp = jn._center(jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask))
        tq, tp = tn._center(t(q), t(p), t(mask))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(
            tn.sq_dists(tq, tp).numpy(), np.asarray(jn.sq_dists(jq, jp)),
            atol=2e-5,
        )

    def test_radius_count(self, rng):
        q, _ = _cloud(rng, 300)
        p, mask = _cloud(rng, 700)
        r = 0.6
        jc, _ = jn.radius_count(jnp.asarray(q), jnp.asarray(p), r,
                                p_mask=jnp.asarray(mask), tile=128)
        tc, over = tn.radius_count(t(q), t(p), r, p_mask=t(mask), tile=128)
        assert over == 0 and tc.dtype == torch.int32
        ok = _boundary_free(q, p, mask, r)
        assert ok.mean() > 0.9
        np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
        tc2, _ = tn.radius_count(t(q), t(p), r, p_mask=t(mask), tile=128,
                                 include_self=False)
        np.testing.assert_array_equal(tc2.numpy(), tc.numpy() - 1)

    def test_radius_neighbors_sets_and_distances(self, rng):
        p, mask = _cloud(rng, 600)
        q = p[:200]  # self hits at zero distance
        r, k = 0.7, 12
        ji, jd, jv, _ = jn.radius_neighbors(
            jnp.asarray(q), jnp.asarray(p), r, k, p_mask=jnp.asarray(mask),
            tile=64,
        )
        ti, td, tv, over = tn.radius_neighbors(
            t(q), t(p), r, k, p_mask=t(mask), tile=64
        )
        assert over == 0 and ti.shape == (200, k) and ti.dtype == torch.int32
        # nearest first, equal distances in either order: compare sorted
        # distances and the neighbour sets per query
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5)
        ok = _boundary_free(q, p, mask, r)
        jv, tv = np.asarray(jv), tv.numpy()
        np.testing.assert_array_equal(tv[ok], jv[ok])
        ji, ti = np.asarray(ji), ti.numpy()
        for i in np.flatnonzero(ok):
            assert set(ti[i][tv[i]]) == set(ji[i][jv[i]])

    def test_radius_neighbors_pads_past_capacity(self, rng):
        p, mask = _cloud(rng, 5, keep=1.0)
        ti, td, tv, _ = tn.radius_neighbors(t(p), t(p), 10.0, 8, p_mask=t(mask))
        ji, jd, jv, _ = jn.radius_neighbors(
            jnp.asarray(p), jnp.asarray(p), 10.0, 8, p_mask=jnp.asarray(mask)
        )
        assert ti.shape == (5, 8)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5)

    def test_neighbor_moments(self, rng):
        p, mask = _cloud(rng, 500)
        q = p[:150]
        r = 0.8
        jc, jm, jcov, _ = jn.neighbor_moments(
            jnp.asarray(q), jnp.asarray(p), r, p_mask=jnp.asarray(mask), tile=64
        )
        tc, tm, tcov, _ = tn.neighbor_moments(
            t(q), t(p), r, p_mask=t(mask), tile=64
        )
        ok = _boundary_free(q, p, mask, r)
        np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
        np.testing.assert_allclose(tm.numpy()[ok], np.asarray(jm)[ok], atol=1e-5)
        np.testing.assert_allclose(
            tcov.numpy()[ok], np.asarray(jcov)[ok], atol=1e-4
        )

    @pytest.mark.parametrize("reduce", ["sum", "max"])
    def test_radius_reduce(self, rng, reduce):
        """Counts and maxes exactly and sums to rtol 1e-5 (positive values:
        the two matmuls add in other orders), on queries clear of the
        radius; a query with no neighbour gets -BIG under "max"."""
        p, mask = _cloud(rng, 600)
        q = np.concatenate([p[:150], [[50.0, 50.0, 50.0]]]).astype(np.float32)
        values = rng.random((600, 5)).astype(np.float32)
        r = 0.7
        jc, jo, _ = jn.radius_reduce(
            jnp.asarray(q), jnp.asarray(p), r, jnp.asarray(values),
            p_mask=jnp.asarray(mask), tile=64, reduce=reduce,
        )
        tc, to, over = tn.radius_reduce(
            t(q), t(p), r, t(values), p_mask=t(mask), tile=64, reduce=reduce
        )
        assert over == 0 and tc.dtype == torch.int32 and to.shape == (151, 5)
        ok = _boundary_free(q, p, mask, r)
        assert ok.mean() > 0.9 and ok[-1]
        np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
        if reduce == "sum":
            np.testing.assert_allclose(
                to.numpy()[ok], np.asarray(jo)[ok], rtol=1e-5, atol=1e-6
            )
            assert not to[-1].any()
        else:
            np.testing.assert_array_equal(to.numpy()[ok], np.asarray(jo)[ok])
            assert (to[-1] == -tn.BIG).all()
        with pytest.raises(ValueError, match="reduce"):
            tn.radius_reduce(t(q), t(p), r, t(values), reduce="mean")
        with pytest.raises(NotImplementedError, match="cell-grid"):
            tn.radius_reduce(t(q), t(p), r, t(values), engine="grid")

    def test_nearest_neighbor_matches_reference_xla_path(self, rng):
        """The port's 1-NN (kernel A's semantics: direct expansion) against
        the reference's CPU path (centred matmul identity): indices equal off
        near-ties, d2 within the matmul's rounding."""
        q = (rng.random((513, 3)) * 5).astype(np.float32)
        p = (rng.random((2050, 3)) * 5).astype(np.float32)
        mask = rng.random(2050) > 0.2
        ji, jd, _ = jn.nearest_neighbor(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask)
        )
        ti, td, over = tn.nearest_neighbor(t(q), t(p), p_mask=t(mask), bound=1.0)
        assert over == 0
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5)
        d_all = ((q[:, None].astype(np.float64) - p[None]) ** 2).sum(-1)
        d_all[:, ~mask] = np.inf
        gap = np.sort(d_all, axis=1)
        clear = gap[:, 1] - gap[:, 0] > 1e-4
        np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])


class TestNearestNeighborRef:
    """kernels/nn.py:nearest_neighbor_ref, the plain version of kernel A,
    against the Pallas kernel in interpret mode and a float64 oracle.
    Indices exactly; d2 to float32 rounding (rtol 1e-5)."""

    @pytest.mark.parametrize("masked", [False, True])
    def test_parity_with_pallas_and_oracle(self, rng, masked):
        q = (rng.random((257, 3)) * 10).astype(np.float32)
        p = (rng.random((3001, 3)) * 10).astype(np.float32)
        mask = rng.random(3001) > 0.4 if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        pi, pd = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), jm, interpret=True
        )
        ti, td = knn.nearest_neighbor_ref(
            t(q), t(p), None if mask is None else t(mask)
        )
        oi, od = _oracle(q, p, mask)
        np.testing.assert_array_equal(ti.numpy(), oi)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
        np.testing.assert_allclose(td.numpy(), od, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(pd), rtol=1e-5, atol=1e-6)

    def test_tie_break_first_occurrence_across_chunks(self, monkeypatch):
        monkeypatch.setattr(knn, "_PLANE", 64)  # 64-target chunks
        q = torch.zeros((1, 3))
        p = torch.zeros((300, 3))  # all targets equidistant
        idx, d2 = knn.nearest_neighbor_ref(q, p)
        assert int(idx[0]) == 0 and float(d2[0]) == 0.0
        mask = torch.ones(300, dtype=torch.bool)
        mask[:130] = False  # first valid target sits in the third chunk
        idx, d2 = knn.nearest_neighbor_ref(q, p, mask)
        assert int(idx[0]) == 130 and float(d2[0]) == 0.0

    def test_chunking_does_not_change_results(self, rng, monkeypatch):
        q = t((rng.random((40, 3)) * 3).astype(np.float32))
        p = t((rng.random((500, 3)) * 3).astype(np.float32))
        mask = t(rng.random(500) > 0.3)
        whole = knn.nearest_neighbor_ref(q, p, mask)
        monkeypatch.setattr(knn, "_PLANE", 40 * 7)  # 7-target chunks
        chunked = knn.nearest_neighbor_ref(q, p, mask)
        assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])

    def test_all_masked_targets(self, rng):
        q = t(rng.random((10, 3)).astype(np.float32))
        p = t(rng.random((100, 3)).astype(np.float32))
        _, d2 = knn.nearest_neighbor_ref(q, p, torch.zeros(100, dtype=torch.bool))
        assert bool((d2 >= 1e11).all())  # everything at the penalty

    def test_wrapper_takes_plain_version_only_on_cpu(self, rng):
        q = t(rng.random((5, 3)).astype(np.float32))
        before = knn.KERNEL.launches
        idx, d2 = knn.nearest_neighbor(q, q)
        assert knn.KERNEL.launches == before  # no kernel launched on the CPU
        assert idx.tolist() == list(range(5)) and float(d2.max()) == 0.0
        with pytest.raises(ValueError, match="unsupported device"):
            knn.nearest_neighbor(q.to("meta"), q.to("meta"))
