"""Descriptor parity beyond FPFH: PFH-125, PFHRGB-250, RSD, SHOT1344 (its
local reference frames and CIELab conversion too) and SC3D-1980, each
against mapmerge_tpu on the same cloud, normals and keypoints; and the
registry with `descriptor_kind_from_dim`.

Keypoints are cloud points chosen so that no valid point lies within 1e-4
m^2 of the radius and the neighbour caps (48, and SC3D's 128) do not cut
between two distances closer than 1e-5 m^2: the reference's matmul-identity
distances and the port's direct expansion then gather the same
neighbourhoods, and each test isolates its descriptor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core.enums import DESCRIPTOR_DIMS, Descriptor
from mapmerge_tpu.ops.descriptors import compute_descriptors as j_desc
from mapmerge_tpu.ops.descriptors import descriptor_kind_from_dim as j_kind
from mapmerge_tpu.ops.descriptors import shot as jshot
from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
from mapmerge_tpu.ops.keypoints.harris import Keypoints as JKeypoints
from mapmerge_tpu.ops.normals import compute_surface_normals as j_normals
from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
from mapmerge_torch import convert
from mapmerge_torch.ops import descriptors as tdesc
from mapmerge_torch.ops.descriptors import pfh as tpfh
from mapmerge_torch.ops.descriptors import rsd as trsd
from mapmerge_torch.ops.descriptors import sc3d as tsc3d
from mapmerge_torch.ops.descriptors import shot as tshot
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import radius_neighbors
from mapmerge_torch.ops.normals import SurfaceNormals

from torch_parity import SLICE_PARAMS, both_clouds, small_scene, t

RADIUS = SLICE_PARAMS.descriptor_radius
N_KP, SLOTS = 64, 80


def _clean(xyz, ok, radius, caps=(48, 128)):
    """Valid points whose radius neighbourhood has no point within 1e-4 m^2
    of the radius and no near-tie (1e-5 m^2) at a neighbour cap."""
    cand = np.flatnonzero(ok)
    d2 = ((xyz[cand, None, :].astype(np.float64) - xyz[None, ok]) ** 2).sum(-1)
    clean = ~(np.abs(d2 - radius * radius) < 1e-4).any(axis=1)
    d2.sort(axis=1)
    for m in caps:
        clean &= ~((d2[:, m] <= radius * radius) & (d2[:, m] - d2[:, m - 1] < 1e-5))
    return cand[clean]


@pytest.fixture(scope="module")
def surface():
    """The slice scene's view A after the reference's downsample, outlier
    removal and normals, and 64 keypoints (+16 empty slots), in both
    packages: (jax cloud, normals, keypoints), (torch ...)."""
    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, _ = both_clouds(a_xyz, a_rgb, capacity=cap)
    p = SLICE_PARAMS
    jc = j_voxel(jc, p.resolution, out_capacity=min(cap, p.max_points))
    jc = j_outliers(jc, p.descriptor_radius, p.outliers_min_neighbours, tile=512)
    jn = j_normals(jc, p.normal_radius, tile=512)
    xyz = np.asarray(jc.xyz)
    pick = np.random.default_rng(5).choice(
        _clean(xyz, np.asarray(jc.mask & jn.valid), RADIUS), N_KP, replace=False
    )
    kp_xyz = np.full((SLOTS, 3), 1e8, np.float32)
    kp_xyz[:N_KP] = xyz[pick]
    kp_mask = np.arange(SLOTS) < N_KP
    jk = JKeypoints(xyz=jnp.asarray(kp_xyz), response=jnp.zeros(SLOTS),
                    mask=jnp.asarray(kp_mask))
    tk = Keypoints(xyz=t(kp_xyz), response=torch.zeros(SLOTS), mask=t(kp_mask),
                   truncated=torch.zeros((), dtype=torch.int32))
    tn = SurfaceNormals(
        normals=t(jn.normals), curvature=t(jn.curvature), valid=t(jn.valid)
    )
    return (jc, jn, jk), (convert.cloud_from_numpy(jc), tn, tk)


def _both(surface, kind):
    (jc, jn, jk), (tc, tn, tk) = surface
    jd = j_desc(jc, jn, jk, kind, RADIUS, max_neighbors=48, tile=512)
    td = tdesc.compute_descriptors(tc, tn, tk, kind, RADIUS, max_neighbors=48, tile=512)
    assert td.data.shape == (SLOTS, DESCRIPTOR_DIMS[kind])
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert td.valid[:N_KP].all() and not td.valid[N_KP:].any()
    assert not td.data[N_KP:].any()
    return td.data.numpy()[:N_KP], np.asarray(jd.data)[:N_KP]


@pytest.mark.parametrize("kind,tol", [("PFH", 1e-3), ("PFHRGB", 1e-3), ("RSD", 1e-4)])
def test_histograms_and_radii_match_reference(surface, kind, tol):
    """PFH/PFHRGB bins (each 125-block sums to 100) to 1e-3 and RSD radii to
    1e-4 m, except on at most 1% of rows, where a pair's feature (an atan2
    or arccos rounded otherwise) can cross a bin edge."""
    got, ref = _both(surface, kind)
    bad = np.abs(got - ref).max(axis=1) > tol
    assert bad.mean() <= 0.01, f"{bad.sum()} rows differ"
    if kind == "RSD":
        assert ((got >= 0) & (got <= 0.2 + 1e-6)).all()
        assert (got[:, 0] <= got[:, 1]).all()
    else:
        sums = got.reshape(N_KP, -1, 125).sum(-1)
        np.testing.assert_allclose(sums, 100.0, atol=1e-3)


@pytest.mark.parametrize("kind", ["SHOT", "SC3D"])
def test_soft_and_log_polar_histograms_match_reference(surface, kind):
    """SHOT's quadrilinear votes and SC3D's density-weighted log-polar bins
    to 1e-4 (L2-normalised rows); cbrt is a float32 power in the port."""
    got, ref = _both(surface, kind)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_local_reference_frames_match_reference(surface):
    """The same gathered neighbourhoods into both: axes to 1e-4, the same
    ok flags, and right-handed orthonormal frames."""
    _, (tc, tn, tk) = surface
    idx, _, nmask, _ = radius_neighbors(
        tk.xyz, tc.xyz, RADIUS, 48, p_mask=tc.mask & tn.valid, tile=512
    )
    nmask = nmask & tk.mask[:, None]
    nbr = tc.xyz[idx.long()]
    got = tshot._local_reference_frames(tk.xyz, nbr, nmask, RADIUS)
    ref = jshot._local_reference_frames(
        jnp.asarray(tk.xyz.numpy()), jnp.asarray(nbr.numpy()),
        jnp.asarray(nmask.numpy()), RADIUS,
    )
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    ok = got[3].numpy()
    assert ok[:N_KP].all() and not ok[N_KP:].any()
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(r)[ok], atol=1e-4)
    frame = torch.stack(got[:3], dim=-1)[torch.from_numpy(ok)]
    np.testing.assert_allclose(torch.linalg.det(frame).numpy(), 1.0, atol=1e-5)


def test_rgb_to_lab_matches_reference(rng):
    """To 1e-4 on L, a, b (ranges ~100), across both branches of the sRGB
    and the cube-root piecewise functions."""
    rgb = rng.random((2000, 3)).astype(np.float32)
    rgb[:200] *= 0.05  # the linear branches near black
    rgb[200] = 0.0
    rgb[201] = 1.0
    got = tshot._rgb_to_lab(t(rgb)).numpy()
    ref = np.asarray(jshot._rgb_to_lab(jnp.asarray(rgb)))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_registry_and_kind_from_dim(surface):
    """Every kind dispatches to its module's function; the width recovers
    the kind as in the reference."""
    _, (tc, tn, tk) = surface
    direct = {
        Descriptor.PFH: tpfh.compute_pfh, Descriptor.PFHRGB: tpfh.compute_pfhrgb,
        Descriptor.RSD: trsd.compute_rsd, Descriptor.SC3D: tsc3d.compute_sc3d,
    }
    for kind, fn in direct.items():
        a = tdesc.compute_descriptors(tc, tn, tk, kind, RADIUS, max_neighbors=16)
        b = fn(tc, tn, tk, RADIUS, max_neighbors=16)
        assert torch.equal(a.valid, b.valid) and torch.equal(a.data, b.data)
    assert set(tdesc._REGISTRY) == set(Descriptor)
    for kind, dim in DESCRIPTOR_DIMS.items():
        assert tdesc.descriptor_kind_from_dim(dim) == j_kind(dim) == kind
    with pytest.raises(ValueError, match="dimensionality 7"):
        tdesc.descriptor_kind_from_dim(7)
    with pytest.raises(ValueError, match="descriptor type"):
        tdesc.compute_descriptors(tc, tn, tk, "RIFT", RADIUS)
