"""SIFT's cell-grid branch in mapmerge_torch against mapmerge_tpu's
detect_keypoints_sift, on a ~4,000-point view of the synthetic town.

Each octave resolves its engine on its own capacity: the forced grid takes
every octave, and the mixed case (GRID_AUTO_THRESHOLD lowered to the
cloud's capacity in both packages) takes octave 0 on the grid and the
downsampled octaves dense. Tolerances: the keypoint sets are equal (a port
keypoint within 1e-5 m of a JAX one and the reverse, compared as sets, not
by slot: the voxel centroids of later octaves differ in the last ulp, and
top-k orders equal responses freely), `truncated` is equal exactly, and the
matched responses agree within rtol 1e-5 plus atol 2e-4. The absolute part
is float32 rounding at the intensity scale: a response is the difference of
two smoothed intensities of up to 255 (ulp 1.5e-5), each a sum over up to
27 x 128 candidates that the two packages add in other orders (up to 9.2e-5
apart on this view).
"""

import numpy as np
import pytest

from mapmerge_tpu.ops import neighbors as jn
from mapmerge_tpu.ops.keypoints.sift import detect_keypoints_sift as j_sift
from mapmerge_torch.ops import neighbors as tn
from mapmerge_torch.ops.keypoints.sift import detect_keypoints_sift as t_sift
from mapmerge_torch.testing.scene import make_town, n_overlapping_views

from torch_parity import both_clouds

CAP = 4096
SIFT_ARGS = dict(
    min_scale=0.1, octaves=3, scales_per_octave=3, min_contrast=3.0,
    max_keypoints=96, tile=512,
)


@pytest.fixture(scope="module")
def town_view():
    rng = np.random.default_rng(21)
    xyz, rgb = make_town(rng, 3000)
    (view,) = n_overlapping_views(rng, xyz, rgb, [np.eye(4, dtype=np.float32)], 0.8)
    keep = np.random.default_rng(5).permutation(len(view[0]))[:4000]
    return view[0][keep], view[1][keep]


def _kp(kp, to_np):
    m = to_np(kp.mask)
    return to_np(kp.xyz)[m], to_np(kp.response)[m], int(to_np(kp.truncated))


def _assert_same_keypoints(got, ref):
    (t_xyz, t_resp, t_trunc), (j_xyz, j_resp, j_trunc) = got, ref
    assert t_trunc == j_trunc
    assert len(t_xyz) == len(j_xyz) > 5
    d = np.linalg.norm(t_xyz[:, None, :] - j_xyz[None, :, :], axis=-1)
    match = d.argmin(axis=1)
    assert d.min(axis=1).max() < 1e-5
    assert sorted(match.tolist()) == list(range(len(j_xyz)))  # one to one
    np.testing.assert_allclose(t_resp, j_resp[match], rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("case", ["grid", "mixed"])
def test_sift_grid_matches_reference(town_view, case, monkeypatch):
    engine = "grid"
    if case == "mixed":
        # octave 0 (capacity 4096) on the grid, octaves 1-2 (2048) dense
        monkeypatch.setattr(jn, "GRID_AUTO_THRESHOLD", CAP)
        monkeypatch.setattr(tn, "GRID_AUTO_THRESHOLD", CAP)
        engine = "auto"
        assert tn._resolve_engine(engine, CAP) == "grid"
        assert tn._resolve_engine(engine, CAP // 2) == "dense"
    jc, tc = both_clouds(*town_view, capacity=CAP)
    ref = j_sift(jc, engine=engine, scan_cap=128, **SIFT_ARGS)
    got = t_sift(tc, engine=engine, scan_cap=128, **SIFT_ARGS)
    _assert_same_keypoints(_kp(got, lambda a: a.numpy()), _kp(ref, np.asarray))


def test_sift_grid_truncation_and_scan_cap(town_view):
    """Through the keypoint dispatch (which hands SIFT its scan_cap): a
    small keypoint cap truncates alike, and a scan cap below the buckets'
    fill drops the same candidates in both packages."""
    from mapmerge_tpu.core.enums import Keypoint as JKeypoint
    from mapmerge_tpu.ops.keypoints import detect_keypoints as j_detect
    from mapmerge_torch.core.enums import Keypoint as TKeypoint
    from mapmerge_torch.ops.keypoints import detect_keypoints as t_detect

    kw = dict(threshold=3.0, radius=0.6, resolution=0.1, max_keypoints=8,
              tile=512, engine="grid", scan_cap=16)
    jc, tc = both_clouds(*town_view, capacity=CAP)
    ref = j_detect(jc, None, JKeypoint.SIFT, **kw)
    got = t_detect(tc, None, TKeypoint.SIFT, **kw)
    (t_xyz, _, t_trunc), (j_xyz, _, j_trunc) = (
        _kp(got, lambda a: a.numpy()), _kp(ref, np.asarray)
    )
    assert t_trunc == j_trunc > 0
    assert len(t_xyz) == len(j_xyz) == 8
