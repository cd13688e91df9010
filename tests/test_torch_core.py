"""mapmerge_torch core parity: clouds, transforms, the numpy scene generator,
the constants shared with the reference, the not-ported configurations, and
the rule that the port never imports jax."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core import transforms as jtf
from mapmerge_tpu.core.cloud import pad_cloud as j_pad, stack_clouds as j_stack
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import FAR, pad_cloud as t_pad, stack_clouds as t_stack
from mapmerge_torch.testing import scene as tscene

from synthetic import make_scene, overlapping_views, rotation_z, se3
from torch_parity import both_clouds, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _random_rigid(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3)
    return r.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


class TestCloud:
    def test_from_numpy_matches_reference(self, rng):
        xyz = rng.normal(size=(50, 3)).astype(np.float32)
        rgb = rng.random((50, 3)).astype(np.float32)
        jc, tc = both_clouds(xyz, rgb, capacity=64)
        for name in ("xyz", "rgb", "mask"):
            np.testing.assert_array_equal(
                getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
            )
        assert tc.capacity == jc.capacity == 64
        assert int(tc.count) == 50
        for a, b in zip(tc.to_numpy(), jc.to_arrays()):
            np.testing.assert_array_equal(a, b)

    def test_park_pad_stack_match_reference(self, rng):
        xyz = rng.normal(size=(30, 3)).astype(np.float32)
        jc, tc = both_clouds(xyz, rng.random((30, 3)), capacity=30)
        mask = rng.random(30) > 0.3
        jc = type(jc)(xyz=jc.xyz, rgb=jc.rgb, mask=jnp.asarray(mask))
        tc = type(tc)(xyz=tc.xyz, rgb=tc.rgb, mask=torch.from_numpy(mask))
        jp, tp = jc.park_invalid(), tc.park_invalid()
        np.testing.assert_array_equal(tp.xyz.numpy(), np.asarray(jp.xyz))
        np.testing.assert_array_equal(tp.rgb.numpy(), np.asarray(jp.rgb))
        assert float(tp.xyz[~torch.from_numpy(mask)].min()) == FAR
        jq, tq = j_pad(jp, 40), t_pad(tp, 40)
        np.testing.assert_array_equal(tq.xyz.numpy(), np.asarray(jq.xyz))
        np.testing.assert_array_equal(tq.mask.numpy(), np.asarray(jq.mask))
        with pytest.raises(ValueError):
            t_pad(tp, 10)
        js, ts = j_stack([jp, jq]), t_stack([tp, tq])
        assert ts.xyz.shape == (2, 40, 3)
        np.testing.assert_array_equal(ts.xyz.numpy(), np.asarray(js.xyz))
        np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))


class TestTransforms:
    def test_compose_apply_match_reference(self, rng):
        r, tr = _random_rigid(rng, 4)
        pts = rng.normal(size=(4, 20, 3)).astype(np.float32)
        jt = jtf.from_rotation_translation(jnp.asarray(r), jnp.asarray(tr))
        tt = ttf.from_rotation_translation(t(r), t(tr))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(
            ttf.apply(tt, t(pts)).numpy(), np.asarray(jtf.apply(jt, jnp.asarray(pts))),
            rtol=1e-6, atol=1e-6,
        )
        np.testing.assert_allclose(
            ttf.compose(tt[0], tt[1]).numpy(), np.asarray(jtf.compose(jt[0], jt[1])),
            rtol=1e-6, atol=1e-6,
        )
        # the identity and zero conventions
        np.testing.assert_array_equal(
            ttf.identity("cpu").numpy(), np.asarray(jtf.identity())
        )
        np.testing.assert_array_equal(ttf.zero("cpu").numpy(), np.asarray(jtf.zero()))

    def test_geodesic_and_translation_error_match_reference(self, rng):
        r, tr = _random_rigid(rng, 6)
        a = ttf.from_rotation_translation(t(r[:3]), t(tr[:3]))
        b = ttf.from_rotation_translation(t(r[3:]), t(tr[3:]))
        ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
        # float32 arccos near 1: 1e-3 deg absolute
        np.testing.assert_allclose(
            ttf.rotation_geodesic_deg(a, b).numpy(),
            np.asarray(jtf.rotation_geodesic_deg(ja, jb)), atol=1e-3,
        )
        np.testing.assert_allclose(
            ttf.translation_error(a, b).numpy(),
            np.asarray(jtf.translation_error(ja, jb)), rtol=1e-6,
        )
        rot, trans = ttf.pose_error(a[0].numpy(), a[0].numpy())
        assert rot < 1e-2 and trans == 0.0

    @pytest.mark.parametrize("case", ["zero", "identity", "tiny", "batched"])
    def test_is_zero_matches_reference(self, rng, case):
        """Exactly the reference's flags, at the default tolerance and at
        tolerances just below and just above the largest entry."""
        x = {
            "zero": np.zeros((4, 4)),
            "identity": np.eye(4),
            "tiny": np.where(rng.random((4, 4)) < 0.3, 3e-7, 0.0),
            "batched": rng.normal(size=(5, 4, 4)) * (rng.random((5, 1, 1)) < 0.5),
        }[case].astype(np.float32)
        largest = float(np.abs(x).max())
        tols = {0.0, largest, float(np.nextafter(np.float32(largest), np.float32(0))),
                float(np.nextafter(np.float32(largest), np.float32(1)))}
        for tol in sorted(tols):
            got = ttf.is_zero(t(x), tol)
            assert got.dtype == torch.bool and got.shape == x.shape[:-2]
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jtf.is_zero(jnp.asarray(x), tol))
            )

    def test_rigid_inverse_matches_reference(self, rng):
        """The rotation block exactly (a transpose), the translation within
        1e-6 m of the reference's for |p| <= 10 m, batched (2, 8); and
        compose(t, rigid_inverse(t)) within 1e-6 of the identity, as
        tests/test_core.py holds the reference's."""
        r, p = _random_rigid(rng, 16)
        p = p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0, 10, (16, 1))
        x = ttf.from_rotation_translation(t(r), t(p.astype(np.float32))).reshape(2, 8, 4, 4)
        got = ttf.rigid_inverse(x)
        ref = np.asarray(jtf.rigid_inverse(jnp.asarray(x.numpy())))
        assert got.shape == (2, 8, 4, 4) and got.dtype == torch.float32
        np.testing.assert_array_equal(got[..., :3, :3].numpy(), ref[..., :3, :3])
        np.testing.assert_array_equal(got[..., 3, :].numpy(), ref[..., 3, :])
        np.testing.assert_allclose(got[..., :3, 3].numpy(), ref[..., :3, 3],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            ttf.compose(x, got).numpy(), np.broadcast_to(np.eye(4), (2, 8, 4, 4)),
            rtol=0, atol=1e-6,
        )


class TestDeviceSync:
    def test_returns_its_tree_as_the_reference_does(self, rng, monkeypatch):
        """Both packages return the tree they were given; with CPU tensors
        only, the port synchronises no card."""
        import dataclasses

        from mapmerge_tpu.utils.profiling import device_sync as j_sync
        from mapmerge_torch.utils import profiling as tprof

        @dataclasses.dataclass
        class Pair:
            a: object
            b: object

        x = rng.normal(size=(3, 4)).astype(np.float32)
        mask = rng.random(5) > 0.5
        synced = []
        monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
        jtree = {"x": jnp.asarray(x), "rest": [jnp.asarray(mask), (1.5, "s")]}
        ttree = {"x": t(x), "rest": [t(mask), (1.5, "s")], "pair": Pair(t(x), [t(mask)])}
        assert j_sync(jtree) is jtree
        assert tprof.device_sync(ttree) is ttree
        assert synced == []
        assert [a.data_ptr() for a in tprof._tensors(ttree)] == [
            a.data_ptr() for a in (ttree["x"], ttree["rest"][0], ttree["pair"].a,
                                   ttree["pair"].b[0])
        ]
        assert list(tprof._tensors(Pair)) == [] and tprof.device_sync(None) is None


class TestScene:
    """mapmerge_torch/testing/scene.py makes the same RNG calls as
    tests/synthetic.py: its arrays must be bit-identical."""

    @pytest.mark.parametrize(
        "boxes,extent,density,angle,shift",
        [
            (6, 8.0, 60.0, 0.4, [1.5, -0.7, 0.2]),  # the slice test's scene
            (20, 16.0, 220.0, 0.35, [1.2, -0.5, 0.15]),  # bench.py config #1
        ],
    )
    def test_bit_identical_to_synthetic(self, boxes, extent, density, angle, shift):
        ref = make_scene(np.random.default_rng(7), n_boxes=boxes, extent=extent,
                         density=density)
        got = tscene.make_scene(np.random.default_rng(7), n_boxes=boxes,
                                extent=extent, density=density)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        truth = se3(rotation_z(angle), shift)
        np.testing.assert_array_equal(tscene.se3(tscene.rotation_z(angle), shift), truth)
        ja, jb = overlapping_views(np.random.default_rng(3), *ref, truth, overlap=0.6)
        ta, tb, cap = tscene.overlapping_views(
            np.random.default_rng(3), *got, truth, overlap=0.6
        )
        assert cap == ja.capacity == jb.capacity
        for (txyz, trgb), jc in ((ta, ja), (tb, jb)):
            jxyz, jrgb = jc.to_arrays()
            np.testing.assert_array_equal(txyz, jxyz)
            np.testing.assert_array_equal(trgb, jrgb)

    def test_config1_scene_matches_bench(self):
        (a_xyz, _), (b_xyz, _), cap, truth = tscene.config1_scene()
        assert (a_xyz.shape[0], b_xyz.shape[0]) == (55425, 62499)  # golden
        assert cap == 62499
        np.testing.assert_array_equal(
            truth, se3(rotation_z(0.35), [1.2, -0.5, 0.15])
        )


def _imports(path: pathlib.Path) -> set[str]:
    """Every module a file imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


class TestNoJax:
    def test_port_imports_no_jax(self):
        """AST scan: no module of mapmerge_torch, nor chip_smoke.py, imports
        jax or anything of mapmerge_tpu, at any depth of its code. The port
        keeps its own copies (core.params, core.enums, graph.*)."""
        files = sorted((ROOT / "mapmerge_torch").rglob("*.py"))
        files.append(ROOT / "chip_smoke.py")
        assert len(files) > 20
        for path in files:
            for name in _imports(path):
                assert name.split(".")[0] not in ("jax", "jaxlib", "mapmerge_tpu"), (
                    f"{path.relative_to(ROOT)}: imports {name}"
                )

    def test_constants_match_reference(self):
        from mapmerge_tpu.ops import neighbors as jn
        from mapmerge_tpu.pipeline import registration as jr
        from mapmerge_torch.ops import neighbors as tn
        from mapmerge_torch.pipeline import registration as tr

        assert (tn.BIG, tn.GRID_AUTO_THRESHOLD, tn.GRID_NN_THRESHOLD) == (
            jn.BIG, jn.GRID_AUTO_THRESHOLD, jn.GRID_NN_THRESHOLD,
        )
        assert (
            tr.AMBIGUITY_MIN_COVERAGE, tr.AMBIGUITY_MIN_PURITY,
            tr.AMBIGUITY_MIN_SUPPORT,
        ) == (
            jr.AMBIGUITY_MIN_COVERAGE, jr.AMBIGUITY_MIN_PURITY,
            jr.AMBIGUITY_MIN_SUPPORT,
        )


class TestOutsideTheSlice:
    """Configurations the port does not cover raise NotImplementedError,
    naming what is missing, instead of taking another path; the engines and
    the keypoint x descriptor x method surface dispatch on both engines."""

    def test_grid_engine(self, monkeypatch):
        """The grid engine answers the neighbour ops and SIFT, chosen by
        "grid", by "auto" at the threshold, or by the MAPMERGE_ENGINE
        override."""
        from mapmerge_torch.core.params import MergeParams
        from mapmerge_torch.ops import neighbors as tn
        from mapmerge_torch.pipeline.features import extract_features

        q = torch.zeros((4, 3))
        counts, overflow = tn.radius_count(q, q, 1.0, engine="grid")
        assert counts.tolist() == [4] * 4 and int(overflow) == 0
        assert tn._resolve_engine("auto", tn.GRID_AUTO_THRESHOLD) == "grid"
        assert tn._resolve_engine(
            "auto", tn.GRID_NN_THRESHOLD, tn.GRID_NN_THRESHOLD
        ) == "grid"
        assert tn._resolve_engine(
            "auto", tn.GRID_NN_THRESHOLD - 1, tn.GRID_NN_THRESHOLD
        ) == "dense"
        assert tn._resolve_engine("dense", tn.GRID_AUTO_THRESHOLD) == "dense"
        monkeypatch.setenv("MAPMERGE_ENGINE", "grid")
        assert tn._resolve_engine("dense", 10) == "grid"
        # the default MergeParams() (SIFT + PFH) runs on the forced grid
        rng = np.random.default_rng(2)
        xyz = (rng.random((400, 3)) * 2).astype(np.float32)
        xyz[:200, 2] = 0.0
        _, tc = both_clouds(xyz, rng.random((400, 3)))
        feats = extract_features(tc, MergeParams(
            neighbor_engine="dense", keypoint_threshold=0.0, max_keypoints=16,
        ))
        assert feats.keypoints.xyz.shape == (16, 3)
        assert feats.descriptors.data.shape == (16, 125)
        assert int(feats.scan_overflow) == 0

    def test_mesh_is_ported(self):
        """The mesh is ported: both entry points take one and no longer
        raise (tests/test_torch_parallel.py holds the sharded path)."""
        from mapmerge_torch.parallel.mesh import make_mesh
        from mapmerge_torch.pipeline.merging import estimate_maps_transforms
        from mapmerge_torch.runtime.node import MapMergeNode
        from mapmerge_torch.runtime.transport import InProcTransport

        mesh = make_mesh(["cpu"])
        assert estimate_maps_transforms([], mesh=mesh) == []
        node = MapMergeNode(InProcTransport(), mesh=mesh, device="cpu")
        assert node.mesh is mesh
        node.transforms_estimation()  # no robot yet: an empty tick
        assert node.get_transforms() == {}

    def test_keypoint_descriptor_and_method(self):
        """HARRIS, SIFT, PFH and SAC_IA dispatch on both engines."""
        from mapmerge_torch.core.enums import Descriptor, Keypoint
        from mapmerge_torch.ops.descriptors import compute_descriptors
        from mapmerge_torch.ops.keypoints import detect_keypoints
        from mapmerge_torch.ops.normals import compute_surface_normals
        from mapmerge_torch.pipeline.features import extract_features
        from mapmerge_torch.pipeline.registration import estimate_transform
        from torch_parity import SLICE_PARAMS, port_params

        rng = np.random.default_rng(1)
        xyz = (rng.random((300, 3)) * 2).astype(np.float32)
        xyz[:100, 2] = 0.0  # a floor and two walls meet in corners
        xyz[100:200, 0] = 0.0
        xyz[200:, 1] = 0.0
        _, tc = both_clouds(xyz, rng.random((300, 3)))
        nrm = compute_surface_normals(tc, 0.6)

        def harris(engine):
            return detect_keypoints(
                tc, nrm, Keypoint.HARRIS, 0.0, 0.6, 0.1, 8, engine=engine
            )

        def pfh(engine):
            return compute_descriptors(
                tc, nrm, kp, Descriptor.PFH, 0.8, engine=engine
            )

        kp = harris("dense")
        assert kp.mask.any()
        desc = pfh("dense")
        assert desc.data.shape == (8, 125) and desc.valid.any()
        params = port_params(SLICE_PARAMS).replace(
            keypoint_type="HARRIS", keypoint_threshold=0.0,
            descriptor_type="PFH", estimation_method="SAC_IA",
            sacia_hypotheses=64, max_keypoints=16, refine_transform=False,
        )
        feats = extract_features(tc, params.replace(neighbor_engine="dense"))
        est = estimate_transform(
            feats, feats, params, generator=torch.Generator().manual_seed(0)
        )
        assert est.transform.shape == (4, 4) and float(est.support) == 1.0
        assert torch.equal(harris("grid").mask, kp.mask)
        assert torch.equal(pfh("grid").valid, desc.valid)
        grid_feats = extract_features(tc, params.replace(neighbor_engine="grid"))
        assert int(grid_feats.scan_overflow) == 0
        # SIFT on the cell-grid engine
        grid_feats = extract_features(tc, params.replace(
            neighbor_engine="grid", keypoint_type="SIFT"
        ))
        assert grid_feats.keypoints.xyz.shape == (params.max_keypoints, 3)
        assert grid_feats.keypoints.mask.shape == (params.max_keypoints,)
        assert int(grid_feats.scan_overflow) == 0
