"""The port's own copies of the reference's framework-free modules, held
against them: MergeParams and the enums (core/params.py, core/enums.py),
the merge-graph solve and the pose-graph refiner (graph/), and the default
device of the port's entry points."""

import dataclasses

import numpy as np
import pytest
import torch

from mapmerge_tpu.core import enums as jenums
from mapmerge_tpu.core.params import MergeParams as JParams
from mapmerge_tpu.graph import merge_graph as jmg
from mapmerge_tpu.graph import pose_graph as jpg
from mapmerge_torch import convert
from mapmerge_torch.core import enums as tenums
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.device import default_device
from mapmerge_torch.core.params import MergeParams as TParams
from mapmerge_torch.graph import merge_graph as tmg
from mapmerge_torch.graph import pose_graph as tpg
from torch_parity import jax_native  # noqa: F401  (a fixture)

ENUMS = ("Keypoint", "Descriptor", "EstimationMethod")


def _fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


class TestParams:
    def test_fields_and_defaults_match_reference(self):
        assert [f.name for f in dataclasses.fields(TParams)] == [
            f.name for f in dataclasses.fields(JParams)
        ]
        for ours, theirs in (
            (TParams(), JParams()),
            (TParams.strict_parity(), JParams.strict_parity()),
            (TParams.strict_parity(max_points=123, icp_anneal=0.5),
             JParams.strict_parity(max_points=123, icp_anneal=0.5)),
        ):
            assert _fields(ours) == _fields(theirs)
        assert TParams().replace(matching_k=7).matching_k == 7

    @pytest.mark.parametrize(
        "field,raw", [("keypoint_type", "harris"), ("descriptor_type", "Shot"),
                      ("estimation_method", "sac_ia")],
    )
    def test_enum_strings_parse_as_reference(self, field, raw):
        ours, theirs = TParams(**{field: raw}), JParams(**{field: raw})
        value = getattr(ours, field)
        assert value == getattr(theirs, field)
        assert type(value).__module__ == "mapmerge_torch.core.enums"
        with pytest.raises(ValueError) as ours_err:
            TParams(**{field: "nonsense"})
        with pytest.raises(ValueError) as theirs_err:
            JParams(**{field: "nonsense"})
        assert str(ours_err.value) == str(theirs_err.value)

    def test_params_from_reference(self):
        ref = JParams.strict_parity(
            keypoint_type="HARRIS", descriptor_type="FPFH",
            estimation_method="SAC_IA", max_keypoints=77,
        )
        ours = convert.params_from_reference(ref)
        assert isinstance(ours, TParams)
        assert _fields(ours) == _fields(ref)
        for name in ("keypoint_type", "descriptor_type", "estimation_method"):
            assert isinstance(getattr(ours, name), tuple(
                getattr(tenums, e) for e in ENUMS
            ))


def test_enums_match_reference():
    for name in ENUMS:
        ours, theirs = getattr(tenums, name), getattr(jenums, name)
        assert [(m.name, m.value) for m in ours] == [
            (m.name, m.value) for m in theirs
        ]
    assert {k.value: v for k, v in tenums.DESCRIPTOR_DIMS.items()} == {
        k.value: v for k, v in jenums.DESCRIPTOR_DIMS.items()
    }


def _rigid(rng, angle_scale=1.0, shift_scale=3.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-np.pi, np.pi) * angle_scale
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    t = np.eye(4)
    t[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    t[:3, 3] = rng.normal(size=3) * shift_scale
    return t


#: (seed, nodes, components, edge probability, failed share, threshold)
GRAPHS = [
    (0, 4, 1, 1.0, 0.0, 0.0),  # complete, all confident
    (1, 6, 1, 0.7, 0.1, 0.0),  # sparse, a failed pair
    (2, 7, 2, 0.9, 0.0, 0.0),  # two components
    (3, 6, 1, 0.8, 0.0, 0.5),  # edges below the confidence threshold
    (4, 8, 3, 1.0, 0.2, 0.3),  # three components, failures, a threshold
    (5, 5, 1, 1.0, 0.0, 2.0),  # every edge below the threshold
    (6, 8, 1, 0.6, 0.1, 0.2),  # the threshold splits it; the rest relaxes
    (7, 10, 1, 0.5, 0.0, 0.0),  # sparse, ten nodes
    (8, 9, 1, 0.8, 0.1, 0.0),  # dense, failures
]


def _graph(seed, nodes, components, p_edge, p_fail, _threshold):
    """Noisy pair estimates of random true poses, in both packages' types.
    A pair is registered only inside a component; the last node index
    always appears so both solvers size the output alike."""
    rng = np.random.default_rng(seed)
    truth = [_rigid(rng) for _ in range(nodes)]
    comp = rng.integers(0, components, nodes)
    ests = []
    for i in range(nodes - 1):
        for j in range(i + 1, nodes):
            if comp[i] != comp[j] or rng.random() > p_edge:
                continue
            # T: i -> j frame, so that global[i] = global[j] @ T
            t = np.linalg.inv(truth[j]) @ truth[i] @ _rigid(rng, 0.005, 0.02)
            if rng.random() < p_fail:
                t = np.zeros((4, 4))
            ests.append((i, j, t.astype(np.float32), float(rng.uniform(0.1, 1.0)),
                         bool(rng.random() < 0.2)))
    if not any(nodes - 1 in e[:2] for e in ests):
        ests.append((0, nodes - 1, np.zeros((4, 4), np.float32), 0.05, False))
    return (
        [jmg.TransformEstimate(*e) for e in ests],
        [tmg.TransformEstimate(*e) for e in ests],
    )


@pytest.mark.parametrize("graph", GRAPHS, ids=[f"seed{g[0]}" for g in GRAPHS])
def test_compute_global_transforms_matches_reference(graph, jax_native):
    """Both packages' default path is a native solve of the same source:
    equal bits."""
    j_est, t_est = _graph(*graph)
    threshold = graph[-1]
    ours = tmg.compute_global_transforms(t_est, threshold)
    theirs = jmg.compute_global_transforms(j_est, threshold)
    assert len(ours) == len(theirs) == graph[1]
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("graph", GRAPHS, ids=[f"seed{g[0]}" for g in GRAPHS])
def test_refine_global_transforms_matches_reference(graph):
    """Both refiners from the reference's tree seed (the copy drops the
    options the port never sets; their defaults are what it keeps)."""
    j_est, t_est = _graph(*graph)
    threshold = graph[-1]
    seed = [np.asarray(t) for t in jmg.compute_global_transforms(j_est, threshold)]
    ours = tpg.refine_global_transforms(t_est, list(seed), threshold)
    theirs = jpg.refine_global_transforms(j_est, list(seed), threshold)
    assert [bool(t.any()) for t in ours] == [bool(t.any()) for t in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_entry_points_default_to_the_card():
    """No device named: the current CUDA device, or, with no card, a
    RuntimeError that names device="cpu"; never a quiet CPU run."""
    xyz = np.zeros((4, 3), np.float32)
    calls = (
        default_device,
        lambda: PointCloud.from_numpy(xyz).xyz.device,
        lambda: ttf.identity().device,
        lambda: ttf.zero().device,
    )
    if torch.cuda.is_available():
        for call in calls:
            assert call().type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert PointCloud.from_numpy(xyz, device="cpu").xyz.device.type == "cpu"
