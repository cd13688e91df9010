"""mapmerge_torch's incremental register-to-world mode against
mapmerge_tpu/pipeline/incremental.py, and the pose-graph options it needs.

Tolerances: refine_global_transforms with its options within 1e-5 of the
reference's poses (the same numpy code; equal in practice); `_vote` counts
exactly equal; the WorldModel's bookkeeping (its descriptor block, edges and
refined poses on bare poses) exactly equal; `localize` on the reference's
own features (extract_features at max_points 4096, carried across by
`convert`) within 1 deg / 0.1 m of the reference's pose and of the truth,
since torch cannot replay JAX's random draws.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JCloud
from mapmerge_tpu.core.params import MergeParams as JParams
from mapmerge_tpu.graph import pose_graph as jpg
from mapmerge_tpu.graph.merge_graph import TransformEstimate as JEst
from mapmerge_tpu.pipeline import incremental as jinc
from mapmerge_torch import convert
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.graph import pose_graph as tpg
from mapmerge_torch.graph.merge_graph import TransformEstimate as TEst
from mapmerge_torch.pipeline import incremental as tinc
from mapmerge_torch.testing.scene import rotation_z, se3, town_views

from torch_parity import port_params

#: the stream's parameters at tier-1 size (tests/test_incremental.py:38-47,
#: max_points 4096)
STREAM = JParams(
    keypoint_type="SIFT", keypoint_threshold=3.0, descriptor_type="FPFH",
    refine_transform=True, max_iterations=30, max_points=4096,
    max_keypoints=128, max_neighbors=32, ransac_hypotheses=512,
    neighbor_tile=256,
)


def _drifted_chain(n=6):
    """Truth poses, noisy chain edges (1.5 deg a hop), their chained seed,
    and an exact closing edge from the last map to the first."""
    truths = [se3(rotation_z(0.15 * i), [1.0 * i, 0.2 * i, 0.0]) for i in range(n)]
    hop = se3(rotation_z(np.radians(1.5)), [0, 0, 0])
    edges, seed = [], [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        rel = (np.linalg.inv(truths[i - 1]) @ truths[i] @ hop).astype(np.float32)
        edges.append((i, i - 1, rel, 10.0))
        seed.append((seed[-1] @ rel).astype(np.float32))
    closing = (np.linalg.inv(truths[0]) @ truths[-1]).astype(np.float32)
    edges.append((n - 1, 0, closing, 10.0))
    return truths, edges, seed


def _estimates(cls, edges):
    return [
        cls(source_idx=s, target_idx=t, transform=m, confidence=c)
        for s, t, m, c in edges
    ]


@pytest.mark.parametrize("options", [
    dict(rot_scale_m=12.0),
    dict(rot_scale_m=3.0, huber_delta=0.05, reject_outliers=False),
    dict(max_iterations=4, tol=1e-6, seed_gate_deg=10.0, seed_gate_m=0.8,
         rot_scale_m=25.0),
])
def test_refine_options_match_reference(options):
    """The options the offline path leaves at their defaults, rot_scale_m
    first: the stream's WorldModel.refine passes it."""
    _, edges, seed = _drifted_chain()
    ours = tpg.refine_global_transforms(_estimates(TEst, edges), list(seed), 0.0, **options)
    theirs = jpg.refine_global_transforms(_estimates(JEst, edges), list(seed), 0.0, **options)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-5)
    default = tpg.refine_global_transforms(_estimates(TEst, edges), list(seed), 0.0)
    assert any(not np.allclose(a, b, atol=1e-5) for a, b in zip(ours, default))


@pytest.mark.parametrize("k", [1, 5])
def test_vote_matches_reference(k):
    """Random descriptors, masked rows on both sides, and a map id past
    m_max (dropped, the reference's mode="drop")."""
    rng = np.random.default_rng(k)
    m_max, kp, d = 4, 24, 33
    new = rng.random((kp, d)).astype(np.float32)
    world = rng.random((m_max * kp, d)).astype(np.float32)
    world[:kp] = new + 0.01 * rng.random((kp, d)).astype(np.float32)  # map 0 overlaps
    world[2 * kp : 2 * kp + 10] = new[:10] + 0.02  # map 2 overlaps partly
    new_valid = rng.random(kp) > 0.2
    world_valid = rng.random(m_max * kp) > 0.3
    world_id = np.repeat(np.arange(m_max, dtype=np.int32), kp)
    world_id[3 * kp :] = m_max + 3  # outside [0, m_max): dropped
    ref = jinc._vote(
        jnp.asarray(new), jnp.asarray(new_valid), jnp.asarray(world),
        jnp.asarray(world_valid), jnp.asarray(world_id), k, m_max,
    )
    got = tinc._vote(
        torch.from_numpy(new), torch.from_numpy(new_valid), torch.from_numpy(world),
        torch.from_numpy(world_valid), torch.from_numpy(world_id), k, m_max,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got[0]) > 0


def _worlds_with(poses, edges):
    """A reference and a port WorldModel holding bare poses (no features)."""
    worlds = []
    for pkg, est_cls in ((jinc, JEst), (tinc, TEst)):
        params = JParams() if pkg is jinc else port_params(JParams())
        w = pkg.WorldModel(params, max_maps=16)
        for i, p in enumerate(poses):
            w.entries.append(pkg._Entry(f"m{i}", None, np.asarray(p, np.float32)))
            w._by_name[f"m{i}"] = i
        w.edges = _estimates(est_cls, edges)
        worlds.append(w)
    return worlds


class TestWorldModelBookkeeping:
    def test_drifted_chain_corrected_by_closing_edge(self):
        truths, edges, seed = _drifted_chain()
        jw, tw = _worlds_with(seed, edges)
        assert tw.refine() is True and jw.refine() is True
        for je, te in zip(jw.entries, tw.entries):
            np.testing.assert_array_equal(te.pose, je.pose)
        end_truth = np.linalg.inv(truths[0]) @ truths[-1]
        before, _ = ttf.pose_error(seed[-1], end_truth)
        after, _ = ttf.pose_error(tw.entries[-1].pose, end_truth)
        assert before > 5.0 and after < 2.0

    def test_refine_needs_redundancy(self):
        _, edges, seed = _drifted_chain(4)
        jw, tw = _worlds_with(seed[:4], edges[:3])  # a bare chain (a tree)
        assert tw.refine() is False and jw.refine() is False
        jw, tw = _worlds_with(seed[:2], edges[:1] * 3)  # fewer than 3 maps
        assert tw.refine() is False and jw.refine() is False

    def test_add_replace_and_edges(self):
        """add() writes each map's descriptors, valid flags and slot into
        the world block; replacing a map drops the edges that touch it;
        add_edges records a Localization's edges by slot."""
        rng = np.random.default_rng(3)
        params = JParams(max_keypoints=8)
        jw = jinc.WorldModel(params, max_maps=4)
        tw = tinc.WorldModel(port_params(params), max_maps=4)

        def feats(seed):
            r = np.random.default_rng(seed)
            data = r.random((8, 33)).astype(np.float32)
            valid, mask = r.random(8) > 0.2, r.random(8) > 0.1
            j = SimpleNamespace(
                descriptors=SimpleNamespace(data=jnp.asarray(data), valid=jnp.asarray(valid)),
                keypoints=SimpleNamespace(mask=jnp.asarray(mask)),
            )
            t = SimpleNamespace(
                descriptors=SimpleNamespace(data=torch.from_numpy(data), valid=torch.from_numpy(valid)),
                keypoints=SimpleNamespace(mask=torch.from_numpy(mask)),
            )
            return j, t

        poses = [se3(rotation_z(0.1 * i), rng.random(3)) for i in range(3)]
        for i, name in enumerate("abc"):
            j, t = feats(i)
            jw.add(name, j, poses[i])
            tw.add(name, t, poses[i])
        edge = [("a", np.eye(4, dtype=np.float32), 2.0, False)]
        jw.add_edges("b", edge)
        tw.add_edges("b", edge)
        jw.add_edges("c", edge + [("b", poses[1], 1.0, True)])
        tw.add_edges("c", edge + [("b", poses[1], 1.0, True)])
        j, t = feats(9)
        jw.add("b", j, poses[0])  # replace: b's edges measured old geometry
        tw.add("b", t, poses[0])
        assert tw.names == jw.names == ["a", "b", "c"]
        np.testing.assert_array_equal(tw._world_desc.numpy(), np.asarray(jw._world_desc))
        np.testing.assert_array_equal(tw._world_valid.numpy(), np.asarray(jw._world_valid))
        np.testing.assert_array_equal(tw._world_map_id.numpy(), np.asarray(jw._world_map_id))
        assert [(e.source_idx, e.target_idx, e.confidence, e.ambiguous) for e in tw.edges] == [
            (e.source_idx, e.target_idx, e.confidence, e.ambiguous) for e in jw.edges
        ] == [(2, 0, 2.0, False)]
        np.testing.assert_array_equal(tw.pose_of("b"), poses[0])
        with pytest.raises(ValueError, match="world model full"):
            full = tinc.WorldModel(port_params(params), max_maps=1)
            full.add("a", feats(0)[1], poses[0])
            full.add("b", feats(1)[1], poses[1])


@pytest.fixture(scope="module")
def stream_views():
    """Three town views, each a random 4,096-point subsample, and their
    truths; the reference's features of the first two."""
    views, truths = town_views(3, 4000, keep=0.8, seed=11)
    out = []
    for i, (x, r) in enumerate(views):
        keep = np.sort(np.random.default_rng(i).permutation(len(x))[: STREAM.max_points])
        out.append((x[keep], r[keep]))
    jf = [
        jinc.features_for(JCloud.from_arrays(*v, capacity=STREAM.max_points), STREAM)
        for v in out[:2]
    ]
    return out, truths, jf


def _port_features(jf):
    return convert.features_from_numpy(jax.tree_util.tree_map(np.asarray, jf), "cpu")


def test_localize_matches_reference(stream_views):
    """Map 1 localized against a world holding map 0, on the reference's
    features: the port's pose within 1 deg / 0.1 m of the reference's and
    of the truth; the same map radius (refine's rot_scale_m)."""
    _, truths, jf = stream_views
    tf_ = [_port_features(f) for f in jf]
    jw = jinc.WorldModel(STREAM, max_maps=8)
    tw = tinc.WorldModel(port_params(STREAM), max_maps=8)
    jw.add("m0", jf[0], np.eye(4, dtype=np.float32))
    tw.add("m0", tf_[0], np.eye(4, dtype=np.float32))
    ref = jw.localize(jf[1], jax.random.key(0))
    got = tw.localize(tf_[1], (0, 0))
    assert ref is not None and got is not None
    assert got.partner == ref.partner == "m0"
    assert [e[0] for e in got.edges] == ["m0"]
    truth = np.linalg.inv(truths[0]) @ truths[1]
    for other in (ref.pose, truth):
        rot, trans = ttf.pose_error(got.pose, other)
        assert rot < 1.0 and trans < 0.1, (rot, trans)
    assert tw._map_radius() == jw._map_radius() > 1.0


def test_updated_map_votes_for_itself_reference_fault(stream_views):
    """Reference fault at mapmerge_tpu/pipeline/incremental.py:203, ported
    as is: re-localizing a map already in the world votes against the whole
    world, its own (stale) descriptors included, so its own slot takes the
    most votes and its best partner is itself (a self-loop edge)."""
    _, _, jf = stream_views
    tf_ = [_port_features(f) for f in jf]
    jw = jinc.WorldModel(STREAM, max_maps=4)
    tw = tinc.WorldModel(port_params(STREAM), max_maps=4)
    for name, j, t in zip(("m0", "m1"), jf, tf_):
        jw.add(name, j, np.eye(4, dtype=np.float32))
        tw.add(name, t, np.eye(4, dtype=np.float32))
    ref = np.asarray(jinc._vote(
        jf[1].descriptors.data, jf[1].descriptors.valid & jf[1].keypoints.mask,
        jw._world_desc, jw._world_valid, jw._world_map_id, STREAM.matching_k, 4,
    ))
    got = tinc._vote(
        tf_[1].descriptors.data, tf_[1].descriptors.valid & tf_[1].keypoints.mask,
        tw._world_desc, tw._world_valid, tw._world_map_id, STREAM.matching_k, 4,
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    n_desc = int((tf_[1].descriptors.valid & tf_[1].keypoints.mask).sum())
    assert got.argmax() == 1 and got[1] == n_desc  # every descriptor finds itself


def test_features_for_is_extract_features(stream_views):
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.pipeline.features import extract_features

    views, _, _ = stream_views
    cloud = PointCloud.from_numpy(*views[2], capacity=STREAM.max_points, device="cpu")
    a = tinc.features_for(cloud, port_params(STREAM))
    b = extract_features(cloud, port_params(STREAM))
    assert torch.equal(a.descriptors.data, b.descriptors.data)
    assert torch.equal(a.keypoints.mask, b.keypoints.mask)
