"""Incremental register-to-world mode of the online node (port of
mapmerge_tpu/pipeline/incremental.py).

The reference node re-runs the full O(N^2) pairwise estimation on every
estimation tick (map_merge_node.cpp:141-142 -> map_merging.cpp:188-275).
This mode keeps a world model instead:

  - registered maps' keypoint descriptors sit in one preallocated device
    block of (max_maps * max_keypoints, D), so one descriptor matching
    matches a new map against every registered map at once;
  - a new (or updated) map is localized by that matching: reciprocal
    correspondences vote for registered maps, then the pairwise
    registration (pipeline/registration.py) runs against the best-voted
    map and, when a second map also has strong votes, against it too,
    which gives a redundant edge (a loop-closure candidate);
  - every successful registration is kept as a TransformEstimate edge, and
    `WorldModel.refine` relaxes the edge set with the offline pipeline's
    pose-graph refinement (graph/pose_graph.py), so stream drift is
    corrected, not only bounded by pairwise quality;
  - a map that cannot be localized stays unregistered and is retried on a
    later tick against the then richer world.

The reference's fault at incremental.py:203 is kept as it is: re-localizing
an updated map votes against the whole world, its own stale descriptors
included, so it may vote for itself and register against its old version.

Random draws: the reference folds (robot, tick, retry) and then the
partner's rank into a JAX key; here the same integers seed one
torch.Generator per registration (merging.seeded_generator). Torch cannot
replay JAX's key stream, so parity is checked at the pose level, as for
RANSAC.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.graph.merge_graph import TransformEstimate
from mapmerge_torch.graph.pose_graph import refine_global_transforms
from mapmerge_torch.ops.matching import find_correspondences
from mapmerge_torch.pipeline.features import CloudFeatures, extract_features
from mapmerge_torch.pipeline.merging import seeded_generator
from mapmerge_torch.pipeline.registration import estimate_transform


def features_for(cloud: PointCloud, params: MergeParams) -> CloudFeatures:
    """Features of one map at the cloud's own capacity. The reference jits
    this at a fixed capacity (or runs its staged path on big clouds); the
    port's stages run eagerly, so this is extract_features."""
    return extract_features(cloud, params)


def _vote(
    new_desc: torch.Tensor,
    new_valid: torch.Tensor,
    world_desc: torch.Tensor,
    world_valid: torch.Tensor,
    world_map_id: torch.Tensor,
    k: int,
    m_max: int,
) -> torch.Tensor:
    """Reciprocal matches of the new map's descriptors against the whole
    world, counted per registered map: (m_max,) int32. Counts add as
    integers, so their order cannot change them; map ids outside
    [0, m_max) are dropped (the reference's mode="drop")."""
    corr = find_correspondences(
        new_desc, world_desc, k=k,
        source_valid=new_valid, target_valid=world_valid,
    )
    seg = world_map_id[corr.target.to(torch.int64)].to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < m_max), seg, m_max)  # m_max: scrap
    votes = torch.zeros((m_max + 1,), dtype=torch.int32, device=seg.device)
    votes.index_add_(0, seg, corr.valid.to(torch.int32))
    return votes[:m_max]


@dataclasses.dataclass
class _Entry:
    name: str
    features: CloudFeatures
    pose: np.ndarray  # (4, 4) float32, map -> world


@dataclasses.dataclass
class Localization:
    """WorldModel.localize's result: the map's world pose, composed through
    the successful registration of highest confidence, and every pairwise
    edge the localization produced (for the world's pose graph)."""

    pose: np.ndarray  # (4, 4) float32, map -> world
    confidence: float
    partner: str  # the partner the pose was composed through
    #: (partner name, transform map -> partner, confidence, ambiguous) for
    #: each successful pair registration
    edges: list


class WorldModel:
    """Registered maps' descriptors (on their device) and poses, and the
    accumulated localization edges (the stream's pose graph)."""

    def __init__(
        self,
        params: MergeParams,
        max_maps: int = 64,
        second_partner: bool = True,
    ):
        self.params = params
        self.max_maps = max_maps
        #: register against the runner-up too when its votes are strong:
        #: the redundant edge lets refine() correct drift
        self.second_partner = second_partner
        self.entries: list[_Entry] = []
        self._by_name: dict[str, int] = {}
        #: TransformEstimate edges over entry slots; add() drops the edges
        #: of a replaced map
        self.edges: list[TransformEstimate] = []
        self._k = params.max_keypoints
        # the descriptor block is allocated at the first add(), on the
        # features' device, once the descriptor width is known
        self._world_desc: torch.Tensor | None = None
        self._world_valid: torch.Tensor | None = None
        self._world_map_id: torch.Tensor | None = None
        self._radius: float | None = None

    # ---- registry ----
    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def pose_of(self, name: str) -> np.ndarray:
        return self.entries[self._by_name[name]].pose

    @property
    def names(self) -> list[str]:
        return [e.name for e in self.entries]

    def add(self, name: str, features: CloudFeatures, pose: np.ndarray):
        """Insert or replace a registered map."""
        desc = features.descriptors.data
        valid = features.descriptors.valid & features.keypoints.mask
        if self._world_desc is None:
            rows, dev = self.max_maps * self._k, desc.device
            self._world_desc = torch.zeros(
                (rows, desc.shape[-1]), dtype=torch.float32, device=dev
            )
            self._world_valid = torch.zeros((rows,), dtype=torch.bool, device=dev)
            self._world_map_id = torch.zeros((rows,), dtype=torch.int32, device=dev)
        if name in self._by_name:
            slot = self._by_name[name]
            self.entries[slot] = _Entry(name, features, np.asarray(pose))
            # a replaced map's old edges measured the old geometry
            self.edges = [
                e for e in self.edges
                if e.source_idx != slot and e.target_idx != slot
            ]
        else:
            slot = len(self.entries)
            if slot >= self.max_maps:
                raise ValueError(
                    f"world model full ({self.max_maps} maps); raise max_maps"
                )
            self.entries.append(_Entry(name, features, np.asarray(pose)))
            self._by_name[name] = slot
        lo = slot * self._k
        self._world_desc[lo : lo + desc.shape[0]] = desc.to(torch.float32)
        self._world_valid[lo : lo + valid.shape[0]] = valid
        self._world_map_id[lo : lo + self._k] = slot

    # ---- localization ----
    def localize(
        self,
        features: CloudFeatures,
        key: Sequence[int],
        min_votes: int = 3,
    ) -> Localization | None:
        """Register a map against the world.

        One matching votes per registered map; the best-voted map is
        registered pairwise and (second_partner) so is the runner-up when
        its votes are strong. `key` seeds the registrations: the one
        against the partner of rank r draws from
        seeded_generator([*key, r]). None when the map cannot be localized
        yet (too few votes, or every registration failed): an in-band
        failure, retried on a later tick."""
        if not self.entries:
            return None
        votes = _vote(
            features.descriptors.data,
            features.descriptors.valid & features.keypoints.mask,
            self._world_desc, self._world_valid, self._world_map_id,
            self.params.matching_k, self.max_maps,
        )
        votes = votes.cpu().numpy()[: len(self.entries)]
        order = np.argsort(votes)[::-1]
        best = int(order[0])
        if votes[best] < min_votes:
            return None
        partners = [best]
        if (
            self.second_partner
            and len(order) > 1
            and votes[int(order[1])] >= max(min_votes, 0.3 * votes[best])
        ):
            partners.append(int(order[1]))

        edges, results = [], []
        device = features.descriptors.data.device
        for rank, slot in enumerate(partners):
            partner = self.entries[slot]
            est = estimate_transform(
                features, partner.features, self.params,
                generator=seeded_generator([*key, rank], device),
            )
            if not bool(est.ok):
                continue
            rel = est.transform.cpu().numpy()
            conf = float(est.confidence)
            amb = bool(est.ambiguous())
            edges.append((partner.name, rel, conf, amb))
            results.append((conf, partner, rel))
        if not results:
            return None
        conf, partner, rel = max(results, key=lambda r: r[0])
        pose = (partner.pose @ rel).astype(np.float32)
        return Localization(
            pose=pose, confidence=conf, partner=partner.name, edges=edges
        )

    # ---- the stream's pose graph ----
    def add_edges(self, name: str, edges: list) -> None:
        """Record a Localization's pairwise edges against `name`'s slot."""
        slot = self._by_name[name]
        for partner_name, rel, conf, amb in edges:
            self.edges.append(
                TransformEstimate(
                    source_idx=slot,
                    target_idx=self._by_name[partner_name],
                    transform=np.asarray(rel, np.float32),
                    confidence=conf,
                    ambiguous=amb,
                )
            )

    def _map_radius(self) -> float | None:
        """RMS radius of the first registered map's points, clipped to
        [1, 50] m: the length at which a rotation error displaces geometry
        (refine's rot_scale_m). Cached after the first call; None for a
        world of bare poses (no features), which keeps the refiner's
        mixed-unit residual."""
        if self._radius is None:
            feats = self.entries[0].features
            if feats is None:
                return None
            xyz = feats.cloud.xyz.cpu().numpy()
            pts = xyz[feats.cloud.mask.cpu().numpy()]
            c = pts.mean(0)
            self._radius = float(
                np.clip(np.sqrt(((pts - c) ** 2).sum(1).mean()), 1.0, 50.0)
            )
        return self._radius

    def refine(self, confidence_threshold: float = 0.0) -> bool:
        """Relax the accumulated edges with the offline pipeline's pose-graph
        refinement and update every entry's pose in place; the anchor
        (identity pose) is the gauge. True if a refinement ran (at least 3
        maps and an edge beyond a tree)."""
        n = len(self.entries)
        if n < 3 or len(self.edges) <= n - 1:
            return False
        seed = [np.asarray(e.pose, np.float32) for e in self.entries]
        refined = refine_global_transforms(
            self.edges, seed, confidence_threshold,
            rot_scale_m=self._map_radius(),
        )
        for i, entry in enumerate(self.entries):
            if np.asarray(refined[i]).any():
                entry.pose = np.asarray(refined[i], np.float32)
        return True
