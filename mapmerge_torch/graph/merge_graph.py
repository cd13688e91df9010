"""Global-consistency merge graph solve, host numpy (the port's copy of
mapmerge_tpu/graph/merge_graph.py).

The reference's graph machinery (map_merge_3d/src/graph.cpp, graph.h):
union-find components under a confidence threshold, a maximum spanning tree
by Kruskal on descending confidence, tree centres by leaf-BFS eccentricity,
and global transforms chained over the tree. N maps make O(N^2) scalars, so
it stays on the host. This is the reference's pure-Python path, its
behavioural contract (merge_graph.py:184-185), not its native solver, with
one repair taken from that solver (native/mapmerge_native.cpp:219-247): a
failed pair (zero matrix) on the tree leaves the maps beyond it
unregistered, where the Python path would invert it and raise.

- edges below `confidence_threshold` do not join components
  (graph.cpp:77-80), but every estimate whose source lands in the largest
  component is kept for the spanning tree (graph.cpp:92-99);
- the transforms are sized by the highest node index in the estimates
  (map_merging.cpp:167); a zero matrix means unregistered;
- for an edge (source i, target j, T: i->j frame), global[j] =
  global[i] @ T^-1 when walking i->j (map_merging.cpp:137-151).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TransformEstimate:
    """Pairwise estimate (graph.h:24-36). `ambiguous` marks structurally
    weak evidence (PairEstimate.ambiguous): the spanning tree ignores it,
    the pose-graph refiner halves its weight."""

    source_idx: int
    target_idx: int
    transform: np.ndarray  # (4, 4) float32; zeros when estimation failed
    confidence: float
    ambiguous: bool = False


class DisjointSets:
    """Union-find with union by rank and path compression (graph.cpp:17-57);
    `size` is authoritative at roots only."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n
        self.size = [1] * n

    def find(self, elem: int) -> int:
        root = elem
        while root != self.parent[root]:
            root = self.parent[root]
        while elem != self.parent[elem]:
            elem, self.parent[elem] = self.parent[elem], root
        return root

    def merge(self, a: int, b: int) -> int:
        if self.rank[a] < self.rank[b]:
            self.parent[a] = b
            self.size[b] += self.size[a]
            return b
        if self.rank[b] < self.rank[a]:
            self.parent[b] = a
            self.size[a] += self.size[b]
            return a
        self.parent[a] = b
        self.rank[b] += 1
        self.size[b] += self.size[a]
        return b


def number_of_nodes(estimates: list[TransformEstimate]) -> int:
    n = 0
    for est in estimates:
        n = max(n, est.source_idx + 1, est.target_idx + 1)
    return n


def largest_connected_component(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[TransformEstimate]:
    """The estimates of the largest component (graph.cpp:64-102)."""
    n = number_of_nodes(estimates)
    if n == 0:
        return []
    comps = DisjointSets(n)
    for est in estimates:
        if est.confidence < confidence_threshold:
            continue
        a = comps.find(est.source_idx)
        b = comps.find(est.target_idx)
        if a != b:
            comps.merge(a, b)
    # argmax over the sizes of roots only, so the winner is a component
    # representative even where stale sizes tie
    roots = [comps.find(i) for i in range(n)]
    sizes = [comps.size[i] if roots[i] == i else 0 for i in range(n)]
    max_comp = int(np.argmax(sizes))
    return [e for e in estimates if comps.find(e.source_idx) == max_comp]


def find_max_spanning_tree(
    estimates: list[TransformEstimate],
) -> tuple[dict[int, list[tuple[int, float]]], list[int]]:
    """Kruskal maximum spanning tree and tree centres (graph.cpp:104-175):
    (adjacency {node: [(neighbour, weight)]}, centres)."""
    n = number_of_nodes(estimates)
    if n == 0:
        return {}, []
    edges = sorted(
        ((e.source_idx, e.target_idx, e.confidence) for e in estimates),
        key=lambda t: t[2],
        reverse=True,
    )
    comps = DisjointSets(n)
    adj: dict[int, list[tuple[int, float]]] = {i: [] for i in range(n)}
    powers = [0] * n
    for a, b, w in edges:
        ra, rb = comps.find(a), comps.find(b)
        if ra != rb:
            comps.merge(ra, rb)
            adj[a].append((b, w))
            adj[b].append((a, w))
            powers[a] += 1
            powers[b] += 1

    leafs = [i for i in range(n) if powers[i] == 1]
    max_dists = [0] * n
    for leaf in leafs:
        cur = _bfs_distances(adj, leaf, n)
        for i in range(n):
            max_dists[i] = max(max_dists[i], cur[i])
    min_max = min(max_dists)
    centers = [i for i in range(n) if max_dists[i] == min_max]
    return adj, centers


def _bfs_distances(adj, start: int, n: int) -> list[int]:
    dist = [0] * n
    seen = [False] * n
    seen[start] = True
    queue = [start]
    while queue:
        u = queue.pop(0)
        for v, _ in adj[u]:
            if not seen[v]:
                seen[v] = True
                dist[v] = dist[u] + 1
                queue.append(v)
    return dist


def _get_transform(
    estimates: list[TransformEstimate], from_idx: int, to_idx: int
) -> np.ndarray:
    """Transform for walking from -> to (map_merging.cpp:137-151); zeros
    across a failed pair."""
    for est in estimates:
        if est.source_idx == from_idx and est.target_idx == to_idx:
            if not np.any(est.transform):
                return np.zeros((4, 4), np.float32)
            return np.linalg.inv(est.transform)
        if est.source_idx == to_idx and est.target_idx == from_idx:
            return est.transform
    return np.zeros((4, 4), np.float32)


def compute_global_transforms(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[np.ndarray]:
    """Per-node map -> reference transforms (map_merging.cpp:153-186).

    Zero matrices mark nodes outside the largest component or unreached."""
    nodes_count = number_of_nodes(estimates)
    if nodes_count == 0:
        return []
    component = largest_connected_component(estimates, confidence_threshold)
    adj, centers = find_max_spanning_tree(component)

    global_t = [np.zeros((4, 4), np.float32) for _ in range(nodes_count)]
    if not centers:
        return global_t
    reference = centers[0]
    global_t[reference] = np.eye(4, dtype=np.float32)

    # breadth-first walk, chaining the transforms
    seen = {reference}
    queue = [reference]
    while queue:
        u = queue.pop(0)
        for v, _ in adj.get(u, []):
            if v not in seen:
                seen.add(v)
                global_t[v] = (
                    global_t[u] @ _get_transform(component, u, v)
                ).astype(np.float32)
                queue.append(v)
    return global_t
