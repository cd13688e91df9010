"""Global-consistency merge graph solve on the host (the port's copy of
mapmerge_tpu/graph/merge_graph.py).

The reference's graph machinery (map_merge_3d/src/graph.cpp, graph.h):
union-find components under a confidence threshold, a maximum spanning tree
by Kruskal on descending confidence, tree centres by leaf-BFS eccentricity,
and global transforms chained over the tree. N maps make O(N^2) scalars, so
it stays on the host. `compute_global_transforms` is what every merge runs,
as the JAX package's default path does: the native solver,
`native.merge_graph_solve` (csrc/mapmerge_native.cpp, built with g++),
float32 confidences and threshold, chaining and inverses in double.
`compute_global_transforms_plain` is its plain Python version, which the
tests and chip_smoke.py hold it against and no merge runs: the JAX
package's pure-Python path, its behavioural contract
(merge_graph.py:184-185), brought to the native rule where the two differ:
confidences compared as float32, and an edge whose transform has no inverse
(a failed pair's zero matrix, or a singular estimate: a Gauss-Jordan pivot
below 1e-12, native/mapmerge_native.cpp:60-84) leaves the maps beyond it
unregistered, where the Python path raises.

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

from mapmerge_torch import native


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
    threshold = np.float32(confidence_threshold)
    for est in estimates:
        if np.float32(est.confidence) < threshold:
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
        ((e.source_idx, e.target_idx, np.float32(e.confidence)) for e in estimates),
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


def _invert4(m: np.ndarray) -> np.ndarray | None:
    """General 4x4 inverse by Gauss-Jordan with partial pivoting, in double
    (the native invert4); None where a pivot falls below 1e-12."""
    a = [[float(v) for v in row] + [float(r == c) for c in range(4)]
         for r, row in enumerate(np.asarray(m, np.float32))]
    for col in range(4):
        piv = col
        for r in range(col + 1, 4):
            if abs(a[r][col]) > abs(a[piv][col]):
                piv = r
        if abs(a[piv][col]) < 1e-12:
            return None
        a[piv], a[col] = a[col], a[piv]
        d = a[col][col]
        a[col] = [v / d for v in a[col]]
        for r in range(4):
            if r != col:
                f = a[r][col]
                a[r] = [v - f * p for v, p in zip(a[r], a[col])]
    return np.array([row[4:] for row in a], np.float32)


def _get_transform(
    estimates: list[TransformEstimate], from_idx: int, to_idx: int
) -> np.ndarray:
    """Transform for walking from -> to (map_merging.cpp:137-151); zeros
    where the edge's transform has no inverse (a failed pair)."""
    for est in estimates:
        if est.source_idx == from_idx and est.target_idx == to_idx:
            inv = _invert4(est.transform)
            return np.zeros((4, 4), np.float32) if inv is None else inv
        if est.source_idx == to_idx and est.target_idx == from_idx:
            return est.transform
    return np.zeros((4, 4), np.float32)


def compute_global_transforms(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[np.ndarray]:
    """Per-node map -> reference transforms (map_merging.cpp:153-186), by
    the native solver. Zero matrices mark nodes outside the largest
    component or unreached."""
    if not estimates:
        return []
    return list(native.merge_graph_solve(
        np.asarray([e.source_idx for e in estimates], np.int32),
        np.asarray([e.target_idx for e in estimates], np.int32),
        np.asarray([e.confidence for e in estimates], np.float32),
        np.stack([np.asarray(e.transform, np.float32) for e in estimates]),
        confidence_threshold,
    ))


def compute_global_transforms_plain(
    estimates: list[TransformEstimate], confidence_threshold: float
) -> list[np.ndarray]:
    """compute_global_transforms in plain Python (the reference's own
    path): the same maps registered, transforms within float32 rounding of
    the native chain, which accumulates in double."""
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
