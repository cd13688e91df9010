"""The plain reference: the same semantics as the pipeline's layers, in plain
PyTorch, written from their definitions and independent of mapmerge_torch
(it imports nothing of it, and takes nothing that the program made).

- `voxel_grid`: pcl::VoxelGrid, each occupied cube of edge `resolution`
  becomes the centroid of its points; a point's cube is floor(x * (1 /
  resolution)) in float32, as PCL computes it, the centroid a float64 mean.
- `radius_counts`: pcl::RadiusOutlierRemoval's count, the points within
  `radius` of each point, itself included.
- `normals`: pcl::NormalEstimation, PCA over each query's radius
  neighbourhood: the normal is the eigenvector of the covariance's
  smallest eigenvalue, curvature = l0 / (l0 + l1 + l2), at least 3 points.
- `harris_response`: pcl::HarrisKeypoint3D's HARRIS response at each
  query, C = the sum of n n^T over the points with a valid normal within
  the radius, det(C) - 0.04 tr(C)^2.
- `gaussian_smooth`: pcl::SIFTKeypoint's scale space at each query, the
  Gaussian-weighted mean exp(-d^2 / (2 s^2)) of the points' intensities
  within 3 max(s), for each scale s.
- `fpfh`: pcl::FPFHEstimation at each keypoint: an SPFH (computePairFeatures'
  theta, alpha, phi, 11 bins each, scaled to 100 over the valid pairs) at
  every surface point within the radius, over every surface point within
  the radius of it; their sum weighted by 1 / distance (the port's weight;
  the keypoint itself left out), each 11-bin block scaled to 100.
- `compose`: composeMaps, each map moved by its pose, all concatenated,
  then voxelized at the output resolution.
- `pose_errors`: each registered map's pose against the scene's truth,
  relative to the first registered map.

Each computes in float64 by default. `precision` "tf32" or "bfloat16"
rounds the operands of the products to that type and sums in float32, as
a tensor core would: that is the control, the reference put in the
program's place one precision below the float32 it states.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

#: a cell index's offset and span in the packed 64-bit key (21 bits an axis)
_OFF = 1 << 20
_SPAN = 1 << 21
_NEIGHBOUR_CELLS = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)), dtype=torch.int64)


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """float32 `x` with its mantissa rounded to `precision` ("float32" and
    "float64" leave it as it is): TF32 keeps 10 bits, bfloat16 7."""
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _work_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def pack_keys(cells: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 cell indices -> (N,) int64 keys, ordered by x, y, z."""
    c = cells + _OFF
    return (c[:, 0] * _SPAN + c[:, 1]) * _SPAN + c[:, 2]


def voxel_keys(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """The key of each point's cube: floor(x * f32(1 / resolution)) in
    float32, as pcl::VoxelGrid computes it."""
    inv = torch.tensor(1.0 / resolution, dtype=torch.float32)
    return pack_keys(torch.floor(xyz.to(torch.float32) * inv.to(xyz.device)).to(torch.int64))


def voxel_grid(xyz: torch.Tensor, resolution: float, precision: str = "float64",
               rgb: torch.Tensor | None = None):
    """(keys (M,) sorted, centroids (M, 3), counts (M,)) of the occupied
    cubes of the points `xyz` (N, 3) float32; with `rgb` (N, 3) also each
    cube's mean colour (M, 3), last."""
    keys = voxel_keys(xyz, resolution)
    uniq, inverse, counts = torch.unique(keys, return_inverse=True, return_counts=True)
    dtype = _work_dtype(precision)
    sums = torch.zeros((uniq.shape[0], 3), dtype=dtype, device=xyz.device)
    sums.index_add_(0, inverse, round_to(xyz.to(torch.float32), precision).to(dtype))
    out = (uniq, sums / counts[:, None].to(dtype), counts)
    if rgb is None:
        return out
    colours = torch.zeros((uniq.shape[0], 3), dtype=dtype, device=xyz.device)
    colours.index_add_(0, inverse, round_to(rgb.to(torch.float32), precision).to(dtype))
    return (*out, colours / counts[:, None].to(dtype))


def lookup(keys: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The index of each of `want` in the sorted `keys`, -1 where absent."""
    if keys.numel() == 0:
        return torch.full_like(want, -1)
    pos = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
    return torch.where(keys[pos] == want, pos, -1)


def radius_pairs(q: torch.Tensor, p: torch.Tensor, radius: float, chunk: int = 1 << 15,
                 precision: str = "float64"):
    """Every (query, point) pair with |q - p| <= radius, by query chunks:
    yields (query index, point index, squared distance), from a hash of cubes of edge
    `radius` (each query looks at its own and the 26 around it), distances
    in float64 (or, below it, the float32 offsets rounded to `precision`
    and squared and summed in float32 against float32 r^2)."""
    dev = q.device
    q64, p64 = q.to(torch.float64), p.to(torch.float64)
    r2 = radius * radius
    cells_p = torch.floor(p64 / radius).to(torch.int64)
    keys_p = pack_keys(cells_p)
    order = torch.argsort(keys_p)
    sorted_keys = keys_p[order]
    cells_q = torch.floor(q64 / radius).to(torch.int64)
    offsets = _NEIGHBOUR_CELLS.to(dev)
    for s in range(0, q.shape[0], chunk):
        cq = cells_q[s : s + chunk]
        rows_all = torch.arange(cq.shape[0], device=dev)
        for off in offsets:
            want = pack_keys(cq + off)
            lo = torch.searchsorted(sorted_keys, want)
            n = torch.searchsorted(sorted_keys, want, right=True) - lo
            total = int(n.sum())
            if total == 0:
                continue
            rows = torch.repeat_interleave(rows_all, n)
            first = torch.cumsum(n, 0) - n
            pos = lo[rows] + torch.arange(total, device=dev) - first[rows]
            qi, pi = rows + s, order[pos]
            if precision == "float64":
                d2 = ((q64[qi] - p64[pi]) ** 2).sum(1)
                keep = d2 <= r2
            else:
                d = round_to(p[pi].to(torch.float32) - q[qi].to(torch.float32), precision)
                d2 = (d * d).sum(1)
                keep = d2 <= torch.tensor(r2, dtype=torch.float32)
            yield qi[keep], pi[keep], d2[keep]


def radius_counts(points: torch.Tensor, radii: tuple[float, ...],
                  precision: str = "float64") -> list[torch.Tensor]:
    """For each of `radii`, (N,) int64: the points within it of each point,
    itself included (pcl::RadiusOutlierRemoval), from one sweep."""
    n = points.shape[0]
    counts = [torch.zeros((n,), dtype=torch.int64, device=points.device) for _ in radii]
    for qi, _, d2 in radius_pairs(points, points, max(radii), precision=precision):
        for c, r in zip(counts, radii):
            c += torch.bincount(qi[d2 <= (r * r if precision == "float64" else
                                          torch.tensor(r * r, dtype=torch.float32))], minlength=n)
    return counts


def radius_counts_at(queries: torch.Tensor, points: torch.Tensor, radius: float) -> np.ndarray:
    """The points within `radius` of each query (float64 distances), as a
    host array."""
    count = torch.zeros((queries.shape[0],), dtype=torch.int64, device=queries.device)
    for qi, _, _ in radius_pairs(queries, points, radius):
        count += torch.bincount(qi, minlength=queries.shape[0])
    return count.cpu().numpy()


def normals(queries: torch.Tensor, points: torch.Tensor, radius: float,
            precision: str = "float64"):
    """pcl::NormalEstimation at each query over `points` within `radius`:
    (normal (Q, 3), curvature (Q,), count (Q,)) as float64 host arrays; the
    normal is NaN where fewer than 3 points lie within the radius. The
    moments are summed over query-centred offsets (float64, or the
    offsets' products in `precision` summed in float32)."""
    nq = queries.shape[0]
    dev = queries.device
    dtype = _work_dtype(precision)
    n = torch.zeros((nq,), dtype=torch.float64, device=dev)
    s1 = torch.zeros((nq, 3), dtype=dtype, device=dev)
    s2 = torch.zeros((nq, 9), dtype=dtype, device=dev)
    for qi, pi, _ in radius_pairs(queries, points, radius):
        if precision == "float64":
            d = points[pi].to(torch.float64) - queries[qi].to(torch.float64)
        else:
            d = round_to(points[pi].to(torch.float32) - queries[qi].to(torch.float32), precision)
        n.index_add_(0, qi, torch.ones_like(qi, dtype=torch.float64))
        s1.index_add_(0, qi, d)
        s2.index_add_(0, qi, (d[:, :, None] * d[:, None, :]).reshape(-1, 9))
    count = n.cpu().numpy()
    c = np.maximum(count, 1.0)[:, None]
    mean = s1.cpu().numpy().astype(np.float64) / c
    cov = (s2.cpu().numpy().astype(np.float64) / c).reshape(-1, 3, 3)
    cov -= mean[:, :, None] * mean[:, None, :]
    lam, vec = np.linalg.eigh(cov)
    lam = np.maximum(lam, 0.0)
    normal = vec[:, :, 0]
    total = lam.sum(1)
    curvature = np.where(total > 0, lam[:, 0] / np.where(total > 0, total, 1.0), 0.0)
    normal[count < 3] = np.nan
    return normal, curvature, count


def _members(queries, points, radius: float, tie: float):
    """The (query, point, d2) pairs within `radius` + `tie` (float64
    distances), and for each query whether a point lies within `tie` of
    the radius: a tie, whose membership rounding settles either way."""
    nq = queries.shape[0]
    tied = torch.zeros((nq,), dtype=torch.bool, device=queries.device)
    lo2, hi2 = (radius - tie) ** 2, radius * radius
    blocks = []
    for qi, pi, d2 in radius_pairs(queries, points, radius + tie):
        tied[qi[d2 > lo2]] = True
        keep = d2 <= hi2
        blocks.append((qi[keep], pi[keep], d2[keep]))
    return blocks, tied


def _products(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """(N, 3, 3) a b^T of float32 rows, in float64 or with the rows
    rounded to `precision` and multiplied in float32."""
    if precision == "float64":
        a, b = a.to(torch.float64), b.to(torch.float64)
    else:
        a, b = round_to(a.to(torch.float32), precision), round_to(b.to(torch.float32), precision)
    return a[:, :, None] * b[:, None, :]


def harris_response(queries: torch.Tensor, points: torch.Tensor, normals: torch.Tensor,
                    radius: float, tie: float, precision: str = "float64"):
    """HarrisKeypoint3D's HARRIS response at each query over `points` with
    their (valid) `normals` within `radius`: (response (Q,), tr(C) (Q,),
    tied (Q,)) as float64 host arrays. C is summed in float64, or with the
    normals rounded to `precision` and the products summed in float32."""
    nq = queries.shape[0]
    dtype = _work_dtype(precision)
    c = torch.zeros((nq, 9), dtype=dtype, device=queries.device)
    blocks, tied = _members(queries, points, radius, tie)
    for qi, pi, _ in blocks:
        n = normals[pi]
        c.index_add_(0, qi, _products(n, n, precision).reshape(-1, 9))
    c = c.cpu().numpy().astype(np.float64).reshape(-1, 3, 3)
    trace = np.trace(c, axis1=1, axis2=2)
    return np.linalg.det(c) - 0.04 * trace * trace, trace, tied.cpu().numpy()


def gaussian_smooth(queries: torch.Tensor, points: torch.Tensor, values: torch.Tensor,
                    sigmas: list[float], tie: float, precision: str = "float64"):
    """The Gaussian-weighted mean of `values` (P,) over `points` within 3
    max(sigmas) of each query, for each sigma: ((S, Q), tied (Q,)) as
    float64 host arrays. Weights and sums in float64, or the values and
    weights rounded to `precision` and summed in float32."""
    nq, dtype = queries.shape[0], _work_dtype(precision)
    num = torch.zeros((len(sigmas), nq), dtype=dtype, device=queries.device)
    den = torch.zeros_like(num)
    blocks, tied = _members(queries, points, 3.0 * max(sigmas), tie)
    for qi, pi, d2 in blocks:
        v = values[pi].to(torch.float64)
        if precision != "float64":
            v = round_to(values[pi].to(torch.float32), precision)
        for s, sigma in enumerate(sigmas):
            w = torch.exp(-d2 / (2.0 * sigma * sigma))
            if precision != "float64":
                w = round_to(w.to(torch.float32), precision)
            num[s].index_add_(0, qi, (w * v).to(dtype))
            den[s].index_add_(0, qi, w.to(dtype))
    out = num.cpu().numpy().astype(np.float64) / np.maximum(den.cpu().numpy(), 1e-12)
    return out, tied.cpu().numpy()


def pair_features(p1, n1, p2, n2):
    """pcl::computePairFeatures of point pairs (N, 3), in their dtype:
    (theta, alpha, phi, ok). The source of the Darboux frame is the point
    whose normal makes the smaller angle with the line joining them."""
    d = p2 - p1
    dist = torch.linalg.vector_norm(d, dim=1)
    ok = dist > 0
    d = d / torch.where(ok, dist, 1.0)[:, None]
    a1, a2 = (n1 * d).sum(1), (n2 * d).sum(1)
    swap = a1.abs() < a2.abs()
    ns = torch.where(swap[:, None], n2, n1)
    nt = torch.where(swap[:, None], n1, n2)
    d = torch.where(swap[:, None], -d, d)
    phi = torch.where(swap, -a2, a1)
    v = torch.linalg.cross(d, ns, dim=1)
    vn = torch.linalg.vector_norm(v, dim=1)
    ok &= vn > 0
    v = v / torch.where(vn > 0, vn, 1.0)[:, None]
    w = torch.linalg.cross(ns, v, dim=1)
    alpha = (v * nt).sum(1)
    theta = torch.atan2((w * nt).sum(1), (ns * nt).sum(1))
    return theta, alpha, phi, ok


def _bins(value: torch.Tensor, lo: float, hi: float, bins: int = 11) -> torch.Tensor:
    """PCL's floor-and-clip binning."""
    return torch.floor((value - lo) / (hi - lo) * bins).to(torch.int64).clamp(0, bins - 1)


def spfh(queries: torch.Tensor, q_normals: torch.Tensor, points: torch.Tensor,
         normals: torch.Tensor, radius: float, precision: str = "float64") -> torch.Tensor:
    """(Q, 33) SPFH of each query point over `points` within `radius`, each
    row scaled to 100 over its valid pairs (the query itself is no pair);
    pair features in float64, or from offsets and normals rounded to
    `precision` in float32."""
    nq = queries.shape[0]
    dtype = torch.float64 if precision == "float64" else torch.float32
    hist = torch.zeros((nq, 33), dtype=torch.float64, device=queries.device)
    total = torch.zeros((nq,), dtype=torch.float64, device=queries.device)
    for qi, pi, _ in radius_pairs(queries, points, radius):
        p1 = queries[qi].to(dtype)
        p2 = p1 + round_to((points[pi] - queries[qi]).to(torch.float32), precision).to(dtype) \
            if precision != "float64" else points[pi].to(dtype)
        n1 = round_to(q_normals[qi].to(torch.float32), precision).to(dtype)
        n2 = round_to(normals[pi].to(torch.float32), precision).to(dtype)
        theta, alpha, phi, ok = pair_features(p1, n1, p2, n2)
        qi = qi[ok]
        for k, (value, lo, hi) in enumerate(((theta, -np.pi, np.pi), (alpha, -1.0, 1.0),
                                             (phi, -1.0, 1.0))):
            idx = qi * 33 + k * 11 + _bins(value[ok].to(torch.float64), lo, hi)
            hist.view(-1).index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))
        total.index_add_(0, qi, torch.ones_like(qi, dtype=torch.float64))
    return hist * torch.where(total > 0, 100.0 / total.clamp_min(1.0), 0.0)[:, None]


def fpfh(keypoints: torch.Tensor, points: torch.Tensor, normals: torch.Tensor,
         radius: float, tie: float, precision: str = "float64"):
    """FPFH-33 at each keypoint over the surface `points` with their
    `normals`: (descriptors (K, 33), neighbours (K,), tied (K,)) as host
    arrays; a keypoint with no weighted neighbour gets NaN."""
    nk, dev = keypoints.shape[0], keypoints.device
    blocks, tied = _members(keypoints, points, radius, tie)
    ki = torch.cat([b[0] for b in blocks]) if blocks else torch.zeros(0, dtype=torch.int64, device=dev)
    pj = torch.cat([b[1] for b in blocks]) if blocks else ki
    d2 = torch.cat([b[2] for b in blocks]) if blocks else ki.to(torch.float64)
    neighbours = torch.bincount(ki, minlength=nk)
    away = d2 > 0
    ki, pj, dist = ki[away], pj[away], torch.sqrt(d2[away])
    needed, row = torch.unique(pj, return_inverse=True)
    table = spfh(points[needed], normals[needed], points, normals, radius, precision)
    out = torch.zeros((nk, 33), dtype=torch.float64, device=dev)
    out.index_add_(0, ki, table[row] / dist[:, None])
    blocks3 = out.reshape(nk, 3, 11)
    sums = blocks3.sum(2, keepdim=True)
    out = torch.where(sums > 0, blocks3 * 100.0 / sums.clamp_min(1e-300), torch.nan).reshape(nk, 33)
    return out.cpu().numpy(), neighbours.cpu().numpy(), tied.cpu().numpy()


def transform(pose: np.ndarray, xyz: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """x -> R x + t of the (4, 4) pose, in float64 or with R and x rounded
    to `precision` and the products summed in float32."""
    dtype = _work_dtype(precision)
    t = torch.as_tensor(np.asarray(pose), device=xyz.device)
    if precision == "float64":
        return xyz.to(torch.float64) @ t[:3, :3].to(torch.float64).T + t[:3, 3].to(torch.float64)
    r = round_to(t[:3, :3].to(torch.float32), precision)
    x = round_to(xyz.to(torch.float32), precision)
    return (x[:, :, None] * r[None, :, :].transpose(1, 2)).sum(1).to(dtype) + t[:3, 3].to(dtype)


def compose(views: list[torch.Tensor], poses: list[np.ndarray], resolution: float,
            precision: str = "float64"):
    """composeMaps: the views whose pose is not zero, moved and
    concatenated, voxelized at `resolution`: voxel_grid's (keys, centroids,
    counts)."""
    moved = torch.cat([
        transform(p, v, precision) for v, p in zip(views, poses) if np.asarray(p).any()
    ])
    if precision == "float64":
        return _voxel_grid64(moved, resolution)
    return voxel_grid(moved.to(torch.float32), resolution)


def _voxel_grid64(xyz64: torch.Tensor, resolution: float):
    """voxel_grid of float64 points: cubes by floor(x * f32(1 / resolution))
    in float64, float64 centroids."""
    inv = float(np.float32(1.0 / resolution))
    keys = pack_keys(torch.floor(xyz64 * inv).to(torch.int64))
    uniq, inverse, counts = torch.unique(keys, return_inverse=True, return_counts=True)
    sums = torch.zeros((uniq.shape[0], 3), dtype=torch.float64, device=xyz64.device)
    sums.index_add_(0, inverse, xyz64)
    return uniq, sums / counts[:, None].to(torch.float64), counts


def rotation_deg(r: np.ndarray) -> float:
    """The angle of a rotation matrix, in degrees."""
    cos = (np.trace(r) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def pose_errors(poses: list[np.ndarray], truths: list[np.ndarray]) -> list:
    """(rotation deg, translation m) of each registered map's pose against
    its truth, both taken relative to the first registered map (the
    poses' frame is arbitrary); None for a map with a zero pose."""
    ok = [i for i, p in enumerate(poses) if np.asarray(p).any()]
    if not ok:
        return [None] * len(poses)
    a = ok[0]
    inv_p = np.linalg.inv(np.asarray(poses[a], np.float64))
    inv_t = np.linalg.inv(np.asarray(truths[a], np.float64))
    out = []
    for i, p in enumerate(poses):
        if i not in ok:
            out.append(None)
            continue
        got = inv_p @ np.asarray(p, np.float64)
        want = inv_t @ np.asarray(truths[i], np.float64)
        diff = np.linalg.inv(want) @ got
        out.append((rotation_deg(diff[:3, :3]), float(np.linalg.norm(got[:3, 3] - want[:3, 3]))))
    return out
