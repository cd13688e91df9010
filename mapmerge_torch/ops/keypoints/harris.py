"""Harris3D keypoints (port of mapmerge_tpu/ops/keypoints/harris.py).

pcl::HarrisKeypoint3D as the reference configures it (features.cpp:64-83):
the HARRIS response of the covariance of the valid surface normals in the
search radius, C = sum n n^T, r = det(C) - 0.04 tr(C)^2 (one radius_reduce
sum of the outer products); non-max suppression as a radius_reduce max;
the top `max_keypoints` survivors above the threshold; then a fixed 3
refinement solves sum(n n^T) x = sum(n n^T p).

On the grid engine an extraction sorts its points twice: one target grid
(the points valid in the mask and the normals) and one query grid of every
point, which the response and the suppression sweep, and the tile boxes of
the target once, which the refinement's few queries take on the small-Q
path (ops/grid.grid_reduce_query, kernel L). C is symmetric, so the grid
sums its upper triangle alone (6 channels, UPPER), each channel on its own,
and mirrors them into the 3 x 3 (MIRROR); the refinement adds the 3
channels of n n^T p. The suppression sweeps only the queries whose
response is above the threshold (the query grid's slots and-ed with it):
a query at or below it, or NaN, is never kept, whatever its neighbourhood
max. The dense engine sums all 9 channels (12 in the refinement) over
every query.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import FAR, PointCloud
from mapmerge_torch.kernels import grid as grid_kernels
from mapmerge_torch.ops.grid import (
    SMALL_Q_THRESHOLD,
    build_grid,
    grid_reduce_query,
    masked_query_grid,
)
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import BIG, _f32, _resolve_engine, radius_reduce
from mapmerge_torch.ops.normals import SurfaceNormals
from mapmerge_torch.ops.rigid import _det3

_HARRIS_K = 0.04
_REFINE_ITERS = 3  # HarrisKeypoint3D refine on (features.cpp:64-83)
#: the distinct entries of the symmetric n n^T, row-major channels of its
#: 3 x 3: xx, xy, xz, yy, yz, zz
UPPER = (0, 1, 2, 4, 5, 8)
#: the channel of UPPER that each row-major entry of the 3 x 3 reads
MIRROR = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def _outer(normals: SurfaceNormals) -> torch.Tensor:
    """(P, 3, 3) n n^T of the valid normals (zero elsewhere)."""
    n = torch.where(normals.valid[:, None], normals.normals, 0.0)
    return n[:, :, None] * n[:, None, :]


def _mirror(upper: torch.Tensor) -> torch.Tensor:
    """(Q, 3, 3) from the sums of the UPPER channels (Q, 6): n_i n_j and
    n_j n_i are one product, so each mirrored entry is the bits of the
    9-channel sum of that entry."""
    return upper[:, list(MIRROR)].reshape(-1, 3, 3)


def _response(c: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """det(C) - k tr(C)^2 of each (3, 3) sum; -BIG outside `ok`."""
    trace = c[:, 0, 0] + c[:, 1, 1] + c[:, 2, 2]
    return torch.where(ok, _det3(c) - _HARRIS_K * trace * trace, -BIG)


class GridRoute:
    """The grids of one Harris extraction on the grid engine: the target
    grid of the points valid in `ok` (cell edge = the radius), the query
    grid of every point (None where they are few enough for the small-Q
    path, which needs none) and the target's tile boxes (kernels/grid.boxes,
    for the refinement's list route)."""

    def __init__(self, cloud: PointCloud, ok: torch.Tensor, radius: float, scan_cap: int):
        self.q = cloud.xyz
        self.grid = build_grid(cloud.xyz, ok, radius, None, scan_cap)
        self.qg = None
        if cloud.xyz.shape[0] > SMALL_Q_THRESHOLD:
            self.qg = build_grid(cloud.xyz, None, self.grid.cell_size, self.grid.dims,
                                 self.grid.cap)
        self.boxes = grid_kernels.boxes(self.grid)

    def response(self, normals: SurfaceNormals, ok: torch.Tensor) -> torch.Tensor:
        """The HARRIS response of every point: the UPPER channels summed."""
        upper = _outer(normals).reshape(-1, 9)[:, list(UPPER)]
        _, sums, _ = grid_reduce_query(self.grid, self.q, upper, "sum", qg=self.qg,
                                       boxes=self.boxes)
        return _response(_mirror(sums), ok)

    def suppression(self, resp: torch.Tensor, threshold: float) -> torch.Tensor:
        """The neighbourhood max of the response over the queries above the
        threshold (the query grid's slots and-ed with resp > threshold);
        -BIG at the others, which are never kept."""
        qg = self.qg
        if qg is not None:
            qg = masked_query_grid(qg, resp > threshold, self.q.shape[0])
        _, nmax, _ = grid_reduce_query(self.grid, self.q, resp[:, None], "max", qg=qg,
                                       boxes=self.boxes)
        return nmax[:, 0]


def harris_response(
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> torch.Tensor:
    """HARRIS corner response per cloud point; -BIG at invalid slots."""
    ok = cloud.mask & normals.valid
    if _resolve_engine(engine, cloud.xyz.shape[0]) == "grid":
        return GridRoute(cloud, ok, radius, scan_cap).response(normals, ok)
    _, sums, _ = radius_reduce(
        cloud.xyz, cloud.xyz, radius, _outer(normals).reshape(-1, 9),
        p_mask=ok, tile=tile, engine=engine, scan_cap=scan_cap,
    )
    return _response(sums.reshape(-1, 3, 3), ok)


def _refine_step(
    kp_xyz: torch.Tensor,
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
    route: GridRoute | None = None,
) -> torch.Tensor:
    """One corner-refinement solve sum(n n^T) x = sum(n n^T p) by the
    adjugate. An ill-conditioned system, or a solution that moves more than
    `radius`, keeps the point. With `route` (the extraction's grids) the
    sums take its target grid and boxes, on the UPPER channels and n n^T p."""
    outer = _outer(normals)
    nntp = (outer * cloud.xyz[:, None, :]).sum(dim=-1)  # (P, 3)
    if route is not None:
        values = torch.cat([outer.reshape(-1, 9)[:, list(UPPER)], nntp], dim=-1)  # (P, 9)
        _, sums, _ = grid_reduce_query(route.grid, kp_xyz, values, "sum", boxes=route.boxes)
        a, b = _mirror(sums[:, :6]), sums[:, 6:]
    else:
        values = torch.cat([outer.reshape(-1, 9), nntp], dim=-1)  # (P, 12)
        _, sums, _ = radius_reduce(
            kp_xyz, cloud.xyz, radius, values, p_mask=cloud.mask & normals.valid,
            tile=tile, engine=engine, scan_cap=scan_cap,
        )
        a, b = sums[:, :9].reshape(-1, 3, 3), sums[:, 9:]
    det = _det3(a)
    adj = torch.stack(
        [
            a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1],
            a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2],
            a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1],
            a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2],
            a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0],
            a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2],
            a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0],
            a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1],
            a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0],
        ],
        dim=-1,
    ).reshape(-1, 3, 3)
    trace = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    well = det.abs() > 1e-9 * trace.clamp_min(1e-9) ** 3
    x = (adj * b[:, None, :]).sum(dim=-1) / torch.where(well, det, 1.0)[:, None]
    moved2 = ((x - kp_xyz) ** 2).sum(dim=-1)
    keep_new = well & (moved2 <= _f32(radius * radius))
    return torch.where(keep_new[:, None], x, kp_xyz)


def detect_keypoints_harris(
    cloud: PointCloud,
    normals: SurfaceNormals,
    threshold: float,
    radius: float,
    max_keypoints: int,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Keypoints:
    """Reference features.cpp:64-83: non-max suppression on, refine on.

    Slots beyond the survivors are masked and parked at FAR; the order of
    equal responses is unspecified (it differs from lax.top_k's). On the
    grid engine the extraction's two grids serve every sum (GridRoute)."""
    ok = cloud.mask & normals.valid
    route = None
    if _resolve_engine(engine, cloud.xyz.shape[0]) == "grid":
        route = GridRoute(cloud, ok, radius, scan_cap)
        resp = route.response(normals, ok)
        nmax = route.suppression(resp, threshold)
    else:
        resp = harris_response(
            cloud, normals, radius, tile=tile, engine=engine, scan_cap=scan_cap
        )
        # non-max suppression: the own response must equal the neighborhood max
        _, nmax, _ = radius_reduce(
            cloud.xyz, cloud.xyz, radius, resp[:, None], p_mask=ok, tile=tile,
            reduce="max", engine=engine, scan_cap=scan_cap,
        )
        nmax = nmax[:, 0]
    keep = ok & (resp >= nmax) & (resp > threshold)

    score = torch.where(keep, resp, -BIG)
    k = min(max_keypoints, score.shape[0])
    top_scores, top_idx = torch.topk(score, k)
    kp_mask = top_scores > -BIG / 2
    kp_xyz = cloud.xyz[top_idx]
    for _ in range(_REFINE_ITERS):
        kp_xyz = _refine_step(
            kp_xyz, cloud, normals, radius, tile, engine, scan_cap, route=route
        )
    return Keypoints(
        xyz=torch.where(kp_mask[:, None], kp_xyz, FAR),
        response=torch.where(kp_mask, top_scores, 0.0),
        mask=kp_mask,
        truncated=(keep.sum().to(torch.int32) - k).clamp_min(0),
    )
