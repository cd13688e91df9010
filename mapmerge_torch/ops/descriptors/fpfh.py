"""FPFH-33 descriptors (port of mapmerge_tpu/ops/descriptors/fpfh.py).

pcl::FPFHEstimation: an SPFH histogram (11 theta, 11 alpha, 11 phi bins,
each block summing to 100) at every neighbour of every keypoint, over ALL
valid in-radius points of the cloud (the SPFH sweep kernel,
kernels/spfh.py); then FPFH(keypoint) = sum over its nearest `max_neighbors`
in-radius neighbours j at distance > 0 of SPFH_j / d_j, each 11-bin block
renormalised to 100. Keypoints with no weighted neighbour are invalid.

Two engines, dispatched as every neighbour op (ops/neighbors.py):
- dense: the kernel's shared-candidate mode, every neighbour row against
  the whole cloud (duplicate neighbours are recomputed);
- grid: one grid of the valid surface at the descriptor radius serves the
  keypoint neighbourhoods (small-Q path) and the SPFH sweep. The sweep
  computes each needed point's SPFH once (the deduplicated union of the
  neighbourhoods) through the kernel's grid entry, one launch per cloud that
  reads the grid in place and sweeps only the needed slots. Bucket overflow
  is the only cap, counted by the feature stage's probe.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.kernels import spfh as spfh_kernel
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.grid import build_grid, masked_query_grid
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import _resolve_engine
from mapmerge_torch.ops.normals import SurfaceNormals

_BINS = 11


def _spfh_dense(
    q_xyz: torch.Tensor,  # (K, M, 3)
    q_nrm: torch.Tensor,  # (K, M, 3)
    q_ok: torch.Tensor,  # (K, M)
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH (K, M, 33) at the given oriented query points + validity (K, M).

    Shared-candidate sweep: every query sees the whole cloud. Masked-out
    queries are swept too; their FAR coordinates fail every radius test."""
    p_ok = cloud.mask & normals.valid
    spfh, total = spfh_kernel.spfh_tile(
        q_xyz.contiguous(), q_nrm.contiguous(),
        cloud.xyz[None].contiguous(), normals.normals[None].contiguous(),
        p_ok[None].contiguous(), r2=float(radius) * float(radius),
    )
    return spfh, q_ok & (total > 0)


def _spfh_grid(
    cloud: PointCloud,
    normals: SurfaceNormals,
    needed: torch.Tensor,
    radius: float,
    grid,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH (P, 33) at every cloud point flagged `needed` + pair counts (P,).

    `grid` is the cloud's valid surface at `radius`; the query slots are
    derived from it by masking (the queries are its own points), so the
    stage sorts the cloud once. The kernel's grid entry sweeps those slots
    against the grid in one launch."""
    qg = masked_query_grid(grid, needed & cloud.mask & normals.valid, cloud.capacity)
    return spfh_kernel.spfh_grid(
        grid, qg.cell_ok, normals.normals.contiguous(), float(radius) * float(radius)
    )


def compute_fpfh(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """FPFH-33 at each keypoint over the cloud surface."""
    n = cloud.capacity
    if _resolve_engine(engine, n) == "grid":
        grid = build_grid(cloud.xyz, cloud.mask & normals.valid, radius, None, scan_cap)
        idx, d2, nmask = keypoint_neighborhoods(
            cloud, normals, keypoints, radius, max_neighbors, tile, engine,
            scan_cap=scan_cap, grid=grid,
        )
        # each cloud point in any neighbourhood gets its SPFH computed once
        needed = torch.zeros((n + 1,), dtype=torch.bool, device=cloud.device)
        needed[torch.where(nmask, idx, n).reshape(-1)] = True
        spfh_all, npairs = _spfh_grid(cloud, normals, needed[:n], radius, grid)
        spfh = spfh_all[idx]
        spfh_ok = (npairs[idx] > 0) & nmask
    else:
        idx, d2, nmask = keypoint_neighborhoods(
            cloud, normals, keypoints, radius, max_neighbors, tile, engine,
            scan_cap=scan_cap,
        )
        # SPFH only at the gathered neighbour points (PCL
        # computeSPFHSignatures); duplicates are recomputed
        spfh, spfh_ok = _spfh_dense(
            cloud.xyz[idx], normals.normals[idx], nmask, cloud, normals, radius,
        )

    dist = torch.sqrt(d2.clamp_min(0.0))
    w = torch.where(
        nmask & spfh_ok & (dist > 1e-9),
        torch.reciprocal(dist.clamp_min(1e-9)),
        0.0,
    )  # (K, M)
    fpfh = torch.einsum("km,kmd->kd", w, spfh)

    # renormalise each 11-bin block to sum 100
    blocks = fpfh.reshape(-1, 3, _BINS)
    sums = blocks.sum(dim=-1, keepdim=True)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=cloud.device)
    blocks = torch.where(sums > 0, blocks * (hundred / sums.clamp_min(1e-9)), 0.0)
    data = blocks.reshape(-1, 3 * _BINS)

    valid = keypoints.mask & (w.sum(dim=-1) > 0)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
