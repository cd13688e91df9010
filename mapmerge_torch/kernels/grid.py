"""The cell-grid engine's sweeps: the CUDA kernels of `csrc/grid.cu` and
their plain PyTorch versions.

Kernel G, `nn_query`: the bounded 1-NN of each query against a target grid
whose cell edge is the bound (ops/grid.grid_nn_query: ICP every iteration,
and the transform score through grid_nearest_neighbor). Kernel H,
`moments`: the count, mean and covariance of each query's neighbourhood
(grid_neighbor_moments: the normals). Kernel I, `count`: the neighbour
count (grid_radius_count: outlier removal). None is a TPU kernel: the JAX
package leaves all three to XLA (mapmerge_tpu/ops/grid.py `grid_query`).

Each takes the target grid and the query grid of core/grid.build_grid and
reads both in place, one launch a call: one CTA a query bucket (a bucket
with no query exits at once, so nothing is read back to the host), one
thread a query slot, against the filled slots of the distinct wrapped
neighbour buckets of its bucket, in ascending bucket id, then slot order
(core/grid._candidates' order). The kernels read the target slots s <
count[h]; for a grid from build_grid that is exactly cell_ok, and every
caller's target grid comes from build_grid. The query side is the plain
version's: the query grid's slots with cell_ok set are answered, the rows
of the others (the queries the query-side cap dropped, masked queries) keep
the plain version's defaults.

- `nn_query` equals `nn_query_ref` bit for bit: idx and d2.
- `count` equals `count_ref` bit for bit, the include_self subtraction
  included.
- `moments` has `moments_ref`'s count exactly; its mean and covariance
  agree to rounding: the kernel sums each query's members in candidate
  order, the plain version by torch's reduction tree. The tolerance held on
  the card is F's, kernels/radius.MOMENTS_RTOL of each query's largest
  second moment about the query (kernels/radius.moments_error with the
  queries as the origin).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrappers copy nothing to the host and never synchronise.

The plain versions run core/grid.grid_query; ops/grid.py calls the
wrappers.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core import grid as cgrid
from mapmerge_torch.kernels import build

NN_KERNEL = build.Kernel(
    name="grid_nn",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:594",
)
MOMENTS_KERNEL = build.Kernel(
    name="grid_moments",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:754",
)
COUNT_KERNEL = build.Kernel(
    name="grid_count",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:397",
)


def nn_query(grid, qg, q: torch.Tensor, n_p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounded 1-NN of the queries q (Q, 3) against the target grid `grid`
    (cell edge = the bound), through their query grid `qg`
    (build_grid(q, q_mask, grid's cell, dims and cap)): (idx (Q,) int32, d2
    (Q,) float32); d2 = BIG and the first candidate's index where nothing
    lies within the bound, (0, BIG) for a query in no answered slot; an
    index >= n_p becomes 0. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel G or raises."""
    if q.device.type == "cpu":
        return nn_query_ref(grid, qg, q, n_p)
    kernel = NN_KERNEL
    dev, nq, dims = _operands(kernel, grid, qg, q)
    if n_p >= 2**31:
        raise ValueError(f"{kernel.name}: unsupported target size {n_p}")
    idx = torch.zeros((nq,), dtype=torch.int32, device=dev)
    d2 = torch.full((nq,), cgrid.BIG, dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_grid_nn(
            grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(), grid.count.data_ptr(),
            qg.cell_xyz.data_ptr(), qg.cell_idx.data_ptr(), qg.cell_ok.data_ptr(),
            qg.count.data_ptr(), *dims, _nn_r2(grid), n_p, idx.data_ptr(),
            d2.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return idx, d2


def moments(
    grid, qg, q: torch.Tensor, r2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count (Q,), mean (Q, 3) and covariance (Q, 3, 3) float32 of each
    query's members (the target points with d2 <= r2), summed over the
    query-centred offsets; zeros for a query in no answered slot. Operands
    and routes as `nn_query`'s; kernel H."""
    if q.device.type == "cpu":
        return moments_ref(grid, qg, q, r2)
    kernel = MOMENTS_KERNEL
    dev, nq, dims = _operands(kernel, grid, qg, q)
    s0 = torch.zeros((nq,), dtype=torch.float32, device=dev)
    mean = torch.zeros((nq, 3), dtype=torch.float32, device=dev)
    cov = torch.zeros((nq, 3, 3), dtype=torch.float32, device=dev)
    if nq == 0:
        return s0, mean, cov
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_grid_moments(
            grid.cell_xyz.data_ptr(), grid.count.data_ptr(), qg.cell_xyz.data_ptr(),
            qg.cell_idx.data_ptr(), qg.cell_ok.data_ptr(), qg.count.data_ptr(), *dims,
            r2, s0.data_ptr(), mean.data_ptr(), cov.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return s0, mean, cov


def count(
    grid, qg, q: torch.Tensor, r2: float, include_self: bool = True
) -> torch.Tensor:
    """(Q,) int32: the target points with d2 <= r2 of each query, minus 1
    without include_self (0 - 1 for a query in no answered slot, as the
    plain version). Operands and routes as `nn_query`'s; kernel I."""
    if q.device.type == "cpu":
        return count_ref(grid, qg, q, r2, include_self)
    kernel = COUNT_KERNEL
    dev, nq, dims = _operands(kernel, grid, qg, q)
    sub = 0 if include_self else 1
    out = torch.full((nq,), -sub, dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_grid_count(
            grid.cell_xyz.data_ptr(), grid.count.data_ptr(), qg.cell_xyz.data_ptr(),
            qg.cell_idx.data_ptr(), qg.cell_ok.data_ptr(), qg.count.data_ptr(), *dims,
            r2, sub, out.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return out


def _nn_r2(grid) -> float:
    """The bounded 1-NN's squared bound: the cell edge squared, in float32."""
    return cgrid._f32(grid.cell_size * grid.cell_size)


def _operands(kernel: build.Kernel, grid, qg, q: torch.Tensor):
    """(device, Q, (H, cap, Gx, Gy, Gz)) of a launch: both grids checked to
    be ones the kernel indexes (build_grid's tensors, one layout and cap, H =
    Gx Gy Gz, offsets within int32 a coordinate), else a raise."""
    dev = build.cuda_device(kernel, q)
    nq = q.shape[0]
    h, cap = grid.cell_idx.shape
    gx, gy, gz = grid.dims
    build.require(f"{kernel.name}: q", q, torch.float32, (None, 3), dev)
    for name, g in (("grid", grid), ("qg", qg)):
        name = f"{kernel.name}: {name}"
        build.require(f"{name}.cell_xyz", g.cell_xyz, torch.float32, (h, cap, 3), dev)
        build.require(f"{name}.cell_idx", g.cell_idx, torch.int64, (h, cap), dev)
        build.require(f"{name}.cell_ok", g.cell_ok, torch.bool, (h, cap), dev)
        build.require(f"{name}.count", g.count, torch.int32, (h,), dev)
    if (tuple(qg.dims) != tuple(grid.dims) or qg.cap != cap or grid.cap != cap
            or gx * gy * gz != h or 27 * cap >= 2**31 or nq >= 2**31):
        raise ValueError(
            f"{kernel.name}: unsupported grids H={h} C={cap} dims={grid.dims} "
            f"(query grid dims={qg.dims} C={qg.cap}), Q={nq}"
        )
    return dev, nq, (h, cap, gx, gy, gz)


def nn_query_ref(grid, qg, q: torch.Tensor, n_p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch bounded 1-NN: core/grid.grid_query over the query
    buckets, each chunk's (B, Cq, 27 C) plane of _d2 with the empty,
    duplicated and out-of-bound candidates at BIG, its argmin (ties to the
    first candidate), then idx >= n_p -> 0."""
    r2 = _nn_r2(grid)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        d2 = cgrid._d2(q_block, cand_xyz)
        d2 = torch.where(cand_ok[:, None, :] & (d2 <= r2), d2, cgrid.BIG)
        j = torch.argmin(d2, dim=-1, keepdim=True)  # (B, Cq, 1)
        best = torch.gather(d2, -1, j)[..., 0]
        idx = torch.gather(cand_idx[:, None, :].expand(d2.shape), -1, j)[..., 0]
        return idx.to(torch.int32), best

    (idx, best), _ = cgrid.grid_query(q, grid, tile_fn, (0, cgrid.BIG), qg=qg)
    idx = torch.where(idx >= n_p, 0, idx)
    return idx, best


def moments_ref(
    grid, qg, q: torch.Tensor, r2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch moments: core/grid.grid_query over the query buckets,
    the candidates centred on the query, the {0,1} member weights and the
    sums of the weighted offsets and their products over the candidate
    axis."""

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        rx, ry, rz = (
            cand_xyz[:, None, :, c] - q_block[:, :, c : c + 1] for c in range(3)
        )  # (B, Cq, M) each
        d2 = rx * rx
        d2 += ry * ry
        d2 += rz * rz
        w = (cand_ok[:, None, :] & (d2 <= r2)).to(torch.float32)
        del d2
        wx, wy, wz = w * rx, w * ry, w * rz
        s0 = w.sum(dim=-1)
        s1 = torch.stack([wx.sum(-1), wy.sum(-1), wz.sum(-1)], dim=-1)
        sxx, sxy, sxz = (wx * rx).sum(-1), (wx * ry).sum(-1), (wx * rz).sum(-1)
        syy, syz, szz = (wy * ry).sum(-1), (wy * rz).sum(-1), (wz * rz).sum(-1)
        s2 = torch.stack(
            [
                torch.stack([sxx, sxy, sxz], -1),
                torch.stack([sxy, syy, syz], -1),
                torch.stack([sxz, syz, szz], -1),
            ],
            dim=-2,
        )
        denom = s0.clamp_min(1.0)[..., None]
        mean_rel = s1 / denom
        cov = s2 / denom[..., None] - mean_rel[..., :, None] * mean_rel[..., None, :]
        return s0, mean_rel + q_block, cov

    out, _ = cgrid.grid_query(q, grid, tile_fn, (0.0, 0.0, 0.0), qg=qg)
    return out


def count_ref(
    grid, qg, q: torch.Tensor, r2: float, include_self: bool = True
) -> torch.Tensor:
    """Plain PyTorch count: core/grid.grid_query over the query buckets,
    the row sums of each chunk's {0,1} member plane, then - 1 for every
    query without include_self."""

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        within = cand_ok[:, None, :] & (cgrid._d2(q_block, cand_xyz) <= r2)
        return within.sum(dim=-1).to(torch.int32)

    counts, _ = cgrid.grid_query(q, grid, tile_fn, 0, qg=qg)
    if not include_self:
        counts = counts - 1
    return counts
