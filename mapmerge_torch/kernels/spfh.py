"""SPFH sweep: the CUDA kernel `csrc/spfh.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel mapmerge_tpu/pallas/spfh.py
(`spfh_tile_pallas`). For every oriented query, the Darboux pair features
against every candidate within r2 go into 11 theta, 11 alpha and 11 phi bins
plus a pair count; each row is scaled to sum 100. The math is that of the
plain/XLA path of the reference (`fpfh._spfh_dense`): atan2 theta and
floor-and-clip binning. See csrc/spfh.cu for what bounds the kernel.

Two entries. `spfh_tile` is the shared-candidate mode of the dense FPFH
sweep: (B, Cq) queries, every one against the same candidate cloud (Bc = 1).
`spfh_grid` is the grid engine's sweep (fpfh._spfh_grid): the needed slots
of a cloud's cell grid (core/grid.py) against the filled slots of the 27
wrapped neighbour buckets of their own, one launch per cloud, rows written
in point order. `spfh_ref` keeps the per-bucket form (Bc = B, batch i's
queries against batch i's candidates), which the grid entry's plain version
runs over grid_query's blocks.

In shared mode the launch first bins the ok candidates by cell on the
card (csrc/spfh.cu: count, scan, scatter): cells of edge r (1 + 1e-3),
their integer coordinates hashed into a table of 2^15 buckets (no host read
of the cloud's extent), the candidates gathered by bucket. The sweep then
reads only the buckets of the 27 cells around each query. The 1e-3 margin
keeps an in-radius pair in neighbouring cells despite the rounding of
x / cell, for coordinates within about 4,000 cells of the origin (3 km at
r = 0.8 m); a collision only adds candidates that fail the radius test.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mapmerge_torch.core.grid import CellGrid, grid_query
from mapmerge_torch.kernels import build
from mapmerge_torch.ops.descriptors.darboux import bin_index, pair_features

_BINS = 11
_PI = 3.141592653589793
#: pairs per (rows, M) plane of the plain version
_PLANE = 1 << 22
#: hash buckets of the shared sweep's cells (csrc/spfh.cu: kTable)
_TABLE = 1 << 15
#: cell edge over the radius
_CELL_MARGIN = 1.0 + 1e-3
#: most queries a block of the shared sweep takes (csrc/spfh.cu: kGroupMax)
_GROUP_MAX = 64
#: queries a block of the grid sweep takes (csrc/spfh.cu: kGridGroup)
_GRID_GROUP = 32
#: squared-radius margin of the kernel's first distance test; a pair whose
#: rounded sqrt passes r2 has d2 <= r2 (1 + 2.4e-7)
_R2_MARGIN = 1.0 + 1e-5

KERNEL = build.Kernel(
    name="spfh",
    source="mapmerge_torch/csrc/spfh.cu",
    replaces="mapmerge_tpu/pallas/spfh.py:168",
)


def spfh_tile(
    q_xyz: torch.Tensor,  # (B, Cq, 3)
    q_nrm: torch.Tensor,  # (B, Cq, 3)
    cand_xyz: torch.Tensor,  # (Bc, M, 3)
    cand_nrm: torch.Tensor,  # (Bc, M, 3)
    cand_ok: torch.Tensor,  # (Bc, M) bool
    r2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH histograms ((B, Cq, 33) float32, pair counts (B, Cq) float32).

    A CPU tensor takes the plain version (either candidate batch, Bc in
    {1, B}); a CUDA tensor launches the shared-candidate kernel (Bc = 1) or
    raises."""
    if q_xyz.device.type == "cpu":
        return spfh_ref(q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok, r2)
    if q_xyz.device.type != "cuda":
        raise ValueError(f"spfh_tile: unsupported device {q_xyz.device}")
    dev = q_xyz.device
    b, cq = q_xyz.shape[0], q_xyz.shape[1]
    bc, m = cand_xyz.shape[0], cand_xyz.shape[1]
    if bc != 1:
        raise ValueError(
            f"spfh_tile: candidate batch {bc}; the kernel takes one candidate "
            "cloud (Bc = 1); per-bucket candidates go through spfh_grid"
        )
    f32 = torch.float32
    build.require("q_xyz", q_xyz, f32, (b, cq, 3), dev)
    build.require("q_nrm", q_nrm, f32, (b, cq, 3), dev)
    build.require("cand_xyz", cand_xyz, f32, (1, m, 3), dev)
    build.require("cand_nrm", cand_nrm, f32, (1, m, 3), dev)
    build.require("cand_ok", cand_ok, torch.bool, (1, m), dev)
    hist = torch.empty((b, cq, 3 * _BINS), dtype=f32, device=dev)
    total = torch.empty((b, cq), dtype=f32, device=dev)
    if max(m, b * cq) >= 2**31 // 3:
        raise ValueError(f"spfh_tile: unsupported sizes B={b} Cq={cq} M={m}")
    if b * cq == 0:
        return hist, total
    lib = build.load()
    # one group of rows per block: one keypoint's neighbours where Cq holds
    # them, all within r of the keypoint
    group = -(-cq // -(-cq // _GROUP_MAX))
    with torch.cuda.device(dev):
        # bucket counts, starts, cursors and each candidate's bucket; the
        # candidates gathered by bucket
        ints = torch.empty((3 * _TABLE + 1 + m,), dtype=torch.int32, device=dev)
        gathered = torch.empty((2, m, 4), dtype=f32, device=dev)
        err = lib.mm_spfh_shared(
            q_xyz.data_ptr(), q_nrm.data_ptr(), b * cq, group,
            cand_xyz.data_ptr(), cand_nrm.data_ptr(), cand_ok.data_ptr(),
            m, math.sqrt(r2) * _CELL_MARGIN, float(r2),
            float(r2) * _R2_MARGIN, ints.data_ptr(), gathered.data_ptr(),
            hist.data_ptr(), total.data_ptr(), build.stream_handle(dev),
        )
    KERNEL.launched()
    build.check_launch(KERNEL, err)
    return hist, total


def spfh_grid(
    grid: CellGrid,
    q_ok: torch.Tensor,  # (H, C) bool
    normals: torch.Tensor,  # (P, 3)
    r2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SPFH at the needed slots of a cloud's cell grid, in point order:
    ((P, 33) float32 histograms, (P,) float32 pair counts).

    `grid` is the cloud's grid (ops/grid.build_grid: slot s of bucket h
    holds point cell_idx[h, s] where s < count[h]); `q_ok` marks the needed
    slots (ops/grid.masked_query_grid's cell_ok, a subset of the filled
    ones); `normals` are the cloud's, by point index. Each needed slot is
    swept against the filled slots of the distinct wrapped neighbour
    buckets of its bucket. Rows of points in no needed slot are zero.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch; none when no slot is needed) or raises."""
    if normals.device.type == "cpu":
        return spfh_grid_ref(grid, q_ok, normals, r2)
    if normals.device.type != "cuda":
        raise ValueError(f"spfh_grid: unsupported device {normals.device}")
    dev = normals.device
    h, cap = grid.cell_idx.shape
    p = normals.shape[0]
    gx, gy, gz = grid.dims
    build.require("cell_xyz", grid.cell_xyz, torch.float32, (h, cap, 3), dev)
    build.require("cell_idx", grid.cell_idx, torch.int64, (h, cap), dev)
    build.require("count", grid.count, torch.int32, (h,), dev)
    build.require("q_ok", q_ok, torch.bool, (h, cap), dev)
    build.require("normals", normals, torch.float32, (p, 3), dev)
    if gx * gy * gz != h or 3 * h * cap >= 2**31 or cap > _GRID_GROUP * 65535:
        raise ValueError(f"spfh_grid: unsupported grid H={h} C={cap} dims={grid.dims}")
    hist = torch.zeros((p, 3 * _BINS), dtype=torch.float32, device=dev)
    total = torch.zeros((p,), dtype=torch.float32, device=dev)
    # the buckets that hold a needed slot (one host read)
    active = torch.nonzero(q_ok.any(dim=1)).flatten().to(torch.int32)
    if active.numel() == 0:
        return hist, total
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_spfh_grid(
            grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(),
            grid.count.data_ptr(), q_ok.data_ptr(), active.data_ptr(),
            active.numel(), cap, gx, gy, gz, normals.data_ptr(), float(r2),
            float(r2) * _R2_MARGIN, hist.data_ptr(), total.data_ptr(),
            build.stream_handle(dev),
        )
    KERNEL.launched()
    build.check_launch(KERNEL, err)
    return hist, total


def spfh_grid_ref(
    grid: CellGrid, q_ok: torch.Tensor, normals: torch.Tensor, r2: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of spfh_grid: grid_query over the needed
    slots' buckets, each block through spfh_ref's per-bucket form (the
    candidates of core/grid._candidates, wrapped duplicates masked)."""
    qg = dataclasses.replace(
        grid, cell_ok=q_ok, count=q_ok.sum(dim=1).to(torch.int32)
    )

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, q_nrm, cand_nrm):
        return spfh_ref(q_block, q_nrm, cand_xyz, cand_nrm, cand_ok, r2)

    # with qg given, grid_query reads only the row count of its first operand
    (hist, total), _ = grid_query(
        normals, grid, tile_fn, (0.0, 0.0), q_values=normals,
        p_values=normals, qg=qg,
    )
    return hist, total


def spfh_ref(
    q_xyz: torch.Tensor,
    q_nrm: torch.Tensor,
    cand_xyz: torch.Tensor,
    cand_nrm: torch.Tensor,
    cand_ok: torch.Tensor,
    r2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SPFH: the `_spfh_dense` XLA-branch math, chunked over
    queries to bound the (rows, M) planes in flight."""
    b, cq = q_xyz.shape[0], q_xyz.shape[1]
    if b == 0:  # an empty chunk of grid buckets
        return q_xyz.new_zeros((0, cq, 3 * _BINS)), q_xyz.new_zeros((0, cq))
    if cand_xyz.shape[0] == 1:
        hist, total = _spfh_rows(
            q_xyz.reshape(-1, 3), q_nrm.reshape(-1, 3),
            cand_xyz[0], cand_nrm[0], cand_ok[0], r2,
        )
        return hist.reshape(b, cq, 3 * _BINS), total.reshape(b, cq)
    outs = [
        _spfh_rows(q_xyz[i], q_nrm[i], cand_xyz[i], cand_nrm[i], cand_ok[i], r2)
        for i in range(b)
    ]
    return (
        torch.stack([h for h, _ in outs]).reshape(b, cq, 3 * _BINS),
        torch.stack([t for _, t in outs]).reshape(b, cq),
    )


def _spfh_rows(qx, qn, cx, cn, cok, r2):
    """(Q, 33) scaled histograms and (Q,) pair counts of Q queries against
    one candidate set."""
    nq, m = qx.shape[0], cx.shape[0]
    dev = qx.device
    r2_t = torch.tensor(r2, dtype=torch.float32, device=dev)
    hundred = torch.tensor(100.0, dtype=torch.float32, device=dev)
    hist = torch.zeros((nq, 3 * _BINS), dtype=torch.float32, device=dev)
    total = torch.zeros((nq,), dtype=torch.float32, device=dev)
    rows = max(1, _PLANE // max(m, 1))
    for s in range(0, nq, rows):
        theta, alpha, phi, dist, pair_ok = pair_features(
            qx[s : s + rows, None, :], qn[s : s + rows, None, :],
            cx[None], cn[None],
        )
        w = (cok[None, :] & pair_ok & (dist * dist <= r2_t)).to(torch.float32)
        h = hist[s : s + rows]
        for k, (src, lo, hi) in enumerate(
            ((theta, -_PI, _PI), (alpha, -1.0, 1.0), (phi, -1.0, 1.0))
        ):
            idx = bin_index(src, lo, hi, _BINS).to(torch.int64) + k * _BINS
            h.scatter_add_(1, idx, w)  # exact: sums of 0/1 counts
        total[s : s + rows] = w.sum(dim=-1)
    scale = torch.where(total > 0, hundred / total.clamp_min(1.0), 0.0)
    return hist * scale[:, None], total
