"""SPFH sweep: the CUDA kernel `csrc/spfh.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel mapmerge_tpu/pallas/spfh.py
(`spfh_tile_pallas`). For every oriented query, the Darboux pair features
against every candidate within r2 go into 11 theta, 11 alpha and 11 phi bins
plus a pair count; each row is scaled to sum 100. The math is that of the
plain/XLA path of the reference (`fpfh._spfh_dense`): atan2 theta and
floor-and-clip binning. See csrc/spfh.cu for what bounds the kernel.

Candidates come with a leading dimension Bc in {1, B}: Bc = 1 is the
shared-candidate mode of the dense FPFH sweep (every query sees the same
cloud); Bc = B is the per-cell mode of the grid engine (fpfh._spfh_grid:
one batch per bucket, Cq = 128 slots against M = 27 x 128 candidates, B a
grid_query chunk of 151 buckets; B x M <= PAIRS_PER_CHUNK / Cq = 2^26 / Cq
stays far inside the size guard below).

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

import math

import torch

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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q_xyz.device.type == "cpu":
        return spfh_ref(q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok, r2)
    if q_xyz.device.type != "cuda":
        raise ValueError(f"spfh_tile: unsupported device {q_xyz.device}")
    dev = q_xyz.device
    b, cq = q_xyz.shape[0], q_xyz.shape[1]
    bc, m = cand_xyz.shape[0], cand_xyz.shape[1]
    f32 = torch.float32
    build.require("q_xyz", q_xyz, f32, (b, cq, 3), dev)
    build.require("q_nrm", q_nrm, f32, (b, cq, 3), dev)
    build.require("cand_xyz", cand_xyz, f32, (bc, m, 3), dev)
    build.require("cand_nrm", cand_nrm, f32, (bc, m, 3), dev)
    build.require("cand_ok", cand_ok, torch.bool, (bc, m), dev)
    if bc not in (1, b):
        raise ValueError(f"spfh_tile: candidate batch {bc} is neither 1 nor {b}")
    hist = torch.empty((b, cq, 3 * _BINS), dtype=f32, device=dev)
    total = torch.empty((b, cq), dtype=f32, device=dev)
    if cq >= 128 * 65535 or max(bc * m, b * cq) >= 2**31 // 3:
        raise ValueError(f"spfh_tile: unsupported sizes B={b} Cq={cq} M={m}")
    if b * cq == 0:
        return hist, total
    lib = build.load()
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        if bc == 1:
            # one group of rows per block: one keypoint's neighbours where
            # Cq holds them, all within r of the keypoint
            group = -(-cq // -(-cq // _GROUP_MAX))
            # bucket counts, starts, cursors and each candidate's bucket;
            # the candidates gathered by bucket
            ints = torch.empty((3 * _TABLE + 1 + m,), dtype=torch.int32, device=dev)
            gathered = torch.empty((2, m, 4), dtype=f32, device=dev)
            err = lib.mm_spfh_shared(
                q_xyz.data_ptr(), q_nrm.data_ptr(), b * cq, group,
                cand_xyz.data_ptr(), cand_nrm.data_ptr(), cand_ok.data_ptr(),
                m, math.sqrt(r2) * _CELL_MARGIN, float(r2),
                float(r2) * _R2_MARGIN, ints.data_ptr(), gathered.data_ptr(),
                hist.data_ptr(), total.data_ptr(), stream,
            )
        else:
            err = lib.mm_spfh_cell(
                q_xyz.data_ptr(), q_nrm.data_ptr(), cq, b,
                cand_xyz.data_ptr(), cand_nrm.data_ptr(), cand_ok.data_ptr(),
                m, float(r2), hist.data_ptr(), total.data_ptr(), stream,
            )
    KERNEL.launches += 1
    build.check_launch(KERNEL, err)
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
