"""SPFH sweep: the CUDA kernel `csrc/spfh.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel mapmerge_tpu/pallas/spfh.py
(`spfh_tile_pallas`). For every oriented query, the Darboux pair features
against every candidate within r2 go into 11 theta, 11 alpha and 11 phi bins
plus a pair count; each row is scaled to sum 100. The math is that of the
plain/XLA path of the reference (`fpfh._spfh_dense`): atan2 theta and
floor-and-clip binning. See csrc/spfh.cu for what bounds the kernel.

Candidates come with a leading dimension Bc in {1, B}: Bc = 1 is the
shared-candidate mode of the dense FPFH sweep (every query sees the same
cloud); Bc = B is the per-cell mode of the grid engine.
"""

from __future__ import annotations

import torch

from mapmerge_torch.kernels import build
from mapmerge_torch.ops.descriptors.darboux import bin_index, pair_features

_BINS = 11
_PI = 3.141592653589793
#: pairs per (rows, M) plane of the plain version
_PLANE = 1 << 22

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
    # shared candidates: all B*Cq queries form one batch over one cloud
    rows, batches, stride = (b * cq, 1, 0) if bc == 1 else (cq, b, m)
    if rows >= 128 * 65535 or max(m, b * cq) >= 2**31 // 3:
        raise ValueError(f"spfh_tile: unsupported sizes B={b} Cq={cq} M={m}")
    if rows == 0 or batches == 0:
        return hist, total
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_spfh(
            q_xyz.data_ptr(), q_nrm.data_ptr(), rows, batches,
            cand_xyz.data_ptr(), cand_nrm.data_ptr(), cand_ok.data_ptr(), m,
            stride, float(r2), hist.data_ptr(), total.data_ptr(),
            build.stream_handle(dev),
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
