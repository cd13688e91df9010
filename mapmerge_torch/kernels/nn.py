"""Exact 1-nearest-neighbour: the CUDA kernel `csrc/nn.cu` and its plain
PyTorch version.

Replaces the Pallas TPU kernel mapmerge_tpu/pallas/nn.py
(`nearest_neighbor_pallas`). Both versions use the direct (q - p)^2
expansion (no centring, no matmul), add BIG to the squared distance of masked
targets, and resolve ties to the first occurrence. The kernel rounds each
operation as the plain version does, so the two agree bit for bit; see the
source note in csrc/nn.cu for what bounds the kernel on the card.
"""

from __future__ import annotations

import torch

from mapmerge_torch.kernels import build

#: squared-distance penalty for masked targets (ops/neighbors.BIG)
BIG = 1.0e12
#: elements per (Q, chunk) distance plane of the plain version
_PLANE = 1 << 22

KERNEL = build.Kernel(
    name="nearest_neighbor",
    source="mapmerge_torch/csrc/nn.cu",
    replaces="mapmerge_tpu/pallas/nn.py:82",
)


def nearest_neighbor(
    q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (idx (Q,) int32, squared distance (Q,) float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return nearest_neighbor_ref(q, p, p_mask)
    if q.device.type != "cuda":
        raise ValueError(f"nearest_neighbor: unsupported device {q.device}")
    dev = q.device
    nq, np_ = q.shape[0], p.shape[0]
    build.require("q", q, torch.float32, (None, 3), dev)
    build.require("p", p, torch.float32, (None, 3), dev)
    if p_mask is not None:
        build.require("p_mask", p_mask, torch.bool, (np_,), dev)
    if np_ == 0 or max(nq, np_) >= 2**31 // 3:
        raise ValueError(f"nearest_neighbor: unsupported sizes Q={nq} P={np_}")
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    d2 = torch.empty((nq,), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_nearest_neighbor(
            q.data_ptr(), nq, p.data_ptr(),
            None if p_mask is None else p_mask.data_ptr(), np_,
            idx.data_ptr(), d2.data_ptr(), build.stream_handle(dev),
        )
    KERNEL.launches += 1
    build.check_launch(KERNEL, err)
    return idx, d2


def nearest_neighbor_ref(
    q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch 1-NN: direct expansion, chunked over P to bound memory,
    with a running (min, argmin) that keeps the first occurrence."""
    nq, np_ = q.shape[0], p.shape[0]
    pen = torch.zeros((np_,), dtype=torch.float32, device=q.device)
    if p_mask is not None:
        pen = torch.where(p_mask, pen, BIG)
    best_d2 = torch.full((nq,), float("inf"), dtype=torch.float32, device=q.device)
    best_idx = torch.zeros((nq,), dtype=torch.int32, device=q.device)
    chunk = max(1, _PLANE // max(nq, 1))
    for s in range(0, np_, chunk):
        pc = p[s : s + chunk]
        dx = q[:, 0:1] - pc[None, :, 0]
        dy = q[:, 1:2] - pc[None, :, 1]
        dz = q[:, 2:3] - pc[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz + pen[None, s : s + chunk]
        m, a = d2.min(dim=1)  # first occurrence within the chunk
        better = m < best_d2  # strict: earlier chunks win ties
        best_idx = torch.where(better, a.to(torch.int32) + s, best_idx)
        best_d2 = torch.where(better, m, best_d2)
    return best_idx, best_d2
