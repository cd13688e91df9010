"""Exact 1-nearest-neighbour: the CUDA kernel `csrc/nn.cu` and its plain
PyTorch version.

Replaces the Pallas TPU kernel mapmerge_tpu/pallas/nn.py
(`nearest_neighbor_pallas`). Both versions use the direct (q - p)^2
expansion (no centring, no matmul), add BIG to the squared distance of masked
targets, and resolve ties to the first occurrence. The kernel rounds each
operation as the plain version does, so the two agree bit for bit; see the
source note in csrc/nn.cu for what bounds the kernel on the card and how
its grid splits the targets.

`nearest_neighbor_batched` is the same kernel over a leading pair axis: B
problems of one shape in one launch (the batched pair stage's ICP and
score), each row the bits `nearest_neighbor` gives on that pair alone. It
counts its launches apart (`BATCHED_KERNEL`), so a run shows which entry
it went through.
"""

from __future__ import annotations

import functools

import torch

from mapmerge_torch.kernels import build

#: squared-distance penalty for masked targets (ops/neighbors.BIG)
BIG = 1.0e12
#: elements per (Q, chunk) distance plane of the plain version
_PLANE = 1 << 22
#: queries per block of the kernel (csrc/nn.cu: kQueries)
_BLOCK_QUERIES = 512
#: blocks per SM the target splits aim at: many short blocks keep the
#: tail of the grid short (16 measured fastest of 4-32 at 32768^2, PERF.md)
_BLOCKS_PER_SM = 16
#: fewest targets per split
_MIN_SPLIT = 256

KERNEL = build.Kernel(
    name="nearest_neighbor",
    source="mapmerge_torch/csrc/nn.cu",
    replaces="mapmerge_tpu/pallas/nn.py:82",
)
BATCHED_KERNEL = build.Kernel(
    name="nearest_neighbor_batched",
    source="mapmerge_torch/csrc/nn.cu",
    replaces="mapmerge_tpu/pallas/nn.py:82",
)


def nearest_neighbor(
    q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (idx (Q,) int32, squared distance (Q,) float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (a batch of one) or raises."""
    if q.device.type == "cpu":
        return nearest_neighbor_ref(q, p, p_mask)
    idx, d2 = _launch(
        KERNEL, q[None], p[None], None if p_mask is None else p_mask[None]
    )
    return idx[0], d2[0]


def nearest_neighbor_batched(
    q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each pair of a batch: q (B, Q, 3), p (B, P, 3), p_mask
    (B, P) -> (idx (B, Q) int32, squared distance (B, Q) float32), in one
    launch.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return nearest_neighbor_batched_ref(q, p, p_mask)
    return _launch(BATCHED_KERNEL, q, p, p_mask)


def _launch(
    kernel: build.Kernel, q: torch.Tensor, p: torch.Tensor,
    p_mask: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of mm_nearest_neighbor_batched on (B, Q, 3) x (B, P, 3),
    counted on `kernel`."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {q.device}")
    dev = q.device
    nb, nq, np_ = q.shape[0], q.shape[1], p.shape[1]
    build.require("q", q, torch.float32, (None, None, 3), dev)
    build.require("p", p, torch.float32, (nb, None, 3), dev)
    if p_mask is not None:
        build.require("p_mask", p_mask, torch.bool, (nb, np_), dev)
    if np_ == 0 or not 1 <= nb <= 65535 or max(nq, np_) >= 2**31 // 3:
        raise ValueError(f"{kernel.name}: unsupported sizes B={nb} Q={nq} P={np_}")
    idx = torch.empty((nb, nq), dtype=torch.int32, device=dev)
    d2 = torch.empty((nb, nq), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, d2
    splits = _splits(nb * nq, np_, _sm_count(dev.index))
    part_idx = torch.empty((nb, splits, nq), dtype=torch.int32, device=dev)
    part_d2 = torch.empty((nb, splits, nq), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_nearest_neighbor_batched(
            q.data_ptr(), nb, nq, p.data_ptr(),
            None if p_mask is None else p_mask.data_ptr(), np_, splits,
            part_idx.data_ptr(), part_d2.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return idx, d2


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(nq: int, np_: int, sms: int) -> int:
    """Target splits for about _BLOCKS_PER_SM blocks per SM, each split
    at least _MIN_SPLIT targets (`nq`: the queries of the whole batch, so a
    batch that fills the card already takes one split)."""
    tiles = -(-nq // _BLOCK_QUERIES)
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    return max(1, min(want, -(-np_ // _MIN_SPLIT), 65535))


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


def nearest_neighbor_batched_ref(
    q: torch.Tensor, p: torch.Tensor, p_mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch batched 1-NN: `nearest_neighbor_ref` on each pair."""
    rows = [
        nearest_neighbor_ref(q[b], p[b], None if p_mask is None else p_mask[b])
        for b in range(q.shape[0])
    ]
    if not rows:
        return (torch.empty(q.shape[:2], dtype=torch.int32, device=q.device),
                torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))
    return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
