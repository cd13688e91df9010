"""SIFT's dense octave: the CUDA kernels of `csrc/sift.cu` and their plain
PyTorch versions.

Kernel C, `scale_space`: the Gaussian scale space of one octave on the
dense engine, every sigma in one launch (the dense branch of
mapmerge_tpu/ops/keypoints/sift.py `_scale_space`). Kernel D, `knn`: the
26 nearest neighbours of the extremum test, by (d2, index) with masked
targets at d2 = BIG (the dense `radius_neighbors` that the reference's
sift.py calls with k = 26). Neither is a TPU kernel: the JAX package leaves
both to XLA.

Both take coordinates centred on the valid mean (ops/neighbors._center)
and compute d2 as `ops/neighbors.sq_dists` does, bit for bit.

- `scale_space` agrees with `scale_space_ref` to rounding: the kernel
  divides by 2 s^2 and sums in point order, the plain version's exp, product
  and matrix-vector product round and sum otherwise on each device. A
  point's inclusion (d2 <= r2_bound, valid) is the same bits on both. The
  tolerance held on the card is SCALE_SPACE_RTOL of the field's largest
  magnitude.
- `knn` equals `knn_ref` exactly: the k smallest (d2, index) pairs are
  unique, and both break ties by the lower index, as lax.top_k does.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The plain versions serve CPU tensors and the checks of the kernels.
"""

from __future__ import annotations

import torch

from mapmerge_torch.kernels import build
from mapmerge_torch.ops.neighbors import BIG, sq_dists, tiled_query

#: the kernel's scale space against its plain version, on the card: the
#: largest difference within this share of the field's largest magnitude
#: (float32 rounding of exp, the division and the sums' order)
SCALE_SPACE_RTOL = 1e-5
#: the longest neighbour list kernel D keeps (csrc/sift.cu: kK)
MAX_K = 26
#: blocks the point splits aim at: the splits depend on Q and P alone, so
#: the kernels' bits do not depend on the card's SM count
_TARGET_BLOCKS = 2048
#: fewest points per split
_MIN_SPLIT = 256
#: queries per block (csrc/sift.cu: kQueries for C, kThreads for D)
_C_BLOCK_QUERIES = 512
_D_BLOCK_QUERIES = 128

SCALE_SPACE_KERNEL = build.Kernel(
    name="sift_scale_space",
    source="mapmerge_torch/csrc/sift.cu",
    replaces="mapmerge_tpu/ops/keypoints/sift.py:59",
)
KNN_KERNEL = build.Kernel(
    name="sift_knn",
    source="mapmerge_torch/csrc/sift.cu",
    replaces="mapmerge_tpu/ops/neighbors.py:151",
)


def scale_space(
    qc: torch.Tensor,
    pc: torch.Tensor,
    vals: torch.Tensor,
    mask: torch.Tensor,
    sigmas: list[float],
    r2_bound: float,
    tile: int = 1024,
) -> torch.Tensor:
    """Gaussian-smoothed values for every sigma: (S, Q) float32.

    qc (Q, 3) and pc (P, 3) centred alike; vals (P,) zero where masked;
    mask (P,) bool. Each query's weights exp(-d2 / (2 s^2)) over the valid
    points with d2 <= r2_bound; out = sum(w * val) / max(sum(w), 1e-12). A
    CPU tensor takes the plain version (in query tiles of `tile`); a CUDA
    tensor launches the kernel or raises."""
    if qc.device.type == "cpu":
        return scale_space_ref(qc, pc, vals, mask, sigmas, r2_bound, tile)
    kernel = SCALE_SPACE_KERNEL
    dev = _cuda(kernel, qc)
    nq, np_, ns = qc.shape[0], pc.shape[0], len(sigmas)
    build.require("qc", qc, torch.float32, (None, 3), dev)
    build.require("pc", pc, torch.float32, (None, 3), dev)
    build.require("vals", vals, torch.float32, (np_,), dev)
    build.require("mask", mask, torch.bool, (np_,), dev)
    if np_ == 0 or not 1 <= ns <= 65535 or max(nq, np_) >= 2**31 // 3:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_} S={ns}")
    out = torch.empty((ns, nq), dtype=torch.float32, device=dev)
    if nq == 0:
        return out
    # the float32 value of 2 s^2 that `-d2 / (2.0 * s * s)` divides by
    two_s2 = torch.tensor([2.0 * s * s for s in sigmas], dtype=torch.float32).to(dev)
    splits = _splits(nq, np_, _C_BLOCK_QUERIES)
    part_num = torch.empty((splits, ns, nq), dtype=torch.float32, device=dev)
    part_den = torch.empty_like(part_num)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_sift_scale_space(
            qc.data_ptr(), nq, pc.data_ptr(), vals.data_ptr(), mask.data_ptr(),
            np_, two_s2.data_ptr(), ns, r2_bound, splits, part_num.data_ptr(),
            part_den.data_ptr(), out.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return out


def knn(
    q: torch.Tensor,
    p: torch.Tensor,
    p_mask: torch.Tensor | None,
    k: int,
    r2: float,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest p-points of each query by (d2, index), nearest first,
    masked targets at d2 = BIG: (idx (Q, k) int32, valid (Q, k) bool, d2 <=
    r2). q and p centred alike; k <= min(MAX_K, P). A CPU tensor takes the
    plain version (in query tiles of `tile`); a CUDA tensor launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return knn_ref(q, p, p_mask, k, r2, tile)
    kernel = KNN_KERNEL
    dev = _cuda(kernel, q)
    nq, np_ = q.shape[0], p.shape[0]
    build.require("q", q, torch.float32, (None, 3), dev)
    build.require("p", p, torch.float32, (None, 3), dev)
    if p_mask is not None:
        build.require("p_mask", p_mask, torch.bool, (np_,), dev)
    if not 1 <= k <= min(MAX_K, np_) or max(nq, np_) >= 2**31 // MAX_K:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_} k={k}")
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    valid = torch.empty((nq, k), dtype=torch.bool, device=dev)
    if nq == 0:
        return idx, valid
    splits = _splits(nq, np_, _D_BLOCK_QUERIES)
    part_d2 = torch.empty((splits, MAX_K, nq), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, MAX_K, nq), dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_sift_knn(
            q.data_ptr(), nq, p.data_ptr(),
            None if p_mask is None else p_mask.data_ptr(), np_, k, r2, splits,
            part_d2.data_ptr(), part_idx.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return idx, valid


def _cuda(kernel: build.Kernel, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {t.device}")
    return t.device


def _splits(nq: int, np_: int, block_queries: int) -> int:
    """Point splits for about _TARGET_BLOCKS blocks, each split at least
    _MIN_SPLIT points: many where Q is small (config5's octaves of a few
    thousand points), few at config #1's 32,768."""
    tiles = -(-nq // block_queries)
    want = -(-_TARGET_BLOCKS // tiles)
    return max(1, min(want, -(-np_ // _MIN_SPLIT), 65535))


def scale_space_ref(
    qc: torch.Tensor,
    pc: torch.Tensor,
    vals: torch.Tensor,
    mask: torch.Tensor,
    sigmas: list[float],
    r2_bound: float,
    tile: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch scale space (the dense branch of the parent's
    `ops/keypoints/sift._scale_space`): per query tile, the (tile, P)
    distance slab, the bound-and-mask weights of each sigma, a
    matrix-vector product and a row sum. (S, Q)."""
    maskf = mask.to(torch.float32)

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        bounded = (d2 <= r2_bound).to(torch.float32) * maskf[None, :]
        outs = []
        for s in sigmas:
            w = torch.exp(-d2 / (2.0 * s * s)) * bounded
            num = w @ vals
            den = w.sum(dim=-1)
            outs.append(num / den.clamp_min(1e-12))
        return torch.stack(outs, dim=-1)  # (tile, S)

    if qc.shape[0] == 0:
        return torch.empty((len(sigmas), 0), dtype=torch.float32, device=qc.device)
    return tiled_query(qc, tile_fn, tile).T


def knn_ref(
    q: torch.Tensor,
    p: torch.Tensor,
    p_mask: torch.Tensor | None,
    k: int,
    r2: float,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch k-NN: per query tile, the (tile, P) slab of sq_dists
    with masked targets at BIG, sorted stably (ties keep the lower index),
    the first k taken."""

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, p)
        if p_mask is not None:
            d2 = torch.where(p_mask[None, :], d2, BIG)
        d2s, order = torch.sort(d2, dim=-1, stable=True)
        return order[:, :k].to(torch.int32), d2s[:, :k] <= r2

    if q.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=q.device),
                torch.empty((0, k), dtype=torch.bool, device=q.device))
    return tiled_query(q, tile_fn, tile)
