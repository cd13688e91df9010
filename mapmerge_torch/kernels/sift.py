"""SIFT's dense octave: the CUDA kernels of `csrc/sift.cu` and their plain
PyTorch versions.

Kernel C, `scale_space`: the Gaussian scale space of one octave on the
dense engine, every sigma in one launch (the dense branch of
mapmerge_tpu/ops/keypoints/sift.py `_scale_space`). Kernel D, `knn`: the
26 nearest neighbours of the extremum test, by (d2, index) with masked
targets at d2 = BIG (the dense `radius_neighbors` that the reference's
sift.py calls with k = 26). Neither is a TPU kernel: the JAX package leaves
both to XLA. Both read the output of the tile pre-pass (`kernels/tiles.pack`:
the points, x = NaN where masked, and the box of each tile), by which C
and D skip, exactly, the tiles no query of a warp can reach. SIFT packs
each dense octave once, with its values, and hands the buffer to both
(`packed`); a wrapper given none packs its own points first.

Both take coordinates centred on the valid mean (ops/neighbors._center)
and compute d2 as `core/dense.sq_dists` does, bit for bit.

- `scale_space` agrees with `scale_space_ref` to rounding: the kernel
  multiplies by the float32 reciprocal of 2 s^2 and sums in point order in
  the 8 parts its lanes take (csrc/sift.cu: kCLanes), the plain version's
  exp, product and matrix-vector product round and sum otherwise on each
  device. A point's inclusion (d2 <= r2_bound, valid) is the same bits on
  both. The tolerance held on the card is SCALE_SPACE_RTOL of the field's
  largest magnitude.
- `knn` equals `knn_ref` exactly: the k smallest (d2, index) pairs are
  unique, and both break ties by the lower index, as lax.top_k does.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrappers copy nothing to the card and never synchronise: the
reciprocals of 2 s^2 go to the kernel by value. The plain versions serve
CPU tensors and the checks of the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mapmerge_torch.core.dense import sq_dists, tiled_query
from mapmerge_torch.core.grid import BIG
from mapmerge_torch.kernels import build, tiles

#: the kernel's scale space against its plain version, on the card: the
#: largest difference within this share of the field's largest magnitude
#: (float32 rounding of exp, the reciprocal and the sums' order)
SCALE_SPACE_RTOL = 1e-5
#: the longest neighbour list kernel D keeps (csrc/sift.cu: kK)
MAX_K = 26
#: the most sigmas kernel C takes in a launch (csrc/sift.cu: kMaxSigma)
MAX_SIGMAS = 64
#: kernel D: the most lanes that share a query (csrc/sift.cu), and the warps
#: it aims at (_lanes_per_query); on one H100 D ran fastest with 4 lanes a
#: query up to 32,768 queries and with 2 at 58,254 (PERF.md, section 6)
_D_LANES = (4, 3500)

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
    *,
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Gaussian-smoothed values for every sigma: (S, Q) float32.

    qc (Q, 3) and pc (P, 3) centred alike; vals (P,) zero where masked;
    mask (P,) bool. Each query's weights exp(-d2 / (2 s^2)) over the valid
    points with d2 <= r2_bound; out = sum(w * val) / max(sum(w), 1e-12). A
    CPU tensor takes the plain version (in query tiles of `tile`); a CUDA
    tensor launches the kernel or raises, after the pre-pass where `packed`
    is None (else `packed` must be `tiles.pack(pc, vals, mask)`)."""
    if qc.device.type == "cpu":
        return scale_space_ref(qc, pc, vals, mask, sigmas, r2_bound, tile)
    kernel = SCALE_SPACE_KERNEL
    dev = build.cuda_device(kernel, qc)
    nq, np_, ns = qc.shape[0], pc.shape[0], len(sigmas)
    build.require("qc", qc, torch.float32, (None, 3), dev)
    if np_ == 0 or not 1 <= ns <= MAX_SIGMAS or nq >= 2**31 // 3:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_} S={ns}")
    out = torch.empty((ns, nq), dtype=torch.float32, device=dev)
    if nq == 0:
        return out
    pts, boxes = _packed(packed, pc, vals, mask, dev)
    recips = (ctypes.c_float * ns)(*_recips(sigmas))
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_sift_scale_space(
            pts.data_ptr(), boxes.data_ptr(), np_, qc.data_ptr(), nq, recips, ns,
            r2_bound, out.data_ptr(), build.stream_handle(dev),
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
    *,
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest p-points of each query by (d2, index), nearest first,
    masked targets at d2 = BIG: (idx (Q, k) int32, valid (Q, k) bool, d2 <=
    r2). q and p centred alike; k <= min(MAX_K, P). A CPU tensor takes the
    plain version (in query tiles of `tile`); a CUDA tensor launches the
    kernel or raises, after the pre-pass where `packed` is None (else
    `packed` must be `tiles.pack(p, vals, p_mask)`, any vals)."""
    if q.device.type == "cpu":
        return knn_ref(q, p, p_mask, k, r2, tile)
    kernel = KNN_KERNEL
    dev = build.cuda_device(kernel, q)
    nq, np_ = q.shape[0], p.shape[0]
    build.require("q", q, torch.float32, (None, 3), dev)
    if not 1 <= k <= min(MAX_K, np_) or max(nq, np_) >= 2**31 // MAX_K:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_} k={k}")
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    valid = torch.empty((nq, k), dtype=torch.bool, device=dev)
    if nq == 0:
        return idx, valid
    pts, boxes = _packed(packed, p, None, p_mask, dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_sift_knn(
            pts.data_ptr(), boxes.data_ptr(), np_, q.data_ptr(), nq, k, r2,
            _lanes_per_query(nq, *_D_LANES), idx.data_ptr(), valid.data_ptr(),
            build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return idx, valid


def _packed(packed, p, vals, mask, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """`packed` checked against the P points it must hold, or tiles.pack(p,
    vals, mask) where it is None."""
    if packed is None:
        return tiles.pack(p, vals, mask)
    pts, boxes = packed
    n_tiles = -(-p.shape[0] // tiles.TILE)
    build.require("packed points", pts, torch.float32, (n_tiles * tiles.TILE, 4), dev)
    build.require("packed boxes", boxes, torch.float32, (n_tiles, 2, 4), dev)
    return pts, boxes


def _recips(sigmas: list[float]) -> list[float]:
    """The float32 reciprocal of the float32 value of 2 s^2 for each sigma:
    what PyTorch multiplies by on the card for `-d2 / (2.0 * s * s)`."""
    return [float(np.float32(1.0) / np.float32(2.0 * s * s)) for s in sigmas]


def _lanes_per_query(nq: int, most: int, target_warps: int) -> int:
    """The lanes that share a query in kernel D, G: the fewest powers of two
    that give `target_warps` warps of 32 // G queries, at most `most`. Lane g
    of a query takes the points j = g (mod G) of every tile; D's lists are
    merged exactly, so G moves its time, never its result."""
    g = 1
    while g < most and -(-nq // (32 // g)) < target_warps:
        g *= 2
    return g


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
