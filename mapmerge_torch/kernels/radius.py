"""The dense radius sweeps: the CUDA kernels of `csrc/radius.cu` and their
plain PyTorch versions.

Kernel E, `count`: the number of valid points within the radius of each
query (the dense branch of mapmerge_tpu/ops/neighbors.py `radius_count`,
behind outlier removal and SC3D's density). Kernel F, `moments`: the count,
mean and covariance of each query's neighbourhood (the dense branch of
`neighbor_moments`, behind the surface normals). Neither is a TPU kernel:
the JAX package leaves both to XLA. Each call first runs the tile pre-pass
(`kernels/tiles.pack` of the points and their mask) that SIFT's kernels C
and D read too, by which they skip, exactly, the tiles no query of a warp
can reach.

Both take coordinates centred on the valid mean (ops/neighbors._center)
and take the members sq_dists takes: valid points with d2 <= r2, d2 bit for
bit `core/dense.sq_dists`.

- `count` equals `count_ref` exactly.
- `moments` has `moments_ref`'s count exactly; its mean and covariance
  agree to rounding: the kernel sums each query's members in point order in
  the 8 parts its lanes take (csrc/radius.cu: kLanes), the plain version's
  matrix products sum otherwise. The tolerance held on the card is
  MOMENTS_RTOL of each query's largest second moment |E[p_i p_j]|
  (`moments_error`), which holds kernel H of kernels/grid.py too.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrappers copy nothing to the host and never synchronise. The
plain versions serve CPU tensors and the checks of the kernels.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.dense import sq_dists, tiled_query
from mapmerge_torch.kernels import build, tiles

#: kernels F's and H's (kernels/grid.py) mean and covariance against their
#: plain versions', on the card: each query's difference within this share
#: of its largest second moment (moments_error; float32 rounding of the
#: sums' order)
MOMENTS_RTOL = 1e-5

COUNT_KERNEL = build.Kernel(
    name="radius_count",
    source="mapmerge_torch/csrc/radius.cu",
    replaces="mapmerge_tpu/ops/neighbors.py:107",
)
MOMENTS_KERNEL = build.Kernel(
    name="radius_moments",
    source="mapmerge_torch/csrc/radius.cu",
    replaces="mapmerge_tpu/ops/neighbors.py:361",
)


def count(
    qc: torch.Tensor,
    pc: torch.Tensor,
    mask: torch.Tensor | None,
    r2: float,
    tile: int = 1024,
) -> torch.Tensor:
    """(Q,) int32: the valid p-points with sq_dists <= r2 of each query.

    qc (Q, 3) and pc (P, 3) centred alike; mask (P,) bool or None (all
    valid). A CPU tensor takes the plain version (in query tiles of
    `tile`); a CUDA tensor launches the pre-pass and the kernel or
    raises."""
    if qc.device.type == "cpu":
        return count_ref(qc, pc, mask, r2, tile)
    kernel = COUNT_KERNEL
    dev, nq, np_ = _operands(kernel, qc, pc)
    out = torch.empty((nq,), dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    pts, boxes = tiles.pack(pc, None, mask)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_radius_count(
            pts.data_ptr(), boxes.data_ptr(), np_, qc.data_ptr(), nq, r2,
            out.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return out


def moments(
    qc: torch.Tensor,
    pc: torch.Tensor,
    mask: torch.Tensor | None,
    r2: float,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count (Q,), mean (Q, 3) and covariance (Q, 3, 3) float32 of each
    query's members (the valid p-points with sq_dists <= r2), in the centred
    frame; a query with none gets 0, 0 and 0. Operands and routes as
    `count`'s."""
    if qc.device.type == "cpu":
        return moments_ref(qc, pc, mask, r2, tile)
    kernel = MOMENTS_KERNEL
    dev, nq, np_ = _operands(kernel, qc, pc)
    s0 = torch.empty((nq,), dtype=torch.float32, device=dev)
    mean = torch.empty((nq, 3), dtype=torch.float32, device=dev)
    cov = torch.empty((nq, 3, 3), dtype=torch.float32, device=dev)
    if nq == 0:
        return s0, mean, cov
    pts, boxes = tiles.pack(pc, None, mask)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_radius_moments(
            pts.data_ptr(), boxes.data_ptr(), np_, qc.data_ptr(), nq, r2,
            s0.data_ptr(), mean.data_ptr(), cov.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return s0, mean, cov


def _operands(kernel: build.Kernel, qc: torch.Tensor, pc: torch.Tensor):
    """(device, Q, P) of a launch, its queries checked (the pre-pass checks
    the points and the mask)."""
    dev = build.cuda_device(kernel, qc)
    nq, np_ = qc.shape[0], pc.shape[0]
    build.require("qc", qc, torch.float32, (None, 3), dev)
    if np_ == 0 or nq >= 2**31:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_}")
    return dev, nq, np_


def moments_error(got, want, origin: torch.Tensor | None = None) -> tuple[float, float]:
    """Kernel F's (or H's) output `got` against its plain version's `want`:
    (the largest absolute difference of the mean and the covariance, the
    largest over the queries of that query's share of its largest second
    moment S = |cov + m m^T| about `origin` of `want`, m = mean - origin).
    `origin` (Q, 3) is None for F, whose frame is centred already (m =
    mean), and the queries for H. The covariance's difference is taken over
    S and the mean's over sqrt(S). H's mean comes back as m + the query,
    rounded once at the query's coordinates on sums that differ by rounding,
    so where an origin is given one float32 step of the mean is taken off
    the mean's difference first. 0 where both agree, inf where only the
    scale is 0. The counts are compared apart, exactly."""
    _, mean, cov = got
    _, rmean, rcov = want
    if mean.shape[0] == 0:
        return 0.0, 0.0
    dmean = (mean - rmean).abs()
    dcov = (cov - rcov).abs().amax((-2, -1))
    err = float(torch.maximum(dmean.amax(-1), dcov).max())
    m = rmean if origin is None else rmean - origin
    scale = (rcov + m[:, :, None] * m[:, None, :]).abs().amax((-2, -1))
    if origin is not None:
        step = torch.nextafter(rmean.abs(), torch.full_like(rmean, float("inf"))) - rmean.abs()
        dmean = (dmean - step).clamp_min(0.0)
    dmean = dmean.amax(-1)
    rel = torch.maximum(
        torch.where(dcov == 0, 0.0, dcov / scale),
        torch.where(dmean == 0, 0.0, dmean / scale.sqrt()),
    )
    return err, float(rel.max())


def count_ref(
    qc: torch.Tensor,
    pc: torch.Tensor,
    mask: torch.Tensor | None,
    r2: float,
    tile: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch count (the dense branch of the parent's
    `ops/neighbors.radius_count`): per query tile, the (tile, P) slab of
    sq_dists, the {0,1} within-radius mask and its row sum. (Q,) int32."""

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if mask is not None:
            within = within & mask[None, :]
        return within.sum(dim=-1).to(torch.int32)

    if qc.shape[0] == 0:
        return torch.empty((0,), dtype=torch.int32, device=qc.device)
    return tiled_query(qc, tile_fn, tile)


def moments_ref(
    qc: torch.Tensor,
    pc: torch.Tensor,
    mask: torch.Tensor | None,
    r2: float,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch moments (the dense branch of the parent's
    `ops/neighbors.neighbor_moments`): per query tile, the {0,1}
    within-radius matrix w, its row sum and the matrix products w @ pc and
    w @ pp (pp the per-point products pc_i * pc_j). Count (Q,), mean (Q, 3)
    and covariance (Q, 3, 3), centred."""
    pp = (pc[:, :, None] * pc[:, None, :]).reshape(-1, 9)

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if mask is not None:
            within = within & mask[None, :]
        w = within.to(torch.float32)
        s0 = w.sum(dim=-1)
        denom = s0.clamp_min(1.0)[:, None]
        mean = (w @ pc) / denom
        e_outer = (w @ pp) / denom
        cov = e_outer.reshape(-1, 3, 3) - mean[:, :, None] * mean[:, None, :]
        return s0, mean, cov

    if qc.shape[0] == 0:
        return (torch.empty((0,), dtype=torch.float32, device=qc.device),
                torch.empty((0, 3), dtype=torch.float32, device=qc.device),
                torch.empty((0, 3, 3), dtype=torch.float32, device=qc.device))
    return tiled_query(qc, tile_fn, tile)
