"""The dense radius sweeps: the CUDA kernels of `csrc/radius.cu` and their
plain PyTorch versions.

Kernel E, `count`: the number of valid points within the radius of each
query (the dense branch of mapmerge_tpu/ops/neighbors.py `radius_count`,
behind outlier removal and SC3D's density). Kernel F, `moments`: the count,
mean and covariance of each query's neighbourhood (the dense branch of
`neighbor_moments`, behind the surface normals). Neither is a TPU kernel:
the JAX package leaves both to XLA. Both skip, exactly, the tiles of TILE
points that no query of a warp can reach, by the boxes of the tiles.

A call on the card is one C call, on one of two routes chosen by the
number of points P alone (`route`):

- "resident", P <= RESIDENT_MAX_POINTS: one launch. Every CTA holds the
  whole cloud in shared memory, in the caller's order, builds its tile boxes
  there and sweeps its share of the queries.
- "streamed", above: two launches into one workspace. The order pre-pass
  (its own launch count, ORDER_KERNEL; plain version `order_ref`) writes the
  points in chunks of ORDER_CHUNK, each sorted by the Morton code of its
  cells of r / ORDER_CELLS, with the box of each tile (kernels/tiles.py's
  layout) and of each chunk, so that a tile is a compact box; then the
  sweep reads them.

On both a warp tests the boxes of the super-tiles (SUPER tiles each) that
its queries may reach before those of their tiles.

Both take coordinates centred on the valid mean (ops/neighbors._center)
and take the members sq_dists takes: valid points with d2 <= r2, d2 bit for
bit `core/dense.sq_dists`.

- `count` equals `count_ref` exactly.
- `moments` has `moments_ref`'s count exactly; its mean and covariance
  agree to rounding: the kernel sums each query's members in the route's
  point order in the LANES parts its lanes take, the plain version's
  matrix products sum otherwise. On the resident route the points keep the
  caller's order, and F's bits are those of the culled sweep before it. The tolerance held on the
  card is MOMENTS_RTOL of each query's largest second moment |E[p_i p_j]|
  (`moments_error`), which holds kernel H of kernels/grid.py too.

A CPU tensor takes the plain version; a CUDA tensor launches the route its
size picks or raises: no route gives way to another or to the plain
version. The wrappers copy nothing to the host and never synchronise. The
plain versions serve CPU tensors and the checks of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from mapmerge_torch.core.dense import sq_dists, tiled_query
from mapmerge_torch.kernels import build

#: kernels F's and H's (kernels/grid.py) mean and covariance against their
#: plain versions', on the card: each query's difference within this share
#: of its largest second moment (moments_error; float32 rounding of the
#: sums' order)
MOMENTS_RTOL = 1e-5
#: points a tile (csrc/cull.cuh: kT)
TILE = 32
#: lanes that share a query (csrc/radius.cu: kLanes), so TILE // LANES
#: queries a warp
LANES = 8
#: tiles a super-tile (csrc/radius.cu: kSuper): the culling tests the box of
#: each super-tile before those of its tiles
SUPER = 32
#: the largest cloud of the resident route (csrc/radius.cu: kResidentMax,
#: where the streamed route's sort starts to pay on an H100): its
#: coordinates, mask and boxes fill 110 KB of a CTA's shared memory
RESIDENT_MAX_POINTS = 8192
#: the streamed route's order (csrc/radius.cu: kChunk, kCells, kCodeBits):
#: chunks of ORDER_CHUNK points (a super-tile each), each sorted by the
#: Morton code of its cells of r / ORDER_CELLS above the chunk's least
#: valid coordinates, ORDER_CODE_BITS bits an axis
ORDER_CHUNK = SUPER * TILE
ORDER_CELLS = 8.0
ORDER_CODE_BITS = 10

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
#: the streamed route's pre-pass, launched inside E's and F's calls
ORDER_KERNEL = build.Kernel(
    name="radius_order",
    source="mapmerge_torch/csrc/radius.cu",
    replaces="mapmerge_tpu/ops/neighbors.py:107",
)


def route(n_points: int) -> str:
    """The route of a cloud of `n_points` on the card: "resident" or
    "streamed"."""
    return "resident" if n_points <= RESIDENT_MAX_POINTS else "streamed"


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
    `tile`); a CUDA tensor launches its route or raises."""
    if qc.device.type == "cpu":
        return count_ref(qc, pc, mask, r2, tile)
    dev = _operands(COUNT_KERNEL, qc, pc, mask)
    out = torch.empty((qc.shape[0],), dtype=torch.int32, device=dev)
    if qc.shape[0] > 0:
        _launch(COUNT_KERNEL, "mm_radius_count", dev, qc, pc, mask, r2, out)
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
    `count`'s; the three are views of one buffer."""
    if qc.device.type == "cpu":
        return moments_ref(qc, pc, mask, r2, tile)
    dev = _operands(MOMENTS_KERNEL, qc, pc, mask)
    nq = qc.shape[0]
    out = torch.empty((13 * nq,), dtype=torch.float32, device=dev)
    if nq > 0:
        _launch(MOMENTS_KERNEL, "mm_radius_moments", dev, qc, pc, mask, r2, out)
    return out[:nq], out[nq : 4 * nq].view(nq, 3), out[4 * nq :].view(nq, 3, 3)


def order(
    pc: torch.Tensor, mask: torch.Tensor | None, r2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The streamed route's pre-pass alone, for any P: (pts (P', 4), boxes
    (P' / TILE, 2, 4), supers (P' / ORDER_CHUNK, 2, 4)) float32 as order_ref
    defines them, P' the points rounded up to ORDER_CHUNK. A CPU tensor
    takes order_ref; a CUDA tensor launches the pre-pass or raises."""
    if pc.device.type == "cpu":
        return order_ref(pc, mask, r2)
    dev = _operands(ORDER_KERNEL, pc, pc, mask)
    np_ = pc.shape[0]
    work = torch.empty((work_floats(np_),), dtype=torch.float32, device=dev)
    lib = build.load()
    with build.device_guard(dev):
        err = lib.mm_radius_order(
            pc.data_ptr(), None if mask is None else mask.data_ptr(), np_, r2,
            work.data_ptr(), build.stream_handle(dev),
        )
    ORDER_KERNEL.launched()
    build.check_launch(ORDER_KERNEL, err)
    return _split_work(work, np_)


def work_floats(n_points: int) -> int:
    """The floats of the streamed route's workspace: the points (4 each),
    the tile boxes and the chunk boxes (8 each) of P rounded up to
    ORDER_CHUNK."""
    npad = -(-n_points // ORDER_CHUNK) * ORDER_CHUNK
    return npad * 4 + npad // TILE * 8 + npad // ORDER_CHUNK * 8


def _split_work(work: torch.Tensor, n_points: int):
    npad = -(-n_points // ORDER_CHUNK) * ORDER_CHUNK
    boxes = npad * 4 + npad // TILE * 8
    return (work[: npad * 4].view(npad, 4), work[npad * 4 : boxes].view(npad // TILE, 2, 4),
            work[boxes:].view(npad // ORDER_CHUNK, 2, 4))


def _operands(kernel: build.Kernel, qc: torch.Tensor, pc: torch.Tensor, mask) -> torch.device:
    """The device of a launch, its operands checked."""
    dev = build.cuda_device(kernel, qc)
    nq, np_ = qc.shape[0], pc.shape[0]
    build.require("qc", qc, torch.float32, (None, 3), dev)
    build.require("pc", pc, torch.float32, (None, 3), dev)
    if mask is not None:
        build.require("mask", mask, torch.bool, (np_,), dev)
    if not 1 <= np_ < 2**31 // 4 - ORDER_CHUNK or nq >= 2**31 // 13:
        raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={np_}")
    return dev


def _launch(kernel, fn: str, dev, qc, pc, mask, r2: float, out: torch.Tensor) -> None:
    """One C call: the resident route, or the streamed route (the order
    pre-pass, counted, then the sweep) into one workspace."""
    np_ = pc.shape[0]
    streamed = route(np_) == "streamed"
    work = (torch.empty((work_floats(np_),), dtype=torch.float32, device=dev)
            if streamed else None)
    lib = build.load()
    with build.device_guard(dev):
        err = getattr(lib, fn)(
            pc.data_ptr(), None if mask is None else mask.data_ptr(), np_, qc.data_ptr(),
            qc.shape[0], r2, out.data_ptr(), None if work is None else work.data_ptr(),
            build.stream_handle(dev),
        )
    if streamed:
        ORDER_KERNEL.launched()
    kernel.launched()
    build.check_launch(kernel, err)


def order_ref(
    pc: torch.Tensor, mask: torch.Tensor | None, r2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streamed route's pre-pass. For each
    chunk of ORDER_CHUNK points (the last padded with absent points): lo =
    the least x, y, z of its valid points (a NaN coordinate passed over);
    the key of a valid point the Morton code of its cells c = floor((x - lo)
    * inv) (inv = ORDER_CELLS / sqrt(r2) in float32; NaN and below 0 to 0,
    at most 2^ORDER_CODE_BITS - 1), of a masked or absent one 2^(3
    ORDER_CODE_BITS); the chunk's points in (key, place) order. pts (P', 4):
    (x, y, z, 0), x = NaN where masked, absent rows (NaN, 0, 0, 0); boxes
    (P' / TILE, 2, 4): each tile's (least, largest) x, y, z of its valid
    points, w = 0 (+inf / -inf for a tile with none); supers (P' /
    ORDER_CHUNK, 2, 4): each chunk's so. A point whose x is NaN counts as
    masked."""
    np_, dev = pc.shape[0], pc.device
    npad = -(-np_ // ORDER_CHUNK) * ORDER_CHUNK
    valid = torch.ones(np_, dtype=torch.bool, device=dev) if mask is None else mask
    valid = valid & ~pc[:, 0].isnan()  # within r2 of no query: masked alike
    valid = torch.cat([valid, torch.zeros(npad - np_, dtype=torch.bool, device=dev)])
    xyz = torch.cat([pc, torch.zeros((npad - np_, 3), dtype=torch.float32, device=dev)])
    chunks, vc = xyz.view(-1, ORDER_CHUNK, 3), valid.view(-1, ORDER_CHUNK, 1)
    lo = torch.where(vc & ~chunks.isnan(), chunks, torch.inf).amin(1, keepdim=True)
    inv = torch.tensor(np.float32(ORDER_CELLS) / np.sqrt(np.float32(r2)), device=dev)
    cell = torch.floor((chunks - lo) * inv)
    cell = torch.where(cell >= 0, cell, 0.0).clamp(max=2**ORDER_CODE_BITS - 1).to(torch.int64)
    code = torch.zeros(cell.shape[:2], dtype=torch.int64, device=dev)
    for bit in range(ORDER_CODE_BITS):
        for axis in range(3):
            code |= ((cell[..., axis] >> bit) & 1) << (3 * bit + 2 - axis)
    code = torch.where(vc[..., 0], code, 1 << (3 * ORDER_CODE_BITS))
    place = torch.arange(ORDER_CHUNK, device=dev)
    perm = torch.sort(code * ORDER_CHUNK + place, dim=1).values % ORDER_CHUNK
    rows = (perm + torch.arange(0, npad, ORDER_CHUNK, device=dev)[:, None]).reshape(-1)
    p, v = xyz[rows], valid[rows]
    x = torch.where(v, p[:, 0], torch.nan)
    pts = torch.stack([x, p[:, 1], p[:, 2], torch.zeros_like(x)], dim=1)
    vt, tiles = v.view(-1, TILE, 1), p.view(-1, TILE, 3)
    vt = vt & ~tiles.isnan()  # the kernel's fminf / fmaxf pass over NaN
    boxes = []
    for size in (TILE, ORDER_CHUNK):
        v, t = vt.view(-1, size, 3), tiles.view(-1, size, 3)
        lo = torch.where(v, t, torch.inf).amin(dim=1)
        hi = torch.where(v, t, -torch.inf).amax(dim=1)
        zero = torch.zeros((lo.shape[0], 1), dtype=torch.float32, device=dev)
        boxes.append(torch.stack([torch.cat([lo, zero], 1), torch.cat([hi, zero], 1)], dim=1))
    return pts, boxes[0], boxes[1]


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
