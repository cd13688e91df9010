"""The cell-grid engine's sweeps: the CUDA kernels of `csrc/grid.cu` and
their plain PyTorch versions.

Kernel G, `nn_query`: the bounded 1-NN of each query against a target grid
whose cell edge is the bound (ops/grid.grid_nn_query: ICP every iteration,
and the transform score through grid_nearest_neighbor). Kernel H,
`moments`: the count, mean and covariance of each query's neighbourhood
(grid_neighbor_moments: the normals). Kernel I, `count`: the neighbour
count (grid_radius_count: outlier removal). Kernel J, `smooth`: the
Gaussian-weighted means of a value at every sigma (grid_gaussian_smooth:
SIFT's scale space on a grid octave). Kernel K, `knn`: the k nearest
candidates (the big-Q branch of grid_radius_neighbors: SIFT's 26-NN on a
grid octave). Kernel L, `reduce` and `reduce_list`: the count and the sum
or max of each query's members' values (grid_radius_reduce: Harris's
response and suppression on its sweep route, its corner refinement's few
queries on its list route). None is a TPU kernel: the JAX package leaves
all six to XLA (mapmerge_tpu/ops/grid.py `grid_query`, and the small-Q
gather `_radius_reduce_smallq`).

Each takes the target grid and the query grid of core/grid.build_grid and
reads both in place, with nothing read back to the host. The candidates of
a query slot are the filled slots of the distinct wrapped neighbour buckets
of its bucket, in ascending bucket id, then slot order (core/grid.
_candidates' order). The kernels read the target slots s < count[h]; for a
grid from build_grid that is exactly cell_ok, and every caller's target
grid comes from build_grid. The query side is the plain version's: the
query grid's slots with cell_ok set are answered, the rows of the others
(the queries the query-side cap dropped, masked queries) keep the plain
version's defaults.

G-K and L's sweep route cull, on one pre-pass: a call launches the
pre-pass (`pack`, counted as "grid_pack"; one launch), which writes the
box of every run of TILE slots of each target bucket and lists the units
of the query grid (up to 32 answered slots of one bucket, a lane a
query), then the kernel, whose warps take the units. G and K need only
the first member, or the first k candidates, of a query, and skip,
exactly, every tile whose box bound cannot come before a query's
threshold in (d2, slot) order. H, I, J and L add every member, a point
within the fixed radius: a unit walks its neighbours' tiles in candidate
order and skips, exactly, every tile whose box lies beyond the radius of
its queries' box, then of each lane's query. H, J and L's sum add each
lane's members in the sweep's order (the bits of the one-thread-a-slot
sweep H and J replaced). I and L's max need no order: where a tile's
straddling queries are few, the warp's lanes test the tile's slots against
one query a step (L's max a warp max of its members' values), else each
straddling lane loops over the slots. L is built for the widths
REDUCE_WIDTHS and once for any other C. A caller that queries one target
grid many times (ICP, Harris) makes its boxes once (`boxes`, also counted
as "grid_pack") and passes them to `nn_query`, whose pre-pass then lists
the units alone, or to `reduce_list`, whose warps skip a tile whose box
lies beyond the radius of their query. `select_counters` launches G, K, H,
I, J or L's sweep route once more with its counters on: the pairs it
compared, the tiles it visited, its units and the share of their lanes
that answer a query; H, I, J and L also the members they added, I and L's
max their straddling (query, tile) pairs, warp steps and tiles done a lane
a query.

- `nn_query` equals `nn_query_ref` bit for bit: idx and d2.
- `count` equals `count_ref` bit for bit, the include_self subtraction
  included.
- `moments` has `moments_ref`'s count exactly; its mean and covariance
  agree to rounding: the kernel sums each query's members in candidate
  order, the plain version by torch's reduction tree. The tolerance held on
  the card is F's, kernels/radius.MOMENTS_RTOL of each query's largest
  second moment about the query (kernels/radius.moments_error with the
  queries as the origin).
- `smooth` agrees with `smooth_ref` to rounding: the members are the same
  bits, but the kernel sums w v and w in candidate order (kernel C's
  arithmetic, expf), the plain version by bmm and a row sum. The tolerance
  held on the card is C's, kernels/sift.SCALE_SPACE_RTOL of the field's
  largest magnitude. The kernel reads each member's value in place, through
  the target grid's cell_idx; no plane of values in the grid's layout is
  made.
- `knn` equals `knn_ref` bit for bit: the k smallest d2 with ties to the
  first candidate position (knn_ref sorts stably), entries at BIG or beyond
  as (0, BIG, BIG <= r2).
- `reduce` and `reduce_list` have `reduce_ref`'s and `reduce_list_ref`'s
  counts and maxes bit for bit (NaN where NaN); their sums add the same
  float32 terms in another order (candidate order, each channel on its
  own, so a channel's sum does not depend on C; on the list route a lane's
  slots, then a fixed shuffle tree), against the plain bmm's, and agree
  within REDUCE_RTOL of the members' sum of |v| (`reduce_error`). Both
  read each member's values in place through cell_idx; the list route
  builds no query grid and, given the target's boxes, launches no
  pre-pass.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrappers copy nothing to the host and never synchronise (J's
reciprocals of 2 s^2 go to the kernel by value).

The plain versions run core/grid.grid_query; ops/grid.py calls the
wrappers.
"""

from __future__ import annotations

import ctypes
import math

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
SMOOTH_KERNEL = build.Kernel(
    name="grid_smooth",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:813",
)
KNN_KERNEL = build.Kernel(
    name="grid_knn",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:507",
)
REDUCE_KERNEL = build.Kernel(
    name="grid_reduce",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:701",
)
REDUCE_LIST_KERNEL = build.Kernel(
    name="grid_reduce_list",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:632",
)
#: the pre-pass of G-L (csrc/grid.cu: grid_pack_kernel), part of their
#: port: launched with each of them but L's list route, and alone by `pack`
#: and `boxes`
PACK_KERNEL = build.Kernel(
    name="grid_pack",
    source="mapmerge_torch/csrc/grid.cu",
    replaces="mapmerge_tpu/ops/grid.py:594",
)
#: the most sigmas kernel J takes in a launch (csrc/grid.cu: kMaxSigma)
MAX_SIGMAS = 64
#: the sigmas a warp of kernel J takes, its group (csrc/grid.cu: kSigLane)
SIGMA_GROUP = 8
#: the longest neighbour list kernel K keeps (csrc/grid.cu: kK)
MAX_K = 26
#: slots a tile of the pre-pass's boxes (csrc/cull.cuh: kT)
TILE = 32
#: the most channels of values kernel L takes (csrc/grid.cu: kMaxChannels)
MAX_CHANNELS = 16
#: the widths kernel L is built for, its arrays that wide; any other C up to
#: MAX_CHANNELS takes its generic instantiation (csrc/grid.cu: kWidth)
REDUCE_WIDTHS = (1, 6, 9)
#: kernel L's sum against its plain version: within REDUCE_RTOL of the sum
#: of |v| over the query's members, per query and channel (the sums add the
#: same float32 terms in another order: candidate order, or the list
#: route's lanes and their tree, against the bmm's)
REDUCE_RTOL = 1e-5
#: counts a warp of kernel I's counters (csrc/grid.cu: kCountCounters)
COUNT_COUNTERS = 8
#: kernel I counts a tile a lane a query over its slots where its
#: straddling queries number more than LOOP_TENTHS / 10 of its filled
#: slots, else a step a query (csrc/grid.cu: kLoopTenths)
LOOP_TENTHS = 7


def nn_query(
    grid, qg, q: torch.Tensor, n_p: int, boxes: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounded 1-NN of the queries q (Q, 3) against the target grid `grid`
    (cell edge = the bound), through their query grid `qg`
    (build_grid(q, q_mask, grid's cell, dims and cap)): (idx (Q,) int32, d2
    (Q,) float32); d2 = BIG and the first candidate's index where nothing
    lies within the bound, (0, BIG) for a query in no answered slot; an
    index >= n_p becomes 0. `boxes`: `boxes(grid)` made earlier for this
    grid, as it still is (ICP's target), or None to make them in the call.
    A CPU tensor takes the plain version (which needs no boxes); a CUDA
    tensor launches the pre-pass and kernel G or raises."""
    if q.device.type == "cpu":
        return nn_query_ref(grid, qg, q, n_p)
    return _select(NN_KERNEL, grid, qg, q, n_p, boxes=boxes)


def moments(
    grid, qg, q: torch.Tensor, r2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count (Q,), mean (Q, 3) and covariance (Q, 3, 3) float32 of each
    query's members (the target points with d2 <= r2), summed over the
    query-centred offsets; zeros for a query in no answered slot. Operands
    and routes as `nn_query`'s; the pre-pass and kernel H."""
    if q.device.type == "cpu":
        return moments_ref(grid, qg, q, r2)
    return _radius(MOMENTS_KERNEL, grid, qg, q, r2)


def count(
    grid, qg, q: torch.Tensor, r2: float, include_self: bool = True
) -> torch.Tensor:
    """(Q,) int32: the target points with d2 <= r2 of each query, minus 1
    without include_self (0 - 1 for a query in no answered slot, as the
    plain version). Operands and routes as `nn_query`'s; the pre-pass and
    kernel I."""
    if q.device.type == "cpu":
        return count_ref(grid, qg, q, r2, include_self)
    return _radius(COUNT_KERNEL, grid, qg, q, r2, sub=0 if include_self else 1)


def smooth(
    grid, qg, q: torch.Tensor, values: torch.Tensor, sigmas: list[float], r2: float
) -> torch.Tensor:
    """(Q, S) float32: for each answered query and sigma s, sum w v / max(sum
    w, 1e-12) over its members (the target points with d2 <= r2), w =
    exp(-d2 f32(1 / (2 s^2))), v the member's value of `values` (P,) (the
    P points the target grid was built from); 0 for a query in no answered
    slot. Operands and routes as `nn_query`'s; the pre-pass and kernel J,
    which reads the values in place."""
    if q.device.type == "cpu":
        return smooth_ref(grid, qg, q, values, sigmas, r2)
    return _radius(SMOOTH_KERNEL, grid, qg, q, r2, values, sigmas)


def knn(
    grid, qg, q: torch.Tensor, n_p: int, k: int, r2: float, exclude_self: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k nearest candidates of each answered query, nearest first, ties
    to the first candidate position: (idx (Q, k) int32, d2 (Q, k) float32,
    valid (Q, k) = d2 <= r2). No radius cut in the selection; with
    exclude_self a candidate at d2 <= 1e-12 goes to BIG; an entry at BIG or
    beyond is (0, BIG, BIG <= r2), a query in no answered slot gets (0,
    BIG, False), an index >= n_p becomes 0. Operands and routes as
    `nn_query`'s; the pre-pass and kernel K."""
    if q.device.type == "cpu":
        return knn_ref(grid, qg, q, n_p, k, r2, exclude_self)
    return _select(KNN_KERNEL, grid, qg, q, n_p, k, r2, exclude_self)


def reduce(
    grid, qg, q: torch.Tensor, values: torch.Tensor, r2: float, op: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Count (Q,) int32 and the sum (op "sum") or NaN-propagating max (op
    "max") (Q, C) float32 of the values (P, C) of each query's members (the
    target points with d2 <= r2; P the points the target grid was built
    from); a query in no answered slot gets (0, 0) or (0, -BIG), and so
    does the max of a query whose candidates are not all members where its
    members' max is below -BIG, as the plain version's where() gives it.
    Operands and routes as `nn_query`'s; the pre-pass and kernel L's sweep
    route, which reads each member's values in place through the target
    grid's cell_idx (1 <= C <= MAX_CHANNELS on the card)."""
    if q.device.type == "cpu":
        return reduce_ref(grid, qg, q, values, r2, op)
    return _radius(REDUCE_KERNEL, grid, qg, q, r2, values, op=op)


def reduce_list(
    grid, q: torch.Tensor, values: torch.Tensor, r2: float, op: str,
    boxes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`reduce` for a few queries (the small-Q path): every query answered,
    no query grid, its candidates the filled slots of the distinct wrapped
    neighbours of the bucket its coordinates fall in. `boxes`: `boxes(grid)`
    made earlier for this grid, as it still is (Harris's target), or None
    to make them in the call. A CPU tensor takes reduce_list_ref (which
    needs no boxes); a CUDA tensor launches kernel L's list route (one
    launch, a warp a query, each tile of 32 slots skipped where its box lies
    beyond r2 of the query; the pre-pass's boxes first where none are
    given) or raises."""
    if q.device.type == "cpu":
        return reduce_list_ref(grid, q, values, r2, op)
    kernel = REDUCE_LIST_KERNEL
    dev = build.cuda_device(kernel, q)
    nq = q.shape[0]
    h, cap = grid.cell_idx.shape
    gx, gy, gz = grid.dims
    build.require(f"{kernel.name}: q", q, torch.float32, (None, 3), dev)
    build.require(f"{kernel.name}: grid.cell_xyz", grid.cell_xyz, torch.float32, (h, cap, 3), dev)
    build.require(f"{kernel.name}: grid.cell_idx", grid.cell_idx, torch.int64, (h, cap), dev)
    build.require(f"{kernel.name}: grid.count", grid.count, torch.int32, (h,), dev)
    channels = _reduce_channels(kernel, values, dev)
    if gx * gy * gz != h or 27 * cap >= 2**31 or nq >= 2**31 - 4:
        raise ValueError(f"{kernel.name}: unsupported grid H={h} C={cap} dims={grid.dims}, "
                         f"Q={nq}")
    if boxes is not None:
        build.require(f"{kernel.name}: boxes", boxes, torch.float32, (h * -(-cap // TILE), 2, 4),
                      dev)
    count, out = _reduce_outputs(nq, channels, op, dev)
    if nq == 0:
        return count, out
    if boxes is None:
        boxes = _tile_boxes(grid)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_grid_reduce_list(
            grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(), grid.count.data_ptr(),
            boxes.data_ptr(), values.data_ptr(), channels, int(op == "max"), q.data_ptr(), nq,
            h, cap, gx, gy, gz, cgrid._f32(1.0 / grid.cell_size), r2, count.data_ptr(),
            out.data_ptr(), build.stream_handle(dev))
    kernel.launched()
    build.check_launch(kernel, err)
    return count, out


def _reduce_channels(kernel: build.Kernel, values: torch.Tensor, dev) -> int:
    """The channels of kernel L's values (P, C), checked: float32,
    contiguous, on `dev`, 1 <= C <= MAX_CHANNELS, else a raise."""
    build.require(f"{kernel.name}: values", values, torch.float32, (None, None), dev)
    channels = values.shape[1]
    if not 1 <= channels <= MAX_CHANNELS:
        raise ValueError(f"{kernel.name}: unsupported channel count {channels}")
    return channels


def _reduce_outputs(nq: int, channels: int, op: str, dev):
    """Kernel L's outputs with the rows of an unanswered query: count 0,
    and 0 (sum) or -BIG (max)."""
    count = torch.zeros((nq,), dtype=torch.int32, device=dev)
    fill = 0.0 if op == "sum" else -cgrid.BIG
    return count, torch.full((nq, channels), fill, dtype=torch.float32, device=dev)


def pack(grid, qg, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass of kernels G-L alone, on their operands (the target
    grid, the query grid of the queries q): as `pack_ref` defines it,
    (boxes, units), but the boxes of empty tiles (outside `filled_tiles`)
    and the units' rows past units[0] + 1 are not written, and the units'
    runs of 1,024 buckets lie in an order of their own. A CPU tensor takes
    pack_ref; a CUDA tensor launches the pre-pass (one launch, with nothing
    zeroed before it) or raises."""
    if q.device.type == "cpu":
        return pack_ref(grid, qg, q)
    dev, nq, dims = _operands(PACK_KERNEL, grid, qg, q)
    boxes = _empty_boxes(grid, dev)
    units = torch.empty((units_max(nq, dims[0]),), dtype=torch.int32, device=dev)
    _launch_pack(dev, grid, qg.count.data_ptr(), dims, boxes.data_ptr(), units)
    return boxes, units


def boxes(grid) -> torch.Tensor:
    """The pre-pass's tile boxes of a target grid alone, for a caller that
    queries the grid many times (ICP, Harris) and passes them to `nn_query`
    or `reduce_list`: as `boxes_ref`, but the boxes of empty tiles are not
    written. A CPU grid takes boxes_ref; a CUDA grid launches the pre-pass
    (counted as "grid_pack") or raises."""
    if grid.cell_xyz.device.type == "cpu":
        return boxes_ref(grid)
    return _tile_boxes(grid)


def _tile_boxes(grid) -> torch.Tensor:
    """`boxes` of a grid on the card."""
    # the grid stands as its own query grid: only its shape is checked
    dev, _, dims = _operands(PACK_KERNEL, grid, grid, grid.cell_xyz.new_empty((0, 3)))
    out = _empty_boxes(grid, dev)
    _launch_pack(dev, grid, None, dims, out.data_ptr(), None)
    return out


def _launch_pack(dev, grid, q_count, dims, boxes_ptr, units) -> None:
    """mm_grid_pack on the card: the boxes where boxes_ptr is not None, the
    units of the query counts at q_count where `units` is not None."""
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_grid_pack(
            grid.cell_xyz.data_ptr(), grid.count.data_ptr(), q_count, *dims, boxes_ptr,
            None if units is None else units.data_ptr(),
            0 if units is None else units.numel() - 1, build.stream_handle(dev),
        )
    PACK_KERNEL.launched()
    build.check_launch(PACK_KERNEL, err)


def filled_tiles(grid) -> torch.Tensor:
    """(H T,) bool: the tiles of the target grid that hold a filled slot,
    the boxes the pre-pass writes."""
    h, cap = grid.cell_idx.shape
    t = torch.arange(-(-cap // TILE), device=grid.count.device)
    return (t[None, :] * TILE < grid.count.clamp(0, cap)[:, None]).reshape(-1)


def units_max(nq: int, h: int) -> int:
    """The length of the units buffer for nq queries over h buckets: its
    count and at most nq / 32 full groups and one partial group a bucket
    (no query lies in two slots)."""
    return 1 + nq // 32 + min(h, nq)


def pack_ref(grid, qg, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pre-pass of kernels G-K: (boxes_ref(grid), units).
    units (units_max(Q, H),) int32: their count n first, then, for each
    query bucket b in order and j < ceil(min(count_b, C) / 32), b ceil(C /
    32) + j: the j-th group of 32 answered slots of b, a warp's work; the
    rows past n + 1 are 0."""
    h, cap = grid.cell_idx.shape
    dev = grid.cell_xyz.device
    per = (qg.count.clamp(0, cap).to(torch.int64) + 31) // 32
    bucket = torch.repeat_interleave(torch.arange(h, device=dev), per)
    group = torch.arange(bucket.numel(), device=dev) - (torch.cumsum(per, 0) - per)[bucket]
    units = torch.zeros((units_max(q.shape[0], h),), dtype=torch.int32, device=dev)
    n = min(bucket.numel(), units.numel() - 1)
    units[0] = n
    units[1 : n + 1] = (bucket * -(-cap // 32) + group)[:n].to(torch.int32)
    return boxes_ref(grid), units


def boxes_ref(grid) -> torch.Tensor:
    """Plain PyTorch tile boxes of a target grid: (H T, 2, 4) float32, T =
    ceil(C / TILE): for each run of TILE slots of each target bucket (T a
    bucket), lo = (the least x, y, z of its filled slots, 0) and hi = (the
    largest, 0), a coordinate that is NaN left out (as fminf and fmaxf leave
    it); a run with none has lo = +inf, hi = -inf."""
    h, cap = grid.cell_idx.shape
    dev = grid.cell_xyz.device
    t = -(-cap // TILE)
    xyz = torch.nn.functional.pad(grid.cell_xyz, (0, 0, 0, t * TILE - cap))
    slot = torch.arange(t * TILE, device=dev)
    filled = slot[None, :] < grid.count.clamp(0, cap).to(torch.int64)[:, None]
    ok = filled[..., None] & ~xyz.isnan()
    lo = torch.where(ok, xyz, torch.inf).reshape(h * t, TILE, 3).amin(dim=1)
    hi = torch.where(ok, xyz, -torch.inf).reshape(h * t, TILE, 3).amax(dim=1)
    zero = torch.zeros((h * t, 1), dtype=torch.float32, device=dev)
    return torch.stack([torch.cat([lo, zero], 1), torch.cat([hi, zero], 1)], dim=1)


def _empty_boxes(grid, dev) -> torch.Tensor:
    h, cap = grid.cell_idx.shape
    return torch.empty((h * -(-cap // TILE), 2, 4), dtype=torch.float32, device=dev)


def _select(kernel: build.Kernel, grid, qg, q, n_p: int, *knn_args, boxes=None,
            counters=None):
    """Launch the pre-pass and kernel G (`knn_args` empty) or K (`knn_args`
    (k, r2, exclude_self)) on the card: the outputs, their rows defaulted
    as the plain version's. G takes the target's boxes made earlier
    (`boxes`) where given, else the pre-pass makes them. `counters`, an
    int64 tensor on the card, receives the kernel's per-warp counts
    (select_counters); the package's calls pass none."""
    dev, nq, dims = _operands(kernel, grid, qg, q)
    if n_p >= 2**31 or dims[0] * dims[1] >= 2**31:
        raise ValueError(f"{kernel.name}: unsupported sizes H={dims[0]} C={dims[1]} P={n_p}")
    knn = kernel is KNN_KERNEL
    if knn:
        k, r2, exclude_self = knn_args
        if not 1 <= k <= MAX_K or nq * k >= 2**31:
            raise ValueError(f"{kernel.name}: unsupported sizes Q={nq} P={n_p} k={k}")
        shape = (nq, k)
    else:
        shape = (nq,)
    ready = boxes is not None
    if ready:
        build.require(f"{kernel.name}: boxes", boxes, torch.float32,
                      (dims[0] * -(-dims[1] // TILE), 2, 4), dev)
    idx = torch.zeros(shape, dtype=torch.int32, device=dev)
    d2 = torch.full(shape, cgrid.BIG, dtype=torch.float32, device=dev)
    valid = torch.zeros(shape, dtype=torch.bool, device=dev) if knn else None
    if nq == 0:
        return (idx, d2, valid) if knn else (idx, d2)
    if not ready:
        boxes = _empty_boxes(grid, dev)
    units = torch.empty((units_max(nq, dims[0]),), dtype=torch.int32, device=dev)
    common = (
        grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(), grid.count.data_ptr(),
        qg.cell_xyz.data_ptr(), qg.cell_idx.data_ptr(), qg.cell_ok.data_ptr(),
        qg.count.data_ptr(), *dims,
    )
    work = (units.data_ptr(), units.numel() - 1, idx.data_ptr(), d2.data_ptr())
    extra = (None, 0) if counters is None else (counters.data_ptr(), counters.numel())
    lib = build.load()
    with torch.cuda.device(dev):
        if knn:
            err = lib.mm_grid_knn(*common, r2, k, int(exclude_self), n_p, boxes.data_ptr(),
                                  *work, valid.data_ptr(), *extra, build.stream_handle(dev))
        else:
            err = lib.mm_grid_nn(*common, _nn_r2(grid), n_p, boxes.data_ptr(), int(ready),
                                 *work, *extra, build.stream_handle(dev))
    kernel.launched()
    PACK_KERNEL.launched()
    build.check_launch(kernel, err)
    return (idx, d2, valid) if knn else (idx, d2)


def _radius(kernel: build.Kernel, grid, qg, q, r2: float, values=None, sigmas=None,
            sub: int = 0, counters=None, op: str = "sum"):
    """Launch the pre-pass and kernel H (MOMENTS_KERNEL), I (COUNT_KERNEL,
    each count less `sub`), J (SMOOTH_KERNEL, with `values` and `sigmas`)
    or L's sweep route (REDUCE_KERNEL, with `values` and `op`) on the card:
    H's (count, mean, cov), I's counts, J's field or L's (count, sum or
    max), their rows defaulted as the plain version's. `counters`, an int64
    tensor on the card, receives the kernel's per-warp counts
    (select_counters); the package's calls pass none."""
    dev, nq, dims = _operands(kernel, grid, qg, q)
    smooth, count = kernel is SMOOTH_KERNEL, kernel is COUNT_KERNEL
    reduced = kernel is REDUCE_KERNEL
    if reduced:
        channels = _reduce_channels(kernel, values, dev)
        outs = _reduce_outputs(nq, channels, op, dev)
    elif smooth:
        ns = len(sigmas)
        build.require(f"{kernel.name}: values", values, torch.float32, (None,), dev)
        if not 1 <= ns <= MAX_SIGMAS:
            raise ValueError(f"{kernel.name}: unsupported sigma count {ns}")
        outs = (torch.zeros((nq, ns), dtype=torch.float32, device=dev),)
    elif count:
        outs = (torch.full((nq,), -sub, dtype=torch.int32, device=dev),)
    else:
        outs = (torch.zeros((nq,), dtype=torch.float32, device=dev),
                torch.zeros((nq, 3), dtype=torch.float32, device=dev),
                torch.zeros((nq, 3, 3), dtype=torch.float32, device=dev))
    single = smooth or count
    if nq == 0:
        return outs[0] if single else outs
    boxes = _empty_boxes(grid, dev)
    units = torch.empty((units_max(nq, dims[0]),), dtype=torch.int32, device=dev)
    work = (boxes.data_ptr(), units.data_ptr(), units.numel() - 1)
    extra = (None, 0) if counters is None else (counters.data_ptr(), counters.numel())
    queries = (qg.cell_xyz.data_ptr(), qg.cell_idx.data_ptr(), qg.cell_ok.data_ptr(),
               qg.count.data_ptr(), *dims, r2)
    lib = build.load()
    with torch.cuda.device(dev):
        if smooth:
            recips = (ctypes.c_float * ns)(*_recips(sigmas))
            err = lib.mm_grid_smooth(
                grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(), grid.count.data_ptr(),
                values.data_ptr(), *queries, recips, ns, *work, outs[0].data_ptr(), *extra,
                build.stream_handle(dev))
        elif reduced:
            err = lib.mm_grid_reduce(
                grid.cell_xyz.data_ptr(), grid.cell_idx.data_ptr(), grid.count.data_ptr(),
                values.data_ptr(), values.shape[1], int(op == "max"), *queries, *work,
                *(a.data_ptr() for a in outs), *extra, build.stream_handle(dev))
        elif count:
            err = lib.mm_grid_count(
                grid.cell_xyz.data_ptr(), grid.count.data_ptr(), *queries, sub, *work,
                outs[0].data_ptr(), *extra, build.stream_handle(dev))
        else:
            err = lib.mm_grid_moments(
                grid.cell_xyz.data_ptr(), grid.count.data_ptr(), *queries, *work,
                *(a.data_ptr() for a in outs), *extra, build.stream_handle(dev))
    kernel.launched()
    PACK_KERNEL.launched()
    build.check_launch(kernel, err)
    return outs[0] if single else outs


#: the length of select_counters' buffer for G and K: 4 counts a warp of a
#: persistent grid of up to 32 resident CTAs of 4 warps on each of 256 SMs
#: (an H100 has 132)
COUNTERS_LEN = 4 * 4 * 32 * 256


def select_counters(name: str, grid, qg, q, *args) -> dict:
    """Kernel G ("grid_nn"), K ("grid_knn"), H ("grid_moments"), I
    ("grid_count"), J ("grid_smooth") or L's sweep route ("grid_reduce")
    launched once more on these
    operands with its counters on (not a path of the package; `args` those
    of its wrapper after q): the (query, candidate) pairs it compared, the
    tiles it visited, its units (warps' worth of queries) and the queries
    answered, summed over its warps, and the share of the units' lanes that
    answer a query; H, I, J and L also the members they added, each (query,
    point) within the radius (J's counts summed over its sigma groups, each
    of which walks the units again); I also the straddling (query, tile)
    pairs, its warp steps (one a tile visited for its bounds, then one a
    straddling query, or one a filled slot where the lanes loop) and the
    tiles counted a lane a query (`looped`), and so does L's max, which runs
    on I's schedule."""
    smooth = name == "grid_smooth"
    # L's max runs on I's schedule and gives I's counts
    count = name == "grid_count" or (name == "grid_reduce" and args[-1] == "max")
    if name in ("grid_nn", "grid_knn"):
        width = 4
        counters = torch.zeros((COUNTERS_LEN,), dtype=torch.int64, device=q.device)
        kernel = NN_KERNEL if name == "grid_nn" else KNN_KERNEL
        _select(kernel, grid, qg, q, *args, counters=counters)
    else:
        # 5 counts a warp (COUNT_COUNTERS for I and L's max), a warp for
        # each unit the buffer holds (rounded up to CTAs of 4), in each of
        # J's sigma groups
        width = COUNT_COUNTERS if count else 5
        groups = -(-len(args[1]) // SIGMA_GROUP) if smooth else 1
        warps = -(-units_max(q.shape[0], grid.cell_idx.shape[0]) // 4) * 4
        counters = torch.zeros((width * warps * groups,), dtype=torch.int64, device=q.device)
        if smooth:
            values, sigmas, r2 = args
            _radius(SMOOTH_KERNEL, grid, qg, q, r2, values, sigmas, counters=counters)
        elif name == "grid_reduce":
            values, r2, op = args
            _radius(REDUCE_KERNEL, grid, qg, q, r2, values, counters=counters, op=op)
        elif name == "grid_count":
            r2, include_self = (*args, True)[:2]
            _radius(COUNT_KERNEL, grid, qg, q, r2, sub=0 if include_self else 1,
                    counters=counters)
        else:
            _radius(MOMENTS_KERNEL, grid, qg, q, *args, counters=counters)
    sums = [int(v) for v in counters.view(-1, width).sum(dim=0)]
    pairs, tiles, units, answered = sums[:4]
    out = {"pairs_compared": pairs, "tiles_visited": tiles, "units": units,
           "answered": answered, "lane_share": answered / (32 * units) if units else None}
    if width >= 5:
        out["members"] = sums[4]
    if count:
        out.update(straddling=sums[5], steps=sums[6], looped=sums[7])
    return out


def _recips(sigmas: list[float]) -> list[float]:
    """The float32 value of 1 / (2 s^2) of each sigma: the plain version's
    constant (the reference's jnp.float32(1.0 / (2.0 * s * s)))."""
    return [cgrid._f32(1.0 / (2.0 * s * s)) for s in sigmas]


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


def _reduce(within: torch.Tensor, v: torch.Tensor, op: str) -> torch.Tensor:
    """Sum (one bmm of the {0,1} matrix) or max (out-of-radius at -BIG) of
    v (B, M, V) over within (B, Q, M)."""
    if op == "sum":
        return torch.bmm(within.to(torch.float32), v)
    return torch.where(within[..., None], v[:, None], -cgrid.BIG).amax(dim=2)


def reduce_ref(
    grid, qg, q: torch.Tensor, values: torch.Tensor, r2: float, op: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch reduce: core/grid.grid_query over the query buckets
    with the values gathered into the cell layout, each chunk's (B, Cq, 27 C)
    {0,1} member plane, its row sums (the count) and a bmm with the values
    (sum) or their masked amax, non-members at -BIG (max)."""

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, v):
        within = cand_ok[:, None, :] & (cgrid._d2(q_block, cand_xyz) <= r2)
        return within.sum(dim=-1).to(torch.int32), _reduce(within, v, op)

    default = 0.0 if op == "sum" else -cgrid.BIG
    (count, out), _ = cgrid.grid_query(q, grid, tile_fn, (0, default), p_values=values, qg=qg)
    return count, out


def reduce_list_ref(
    grid, q: torch.Tensor, values: torch.Tensor, r2: float, op: str, chunk: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch reduce_list: each query's 27 neighbour blocks
    gathered directly (core/grid._candidates of the bucket its coordinates
    fall in), `chunk` queries at a time; the values of a chunk's candidates
    gathered by index (an empty slot's index n reads a zero row), then the
    count, and the bmm or the masked amax of `_reduce`."""
    v_pad = cgrid._pad_rows(values)
    bucket = cgrid._bucket_of(cgrid._cells(q, grid.cell_size), grid.dims)
    counts, outs = [], []
    for s in range(0, q.shape[0], chunk):
        _, cand_xyz, cand_ok, cand_idx = cgrid._candidates(grid, bucket[s : s + chunk])
        d2 = cgrid._d2(q[s : s + chunk, None, :], cand_xyz)  # (B, 1, M)
        within = cand_ok[:, None, :] & (d2 <= r2)
        counts.append(within.sum(dim=-1)[:, 0].to(torch.int32))
        outs.append(_reduce(within, v_pad[cand_idx], op)[:, 0])
    if not counts:
        return _reduce_outputs(0, values.shape[1], op, q.device)
    return torch.cat(counts), torch.cat(outs)


def reduce_error(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest |got - want| of L's sums (Q, C) over `scale`, the sums
    of |v| over each query's members (reduce_ref or reduce_list_ref of the
    values' magnitudes): REDUCE_RTOL bounds it. A difference where the
    scale is 0 is infinite, and so is an entry NaN on one side only (a NaN
    never compares within the limit); entries equal or NaN on both sides
    agree."""
    same = (got == want) | (got.isnan() & want.isnan())
    rel = torch.where(same, 0.0, (got - want).abs() / scale)
    return float(torch.where(rel.isnan(), math.inf, rel).max()) if rel.numel() else 0.0


def smooth_ref(
    grid, qg, q: torch.Tensor, values: torch.Tensor, sigmas: list[float], r2: float
) -> torch.Tensor:
    """Plain PyTorch Gaussian smoothing: core/grid.grid_query over the query
    buckets with the values gathered into the cell layout, each chunk's
    (B, Cq, 27 C) plane of _d2, the member weights exp(-d2 c) of each sigma,
    a bmm with the values and a row sum."""
    recips = _recips(sigmas)

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, v):
        d2 = cgrid._d2(q_block, cand_xyz)  # (B, Cq, M)
        base_ok = (cand_ok[:, None, :] & (d2 <= r2)).to(torch.float32)
        outs = []
        for c in recips:
            w = torch.exp(-d2 * c) * base_ok
            num = torch.bmm(w, v[..., None])[..., 0]
            outs.append(num / w.sum(dim=-1).clamp_min(1e-12))
        return torch.stack(outs, dim=-1)

    out, _ = cgrid.grid_query(q, grid, tile_fn, 0.0, p_values=values, qg=qg)
    return out


def knn_ref(
    grid, qg, q: torch.Tensor, n_p: int, k: int, r2: float, exclude_self: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch k nearest: core/grid.grid_query over the query buckets,
    each chunk's (B, Cq, 27 C) plane of _d2 with the empty and duplicated
    candidates at BIG (and, with exclude_self, d2 <= 1e-12 too), sorted
    stably (ties keep the first candidate position), the first k taken;
    entries at BIG or beyond -> (0, BIG), valid = d2 <= r2, then idx >= n_p
    -> 0."""

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        d2 = torch.where(cand_ok[:, None, :], cgrid._d2(q_block, cand_xyz), cgrid.BIG)
        if exclude_self:
            d2 = torch.where(d2 <= 1e-12, cgrid.BIG, d2)
        k_eff = min(k, d2.shape[-1])
        d2s, pos = torch.sort(d2, dim=-1, stable=True)
        d2k, pos = d2s[..., :k_eff], pos[..., :k_eff]
        idx = torch.gather(cand_idx[:, None, :].expand(d2.shape), -1, pos)
        far = d2k >= cgrid.BIG
        idx = torch.where(far, 0, idx)
        d2k = torch.where(far, cgrid.BIG, d2k)
        valid = d2k <= r2
        if k_eff < k:
            pad = k - k_eff
            idx = torch.nn.functional.pad(idx, (0, pad))
            d2k = torch.nn.functional.pad(d2k, (0, pad), value=cgrid.BIG)
            valid = torch.nn.functional.pad(valid, (0, pad))
        return idx.to(torch.int32), d2k, valid

    (idx, d2k, valid), _ = cgrid.grid_query(q, grid, tile_fn, (0, cgrid.BIG, False), qg=qg)
    idx = torch.where(idx >= n_p, 0, idx)
    return idx, d2k, valid
