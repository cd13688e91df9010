"""The yardstick of the hand kernels: the chip's peaks, each kernel's least
bytes, and the kernel names that the device trace carries.

A launch's least time is the bytes its operation must move over the
chip's peak bandwidth: each input point's coordinates and values read
once, each output written once, at float32 (indices and counts at 4
bytes, flags at 1), counted from the operation's logical sizes: the valid
points of a target grid or mask, the answered queries of a query grid,
the channels, neighbours and sigmas (P, Q, C, k, S), never from the
padded capacities, packed tiles, grids or boxes a wrapper happens to pass.
The bound is by bytes alone: these kernels compare distances, and their
operations per byte sit far below the chip's ridge point, so bytes bound
every one of them. The counts do not depend on the kernel's design, so a
rewritten kernel is judged on the same work.

The valid sizes are read from the call's masks on the device, so the
hooks run in steps of their own that nobody times (`trace.count_bytes`):
each returns a device count, summed once the steps are done.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM5 80 GB, published: HBM3 bandwidth (bytes/s) at the
#: 700 W power limit
PEAK_BYTES_PER_S = 3.35e12

F32 = 4
I32 = 4
FLAG = 1


def _valid(mask: torch.Tensor) -> torch.Tensor:
    """The valid entries of a mask, as a device count (no host read)."""
    return torch.count_nonzero(mask)


def _answered(qg, q) -> torch.Tensor | int:
    """The queries a query grid answers (its valid slots), or all of q."""
    return _valid(qg.cell_ok) if qg is not None else int(q.shape[0])


def _rows(t) -> int:
    return int(t.shape[0])


# each function takes the wrapper's own arguments and returns the bytes
# its operation must move (the wrapper's signature in mapmerge_torch/kernels)
def _grid_nn_query(grid, qg, q, n_p, boxes=None):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    return 3 * F32 * (nq + n_t) + nq * (I32 + F32)


def _grid_moments(grid, qg, q, r2):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    return 3 * F32 * (nq + n_t) + nq * (I32 + 3 * F32 + 9 * F32)


def _grid_count(grid, qg, q, r2, include_self=True):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    return 3 * F32 * (nq + n_t) + nq * I32


def _grid_smooth(grid, qg, q, values, sigmas, r2):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    return 3 * F32 * nq + n_t * (3 * F32 + F32) + nq * len(sigmas) * F32


def _grid_knn(grid, qg, q, n_p, k, r2, exclude_self=False):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    return 3 * F32 * (nq + n_t) + nq * k * (I32 + F32 + FLAG)


def _grid_reduce(grid, qg, q, values, r2, op):
    nq, n_t = _answered(qg, q), _valid(grid.cell_ok)
    c = int(values.shape[1]) if values.dim() > 1 else 1
    return 3 * F32 * nq + n_t * (3 * F32 + c * F32) + nq * (I32 + c * F32)


def _grid_reduce_list(grid, q, values, r2, op, boxes=None):
    return _grid_reduce(grid, None, q, values, r2, op)


def _spfh_grid(grid, q_ok, normals, r2):
    nq, n_t = _valid(q_ok), _valid(grid.cell_ok)
    return nq * 6 * F32 + n_t * (6 * F32 + FLAG) + nq * (33 * F32 + F32)


def _spfh_tile(q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok, r2):
    nq = int(q_xyz.shape[0]) * int(q_xyz.shape[1])
    return nq * 6 * F32 + _valid(cand_ok) * 6 * F32 + nq * (33 * F32 + F32)


def _masked_queries(q, p, mask):
    """The valid queries and targets of a dense sweep whose queries are its
    targets (SIFT's octaves, the outlier pass, the normals), or all of q."""
    n_t = _valid(mask)
    return (n_t if q is p or q.data_ptr() == p.data_ptr() else _rows(q)), n_t


def _sift_scale_space(qc, pc, vals, mask, sigmas, r2_bound, tile=1024, *, packed=None):
    nq, n_t = _masked_queries(qc, pc, mask)
    return 3 * F32 * nq + n_t * (3 * F32 + F32) + len(sigmas) * nq * F32


def _sift_knn(q, p, p_mask, k, r2, tile=1024, *, packed=None):
    nq, n_t = _masked_queries(q, p, p_mask)
    return 3 * F32 * (nq + n_t) + nq * k * (I32 + FLAG)


def _radius_count(qc, pc, mask, r2, tile=1024):
    nq, n_t = _masked_queries(qc, pc, mask)
    return 3 * F32 * (nq + n_t) + nq * I32


def _radius_moments(qc, pc, mask, r2, tile=1024):
    nq, n_t = _masked_queries(qc, pc, mask)
    return 3 * F32 * (nq + n_t) + nq * 13 * F32


def _nn(q, p, p_mask=None):
    # one pair, or a batch of pairs on a leading axis
    nq = q.numel() // 3
    n_t = _valid(p_mask) if p_mask is not None else p.numel() // 3
    return 3 * F32 * (nq + n_t) + nq * (I32 + F32)


#: the wrapper of each hand kernel's operation -> its least bytes
BYTES = {
    "mapmerge_torch.kernels.grid:nn_query": _grid_nn_query,
    "mapmerge_torch.kernels.grid:moments": _grid_moments,
    "mapmerge_torch.kernels.grid:count": _grid_count,
    "mapmerge_torch.kernels.grid:smooth": _grid_smooth,
    "mapmerge_torch.kernels.grid:knn": _grid_knn,
    "mapmerge_torch.kernels.grid:reduce": _grid_reduce,
    "mapmerge_torch.kernels.grid:reduce_list": _grid_reduce_list,
    "mapmerge_torch.kernels.spfh:spfh_grid": _spfh_grid,
    "mapmerge_torch.kernels.spfh:spfh_tile": _spfh_tile,
    "mapmerge_torch.kernels.sift:scale_space": _sift_scale_space,
    "mapmerge_torch.kernels.sift:knn": _sift_knn,
    "mapmerge_torch.kernels.radius:count": _radius_count,
    "mapmerge_torch.kernels.radius:moments": _radius_moments,
    "mapmerge_torch.kernels.nn:nearest_neighbor": _nn,
    "mapmerge_torch.kernels.nn:nearest_neighbor_batched": _nn,
}

#: the __global__ functions of mapmerge_torch/csrc, pre-passes included, as
#: the device trace names them (a template's arguments follow the name)
KERNELS = (
    "grid_select_kernel", "grid_radius_kernel", "grid_count_kernel",
    "grid_max_kernel", "grid_reduce_list_kernel", "grid_pack_kernel",
    "nn_split_kernel", "nn_reduce_kernel", "resident_kernel", "order_kernel",
    "streamed_kernel", "scale_space_kernel", "knn_kernel", "bin_count_kernel",
    "bin_scan_kernel", "bin_scatter_kernel", "spfh_shared_kernel",
    "spfh_grid_kernel", "pack_kernel",
)


def is_hand_kernel(name: str, kernels=KERNELS) -> bool:
    """Whether a device event's name is one of `kernels`: the name itself,
    after `void ` and any namespace, before its template arguments or
    parameter list."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = base.split("(", 1)[0].split("<", 1)[0].strip()
    return base.rsplit("::", 1)[-1] in kernels


def share_percent(bytes_total: float, device_s: float) -> float | None:
    """The least time of `bytes_total` over the kernels' device seconds, in
    percent; None where no hand kernel ran (a share is never reported as
    0 for want of a reading)."""
    if device_s <= 0 or bytes_total <= 0:
        return None
    return 100.0 * bytes_total / PEAK_BYTES_PER_S / device_s
