"""The tile pre-pass of the culled dense-neighbourhood kernels: the CUDA
kernel of `csrc/tiles.cu` and its plain PyTorch version.

SIFT's kernels C and D (kernels/sift.py) read the points in tiles of TILE
consecutive points (the radius sweeps E and F, kernels/radius.py, write
the same layout with their own pre-pass):
`pack` writes them as float4 (x, y, z, value) with x = NaN where masked,
and the box of each tile's valid points, by which a kernel skips, exactly,
the tiles no query of a warp can reach (`tile_bound` is the plain version
of that bound; csrc/cull.cuh the kernels' own). Not a port of a TPU kernel.

`pack` equals `pack_ref`: the same values, NaN where NaN, the int bits of
the boxes' fourth column exactly. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises, with no copy to the host and no
synchronisation.
"""

from __future__ import annotations

import torch

from mapmerge_torch.kernels import build

#: points a tile (csrc/cull.cuh: kT)
TILE = 32
#: a tile holding no masked point: its first masked index (csrc/tiles.cu)
_NO_MASKED = 2**31 - 1

PACK_KERNEL = build.Kernel(
    name="tiles_pack",
    source="mapmerge_torch/csrc/tiles.cu",
    replaces="mapmerge_tpu/ops/keypoints/sift.py:59",
)


def pack(
    p: torch.Tensor, vals: torch.Tensor | None, mask: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass of kernels C and D: (pts (n_tiles * TILE, 4),
    boxes (n_tiles, 2, 4)) float32, as pack_ref defines them. A CPU tensor
    takes pack_ref; a CUDA tensor launches the kernel or raises."""
    if p.device.type == "cpu":
        return pack_ref(p, vals, mask)
    kernel = PACK_KERNEL
    dev = build.cuda_device(kernel, p)
    np_ = p.shape[0]
    build.require("p", p, torch.float32, (None, 3), dev)
    if vals is not None:
        build.require("vals", vals, torch.float32, (np_,), dev)
    if mask is not None:
        build.require("mask", mask, torch.bool, (np_,), dev)
    if not 1 <= np_ < 2**31 // 4 - TILE:
        raise ValueError(f"{kernel.name}: unsupported size P={np_}")
    n_tiles = -(-np_ // TILE)
    pts = torch.empty((n_tiles * TILE, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((n_tiles, 2, 4), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.mm_tiles_pack(
            p.data_ptr(), None if vals is None else vals.data_ptr(),
            None if mask is None else mask.data_ptr(), np_, pts.data_ptr(),
            boxes.data_ptr(), build.stream_handle(dev),
        )
    kernel.launched()
    build.check_launch(kernel, err)
    return pts, boxes


def pack_ref(
    p: torch.Tensor, vals: torch.Tensor | None, mask: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pre-pass. pts (n_tiles * TILE, 4): (x, y, z, value)
    per point, x = NaN where masked, value 0 where `vals` is None; the rows
    past P are (NaN, 0, 0, 0). boxes (n_tiles, 2, 4), for each tile of TILE
    consecutive points: lo = (the least x, y, z of its valid points, its
    first masked index as int32 bits, 2^31 - 1 if none), hi = (the largest,
    its first point index as int32 bits); a tile with no valid point has lo
    = +inf and hi = -inf."""
    np_, dev = p.shape[0], p.device
    n_tiles = -(-np_ // TILE)
    pad = n_tiles * TILE - np_
    valid = torch.ones(np_, dtype=torch.bool, device=dev) if mask is None else mask
    valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    xyz = torch.cat([p, torch.zeros((pad, 3), dtype=torch.float32, device=dev)])
    w = torch.zeros(np_, dtype=torch.float32, device=dev) if vals is None else vals
    w = torch.cat([w, torch.zeros(pad, dtype=torch.float32, device=dev)])
    x = torch.where(valid, xyz[:, 0], torch.nan)
    pts = torch.stack([x, xyz[:, 1], xyz[:, 2], w], dim=1)
    v = valid.view(n_tiles, TILE, 1)
    tiles = xyz.view(n_tiles, TILE, 3)
    lo = torch.where(v, tiles, torch.inf).amin(dim=1)
    hi = torch.where(v, tiles, -torch.inf).amax(dim=1)
    index = torch.arange(n_tiles * TILE, dtype=torch.int32, device=dev).view(n_tiles, TILE)
    masked = ~valid.view(n_tiles, TILE) & (index < np_)
    first = torch.where(masked, index, _NO_MASKED).amin(dim=1)
    lo = torch.cat([lo, first.view(torch.float32)[:, None]], dim=1)
    hi = torch.cat([hi, index[:, 0].contiguous().view(torch.float32)[:, None]], dim=1)
    return pts, torch.stack([lo, hi], dim=1)


def tile_bound(q: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(Q, n_tiles) lower bounds of sq_dists from each query to the valid
    points of each tile of `boxes` (pack_ref's): q clamped into the box and
    the distance to that point taken as sq_dists takes it. Rounding is
    monotone, so each bound is <= sq_dists to every valid point of its
    tile: the plain version of the culling bound of kernels C-F (+inf for a
    tile with no valid point)."""
    lo, hi = boxes[None, :, 0, :3], boxes[None, :, 1, :3]
    d = q[:, None] - torch.minimum(torch.maximum(q[:, None], lo), hi)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
