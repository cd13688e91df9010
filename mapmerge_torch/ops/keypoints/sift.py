"""SIFT 3D keypoints on colour intensity (port of
mapmerge_tpu/ops/keypoints/sift.py).

pcl::SIFTKeypoint over the RGB intensity: per octave, nr_scales + 3
Gaussian-smoothed intensity fields, their differences (DoG), and an extremum
test of each point against its 25 nearest neighbours' DoG values at the
adjacent levels. Between octaves the cloud is voxel-downsampled with leaf
2 x octave scale, at a third of the capacity. Keypoints of all octaves are
pooled and the top `max_keypoints` by |DoG| kept.

Each octave resolves its neighbour engine on its own capacity, as the
reference does. On the cell grid the scale space is
`grid.grid_gaussian_smooth` and the 25-NN is bounded at
_GRID_KNN_RADIUS_SCALES octave scales (`radius_neighbors`); on the dense
engine both are exact sweeps over every point, the 25-NN unbounded (PCL's
semantics): the hand-written kernels of kernels/sift.py, `scale_space`
(kernel C) and `knn` (kernel D), each launched once per dense octave on the
points that `_dense_octave` centres and packs once for both.
"""

from __future__ import annotations

import torch

from mapmerge_torch.core.cloud import FAR, PointCloud
from mapmerge_torch.kernels import sift as sift_kernels
from mapmerge_torch.kernels import tiles
from mapmerge_torch.ops import grid
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import (
    BIG,
    _center,
    _f32,
    _resolve_engine,
    radius_neighbors,
)

_KNN = 25  # PCL's spatial neighborhood for extremum tests
#: radius, in octave scales, bounding the 25-NN under the grid engine:
#: points lie at least the previous octave's voxel leaf apart, so 8 scales
#: cover 25 surface neighbours (mapmerge_tpu/ops/keypoints/sift.py:45-48)
_GRID_KNN_RADIUS_SCALES = 8.0


def _intensity(rgb: torch.Tensor) -> torch.Tensor:
    """PCL IntensityFieldAccessor<PointXYZRGB> on 8-bit channels."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (299.0 * r + 587.0 * g + 114.0 * b) * (255.0 / 1000.0)


def _dense_octave(cloud: PointCloud, intensity: torch.Tensor | None = None) -> tuple:
    """A dense octave's operands of kernels C and D, made once for both:
    (pc, vals, packed), the points centred on their valid mean (queries and
    targets alike), the intensities zeroed where masked (None without
    `intensity`) and the tile pre-pass `tiles.pack` of the two."""
    _, pc = _center(cloud.xyz, cloud.xyz, cloud.mask)
    vals = None if intensity is None else torch.where(cloud.mask, intensity, 0.0)
    return pc, vals, tiles.pack(pc, vals, cloud.mask)


def _scale_space(
    cloud: PointCloud,
    intensity: torch.Tensor,
    sigmas: list[float],
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
    dense: tuple | None = None,
) -> torch.Tensor:
    """Gaussian-smoothed intensities for every sigma: (S, P), each bounded at
    3 sigma_max. The grid's query overflow is dropped here, as in the
    reference: the query grid is the point grid, so it equals the build
    overflow that the feature stage's probe reports. A dense octave takes
    `dense`, its _dense_octave(cloud, intensity), or makes it."""
    if _resolve_engine(engine, cloud.capacity) == "grid":
        out, _ = grid.grid_gaussian_smooth(
            cloud.xyz, cloud.xyz, intensity, sigmas, p_mask=cloud.mask,
            scan_cap=scan_cap,
        )  # (P, S)
        return out.T
    r2_bound = _f32((3.0 * max(sigmas)) ** 2)
    pc, vals, packed = dense if dense is not None else _dense_octave(cloud, intensity)
    return sift_kernels.scale_space(
        pc, pc, vals, cloud.mask, sigmas, r2_bound, tile, packed=packed
    )  # (S, P)


def _knn(
    cloud: PointCloud,
    base: float,
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
    dense: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 25-NN of every point for the extremum test: (indices (P, 25)
    int64, valid (P, 25) bool), the point itself (slot 0) left out. On the
    grid, `radius_neighbors` bounded at _GRID_KNN_RADIUS_SCALES octave
    scales; on the dense engine kernel D, unbounded (a radius of 1e6, which
    the masked targets at BIG meet, as in the reference), on `dense`
    (_dense_octave's) or on its own."""
    p_oct = cloud.capacity
    k = min(_KNN + 1, p_oct)
    if _resolve_engine(engine, p_oct) == "grid":
        idx, _, nmask, _ = radius_neighbors(
            cloud.xyz, cloud.xyz, radius=_GRID_KNN_RADIUS_SCALES * base, k=k,
            p_mask=cloud.mask, tile=tile, engine=engine, scan_cap=scan_cap,
        )
    else:
        pc, _, packed = dense if dense is not None else _dense_octave(cloud)
        idx, nmask = sift_kernels.knn(
            pc, pc, cloud.mask, k, _f32(1.0e6 * 1.0e6), tile, packed=packed
        )
    return idx[:, 1:].to(torch.int64), nmask[:, 1:]


def detect_keypoints_sift(
    cloud: PointCloud,
    min_scale: float,
    octaves: int,
    scales_per_octave: int,
    min_contrast: float,
    max_keypoints: int,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Keypoints:
    """Reference features.cpp:45-62: setScales(min_scale, octaves, scales),
    setMinimumContrast(min_contrast)."""
    dev = cloud.device
    cand_resp, cand_xyz = [], []
    base = float(min_scale)
    oct_cloud = cloud
    for octave in range(octaves):
        p_oct = oct_cloud.capacity
        intensity = _intensity(oct_cloud.rgb)
        dense = None
        if _resolve_engine(engine, p_oct) == "dense":
            dense = _dense_octave(oct_cloud, intensity)
        nbr_idx, nbr_ok = _knn(oct_cloud, base, tile, engine, scan_cap, dense=dense)

        n_s = scales_per_octave + 3
        sigmas = [base * (2.0 ** (s / scales_per_octave)) for s in range(n_s)]
        smoothed = _scale_space(
            oct_cloud, intensity, sigmas, tile, engine, scan_cap, dense=dense
        )
        dog = smoothed[1:] - smoothed[:-1]  # (S-1, P)

        for s in range(1, dog.shape[0] - 1):
            val = dog[s]
            nbr_vals = dog[s - 1 : s + 2][:, nbr_idx]  # (3, P, K)
            # nanmax/nanmin over valid neighbours as -inf/+inf masking; the
            # own adjacent levels always count (fmax/fmin in the reference)
            hi = torch.maximum(
                torch.where(nbr_ok[None], nbr_vals, -torch.inf).amax(dim=(0, 2)),
                torch.maximum(dog[s - 1], dog[s + 1]),
            )
            lo = torch.minimum(
                torch.where(nbr_ok[None], nbr_vals, torch.inf).amin(dim=(0, 2)),
                torch.minimum(dog[s - 1], dog[s + 1]),
            )
            is_ext = (val > hi) | (val < lo)
            keep = oct_cloud.mask & is_ext & (val.abs() > min_contrast)
            cand_resp.append(torch.where(keep, val.abs(), -BIG))
            cand_xyz.append(oct_cloud.xyz)
        if octave < octaves - 1:
            oct_cloud = voxel_downsample(
                oct_cloud, 2.0 * base,
                out_capacity=max(p_oct // 3, min(2048, p_oct)),
            )
        base *= 2.0

    resp_all = torch.cat(cand_resp)
    xyz_all = torch.cat(cand_xyz)
    k = min(max_keypoints, resp_all.shape[0])
    top_resp, top_i = torch.topk(resp_all, k)
    kp_mask = top_resp > -BIG / 2
    kp_xyz = torch.where(kp_mask[:, None], xyz_all[top_i], FAR)
    if k < max_keypoints:
        pad = max_keypoints - k
        kp_xyz = torch.cat(
            [kp_xyz, torch.full((pad, 3), FAR, dtype=torch.float32, device=dev)]
        )
        top_resp = torch.cat([top_resp, torch.zeros((pad,), device=dev)])
        kp_mask = torch.cat(
            [kp_mask, torch.zeros((pad,), dtype=torch.bool, device=dev)]
        )
    found = (resp_all > -BIG / 2).sum().to(torch.int32)
    return Keypoints(
        xyz=kp_xyz,
        response=torch.where(kp_mask, top_resp, 0.0),
        mask=kp_mask,
        truncated=(found - max_keypoints).clamp_min(0),
    )
