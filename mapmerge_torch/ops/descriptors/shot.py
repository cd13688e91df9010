"""SHOT colour descriptor, SHOT1344 (port of
mapmerge_tpu/ops/descriptors/shot.py).

pcl::SHOTColorEstimation as the reference chooses it
(dispatch_descriptors.h:44-46):
  - a local reference frame per keypoint: the (R - d)-weighted covariance
    of the neighbour offsets, the analytic eigensolver, and signs by the
    weighted majority of neighbours (pcl SHOTLocalReferenceFrameEstimation);
  - shape: 32 volumes (8 azimuth x 2 elevation x 2 radial) x 11 bins over
    cos(n_j, z_lrf) = 352 values;
  - colour: 32 volumes x 31 bins over the mean L1 CIELab distance to the
    keypoint's colour = 992 values;
  - PCL's quadrilinear soft binning: each neighbour votes 1 - |residual|
    into its own (volume, bin) cell along each of the four axes, and
    |residual| into the adjacent cell along that axis (azimuth and the
    histogram bin wrap; elevation and radial votes outside the sphere are
    dropped); then the whole descriptor is L2-normalised.
The keypoint's colour is its nearest surface point's, as in the reference.

The votes are fractional, so they are summed in one fixed order
(`_fixed_order_hist`), not by scatter_add_, which on CUDA adds in an order
that varies from run to run: a descriptor is the same bits on every run.
"""

from __future__ import annotations

import math

import torch

from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.ops.descriptors.base import Descriptors, keypoint_neighborhoods
from mapmerge_torch.ops.eigh3 import eigvalsh3
from mapmerge_torch.ops.keypoints import Keypoints
from mapmerge_torch.ops.neighbors import _f32
from mapmerge_torch.ops.normals import SurfaceNormals
from mapmerge_torch.ops.rigid import _eigvecs_from_vals

_AZIMUTH = 8
_ELEVATION = 2
_RADIAL = 2
_SHAPE_BINS = 11
_COLOR_BINS = 31
_VOLUMES = _AZIMUTH * _ELEVATION * _RADIAL  # 32
SHOT_DIM = _VOLUMES * _SHAPE_BINS + _VOLUMES * _COLOR_BINS  # 1344

_RGB_TO_XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_WHITE = (0.950456, 1.0, 1.088754)  # D65
#: elements of one (rows, votes, width) one-hot block of _fixed_order_hist
_ONEHOT_BLOCK = 1 << 24


def _const(x, device) -> torch.Tensor:
    """A float32 constant on `device`: dividing by a tensor is a true
    division on every device (a Python-scalar divisor is a reciprocal
    multiply on CUDA, which moves values across bin edges)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _dot(a: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """(K, M, 3) . (K, 3) -> (K, M)."""
    return torch.einsum("kmi,ki->km", a, axis)


def _local_reference_frames(
    kp_xyz: torch.Tensor,  # (K, 3)
    nbr_xyz: torch.Tensor,  # (K, M, 3)
    nbr_ok: torch.Tensor,  # (K, M)
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x_axis, y_axis, z_axis (K, 3) each, ok (K,))."""
    off = nbr_xyz - kp_xyz[:, None, :]
    d = torch.sqrt((off * off).sum(dim=-1).clamp_min(1e-12))
    w = torch.where(nbr_ok, (_f32(radius) - d).clamp_min(0.0), 0.0)  # (K, M)
    wsum = w.sum(dim=-1)
    cov = torch.einsum("kmi,kmj->kij", off * w[..., None], off)
    cov = cov / wsum.clamp_min(1e-9)[:, None, None]

    lam = eigvalsh3(cov)
    v = _eigvecs_from_vals(cov, lam)  # columns ascending

    def fix_sign(axis):
        # majority of the weighted neighbours on the positive side
        s = (torch.sign(_dot(off, axis)) * w).sum(dim=-1)
        return axis * torch.where(s >= 0, 1.0, -1.0)[:, None]

    x_axis = fix_sign(v[..., 2])  # largest
    z_axis = fix_sign(v[..., 0])  # smallest
    # orthogonalise x against z, then y = z x x
    x_axis = x_axis - (x_axis * z_axis).sum(dim=-1, keepdim=True) * z_axis
    xn = torch.sqrt((x_axis * x_axis).sum(dim=-1).clamp_min(1e-12))
    x_axis = x_axis / xn[:, None]
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    ok = (wsum > 0) & (lam[..., 2] > 1e-12)
    return x_axis, y_axis, z_axis, ok


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Cube root of t >= 0 as a float32 power (torch has no cbrt): within
    about 1e-7 relative of jnp.cbrt on the ranges used here."""
    return t.clamp_min(0.0).pow(1.0 / 3.0)


def _rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> CIELab (D65)."""
    dev = rgb.device
    c = torch.where(
        rgb > 0.04045,
        ((rgb + 0.055) / _const(1.055, dev)) ** 2.4,
        rgb / _const(12.92, dev),
    )
    xyz = c @ _const(_RGB_TO_XYZ, dev).T
    t = xyz / _const(_WHITE, dev)
    f = torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)
    ty = t[..., 1]
    lum = torch.where(ty > 0.008856, 116.0 * _cbrt(ty) - 16.0, 903.3 * ty)
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([lum, a, b], dim=-1)


def _fixed_order_hist(
    cols: torch.Tensor, weights: torch.Tensor, width: int
) -> torch.Tensor:
    """(K, width) sums of `weights` (K, N) into the columns `cols` (K, N):
    a one-hot product reduced over N, so every cell adds its votes in one
    fixed order and repeats bit for bit. Rows go in blocks of at most
    _ONEHOT_BLOCK one-hot elements."""
    k, n = cols.shape
    rows = max(1, _ONEHOT_BLOCK // max(n * width, 1))
    ids = torch.arange(width, device=cols.device)
    blocks = [
        torch.where(
            cols[s : s + rows, :, None] == ids, weights[s : s + rows, :, None], 0.0
        ).sum(dim=1)
        for s in range(0, k, rows)
    ]
    return torch.cat(blocks) if blocks else weights.new_zeros((0, width))


def _adjacent(
    value: torch.Tensor, cells: int, wrap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-centre soft binning of `value` in cell units: (own cell,
    residual to its centre in [-0.5, 0.5], adjacent cell mod `wrap`)."""
    own = torch.floor(value + 0.5).clamp(0, cells - 1)
    res = value - own
    return own, res, torch.remainder(own + torch.sign(res), wrap)


def compute_shot(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """SHOT1344 at each keypoint; valid with a frame and >= 5 neighbours."""
    idx, d2, nmask = keypoint_neighborhoods(
        cloud, normals, keypoints, radius, max_neighbors, tile, engine,
        scan_cap=scan_cap,
    )
    nbr_xyz, nbr_nrm, nbr_rgb = cloud.xyz[idx], normals.normals[idx], cloud.rgb[idx]
    dist = torch.sqrt(d2.clamp_min(0.0))
    dev = dist.device

    x_ax, y_ax, z_ax, lrf_ok = _local_reference_frames(
        keypoints.xyz, nbr_xyz, nmask, radius
    )
    off = nbr_xyz - keypoints.xyz[:, None, :]
    lx, ly, lz = _dot(off, x_ax), _dot(off, y_ax), _dot(off, z_ax)

    # azimuth: 8 sectors over [-pi, pi), the adjacent one wraps
    pa = (torch.atan2(ly, lx) + math.pi) / _const(2 * math.pi, dev) * _AZIMUTH
    a_bin = torch.floor(pa).clamp(0, _AZIMUTH - 1)
    ra = pa - (a_bin + 0.5)
    a_adj = torch.remainder(a_bin + torch.sign(ra), _AZIMUTH)
    # elevation: inclination in [0, pi]; cell 0 is the upper half (centre
    # 45 deg), cell 1 the lower; no wrap
    cos_el = (lz / dist.clamp_min(1e-12)).clamp(-1.0, 1.0)
    pe = torch.arccos(cos_el) / _const(math.pi / 2.0, dev)
    e_cell = torch.floor(pe).clamp(0, 1)
    re = pe - (e_cell + 0.5)
    e_adj_cell = e_cell + torch.sign(re)
    e_adj_ok = (e_adj_cell >= 0) & (e_adj_cell <= 1)
    e_bin = 1.0 - e_cell  # volume index: 1 = upper (lz >= 0)
    e_adj = 1.0 - e_adj_cell.clamp(0, 1)
    # radial: shells split at radius / 2; no wrap
    pr = dist / _const(radius / 2.0, dev)
    r_bin = torch.floor(pr).clamp(0, 1)  # 1 = outer shell
    rr = pr - (r_bin + 0.5)
    r_adj = r_bin + torch.sign(rr)
    r_adj_ok = (r_adj >= 0) & (r_adj <= 1)
    r_adj = r_adj.clamp(0, 1)

    def vol_of(a, e, r):
        return a * (_ELEVATION * _RADIAL) + e * _RADIAL + r

    vol = vol_of(a_bin, e_bin, r_bin)  # (K, M) in [0, 32)

    # shape bins: (1 + cos) / 2 * 10 in [0, 10]; PCL wraps the adjacent bin
    # modulo nbins - 1, reproduced as is
    cos_t = _dot(nbr_nrm, z_ax).clamp(-1.0, 1.0)
    bd_s = (cos_t + 1.0) / _const(2.0, dev) * (_SHAPE_BINS - 1)
    s_bin, rs, s_adj = _adjacent(bd_s, _SHAPE_BINS, _SHAPE_BINS - 1)

    # colour bins: the mean per-channel CIELab L1 distance to the keypoint's
    # colour, channels over L/100, a/120, b/120
    lab_n = _rgb_to_lab(nbr_rgb)
    lab_k = _rgb_to_lab(nbr_rgb[:, 0, :])[:, None, :]
    span = _const((100.0, 120.0, 120.0), dev)
    dcol = ((lab_n - lab_k).abs() / span).sum(dim=-1) / _const(3.0, dev)
    bd_c = dcol.clamp(0.0, 1.0) * (_COLOR_BINS - 1)
    c_bin, rc, c_adj = _adjacent(bd_c, _COLOR_BINS, _COLOR_BINS - 1)

    w = (nmask & lrf_ok[:, None]).to(torch.float32)
    spatial_votes = (
        (vol_of(a_adj, e_bin, r_bin), w * ra.abs()),
        (vol_of(a_bin, e_adj, r_bin), w * re.abs() * e_adj_ok),
        (vol_of(a_bin, e_bin, r_adj), w * rr.abs() * r_adj_ok),
    )

    def soft_hist(bin_own, bin_adj, rb, nbins):
        """(K, 32 * nbins): the own (volume, bin) cell gets the sum over the
        four axes of 1 - |residual|; each axis's adjacent cell gets
        |residual| at the own coordinates of the other axes."""
        central = (
            (1.0 - rb.abs()) + (1.0 - ra.abs()) + (1.0 - re.abs())
            + (1.0 - rr.abs())
        )
        votes = (
            (vol, bin_own, w * central),
            (vol, bin_adj, w * rb.abs()),
        ) + tuple((v, bin_own, ww) for v, ww in spatial_votes)
        cols = torch.cat([(v * nbins + b).to(torch.int64) for v, b, _ in votes], 1)
        return _fixed_order_hist(
            cols, torch.cat([ww for _, _, ww in votes], 1), _VOLUMES * nbins
        )

    data = torch.cat(
        [
            soft_hist(s_bin, s_adj, rs, _SHAPE_BINS),
            soft_hist(c_bin, c_adj, rc, _COLOR_BINS),
        ],
        dim=-1,
    )  # (K, 1344)
    data = data / torch.sqrt((data * data).sum(dim=-1).clamp_min(1e-12))[:, None]

    valid = keypoints.mask & lrf_ok & (nmask.sum(dim=-1) >= 5)
    return Descriptors(data=torch.where(valid[:, None], data, 0.0), valid=valid)
