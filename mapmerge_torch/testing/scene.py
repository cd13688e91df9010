"""Synthetic box-world scenes with known SE(3) ground truth, numpy only.

A copy of `make_scene`, `_sample_box_surface`, `overlapping_views`,
`make_town` and `n_overlapping_views` from tests/synthetic.py, and of
`town_views` from bench_configs.py, that returns arrays instead of the JAX
package's clouds (tests/synthetic.py imports jax through
mapmerge_tpu.core.cloud). It makes the same RNG calls in the same order, so
a seed gives bit-identical points.
"""

from __future__ import annotations

import numpy as np


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def se3(r: np.ndarray, t) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r
    out[:3, 3] = np.asarray(t, np.float32)
    return out


def _sample_box_surface(rng, center, size, density):
    """Points on all 6 faces of an axis-aligned box, coloured by face."""
    pts, cols = [], []
    faces = [(0, -1), (0, +1), (1, -1), (1, +1), (2, -1), (2, +1)]
    sx, sy, sz = size
    areas = [sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy]
    for (axis, sign), area in zip(faces, areas):
        n = max(4, int(area * density))
        uv = rng.random((n, 2)).astype(np.float32)
        p = np.empty((n, 3), np.float32)
        dims = [d for d in range(3) if d != axis]
        p[:, dims[0]] = (uv[:, 0] - 0.5) * size[dims[0]] + center[dims[0]]
        p[:, dims[1]] = (uv[:, 1] - 0.5) * size[dims[1]] + center[dims[1]]
        p[:, axis] = center[axis] + sign * size[axis] / 2
        pts.append(p)
        col = np.zeros((n, 3), np.float32)
        col[:, axis] = 0.25 + 0.75 * (sign > 0)
        col[:, (axis + 1) % 3] = 0.2 * axis
        cols.append(col)
    return np.concatenate(pts), np.concatenate(cols)


def make_scene(
    rng: np.random.Generator,
    n_boxes: int = 6,
    extent: float = 8.0,
    density: float = 120.0,
    noise: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Corner-rich scene: floor plane + boxes. Returns (xyz, rgb)."""
    nf = int(extent * extent * density / 4)
    floor = np.empty((nf, 3), np.float32)
    floor[:, :2] = (rng.random((nf, 2)).astype(np.float32) - 0.5) * extent
    floor[:, 2] = 0.0
    pts = [floor]
    cols = [np.full((nf, 3), 0.4, np.float32)]
    for _ in range(n_boxes):
        center = np.array(
            [
                (rng.random() - 0.5) * extent * 0.8,
                (rng.random() - 0.5) * extent * 0.8,
                0.5 + rng.random(),
            ],
            np.float32,
        )
        size = 0.6 + rng.random(3).astype(np.float32) * 1.6
        p, c = _sample_box_surface(rng, center, size, density)
        pts.append(p)
        cols.append(c)
    xyz = np.concatenate(pts)
    rgb = np.clip(np.concatenate(cols), 0, 1)
    if noise:
        xyz = xyz + rng.normal(size=xyz.shape).astype(np.float32) * noise
    return xyz, rgb


def overlapping_views(
    rng: np.random.Generator,
    xyz: np.ndarray,
    rgb: np.ndarray,
    transform: np.ndarray,
    overlap_axis: int = 0,
    overlap: float = 0.6,
):
    """Two overlapping views of a scene: ((a_xyz, a_rgb), (b_xyz, b_rgb),
    capacity). View B is in its own frame (transform @ b_local = world), and
    the capacity is the larger view's point count, as the reference pads
    both views to it. `rng` is unused, as in the reference."""
    lo, hi = xyz[:, overlap_axis].min(), xyz[:, overlap_axis].max()
    span = hi - lo
    a_sel = xyz[:, overlap_axis] <= lo + span * (0.5 + overlap / 2)
    b_sel = xyz[:, overlap_axis] >= lo + span * (0.5 - overlap / 2)
    a_xyz, a_rgb = xyz[a_sel], rgb[a_sel]
    b_world, b_rgb = xyz[b_sel], rgb[b_sel]
    tinv = np.linalg.inv(transform)
    b_local = b_world @ tinv[:3, :3].T + tinv[:3, 3]
    cap = int(max(a_xyz.shape[0], b_local.shape[0]))
    return (
        (a_xyz.astype(np.float32), a_rgb.astype(np.float32)),
        (b_local.astype(np.float32), b_rgb.astype(np.float32)),
        cap,
    )


def config1_scene():
    """Eval config #1's scene (bench.py:49-60): ((a_xyz, a_rgb), (b_xyz,
    b_rgb), capacity, truth) from seeds 7 and 3."""
    xyz, rgb = make_scene(
        np.random.default_rng(7), n_boxes=20, extent=16.0, density=220.0
    )
    truth = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
    va, vb, cap = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    return va, vb, cap, truth


def make_town(
    rng: np.random.Generator,
    n_resized_target: int,
    resolution: float = 0.1,
    raw_density: float = 260.0,
) -> tuple[np.ndarray, np.ndarray]:
    """A floor and yawed, tinted boxes sized so that voxel-downsampling at
    `resolution` gives roughly `n_resized_target` points (the floor ~40% of
    the surface). Box edges exceed Harris's suppression diameter, and the
    bottom faces are dropped (they would double the floor's density)."""
    area_target = n_resized_target * resolution * resolution
    extent = float(np.sqrt(area_target * 0.4))
    pts, cols = [], []
    nf = int(extent * extent * raw_density)
    floor = np.empty((nf, 3), np.float32)
    floor[:, 0] = rng.random(nf) * extent
    floor[:, 1] = rng.random(nf) * extent
    floor[:, 2] = 0.0
    pts.append(floor)
    cols.append(np.full((nf, 3), 0.4, np.float32))

    box_area = 0.0
    while box_area < area_target * 0.6:
        size = (
            0.9 + rng.random() * 1.2,
            0.9 + rng.random() * 1.2,
            0.7 + rng.random() * 1.2,
        )
        center = (
            1.0 + rng.random() * (extent - 2.0),
            1.0 + rng.random() * (extent - 2.0),
            size[2] / 2,
        )
        p, c = _sample_box_surface(rng, (0.0, 0.0, center[2]), size, raw_density)
        keep = p[:, 2] > 0.02
        p, c = p[keep], c[keep]
        r = rotation_z(rng.random() * np.pi)
        p = p @ r.T
        p[:, 0] += center[0]
        p[:, 1] += center[1]
        c = 0.3 * c + 0.7 * rng.random(3).astype(np.float32)
        pts.append(p.astype(np.float32))
        cols.append(c.astype(np.float32))
        sx, sy, sz = size
        box_area += 2 * (sx * sy + sx * sz + sy * sz)
    return np.concatenate(pts), np.concatenate(cols)


def n_overlapping_views(
    rng: np.random.Generator,
    xyz: np.ndarray,
    rgb: np.ndarray,
    truths: list[np.ndarray],
    keep: float = 0.6,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """N views of one scene, each a directional crop keeping `keep` of the
    points, crop directions evenly spaced around the circle (small jitter),
    each in its own frame (world = truth_i @ local)."""
    views = []
    n = len(truths)
    for i, truth in enumerate(truths):
        ang = 2.0 * np.pi * i / max(n, 1) + rng.normal() * 0.1
        u = np.array([np.cos(ang), np.sin(ang)])
        proj = xyz[:, 0] * u[0] + xyz[:, 1] * u[1]
        cut = np.quantile(proj, 1.0 - keep)
        m = proj >= cut
        inv = np.linalg.inv(truth)
        v = xyz[m] @ inv[:3, :3].T + inv[:3, 3]
        views.append((v.astype(np.float32), rgb[m]))
    return views


def town_views(
    n_maps: int, view_resized_target: int, keep: float = 0.6, seed: int = 42
):
    """N overlapping views of one make_town scene and their SE(3) truths
    (bench_configs.town_views); `view_resized_target` ~ points per view at
    registration resolution. Eval config #2 is town_views(5, 500_000)."""
    rng = np.random.default_rng(seed)
    xyz, rgb = make_town(rng, int(view_resized_target / keep))
    truths = [
        np.eye(4, dtype=np.float32)
        if i == 0
        else se3(
            rotation_z(0.15 * ((i % 7) - 3)),
            [0.6 * (i % 5), -0.3 * (i % 4), 0.04 * (i % 3)],
        )
        for i in range(n_maps)
    ]
    views = n_overlapping_views(rng, xyz, rgb, truths, keep=keep)
    return views, truths
