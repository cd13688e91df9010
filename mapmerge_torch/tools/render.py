"""Headless PNG renders of pipeline stages (port of mapmerge_tpu/tools/render.py).

The reference ships interactive PCL viewers for clouds, normals, keypoints,
correspondence lines, and the aligned overlay
(map_merge_3d/src/visualise.cpp:20-95); a GPU server has no display, so
these are the headless equivalents: matplotlib (Agg) orthographic scatter
renders a human can open. Each function writes one PNG and returns its path.

Views are two orthographic projections (top-down XY, side XZ) side by side
— robot maps are flat-ish, so those two axes carry the structure a 3D
orbit view would show. numpy only: the callers hand host arrays, and
matplotlib is imported at the first render, never at module import.
"""

from __future__ import annotations

import os

import numpy as np


def require_matplotlib() -> None:
    """Raise ImportError, naming matplotlib, where it is not installed (the
    renders need it; nothing falls back to skipping them)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "rendering needs matplotlib, which is not installed"
        ) from e


def _axes(title: str):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, (ax_top, ax_side) = plt.subplots(1, 2, figsize=(14, 7))
    fig.suptitle(title)
    ax_top.set_title("top (x-y)")
    ax_side.set_title("side (x-z)")
    for ax in (ax_top, ax_side):
        ax.set_aspect("equal")
    return fig, ax_top, ax_side


def _save(fig, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def _scatter(ax_top, ax_side, xyz, color, size=0.8, label=None, alpha=0.8):
    ax_top.scatter(xyz[:, 0], xyz[:, 1], s=size, c=color, alpha=alpha,
                   label=label, linewidths=0)
    ax_side.scatter(xyz[:, 0], xyz[:, 2], s=size, c=color, alpha=alpha,
                    linewidths=0)


def _subsample(xyz, cap: int, extra=None):
    if len(xyz) <= cap:
        return (xyz, extra) if extra is not None else xyz
    idx = np.random.default_rng(0).choice(len(xyz), cap, replace=False)
    if extra is not None:
        return xyz[idx], extra[idx]
    return xyz[idx]


def render_cloud(path: str, xyz, rgb=None, title: str = "cloud",
                 max_points: int = 60000) -> str:
    """Single cloud, colored by its RGB (visualise.cpp view of a cloud)."""
    xyz = np.asarray(xyz)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 0.35)
    xyz, rgb = _subsample(xyz, max_points, np.asarray(rgb))
    fig, ax_top, ax_side = _axes(f"{title} ({len(xyz)} pts shown)")
    _scatter(ax_top, ax_side, xyz, np.clip(rgb, 0, 1))
    return _save(fig, path)


def render_normals(path: str, xyz, normals, valid=None,
                   title: str = "normals", max_arrows: int = 1500) -> str:
    """Cloud with a subsample of normal arrows (visualiseNormals analog)."""
    xyz = np.asarray(xyz)
    normals = np.asarray(normals)
    if valid is not None:
        keep = np.asarray(valid)
        xyz, normals = xyz[keep], normals[keep]
    fig, ax_top, ax_side = _axes(f"{title} ({len(xyz)} valid)")
    bg = _subsample(xyz, 60000)
    _scatter(ax_top, ax_side, bg, "#b0b0b0", size=0.5, alpha=0.5)
    sub, nrm = _subsample(xyz, max_arrows, normals)
    scale = 0.03 * (np.ptp(xyz[:, 0]) + 1e-6)
    ax_top.quiver(sub[:, 0], sub[:, 1], nrm[:, 0], nrm[:, 1],
                  color="#d62728", width=0.0015, scale=1.0 / scale,
                  scale_units="xy", angles="xy")
    ax_side.quiver(sub[:, 0], sub[:, 2], nrm[:, 0], nrm[:, 2],
                   color="#d62728", width=0.0015, scale=1.0 / scale,
                   scale_units="xy", angles="xy")
    return _save(fig, path)


def render_keypoints(path: str, xyz, kp_xyz, kp_mask=None,
                     title: str = "keypoints") -> str:
    """Cloud in grey with keypoints highlighted (visualiseKeypoints)."""
    xyz = np.asarray(xyz)
    kp = np.asarray(kp_xyz)
    if kp_mask is not None:
        kp = kp[np.asarray(kp_mask)]
    fig, ax_top, ax_side = _axes(f"{title} ({len(kp)} keypoints)")
    bg = _subsample(xyz, 60000)
    _scatter(ax_top, ax_side, bg, "#b0b0b0", size=0.5, alpha=0.5)
    _scatter(ax_top, ax_side, kp, "#d62728", size=22, alpha=1.0,
             label="keypoints")
    ax_top.legend(loc="upper right", fontsize=8)
    return _save(fig, path)


def render_correspondences(path: str, kp_a, kp_b, pairs,
                           inlier_mask=None,
                           title: str = "correspondences") -> str:
    """Keypoint match lines between the two clouds, target offset along x
    for legibility (visualiseCorrespondences draws them in one frame).

    `pairs`: (M, 2) int array of (source_kp_idx, target_kp_idx); with
    `inlier_mask`, inliers draw solid and rejected matches faint.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    kp_a = np.asarray(kp_a)
    kp_b = np.asarray(kp_b)
    pairs = np.asarray(pairs).reshape(-1, 2)
    offset = np.ptp(kp_a[:, 0]) * 1.3 + 1.0 if len(kp_a) else 1.0

    fig, ax = plt.subplots(figsize=(14, 7))
    n_in = int(inlier_mask.sum()) if inlier_mask is not None else len(pairs)
    ax.set_title(f"{title}: {len(pairs)} matches, {n_in} inliers")
    ax.set_aspect("equal")
    ax.scatter(kp_a[:, 0], kp_a[:, 1], s=14, c="#1f77b4", label="source")
    ax.scatter(kp_b[:, 0] + offset, kp_b[:, 1], s=14, c="#2ca02c",
               label="target")
    for m, (i, j) in enumerate(pairs):
        inl = inlier_mask is None or bool(inlier_mask[m])
        ax.plot(
            [kp_a[i, 0], kp_b[j, 0] + offset],
            [kp_a[i, 1], kp_b[j, 1]],
            color="#d62728" if inl else "#bbbbbb",
            linewidth=0.8 if inl else 0.4,
            alpha=0.9 if inl else 0.35,
        )
    ax.legend(loc="upper right", fontsize=8)
    return _save(fig, path)


def render_alignment(path: str, moved_src_xyz, tgt_xyz,
                     title: str = "aligned overlay",
                     max_points: int = 60000) -> str:
    """Transformed source over target in two colors (the reference's
    two-cloud overlay, visualise.cpp:20-40)."""
    a = _subsample(np.asarray(moved_src_xyz), max_points)
    b = _subsample(np.asarray(tgt_xyz), max_points)
    fig, ax_top, ax_side = _axes(title)
    _scatter(ax_top, ax_side, a, "#d62728", size=0.6, alpha=0.55,
             label="source (transformed)")
    _scatter(ax_top, ax_side, b, "#1f77b4", size=0.6, alpha=0.55,
             label="target")
    ax_top.legend(loc="upper right", fontsize=8, markerscale=8)
    return _save(fig, path)
