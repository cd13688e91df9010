"""The comparison that decides `correct`: the program's outputs against the
plain reference (`reference.py`), each number beside its limit.

The outputs a driver hands over, once the window has closed:

- `units`: each merge's or stream's final pose of each map, judged against
  the scene's truth (`pose_rot_deg`, `pose_trans_m`: the worst registered
  map of any unit; a map with a zero pose is failed, not wrong);
- `merged`: one unit's merged cloud, drawn from the seed, with the poses it
  was composed with, judged against the reference's composeMaps of the raw
  views under those poses (`merged_mismatch`);
- `features`: the feature stage's outputs of a few of that unit's clouds:
  the registration cloud after outlier removal and its normals and
  curvature, judged against the reference's voxel grid, outlier count and
  normals, worked out again from the raw view (`downsample_gap_m`,
  `downsample_rgb_gap`, `outlier_mismatch`, `normal_p90_deg`,
  `curvature_p90`); the keypoint detector's field (Harris's response, or
  SIFT's first octave of smoothed intensities) at sampled points, and the
  FPFH descriptors at sampled keypoints, each judged against the
  reference's from the program's registration cloud and normals, which
  the numbers above judge by themselves (`harris_rel_max`, `dog_max`,
  `fpfh_p90`).

The limits come from the cell's file in `limits/`; the configuration
states the pose limits. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from mmbench import reference as ref

#: a merged voxel whose centroid lies farther than this from the
#: reference's counts as a mismatch (m); rounding moves one by ~1e-6
MERGED_TOL_M = 1e-3
#: the half-width of the band around a radius in which the reference's
#: membership counts as a tie (m)
TIE_M = 1e-4
#: keypoints of a cloud whose FPFH descriptors are judged
FPFH_KEYPOINTS = 128


def pose_numbers(units: list[dict], scenes: list[dict]) -> dict:
    """The worst rotation (deg) and translation (m) error of any registered
    map of any unit, and the maps registered."""
    rot, trans, registered = 0.0, 0.0, 0
    for unit in units:
        truths = scenes[unit["scene"]]["truths"]
        for err in ref.pose_errors(unit["poses"], [truths[i] for i in unit["maps"]]):
            if err is None:
                continue
            registered += 1
            rot, trans = max(rot, err[0]), max(trans, err[1])
    return {"pose_rot_deg": rot, "pose_trans_m": trans, "registered": registered}


def merged_numbers(merged: dict, views: dict, resolution: float,
                   precision: str = "float64") -> dict:
    """The share of the reference's merged voxels that the program's merged
    cloud misses, adds or places off by more than MERGED_TOL_M. With
    `precision` below float64 the candidate is the reference's own compose
    in that precision (the control) instead of the program's cloud."""
    keys, centroids, _ = ref.compose([views[i] for i in merged["maps"]], merged["poses"], resolution)
    if precision != "float64":
        _, cand, _ = ref.compose([views[i] for i in merged["maps"]], merged["poses"],
                                 resolution, precision)
        cand = cand.to(torch.float32)
    else:
        cand = merged["xyz"]
    got = ref.voxel_keys(cand, resolution)
    idx = ref.lookup(keys, got)
    hit = idx >= 0
    gap = torch.linalg.vector_norm(cand[hit].to(torch.float64) - centroids[idx[hit]], dim=1)
    close = torch.zeros((keys.shape[0],), dtype=torch.bool, device=keys.device)
    close[idx[hit][gap <= MERGED_TOL_M]] = True
    bad = int((~hit).sum()) + int((~close).sum())
    return {"merged_mismatch": bad / max(int(keys.shape[0]), 1),
            "merged_voxels": int(keys.shape[0])}


def feature_numbers(feat: dict, view: dict, params: dict, rng: np.random.Generator,
                    n_queries: int, controls: tuple[str, ...] = ()) -> dict:
    """One cloud's feature-stage numbers: the program's registration cloud
    against the reference's voxel grid and outlier removal, and its normals
    and curvature at `n_queries` points drawn by `rng` that both kept,
    against the reference's; then its keypoint and descriptor numbers.
    Each of `controls` ("tf32", "bfloat16") adds
    the same numbers for the reference in that precision, under
    "<control>:<name>"."""
    res = params["resolution"]
    keys, centroids, _, colours = ref.voxel_grid(view["xyz"], res, rgb=view["rgb"])
    r, least = params["descriptor_radius"], params["outliers_min_neighbours"]
    # a decision that a move of the radius by TIE_M would turn is a tie that
    # rounding settles either way (the program's centroids lie ~1e-5 m from
    # the reference's): it is not judged
    inner, exact, outer = (c >= least for c in ref.radius_counts(
        centroids, (r - TIE_M, r, r + TIE_M)))
    kept, tie = exact, inner != outer

    mask = feat["mask"]
    pxyz = feat["xyz"][mask]
    idx = ref.lookup(keys, ref.voxel_keys(pxyz, res))
    hit = idx >= 0
    gap = torch.linalg.vector_norm(pxyz[hit].to(torch.float64) - centroids[idx[hit]], dim=1)
    prog_kept = torch.zeros_like(kept)
    prog_kept[idx[hit]] = True
    rgb_gap = (feat["rgb"][mask][hit].to(torch.float64) - colours[idx[hit]]).abs()
    out = {
        "downsample_gap_m": float(gap.max()) if gap.numel() else 0.0,
        "downsample_rgb_gap": float(rgb_gap.max()) if rgb_gap.numel() else 0.0,
        "outlier_mismatch": (int((~hit).sum()) + int(((prog_kept != kept) & ~tie).sum()))
        / max(int(keys.shape[0]), 1),
        "outlier_ties": int(tie.sum()),
    }

    # normals at points both kept: the program's point of a voxel is found by its key
    prog_of_voxel = torch.full_like(keys, -1)
    prog_of_voxel[idx[hit]] = torch.nonzero(hit).flatten()
    both = torch.nonzero(prog_kept & kept).flatten().cpu().numpy()
    pick = np.sort(rng.choice(both.shape[0], size=min(n_queries, both.shape[0]), replace=False))
    vox = torch.as_tensor(both[pick], device=keys.device)
    q, pts = centroids[vox], centroids[kept]
    want_n, want_c, count = ref.normals(q, pts, params["normal_radius"])
    j = prog_of_voxel[vox]
    got_n = feat["normals"][mask][j].cpu().numpy().astype(np.float64)
    got_c = feat["curvature"][mask][j].cpu().numpy().astype(np.float64)
    got_ok = feat["valid"][mask][j].cpu().numpy()
    judged = got_ok & (count >= 3)
    out.update(_normal_numbers(got_n[judged], got_c[judged], want_n[judged], want_c[judged]))
    out["normals_judged"] = int(judged.sum())
    for precision in controls:
        ctl_n, ctl_c, _ = ref.normals(q, pts, params["normal_radius"], precision)
        for k, v in _normal_numbers(ctl_n[judged], ctl_c[judged], want_n[judged], want_c[judged]).items():
            out[f"{precision}:{k}"] = v
        ctl_kept = ref.radius_counts(centroids.to(torch.float32), (r,), precision)[0] >= least
        out[f"{precision}:outlier_mismatch"] = int(((ctl_kept != kept) & ~tie).sum()) / max(
            int(keys.shape[0]), 1)
        _, ctl_centroids, _, ctl_colours = ref.voxel_grid(view["xyz"], res, precision,
                                                          rgb=view["rgb"])
        out[f"{precision}:downsample_gap_m"] = float(
            torch.linalg.vector_norm(ctl_centroids.to(torch.float64) - centroids, dim=1).max())
        out[f"{precision}:downsample_rgb_gap"] = float(
            (ctl_colours.to(torch.float64) - colours).abs().max())
    out.update(keypoint_numbers(feat, params, rng, n_queries, controls))
    out.update(descriptor_numbers(feat, params, rng, controls))
    return out


def _surface(feat: dict):
    """The program's registration cloud: the points valid in its mask and
    normals, their normals, and the index of each among all slots."""
    ok = feat["mask"] & feat["valid"]
    slots = torch.nonzero(ok).flatten()
    return feat["xyz"][slots], feat["normals"][slots], slots


def _quantiles(prefix: str, err: np.ndarray) -> dict:
    if err.shape[0] == 0:
        return {}
    return {f"{prefix}_p90": float(np.percentile(err, 90)), f"{prefix}_max": float(err.max())}


def keypoint_numbers(feat: dict, params: dict, rng: np.random.Generator, n_queries: int,
                     controls: tuple[str, ...] = ()) -> dict:
    """The detector's field at `n_queries` surface points drawn by `rng`,
    against the reference's from the program's registration cloud: Harris's
    response relative to tr(C)^2 (`harris_rel`), or the differences of
    SIFT's first octave of smoothed intensities (`dog`, intensity units).
    Queries within TIE_M of a member's radius are not judged."""
    field = feat.get("field")
    if field is None:
        return {}
    pts, nrm, slots = _surface(feat)
    pick = torch.as_tensor(np.sort(rng.choice(pts.shape[0], size=min(n_queries, pts.shape[0]),
                                              replace=False)), device=pts.device)
    q = pts[pick]
    out = {}
    if feat["detector"] == "HARRIS":
        got = field[slots[pick]].cpu().numpy().astype(np.float64)
        r = params["normal_radius"]
        want, trace, tied = ref.harris_response(q, pts, nrm, r, TIE_M)
        judged = ~tied & (trace > 0)
        scale = trace[judged] ** 2
        out.update(_quantiles("harris_rel", np.abs(got[judged] - want[judged]) / scale))
        out["harris_judged"] = int(judged.sum())
        for p in controls:
            ctl, _, _ = ref.harris_response(q, pts, nrm, r, TIE_M, p)
            for k, v in _quantiles("harris_rel", np.abs(ctl[judged] - want[judged]) / scale).items():
                out[f"{p}:{k}"] = v
        return out
    # SIFT: octave 0 is the registration cloud, its scales min_scale 2^(s / n)
    n = params["sift_scales_per_octave"]
    sigmas = [params["resolution"] * 2.0 ** (s / n) for s in range(n + 3)]
    ok_pts = feat["xyz"][feat["mask"]]
    rgb = feat["rgb"][feat["mask"]].to(torch.float64)
    intensity = (299.0 * rgb[:, 0] + 587.0 * rgb[:, 1] + 114.0 * rgb[:, 2]) * (255.0 / 1000.0)
    want, tied = ref.gaussian_smooth(q, ok_pts, intensity, sigmas, TIE_M)
    got = field[:, slots[pick]].cpu().numpy().astype(np.float64)
    judged = ~tied
    want_dog = np.diff(want, axis=0)
    out.update(_quantiles("dog", np.abs(np.diff(got, axis=0) - want_dog).max(axis=0)[judged]))
    out["dog_judged"] = int(judged.sum())
    for p in controls:
        ctl, _ = ref.gaussian_smooth(q, ok_pts, intensity, sigmas, TIE_M, p)
        err = np.abs(np.diff(ctl, axis=0) - want_dog).max(axis=0)[judged]
        for k, v in _quantiles("dog", err).items():
            out[f"{p}:{k}"] = v
    return out


def descriptor_numbers(feat: dict, params: dict, rng: np.random.Generator,
                       controls: tuple[str, ...] = ()) -> dict:
    """FPFH-33 at up to FPFH_KEYPOINTS of the program's valid keypoints
    drawn by `rng`, against the reference's from the program's registration
    cloud and normals: each keypoint's largest bin difference (of 100 a
    block). Keypoints with a surface point within TIE_M of the radius are
    not judged. Also the neighbours within the radius of every valid
    keypoint, against the program's `max_neighbors` (the largest, and the
    share of keypoints above it)."""
    if params["descriptor_type"] != "FPFH":
        return {}
    pts, nrm, _ = _surface(feat)
    valid = torch.nonzero(feat["descriptor_valid"]).flatten()
    r = params["descriptor_radius"]
    kp = feat["keypoints"][valid]
    counts = ref.radius_counts_at(kp, pts, r) if kp.shape[0] else np.zeros(0)
    out = {"keypoints": int(kp.shape[0]),
           "fpfh_neighbours_max": int(counts.max()) if counts.shape[0] else 0,
           "fpfh_truncated_share": float((counts > params["max_neighbors"]).mean())
           if counts.shape[0] else 0.0}
    pick = np.sort(rng.choice(kp.shape[0], size=min(FPFH_KEYPOINTS, kp.shape[0]), replace=False))
    pick_t = torch.as_tensor(pick, device=kp.device)
    want, _, tied = ref.fpfh(kp[pick_t], pts, nrm, r, TIE_M)
    got = feat["descriptors"][valid][pick_t].cpu().numpy().astype(np.float64)
    judged = ~tied & np.isfinite(want).all(1)
    out.update(_quantiles("fpfh", np.abs(got - want).max(1)[judged]))
    out["fpfh_judged"] = int(judged.sum())
    for p in controls:
        ctl, _, _ = ref.fpfh(kp[pick_t], pts, nrm, r, TIE_M, p)
        for k, v in _quantiles("fpfh", np.abs(ctl - want).max(1)[judged]).items():
            out[f"{p}:{k}"] = v
    return out


def _normal_numbers(got_n, got_c, want_n, want_c) -> dict:
    """Quantiles of the angle between normals (sign-free, deg) and of the
    curvature's absolute difference."""
    if got_n.shape[0] == 0:
        return {}
    cos = np.abs((got_n * want_n).sum(1)) / (
        np.linalg.norm(got_n, axis=1) * np.linalg.norm(want_n, axis=1))
    angle = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    dc = np.abs(got_c - want_c)
    out = {}
    for q in (50, 90, 99):
        out[f"normal_p{q}_deg"] = float(np.percentile(angle, q))
        out[f"curvature_p{q}"] = float(np.percentile(dc, q))
    out["normal_max_deg"] = float(angle.max())
    out["curvature_max"] = float(dc.max())
    return out


def judge(outputs: dict, limits: dict, device, seed: int) -> tuple[dict, bool, dict]:
    """(checks {name: {"value", "limit"}} of the compared numbers, correct,
    every number read). A number is within its limit where value <= limit;
    a number that could not be read fails."""
    numbers = pose_numbers(outputs["units"], outputs["scenes"])
    numbers.update(unit_numbers(outputs, device, seed, limits.get("normal_queries", 4096)))
    checks, correct = {}, True
    for name, limit in limits["checks"].items():
        value = numbers.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        correct &= bool(ok)
        checks[name] = {"value": value, "limit": limit}
    return checks, correct, numbers


def unit_numbers(outputs: dict, device, seed: int, n_queries: int,
                 controls: tuple[str, ...] = ()) -> dict:
    """The sampled unit's merged-cloud and feature-stage numbers, the
    clouds' pooled, and with `controls` the control's beside them."""
    views = {}

    def view(k, i):
        if (k, i) not in views:
            xyz, rgb = outputs["scenes"][k]["views"][i]
            views[k, i] = {"xyz": torch.as_tensor(xyz, device=device),
                           "rgb": torch.as_tensor(rgb, device=device)}
        return views[k, i]

    numbers = {}
    merged, params = outputs.get("merged"), outputs["params"]
    if merged is not None:
        merged_views = {i: view(merged["scene"], i)["xyz"] for i in merged["maps"]}
        numbers.update(merged_numbers(merged, merged_views, params["output_resolution"]))
        for p in controls:
            numbers[f"{p}:merged_mismatch"] = merged_numbers(
                merged, merged_views, params["output_resolution"], p)["merged_mismatch"]
    rng = np.random.default_rng([seed, 7])
    numbers.update(pool([
        feature_numbers(f, view(f["scene"], f["map"]), params, rng, n_queries, controls)
        for f in outputs.get("features", [])
    ]))
    return numbers


def pool(per_cloud: list[dict]) -> dict:
    """The clouds' numbers as one: the worst cloud's."""
    out: dict = {}
    for numbers in per_cloud:
        for k, v in numbers.items():
            out[k] = max(out.get(k, v), v)
    return out
