#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from csrc/ and print the build time;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, with the stated tolerances, and time both (CUDA events);
  4. eval config #1 (bench.py:49-77) through estimate_maps_transforms on the
     card: reset the kernels' launch counts, run once, require every kernel
     to have launched; gate the poses against the ground truth and against
     golden/config1.json at 1 deg / 0.1 m; time 5 warm repetitions; run
     compose_maps at the output resolution;
  4b. the repeat check: every warm repetition gives transforms bitwise equal
     to the first run's, and compose_maps run twice gives the same points;
  5. the reference's default operating point at config #1's size
     (bench_configs.config1_pfh: SIFT + PFH-125): the 1 deg / 0.1 m gate,
     nn launches, 5 warm repetitions, peak memory, the repeat check, and the
     PFH descriptor stage against FPFH's on the same inputs;
  6. the registry sweep on the descriptor-parity scene of
     tests/test_oracle_parity.py:81-135 (Harris keypoints): PFH, PFHRGB,
     SHOT and SC3D under MATCHING, FPFH and RSD under SAC_IA, each gated at
     1.5 deg / 0.15 m, with the descriptors' width and normalisation
     checked, the launches required, and 3 warm calls timed and required to
     repeat the first run bit for bit (SHOT and SC3D excepted: their
     fractional scatter-adds may round otherwise from run to run).
Each path runs with the launch counts reset just before it and read just
after. On every path each kernel it launched is then held against its plain
version on the inputs of its first launch in that run (the path's own
shapes, ragged edges included). The line before the last is a JSON object
of the kernels (launches from config #1's run); the last line is
{"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: the dense SPFH sweep's query block: 512 keypoints x 48 neighbours
SPFH_B, SPFH_CQ, SPFH_M = 512, 48, 32768
NN_Q = NN_P = 32768
DESC_R2 = 0.8 * 0.8


def require(cond, msg: str) -> None:
    """Fail the run (an explicit raise: asserts vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of `fn` in ms over `reps` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def _nn_compare(name, nn, q, p, mask=None):
    """Kernel A against nearest_neighbor_ref on the same inputs.

    Tolerance: d2 within 1e-6 relative (both round every operation alike,
    so 0 is expected); an index may differ only where the two candidates'
    squared distances agree within that tolerance (a tie). Returns
    (max |d2 err|, index mismatches at ties)."""
    idx_k, d2_k = nn.nearest_neighbor(q, p, mask)
    idx_r, d2_r = nn.nearest_neighbor_ref(q, p, mask)
    torch.cuda.synchronize()
    n = q.shape[0]
    require(idx_k.shape == (n,) and d2_k.shape == (n,), f"{name}: shapes")
    err = (d2_k - d2_r).abs()
    tol = 1e-6 * d2_r.abs().clamp_min(1.0)
    require(bool((err <= tol).all()), f"{name}: d2 off by {float(err.max())}")
    diff = idx_k != idx_r
    if bool(diff.any()):
        pen = torch.zeros(p.shape[0], device=p.device)
        if mask is not None:
            pen = torch.where(mask, 0.0, 1e12)
        cand_k = ((q - p[idx_k.long()]) ** 2).sum(-1) + pen[idx_k.long()]
        cand_r = ((q - p[idx_r.long()]) ** 2).sum(-1) + pen[idx_r.long()]
        gap = (cand_k - cand_r).abs()[diff]
        require(bool((gap <= tol[diff]).all()), f"{name}: index differs off a tie")
    return float(err.max()), int(diff.sum())


def check_nn(dev, nn) -> dict:
    """Kernel A against nearest_neighbor_ref: Q = P = 32768 with a mask,
    then the tie and all-masked cases (tolerance: _nn_compare)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.rand((NN_Q, 3), generator=g, device=dev) * 16.0
    p = torch.rand((NN_P, 3), generator=g, device=dev) * 16.0
    mask = torch.rand((NN_P,), generator=g, device=dev) > 0.2
    err, n_tie_mismatch = _nn_compare("nn", nn, q, p, mask)

    # ties: every target equidistant -> the first index, across tiles
    qt = torch.zeros((256, 3), device=dev)
    pt = torch.zeros((NN_P, 3), device=dev)
    it, dt = nn.nearest_neighbor(qt, pt)
    require(bool((it == 0).all()) and bool((dt == 0).all()), "nn: tie break")
    # all targets masked: every distance at the penalty
    _, dm = nn.nearest_neighbor(q[:1024], p, torch.zeros_like(mask))
    require(bool((dm >= 1e11).all()), "nn: all-masked case")

    ms = time_ms(lambda: nn.nearest_neighbor(q, p, mask))
    plain_ms = time_ms(lambda: nn.nearest_neighbor_ref(q, p, mask))
    log(
        f"kernel nearest_neighbor Q=P={NN_Q}: max|d2 err| {err}"
        f", idx mismatches at ties {n_tie_mismatch}, tie/all-masked ok; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "tie_mismatches": n_tie_mismatch}


def _spfh_inputs(g, dev, b, cq, bc, m):
    """Surface-like candidates (points near planes, unit normals), queries
    drawn from the candidates so zero-distance self pairs occur."""
    cand = torch.rand((bc, m, 3), generator=g, device=dev) * 6.0
    cand[..., 2] = torch.round(cand[..., 2]) + 0.02 * torch.rand(
        (bc, m), generator=g, device=dev
    )
    nrm = torch.randn((bc, m, 3), generator=g, device=dev) * 0.2
    nrm[..., 2] += 1.0
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    ok = torch.rand((bc, m), generator=g, device=dev) > 0.1
    pick = torch.randint(0, m, (b, cq), generator=g, device=dev)
    src = 0 if bc == 1 else torch.arange(b, device=dev)[:, None]
    return cand[src, pick], nrm[src, pick], cand, nrm, ok


def _spfh_compare(name, got, ref):
    """Tolerance: the pair counts agree exactly and the scaled histograms to
    1e-4, except on at most 0.1% of rows, where a pair on the r2 boundary or
    at zero distance may fall on the other side (both versions round every
    operation alike, so 0 such rows is expected)."""
    (h_k, t_k), (h_r, t_r) = got, ref
    require(bool(torch.isfinite(h_k).all()), f"{name}: non-finite histogram")
    row_bad = ((h_k - h_r).abs().amax(-1) > 1e-4) | (t_k != t_r)
    n_bad = int(row_bad.sum())
    require(n_bad <= max(1, row_bad.numel() // 1000), f"{name}: {n_bad} rows")
    return float((h_k - h_r).abs().max()), n_bad


def check_spfh(dev, spfh) -> dict:
    """Kernel B against spfh_ref: 24,576 queries x 32,768 candidates at
    r2 = 0.64 in shared-candidate mode, plus a small per-cell case."""
    g = torch.Generator(device=dev).manual_seed(12)
    args = _spfh_inputs(g, dev, SPFH_B, SPFH_CQ, 1, SPFH_M)
    got = spfh.spfh_tile(*args, r2=DESC_R2)
    ref = spfh.spfh_ref(*args, r2=DESC_R2)
    torch.cuda.synchronize()
    require(
        got[0].shape == (SPFH_B, SPFH_CQ, 33)
        and got[1].shape == (SPFH_B, SPFH_CQ),
        "spfh: shapes",
    )
    err, n_bad = _spfh_compare("spfh shared", got, ref)
    mean_pairs = float(ref[1].mean())

    cell = _spfh_inputs(g, dev, 4, 40, 4, 300)
    err_cell, bad_cell = _spfh_compare(
        "spfh per-cell", spfh.spfh_tile(*cell, r2=1.0), spfh.spfh_ref(*cell, r2=1.0)
    )

    ms = time_ms(lambda: spfh.spfh_tile(*args, r2=DESC_R2), reps=3)
    plain_ms = time_ms(lambda: spfh.spfh_ref(*args, r2=DESC_R2), reps=3)
    log(
        f"kernel spfh {SPFH_B * SPFH_CQ} x {SPFH_M} (shared, mean "
        f"{mean_pairs:.1f} pairs/query): max|hist err| {err}, rows off {n_bad}"
        f"; per-cell 4x40x300: max err {err_cell}, rows off {bad_cell}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
    )
    return {"max_abs_err": max(err, err_cell), "ms": ms, "plain_ms": plain_ms}


@contextlib.contextmanager
def first_launch_inputs(nn, spfh):
    """Record clones of the arguments of each kernel wrapper's first call
    while a path runs. The wrappers still launch and count as before; the
    callers (ops/neighbors.py, ops/descriptors/fpfh.py) look them up on
    their modules at call time, so they see the recording ones."""
    seen: dict[str, tuple] = {}
    saved = {}

    def record(mod, attr, name):
        fn = saved[(mod, attr)] = getattr(mod, attr)

        def wrapper(*args, **kwargs):
            if name not in seen:
                seen[name] = (
                    [a.clone() if torch.is_tensor(a) else a for a in args],
                    dict(kwargs),
                )
            return fn(*args, **kwargs)

        setattr(mod, attr, wrapper)

    record(nn, "nearest_neighbor", "nearest_neighbor")
    record(spfh, "spfh_tile", "spfh")
    try:
        yield seen
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def hold_on_path_inputs(label: str, seen: dict, nn, spfh) -> None:
    """Each kernel a path launched against its plain version on the inputs
    of its first launch there, with check_nn's and check_spfh's
    tolerances. These launches come after the path's counts were read."""
    parts = []
    if "nearest_neighbor" in seen:
        args, _ = seen["nearest_neighbor"]
        err, ties = _nn_compare(f"{label} nn", nn, *args)
        parts.append(f"nn Q={args[0].shape[0]} P={args[1].shape[0]}: "
                     f"max|d2 err| {err}, idx mismatches at ties {ties}")
    if "spfh" in seen:
        args, kwargs = seen["spfh"]
        err, n_bad = _spfh_compare(
            f"{label} spfh", spfh.spfh_tile(*args, **kwargs),
            spfh.spfh_ref(*args, **kwargs),
        )
        b, cq, _ = args[0].shape
        bc, m, _ = args[2].shape
        parts.append(f"spfh {b}x{cq} queries x {bc}x{m} candidates: "
                     f"max|hist err| {err}, rows off {n_bad}")
    require(parts, f"{label}: no kernel input was recorded")
    log(f"{label}: kernels on the path's own inputs: " + "; ".join(parts))


def config1_params():
    from mapmerge_torch.pipeline.merging import MergeParams

    return MergeParams(
        keypoint_type="SIFT",
        keypoint_threshold=3.0,
        descriptor_type="FPFH",
        refine_transform=True,
        max_iterations=60,
        max_points=32768,
        max_keypoints=512,
        max_neighbors=48,
        ransac_hypotheses=1024,
        neighbor_tile=1024,
    )


def rel_pose(transforms) -> np.ndarray:
    return np.linalg.inv(transforms[0]) @ transforms[1]


def run_main_path(dev, kernels) -> dict:
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.pipeline.merging import (
        compose_maps,
        estimate_maps_transforms,
    )
    from mapmerge_torch.testing.scene import config1_scene

    va, vb, cap, truth = config1_scene()
    clouds = [
        PointCloud.from_numpy(*va, capacity=cap, device=dev),
        PointCloud.from_numpy(*vb, capacity=cap, device=dev),
    ]
    params = config1_params()
    log(f"config #1: views of {va[0].shape[0]} and {vb[0].shape[0]} points, "
        f"capacity {cap}")

    from mapmerge_torch.kernels import nn, spfh

    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = estimate_maps_transforms(clouds, params, seed=0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"main path run: {first_s:.3f} s, launches {launches}, "
        f"peak device memory {peak_gib:.2f} GiB")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched by the main path")
    hold_on_path_inputs("config #1", seen, nn, spfh)

    require(len(out) == 2 and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in out
    ), "transforms are not two finite 4x4 matrices")
    rel = rel_pose(out)
    rot, trans = tf.pose_error(rel, truth)
    golden = json.loads((ROOT / "golden" / "config1.json").read_text())
    g_rot, g_trans = tf.pose_error(
        rel, rel_pose([np.asarray(t, np.float32) for t in golden["transforms"]])
    )
    log(f"pose vs truth: {rot} deg, {trans} m; vs golden/config1.json: "
        f"{g_rot} deg, {g_trans} m")
    require(rot < 1.0 and trans < 0.1, "pose gate against truth failed")
    require(g_rot < 1.0 and g_trans < 0.1, "pose gate against golden failed")

    walls = warm_runs(clouds, params, out, "config #1")
    log(f"estimate_maps_transforms wall s (5 warm reps): median "
        f"{statistics.median(walls)}, min {min(walls)}, max {max(walls)}")

    merged = compose_maps(clouds, out, params.output_resolution)
    n_merged = int(merged.mask.sum())
    require(
        n_merged > 0 and bool(torch.isfinite(merged.xyz[merged.mask]).all()),
        "compose_maps gave no finite points",
    )
    log(f"compose_maps at {params.output_resolution} m: {n_merged} points")
    again = int(compose_maps(clouds, out, params.output_resolution).mask.sum())
    require(again == n_merged, f"compose_maps gave {n_merged} then {again} points")
    log("repeat check (config #1): 5 warm runs bitwise equal to the first; "
        f"compose_maps {n_merged} points twice")
    return launches


def warm_runs(clouds, params, first, label: str, reps: int = 5) -> list[float]:
    """Wall seconds of `reps` warm estimate_maps_transforms calls, each
    required to give transforms bitwise equal to `first` unless that is
    None (SHOT's and SC3D's fractional scatter-adds may round otherwise
    from run to run)."""
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = estimate_maps_transforms(clouds, params, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        require(
            first is None
            or len(out) == len(first)
            and all(np.array_equal(a, b) for a, b in zip(out, first)),
            f"{label}: a repeat run gave other transforms than the first",
        )
    return walls


def drive(label: str, clouds, params, kernels, truth, rot_gate, trans_gate):
    """One estimate_maps_transforms call with the launch counts reset just
    before and read just after; the relative pose gated against `truth`,
    the kernels held against their plain versions on the run's own inputs.
    Returns (transforms, launches, wall s, pose error)."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = estimate_maps_transforms(clouds, params, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    require(len(out) == 2 and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in out
    ), f"{label}: transforms are not two finite 4x4 matrices")
    rot, trans = tf.pose_error(rel_pose(out), truth)
    log(f"{label}: {wall:.3f} s, launches {launches}, pose vs truth "
        f"{rot} deg, {trans} m")
    require(rot < rot_gate and trans < trans_gate,
            f"{label}: pose gate {rot_gate} deg / {trans_gate} m failed")
    require(launches["nearest_neighbor"] > 0,
            f"{label}: kernel nearest_neighbor was not launched")
    hold_on_path_inputs(label, seen, nn, spfh)
    return out, launches, wall, (rot, trans)


def stage_ms(fn, reps: int = 5) -> float:
    """Median host ms of `fn` between two synchronisations, after a warm-up
    (how PERF.md's stage profile times a stage)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_default_operating_point(dev, kernels) -> None:
    """bench_configs.config1_pfh: config #1 with the reference's default
    descriptor, PFH-125."""
    from mapmerge_torch.core.cloud import PointCloud, pad_cloud
    from mapmerge_torch.ops.descriptors import compute_descriptors
    from mapmerge_torch.ops.downsample import voxel_downsample
    from mapmerge_torch.ops.keypoints import detect_keypoints
    from mapmerge_torch.ops.normals import compute_surface_normals
    from mapmerge_torch.ops.outliers import remove_outliers
    from mapmerge_torch.pipeline.merging import compose_maps
    from mapmerge_torch.testing.scene import config1_scene

    va, vb, cap, truth = config1_scene()
    clouds = [
        PointCloud.from_numpy(*va, capacity=cap, device=dev),
        PointCloud.from_numpy(*vb, capacity=cap, device=dev),
    ]
    params = config1_params().replace(descriptor_type="PFH")
    torch.cuda.reset_peak_memory_stats(dev)
    out, launches, first_s, _ = drive(
        "config1_pfh", clouds, params, kernels, truth, 1.0, 0.1
    )
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    walls = warm_runs(clouds, params, out, "config1_pfh")
    log(f"config1_pfh wall s (5 warm reps): median {statistics.median(walls)}"
        f", min {min(walls)}, max {max(walls)}; first run {first_s:.3f} s; "
        f"peak device memory {peak_gib:.2f} GiB")
    n1 = int(compose_maps(clouds, out, params.output_resolution).mask.sum())
    n2 = int(compose_maps(clouds, out, params.output_resolution).mask.sum())
    require(n1 == n2 and n1 > 0, f"config1_pfh: compose_maps {n1} then {n2}")
    log(f"repeat check (config1_pfh): 5 warm runs bitwise equal to the first;"
        f" compose_maps {n1} points twice")

    # the descriptor stage alone, PFH against FPFH on the same inputs, both
    # clouds summed (the stage profile's method)
    r = params.descriptor_radius
    stage = {"PFH": 0.0, "FPFH": 0.0}
    for c in clouds:
        c = voxel_downsample(pad_cloud(c, cap), params.resolution,
                             out_capacity=min(cap, params.max_points))
        c = remove_outliers(c, r, params.outliers_min_neighbours,
                            tile=params.neighbor_tile)
        nrm = compute_surface_normals(c, params.normal_radius,
                                      tile=params.neighbor_tile)
        kp = detect_keypoints(
            c, nrm, params.keypoint_type, params.keypoint_threshold,
            params.normal_radius, params.resolution, params.max_keypoints,
            tile=params.neighbor_tile,
        )
        for kind in stage:
            stage[kind] += stage_ms(lambda: compute_descriptors(
                c, nrm, kp, kind, r, max_neighbors=params.max_neighbors,
                tile=params.neighbor_tile,
            ))
    log(f"descriptor stage ms per merge (median of 5, 2 clouds, "
        f"{params.max_keypoints} keypoints x {params.max_neighbors} "
        f"neighbours): PFH {stage['PFH']:.3f}, FPFH {stage['FPFH']:.3f}")


def check_descriptor_rows(label: str, kind: str, data, valid) -> None:
    """Width and normalisation of the valid rows: histogram blocks sum to
    100, or to 0 where no pair counted (FPFH 3 x 11, PFH 125, PFHRGB
    2 x 125), SHOT and SC3D rows have unit L2 norm, RSD radii lie in
    [0, 0.2]."""
    from mapmerge_torch.ops.descriptors import descriptor_kind_from_dim

    require(descriptor_kind_from_dim(data.shape[1]).value == kind,
            f"{label}: descriptor width {data.shape[1]}")
    rows = data[valid]
    require(rows.shape[0] > 5 and bool(torch.isfinite(rows).all()),
            f"{label}: {rows.shape[0]} valid descriptors")
    block = {"FPFH": 11, "PFH": 125, "PFHRGB": 125}.get(kind)
    if block is not None:
        sums = rows.reshape(rows.shape[0], -1, block).sum(-1)
        require(bool((((sums - 100.0).abs() < 1e-2) | (sums == 0)).all()),
                f"{label}: histogram blocks do not sum to 100")
    elif kind in ("SHOT", "SC3D"):
        norms = rows.norm(dim=-1)
        require(bool(((norms - 1.0).abs() < 1e-4).all()),
                f"{label}: rows are not unit length")
    else:
        require(bool(((rows >= 0) & (rows <= 0.2 + 1e-6)).all()),
                f"{label}: RSD radii outside [0, 0.2]")


def sweep_params(desc: str, method: str):
    """tests/test_oracle_parity.py:105-135 (strict parity, Harris keypoints
    at threshold 1.0)."""
    from mapmerge_torch.pipeline.merging import MergeParams

    common = dict(
        keypoint_type="HARRIS", keypoint_threshold=1.0, descriptor_type=desc,
        refine_transform=True, max_points=16384, max_keypoints=256,
        max_neighbors=48, neighbor_tile=512,
    )
    if method == "MATCHING":
        return MergeParams.strict_parity(
            max_iterations=80, ransac_hypotheses=512, **common
        )
    return MergeParams.strict_parity(
        estimation_method="SAC_IA", max_iterations=500,
        sacia_hypotheses=4096, **common
    )


SWEEP = (
    ("PFH", "MATCHING"), ("PFHRGB", "MATCHING"), ("SHOT", "MATCHING"),
    ("SC3D", "MATCHING"), ("FPFH", "SAC_IA"), ("RSD", "SAC_IA"),
)
#: fractional scatter-adds: not required to repeat bit for bit
UNREPEATABLE = ("SHOT", "SC3D")


def run_registry_sweep(dev, kernels) -> None:
    from mapmerge_torch.core.cloud import PointCloud, pad_cloud
    from mapmerge_torch.pipeline.features import extract_features
    from mapmerge_torch.testing.scene import (
        make_scene, overlapping_views, rotation_z, se3,
    )

    xyz, rgb = make_scene(
        np.random.default_rng(7), n_boxes=12, extent=8.0, density=90.0
    )
    truth = se3(rotation_z(0.4), [1.5, -0.7, 0.2])
    va, vb, cap = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    clouds = [
        PointCloud.from_numpy(*va, capacity=cap, device=dev),
        PointCloud.from_numpy(*vb, capacity=cap, device=dev),
    ]
    log(f"registry sweep: views of {va[0].shape[0]} and {vb[0].shape[0]} "
        f"points, capacity {cap}")
    for desc, method in SWEEP:
        label = f"{desc}+{method}"
        params = sweep_params(desc, method)
        out, launches, _, _ = drive(
            label, clouds, params, kernels, truth, 1.5, 0.15
        )
        if desc == "FPFH":
            require(launches["spfh"] > 0, f"{label}: spfh was not launched")
        for c in clouds:
            f = extract_features(pad_cloud(c, cap), params)
            check_descriptor_rows(label, desc, f.descriptors.data,
                                  f.descriptors.valid)
        first = None if desc in UNREPEATABLE else out
        walls = warm_runs(clouds, params, first, label, reps=3)
        log(f"{label}: warm call s (3 reps): median {statistics.median(walls)}"
            f", min {min(walls)}, max {max(walls)}; descriptors well formed; "
            + ("repeats not required (fractional scatter-adds)" if first is None
               else "3 warm runs bitwise equal to the first"))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    import mapmerge_torch  # noqa: F401  (sets the TF32 flags off)
    from mapmerge_torch.kernels import build, nn, spfh

    require(
        not torch.backends.cuda.matmul.allow_tf32
        and not torch.backends.cudnn.allow_tf32,
        "TF32 is on",
    )

    t0 = time.perf_counter()
    build.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    report = build.library_path().with_suffix(".log")
    if report.exists():
        log(report.read_text().strip())

    stats = {"nearest_neighbor": check_nn(dev, nn), "spfh": check_spfh(dev, spfh)}
    kernels = (nn.KERNEL, spfh.KERNEL)
    launches = run_main_path(dev, kernels)
    run_default_operating_point(dev, kernels)
    run_registry_sweep(dev, kernels)

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": stats[k.name]["max_abs_err"],
            "ms": stats[k.name]["ms"], "plain_ms": stats[k.name]["plain_ms"],
        }
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
