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
     compose_maps at the output resolution.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

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


def check_nn(dev, nn) -> dict:
    """Kernel A against nearest_neighbor_ref: Q = P = 32768 with a mask,
    then the tie and all-masked cases.

    Tolerance: d2 within 1e-6 relative (both round every operation alike,
    so 0 is expected); an index may differ only where the two candidates'
    squared distances agree within that tolerance (a tie)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.rand((NN_Q, 3), generator=g, device=dev) * 16.0
    p = torch.rand((NN_P, 3), generator=g, device=dev) * 16.0
    mask = torch.rand((NN_P,), generator=g, device=dev) > 0.2
    idx_k, d2_k = nn.nearest_neighbor(q, p, mask)
    idx_r, d2_r = nn.nearest_neighbor_ref(q, p, mask)
    torch.cuda.synchronize()
    require(idx_k.shape == (NN_Q,) and d2_k.shape == (NN_Q,), "nn: shapes")
    err = (d2_k - d2_r).abs()
    tol = 1e-6 * d2_r.abs().clamp_min(1.0)
    require(bool((err <= tol).all()), f"nn: d2 off by {float(err.max())}")
    diff = idx_k != idx_r
    if bool(diff.any()):
        pen = torch.where(mask, 0.0, 1e12)
        cand_k = ((q - p[idx_k.long()]) ** 2).sum(-1) + pen[idx_k.long()]
        cand_r = ((q - p[idx_r.long()]) ** 2).sum(-1) + pen[idx_r.long()]
        gap = (cand_k - cand_r).abs()[diff]
        require(bool((gap <= tol[diff]).all()), "nn: index differs off a tie")
    n_tie_mismatch = int(diff.sum())

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
        f"kernel nearest_neighbor Q=P={NN_Q}: max|d2 err| {float(err.max())}"
        f", idx mismatches at ties {n_tie_mismatch}, tie/all-masked ok; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
    )
    return {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
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

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        estimate_maps_transforms(clouds, params, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"estimate_maps_transforms wall s (5 warm reps): median "
        f"{statistics.median(walls)}, min {min(walls)}, max {max(walls)}")

    merged = compose_maps(clouds, out, params.output_resolution)
    n_merged = int(merged.mask.sum())
    require(
        n_merged > 0 and bool(torch.isfinite(merged.xyz[merged.mask]).all()),
        "compose_maps gave no finite points",
    )
    log(f"compose_maps at {params.output_resolution} m: {n_merged} points")
    return launches


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
