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
     repeat the first run bit for bit;
  7. eval config #2 (bench_configs.py:250-303) at full size on the cell-grid
     engine: five views of one synthetic town, 1,150,172 points each, at
     capacity 2^21 with max_points 2^20, Harris + FPFH, all ten pairs and
     the graph solve. One cold run (launch counts, peak memory, the
     counters of the feature and pair stages), gated at 4 of 5 maps within
     2 deg / 0.3 m of the truth and every registered map within 2 deg /
     0.3 m of golden/config2.json; one warm timed run and one run timed
     stage by stage, each required to repeat the cold run bit for bit.
     The SPFH kernel's grid entry must launch once per cloud (5 times a
     merge) and equal its plain version exactly on the first cloud's
     inputs; the stage-timed run logs each cloud's sweep: the buckets that
     hold a needed slot, the needed slots, the filled slots in those
     buckets, the candidates staged and the pairs counted.
  8. the online node, stateless (runtime/node.MapMergeNode over an
     InProcTransport) on config #1's views: one discovery, estimation and
     compositing tick; the poses bit for bit those of estimate_maps_transforms
     on the clouds the node builds (each view subsampled to max_points, as the
     reference node does), gated at 1 deg / 0.1 m; both kernels launched;
  9. the node in incremental mode on the same views, gated at 1 deg / 0.1 m,
     nn launched, run twice and required to repeat bit for bit;
  10. config5_big (bench_configs.py:678-788): 50 town views of 459,685 raw
     points streamed into an incremental node (max_robots 64, capacity 2^19,
     SIFT on the grid for octaves 0-1 and dense for octave 2, FPFH) five at a
     time, each batch a discovery and an estimation tick, compositing once at
     the end; gated at 45 of 50 maps registered, 40 adjacent pairs within 5
     deg / 0.5 m, end-to-end drift under 0.5 deg / 0.25 m and more than 10,000
     merged points; spfh launched once per feature extraction through
     spfh_grid and held exactly on the first map's inputs; a second node runs
     the first batch and must repeat the first tick's poses bit for bit; the
     stage times, counters, peak memory, wall time and maps per minute are
     printed.
Each path runs with the launch counts reset just before it and read just
after. On every path each kernel it launched is then held against its plain
version on the inputs of its first launch in that run (the path's own
shapes, ragged edges included) and timed there (CUDA events, warm, median),
beside its bound: the larger of the bytes it must move over 3.35 TB/s and
the float32 operations these inputs need over 67 TFLOP/s (H100 SXM data
sheet). The line before the last is a JSON object of the kernels: launches,
times and bound on config #1's own inputs, and the same for every path and
for the synthetic shapes; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of mapmerge_tpu, and checks at its end
that no such module was loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
#: eval config #2 (bench_configs.py:250-303, golden/config2.json)
CONFIG2_MAPS, CONFIG2_VIEW_TARGET = 5, 500_000
CONFIG2_VIEW_POINTS = 1_150_172
CONFIG2_CAP = 1 << 21
#: H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
#: float32 operations of one nn (query, target) pair: 3 subtractions, 3
#: products, 2 sums and the penalty add
NN_PAIR_OPS = 9
#: float32 operations of one counted SPFH pair (csrc/spfh.cu): the distance
#: 8, square root and radius product 2, unit vector 3, the two cosines 10,
#: v = d x u 9, its norm and scaling 9, w = u x v 9, alpha 5, theta's two
#: dots and atan2 11, three bin indices 12 (special functions count 1)
SPFH_PAIR_OPS = 78


def require(cond, msg: str) -> None:
    """Fail the run (an explicit raise: asserts vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of `fn` in ms over `reps` runs, each between two
    CUDA events, after `warmup` runs."""
    for _ in range(warmup):
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


def _bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nn_bound(q, p) -> dict:
    """Each query and target read once (12 B, the mask 1 B), idx and d2
    written once; every (query, target) pair costs NN_PAIR_OPS."""
    nq, np_ = q.shape[0], p.shape[0]
    return _bound(nq * 12 + np_ * 13 + nq * 8, nq * np_ * NN_PAIR_OPS)


def spfh_bound(args, pairs: int) -> dict:
    """Queries (24 B) and candidates (24 B + ok) read once, rows of 33
    bins and a count written once; SPFH_PAIR_OPS for each pair these
    inputs count (the data decides how many lie within the radius)."""
    q_xyz, cand_xyz = args[0], args[2]
    rows = q_xyz.shape[0] * q_xyz.shape[1]
    cands = cand_xyz.shape[0] * cand_xyz.shape[1]
    return _bound(rows * 24 + cands * 25 + rows * 34 * 4, pairs * SPFH_PAIR_OPS)


def grid_sweep_counters(grid, q_ok, total) -> dict:
    """What one spfh_grid call swept: the buckets that hold a needed slot,
    the needed slots, the filled slots in those buckets, the candidates the
    blocks stage (each block the filled slots of the distinct wrapped
    neighbours of its bucket, ops/grid._candidates' set), the distinct
    points among them, and the pairs counted (the needed rows' counts)."""
    from mapmerge_torch.kernels import spfh as spfh_kernel
    from mapmerge_torch.ops.grid import _neighbor_buckets

    active = torch.nonzero(q_ok.any(dim=1)).flatten()
    count = grid.count.to(torch.int64)
    nbr, _ = torch.sort(_neighbor_buckets(active, grid.dims), dim=-1)
    first = torch.ones_like(nbr, dtype=torch.bool)
    first[:, 1:] = nbr[:, 1:] != nbr[:, :-1]
    groups = -(-q_ok.sum(dim=1)[active] // spfh_kernel._GRID_GROUP)  # blocks
    staged = (count[nbr] * first).sum(dim=1)
    return {
        "active_buckets": int(active.numel()),
        "needed_slots": int(q_ok.sum()),
        "filled_in_active": int(count[active].sum()),
        "blocks": int(groups.sum()),
        "staged_candidates": int((staged * groups).sum()),
        "distinct_candidates": int(count[torch.unique(nbr)].sum()),
        "counted_pairs": int(total.to(torch.int64).sum()),
    }


def spfh_grid_bound(grid, q_ok, normals, total) -> dict:
    """The distinct candidate points read once (12 B xyz, 8 B index, 12 B
    normal), the needed flags of the active buckets (1 B a slot), the
    (P, 33) rows and (P,) counts written once; SPFH_PAIR_OPS for each pair
    the needed rows count."""
    c = grid_sweep_counters(grid, q_ok, total)
    n_bytes = (c["distinct_candidates"] * 32 + c["active_buckets"] * grid.cap
               + normals.shape[0] * 34 * 4)
    return _bound(n_bytes, c["counted_pairs"] * SPFH_PAIR_OPS)


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
    plain_ms = time_ms(lambda: nn.nearest_neighbor_ref(q, p, mask), reps=5)
    bound = nn_bound(q, p)
    log(
        f"kernel nearest_neighbor Q=P={NN_Q}: max|d2 err| {err}"
        f", idx mismatches at ties {n_tie_mismatch}, tie/all-masked ok; "
        f"kernel {ms} ms, plain {plain_ms} ms, bound {bound['bound_ms']} ms"
    )
    return {"shape": f"Q={NN_Q} P={NN_P}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **bound}


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


def _grid_inputs(g, dev, n, extent, needed):
    """A cell grid at r = 0.8 (cap 128) of n surface-like points over
    `extent` m (planes 3 m apart, 5% masked, one dense cluster over the
    cap), a share `needed` of them needed: spfh_grid's arguments."""
    from mapmerge_torch.ops.grid import build_grid, masked_query_grid

    xyz = torch.rand((n, 3), generator=g, device=dev) * extent
    xyz[:, 2] = torch.round(xyz[:, 2] / 3) * 3 + 0.01 * torch.rand(
        (n,), generator=g, device=dev
    )
    xyz[:400] = 2.0 + 0.3 * torch.rand((400, 3), generator=g, device=dev)
    nrm = torch.randn((n, 3), generator=g, device=dev) * 0.2
    nrm[:, 2] += 1.0
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    ok = torch.rand((n,), generator=g, device=dev) > 0.05
    need = torch.rand((n,), generator=g, device=dev) < needed
    grid = build_grid(xyz, ok, 0.8, None, 128)
    return grid, masked_query_grid(grid, need & ok, n).cell_ok, nrm


def check_spfh(dev, spfh) -> dict:
    """Kernel B against its plain versions: 24,576 queries x 32,768
    candidates at r2 = 0.64 in shared-candidate mode, plus a grid case
    (200,000 points, 2% needed), which must agree exactly."""
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

    grid_args = _grid_inputs(g, dev, 200_000, 40.0, 0.02)
    err_grid, bad_grid = _spfh_compare(
        "spfh grid", spfh.spfh_grid(*grid_args, r2=DESC_R2),
        spfh.spfh_grid_ref(*grid_args, r2=DESC_R2),
    )
    require(err_grid == 0.0 and bad_grid == 0,
            f"spfh grid: max err {err_grid}, {bad_grid} rows off; exact required")

    ms = time_ms(lambda: spfh.spfh_tile(*args, r2=DESC_R2))
    plain_ms = time_ms(lambda: spfh.spfh_ref(*args, r2=DESC_R2), reps=3, warmup=1)
    bound = spfh_bound(args, int(ref[1].sum()))
    log(
        f"kernel spfh {SPFH_B * SPFH_CQ} x {SPFH_M} (shared, mean "
        f"{mean_pairs} pairs/query): max|hist err| {err}, rows off {n_bad}"
        f"; grid 200,000 points: max err {err_grid}, rows off {bad_grid}; "
        f"kernel {ms} ms, plain {plain_ms} ms, bound {bound['bound_ms']} ms"
    )
    return {"shape": f"{SPFH_B}x{SPFH_CQ} x {SPFH_M}",
            "max_abs_err": max(err, err_grid), "ms": ms, "plain_ms": plain_ms,
            **bound}


@contextlib.contextmanager
def patched(targets):
    """Replace each (module, attribute) of `targets` by make(original) for
    the duration: `targets` maps (module, attribute) to make. Callers look
    these functions up on their modules at call time, so they see the
    replacements."""
    saved = {key: getattr(*key) for key in targets}
    try:
        for (mod, attr), make in targets.items():
            setattr(mod, attr, make(saved[(mod, attr)]))
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _copied(a, dev=None):
    """A copy of a recorded argument, on `dev` (None: where it lies): a
    tensor, or the tensors of a cell grid (spfh_grid's first argument)."""
    if torch.is_tensor(a):
        return a.to(a.device if dev is None else dev, copy=True)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _copied(getattr(a, f.name), dev) for f in dataclasses.fields(a)
            if torch.is_tensor(getattr(a, f.name))
        })
    return a


@contextlib.contextmanager
def first_launch_inputs(nn, spfh):
    """Record clones of the arguments of each kernel wrapper's first call
    while a path runs. The wrappers still launch and count as before; the
    callers (ops/neighbors.py, ops/descriptors/fpfh.py) look them up on
    their modules at call time, so they see the recording ones."""
    seen: dict[str, tuple] = {}

    def record(name, dev=None):
        def make(fn):
            def wrapper(*args, **kwargs):
                if name not in seen:
                    seen[name] = ([_copied(a, dev) for a in args], dict(kwargs))
                return fn(*args, **kwargs)

            return wrapper

        return make

    with patched({(nn, "nearest_neighbor"): record("nearest_neighbor"),
                  (spfh, "spfh_tile"): record("spfh"),
                  # a grid sweep's arguments are ~200 MB at config #2's size:
                  # kept in host memory, out of the run's peak device memory
                  (spfh, "spfh_grid"): record("spfh_grid", torch.device("cpu"))}):
        yield seen


#: per path, per kernel: shape, max error, times and bound on the path's
#: own first-launch inputs (hold_on_path_inputs)
PATH_STATS: dict[str, dict] = {}


def hold_on_path_inputs(label: str, seen: dict, nn, spfh, launches: dict,
                        plain: bool = False, exact: bool = False) -> None:
    """Each kernel a path launched against its plain version on the inputs
    of its first launch there, with check_nn's and check_spfh's
    tolerances (with `exact`: no difference at all), then timed on them
    (CUDA events, warm, median; the plain version too where `plain`).
    These launches come after the path's counts were read."""
    stats = PATH_STATS[label] = {}
    if "nearest_neighbor" in seen:
        args, _ = seen["nearest_neighbor"]
        err, ties = _nn_compare(f"{label} nn", nn, *args)
        st = stats["nearest_neighbor"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]}",
            "launches": launches["nearest_neighbor"], "max_abs_err": err,
            "tie_mismatches": ties,
            "ms": time_ms(lambda: nn.nearest_neighbor(*args)),
            **nn_bound(args[0], args[1]),
        }
        if plain:
            st["plain_ms"] = time_ms(lambda: nn.nearest_neighbor_ref(*args), reps=5)
    if "spfh" in seen:
        args, kwargs = seen["spfh"]
        ref = spfh.spfh_ref(*args, **kwargs)
        err, n_bad = _spfh_compare(
            f"{label} spfh", spfh.spfh_tile(*args, **kwargs), ref
        )
        require(not exact or (err == 0.0 and n_bad == 0),
                f"{label} spfh: max err {err}, {n_bad} rows off; exact required")
        b, cq, _ = args[0].shape
        bc, m, _ = args[2].shape
        counted = ref[1][ref[1] > 0]
        st = stats["spfh"] = {
            "shape": f"{b}x{cq} x {bc}x{m}",
            "mode": "shared (Bc = 1)",
            "launches": launches["spfh"],
            "max_abs_err": err, "rows_off": n_bad,
            "pairs_per_query": float(ref[1].mean()),
            "pairs_per_counted_query": float(counted.mean()) if counted.numel() else 0.0,
            "ms": time_ms(lambda: spfh.spfh_tile(*args, **kwargs)),
            **spfh_bound(args, int(ref[1].sum())),
        }
        if plain:
            st["plain_ms"] = time_ms(lambda: spfh.spfh_ref(*args, **kwargs),
                                     reps=3, warmup=1)
    if "spfh_grid" in seen:
        require("spfh" not in seen, f"{label}: both spfh entries launched")
        args, kwargs = seen["spfh_grid"]
        dev = torch.device("cuda", torch.cuda.current_device())
        args = [_copied(a, dev) for a in args]
        ref = spfh.spfh_grid_ref(*args, **kwargs)
        err, n_bad = _spfh_compare(
            f"{label} spfh_grid", spfh.spfh_grid(*args, **kwargs), ref
        )
        require(not exact or (err == 0.0 and n_bad == 0),
                f"{label} spfh_grid: max err {err}, {n_bad} rows off; exact required")
        grid, q_ok, normals = args[:3]
        st = stats["spfh"] = {
            "shape": f"grid {tuple(grid.cell_idx.shape)}, {normals.shape[0]} points",
            "mode": "grid (spfh_grid, one launch a cloud)",
            "launches": launches["spfh"],
            "max_abs_err": err, "rows_off": n_bad,
            **grid_sweep_counters(grid, q_ok, ref[1]),
            "ms": time_ms(lambda: spfh.spfh_grid(*args, **kwargs)),
            **spfh_grid_bound(grid, q_ok, normals, ref[1]),
        }
        if plain:
            st["plain_ms"] = time_ms(lambda: spfh.spfh_grid_ref(*args, **kwargs),
                                     reps=3, warmup=1)
    require(stats, f"{label}: no kernel input was recorded")
    log(f"{label}: kernels on the path's own inputs: {json.dumps(stats)}")


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
    hold_on_path_inputs("config #1", seen, nn, spfh, launches, plain=True)

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
    required to give transforms bitwise equal to `first`."""
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = estimate_maps_transforms(clouds, params, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        require(
            len(out) == len(first)
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
    hold_on_path_inputs(label, seen, nn, spfh, launches)
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
        walls = warm_runs(clouds, params, out, label, reps=3)
        log(f"{label}: warm call s (3 reps): median {statistics.median(walls)}"
            f", min {min(walls)}, max {max(walls)}; descriptors well formed; "
            "3 warm runs bitwise equal to the first")


def config2_params():
    """bench_configs._big_params(2**20): Harris + FPFH at the JAX package's
    large-map settings, the engine left at "auto" (the grid at this size)."""
    from mapmerge_torch.pipeline.merging import MergeParams

    return MergeParams(
        keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=40, max_points=1 << 20,
        max_keypoints=1024, max_neighbors=48, ransac_hypotheses=1024,
    )


def chain_errors(transforms, truths) -> list:
    """Each map's relative pose error (deg, m) against the truth, both
    anchored at the first registered map (bench_configs.check_chain); None
    for a map that did not register."""
    from mapmerge_torch.core import transforms as tf

    ok = [i for i in range(len(truths)) if np.asarray(transforms[i]).any()]
    require(ok, "no map registered at all")
    inv_ta = np.linalg.inv(transforms[ok[0]])
    inv_truth_a = np.linalg.inv(truths[ok[0]])
    return [
        tf.pose_error(inv_ta @ transforms[i], inv_truth_a @ truths[i])
        if i in ok else None
        for i in range(len(truths))
    ]


def golden_errors(transforms, golden) -> list:
    """Each registered map's pose error (deg, m) against the frozen oracle
    poses, both relative to map 0 (bench_configs.config2's golden gate);
    None where either side did not register."""
    from mapmerge_torch.core import transforms as tf

    g = [np.asarray(t, np.float32) for t in golden["transforms"]]
    inv_t0, inv_g0 = np.linalg.inv(transforms[0]), np.linalg.inv(g[0])
    return [
        tf.pose_error(inv_t0 @ transforms[i], inv_g0 @ g[i])
        if g[i].any() and np.asarray(transforms[i]).any() else None
        for i in range(len(g))
    ]


def config2_stages():
    """The stages timed in one run of config #2: (module, function, label)."""
    from mapmerge_torch.pipeline import features, merging, registration

    return (
        (features, "voxel_downsample", "downsample"),
        (features, "overflow_probe", "probe"),
        (features, "remove_outliers", "outliers"),
        (features, "compute_surface_normals", "normals"),
        (features, "detect_keypoints", "Harris"),
        (features, "compute_descriptors", "FPFH"),
        (registration, "find_correspondences", "matching"),
        (registration, "ransac_transform", "RANSAC"),
        (registration, "icp_refine", "ICP"),
        (registration, "transform_score", "score"),
        (merging, "_solve_graph", "graph"),
    )


@contextlib.contextmanager
def stage_recorder(stages, features_at, pairs_at):
    """Host ms and calls of every stage of `stages` ((owner, attribute,
    label); a label may be a function of the call's arguments), each call
    between two synchronisations, summed over one run; and the counters of
    each cloud's features (the calls of `features_at`, an (owner,
    attribute)) and each pair's estimate (`pairs_at`)."""
    rec = {"ms": {}, "calls": {}, "clouds": [], "pairs": []}

    def timed(label):
        def make(fn):
            def wrapper(*args, **kwargs):
                name = label(*args, **kwargs) if callable(label) else label
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                rec["ms"][name] = rec["ms"].get(name, 0.0) + (time.perf_counter() - t0) * 1e3
                rec["calls"][name] = rec["calls"].get(name, 0) + 1
                return out

            return wrapper

        return make

    def features_counters(fn):
        def wrapper(*args, **kwargs):
            f = fn(*args, **kwargs)
            rec["clouds"].append({
                "points": int(f.cloud.mask.sum()),
                "dropped_points": int(f.dropped_points),
                "scan_overflow": int(f.scan_overflow),
                "keypoints": int(f.keypoints.mask.sum()),
                "keypoints_truncated": int(f.keypoints.truncated),
            })
            return f

        return wrapper

    def pair_counters(fn):
        def wrapper(*args, **kwargs):
            est = fn(*args, **kwargs)
            rec["pairs"].append({"ok": bool(est.ok),
                                 "scan_overflow": int(est.scan_overflow)})
            return est

        return wrapper

    makes: dict = {}
    for owner, attr, label in stages:
        makes.setdefault((owner, attr), []).append(timed(label))
    makes.setdefault(features_at, []).append(features_counters)
    makes.setdefault(pairs_at, []).append(pair_counters)

    def composed(fs):
        def make(fn):
            for f in fs:
                fn = f(fn)
            return fn

        return make

    with patched({key: composed(fs) for key, fs in makes.items()}):
        yield rec


def run_config2(dev, kernels) -> None:
    """Eval config #2 on the cell-grid engine (phase 7)."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.testing.scene import town_views

    t0 = time.perf_counter()
    views, truths = town_views(CONFIG2_MAPS, CONFIG2_VIEW_TARGET)
    sizes = [v[0].shape[0] for v in views]
    require(sizes == [CONFIG2_VIEW_POINTS] * CONFIG2_MAPS,
            f"config #2 views have {sizes} points")
    clouds = [PointCloud.from_numpy(x, r, capacity=CONFIG2_CAP, device=dev)
              for x, r in views]
    params = config2_params()
    log(f"config #2: {CONFIG2_MAPS} views of {sizes[0]} points, capacity "
        f"{CONFIG2_CAP}, max_points {params.max_points}; made in "
        f"{time.perf_counter() - t0:.3f} s")

    info: dict = {}
    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cold = estimate_maps_transforms(clouds, params, seed=0, info_out=info)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"config #2 cold run: {cold_s:.3f} s, launches {launches} "
        f"(nearest_neighbor expected 0: ICP and the score take the grid), "
        f"pairs {info}, peak device memory {peak_gib:.2f} GiB")
    require(launches["spfh"] == CONFIG2_MAPS and "spfh_grid" in seen,
            f"config #2: spfh launched {launches['spfh']} times, expected "
            f"{CONFIG2_MAPS} through spfh_grid (one a cloud)")
    hold_on_path_inputs("config #2", seen, nn, spfh, launches, plain=True,
                        exact=True)

    require(len(cold) == CONFIG2_MAPS and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in cold
    ), "config #2: transforms are not five finite 4x4 matrices")
    truth_err = chain_errors(cold, truths)
    golden = json.loads((ROOT / "golden" / "config2.json").read_text())
    gold_err = golden_errors(cold, golden)
    log(f"config #2 pose error per map vs truth (deg, m): {truth_err}")
    log(f"config #2 pose error per map vs golden/config2.json: {gold_err}")
    n_ok = sum(e is not None and e[0] < 2.0 and e[1] < 0.3 for e in truth_err)
    require(n_ok >= 4, f"config #2: only {n_ok} of 5 maps within 2 deg / 0.3 m")
    require(all(e is None or (e[0] < 2.0 and e[1] < 0.3) for e in gold_err),
            "config #2: golden pose gate (2 deg / 0.3 m) failed")

    t0 = time.perf_counter()
    warm = estimate_maps_transforms(clouds, params, seed=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sweeps = []  # (args, outputs) of each spfh_grid call, read after the run

    def keep(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            sweeps.append((args, out))
            return out

        return wrapper

    from mapmerge_torch.pipeline import merging

    recorder = stage_recorder(config2_stages(), (merging, "extract_features"),
                              (merging, "estimate_transform"))
    with recorder as rec, patched({(spfh, "spfh_grid"): keep}):
        staged = estimate_maps_transforms(clouds, params, seed=0)
    for label, out in (("warm", warm), ("stage-timed", staged)):
        require(all(np.array_equal(a, b) for a, b in zip(out, cold)),
                f"config #2: the {label} run gave other transforms than the cold run")
    log(f"config #2 wall s: cold {cold_s}, warm {warm_s}; the warm and the "
        "stage-timed run bitwise equal to the cold run")
    log(f"config #2 feature stage per cloud: {json.dumps(rec['clouds'])}")
    log(f"config #2 pair stage per pair: {json.dumps(rec['pairs'])}")
    log("config #2 SPFH grid sweep per cloud: " + json.dumps(
        [grid_sweep_counters(a[0], a[1], out[1]) for a, out in sweeps]))
    log(f"config #2 stage ms of one run (5 clouds, 10 pairs summed): "
        f"{json.dumps(rec['ms'])}, sum {sum(rec['ms'].values())}")


def node_tick(dev, kernels, views, params, incremental: bool):
    """A node (seed 0, on `dev`) over an InProcTransport holding `views` as
    robot0, robot1, ...; one discovery and one estimation tick with the
    launch counts reset just before and read just after. Returns (node,
    transforms in robot order, recorded kernel inputs, launches, wall s)."""
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport

    transport = InProcTransport()
    robots = [f"robot{i}" for i in range(len(views))]
    for robot, (x, r) in zip(robots, views):
        transport.publish(robot, x, r)
    node = MapMergeNode(transport, params, seed=0, incremental=incremental,
                        device=dev)
    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        node.discovery()
        node.transforms_estimation()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    poses = node.get_transforms()
    return node, [poses[r] for r in robots], seen, launches, wall


def run_node_config1(dev, kernels) -> None:
    """Phases 8 and 9: the online node on config #1's views, stateless and
    incremental."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.testing.scene import config1_scene

    va, vb, _, truth = config1_scene()
    params = config1_params()

    label = "node stateless"
    node, out, seen, launches, wall = node_tick(dev, kernels, (va, vb), params, False)
    rot, trans = tf.pose_error(rel_pose(out), truth)
    log(f"{label} (config #1's views): {wall:.3f} s, launches {launches}, "
        f"pose vs truth {rot} deg, {trans} m, stats {node.get_stats()}")
    for name, n in launches.items():
        require(n > 0, f"{label}: kernel {name} was not launched")
    hold_on_path_inputs(label, seen, nn, spfh, launches)
    require(rot < 1.0 and trans < 0.1, f"{label}: pose gate 1 deg / 0.1 m failed")
    # the node subsamples each view to max_points, as the reference node
    # does: the direct call takes the clouds the node built
    cap = min(max(len(va[0]), len(vb[0])), params.max_points)
    clouds = [
        PointCloud.from_numpy(*node._fit_to_capacity(x, r, cap, f"robot{i}")[:2],
                              capacity=cap, device=dev)
        for i, (x, r) in enumerate((va, vb))
    ]
    direct = estimate_maps_transforms(clouds, params, seed=0)
    require(all(np.array_equal(a, b) for a, b in zip(out, direct)),
            f"{label}: poses differ from estimate_maps_transforms on its clouds")
    node.map_compositing()
    merged = node.get_merged_map()
    n_merged = int(merged.count)
    require(n_merged > 0 and bool(torch.isfinite(merged.xyz[merged.mask]).all()),
            f"{label}: the merged map has no finite points")
    log(f"{label}: poses bitwise equal to estimate_maps_transforms on the "
        f"node's {cap}-point clouds; merged map {n_merged} points; metrics "
        f"{json.dumps(node.get_metrics()['gauges'])}")

    label = "node incremental"
    runs = [node_tick(dev, kernels, (va, vb), params, True) for _ in range(2)]
    node, out, seen, launches, wall = runs[0]
    rot, trans = tf.pose_error(rel_pose(out), truth)
    log(f"{label} (config #1's views): {wall:.3f} s (second run "
        f"{runs[1][4]:.3f} s), launches {launches}, pose vs truth {rot} deg, "
        f"{trans} m, world edges {len(node._world.edges)}")
    require(launches["nearest_neighbor"] > 0,
            f"{label}: kernel nearest_neighbor was not launched")
    hold_on_path_inputs(label, seen, nn, spfh, launches)
    require(rot < 1.0 and trans < 0.1, f"{label}: pose gate 1 deg / 0.1 m failed")
    require(all(np.array_equal(a, b) for a, b in zip(out, runs[1][1])),
            f"{label}: the second run gave other poses than the first")
    log(f"repeat check ({label}): two runs bitwise equal")


#: config5_big (bench_configs.py:678-788): maps, view size, stream batch;
#: the views' raw size is BENCH_configs.json's raw_points_per_map
CONFIG5_MAPS, CONFIG5_VIEW_TARGET, CONFIG5_BATCH = 50, 200_000, 5
CONFIG5_VIEW_POINTS = 459_685


def config5_big_params(cap: int):
    """bench_configs.py:711-716: SIFT (threshold 3.0) + FPFH at the raw
    capacity, K 384, M 32, 768 hypotheses, ICP <= 30, tile 1024."""
    from mapmerge_torch.pipeline.merging import MergeParams

    return MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=30, max_points=cap,
        max_keypoints=384, max_neighbors=32, ransac_hypotheses=768,
        neighbor_tile=1024,
    )


def config5_stages():
    """The stages timed in the config5_big stream: (owner, function, label);
    SIFT's scale space and 26-NN are split by the engine each octave's
    capacity resolves to."""
    from mapmerge_torch.ops.keypoints import sift
    from mapmerge_torch.ops.neighbors import _resolve_engine
    from mapmerge_torch.pipeline import features, incremental
    from mapmerge_torch.runtime import node

    def octaves(stage, engine, capacity):
        return f"SIFT {stage}, {_resolve_engine(engine, capacity)} octaves"

    return (
        (node, "features_for", "features"),
        (features, "voxel_downsample", "downsample"),
        (features, "overflow_probe", "probe"),
        (features, "remove_outliers", "outliers"),
        (features, "compute_surface_normals", "normals"),
        (features, "detect_keypoints", "SIFT"),
        (sift, "_scale_space",
         lambda *a, **k: octaves("scale space", a[4], a[0].capacity)),
        (sift, "radius_neighbors",
         lambda *a, **k: octaves("26-NN", k["engine"], a[1].shape[0])),
        (features, "compute_descriptors", "FPFH"),
        (incremental, "_vote", "vote"),
        (incremental, "estimate_transform", "pair registrations"),
        (incremental.WorldModel, "refine", "refine"),
        (node, "compose_maps", "compositing"),
    )


def stream(node, transport, views, n: int):
    """Publish views[:n] as robot_00, robot_01, ..., CONFIG5_BATCH at a
    time, each batch followed by a discovery and an estimation tick; the
    poses after the first tick."""
    first = None
    for start in range(0, n, CONFIG5_BATCH):
        for i in range(start, min(start + CONFIG5_BATCH, n)):
            transport.publish(f"robot_{i:02d}", *views[i])
        node.discovery()
        node.transforms_estimation()
        if first is None:
            first = node.get_transforms()
    return first


def run_config5_big(dev, kernels) -> None:
    """config5_big (phase 10): the JAX package's 50-map stream through the
    incremental node at full per-map size."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.ops import grid
    from mapmerge_torch.pipeline import incremental
    from mapmerge_torch.runtime import node as node_module
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport
    from mapmerge_torch.testing.scene import town_views

    n = CONFIG5_MAPS
    t0 = time.perf_counter()
    views, truths = town_views(n, CONFIG5_VIEW_TARGET, keep=0.8, seed=5)
    sizes = [len(v[0]) for v in views]
    require(sizes == [CONFIG5_VIEW_POINTS] * n, f"config5_big views have {sizes} points")
    cap = 1 << int(np.ceil(np.log2(max(sizes))))
    params = config5_big_params(cap)
    log(f"config5_big: {n} views of {sizes[0]} raw points, capacity {cap}, "
        f"batches of {CONFIG5_BATCH}; made in {time.perf_counter() - t0:.3f} s")

    def new_node():
        transport = InProcTransport()
        node = MapMergeNode(transport, params, seed=0, incremental=True,
                            max_robots=64, device=dev)
        return node, transport

    # per SIFT grid octave: (capacity, valid points, grid_gaussian_smooth's
    # query overflow, which counts the parked padding too, and the valid
    # points its bucket cap drops, from a second build of the same grid)
    smooth_overflow = []

    def record_overflow(fn):
        def wrapper(q, p, values, sigmas, p_mask=None, scan_cap=128, **kwargs):
            out, overflow = fn(q, p, values, sigmas, p_mask=p_mask,
                               scan_cap=scan_cap, **kwargs)
            built = grid.build_grid(p, p_mask, 3.0 * max(sigmas), None, scan_cap)
            smooth_overflow.append((p.shape[0], int(p_mask.sum()), int(overflow),
                                    int(built.overflow)))
            return out, overflow

        return wrapper

    node, transport = new_node()
    recorder = stage_recorder(config5_stages(), (node_module, "features_for"),
                              (incremental, "estimate_transform"))
    with first_launch_inputs(nn, spfh) as seen, recorder as rec, patched(
        {(grid, "grid_gaussian_smooth"): record_overflow}
    ):
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        first_tick = stream(node, transport, views, n)
        node.map_compositing()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n_features = rec["calls"]["features"]
    log(f"config5_big stream: {wall:.3f} s, {n * 60.0 / wall} maps a minute, "
        f"launches {launches} (nearest_neighbor expected 0: the 2^19-capacity "
        f"targets take the grid 1-NN), {n_features} feature extractions, "
        f"{rec['calls'].get('pair registrations', 0)} pair registrations, "
        f"peak device memory {peak_gib:.2f} GiB")
    require(launches["spfh"] == n_features == n and "spfh_grid" in seen,
            f"config5_big: spfh launched {launches['spfh']} times for "
            f"{n_features} feature extractions, expected one each through spfh_grid")
    hold_on_path_inputs("config5_big", seen, nn, spfh, launches, plain=True,
                        exact=True)

    poses = node.get_transforms()
    ordered = [poses[f"robot_{i:02d}"] for i in range(n)]
    require(len(poses) == n and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in ordered
    ), "config5_big: transforms are not finite 4x4 matrices, one a map")
    registered = sum(1 for t in ordered if t.any())
    adjacent = [
        tf.pose_error(np.linalg.inv(ordered[i]) @ ordered[i + 1],
                      np.linalg.inv(truths[i]) @ truths[i + 1])
        for i in range(n - 1) if ordered[i].any() and ordered[i + 1].any()
    ]
    n_adjacent = sum(1 for rot, trans in adjacent if rot < 5.0 and trans < 0.5)
    drift = max(e for e in chain_errors(ordered, truths) if e is not None)
    merged = node.get_merged_map()
    n_merged = int(merged.count)
    min_registered = math.ceil(0.9 * n)
    min_adjacent = 40 if n == 50 else math.floor(0.8 * (n - 1))
    log(f"config5_big: {registered}/{n} maps registered, {n_adjacent}/"
        f"{len(adjacent)} adjacent pairs within 5 deg / 0.5 m, end-to-end drift "
        f"{drift[0]} deg / {drift[1]} m, merged map {n_merged} points, world "
        f"edges {len(node._world.edges)}, metrics "
        f"{json.dumps(node.get_metrics()['gauges'])}")
    log(f"config5_big adjacent pair errors (deg, m): {adjacent}")
    require(registered >= min_registered,
            f"config5_big: {registered} maps registered, gate {min_registered}")
    require(n_adjacent >= min_adjacent,
            f"config5_big: {n_adjacent} adjacent pairs ok, gate {min_adjacent}")
    require(drift[0] < 0.5 and drift[1] < 0.25,
            "config5_big: drift gate 0.5 deg / 0.25 m failed")
    require(n_merged > 10000, f"config5_big: merged map of {n_merged} points")

    ms = rec["ms"]
    log(f"config5_big stage ms, the whole stream: {json.dumps(ms)}; calls "
        f"{json.dumps(rec['calls'])}; features per map "
        f"{ms['features'] / n_features}")
    log(f"config5_big feature stage per map: {json.dumps(rec['clouds'])}")
    log(f"config5_big pair registrations: {json.dumps(rec['pairs'])}")
    by_cap: dict = {}
    for c, *counts in smooth_overflow:
        by_cap.setdefault(c, []).append(counts)
    log("config5_big SIFT grid_gaussian_smooth per octave capacity: calls, "
        "valid points, query overflow (padding included) and valid points the "
        "cap drops, each summed over the maps: " + json.dumps(
            {c: [len(v)] + [sum(x) for x in zip(*v)] for c, v in by_cap.items()}))

    # repeatability: a second node streams the first batch
    again, again_transport = new_node()
    stream(again, again_transport, views, CONFIG5_BATCH)
    second = again.get_transforms()
    require(sorted(second) == sorted(first_tick) and all(
        np.array_equal(second[r], first_tick[r]) for r in first_tick
    ), "config5_big: a second node's first batch gave other poses than the first tick")
    log(f"repeat check (config5_big): a second node's first batch "
        f"({CONFIG5_BATCH} maps) bitwise equal to the first tick")


def kernel_entry(k, launches: dict, stats: dict) -> dict:
    """A kernel's entry of the line before the last: its numbers on config
    #1's own inputs (the main path), then per path and on the synthetic
    shapes. No single PyTorch call computes either kernel's function
    (torch.cdist gives neither the masked argmin nor its tie order; nothing
    in PyTorch bins Darboux features), so library_ms is null."""
    main = PATH_STATS["config #1"][k.name]
    errs = [stats[k.name]["max_abs_err"]] + [
        ps[k.name]["max_abs_err"] for ps in PATH_STATS.values() if k.name in ps
    ]
    return {
        "name": k.name, "route": k.route, "source": k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": max(errs), "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "shape": main["shape"],
        "paths": {label: ps[k.name] for label, ps in PATH_STATS.items()
                  if k.name in ps},
        "synthetic": stats[k.name],
    }


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
        f"({', '.join(build.library_path(s).name for s in build.SOURCES)})")
    for source in build.SOURCES:
        report = build.library_path(source).with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())

    stats = {"nearest_neighbor": check_nn(dev, nn), "spfh": check_spfh(dev, spfh)}
    kernels = (nn.KERNEL, spfh.KERNEL)
    launches = run_main_path(dev, kernels)
    run_default_operating_point(dev, kernels)
    run_registry_sweep(dev, kernels)
    run_config2(dev, kernels)
    run_node_config1(dev, kernels)
    run_config5_big(dev, kernels)

    loaded = sorted(m for m in sys.modules
                    if m.startswith("jax") or m.startswith("mapmerge_tpu"))
    require(not loaded, f"modules of JAX or mapmerge_tpu were loaded: {loaded}")

    print(card)
    print(json.dumps({"kernels": [kernel_entry(k, launches, stats) for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
