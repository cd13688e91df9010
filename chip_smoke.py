#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the native host library (csrc/mapmerge_native.cpp, g++) and the
     hand-written kernels from csrc/ and print each build time;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, with the stated tolerances, and time both (CUDA events); kernel
     A's batched entry at config5's shape (45 pairs of 4,096 points),
     exactly, and against the unbatched kernel on each pair; SIFT's kernels
     C (scale space) and D (26-NN) at config #1's octave-0 shape, C within
     its tolerance and D exactly, D also on lattice ties and both on a small
     Q whose points they split; the dense radius sweeps, kernels E (count)
     and F (moments), at config #1's width (Q = P = 32,768, 0.8 / 0.6 m:
     the streamed route, and its order pre-pass against order_ref), E
     exactly and F within its tolerance, then either side of the resident
     route's cutoff (naming each route) and on points exactly on the
     radius, ties, shuffled, all-masked, half-parked, one-tile clouds and
     queries that are not the cloud's points on both routes; the grid
     sweeps, kernels G
     (bounded 1-NN), H (moments) and I (count), on a synthetic town of
     262,144 points at config #2's radii and caps, G and I bit for bit and
     H within its tolerance, then on wrapped lattice dims, ties across
     buckets, all-masked targets, unmatched queries, a query bucket over
     its cap and parked points; SIFT's grid octaves, kernels J (the
     Gaussian scale space) and K (the 26-NN), on the same town queried at
     its own points (masked ones parked at FAR) at config5_big's octave-0
     scales (0.1 m: J's cell 3 sigma_max, K's 8 scales), J within its
     tolerance (rows of unanswered queries 0, a second launch the same bits)
     and K bit for bit, then both on the same adversarial inputs, K with
     exclude_self both ways; the grid radius reduce, kernel L (Harris's
     response, suppression and refinement on the grid), on the same town
     queried at its own points at the Harris radius (0.6 m, cap 128): its
     sweep route at C = 1, 6, 9 and 12 channels (each width it is built
     for, and its generic one), sum and max, and its list route on 4,096
     and on 1 query, the count and the max bit for bit and
     the sum within REDUCE_RTOL of the members' sum of |v| (the TF32 and
     bfloat16 controls failing it), then both routes on the adversarial
     inputs, a NaN point and a full target bucket;
  4. eval config #1 (bench.py:49-77) through estimate_maps_transforms on the
     card: reset the kernels' launch counts, run once, require every kernel
     to have launched; gate the poses against the ground truth and against
     golden/config1.json at 1 deg / 0.1 m; on the card, is_zero of the
     transforms against `not t.any()`, rigid_inverse within 1e-5 of float64
     numpy.linalg.inv and compose(t, rigid_inverse(t)) within 1e-6 of the
     identity; time 5 warm repetitions; run compose_maps at the output
     resolution; the first cloud's SIFT keypoints through kernels C and D
     against those of their plain versions (at least 99% of the plain
     route's found at the same point, response within 1e-3 relative); one
     merge timed stage by stage through the kernels and one through their
     plain versions, SIFT's ms split into scale space and 26-NN;
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
     buckets, the candidates staged and the pairs counted, and splits each
     Harris extraction (harris_split: its two `build_grid` sorts, required
     two, its target's boxes, the response, the suppression and each
     refinement step, and its launches of grid_pack and L). Kernel L
     launches twice on its sweep route and three times on its list route a
     Harris extraction (10 / 15), and the first cloud's Harris keypoints
     through L are held against those of its plain versions
     (hold_harris_keypoints: at least 99% found within 1e-4 m, response
     within 1e-3 relative), its 6-channel response's mirrored sums against
     the 9-channel sweep's bit for bit, and its threshold-masked
     suppression's `keep` against the full one's bit for bit
     (hold_harris_route; so on config #3 too).
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
     spfh_grid and held exactly on the first map's inputs; kernels J and K
     launched once a grid SIFT octave (100 each: octaves 0 and 1 of 50 maps)
     and held in full on the first map's octaves 0 and 1, J within its
     tolerance and K bit for bit; the first map's SIFT keypoints through J
     and K against those of their plain versions (hold_sift_keypoints, 99%);
     a second node runs
     the first batch and must repeat the first tick's poses bit for bit; the
     stage times, counters, peak memory, wall time and maps per minute are
     printed.
  11. the offline tools on config #1's views written as binary .pcd files:
     tools/merge_tool.main, its transforms held bit for bit against
     estimate_maps_transforms on the files read back, its output file's
     points against compose_maps, gated at 1 deg / 0.1 m; then
     tools/registration_visualisation.main with --dump-dir: its dump files,
     its printed counts and its StageTimes table (nn bypassed there: the
     views' own sizes take the grid 1-NN); then the same views written as
     binary_compressed files (testing/lzf.py's compressor): merge_tool on
     them bit for bit its run on the binary files, the native LZF decoder
     called, and native.lzf_decompress held byte for byte against the plain
     decoder on both payloads and on one of config5_big's view size
     (459,685 points, 7,354,960 bytes), both timed;
  12. eval config #2 over a two-rank mesh on the one card (two threads, each
     a gloo group of one HashStore): both ranks' transforms and info_out bit
     for bit phase 7's, phase 7's gates, spfh exactly 5 launches (grid) and
     nn 0 over both ranks; the wall, the peak memory, and each rank's clouds,
     pairs and gather seconds;
  13. the stateless node over two ranks on config #1's views, each rank
     ingesting one robot through its own DirectoryTransport, ticks in
     lockstep: both ranks' poses bit for bit one stateless node's over the
     same two maps, within 1 deg / 0.1 m; the merged maps of equal size.
  14. eval config #3 (bench_configs.py:306-348): two town views of
     1,840,730 points at capacity 2^21, extract_features on each and one
     estimate_transform (Harris + FPFH, 1024 hypotheses, ICP <= 40, grid
     engine); a cold run (launches, peak memory, the probe's and the pair's
     overflow, ICP's flag and iterations) gated at 2 deg / 0.3 m against the
     truth, spfh exactly 2 launches through spfh_grid held exactly on the
     first cloud's inputs, nn 0; a warm and a stage-timed run, each bit for
     bit the cold one;
  15. eval config #4 (bench_configs.py:351-369, gates :599-611) over two OS
     processes on the one card: this script runs itself twice as
     `--rank-job RANK WORLD ADDRESS WORKDIR`; each joins through
     multihost.initialize and global_mesh(), merges config #4's 20 maps
     (town_views(20, 4096, seed=3), SIFT + FPFH, dense engine) and runs
     tests/test_distributed_node.py's scenario (one robot a rank, its own
     DirectoryTransport, ticks in lockstep), holds both kernels on its own
     first-launch inputs and prints one JSON line. Both ranks must give this
     process's single-rank merge bit for bit, info_out included, and one
     stateless node's poses over both maps (within 3 deg / 0.1 m, the gates
     both packages meet there); config #4's gates (14 of 19 adjacent hops
     within 5 deg / 0.5 m, 18 of 20 maps within 1 deg / 0.1 m of the truth
     relative to the first registered map); a failed or stuck rank process
     fails the phase;
     On the one-rank merge, its first 20 pairs (the first chunk) are
     registered again one at a time: the same ok flags, poses within
     PAIR_TOL, the largest difference printed;
  16. config5 (bench_configs.py:615-675): 50 town views of 6,747 points
     streamed ten at a time through the stateless node (SIFT + FPFH, dense
     engine), each batch a discovery, an estimation and a compositing tick:
     gated at 35 of 50 maps registered, 38 adjacent hops within 8 deg / 0.5
     m, drift under 10 deg / 0.5 m and more than 1,000 merged points; the
     last tick bit for bit estimate_maps_transforms on the node's clouds, a
     second node's first batch bit for bit the first tick; each tick's
     time with the tree solve (native) and the pose-graph refinement split
     out, maps a second, peak memory,
     ICP's loop iterations per chunk; the first tick's 45 pairs (one chunk)
     registered again one at a time, held as in phase 15.
Pair routes: where the registration clouds take the dense engine,
estimate_maps_transforms registers the pairs in chunks through
estimate_pairs_batch (config #1, config1_pfh, the sweep, the stateless
node, merge_tool, the node over two ranks or processes, config #4,
config5): kernel A's batched entry launches there and its one-pair entry
must not (no fallback). The incremental node registers one pair at a time
on the dense engine (the one-pair entry); config #2, config5_big, the
debugger and config #3 take the grid 1-NN (kernel G, neither dense entry;
G on no other path). Each path's route, its pair stage's seconds and its
chunks are printed and required.
Each path runs with the launch counts reset just before it and read just
after. The kernel launch counts are one per process, so phases 12-13 count
both thread ranks' launches, and phase 15's rank processes each report
their own. On every path each kernel it launched is then held against its
plain version on the inputs of its first launch in that run (the path's own
shapes, ragged edges included), and both are timed there (CUDA events,
warm, median), beside the kernel's bound: the larger of the bytes it must move over 3.35 TB/s and
the float32 operations these inputs need over 67 TFLOP/s (H100 SXM data
sheet). Kernel A's entries are also timed against one PyTorch route to the
same 1-NN (torch.cdist, the masked targets set to inf, a min over the
targets; library_ms), with the share of queries whose index it matches, of
all and of those not parked at FAR; it rounds otherwise, so it is a
yardstick, not held for bits.
SIFT's dense octaves (kernels C and D, one launch each a dense octave:
three an extraction, one on config5_big, whose octaves 0-1 take the grid;
none on the Harris paths) are required per path from the extractions and
dense octaves counted there, and both are held on every SIFT path's first
launch: C within its tolerance, D exactly, D also timed against torch.cdist +
torch.topk (knn_library); check_sift holds them on adversarial inputs too
(sift_adversarial). C's and D's bounds count the work their inputs need
(the pairs within C's radius, D's k a query), the dense sweep's beside.
The dense radius sweeps (kernels E and F: the outlier pass, SC3D's
density count and the normals) launch once a dense radius pass, one C call
each, their order pre-pass (radius_order) with them on the streamed route
(above RESIDENT_MAX_POINTS) and on no other: E and F once a dense
extraction, E once more on SC3D, neither on config #2, #3 or config5_big
(require_radius); both are held on every dense path's first launch, with
the route it took, the pairs its culling compares and its device time
(torch.profiler) beside the time through the wrapper, E exactly and F
within its tolerance, F's
normals' valid flags equal to the plain version's (the ok flips and the
largest angle logged, and what the angle comes from: moments_precision,
which also holds TF32 and bfloat16 controls of F's sums to fail F's limit
on config #1), E also timed against torch.cdist <= r (count_library).
The grid sweeps (kernels G, H and I, csrc/grid.cu: the grid engine's
bounded 1-NN behind ICP and the score, its moments behind the normals and
its count behind outlier removal, each reading the target and query grids
in place, one launch a call) are required per path: G on the grid route,
H once a grid normal pass and I once a grid outlier pass (and SC3D density
count), none on the dense paths (require_grid_radius); each is held on its
first launch on every grid path (G on ICP's and on the score's first call),
G and I bit for bit and H within its tolerance with the normals' flags, and
timed beside its plain version, the grid route before them, and its bound
on the members (the pairs it visits beside it); G and I also beside
torch.cdist + min / <= r on 4,096 sampled answered queries, scaled
(grid_library_stats), and on config #2 H against float64 sums, with TF32
and bfloat16 controls of its sums required to fail its limit
(grid_moments_precision).
SIFT's grid octaves (kernels J and K, csrc/grid.cu: grid_gaussian_smooth
and the big-Q branch of grid_radius_neighbors, reading the grids in place,
one launch each a grid octave) are required per path: once each a SIFT
octave that resolves to the grid, so 100 each on config5_big and none on
any other path (require_grid_sift); each is held on its first launch at
every query count on the path (config5_big's octaves 0 and 1, in full), J
within SCALE_SPACE_RTOL of the field and K bit for bit in every column,
and timed beside its plain version and its bound (J the members at 9 + 5 a
sigma, K the pairs visited at 9); K also beside torch.cdist + topk on 4,096
sampled answered queries, scaled (grid_library_stats). G, H, I, J and K
each launch the pre-pass grid_pack with them (require_grid_pack), and each
is launched once more with its counters on (select_stats: pairs compared,
tiles visited, units, the lanes' share; H's, I's and J's members required
to be the plain route's exactly; I's straddling pairs, warp steps and
tiles counted a lane a query).
The tile pre-pass (kernels/tiles.pack, which C and D read) launches once
a dense SIFT octave, for both, exactly (require_pack), and is held exactly
on its first launch on every path.
Config #1's merge is also timed stage by stage and profiled once
(profile_merge: the device busy share), and config5_big's octave 0 (2^19
points, on the grid) is timed through C and D beside the grid route, whole
ops through J and K and through their plain versions
(big_octave_stats, with knn_library on its sampled queries), its first
map's outlier and normal passes through E and F beside the grid's, through
I and H and through their plain versions (big_radius_stats), held on
sampled queries; config #1's octaves 1 and 2 give C's and D's bounds and
D's knn_library (sift_octave_stats).
Kernel L (csrc/grid.cu: the grid's radius_reduce behind Harris, its
sweep route `grid_reduce` on the pre-pass and the query grid, its list
route `grid_reduce_list` for at most 4,096 queries) is required twice
(sweep) and three times (list) a Harris extraction on the grid, so 10 / 15
on config #2 and over its two ranks, 4 / 6 on config #3 and none elsewhere
(require_grid_reduce); it is held on the first response (6 channels),
suppression (over the queries above the threshold) and refinement step (9
channels) of each such path (the count and the max bit for bit, the sum
within REDUCE_RTOL of the members' sum of |v|; on config #2 its TF32 and
bfloat16 controls must fail that limit), timed beside its plain version
(the list route given the target's boxes, as Harris calls it), its bound
(the members at 9 + C against both grids' bytes and the values'; the list
route's on the tiles within the radius of a query) and, for the sum,
`(torch.cdist(q, p) <= r).float() @ values` on 4,096 sampled answered
queries, scaled (reduce_library_stats); the sweep route's counters too
(the max's are I's). The ptxas report of each of L's instantiations is
logged apart (reduce_ptxas).
The line before the last is a JSON object of the kernels (kernel
A's one-pair and batched entries, kernel B, the pre-pass, kernels C, D, E,
F, E's and F's order pre-pass, G, H, I, J, K, the grid pre-pass and L's
two routes): launches, times and bound
on each kernel's main path (MAIN_PATH: config #1 for the batched entry, B,
C, D, E, F and their order pre-pass, config #2
for G, H, I, L and the grid pre-pass, config5_big for J and K, the
incremental node on config
#1's views for the one-pair entry), and the same for every path and for
the synthetic shapes; the last
line is {"ok": true, "device": {...}}.
The native host library (native/, csrc/mapmerge_native.cpp): on every path
that solves a graph (4-8, 11-13, 15 in this process and in each rank
process, 16) the call counts are reset just before the path and
merge_graph_solve required after it, once a tree solve, and each solve's
result held against compute_global_transforms_plain on the path's own
estimates (the same maps registered, within 1e-5), both timed on the
largest (host clock, median of 20); the incremental node (9, 10), config
#3 (14) and the debugger (11) must solve none, as in the JAX package.
Config #2's stage times (7) and config5's ticks (16) split the tree solve
from the refinement. A `native` JSON line comes before the card's line.
Imports nothing of JAX and nothing of mapmerge_tpu, and checks at its end
that no such module was loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
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
#: SIFT's dense octave 0 on config #1 (kernels C and D): Q = P = max_points,
#: S = 6 sigmas from the resolution, 0.1 m, the 26-NN
SIFT_N, SIFT_BASE, SIFT_SCALES, SIFT_K = 32768, 0.1, 3, 26
#: float32 operations of one (query, point) pair of kernels C and D: the
#: distance 8 and the bound or list compare 1 (NN_PAIR_OPS' count)
SIFT_PAIR_OPS = 9
#: and of each sigma of a pair within C's bound: the division, exp (special
#: functions count 1), the product and the two sums
SIFT_SIGMA_OPS = 5
#: the dense radius sweeps on config #1 (kernels E and F): the outlier
#: pass's radius (descriptor_radius) and the normals' (normal_radius)
OUTLIER_R, NORMAL_R = 0.8, 0.6
#: float32 operations of one (query, point) pair of kernels E and F: the
#: distance 8 and the radius compare 1
RADIUS_PAIR_OPS = 9
#: and of each member of kernel F: 10 sums (the count, 3 coordinates, 6
#: products) and the 6 products
MOMENTS_MEMBER_OPS = 16
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


def nn_batched_bound(q, p) -> dict:
    """nn_bound of each pair, times the batch."""
    nb, nq, np_ = q.shape[0], q.shape[1], p.shape[1]
    return _bound(nb * (nq * 12 + np_ * 13 + nq * 8), nb * nq * np_ * NN_PAIR_OPS)


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
    from mapmerge_torch.core.grid import _neighbor_buckets

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
    library = nn_library_stats(nn.nearest_neighbor, (q, p, mask))
    bound = nn_bound(q, p)
    log(
        f"kernel nearest_neighbor Q=P={NN_Q}: max|d2 err| {err}"
        f", idx mismatches at ties {n_tie_mismatch}, tie/all-masked ok; "
        f"kernel {ms} ms, plain {plain_ms} ms, library {library['library_ms']} ms, "
        f"bound {bound['bound_ms']} ms"
    )
    return {"shape": f"Q={NN_Q} P={NN_P}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **library, **bound}


def _nn_batched_compare(name, nn, q, p, mask=None):
    """Kernel A's batched entry against its plain version and against the
    unbatched kernel on each pair: indices and d2 bit for bit (both round
    every operation alike, and a pair's row does not depend on the batch).
    Returns (max |d2 err|, differing indices), both 0."""
    idx_k, d2_k = nn.nearest_neighbor_batched(q, p, mask)
    idx_r, d2_r = nn.nearest_neighbor_batched_ref(q, p, mask)
    torch.cuda.synchronize()
    require(idx_k.shape == d2_k.shape == q.shape[:2], f"{name}: shapes")
    err, diff = float((d2_k - d2_r).abs().max()), int((idx_k != idx_r).sum())
    require(err == 0.0 and diff == 0,
            f"{name}: max d2 err {err}, {diff} indices differ; exact required")
    for b in range(q.shape[0]):
        i1, d1 = nn.nearest_neighbor(q[b], p[b], None if mask is None else mask[b])
        require(torch.equal(i1, idx_k[b]) and torch.equal(d1, d2_k[b]),
                f"{name}: pair {b} differs from the unbatched kernel")
    return err, diff


def check_nn_batched(dev, nn) -> dict:
    """Kernel A's batched entry at config5's shape (45 pairs, Q = P =
    4096) with ragged masks and one fully masked pair, and the tie case,
    against its plain version and the unbatched kernel, exactly."""
    g = torch.Generator(device=dev).manual_seed(13)
    nb, n = 45, 4096
    q = torch.round(torch.rand((nb, n, 3), generator=g, device=dev) * 160) / 8
    p = torch.round(torch.rand((nb, n, 3), generator=g, device=dev) * 160) / 8
    mask = torch.rand((nb, n), generator=g, device=dev) > torch.rand(
        (nb, 1), generator=g, device=dev)
    mask[-1] = False
    err, diff = _nn_batched_compare("nn batched", nn, q, p, mask)
    it, dt = nn.nearest_neighbor_batched(torch.zeros((3, 256, 3), device=dev),
                                         torch.zeros((3, 5000, 3), device=dev))
    require(bool((it == 0).all()) and bool((dt == 0).all()), "nn batched: tie break")
    ms = time_ms(lambda: nn.nearest_neighbor_batched(q, p, mask))
    plain_ms = time_ms(lambda: nn.nearest_neighbor_batched_ref(q, p, mask), reps=5)
    library = nn_library_stats(nn.nearest_neighbor_batched, (q, p, mask))
    bound = nn_batched_bound(q, p)
    log(f"kernel nearest_neighbor_batched B={nb} Q=P={n}: max|d2 err| {err}, "
        f"indices differing {diff}, each pair = the unbatched kernel, ties ok; "
        f"kernel {ms} ms, plain {plain_ms} ms, library {library['library_ms']} ms, "
        f"bound {bound['bound_ms']} ms")
    return {"shape": f"B={nb} Q={n} P={n}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **library, **bound}


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


def sift_octave0(g, dev):
    """Config #1's octave-0 shape, surface-like: n slots of which 20% are
    padding at FAR, the rest on four planes 1 m apart over 16 x 16 m at
    about the voxel grid's density, in voxel order (by x, as the grid sorts
    its keys), with 8-bit intensities; centred as the octave centres them.
    Returns (qc, pc, vals, mask)."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.ops.neighbors import _center

    n = SIFT_N

    xyz = torch.rand((n, 3), generator=g, device=dev) * 16.0
    xyz[:, 2] = torch.round(xyz[:, 2] / 4.0)
    xyz = xyz[torch.argsort(xyz[:, 0])]
    mask = torch.arange(n, device=dev) < n - n // 5
    xyz[~mask] = FAR
    vals = torch.where(mask, torch.rand((n,), generator=g, device=dev) * 255.0, 0.0)
    qc, pc = _center(xyz, xyz, mask)
    return qc, pc, vals, mask


def sift_sigmas(base: float = SIFT_BASE, scales: int = SIFT_SCALES) -> list[float]:
    """One octave's sigmas (ops/keypoints/sift.py)."""
    return [base * (2.0 ** (s / scales)) for s in range(scales + 3)]


def scale_space_in_bound(args, tile: int = 1024) -> int:
    """The (query, valid point) pairs within kernel C's bound on its
    arguments `args`: the pairs whose sigmas these inputs make it compute
    (sq_dists' d2, the kernel's bits)."""
    from mapmerge_torch.ops.neighbors import sq_dists

    qc, pc, _, mask, _, r2_bound = args[:6]
    return sum(int(((sq_dists(qc[s : s + tile], pc) <= r2_bound) & mask[None]).sum())
               for s in range(0, qc.shape[0], tile))


def scale_space_bound(args, in_bound: int) -> dict:
    """Queries (12 B) and points (12 B, the value 4 B, the mask 1 B) read
    once, the (S, Q) field written once; the work these inputs need: for
    each pair within the bound SIFT_PAIR_OPS and SIFT_SIGMA_OPS a sigma (a
    kernel that culls need compute no other pair). Beside it
    `dense_bound_ms`, the count of a sweep over every pair (SIFT_PAIR_OPS
    each, the bound of the kernel that swept them all)."""
    qc, pc, _, _, sigmas = args[:5]
    nq, np_, ns = qc.shape[0], pc.shape[0], len(sigmas)
    n_bytes = nq * 12 + np_ * 17 + ns * nq * 4
    dense = _bound(n_bytes, nq * np_ * SIFT_PAIR_OPS + in_bound * ns * SIFT_SIGMA_OPS)
    return {**_bound(n_bytes, in_bound * (SIFT_PAIR_OPS + ns * SIFT_SIGMA_OPS)),
            "dense_bound_ms": dense["bound_ms"]}


def knn_bound(args) -> dict:
    """Queries (12 B) and targets (12 B, the mask 1 B) read once, the (Q, k)
    indices and flags written once; the work these inputs need: the k
    pairs each query keeps, SIFT_PAIR_OPS each. Beside it `dense_bound_ms`,
    every pair's (the bound of the kernel that swept them all)."""
    q, p, _, k = args[:4]
    nq, np_ = q.shape[0], p.shape[0]
    n_bytes = nq * 12 + np_ * 13 + nq * k * 5
    return {**_bound(n_bytes, nq * k * SIFT_PAIR_OPS),
            "dense_bound_ms": _bound(n_bytes, nq * np_ * SIFT_PAIR_OPS)["bound_ms"]}


def pack_bound(args) -> dict:
    """The pre-pass: points (12 B, the value 4 B where given, the mask 1 B
    where given) read once, the packed points (16 B a slot) and the boxes
    (32 B a tile) written once; a min and a max a coordinate a point."""
    p, vals, mask = args[:3]
    n = p.shape[0]
    tiles = -(-n // 32)
    n_bytes = n * (12 + (vals is not None) * 4 + (mask is not None)) + tiles * (32 * 16 + 32)
    return _bound(n_bytes, n * 6)


def _pack_compare(name, ktiles, args):
    """The pre-pass against pack_ref on the same inputs: the same values
    (NaN where NaN; -0 and +0 alike in a box) and the int bits of the
    fourth columns exactly. Returns 0.0, the max abs error."""
    pts, boxes = ktiles.pack(*args)
    rpts, rboxes = ktiles.pack_ref(*args)
    torch.cuda.synchronize()
    same = bool(((pts == rpts) | (pts.isnan() & rpts.isnan())).all())
    same = same and torch.equal(boxes[..., :3], rboxes[..., :3]) and torch.equal(
        boxes[..., 3].contiguous().view(torch.int32),
        rboxes[..., 3].contiguous().view(torch.int32))
    require(same and pts.shape == rpts.shape,
            f"{name}: the packed points or boxes differ from pack_ref")
    return 0.0


def _scale_space_compare(name, ksift, args, kwargs=None):
    """Kernel C (given `kwargs`: the path's own `packed`) against
    scale_space_ref on the same inputs. Tolerance: the largest difference
    within ksift.SCALE_SPACE_RTOL of the field's largest magnitude (exp, the
    division and the sums' order round apart; the points each query takes
    are the same bits); the queries parked at FAR exactly 0; a second launch
    the same bits. Returns (max abs err, that error over the field's largest
    magnitude)."""
    from mapmerge_torch.core.cloud import FAR

    got = ksift.scale_space(*args, **(kwargs or {}))
    ref = ksift.scale_space_ref(*args)
    again = ksift.scale_space(*args, **(kwargs or {}))
    torch.cuda.synchronize()
    require(got.shape == ref.shape == (len(args[4]), args[0].shape[0]), f"{name}: shapes")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    require(rel <= ksift.SCALE_SPACE_RTOL,
            f"{name}: off by {err} ({rel} of the field) > {ksift.SCALE_SPACE_RTOL}")
    parked = args[0].abs().amax(-1) >= FAR / 2
    require(bool((got[:, parked] == 0).all()), f"{name}: a parked query is not 0")
    require(torch.equal(got, again), f"{name}: a second launch gave other bits")
    return err, rel


def _knn_compare(name, ksift, args, kwargs=None):
    """Kernel D (given `kwargs`: the path's own `packed`) against knn_ref on
    the same inputs: indices and valid flags exactly (the k smallest (d2,
    index) pairs are unique). Returns the number of differing entries, 0."""
    idx, valid = ksift.knn(*args, **(kwargs or {}))
    ridx, rvalid = ksift.knn_ref(*args)
    torch.cuda.synchronize()
    diff = int((idx != ridx).sum()) + int((valid != rvalid).sum())
    require(idx.shape == ridx.shape and diff == 0,
            f"{name}: {diff} entries differ from the plain version; exact required")
    return diff


def knn_library(q, p, mask, k):
    """Kernel D's function by one PyTorch route: torch.cdist, the masked
    targets set to inf in place, torch.topk of the k smallest. Timed as a
    yardstick only: cdist rounds otherwise, topk orders ties as it likes,
    and a masked target sits at inf, not at BIG."""
    d = torch.cdist(q, p)
    if mask is not None:
        d.masked_fill_(~mask.unsqueeze(-2), math.inf)
    return d.topk(k, dim=-1, largest=False, sorted=True)


def knn_library_stats(ksift, args) -> dict:
    """knn_library on kernel D's inputs `args`: its time (time_ms, as the
    kernel's) and the share of (query, slot) entries whose index equals
    the kernel's, over all queries and over those not parked at FAR."""
    from mapmerge_torch.core.cloud import FAR

    q, p, mask, k = args[:4]
    ms = time_ms(lambda: knn_library(q, p, mask, k))
    agree = knn_library(q, p, mask, k).indices == ksift.knn(*args)[0].long()
    real = q.abs().amax(-1) < FAR / 2
    stats = {"library_ms": ms, "library_index_agreement": float(agree.double().mean()),
             "library_index_agreement_unparked": float(agree[real].double().mean())
             if bool(real.any()) else None}
    torch.cuda.empty_cache()
    return stats


def pack_stats(label: str, ktiles, seen: dict) -> dict:
    """The tile pre-pass on the inputs of its first launch on a path (the
    path's own shape: E's where outliers come first): held exactly against
    pack_ref (_pack_compare), then timed (CUDA events, warm, median),
    beside its bound."""
    if "tiles_pack" not in seen:
        return {}
    args, _ = seen["tiles_pack"]
    return {"tiles_pack": {
        "shape": f"P={args[0].shape[0]}, vals {args[1] is not None}",
        "max_abs_err": _pack_compare(f"{label} tiles_pack", ktiles, args),
        "ms": time_ms(lambda: ktiles.pack(*args)),
        "plain_ms": time_ms(lambda: ktiles.pack_ref(*args), reps=5),
        "library_ms": None, **pack_bound(args),
    }}


def sift_stats(label: str, ksift, seen: dict) -> dict:
    """Kernels C and D on the inputs of their first launch on a path (the
    path's own shapes): held against their plain versions
    (_scale_space_compare, _knn_compare), then timed (CUDA events, warm,
    median), beside the bound and, for D, knn_library. C and D take the
    buffer the path packed for them where it was recorded (their times are
    then the kernels' alone; the pre-pass has its own row), else pack their
    own points first."""
    stats = {}
    if "sift_scale_space" in seen:
        args, kwargs = seen["sift_scale_space"]
        err, rel = _scale_space_compare(f"{label} sift_scale_space", ksift, args, kwargs)
        in_bound = scale_space_in_bound(args)
        stats["sift_scale_space"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]} S={len(args[4])}",
            "max_abs_err": err,
            "err_of_field": rel, "pairs_in_bound": in_bound,
            "ms": time_ms(lambda: ksift.scale_space(*args, **kwargs)),
            "plain_ms": time_ms(lambda: ksift.scale_space_ref(*args), reps=3, warmup=1),
            "library_ms": None, **scale_space_bound(args, in_bound),
        }
    if "sift_knn" in seen:
        args, kwargs = seen["sift_knn"]
        diff = _knn_compare(f"{label} sift_knn", ksift, args, kwargs)
        stats["sift_knn"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]} k={args[3]}",
            "max_abs_err": 0.0,
            "entries_differing": diff,
            "ms": time_ms(lambda: ksift.knn(*args, **kwargs)),
            "plain_ms": time_ms(lambda: ksift.knn_ref(*args), reps=3, warmup=1),
            **knn_library_stats(ksift, args), **knn_bound(args),
        }
    return stats


def sift_adversarial(g, qc, pc, vals, mask) -> dict:
    """Inputs on which the culling of kernels C and D must stay exact, made
    from sift_octave0's (qc, pc, vals, mask): name -> (q, p, vals, mask).
    Shuffled (no voxel order: every tile spans the cloud), lattice points
    of 1/8 m (ties everywhere), every point masked, half the slots masked
    and their queries parked at FAR, a small Q against every point, and
    one tile (20 points)."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.ops.neighbors import _center

    n = pc.shape[0]
    perm = torch.randperm(n, generator=g, device=pc.device)
    lattice = torch.round(pc * 8.0) / 8.0
    half = torch.arange(n, device=pc.device) < n // 2
    parked = torch.where(half[:, None], pc, FAR)
    pq, pp = _center(parked, parked, half)
    none = torch.zeros_like(mask)
    return {
        "shuffled": (qc[perm], pc[perm], vals[perm], mask[perm]),
        "lattice ties": (lattice, lattice, vals, mask),
        "all masked": (qc, pc, torch.zeros_like(vals), none),
        "half parked": (pq, pp, torch.where(half, vals, 0.0), half),
        "small Q": (qc[:300], pc, vals, mask),
        "one tile": (qc[:20], pc[:20].contiguous(), vals[:20], mask[:20]),
    }


def check_sift(dev, ksift) -> dict:
    """The tile pre-pass and kernels C and D against their plain versions at
    config #1's octave-0 shape (sift_octave0: Q = P = 32,768, six sigmas,
    the 26-NN), C within its tolerance and D exactly; then all three on the
    inputs of sift_adversarial, D also at k = 9 and a bounded radius."""
    g = torch.Generator(device=dev).manual_seed(14)
    from mapmerge_torch.kernels import tiles as ktiles
    from mapmerge_torch.ops.neighbors import _f32

    qc, pc, vals, mask = sift_octave0(g, dev)
    sigmas = sift_sigmas()
    c_args = (qc, pc, vals, mask, sigmas, _f32((3.0 * max(sigmas)) ** 2))
    d_args = (qc, pc, mask, SIFT_K, _f32(1.0e12))
    first = {"tiles_pack": ((pc, vals, mask), {}),
             "sift_scale_space": (c_args, {}), "sift_knn": (d_args, {})}
    stats = {**pack_stats("synthetic", ktiles, first), **sift_stats("synthetic", ksift, first)}
    adversarial = sift_adversarial(g, qc, pc, vals, mask)
    for name, (q, p, v, m) in adversarial.items():
        _pack_compare(f"tiles_pack {name}", ktiles, (p, v, m))
        _scale_space_compare(f"sift_scale_space {name}", ksift,
                             (q, p, v, m, sigmas, c_args[5]))
        for k, r2 in ((SIFT_K, _f32(1.0e12)), (9, 0.25)):
            _knn_compare(f"sift_knn {name} k={k}", ksift, (q, p, m, min(k, p.shape[0]), r2))
    # as SIFT runs them: both on one buffer, packed with C's values
    shared = {"packed": ktiles.pack(pc, vals, mask)}
    _scale_space_compare("sift_scale_space on a shared buffer", ksift, c_args, shared)
    _knn_compare("sift_knn on a shared buffer", ksift, d_args, shared)
    c, d = stats["sift_scale_space"], stats["sift_knn"]
    log(f"kernel sift_scale_space {c['shape']}: max err {c['max_abs_err']} "
        f"({c['err_of_field']} of the field), {c['pairs_in_bound']} pairs in bound; "
        f"kernel {c['ms']} ms, plain {c['plain_ms']} ms, bound {c['bound_ms']} ms")
    log(f"kernels tiles_pack, sift_scale_space and sift_knn held on {sorted(adversarial)} "
        "(sift_knn at k = 26 and 9), and C and D on one shared buffer")
    log(f"kernel sift_knn {d['shape']}: exact; "
        f"kernel {d['ms']} ms, plain {d['plain_ms']} ms, library {d['library_ms']} ms "
        f"(index agreement {d['library_index_agreement_unparked']} unparked), "
        f"bound {d['bound_ms']} ms")
    return stats


def radius_count_bound(args, in_bound: int) -> dict:
    """Kernel E: queries (12 B) and points (12 B, the mask 1 B) read once,
    the counts (4 B) written once; the work these inputs need: each member
    pair's RADIUS_PAIR_OPS (a kernel that culls need test no other pair).
    Beside it `dense_bound_ms`, every pair's (the dense sweep's bound)."""
    nq, np_ = args[0].shape[0], args[1].shape[0]
    n_bytes = nq * 12 + np_ * 13 + nq * 4
    return {**_bound(n_bytes, in_bound * RADIUS_PAIR_OPS),
            "dense_bound_ms": _bound(n_bytes, nq * np_ * RADIUS_PAIR_OPS)["bound_ms"]}


def radius_moments_bound(args, in_bound: int) -> dict:
    """Kernel F: as E's, the count, mean and covariance (52 B a query)
    written once; each member pair's RADIUS_PAIR_OPS + MOMENTS_MEMBER_OPS.
    Beside it `dense_bound_ms`, every pair's distance and compare and the
    members' sums."""
    nq, np_ = args[0].shape[0], args[1].shape[0]
    n_bytes = nq * 12 + np_ * 13 + nq * 52
    dense = nq * np_ * RADIUS_PAIR_OPS + in_bound * MOMENTS_MEMBER_OPS
    return {**_bound(n_bytes, in_bound * (RADIUS_PAIR_OPS + MOMENTS_MEMBER_OPS)),
            "dense_bound_ms": _bound(n_bytes, dense)["bound_ms"]}


def count_library(q, p, mask, r2):
    """Kernel E's function by one PyTorch route: torch.cdist, <= the
    radius, the masked targets dropped, summed over the targets. Timed as a
    yardstick only: cdist expands the distance through a matmul and rounds
    otherwise."""
    within = torch.cdist(q, p) <= math.sqrt(r2)
    if mask is not None:
        within &= mask.unsqueeze(-2)
    return within.sum(-1)


def count_library_stats(kradius, args) -> dict:
    """count_library on kernel E's inputs `args`: its time (time_ms, as the
    kernel's) and the share of queries whose count equals the kernel's."""
    q, p, mask, r2 = args[:4]
    ms = time_ms(lambda: count_library(q, p, mask, r2))
    agree = count_library(q, p, mask, r2) == kradius.count(*args).long()
    stats = {"library_ms": ms, "library_count_agreement": float(agree.double().mean())}
    torch.cuda.empty_cache()
    return stats


def _count_compare(name, kradius, args):
    """Kernel E against count_ref on the same inputs: bit for bit, the
    queries parked at FAR 0. Returns count_ref's counts."""
    from mapmerge_torch.core.cloud import FAR

    got = kradius.count(*args)
    ref = kradius.count_ref(*args)
    torch.cuda.synchronize()
    diff = int((got != ref).sum())
    require(got.shape == ref.shape and diff == 0,
            f"{name}: {diff} counts differ from the plain version; exact required")
    parked = args[0].abs().amax(-1) >= FAR / 2
    require(not bool(got[parked].any()), f"{name}: a parked query has members")
    return ref


def normals_hold(got, ref, args, required: bool = True) -> dict:
    """Kernel F's (or H's) moments and the plain version's through the
    normals' eigen solver (ops/eigh3.smallest_eigenpair3), as
    ops/normals.py takes them: the `valid` flags (ok, count >= 3, and the
    cloud's mask where the queries are its points) equal (required where
    `required`); the points whose `ok` flips, and the largest angle between
    the two normals over the points valid in both (in degrees, the
    eigenvectors' sign aside: the viewpoint flip follows), recorded."""
    from mapmerge_torch.ops.eigh3 import smallest_eigenpair3

    own = args[0].shape[0] == args[1].shape[0] and args[2] is not None
    flags, vecs, oks = [], [], []
    for count, _, cov in (got, ref):
        _, vec, ok = smallest_eigenpair3(cov)
        valid = ok & (count >= 3.0)
        flags.append(valid & args[2] if own else valid)
        vecs.append(vec)
        oks.append(ok)
    both = flags[0] & flags[1]
    cos = (vecs[0][both] * vecs[1][both]).sum(-1).abs().clamp(max=1.0)
    angle = float(torch.rad2deg(torch.acos(cos)).max()) if bool(both.any()) else 0.0
    held = {"valid": int(flags[0].sum()), "valid_differing": int((flags[0] != flags[1]).sum()),
            "ok_flips": int((oks[0] != oks[1]).sum()), "max_angle_deg": angle}
    require(not required or held["valid_differing"] == 0,
            f"normals' valid flags differ between the kernel and its plain version: {held}")
    return held


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), held in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _products(pc: torch.Tensor) -> torch.Tensor:
    return (pc[:, :, None] * pc[:, None, :]).reshape(-1, 9)


#: the operands (points, per-point products) of the moments' sums: float64
#: (the sums' truth over the same members), and the controls of a kernel
#: that rounds them to TF32 or bfloat16 before it sums in float32
MOMENTS_OPERANDS = {
    "float64": lambda pc: (pc.double(), _products(pc.double())),
    "tf32": lambda pc: (_tf32(pc), _tf32(_products(pc))),
    "bf16": lambda pc: tuple(x.to(torch.bfloat16).to(torch.float32)
                             for x in (pc, _products(pc))),
}


def moments_sums(args, operands, tile: int = 1024):
    """moments_ref's function of F's inputs `args` on moments_ref's own
    members (its float32 sq_dists and mask: the same bits), with the
    matrix products' operands `operands(pc)` (MOMENTS_OPERANDS)."""
    from mapmerge_torch.core.dense import sq_dists, tiled_query

    qc, pc, mask, r2 = args[:4]
    xc, xpp = operands(pc)

    def tile_fn(q_slab):
        within = sq_dists(q_slab, pc) <= r2
        if mask is not None:
            within = within & mask[None, :]
        w = within.to(xc.dtype)
        s0 = w.sum(dim=-1)
        denom = s0.clamp_min(1.0)[:, None]
        mean = (w @ xc) / denom
        e_outer = (w @ xpp) / denom
        return s0, mean, e_outer.reshape(-1, 3, 3) - mean[:, :, None] * mean[:, None, :]

    return tiled_query(qc, tile_fn, tile)


def moments_precision(kradius, args, controls_fail: bool) -> dict:
    """Where F's limit stands, on F's inputs `args`: F's moments and
    moments_ref's each against the float64 sums over the same members
    (kradius.moments_error: the largest share of a query's largest second
    moment), and the TF32 and bfloat16 controls against moments_ref, both
    required to fail MOMENTS_RTOL where `controls_fail`. Then what the
    normals' angle comes from: over the points whose normals are valid in
    both routes, the smallest eigenvectors (float64 eigh) of F's, the plain
    version's and the float64 covariance; the largest angles between them,
    the points over 0.1 deg; at the point of the largest angle between F
    and the plain version, and at that between the plain version and the
    float64 sums, its members, float64 eigenvalues, the gap under which the
    normal turns, the covariance's difference and that over the gap
    (first-order perturbation: the angle it predicts)."""
    got = kradius.moments(*args)
    ref = kradius.moments_ref(*args)
    truth = moments_sums(args, MOMENTS_OPERANDS["float64"])
    out = {"kernel_vs_float64": kradius.moments_error(got, truth)[1],
           "plain_vs_float64": kradius.moments_error(ref, truth)[1]}
    for name in ("tf32", "bf16"):
        control = moments_sums(args, MOMENTS_OPERANDS[name])
        out[f"{name}_control"] = kradius.moments_error(control, ref)[1]
        require(not controls_fail or out[f"{name}_control"] > kradius.MOMENTS_RTOL,
                f"radius_moments: a {name} control is within MOMENTS_RTOL "
                f"({out[f'{name}_control']}): the limit does not tell it from float32")
    own = args[0].shape[0] == args[1].shape[0] and args[2] is not None
    valid = (got[0] >= 3.0) & (ref[0] >= 3.0)
    if own:
        valid &= args[2]
    if not bool(valid.any()):
        return out
    lams, normals = [], []
    for _, _, cov in (got, ref, truth):
        lam, vec = torch.linalg.eigh(cov[valid].double().cpu())
        lams.append(lam)
        normals.append(vec[..., :, 0])

    def angle(a, b):
        return torch.rad2deg(torch.acos((a * b).sum(-1).abs().clamp(max=1.0)))

    kp, kt, pt = (angle(normals[0], normals[1]), angle(normals[0], normals[2]),
                  angle(normals[1], normals[2]))

    def point(i: int, other) -> dict:
        """Point i of the valid ones: its members, float64 eigenvalues, the
        gap, |cov - other's cov| and the angle it predicts over the gap."""
        lam = lams[2][i]
        gap = float(lam[1] - lam[0])
        dcov = float((other[2][valid][i] - ref[2][valid][i]).abs().max())
        mean = ref[1][valid][i]
        return {"members": float(ref[0][valid][i]),
                "eigenvalues_float64": [float(v) for v in lam], "gap": gap,
                "cov_diff": dcov,
                "second_moment": float((ref[2][valid][i] + mean[:, None] * mean[None, :])
                                       .abs().max()),
                "predicted_deg": math.degrees(dcov / gap) if gap > 0 else None}

    over = kp > 0.1
    rel_gap = (lams[2][:, 1] - lams[2][:, 0]) / lams[2][:, 2].clamp_min(1e-30)
    out.update({
        "points": int(valid.sum()),
        "max_angle_deg": {"kernel_vs_plain": float(kp.max()),
                          "kernel_vs_float64": float(kt.max()),
                          "plain_vs_float64": float(pt.max())},
        "over_0.1_deg": {"kernel_vs_plain": int(over.sum()),
                         "kernel_vs_float64": int((kt > 0.1).sum()),
                         "plain_vs_float64": int((pt > 0.1).sum())},
        "median_rel_gap": {"all": float(rel_gap.median()),
                           "over_0.1_deg": float(rel_gap[over].median())
                           if bool(over.any()) else None},
        "worst_kernel_vs_plain": point(int(kp.argmax()), got),
        "worst_plain_vs_float64": point(int(pt.argmax()), truth),
    })
    return out


def _moments_compare(name, kradius, args):
    """Kernel F against moments_ref on the same inputs: the count exactly,
    the mean and covariance within MOMENTS_RTOL of each query's largest
    second moment (kradius.moments_error), a second launch the same bits,
    the normals held (normals_hold). Returns (max abs err, that error over
    the second moment, the members counted, normals_hold's record)."""
    got = kradius.moments(*args)
    ref = kradius.moments_ref(*args)
    again = kradius.moments(*args)
    torch.cuda.synchronize()
    require(all(a.shape == b.shape for a, b in zip(got, ref)), f"{name}: shapes")
    require(all(bool(torch.isfinite(a).all()) for a in got), f"{name}: non-finite values")
    require(torch.equal(got[0], ref[0]), f"{name}: the counts differ from the plain version")
    err, rel = kradius.moments_error(got, ref)
    require(rel <= kradius.MOMENTS_RTOL,
            f"{name}: off by {err} ({rel} of a second moment) > {kradius.MOMENTS_RTOL}")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: a second launch gave other bits")
    return err, rel, int(ref[0].sum()), normals_hold(got, ref, args)


def device_us(fn, reps: int = 10) -> dict:
    """The device time of one call of fn in µs: by kernel name (and memset)
    torch.profiler's CUDA intervals over `reps` calls after a warm one,
    summed by name, over reps ("total" their sum); and "queued": CUDA events
    around `reps` calls that the host queued behind a device-side sleep
    (torch.cuda._sleep, long enough to cover the host's issue time), so the
    device runs them back to back, over reps. Over chip_smoke's many
    profiler sessions in one process the profiler has dropped kernels
    (totals falling to 0 on later paths), so "queued" is the one to read."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name).split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                      - e.time_range.start) / reps
    by_name["total"] = sum(by_name.values())
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * reps * host_s * 2e9) + 1_000_000)  # cycles, ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    by_name["queued"] = start.elapsed_time(end) * 1e3 / reps
    return by_name


def radius_pairs(kradius, args) -> dict:
    """What the culling of kernel E or F compares on its inputs `args`, by
    the route their size takes (the boxes of the caller's order of tiles,
    or of order_ref's): a query's pairs compared, the TILE points of each
    tile whose clamped-box bound is within r2 of it; those of the tiles its
    warp visits (the box of the warp's queries and one of its queries reach
    the tile: what its lanes test); its members. Each a query, over the
    queries not parked at FAR."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.kernels import tiles as ktiles

    qc, pc, mask, r2 = args[:4]
    route = kradius.route(pc.shape[0])
    if route == "resident":
        _, boxes = ktiles.pack_ref(pc, None, mask)
    else:
        _, boxes, _ = kradius.order_ref(pc, mask, r2)
    lo, hi = boxes[:, 0, :3], boxes[:, 1, :3]
    per_warp = kradius.TILE // kradius.LANES
    live = qc.abs().amax(-1) < FAR / 2
    own = warp = 0
    for s in range(0, qc.shape[0], 4096):  # whole warps at a time
        q = qc[s : s + 4096]
        d = q[:, None] - torch.minimum(torch.maximum(q[:, None], lo), hi)
        reach = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2] <= r2
        pad = -q.shape[0] % per_warp
        qw = torch.cat([q, q[-1:].expand(pad, 3)]).view(-1, per_warp, 3)
        qlo, qhi = qw.amin(1)[:, None], qw.amax(1)[:, None]
        gap = torch.where(qhi < lo, lo - qhi, torch.where(hi < qlo, qlo - hi, 0.0))
        box = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
        rw = torch.cat([reach, reach[:0].new_zeros((pad, reach.shape[1]))])
        visit = (box <= r2) & rw.view(-1, per_warp, rw.shape[1]).any(1)
        ok = live[s : s + 4096]
        own += int(reach[ok].sum())
        warp += int(visit.sum(1).repeat_interleave(per_warp)[: q.shape[0]][ok].sum())
    n = max(int(live.sum()), 1)
    members = int(kradius.count_ref(*args[:4])[live].sum())
    return {"route": route, "pairs_compared_per_query": own * kradius.TILE / n,
            "warp_pairs_per_query": warp * kradius.TILE / n, "members_per_query": members / n}


def _order_compare(name, kradius, args) -> None:
    """E's and F's order pre-pass against order_ref: the same values, NaN
    where NaN."""
    got, want = kradius.order(*args), kradius.order_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        require(a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all()),
                f"{name}: differs from order_ref")


def order_bound(args) -> dict:
    """The order pre-pass: the points (12 B) and the mask (1 B) read once,
    the points (16 B) and the boxes (32 B a tile and a chunk) of P rounded
    up to a chunk written once (kradius.work_floats); no arithmetic to
    speak of."""
    from mapmerge_torch.kernels import radius as kradius

    np_ = args[0].shape[0]
    return _bound(np_ * 13 + kradius.work_floats(np_) * 4, 0)


def radius_stats(label: str, kradius, seen: dict) -> dict:
    """Kernels E and F on the inputs of their first launch on a path (the
    path's own shapes): held against their plain versions (_count_compare,
    _moments_compare), then timed through the wrapper (CUDA events, warm,
    median: one C call, the route's launches) and on the device (device_us:
    torch.profiler, by kernel), beside the bound on the members (the dense
    sweep's beside it) and, for E, count_library; the route each took and
    the pairs its culling compares (radius_pairs). Where the path's first
    streamed call recorded its points, the order pre-pass alone: held
    exactly against order_ref and timed so."""
    stats = {}
    if "radius_count" in seen:
        args, _ = seen["radius_count"]
        in_bound = int(_count_compare(f"{label} radius_count", kradius, args).sum())
        stats["radius_count"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]} r2={args[3]}",
            "max_abs_err": 0.0, "pairs_in_bound": in_bound, **radius_pairs(kradius, args),
            "ms": time_ms(lambda: kradius.count(*args)),
            "device_us": device_us(lambda: kradius.count(*args)),
            "plain_ms": time_ms(lambda: kradius.count_ref(*args), reps=3, warmup=1),
            **count_library_stats(kradius, args), **radius_count_bound(args, in_bound),
        }
    if "radius_moments" in seen:
        args, _ = seen["radius_moments"]
        err, rel, in_bound, normals = _moments_compare(
            f"{label} radius_moments", kradius, args)
        stats["radius_moments"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]} r2={args[3]}",
            "max_abs_err": err, "err_of_second_moment": rel, "pairs_in_bound": in_bound,
            **radius_pairs(kradius, args), "normals": normals,
            "precision": moments_precision(
                kradius, args, controls_fail=label in ("synthetic", MAIN_PATH["radius_moments"])),
            "ms": time_ms(lambda: kradius.moments(*args)),
            "device_us": device_us(lambda: kradius.moments(*args)),
            "plain_ms": time_ms(lambda: kradius.moments_ref(*args), reps=3, warmup=1),
            "library_ms": None, **radius_moments_bound(args, in_bound),
        }
    if "radius_order" in seen:
        args, _ = seen["radius_order"]
        _order_compare(f"{label} radius_order", kradius, args)
        stats["radius_order"] = {
            "shape": f"P={args[0].shape[0]} r2={args[2]}", "max_abs_err": 0.0,
            "ms": time_ms(lambda: kradius.order(*args)),
            "device_us": device_us(lambda: kradius.order(*args)),
            "plain_ms": time_ms(lambda: kradius.order_ref(*args), reps=3, warmup=1),
            "library_ms": None, **order_bound(args),
        }
    return stats


def radius_adversarial(g, qc, pc, mask) -> dict:
    """Inputs on which the culling of kernels E and F must stay exact, made
    from sift_octave0's (qc, pc, mask): name -> (q, p, mask, r2 of E, r2 of
    F). A 1/4 m lattice at radii of 0.5 and 0.75 m (r2 exact in float32:
    every point has neighbours exactly on the radius, and ties everywhere),
    shuffled (no voxel order), every point masked, half the slots masked and
    their queries parked at FAR, queries that are not the cloud's points
    (a moved sample), and one tile (20 points)."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.ops.neighbors import _center, _f32

    n = pc.shape[0]
    r2e, r2f = _f32(OUTLIER_R ** 2), _f32(NORMAL_R ** 2)
    perm = torch.randperm(n, generator=g, device=pc.device)
    lattice = torch.round(pc * 4.0) / 4.0
    half = torch.arange(n, device=pc.device) < n // 2
    parked = torch.where(half[:, None], pc, FAR)
    pq, pp = _center(parked, parked, half)
    moved = qc[: n - n // 5 : 11] + torch.tensor([0.05, -0.03, 0.01], device=qc.device)
    return {
        "lattice on the radius": (lattice, lattice, mask, 0.25, 0.5625),
        "shuffled": (qc[perm], pc[perm], mask[perm], r2e, r2f),
        "all masked": (qc, pc, torch.zeros_like(mask), r2e, r2f),
        "half parked": (pq, pp, half, r2e, r2f),
        "other queries": (moved.contiguous(), pc, mask, r2e, r2f),
        "one tile": (qc[:20], pc[:20].contiguous(), mask[:20], r2e, r2f),
    }


def check_radius(dev, kradius) -> dict:
    """Kernels E and F against their plain versions at config #1's width
    (sift_octave0's points: Q = P = 32,768, 20% padding at FAR, the
    streamed route; E at the outlier radius, F at the normals'), E exactly
    and F within its tolerance, both timed, and their order pre-pass on its
    points; then at the first RESIDENT_MAX_POINTS of them and one more
    (either side of the cutoff: the two routes), and on radius_adversarial's
    inputs made from all of them and from the first 8,192 (the two routes)."""
    from mapmerge_torch.ops.neighbors import _f32

    g = torch.Generator(device=dev).manual_seed(15)
    qc, pc, _, mask = sift_octave0(g, dev)
    r2e, r2f = _f32(OUTLIER_R ** 2), _f32(NORMAL_R ** 2)

    def first(n: int) -> dict:
        q, p, m = qc[:n].contiguous(), pc[:n].contiguous(), mask[:n].contiguous()
        return {"radius_count": ((q, p, m, r2e), {}), "radius_moments": ((q, p, m, r2f), {}),
                **({"radius_order": ((p, m, r2e), {})}
                   if kradius.route(n) == "streamed" else {})}

    stats = radius_stats("synthetic", kradius, first(qc.shape[0]))
    cutoff = kradius.RESIDENT_MAX_POINTS
    sides = {side: radius_stats(f"synthetic {side}", kradius, first(n))
             for side, n in (("at the cutoff", cutoff), ("past the cutoff", cutoff + 1))}
    for name in ("radius_count", "radius_moments"):
        stats[name]["either_side_of_cutoff"] = {side: st[name] for side, st in sides.items()}
        require([st[name]["route"] for st in sides.values()] == ["resident", "streamed"],
                f"{name}: the routes either side of the cutoff are "
                f"{[st[name]['route'] for st in sides.values()]}")
    worst = 0.0
    adversarial = {**{f"{name} ({kradius.route(pc.shape[0])})": case
                      for name, case in radius_adversarial(g, qc, pc, mask).items()},
                   **{f"{name} (resident)": case for name, case in radius_adversarial(
                       g, qc[:8192].contiguous(), pc[:8192].contiguous(),
                       mask[:8192].contiguous()).items()}}
    for name, (q, p, m, r2e, r2f) in adversarial.items():
        _count_compare(f"radius_count {name}", kradius, (q, p, m, r2e))
        _, rel, _, _ = _moments_compare(f"radius_moments {name}", kradius, (q, p, m, r2f))
        worst = max(worst, rel)
    e, f = stats["radius_count"], stats["radius_moments"]
    log(f"kernel radius_count {e['shape']}: exact, {e['pairs_in_bound']} pairs in bound; "
        f"kernel {e['ms']} ms, plain {e['plain_ms']} ms, library {e['library_ms']} ms "
        f"(count agreement {e['library_count_agreement']}), bound {e['bound_ms']} ms")
    log(f"kernel radius_moments {f['shape']}: max err {f['max_abs_err']} "
        f"({f['err_of_second_moment']} of a second moment), normals {f['normals']}, "
        f"precision {json.dumps(f['precision'])}; "
        f"kernel {f['ms']} ms, plain {f['plain_ms']} ms, bound {f['bound_ms']} ms")
    log(f"kernels radius_count and radius_moments held on {sorted(adversarial)} (largest "
        f"moments error {worst} of a second moment)")
    for side, st in sides.items():
        log(f"kernels radius_count and radius_moments {side} ({st['radius_count']['shape']}, "
            f"{st['radius_count']['route']}): E {st['radius_count']['ms']} ms "
            f"({st['radius_count']['device_us']['queued']} µs on the device), F "
            f"{st['radius_moments']['ms']} ms ({st['radius_moments']['device_us']['queued']} "
            f"µs), F off by {st['radius_moments']['err_of_second_moment']} of a second moment")
    o = stats["radius_order"]
    log(f"kernel radius_order {o['shape']}: exact; {o['ms']} ms "
        f"({o['device_us']['queued']} µs on the device), plain {o['plain_ms']} ms, "
        f"bound {o['bound_ms']} ms")
    return stats


#: the grid sweeps (kernels G, H and I): config #2's radii and bucket caps
#: (ICP's bound max_correspondence_distance at registration_scan_cap, the
#: outlier pass at descriptor_radius and the normals at normal_radius at
#: grid_scan_cap)
GRID_NN_BOUND, GRID_NN_CAP, GRID_CAP = 1.0, 256, 128
#: float32 operations of one (query, candidate) pair of kernels G, H and I:
#: the distance 8 and the bound compare 1 (NN_PAIR_OPS' count)
GRID_PAIR_OPS = 9


def grid_operands(p, mask, q, q_mask, cell: float, cap: int, dims=None):
    """(target grid, query grid, q, n_p) as ops/grid builds them for one
    call of kernel G, H or I: build_grid of the targets, and of the queries
    into the same layout and cap."""
    from mapmerge_torch.ops.grid import build_grid

    grid = build_grid(p, mask, cell, dims, cap)
    qg = build_grid(q, q_mask, grid.cell_size, grid.dims, grid.cap)
    return grid, qg, q, p.shape[0]


def grid_visit_counters(grid, qg) -> dict:
    """What one call of G, H or I visits: the buckets that hold an answered
    query slot (one CTA each that does not exit at once), the answered
    slots, the (query, candidate) pairs (each answered slot against the
    filled slots of the distinct wrapped neighbours of its bucket) and the
    distinct target points among the candidates."""
    from mapmerge_torch.core.grid import _neighbor_buckets

    active = torch.nonzero(qg.count > 0).flatten()
    if active.numel() == 0:
        return {"active_buckets": 0, "answered": 0, "pairs_visited": 0,
                "distinct_candidates": 0}
    count = grid.count.to(torch.int64)
    nbr, _ = torch.sort(_neighbor_buckets(active, grid.dims), dim=-1)
    first = torch.ones_like(nbr, dtype=torch.bool)
    first[:, 1:] = nbr[:, 1:] != nbr[:, :-1]
    answered = qg.cell_ok[active].sum(dim=1).to(torch.int64)
    return {"active_buckets": int(active.numel()), "answered": int(answered.sum()),
            "pairs_visited": int((answered * (count[nbr] * first).sum(dim=1)).sum()),
            "distinct_candidates": int(count[torch.unique(nbr)].sum())}


#: bytes a query row of each grid kernel writes: G idx and d2, H the count,
#: mean and covariance, I the count
GRID_ROW_BYTES = {"grid_nn": 8, "grid_moments": 52, "grid_count": 4}


def grid_bound(name: str, grid, qg, q, members: int, values=None) -> dict:
    """A grid kernel's least time on these inputs: the distinct candidate
    points read once (12 B, and G the 8 B index of the one it keeps: counted
    for each), both grids' counts (4 B a bucket), the answered query slots
    (12 B and their 8 B row) and the answered flags of the active buckets
    (1 B a slot), the rows written once; the work these inputs need: each
    member's GRID_PAIR_OPS (the (query, target) pairs within the radius, for
    G within the bound: a kernel that culls need test no other pair), and
    MOMENTS_MEMBER_OPS more for H. Beside it `visited_bound_ms`, every pair
    the kernels visit (grid_visit_counters' pairs_visited) at
    GRID_PAIR_OPS, as E's `dense_bound_ms` sits beside E's bound. L
    (`values` (P, C) given) reads the values of the distinct candidates
    once (4 B a channel: it reads values only through the candidates'
    cell_idx, never a padded or masked row), writes a count and C channels
    a row and adds C a member."""
    c = grid_visit_counters(grid, qg)
    h, cap = grid.cell_idx.shape
    row = GRID_ROW_BYTES[name] if values is None else 4 + 4 * values.shape[1]
    n_bytes = (c["distinct_candidates"] * (20 if name == "grid_nn" else 12) + 2 * h * 4
               + c["answered"] * 20 + c["active_buckets"] * cap + q.shape[0] * row
               + (0 if values is None else c["distinct_candidates"] * 4 * values.shape[1]))
    extra = members * MOMENTS_MEMBER_OPS if name == "grid_moments" else 0
    if values is not None:
        extra = members * values.shape[1]
    return {**c, "members": members, **_bound(n_bytes, members * GRID_PAIR_OPS + extra),
            "visited_bound_ms": _bound(
                n_bytes, c["pairs_visited"] * GRID_PAIR_OPS + extra)["bound_ms"]}


def grid_library_stats(name: str, args, got) -> dict:
    """nn_library (G), knn_library (K) or count_library (I) on
    BIG_OCTAVE_SAMPLE queries sampled from the call's answered ones, against
    the points the target
    grid kept (its filled slots: the target side's caps dropped the rest,
    as for the kernel; the queries the query-side cap dropped are not
    answered and not sampled). A Q x P plane of all the answered queries
    would not fit (2^20 x 380,000 is 1.6 TB), so the call is timed on the
    sample (time_ms) and that time scaled by the answered queries over the
    sample, as big_octave_stats does for D. Beside them the share of
    sampled queries on which the library agrees with the kernel's `got`: G
    the index, over the queries G matched within the bound; K the index at
    each slot, over K's valid entries; I the count (include_self added
    back). cdist rounds otherwise than the kernels' direct distances, so a
    near-tie or a pair at the bound may differ."""
    from mapmerge_torch.kernels import grid as kgrid

    grid, qg, q = args[:3]
    answered = qg.cell_idx[qg.cell_ok]
    if answered.numel() == 0:
        return {"library_ms": None}
    pts = grid.cell_xyz[grid.cell_ok].contiguous()
    g = torch.Generator(device=q.device).manual_seed(21)
    pick = torch.randperm(answered.numel(), generator=g, device=q.device)
    sample = answered[pick[:BIG_OCTAVE_SAMPLE]].sort().values
    qs = q[sample].contiguous()
    if name == "grid_nn":
        ms = time_ms(lambda: nn_library(qs, pts))
        j = nn_library(qs, pts).indices
        matched = got[1][sample] < 1e11
        agree = (grid.cell_idx[grid.cell_ok][j] == got[0][sample].long())[matched]
        share = {"library_index_agreement_matched": float(agree.double().mean())
                 if bool(matched.any()) else None}
    elif name == "grid_knn":
        k = args[4]
        ms = time_ms(lambda: knn_library(qs, pts, None, k))
        j = knn_library(qs, pts, None, k).indices
        valid = got[2][sample]
        agree = (grid.cell_idx[grid.cell_ok][j] == got[0][sample].long())[valid]
        share = {"library_index_agreement_valid": float(agree.double().mean())
                 if bool(valid.any()) else None}
    else:
        r2, include_self = args[3], args[4] if len(args) > 4 else True
        ms = time_ms(lambda: count_library(qs, pts, None, r2))
        want = got[sample].long() + (0 if include_self else 1)
        share = {"library_count_agreement": float(
            (count_library(qs, pts, None, r2) == want).double().mean())}
    torch.cuda.empty_cache()
    return {"library_sample": int(sample.numel()), "library_sample_ms": ms,
            "library_ms": ms * answered.numel() / sample.numel(), **share}


#: the threads a CTA of the one-thread-a-slot sweep (csrc/grid.cu's
#: grid_sweep_kernel until kernel I left it, on which G took 256 and K, H,
#: I and J 128 before their own kernels; L's share is read at H's 128):
#: one a query slot, a CTA a query bucket
SWEEP_THREADS = {"grid_nn": 256, "grid_knn": 128, "grid_moments": 128, "grid_smooth": 128,
                 "grid_count": 128, "grid_reduce": 128}


def select_stats(name: str, kgrid, args, members: int | None = None) -> dict:
    """What kernel G ("grid_nn"), K ("grid_knn"), H ("grid_moments"), I
    ("grid_count") or J ("grid_smooth") did on these inputs
    (kgrid.select_counters, a launch of its own with the counters on): the
    (query, candidate) pairs compared, the tiles visited, the units and the
    share of their lanes that answer a query, for H, I and J the members
    added, required to be `members`, the plain route's (count_ref's),
    exactly, and for I its straddling (query, tile) pairs, warp steps and
    tiles counted a lane a query; beside them the share the
    sweep's one-thread-a-slot CTAs gave (answered slots over the threads of
    the groups of SWEEP_THREADS slots the answered buckets launch), the
    pairs compared over the pairs the sweep visits, and for G `ms_kept`,
    the call given the target's boxes made before (ICP's iterations; `ms`
    makes them in the call)."""
    grid, qg = args[:2]
    threads = min(SWEEP_THREADS[name], -(-grid.cap // 32) * 32)
    groups = (qg.count.to(torch.int64) + threads - 1) // threads
    launched = int(groups.sum()) * threads
    stats = {**kgrid.select_counters(name, *args),
             "sweep_lane_share": int(qg.cell_ok.sum()) / launched if launched else None}
    visited = grid_visit_counters(grid, qg)["pairs_visited"]
    stats["compared_share"] = stats["pairs_compared"] / visited if visited else None
    if "members" in stats:
        require(stats["members"] == members,
                f"{name}: the kernel added {stats['members']} members, the plain route "
                f"has {members}; exact required")
    if name == "grid_nn":
        boxes = kgrid.boxes(grid)
        stats["ms_kept"] = time_ms(lambda: kgrid.nn_query(*args, boxes=boxes))
    return stats


def grid_pack_bound(kgrid, grid, units: int) -> dict:
    """The pre-pass's least time: the filled target slots read once (12 B),
    both grids' counts (4 B a bucket each), each filled tile's box written
    (32 B) and the units listed (4 B each, and the count)."""
    h, cap = grid.cell_idx.shape
    filled = int(grid.count.clamp(0, cap).to(torch.int64).sum())
    n_bytes = (filled * 12 + 2 * h * 4 + int(kgrid.filled_tiles(grid).sum()) * 32
               + (units + 1) * 4)
    return _bound(n_bytes, 0)


def _grid_pack_compare(name, kgrid, args):
    """The pre-pass against pack_ref on the same inputs: the boxes of the
    filled tiles equal (as values: a zero's sign may differ), with the
    units and alone (boxes()), the units the same set. Returns the count of
    units."""
    boxes, units = kgrid.pack(*args[:3])
    alone = kgrid.boxes(args[0])
    rboxes, runits = kgrid.pack_ref(*args[:3])
    torch.cuda.synchronize()
    n = int(units[0])
    filled = kgrid.filled_tiles(args[0])
    for got in (boxes, alone):
        require(got.shape == rboxes.shape and bool((got[filled] == rboxes[filled]).all()),
                f"{name}: the boxes of the filled tiles differ from pack_ref")
    require(n == int(runits[0]) and torch.equal(
        units[1 : n + 1].sort().values, runits[1 : n + 1].sort().values),
        f"{name}: the units differ from pack_ref")
    return n


def grid_pack_stats(label: str, kgrid, seen: dict) -> dict:
    """The pre-pass on the inputs of the path's first G call from ICP, or
    else of its first K call at the largest query count, moved back to the
    card: held against pack_ref, timed (boxes and units, as a call that is
    given no boxes launches it), the plain version too, beside its bound. No single PyTorch call packs tile boxes and
    work units: library_ms is null."""
    knn = sorted((k for k in seen if k.startswith("grid_knn Q=")),
                 key=lambda k: -int(k.split("=")[1]))
    key = "grid_nn icp" if "grid_nn icp" in seen else (knn[0] if knn else None)
    if key is None:
        return {}
    dev = torch.device("cuda", torch.cuda.current_device())
    args = [_copied(a, dev) for a in seen[key][0]]
    units = _grid_pack_compare(f"{label} grid_pack", kgrid, args)
    grid = args[0]
    entry = {"shape": f"of {key.split()[0]}'s first input: grid "
                      f"{tuple(grid.cell_idx.shape)}, {units} units of 32 queries",
             "max_abs_err": 0.0, "units": units,
             "ms": time_ms(lambda: kgrid.pack(*args[:3])),
             "boxes_ms": time_ms(lambda: kgrid.boxes(grid)),
             "plain_ms": time_ms(lambda: kgrid.pack_ref(*args[:3]), reps=3, warmup=1),
             **grid_pack_bound(kgrid, grid, units), "library_ms": None}
    del args, grid
    torch.cuda.empty_cache()
    return {"grid_pack": entry}


def _grid_nn_compare(name, kgrid, args):
    """Kernel G against nn_query_ref on the same inputs: idx and d2 bit for
    bit, a second launch (given the target's boxes made before, as ICP
    gives them) the same bits. Returns the plain version's (idx, d2)."""
    got = kgrid.nn_query(*args)
    ref = kgrid.nn_query_ref(*args)
    again = kgrid.nn_query(*args, boxes=kgrid.boxes(args[0]))
    torch.cuda.synchronize()
    require(all(a.shape == b.shape for a, b in zip(got, ref)), f"{name}: shapes")
    diff = [int((a != b).sum()) for a, b in zip(got, ref)]
    require(diff == [0, 0],
            f"{name}: {diff[0]} indices and {diff[1]} d2 differ from nn_query_ref; "
            "exact required")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: a second launch gave other bits")
    return ref


def _grid_count_compare(name, kgrid, args):
    """Kernel I against count_ref on the same inputs: bit for bit. Returns
    the plain version's counts."""
    got = kgrid.count(*args)
    ref = kgrid.count_ref(*args)
    torch.cuda.synchronize()
    diff = int((got != ref).sum())
    require(got.shape == ref.shape and diff == 0,
            f"{name}: {diff} counts differ from count_ref; exact required")
    return ref


class OutsideTolerance(RuntimeError):
    """A moments check over MOMENTS_RTOL; `rel` its share of a second
    moment."""

    def __init__(self, msg: str, rel: float):
        super().__init__(msg)
        self.rel = rel


def _grid_moments_compare(name, kgrid, args, flags_required: bool = True, moments=None):
    """Kernel H (or `moments`, a stand-in with its signature: the controls
    of grid_moments_precision) against moments_ref on the same inputs: the
    count exactly, the mean and covariance within MOMENTS_RTOL
    (kradius.moments_error about the queries; over it OutsideTolerance), a
    second launch the same bits, the normals' valid flags (ok, count >= 3)
    equal where `flags_required` (normals_hold: the synthetic and
    adversarial inputs, whose sparse or lattice neighbourhoods put the
    eigen solver's `ok` threshold within rounding, record them). Returns
    (max abs err, its share, the members counted, normals_hold's record)."""
    from mapmerge_torch.kernels import radius as kradius

    moments = moments or kgrid.moments
    got = moments(*args)
    ref = kgrid.moments_ref(*args)
    again = moments(*args)
    torch.cuda.synchronize()
    require(all(a.shape == b.shape for a, b in zip(got, ref)), f"{name}: shapes")
    require(all(bool(torch.isfinite(a).all()) for a in got), f"{name}: non-finite values")
    require(torch.equal(got[0], ref[0]), f"{name}: the counts differ from moments_ref")
    q = args[2]
    err, rel = kradius.moments_error(got, ref, q)
    if rel > kradius.MOMENTS_RTOL:
        raise OutsideTolerance(f"chip_smoke: {name}: off by {err} ({rel} of a second "
                               f"moment) > {kradius.MOMENTS_RTOL}", rel)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: a second launch gave other bits")
    # the counts summed as integers: a float32 sum rounds past 2^24 members
    members = int(ref[0].to(torch.int64).sum())
    return err, rel, members, normals_hold(got, ref, (q, q[:0], None), flags_required)


def grid_moments_sums(args, operands):
    """moments_ref's function of H's inputs `args` on moments_ref's own
    members (its float32 offsets cand - q and their d2 <= r2: the same
    bits), the offsets and their products given to the sums as
    `operands(offsets)` (MOMENTS_OPERANDS) and summed in their type, the
    mean and covariance rounded once to float32 at the end."""
    from mapmerge_torch.core.grid import grid_query

    grid, qg, q, r2 = args[:4]

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx):
        r = cand_xyz[:, None, :, :] - q_block[:, :, None, :]  # (B, Cq, M, 3)
        d2 = r[..., 0] * r[..., 0]
        d2 += r[..., 1] * r[..., 1]
        d2 += r[..., 2] * r[..., 2]
        x, xx = operands(r.reshape(-1, 3))
        x, xx = x.reshape(r.shape), xx.reshape(r.shape[:-1] + (9,))
        w = (cand_ok[:, None, :] & (d2 <= r2)).to(x.dtype)
        del r, d2
        s0 = w.sum(dim=-1)
        denom = s0.clamp_min(1.0)[..., None]
        mean_rel = (w[..., None] * x).sum(-2) / denom
        e2 = ((w[..., None] * xx).sum(-2) / denom).reshape(w.shape[:2] + (3, 3))
        cov = e2 - mean_rel[..., :, None] * mean_rel[..., None, :]
        return (s0.float(), (mean_rel + q_block.to(x.dtype)).float(), cov.float())

    out, _ = grid_query(q, grid, tile_fn, (0.0, 0.0, 0.0), qg=qg)
    return out


def grid_moments_precision(name, kgrid, args) -> dict:
    """Where H's limit stands, on H's inputs `args`: H's moments and
    moments_ref's each against the float64 sums of the same float32 offsets
    over the same members (kradius.moments_error about the queries), and
    the TF32 and bfloat16 controls (the offsets and their products rounded
    so before float32 sums) put through _grid_moments_compare in H's place,
    each required to fail it on MOMENTS_RTOL."""
    from mapmerge_torch.kernels import radius as kradius

    q = args[2]
    truth = grid_moments_sums(args, MOMENTS_OPERANDS["float64"])
    out = {"kernel_vs_float64": kradius.moments_error(kgrid.moments(*args), truth, q)[1],
           "plain_vs_float64": kradius.moments_error(kgrid.moments_ref(*args), truth, q)[1]}
    del truth
    for control in ("tf32", "bf16"):
        try:
            _grid_moments_compare(
                f"{name} {control} control", kgrid, args, flags_required=False,
                moments=lambda *a, o=MOMENTS_OPERANDS[control]: grid_moments_sums(a, o))
        except OutsideTolerance as e:
            out[f"{control}_control"] = e.rel
        else:
            require(False, f"{name}: the {control} control passed _grid_moments_compare: "
                    "MOMENTS_RTOL does not tell it from float32")
        torch.cuda.empty_cache()
    log(f"{name}: H against float64 sums, and its controls: {json.dumps(out)}")
    return out


def grid_stats(label: str, kgrid, seen: dict) -> dict:
    """Kernels G, H and I on the inputs of their first launch on a path
    (G: ICP's first call and the transform score's, recorded apart), moved
    back to the card: held against their plain versions (G and I bit for
    bit, H within MOMENTS_RTOL with the normals' flags; on H's main path
    also against float64 sums, with its TF32 and bfloat16 controls), then
    timed (CUDA events, warm, median), the plain version too, beside the
    bound on the members and, for G and I, the library call on a sample
    (grid_library_stats); G's, H's and I's counters (select_stats, H's and
    I's members exactly the plain route's). No single PyTorch call sums neighbourhood
    moments: H's library_ms is null."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stats = {}
    for key in ("grid_nn icp", "grid_nn score", "grid_moments", "grid_count"):
        if key not in seen:
            continue
        args, _ = seen[key]
        args = [_copied(a, dev) for a in args]
        grid, qg, q = args[:3]
        name = key.split()[0]
        shape = (f"Q={q.shape[0]}, grid {tuple(grid.cell_idx.shape)} dims {grid.dims} "
                 f"cell {grid.cell_size}, query overflow {int(qg.overflow)}")
        if name == "grid_nn":
            ref = _grid_nn_compare(f"{label} {key}", kgrid, args)
            members = int(kgrid.count_ref(grid, qg, q, kgrid._nn_r2(grid))
                          .to(torch.int64).sum())
            entry = {"max_abs_err": 0.0, "matched": int((ref[1] < 1e11).sum()),
                     "fn": kgrid.nn_query, "plain": kgrid.nn_query_ref,
                     **grid_bound(name, grid, qg, q, members),
                     **grid_library_stats(name, args, ref), **select_stats(name, kgrid, args)}
        elif name == "grid_count":
            ref = _grid_count_compare(f"{label} {key}", kgrid, args)
            sub = 0 if (args[4] if len(args) > 4 else True) else 1
            members = int((ref.to(torch.int64) + sub).sum())
            entry = {"max_abs_err": 0.0, "fn": kgrid.count, "plain": kgrid.count_ref,
                     **grid_bound(name, grid, qg, q, members),
                     **grid_library_stats(name, args, ref),
                     **select_stats(name, kgrid, args, members)}
        else:
            err, rel, members, normals = _grid_moments_compare(
                f"{label} {key}", kgrid, args, flags_required=label != "synthetic")
            entry = {"max_abs_err": err, "err_of_second_moment": rel,
                     "normals": normals, "fn": kgrid.moments, "plain": kgrid.moments_ref,
                     **grid_bound(name, grid, qg, q, members), "library_ms": None,
                     **select_stats(name, kgrid, args, members)}
            if label == MAIN_PATH[name]:
                entry["precision"] = grid_moments_precision(f"{label} {key}", kgrid, args)
        fn, plain = entry.pop("fn"), entry.pop("plain")
        entry = {"shape": shape, **entry, "ms": time_ms(lambda: fn(*args)),
                 "plain_ms": time_ms(lambda: plain(*args), reps=3, warmup=1)}
        if key == "grid_nn score":
            stats.setdefault("grid_nn", {})["score"] = entry
        else:
            stats[name] = {**stats.get(name, {}), **entry}
        del args, grid, qg, q
        torch.cuda.empty_cache()
    return stats


def grid_adversarial(g, p, mask, q, q_mask) -> dict:
    """Inputs on which kernels G, H and I must keep the plain versions'
    bits, made from the first 20,000 of check_grid's points: name -> (p,
    mask, q, q_mask, cell, cap, dims). A 1/8 m lattice over wrapped dims
    (4, 2, 1) (every neighbour id repeated, ties across buckets), a 1/4 m
    lattice of cell corners queried at the cells' centres (eight points at
    one distance, in several buckets),
    every target masked, queries 30 m away (unmatched), 3,000 queries at one
    point (a query bucket far over its cap), half the targets and queries
    parked at FAR, and queries on the sphere: each exactly 0.625 m (the
    cell) from a point of a 1/8 m lattice, by an offset whose squares and
    sums are exact in float32 (0.625 on an axis, or 0.375 and 0.5 on two),
    every other one moved a float32 step in one coordinate."""
    from mapmerge_torch.core.cloud import FAR

    n = min(20_000, p.shape[0])
    p, mask, q, q_mask = p[:n], mask[:n], q[:n], q_mask[:n]
    lattice = torch.round(p * 8.0) / 8.0
    quarter = torch.round(p * 4.0) / 4.0
    centres = quarter + 0.125
    half = torch.arange(n, device=p.device) < n // 2
    one = q.clone()
    one[:3000] = q[0]
    legs = torch.tensor([[0.625, 0.0, 0.0], [0.375, 0.5, 0.0]], device=p.device)
    offsets = torch.cat([legs[:, perm] for perm in itertools.permutations(range(3))])
    offsets = torch.cat([offsets * torch.tensor(signs, device=p.device)
                         for signs in itertools.product((1.0, -1.0), repeat=3)])
    row = torch.arange(n, device=p.device)
    sphere = lattice + offsets[row % offsets.shape[0]]
    odd = row[1::2]  # a step inwards or outwards on one axis
    axis = (odd // 2) % 3
    sphere[odd, axis] = torch.nextafter(
        sphere[odd, axis], torch.where(odd % 4 == 1, -FAR, FAR).to(sphere))
    return {
        "wrapped lattice": (lattice, mask, lattice, q_mask, 0.375, 256, (4, 2, 1)),
        "centre ties": (quarter, mask, centres, q_mask, 0.25, 128, None),
        "all masked": (p, torch.zeros_like(mask), q, q_mask, 0.5, 128, None),
        "unmatched": (p, mask, q + 30.0, q_mask, 0.5, 128, None),
        "query bucket over its cap": (p, mask, one, q_mask, 0.5, 64, None),
        "half parked": (torch.where(half[:, None], p, FAR), mask & half,
                        torch.where(half[:, None], FAR, q), q_mask, 0.5, 128, None),
        "on the sphere": (lattice, mask, sphere, q_mask, 0.625, 128, None),
    }


def check_grid(dev, kgrid, n: int = 1 << 18) -> dict:
    """Kernels G, H and I against their plain versions on a synthetic town
    of n = 262,144 surface points over 64 x 64 m (planes 3 m apart, 5% masked),
    G at config #2's ICP bound and cap (1.0 m, 256) for the points moved by a
    small pose (10% outside q_mask), H at the normals' radius and I at the
    outlier radius (cap 128) without include_self; then all three on
    grid_adversarial's inputs."""
    from mapmerge_torch.ops.neighbors import _f32

    g = torch.Generator(device=dev).manual_seed(16)
    p = torch.rand((n, 3), generator=g, device=dev) * 64.0
    p[:, 2] = torch.round(p[:, 2] / 3.0) * 3.0 + 0.02 * torch.rand((n,), generator=g, device=dev)
    mask = torch.rand((n,), generator=g, device=dev) > 0.05
    q = p + torch.tensor([0.05, -0.03, 0.02], device=dev)
    q_mask = torch.rand((n,), generator=g, device=dev) > 0.1
    first = {
        "grid_nn icp": (grid_operands(p, mask, q, q_mask, GRID_NN_BOUND, GRID_NN_CAP), {}),
        "grid_moments": (grid_operands(p, mask, p, None, NORMAL_R, GRID_CAP)[:3]
                         + (_f32(NORMAL_R ** 2),), {}),
        "grid_count": (grid_operands(p, mask, p, None, OUTLIER_R, GRID_CAP)[:3]
                       + (_f32(OUTLIER_R ** 2), False), {}),
    }
    stats = grid_stats("synthetic", kgrid, first)
    adversarial = grid_adversarial(g, p, mask, q, q_mask)
    worst, flags = 0.0, {}
    for name, (ap, am, aq, aqm, cell, cap, dims) in adversarial.items():
        grid, qg, tq, n_p = grid_operands(ap, am, aq, aqm, cell, cap, dims)
        r2 = _f32(cell * cell)
        _grid_nn_compare(f"grid_nn {name}", kgrid, (grid, qg, tq, n_p))
        _grid_pack_compare(f"grid_pack {name}", kgrid, (grid, qg, tq))
        qg_all = grid_operands(ap, am, aq, None, cell, cap, dims)[1]
        _grid_count_compare(f"grid_count {name}", kgrid, (grid, qg_all, tq, r2, False))
        _, rel, _, flags[name] = _grid_moments_compare(
            f"grid_moments {name}", kgrid, (grid, qg_all, tq, r2), flags_required=False)
        worst = max(worst, rel)
    for key, e in stats.items():
        counters = {k: e[k] for k in ("pairs_compared", "compared_share", "tiles_visited",
                                      "members", "straddling", "steps", "looped") if k in e}
        log(f"kernel {key} {e['shape']}: max err {e['max_abs_err']}, "
            f"{e['pairs_visited']} pairs visited, normals {e.get('normals')}; kernel "
            f"{e['ms']} ms, plain {e['plain_ms']} ms, bound {e['bound_ms']} ms "
            f"({e['bound_by']}); counters {json.dumps(counters)}")
    log(f"kernels grid_nn (repeating, given its boxes), grid_pack, grid_count and "
        f"grid_moments held on {sorted(adversarial)} "
        f"(largest moments error {worst} of a second moment); normals' flags, "
        f"recorded: {json.dumps(flags)}")
    pack = grid_pack_stats("synthetic", kgrid, first)
    log(f"kernel grid_pack, synthetic: {json.dumps(pack)}")
    return {**stats, **pack}


# ---- kernel L: the grid radius reduce (Harris's response, suppression and
# corner refinement on the grid) ----

#: L's recorded first calls on a path: (key, Harris's call it serves)
REDUCE_CALLS = (("grid_reduce sum", "response"), ("grid_reduce max", "suppression"),
                ("grid_reduce_list sum", "refinement"))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where NaN (a zero's sign aside)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _reduce_values(args, list_route: bool, values=None):
    """The values of L's arguments (sweep: grid, qg, q, values, r2, op;
    list: grid, q, values, r2, op), or the arguments with `values` in
    their place."""
    at = 2 if list_route else 3
    if values is None:
        return args[at]
    return (*args[:at], values, *args[at + 1 :])


def _grid_reduce_compare(name, kgrid, args, list_route: bool, reduce_fn=None):
    """Kernel L (or `reduce_fn`, a stand-in with its signature: the controls
    of reduce_precision) against its plain version on the same inputs: the
    count exactly, the max bit for bit (NaN where NaN), the sum within
    REDUCE_RTOL of the members' sum of |v| (kgrid.reduce_error; over it
    OutsideTolerance), a second call the same bits. Returns (the plain
    version's output, the sum's max abs err, its share of that scale)."""
    fn = reduce_fn or (kgrid.reduce_list if list_route else kgrid.reduce)
    plain = kgrid.reduce_list_ref if list_route else kgrid.reduce_ref
    got, ref, again = fn(*args), plain(*args), fn(*args)
    torch.cuda.synchronize()
    require(all(a.shape == b.shape for a, b in zip(got, ref)), f"{name}: shapes")
    require(torch.equal(got[0], ref[0]),
            f"{name}: {int((got[0] != ref[0]).sum())} counts differ from the plain version")
    err = rel = 0.0
    if args[-1] == "max":
        require(_same_bits(got[1], ref[1]),
                f"{name}: the max differs from the plain version; exact required")
    else:
        values = _reduce_values(args, list_route)
        scale = plain(*_reduce_values((*args[:-1], "sum"), list_route, values.abs()))[1]
        rel = kgrid.reduce_error(got[1], ref[1], scale)
        err = float((got[1] - ref[1]).abs().max()) if got[1].numel() else 0.0
        if not rel <= kgrid.REDUCE_RTOL:  # reduce_error is inf where one side is NaN
            raise OutsideTolerance(f"chip_smoke: {name}: off by {err} ({rel} of the members' "
                                   f"sum of |v|) > {kgrid.REDUCE_RTOL}", rel)
    require(torch.equal(got[0], again[0]) and _same_bits(got[1], again[1]),
            f"{name}: a second call gave other bits")
    return ref, err, rel


def reduce_precision(name, kgrid, args, list_route: bool) -> dict:
    """Where L's sum limit stands, on L's sum inputs `args`: the plain
    version with the values rounded to TF32 and to bfloat16 first put
    through _grid_reduce_compare in L's place, each required to fail
    REDUCE_RTOL."""
    plain = kgrid.reduce_list_ref if list_route else kgrid.reduce_ref
    values = _reduce_values(args, list_route)
    out = {}
    for control, rounded in (("tf32", _tf32(values)),
                             ("bf16", values.to(torch.bfloat16).to(torch.float32))):
        try:
            _grid_reduce_compare(
                f"{name} {control} control", kgrid, args, list_route,
                reduce_fn=lambda *a, v=rounded: plain(*_reduce_values(a, list_route, v)))
        except OutsideTolerance as e:
            out[f"{control}_control"] = e.rel
        else:
            require(False, f"{name}: the {control} control passed _grid_reduce_compare: "
                    "REDUCE_RTOL does not tell it from float32")
    log(f"{name}: L's sum limit against its TF32 and bfloat16 controls: {json.dumps(out)}")
    return out


def reduce_nan_control(name, kgrid, args, list_route: bool) -> float:
    """A self-check of _grid_reduce_compare's sum limit: kernel L's own
    output with NaN written into the sum of one query that has members,
    put through it in L's place, required to come out OutsideTolerance (a
    NaN on one side must not compare within REDUCE_RTOL). Returns the
    error it reported."""
    fn = kgrid.reduce_list if list_route else kgrid.reduce

    def stand_in(*a):
        count, out = fn(*a)
        out = out.clone()
        out[int(count.argmax())] = float("nan")
        return count, out

    try:
        _grid_reduce_compare(f"{name} NaN control", kgrid, args, list_route, reduce_fn=stand_in)
    except OutsideTolerance as e:
        return e.rel
    require(False, f"{name}: a sum with a NaN row passed _grid_reduce_compare")


def grid_list_bound(grid, q, values, members: int, r2: float) -> dict:
    """L's list route's least time on these inputs: the queries (12 B)
    and the rows written (4 + 4 C B); the counts (4 B) and the tile boxes
    (32 B) of the neighbour buckets of the queries' buckets; the distinct
    slots of the tiles whose box lies within r2 of some query (box_bound in
    the kernel's rounded operations: a tile beyond it holds no member),
    read once (12 B and their C values of 4 B); each member's
    GRID_PAIR_OPS and an add a channel. Beside them the distinct
    candidates of those buckets, which the route read whole before it
    culled."""
    from mapmerge_torch.core.grid import _bucket_of, _cells, _neighbor_buckets
    from mapmerge_torch.kernels import grid as kgrid

    cap, c = grid.cap, values.shape[1]
    tiles = -(-cap // kgrid.TILE)
    bucket = _bucket_of(_cells(q, grid.cell_size), grid.dims)
    nbr = _neighbor_buckets(bucket, grid.dims)  # (Q, 27)
    count = grid.count[nbr].clamp(0, cap).to(torch.int64)
    t = torch.arange(tiles, device=q.device)
    code = nbr[..., None] * tiles + t  # (Q, 27, T)
    filled = (t * kgrid.TILE < count[..., None])
    box = kgrid.boxes_ref(grid)[code]  # (Q, 27, T, 2, 4)
    lo, hi = box[..., 0, :3], box[..., 1, :3]
    near = q[:, None, None, :].clamp(min=lo, max=hi)
    d = q[:, None, None, :] - near
    bound = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    reached = torch.unique(code[filled & (bound <= r2)])
    slots = int((count.new_zeros(grid.count.shape[0] * tiles).index_put_(
        (code[filled].reshape(-1),), (count[..., None] - t * kgrid.TILE).clamp(0, kgrid.TILE)
        [filled].reshape(-1)))[reached].sum())
    buckets = torch.unique(nbr)
    distinct = int(grid.count[buckets].clamp(0, cap).to(torch.int64).sum())
    n_bytes = (q.shape[0] * (12 + 4 + 4 * c) + buckets.numel() * (4 + 32 * tiles)
               + slots * (12 + 4 * c))
    return {"distinct_candidates": distinct, "reached_slots": slots,
            "reached_tiles": int(reached.numel()), "members": members,
            **_bound(n_bytes, members * (GRID_PAIR_OPS + c))}


def reduce_library_stats(args, list_route: bool, got) -> dict:
    """For L's sum: `(torch.cdist(q, p) <= r).float() @ values` on
    BIG_OCTAVE_SAMPLE queries sampled from the call's answered ones against
    the points the target grid kept (its filled slots) and their values,
    timed on the sample and scaled by the answered queries over the sample,
    as grid_library_stats does (a Q x P plane of all of them would not fit);
    beside it the share of sampled queries whose count under cdist's
    rounding is L's. None for the max (no single call)."""
    if list_route:
        grid, q, values, r2, op = args
        rows = torch.arange(q.shape[0], device=q.device)
    else:
        grid, qg, q, values, r2, op = args
        rows = qg.cell_idx[qg.cell_ok]
    if op != "sum" or rows.numel() == 0:
        return {"library_ms": None}
    pts = grid.cell_xyz[grid.cell_ok].contiguous()
    vals = values[grid.cell_idx[grid.cell_ok]].contiguous()
    g = torch.Generator(device=q.device).manual_seed(21)
    pick = torch.randperm(rows.numel(), generator=g, device=q.device)
    sample = rows[pick[:BIG_OCTAVE_SAMPLE]].sort().values
    qs, r = q[sample].contiguous(), math.sqrt(r2)
    ms = time_ms(lambda: (torch.cdist(qs, pts) <= r).float() @ vals)
    agree = float(((torch.cdist(qs, pts) <= r).sum(dim=1) == got[0][sample]).double().mean())
    torch.cuda.empty_cache()
    return {"library_sample": int(sample.numel()), "library_sample_ms": ms,
            "library_ms": ms * rows.numel() / sample.numel(),
            "library_count_agreement": agree}


def grid_reduce_stats(label: str, kgrid, seen: dict) -> dict:
    """Kernel L on the inputs of its first calls on a path (REDUCE_CALLS:
    the sweep route's first sum, Harris's response, and first max, the
    suppression, and the list route's first sum, a refinement step), moved
    back to the card: held against the plain versions (the count and the
    max bit for bit, the sum within REDUCE_RTOL; on L's main path also its
    TF32 and bfloat16 controls, required to fail), then timed (CUDA events,
    warm, median), the plain version too, beside the bound on the members
    (grid_bound with the values, grid_list_bound) and, for the sum, the
    library call on a sample (reduce_library_stats); the sweep route's
    counters (select_stats, its members exactly the plain route's). The
    suppression's entry sits under the sweep's as "suppression"."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stats = {}
    for key, call in REDUCE_CALLS:
        if key not in seen:
            continue
        args = [_copied(a, dev) for a in seen[key][0]]
        name, op = key.split()
        list_route = name == "grid_reduce_list"
        grid, q, values = args[0], args[1 if list_route else 2], _reduce_values(args, list_route)
        shape = (f"{call}: Q={q.shape[0]}, C={values.shape[1]} {op}, grid "
                 f"{tuple(grid.cell_idx.shape)} dims {grid.dims} cell {grid.cell_size}")
        if not list_route:
            shape += f", query overflow {int(args[1].overflow)}"
        ref, err, rel = _grid_reduce_compare(f"{label} {key}", kgrid, args, list_route)
        members = int(ref[0].to(torch.int64).sum())
        fn = kgrid.reduce_list if list_route else kgrid.reduce
        if list_route:  # timed as the path calls it, given the target's boxes
            boxes = kgrid.boxes(grid)
            fn = lambda *a, boxes=boxes: kgrid.reduce_list(*a, boxes=boxes)  # noqa: E731
        plain = kgrid.reduce_list_ref if list_route else kgrid.reduce_ref
        entry = {"shape": shape, "max_abs_err": err, "err_of_members_abs": rel,
                 **(grid_list_bound(grid, q, values, members, args[3]) if list_route
                    else grid_bound(name, grid, args[1], q, members, values)),
                 **reduce_library_stats(args, list_route, ref)}
        if not list_route:
            entry.update(select_stats(name, kgrid, args, members))
        if label == MAIN_PATH[name] and op == "sum":
            entry["precision"] = reduce_precision(f"{label} {key}", kgrid, args, list_route)
        entry["ms"] = time_ms(lambda: fn(*args))
        entry["plain_ms"] = time_ms(lambda: plain(*args), reps=3, warmup=1)
        if call == "suppression":
            stats.setdefault(name, {})["suppression"] = entry
        else:
            stats[name] = {**stats.get(name, {}), **entry}
        del args, grid, q, values
        torch.cuda.empty_cache()
    return stats


def reduce_adversarial(g, p, mask, q) -> dict:
    """Inputs on which kernel L must keep the plain versions' count and max
    bits and its sum limit, beyond grid_adversarial's: name -> (p, mask, q,
    cell, cap, dims). A point of every 997 with a NaN coordinate (kept by
    the grid, a member of no query), and the first 3,000 targets at one
    point (a target bucket far over its cap of 64)."""
    n = min(20_000, p.shape[0])
    p, mask, q = p[:n], mask[:n], q[:n]
    nan = p.clone()
    nan[::997, 1] = float("nan")
    full = p.clone()
    full[:3000] = p[0]
    return {"a NaN point": (nan, torch.ones_like(mask), q, 0.5, 128, None),
            "a full target bucket": (full, mask, q, 0.5, 64, None)}


def check_grid_reduce(dev, kgrid, n: int = 1 << 18) -> dict:
    """Kernel L against its plain versions on check_grid's synthetic town
    (n = 262,144 points, 5% masked) queried at its own points at the
    Harris radius (config #2's normal radius, 0.6 m, cap 128): the sweep
    route at C = 1, 6, 9 and 12 channels (every instantiation: the widths
    REDUCE_WIDTHS and the generic one), sum and max, and the list route on
    4,096 and on 1 of those queries; the values drawn from a seed, their
    TF32 and bfloat16 controls failing the sum limit; then both routes on
    grid_adversarial's and reduce_adversarial's inputs (on the sphere,
    parked, masked, unmatched, a NaN point, a full target bucket). Returns
    the synthetic entries (the sweep at C = 6 sum, its suppression at C = 1
    max, the list route at C = 9 sum: Harris's widths), timed beside their
    bounds."""
    from mapmerge_torch.ops.neighbors import _f32

    g = torch.Generator(device=dev).manual_seed(16)
    p = torch.rand((n, 3), generator=g, device=dev) * 64.0
    p[:, 2] = torch.round(p[:, 2] / 3.0) * 3.0 + 0.02 * torch.rand((n,), generator=g, device=dev)
    mask = torch.rand((n,), generator=g, device=dev) > 0.05
    q = p + torch.tensor([0.05, -0.03, 0.02], device=dev)
    q_mask = torch.rand((n,), generator=g, device=dev) > 0.1
    r2 = _f32(NORMAL_R ** 2)
    grid, qg, _, _ = grid_operands(p, mask, p, None, NORMAL_R, GRID_CAP)
    worst = 0.0
    for c in (1, 6, 9, 12):
        values = torch.randn((n, c), generator=g, device=dev)
        for op in ("sum", "max"):
            for args, list_route in (((grid, qg, p, values, r2, op), False),
                                     ((grid, p[:4096].contiguous(), values, r2, op), True),
                                     ((grid, p[:1].contiguous(), values, r2, op), True)):
                name = f"grid_reduce{'_list' if list_route else ''} C={c} {op}"
                worst = max(worst, _grid_reduce_compare(name, kgrid, args, list_route)[2])
    log(f"kernel grid_reduce on the synthetic town: count and max bit for bit, the sum "
        f"within {worst} of the members' sum of |v| (C = 1, 6, 9, 12; both routes)")
    nan_errs = [reduce_nan_control(f"synthetic {name}", kgrid, args, list_route)
                for name, args, list_route in (
                    ("grid_reduce", (grid, qg, p, values, r2, "sum"), False),
                    ("grid_reduce_list", (grid, p[:4096].contiguous(), values, r2, "sum"), True))]
    log(f"_grid_reduce_compare refused a sum with one NaN row on both routes (errors "
        f"{nan_errs})")
    values = torch.randn((n, 6), generator=g, device=dev)
    first = {"grid_reduce sum": ((grid, qg, p, values, r2, "sum"), {}),
             "grid_reduce max": ((grid, qg, p, values[:, :1].contiguous(), r2, "max"), {}),
             "grid_reduce_list sum": ((grid, p[:1024].contiguous(),
                                       torch.randn((n, 9), generator=g, device=dev), r2,
                                       "sum"), {})}
    stats = grid_reduce_stats("synthetic", kgrid, first)
    stats["grid_reduce"]["precision"] = reduce_precision(
        "synthetic grid_reduce sum", kgrid, first["grid_reduce sum"][0], False)
    cases = {name: (ap, am, aq, cell, cap, dims) for name, (ap, am, aq, _, cell, cap, dims)
             in grid_adversarial(g, p, mask, q, q_mask).items()}
    cases.update(reduce_adversarial(g, p, mask, q))
    worst = 0.0
    for name, (ap, am, aq, cell, cap, dims) in cases.items():
        agrid, aqg, _, _ = grid_operands(ap, am, aq, None, cell, cap, dims)
        ar2 = _f32(cell * cell)
        for c, op in ((9, "sum"), (1, "max"), (12, "sum"), (12, "max")):
            values = torch.randn((ap.shape[0], c), generator=g, device=dev)
            worst = max(worst, _grid_reduce_compare(
                f"grid_reduce {name} C={c} {op}", kgrid, (agrid, aqg, aq, values, ar2, op),
                False)[2])
            worst = max(worst, _grid_reduce_compare(
                f"grid_reduce_list {name} C={c} {op}", kgrid,
                (agrid, aq[:4096].contiguous(), values, ar2, op), True)[2])
    log(f"kernels grid_reduce and grid_reduce_list held on {sorted(cases)} (largest sum "
        f"error {worst} of the members' sum of |v|)")
    for key, e in stats.items():
        log(f"kernel {key} {e['shape']}: max err {e['max_abs_err']}; kernel {e['ms']} ms, "
            f"plain {e['plain_ms']} ms, bound {e['bound_ms']} ms ({e['bound_by']}), library "
            f"{e.get('library_ms')} ms")
    return stats


#: SIFT's 26-NN on a grid octave: its radius in octave scales
#: (ops/keypoints/sift._GRID_KNN_RADIUS_SCALES)
GRID_KNN_SCALES = 8.0


def grid_sift_sigmas(cell: float, n_sigma: int = SIFT_SCALES + 3) -> list[float]:
    """An octave's sigmas (sift_sigmas' shape) whose 3 sigma_max is `cell`:
    kernel J's grid cell; another count than an octave's: n sigmas down
    from the same largest evenly to a quarter of it."""
    if n_sigma != SIFT_SCALES + 3:
        top = cell / 3.0
        return [top * (1.0 - 0.75 * s / max(n_sigma - 1, 1)) for s in range(n_sigma)]
    return sift_sigmas(cell / (3.0 * 2.0 ** ((SIFT_SCALES + 2) / SIFT_SCALES)))


def _grid_smooth_compare(name, kgrid, args):
    """Kernel J against smooth_ref on the same inputs: within
    ksift.SCALE_SPACE_RTOL of the field's largest magnitude (exp and the
    sums' order round apart; the members are the same bits, kernel C's
    tolerance), the rows of the queries no answered slot holds exactly 0, a
    second launch the same bits. Returns (max abs err, its share of the
    field)."""
    from mapmerge_torch.kernels import sift as ksift

    got = kgrid.smooth(*args)
    ref = kgrid.smooth_ref(*args)
    again = kgrid.smooth(*args)
    torch.cuda.synchronize()
    qg, q = args[1], args[2]
    require(got.shape == ref.shape == (q.shape[0], len(args[4])), f"{name}: shapes")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    rel = err / max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30)
    require(rel <= ksift.SCALE_SPACE_RTOL,
            f"{name}: off by {err} ({rel} of the field) > {ksift.SCALE_SPACE_RTOL}")
    answered = torch.zeros((q.shape[0],), dtype=torch.bool, device=q.device)
    answered[qg.cell_idx[qg.cell_ok]] = True
    require(bool((got[~answered] == 0).all()),
            f"{name}: a query no answered slot holds is not 0")
    require(torch.equal(got, again), f"{name}: a second launch gave other bits")
    return err, rel


def _grid_knn_compare(name, kgrid, args):
    """Kernel K against knn_ref on the same inputs: idx, d2 and valid bit
    for bit, a second launch the same bits. Returns knn_ref's output."""
    got = kgrid.knn(*args)
    ref = kgrid.knn_ref(*args)
    again = kgrid.knn(*args)
    torch.cuda.synchronize()
    require(all(a.shape == b.shape for a, b in zip(got, ref)), f"{name}: shapes")
    diff = [int((a != b).sum()) for a, b in zip(got, ref)]
    require(diff == [0, 0, 0],
            f"{name}: {diff} entries of idx, d2, valid differ from knn_ref; exact required")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{name}: a second launch gave other bits")
    return ref


def grid_sift_bound(name: str, grid, qg, q, members: int, width: int) -> dict:
    """Kernel J's (width: the sigmas) or K's (width: k) least time on these
    inputs, with grid_bound's bytes: the distinct candidate points read
    once (12 B, J's value 4 B more), both grids' counts, the answered query
    slots (12 B and their 8 B row) and the answered flags of the active
    buckets, the rows written once (J a float a sigma, K 9 B an entry) and
    K's 8 B index of each entry it keeps. The work: J each member's
    GRID_PAIR_OPS and SIFT_SIGMA_OPS a sigma (kernel C's count: a kernel
    that culls need compute no other pair), with `visited_bound_ms` beside
    it (every pair visited at GRID_PAIR_OPS, the members' sigmas as
    before); K every pair visited at GRID_PAIR_OPS (no radius cuts its
    selection, so every candidate is compared)."""
    c = grid_visit_counters(grid, qg)
    h, cap = grid.cell_idx.shape
    if name == "grid_smooth":
        n_bytes = c["distinct_candidates"] * 16 + q.shape[0] * width * 4
        sigma_ops = members * width * SIFT_SIGMA_OPS
        work = members * GRID_PAIR_OPS + sigma_ops
        visited = c["pairs_visited"] * GRID_PAIR_OPS + sigma_ops
    else:
        n_bytes = (c["distinct_candidates"] * 12 + c["answered"] * width * 8
                   + q.shape[0] * width * 9)
        work = visited = c["pairs_visited"] * GRID_PAIR_OPS
    n_bytes += 2 * h * 4 + c["answered"] * 20 + c["active_buckets"] * cap
    return {**c, "members": members, **_bound(n_bytes, work),
            "visited_bound_ms": _bound(n_bytes, visited)["bound_ms"]}


def grid_sift_stats(label: str, kgrid, seen: dict) -> dict:
    """Kernels J and K on the inputs of their first launch at each query
    count on a path (config5_big: octaves 0 and 1), moved back to the card,
    in full: held against their plain versions (J within SCALE_SPACE_RTOL
    with the unanswered rows 0, K bit for bit; both repeating), then timed
    (CUDA events, warm, median), the plain version too, beside the bound
    (grid_sift_bound), their counters (select_stats, J's members exactly
    the plain route's) and, for K, the library call on a sample
    (grid_library_stats). The largest query count gives the kernel's entry,
    the others sit in it by "Q=n". No single PyTorch call smooths over a
    radius: J's library_ms is null."""
    dev = torch.device("cuda", torch.cuda.current_device())
    keys = [k for k in seen if k.split()[0] in ("grid_smooth", "grid_knn")]
    keys.sort(key=lambda k: (k.split()[0], -int(k.split("=")[1])))
    stats: dict = {}
    for key in keys:
        args, _ = seen[key]
        args = [_copied(a, dev) for a in args]
        grid, qg, q = args[:3]
        name = key.split()[0]
        shape = (f"Q={q.shape[0]}, grid {tuple(grid.cell_idx.shape)} dims {grid.dims} "
                 f"cell {grid.cell_size}, query overflow {int(qg.overflow)}")
        if name == "grid_smooth":
            err, rel = _grid_smooth_compare(f"{label} {key}", kgrid, args)
            members = int(kgrid.count_ref(grid, qg, q, args[5]).to(torch.int64).sum())
            entry = {"max_abs_err": err, "err_of_field": rel, "fn": kgrid.smooth,
                     "plain": kgrid.smooth_ref,
                     **grid_sift_bound(name, grid, qg, q, members, len(args[4])),
                     "library_ms": None, **select_stats(name, kgrid, args, members)}
        else:
            ref = _grid_knn_compare(f"{label} {key}", kgrid, args)
            members = int(kgrid.count_ref(grid, qg, q, args[5]).to(torch.int64).sum())
            entry = {"max_abs_err": 0.0, "valid_entries": int(ref[2].sum()),
                     "fn": kgrid.knn, "plain": kgrid.knn_ref,
                     **grid_sift_bound(name, grid, qg, q, members, args[4]),
                     **grid_library_stats(name, args, ref), **select_stats(name, kgrid, args)}
        fn, plain = entry.pop("fn"), entry.pop("plain")
        entry = {"shape": shape, **entry, "ms": time_ms(lambda: fn(*args)),
                 "plain_ms": time_ms(lambda: plain(*args), reps=3, warmup=1)}
        if name in stats:
            stats[name][f"Q={q.shape[0]}"] = entry
        else:
            stats[name] = entry
        del args, grid, qg, q
        torch.cuda.empty_cache()
    return stats


def check_grid_sift(dev, kgrid, n: int = 1 << 18) -> dict:
    """Kernels J and K against their plain versions on a synthetic town of
    n = 262,144 surface points (check_grid's shape, its own seed), queried
    at its own points as SIFT queries a grid octave (the masked ones parked
    at FAR, no query mask), at config5_big's octave-0 scales: J at
    sift_sigmas() (cell 3 sigma_max, cap 128), K at GRID_KNN_SCALES octave
    scales with k = 26; then both on grid_adversarial's inputs (no query
    mask), J at 6, 1 and 64 sigmas whose 3 sigma_max is the case's cell, K
    at the cell with exclude_self both ways."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.ops.neighbors import _f32

    g = torch.Generator(device=dev).manual_seed(17)
    p = torch.rand((n, 3), generator=g, device=dev) * 64.0
    p[:, 2] = torch.round(p[:, 2] / 3.0) * 3.0 + 0.02 * torch.rand((n,), generator=g, device=dev)
    mask = torch.rand((n,), generator=g, device=dev) > 0.05
    p = torch.where(mask[:, None], p, FAR)
    vals = torch.rand((n,), generator=g, device=dev) * 255.0
    sigmas = sift_sigmas()
    r_bound = 3.0 * max(sigmas)
    r_knn = GRID_KNN_SCALES * SIFT_BASE
    first = {
        f"grid_smooth Q={n}": (grid_operands(p, mask, p, None, r_bound, GRID_CAP)[:3]
                               + (vals, sigmas, _f32(r_bound * r_bound)), {}),
        f"grid_knn Q={n}": (grid_operands(p, mask, p, None, r_knn, GRID_CAP)
                            + (SIFT_K, _f32(r_knn * r_knn), False), {}),
    }
    stats = grid_sift_stats("synthetic", kgrid, first)
    adversarial = grid_adversarial(g, p, mask, p, torch.ones_like(mask))
    for name, (ap, am, aq, _, cell, cap, dims) in adversarial.items():
        grid, qg, tq, n_p = grid_operands(ap, am, aq, None, cell, cap, dims)
        r2 = _f32(cell * cell)
        for n_sigma in (6, 1, 64):  # J's sigma groups: one, one, eight
            _grid_smooth_compare(f"grid_smooth {name} S={n_sigma}", kgrid,
                                 (grid, qg, tq, vals[: ap.shape[0]],
                                  grid_sift_sigmas(cell, n_sigma), r2))
        for exclude_self in (False, True):
            _grid_knn_compare(f"grid_knn {name} exclude_self={exclude_self}", kgrid,
                              (grid, qg, tq, n_p, SIFT_K, r2, exclude_self))
        _grid_pack_compare(f"grid_pack {name}", kgrid, (grid, qg, tq))
    for key, e in stats.items():
        log(f"kernel {key} {e['shape']}: max err {e['max_abs_err']}, "
            f"{e['members']} members of {e['pairs_visited']} pairs visited; kernel "
            f"{e['ms']} ms, plain {e['plain_ms']} ms, bound {e['bound_ms']} ms "
            f"({e['bound_by']}), library {e['library_ms']} ms")
    log(f"kernels grid_smooth, grid_knn and grid_pack held on {sorted(adversarial)} "
        "(grid_smooth at 6, 1 and 64 sigmas, grid_knn with exclude_self both ways)")
    return stats


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
    their modules at call time, so they see the recording ones. Also
    records the merge's pair stage (`seen["pairs"]`): its host seconds
    between two synchronisations, the batched chunks and their pairs, and
    the pairs registered one at a time through merging.register_pair. The
    native call counts are set to 0 on entry and read on exit
    (`seen["native"]`), and every tree solve
    (merging.compute_global_transforms) is kept with its estimates,
    threshold and result (`seen["graph"]`, for hold_graph). The grid
    kernels' first calls are kept in host memory: G's first call from ICP
    and its first from the transform score apart ("grid_nn icp", "grid_nn
    score"), H's and I's, and J's and K's first at each query count
    ("grid_smooth Q=n", "grid_knn Q=n": an octave each), and L's first
    sweep of each op and first list call ("grid_reduce sum", "grid_reduce
    max", "grid_reduce_list sum"). The target grids
    whose boxes a caller made apart for G (kgrid.boxes) are counted
    (`seen["grid_boxes"]`). SIFT's extractions and the octaves among them
    that resolve to the dense engine and to the grid are counted
    (`seen["sift"]`), and the first extraction's
    arguments kept
    (`seen["sift_detect"]`, for hold_sift_keypoints); so are Harris's
    extractions by the engine they resolve to (`seen["harris"]`) and the
    first one's arguments (`seen["harris_detect"]`, for
    hold_harris_keypoints). The dense radius
    passes are counted (`seen["radius"]`): the outlier and normal stages
    (one each an extraction; the pipeline's and the debugger's calls) and
    SC3D's density count whose cloud resolves to the dense engine, and
    those that resolve to the grid apart (`seen["grid_radius"]`); the calls
    of E and F by the route their size takes (`seen["radius_routes"]`), and
    the points of the first streamed one (`seen["radius_order"]`, the
    order pre-pass's arguments)."""
    import inspect
    import threading

    from mapmerge_torch import native
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.kernels import tiles as ktiles
    from mapmerge_torch.ops import icp as icp_ops
    from mapmerge_torch.ops import keypoints as keypoint_ops
    from mapmerge_torch.ops import normals as normals_ops
    from mapmerge_torch.ops import outliers as outliers_ops
    from mapmerge_torch.ops import score as score_ops
    from mapmerge_torch.ops.descriptors import sc3d
    from mapmerge_torch.ops.keypoints import sift as sift_ops
    from mapmerge_torch.ops.neighbors import _resolve_engine
    from mapmerge_torch.parallel import pair_shard
    from mapmerge_torch.pipeline import features, merging

    seen: dict = {"pairs": {"stage_s": 0.0, "chunks": 0, "batched_pairs": 0,
                            "one_pair_calls": 0}, "graph": [],
                  "sift": {"extractions": 0, "dense_octaves": 0, "grid_octaves": 0},
                  "radius": {"outliers": 0, "normals": 0, "SC3D density": 0},
                  "grid_radius": {"outliers": 0, "normals": 0, "SC3D density": 0},
                  "radius_routes": {"resident": 0, "streamed": 0},
                  "grid_boxes": 0, "harris": {"dense": 0, "grid": 0}}
    lock = threading.Lock()
    caller = threading.local()  # which stage a grid 1-NN serves, per thread

    def add(key, value):
        with lock:
            seen["pairs"][key] += value

    def sync():  # rank_job also runs on the CPU
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def stage(fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            add("stage_s", time.perf_counter() - t0)
            return out

        return wrapper

    def chunk(fn):
        def wrapper(sources, targets, params, seed, pairs):
            add("chunks", 1)
            add("batched_pairs", len(pairs))
            return fn(sources, targets, params, seed, pairs)

        return wrapper

    def one_pair(fn):
        def wrapper(*args, **kwargs):
            add("one_pair_calls", 1)
            return fn(*args, **kwargs)

        return wrapper

    def solve(fn):
        def wrapper(estimates, threshold):
            out = fn(estimates, threshold)
            with lock:
                seen["graph"].append((list(estimates), threshold, out))
            return out

        return wrapper

    def extraction(fn):
        def wrapper(*args, **kwargs):
            with lock:
                seen["sift"]["extractions"] += 1
                if "sift_detect" not in seen:
                    seen["sift_detect"] = ([_copied(a) for a in args], dict(kwargs))
            return fn(*args, **kwargs)

        return wrapper

    def octave(fn):
        def wrapper(cloud, *args, **kwargs):
            engine = args[3] if len(args) > 3 else kwargs.get("engine", "auto")
            with lock:
                seen["sift"][f"{_resolve_engine(engine, cloud.capacity)}_octaves"] += 1
            return fn(cloud, *args, **kwargs)

        return wrapper

    def dense_pass(key, size):
        """Count a call under the engine its operand (`size` of its bound
        arguments: the capacity) resolves to: "radius" if the dense one,
        "grid_radius" if the grid."""
        def make(fn):
            signature = inspect.signature(fn)

            def wrapper(*args, **kwargs):
                bound = signature.bind(*args, **kwargs).arguments
                engine = _resolve_engine(bound.get("engine", "auto"), size(bound))
                with lock:
                    seen["radius" if engine == "dense" else "grid_radius"][key] += 1
                return fn(*args, **kwargs)

            return wrapper

        return make

    def capacity(bound):
        return bound["cloud"].capacity

    def counted(key):
        def make(fn):
            def wrapper(*args, **kwargs):
                with lock:
                    seen[key] += 1
                return fn(*args, **kwargs)

            return wrapper

        return make

    def record(name, dev=None):
        def make(fn):
            def wrapper(*args, **kwargs):
                key = name(*args) if callable(name) else name
                if key not in seen:
                    seen[key] = ([_copied(a, dev) for a in args], dict(kwargs))
                return fn(*args, **kwargs)

            return wrapper

        return make

    def radius_call(name):
        """Record kernel E's or F's first call, count each call's route, and
        record the first streamed call's points for the order pre-pass."""
        def make(fn):
            recorded = record(name)(fn)

            def wrapper(qc, pc, mask, r2, *args, **kwargs):
                route = kradius.route(pc.shape[0])
                with lock:
                    seen["radius_routes"][route] += 1
                    if route == "streamed" and "radius_order" not in seen:
                        seen["radius_order"] = ([_copied(a) for a in (pc, mask, r2)], {})
                return recorded(qc, pc, mask, r2, *args, **kwargs)

            return wrapper

        return make

    def harris(fn):
        """Count Harris's extractions by the engine its radius_reduce calls
        resolve to (the cloud's capacity), and keep the first one's
        arguments."""
        signature = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            bound = signature.bind(*args, **kwargs).arguments
            engine = _resolve_engine(bound.get("engine", "auto"), bound["cloud"].capacity)
            with lock:
                seen["harris"][engine] += 1
                if "harris_detect" not in seen:
                    seen["harris_detect"] = ([_copied(a) for a in args], dict(kwargs))
            return fn(*args, **kwargs)

        return wrapper

    def serving(stage):
        """Mark the grid 1-NN calls made inside fn as `stage`'s."""
        def make(fn):
            def wrapper(*args, **kwargs):
                before = getattr(caller, "stage", None)
                caller.stage = stage
                try:
                    return fn(*args, **kwargs)
                finally:
                    caller.stage = before

            return wrapper

        return make

    cpu = torch.device("cpu")

    with patched({(nn, "nearest_neighbor"): record("nearest_neighbor"),
                  (nn, "nearest_neighbor_batched"): record("nearest_neighbor_batched"),
                  (pair_shard, "estimate_pairs_sharded"): stage,
                  (merging, "register_chunk"): chunk,
                  (merging, "register_pair"): one_pair,
                  (merging, "compute_global_transforms"): solve,
                  (spfh, "spfh_tile"): record("spfh"),
                  (ktiles, "pack"): record("tiles_pack"),
                  (ksift, "scale_space"): record("sift_scale_space"),
                  (ksift, "knn"): record("sift_knn"),
                  (kradius, "count"): radius_call("radius_count"),
                  (kradius, "moments"): radius_call("radius_moments"),
                  (features, "remove_outliers"): dense_pass("outliers", capacity),
                  (outliers_ops, "remove_outliers"): dense_pass("outliers", capacity),
                  (features, "compute_surface_normals"): dense_pass("normals", capacity),
                  (normals_ops, "compute_surface_normals"): dense_pass("normals", capacity),
                  (sc3d, "radius_count"): dense_pass(
                      "SC3D density", lambda bound: bound["p"].shape[0]),
                  (sift_ops, "detect_keypoints_sift"): extraction,
                  (sift_ops, "_scale_space"): octave,
                  # a grid sweep's arguments are ~200 MB at config #2's size
                  # (kernel G's two grids 1.4 GB): kept in host memory, out of
                  # the run's peak device memory
                  (spfh, "spfh_grid"): record("spfh_grid", cpu),
                  (icp_ops, "grid_nn_query"): serving("icp"),
                  (score_ops, "nearest_neighbor"): serving("score"),
                  (kgrid, "nn_query"): record(
                      lambda *a: f"grid_nn {getattr(caller, 'stage', None)}", cpu),
                  (kgrid, "boxes"): counted("grid_boxes"),
                  (kgrid, "moments"): record("grid_moments", cpu),
                  (kgrid, "count"): record("grid_count", cpu),
                  # J and K: the first call at each query count (an octave)
                  (kgrid, "smooth"): record(
                      lambda *a: f"grid_smooth Q={a[2].shape[0]}", cpu),
                  (kgrid, "knn"): record(lambda *a: f"grid_knn Q={a[2].shape[0]}", cpu),
                  # L: the first sweep of each op, and the first list call
                  (kgrid, "reduce"): record(lambda *a: f"grid_reduce {a[5]}", cpu),
                  (kgrid, "reduce_list"): record(lambda *a: f"grid_reduce_list {a[4]}", cpu),
                  (keypoint_ops, "detect_keypoints_harris"): harris}):
        counters = (native.GRAPH_SOLVE, native.LZF_DECOMPRESS)
        for c in counters:
            c.launches = 0
        yield seen
        seen["native"] = {c.name: c.launches for c in counters}


#: per path, per kernel: shape, max error, times and bound on the path's
#: own first-launch inputs (hold_on_path_inputs)
PATH_STATS: dict[str, dict] = {}
#: per path: the route its pairs took (require_route) and its pair stage
ROUTES: dict[str, dict] = {}

#: the 1-NN kernel each pair route launches, the others never: the dense
#: batch (no fallback to one pair at a time), pairs one at a time on the
#: dense engine, or the grid 1-NN (kernel G, neither dense entry)
ROUTE_NN = {"batched": "nearest_neighbor_batched", "one pair": "nearest_neighbor",
            "grid": "grid_nn"}


def require_route(label: str, launches: dict, route: str, pairs: dict | None = None):
    """The path's pairs took `route`: its 1-NN kernel launched and the
    others not (ROUTE_NN); with the pair-stage record of first_launch_inputs,
    chunks on the batched route and none on the others. Logged, and kept in
    ROUTES."""
    for entry in ROUTE_NN.values():
        require((launches.get(entry, 0) > 0) == (entry == ROUTE_NN[route]),
                f"{label}: launches {launches} on the {route} route")
    if pairs is not None:
        require((pairs["chunks"] > 0) == (route == "batched"),
                f"{label}: pair stage {pairs} on the {route} route")
    ROUTES[label] = {"route": route, **(pairs or {})}
    log(f"{label}: pairs took the {route} route; pair stage {json.dumps(pairs)}")


def nn_library(q, p, mask=None):
    """Kernel A's function by one PyTorch route, batched where q and p are:
    torch.cdist, the masked targets set to inf in place, and a min over the
    targets. It rounds otherwise than the kernel (cdist expands the
    distance through a matmul), so it is timed as a yardstick only."""
    d = torch.cdist(q, p)
    if mask is not None:
        d.masked_fill_(~mask.unsqueeze(-2), math.inf)
    return d.min(-1)


def nn_library_stats(nn_fn, args) -> dict:
    """nn_library on a kernel entry's inputs `args`: its time (time_ms, as
    the kernel's) and the share of queries whose index equals the kernel's
    (`nn_fn`), over all queries and over those not parked at FAR (padding,
    or padding moved by ICP's pose: a coordinate of 1e8 leaves cdist's
    matmul expansion no bits for the distance). Its (..., Q, P) distances
    are released afterwards."""
    from mapmerge_torch.core.cloud import FAR

    ms = time_ms(lambda: nn_library(*args))
    agree = nn_library(*args).indices == nn_fn(*args)[0].long()
    real = args[0].abs().amax(-1) < FAR / 2
    stats = {"library_ms": ms, "library_index_agreement": float(agree.double().mean()),
             "library_index_agreement_unparked": float(agree[real].double().mean())
             if bool(real.any()) else None}
    torch.cuda.empty_cache()
    return stats


def require_sift(label: str, seen: dict, launches: dict, per_extraction: int) -> None:
    """Kernels C and D launched once a dense SIFT octave each, and
    `per_extraction` times an extraction (3 where every octave is dense, 1
    on config5_big, whose octaves 0-1 take the grid); none on a Harris
    path. Logged."""
    ext, dense = seen["sift"]["extractions"], seen["sift"]["dense_octaves"]
    c, d = launches["sift_scale_space"], launches["sift_knn"]
    log(f"{label}: SIFT extractions {ext}, dense octaves {dense}; launches "
        f"sift_scale_space {c}, sift_knn {d}")
    require(c == d == dense == per_extraction * ext,
            f"{label}: sift_scale_space {c} and sift_knn {d} launches for {ext} "
            f"extractions and {dense} dense octaves, expected {per_extraction} an "
            "extraction")


def require_pack(label: str, seen: dict, launches: dict) -> None:
    """The tile pre-pass launched exactly once a dense SIFT octave (one
    buffer for C and D), and for nothing else: E and F take their own.
    Logged."""
    dense = seen["sift"]["dense_octaves"]
    packs = launches["tiles_pack"]
    log(f"{label}: launches tiles_pack {packs} ({dense} dense SIFT octaves)")
    require(packs == dense,
            f"{label}: tiles_pack {packs} launches, expected {dense} dense SIFT octaves")


def require_radius(label: str, seen: dict, launches: dict) -> None:
    """Kernel E launched once a dense outlier pass and once a dense SC3D
    density count, kernel F once a dense normal pass, and the outlier and
    normal passes alike (one each a dense extraction): so both once a dense
    extraction, E once more on SC3D, neither on the grid paths; their order
    pre-pass once a call that took the streamed route, never on the
    resident one. Logged."""
    passes, routes = seen["radius"], seen["radius_routes"]
    e, f = launches["radius_count"], launches["radius_moments"]
    order = launches["radius_order"]
    log(f"{label}: dense radius passes {passes}; launches radius_count {e}, "
        f"radius_moments {f}, radius_order {order}; routes {routes}")
    require(passes["outliers"] == passes["normals"]
            and e == passes["outliers"] + passes["SC3D density"] and f == passes["normals"],
            f"{label}: radius_count {e} and radius_moments {f} launches for the dense "
            f"passes {passes}")
    require(routes["resident"] + routes["streamed"] == e + f and order == routes["streamed"],
            f"{label}: radius_order {order} launches for the routes {routes} of "
            f"{e + f} calls of E and F")


def require_grid_radius(label: str, seen: dict, launches: dict) -> None:
    """Kernel I launched once a grid outlier pass and once a grid SC3D
    density count, kernel H once a grid normal pass, and the outlier and
    normal passes alike (one each an extraction on the grid): none on the
    dense paths. Logged."""
    passes = seen["grid_radius"]
    i, h = launches["grid_count"], launches["grid_moments"]
    log(f"{label}: grid radius passes {passes}; launches grid_count {i}, "
        f"grid_moments {h}")
    require(passes["outliers"] == passes["normals"]
            and i == passes["outliers"] + passes["SC3D density"] and h == passes["normals"],
            f"{label}: grid_count {i} and grid_moments {h} launches for the grid "
            f"passes {passes}")


def require_grid_sift(label: str, seen: dict, launches: dict) -> None:
    """Kernels J and K launched once each a SIFT octave that resolves to the
    grid (octaves 0 and 1 of each config5_big map), none on any other path.
    Logged."""
    octaves = seen["sift"]["grid_octaves"]
    j, k = launches["grid_smooth"], launches["grid_knn"]
    log(f"{label}: SIFT grid octaves {octaves}; launches grid_smooth {j}, grid_knn {k}")
    require(j == k == octaves,
            f"{label}: grid_smooth {j} and grid_knn {k} launches for {octaves} grid octaves")


def require_grid_reduce(label: str, seen: dict, launches: dict) -> None:
    """Kernel L launched on its sweep route twice a Harris extraction on the
    grid (the response and the suppression) and on its list route three
    times (the refinement steps), none on any other path. Logged."""
    n = seen["harris"]["grid"]
    sweeps, lists = launches["grid_reduce"], launches["grid_reduce_list"]
    log(f"{label}: Harris extractions {seen['harris']}; launches grid_reduce {sweeps}, "
        f"grid_reduce_list {lists}")
    require(sweeps == 2 * n and lists == 3 * n,
            f"{label}: grid_reduce {sweeps} and grid_reduce_list {lists} launches for {n} "
            "Harris extractions on the grid, expected 2 and 3 each")


def require_grid_pack(label: str, seen: dict, launches: dict) -> None:
    """The pre-pass of kernels G-L launched once with each of them (L's
    sweep route; its list route is given its boxes) and once for each
    target grid whose boxes a caller had made apart (kgrid.boxes: ICP's,
    one a grid Harris extraction), no more of those than G's launches and
    the grid Harris extractions, and never else. Logged."""
    packs = launches["grid_pack"]
    with_kernels = {k: launches[k] for k in ("grid_nn", "grid_moments", "grid_count",
                                             "grid_smooth", "grid_knn", "grid_reduce")}
    made = seen["grid_boxes"]
    log(f"{label}: launches grid_pack {packs} ({with_kernels}, the boxes alone {made})")
    require(packs == sum(with_kernels.values()) + made
            and made <= launches["grid_nn"] + seen["harris"]["grid"],
            f"{label}: grid_pack {packs} launches for {with_kernels} + the boxes alone "
            f"{made}")


def hold_on_path_inputs(label: str, seen: dict, nn, spfh, launches: dict,
                        exact: bool = False, sift_per_extraction: int = 3) -> None:
    """Each kernel a path launched against its plain version on the inputs
    of its first launch there, with check_nn's, check_spfh's and
    check_sift's tolerances (with `exact`: no difference at all for A and
    B; C is held within its tolerance and D exactly on every path), then
    timed on them (CUDA events, warm, median), and the plain version too;
    kernel A's entries beside nn_library's time as well (nn_library_stats),
    D beside knn_library's, E beside count_library's; E exactly and F within
    its tolerance on every path (radius_stats); G and I bit for bit and H
    within its tolerance on every grid path (grid_stats); J within its
    tolerance and K bit for bit on every SIFT grid octave's first launch at
    its query count, in full (grid_sift_stats); L's count and max bit for
    bit and its sum within its tolerance on the first response, suppression
    and refinement step of a grid Harris path (grid_reduce_stats). SIFT's,
    the radius sweeps', the grid sweeps', L's and the pre-pass's launches
    are required first (require_sift, require_radius, require_grid_radius,
    require_grid_sift, require_grid_reduce, require_pack,
    require_grid_pack).
    These launches come after the path's counts were read."""
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.kernels import tiles as ktiles

    require_sift(label, seen, launches, sift_per_extraction)
    require_radius(label, seen, launches)
    require_grid_radius(label, seen, launches)
    require_grid_sift(label, seen, launches)
    require_grid_reduce(label, seen, launches)
    require_pack(label, seen, launches)
    require_grid_pack(label, seen, launches)
    stats = PATH_STATS[label] = {}
    if "nearest_neighbor" in seen:
        args, _ = seen["nearest_neighbor"]
        err, ties = _nn_compare(f"{label} nn", nn, *args)
        require(not exact or (err == 0.0 and ties == 0),
                f"{label} nn: max err {err}, {ties} indices differ; exact required")
        stats["nearest_neighbor"] = {
            "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]}",
            "launches": launches["nearest_neighbor"], "max_abs_err": err,
            "tie_mismatches": ties,
            "ms": time_ms(lambda: nn.nearest_neighbor(*args)),
            "plain_ms": time_ms(lambda: nn.nearest_neighbor_ref(*args), reps=5),
            **nn_library_stats(nn.nearest_neighbor, args),
            **nn_bound(args[0], args[1]),
        }
    if "nearest_neighbor_batched" in seen:
        args, _ = seen["nearest_neighbor_batched"]
        err, diff = _nn_batched_compare(f"{label} nn batched", nn, *args)
        stats["nearest_neighbor_batched"] = {
            "shape": f"B={args[0].shape[0]} Q={args[0].shape[1]} P={args[1].shape[1]}",
            "launches": launches["nearest_neighbor_batched"], "max_abs_err": err,
            "indices_differing": diff,
            "ms": time_ms(lambda: nn.nearest_neighbor_batched(*args)),
            "plain_ms": time_ms(lambda: nn.nearest_neighbor_batched_ref(*args), reps=5),
            **nn_library_stats(nn.nearest_neighbor_batched, args),
            **nn_batched_bound(args[0], args[1]),
        }
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
        stats["spfh"] = {
            "shape": f"{b}x{cq} x {bc}x{m}",
            "mode": "shared (Bc = 1)",
            "launches": launches["spfh"],
            "max_abs_err": err, "rows_off": n_bad,
            "pairs_per_query": float(ref[1].mean()),
            "pairs_per_counted_query": float(counted.mean()) if counted.numel() else 0.0,
            "ms": time_ms(lambda: spfh.spfh_tile(*args, **kwargs)),
            "plain_ms": time_ms(lambda: spfh.spfh_ref(*args, **kwargs), reps=3, warmup=1),
            **spfh_bound(args, int(ref[1].sum())),
        }
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
        stats["spfh"] = {
            "shape": f"grid {tuple(grid.cell_idx.shape)}, {normals.shape[0]} points",
            "mode": "grid (spfh_grid, one launch a cloud)",
            "launches": launches["spfh"],
            "max_abs_err": err, "rows_off": n_bad,
            **grid_sweep_counters(grid, q_ok, ref[1]),
            "ms": time_ms(lambda: spfh.spfh_grid(*args, **kwargs)),
            "plain_ms": time_ms(lambda: spfh.spfh_grid_ref(*args, **kwargs),
                                reps=3, warmup=1),
            **spfh_grid_bound(grid, q_ok, normals, ref[1]),
        }
    for name, entry in {**pack_stats(label, ktiles, seen), **sift_stats(label, ksift, seen),
                        **radius_stats(label, kradius, seen),
                        **grid_stats(label, kgrid, seen),
                        **grid_sift_stats(label, kgrid, seen),
                        **grid_reduce_stats(label, kgrid, seen),
                        **grid_pack_stats(label, kgrid, seen)}.items():
        stats[name] = {"launches": launches[name], **entry}
    require(stats, f"{label}: no kernel input was recorded")
    log(f"{label}: kernels on the path's own inputs: {json.dumps(stats)}")


#: the native tree solve against its plain version: the same maps
#: registered and transforms within tests/test_torch_graph.py's tolerance
#: (the plain chain rounds to float32 at every step, the native one in double)
GRAPH_TOL = 1e-5
#: per path: its native tree solves held against the plain version (hold_graph)
GRAPH_STATS: dict[str, dict] = {}
#: per payload: the native LZF decoder held against the plain one (hold_lzf)
LZF_STATS: dict[str, dict] = {}


def host_ms(fn, reps: int = 20) -> float:
    """Median host ms of `fn` (host code: no device work) over `reps` runs
    after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def hold_graph(label: str, seen: dict, solves: bool = True) -> None:
    """The path's tree solves, as first_launch_inputs recorded them. With
    `solves`: native.merge_graph_solve ran once a solve during the path, and
    each solve's result is held against compute_global_transforms_plain on
    the same estimates (the same maps registered, max abs difference within
    GRAPH_TOL); both are timed on the largest (host clock, median of 20).
    Without (the incremental node and config #3 solve no tree, as in the
    JAX package): no solve ran. Kept in GRAPH_STATS and logged."""
    from mapmerge_torch.graph import merge_graph

    calls, solved = seen["native"]["merge_graph_solve"], seen["graph"]
    if not solves:
        require(calls == 0 and not solved,
                f"{label}: {calls} native tree solves on a path that solves none")
        GRAPH_STATS[label] = {"calls": 0}
        log(f"{label}: no tree solve on this path (native merge_graph_solve calls 0)")
        return
    require(calls > 0 and calls == len(solved),
            f"{label}: {calls} native merge_graph_solve calls for {len(solved)} tree solves")
    worst = 0.0
    for est, threshold, out in solved:
        plain = merge_graph.compute_global_transforms_plain(est, threshold)
        require(len(plain) == len(out) and [bool(t.any()) for t in plain]
                == [bool(t.any()) for t in out],
                f"{label}: the plain tree solve registers other maps than the native one")
        worst = max([worst] + [float(np.abs(a - b).max()) for a, b in zip(out, plain)])
    require(worst <= GRAPH_TOL,
            f"{label}: native and plain tree solves differ by {worst} > {GRAPH_TOL}")
    est, threshold, out = max(solved, key=lambda x: len(x[0]))
    stats = GRAPH_STATS[label] = {
        "calls": calls, "maps": len(out), "edges": len(est),
        "registered": sum(bool(t.any()) for t in out), "max_abs_diff": worst,
        "native_ms": host_ms(lambda: merge_graph.compute_global_transforms(est, threshold)),
        "plain_ms": host_ms(
            lambda: merge_graph.compute_global_transforms_plain(est, threshold)),
    }
    log(f"{label}: tree solves native against plain (the largest timed): "
        f"{json.dumps(stats)}")


def hold_lzf(label: str, payload: bytes, raw: bytes) -> None:
    """native.lzf_decompress against the plain decoder on one payload: both
    give `raw`, byte for byte; both timed (host clock, median of 20 and of
    3). Kept in LZF_STATS and logged."""
    from mapmerge_torch import native
    from mapmerge_torch.io.pcd import _lzf_decompress

    got, plain = native.lzf_decompress(payload, len(raw)), _lzf_decompress(payload, len(raw))
    require(got == raw and plain == raw,
            f"{label}: the decoders' bytes differ (native {got == raw}, plain {plain == raw})")
    stats = LZF_STATS[label] = {
        "points": len(raw) // 16, "raw_bytes": len(raw), "compressed_bytes": len(payload),
        "native_ms": host_ms(lambda: native.lzf_decompress(payload, len(raw))),
        "plain_ms": host_ms(lambda: _lzf_decompress(payload, len(raw)), reps=3),
    }
    log(f"{label}: LZF decoders byte for byte: {json.dumps(stats)}")


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


def check_transforms(label: str, out, dev) -> None:
    """The transform helpers on the card, on a merge's transforms: is_zero of
    the stacked transforms equals `not t.any()` for each map; rigid_inverse
    of the registered ones is within 1e-5 of numpy.linalg.inv in float64 on
    the host, and compose(t, rigid_inverse(t)) within 1e-6 of the identity."""
    from mapmerge_torch.core import transforms as tf

    stacked = torch.stack([torch.from_numpy(np.asarray(t, np.float32)) for t in out]).to(dev)
    zero = tf.is_zero(stacked)
    flags = zero.tolist()
    require(flags == [not t.any() for t in out],
            f"{label}: is_zero gave {flags} on the card")
    registered = stacked[~zero]
    require(registered.shape[0] > 0, f"{label}: no map registered")
    inv = tf.rigid_inverse(registered)
    host = np.stack([np.linalg.inv(np.asarray(t, np.float64))
                     for t, z in zip(out, flags) if not z])
    inv_err = float(np.abs(inv.cpu().double().numpy() - host).max())
    eye_err = float((tf.compose(registered, inv) - torch.eye(4, device=dev)).abs().max())
    log(f"{label}: transforms on the card: is_zero {flags} (= not t.any()); "
        f"rigid_inverse max err {inv_err} against float64 numpy.linalg.inv; "
        f"compose(t, rigid_inverse(t)) max err {eye_err} from the identity")
    require(inv_err <= 1e-5, f"{label}: rigid_inverse off by {inv_err} > 1e-5")
    require(eye_err <= 1e-6, f"{label}: compose(t, rigid_inverse(t)) off by {eye_err} > 1e-6")


def run_main_path(dev, kernels) -> None:
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
    require(launches["spfh"] > 0, "kernel spfh was not launched by the main path")
    require_route("config #1", launches, "batched", seen["pairs"])
    hold_on_path_inputs("config #1", seen, nn, spfh, launches)
    hold_graph("config #1", seen)
    hold_sift_keypoints("config #1", seen)

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
    check_transforms("config #1", out, dev)

    walls = warm_runs(clouds, params, out, "config #1")
    log(f"estimate_maps_transforms wall s (5 warm reps): median "
        f"{statistics.median(walls)}, min {min(walls)}, max {max(walls)}")
    sift_split("config #1", clouds, params, out)
    log("config #1 SIFT octaves after the first, kernels C and D: "
        + json.dumps(sift_octave_stats(clouds, params)))
    profile_merge("config #1", clouds, params, out, config1_stages())

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


#: the share of the plain route's keypoints the kernels' route must find at
#: the same point with a response within 1e-3 relative (a DoG extremum at a
#: near-tie may flip where C's field rounds otherwise)
KEYPOINT_AGREEMENT = 0.99


def plain_sift():
    """Patches that send SIFT's dense octave through the plain versions of
    kernels C and D (the parent's route on the card), for `patched`: no
    pre-pass for SIFT's octaves, whose buffer the plain versions do not
    read (kernels E and F keep theirs)."""
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.kernels import tiles as ktiles
    from mapmerge_torch.ops.keypoints import sift as sift_ops

    def plain(ref):
        return lambda fn: lambda *args, packed=None, **kwargs: ref(*args, **kwargs)

    def unpacked(fn):
        def wrapper(*args, **kwargs):
            with patched({(ktiles, "pack"): lambda _: lambda *a: None}):
                return fn(*args, **kwargs)

        return wrapper

    return {(sift_ops, "_dense_octave"): unpacked,
            (ksift, "scale_space"): plain(ksift.scale_space_ref),
            (ksift, "knn"): plain(ksift.knn_ref)}


def plain_grid_sift():
    """Patches that send SIFT's grid octaves through the plain versions of
    kernels J and K (the parent's route on the card), for `patched`."""
    from mapmerge_torch.kernels import grid as kgrid

    return {(kgrid, "smooth"): lambda fn: kgrid.smooth_ref,
            (kgrid, "knn"): lambda fn: kgrid.knn_ref}


def hold_sift_keypoints(label: str, seen: dict, plain_route=None) -> None:
    """The path's first SIFT extraction again on the same cloud, through
    the kernels and through the plain versions that `plain_route` patches
    in (plain_sift(): C and D, where None; plain_grid_sift(): J and K): at
    least KEYPOINT_AGREEMENT of the plain route's keypoints found at the
    same point (1e-6 m) with a response within 1e-3 relative; the keypoints
    that differ are counted and logged. These launches come after the
    path's counts were read."""
    from mapmerge_torch.ops.keypoints import sift as sift_ops

    args, kwargs = seen["sift_detect"]
    got = sift_ops.detect_keypoints_sift(*args, **kwargs)
    with patched(plain_route or plain_sift()):
        plain = sift_ops.detect_keypoints_sift(*args, **kwargs)
    pm, km = plain.mask, got.mask
    pxyz, kxyz = plain.xyz[pm], got.xyz[km]
    pr, kr = plain.response[pm], got.response[km]
    same = ((pxyz[:, None] - kxyz[None]).abs().amax(-1) < 1e-6) & (
        (pr[:, None] - kr[None]).abs() <= 1e-3 * pr[:, None])
    found = same.any(dim=1)
    n_plain, n_found = int(pm.sum()), int(found.sum())
    share = n_found / max(n_plain, 1)
    log(f"{label}: SIFT keypoints of the first cloud, kernels against plain "
        f"versions: {int(km.sum())} and {n_plain} keypoints, {n_found} of the plain "
        f"route's found ({share}), {n_plain - n_found} differ")
    require(n_plain > 0 and share >= KEYPOINT_AGREEMENT,
            f"{label}: {share} of the plain route's keypoints found, gate {KEYPOINT_AGREEMENT}")


def plain_grid_reduce():
    """Patches that send the grid's radius_reduce through the plain
    versions of kernel L's two routes (the parent's route on the card), for
    `patched`."""
    from mapmerge_torch.kernels import grid as kgrid

    def plain_list(fn):
        def wrapper(grid, q, values, r2, op, boxes=None):
            return kgrid.reduce_list_ref(grid, q, values, r2, op)

        return wrapper

    return {(kgrid, "reduce"): lambda fn: kgrid.reduce_ref, (kgrid, "reduce_list"): plain_list}


def _harris_traced(args, kwargs, routes: dict):
    """One Harris extraction on the grid (`detect_keypoints_harris` on
    `args`, under the patches `routes`) with its kernel L calls
    (grid_reduce_query) and refinement steps recorded. Returns (the
    keypoints, the suppression's (response, neighbourhood max, the valid
    mask), a step's (keypoints in, keypoints out, the step's sums as 9 + 3
    channels: the mirrored sum(n n^T), then sum(n n^T p), its member counts)
    each)."""
    import inspect

    from mapmerge_torch.ops.keypoints import harris as harris_ops

    calls, steps = [], []

    def reduce(fn):
        def wrapper(grid, q, values, reduce="sum", **k):
            out = fn(grid, q, values, reduce, **k)
            calls.append((values, reduce, out))
            return out

        return wrapper

    def refine(fn):
        def wrapper(kp, *a, **k):
            out = fn(kp, *a, **k)
            count, sums = calls[-1][2][:2]
            full = torch.cat([harris_ops._mirror(sums[:, :6]).reshape(-1, 9), sums[:, 6:]], 1)
            steps.append((kp, out, full, count))
            return out

        return wrapper

    with patched({**routes, (harris_ops, "grid_reduce_query"): reduce,
                  (harris_ops, "_refine_step"): refine}):
        kps = harris_ops.detect_keypoints_harris(*args, **kwargs)
    bound = inspect.signature(harris_ops.detect_keypoints_harris).bind(*args, **kwargs)
    ok = bound.arguments["cloud"].mask & bound.arguments["normals"].valid
    values, _, out = next(c for c in calls if c[1] == "max")
    return kps, (values[:, 0], out[1][:, 0], ok), steps


def _refine_guards(kp_in, kp_out, sums, r2: float):
    """_refine_step's two guards on a step's sums, as it computes them: its
    `well` test as a ratio (|det| over 1e-9 tr^3; above 1 passes), whether
    the keypoint moved (both guards passed), moved2 / r2 (the move's own
    length where it moved, else that of the solve in float64; at most 1
    passes), and the condition number of sum(n n^T) in float64 (what the
    solve multiplies a relative change of the sums by, at most)."""
    from mapmerge_torch.ops.rigid import _det3

    a, b = sums[:, :9].reshape(-1, 3, 3), sums[:, 9:]
    trace = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    well = _det3(a).abs() / (1e-9 * trace.clamp_min(1e-9) ** 3)
    moved = (kp_out != kp_in).any(dim=-1)
    x = torch.linalg.solve_ex(a.double(), b.double())[0]
    moved2 = torch.where(moved, ((kp_out - kp_in) ** 2).sum(dim=-1).double(),
                         ((x - kp_in.double()) ** 2).sum(dim=-1))
    return well, moved, moved2 / r2, torch.linalg.cond(a.double())


def harris_differences(args, kwargs, got, plain, rows_p, n_show: int = 8) -> dict:
    """Why the plain route's keypoints `rows_p` (rows of its keypoints)
    that kernel L's run did not find differ, from both runs' traces (_harris_traced): the points the
    suppression kept on one route only (each with its response, its
    neighbourhood max and the threshold on both), and for each missed
    keypoint either "selection" (no keypoint of L's run starts where it
    starts) or, step by step, both routes' guards (_refine_guards: moved,
    the well ratio, moved2 / r2), the first step at which a guard differs
    and which one ("well" or "radius") or else the first at which the
    member counts differ (a point at the radius of keypoints that earlier
    steps moved apart), and the step-0 sums' largest
    difference over their largest magnitude (both routes then sum over
    the same queries), with sum(n n^T)'s condition number, both routes'
    member counts and the keypoints' distance after it a step."""
    import inspect

    from mapmerge_torch.ops.keypoints import harris as harris_ops
    from mapmerge_torch.ops.neighbors import _f32

    bound = inspect.signature(harris_ops.detect_keypoints_harris).bind(*args, **kwargs)
    threshold, radius = bound.arguments["threshold"], bound.arguments["radius"]
    r2 = _f32(radius * radius)
    (kk, (resp_k, nmax_k, ok), steps_k), (pk, (resp_p, nmax_p, _), steps_p) = got, plain
    keep_k = ok & (resp_k >= nmax_k) & (resp_k > threshold)
    keep_p = ok & (resp_p >= nmax_p) & (resp_p > threshold)
    one_side = (keep_k ^ keep_p).nonzero()[:, 0]
    out = {"kept_on_one_route": [
        {"point": int(i), "kept_by": "kernel" if bool(keep_k[i]) else "plain",
         "kernel_resp_nmax": [float(resp_k[i]), float(nmax_k[i])],
         "plain_resp_nmax": [float(resp_p[i]), float(nmax_p[i])], "threshold": threshold}
        for i in one_side[:n_show].tolist()], "n_kept_on_one_route": int(one_side.numel())}
    guards_k = [_refine_guards(a, b, c, r2) for a, b, c, _ in steps_k]
    guards_p = [_refine_guards(a, b, c, r2) for a, b, c, _ in steps_p]
    km = kk.mask
    start_k = steps_k[0][0]
    missed, causes = [], {}
    for i in rows_p.tolist():
        eq = (start_k == steps_p[0][0][i]).all(dim=-1) & km
        entry = {"keypoint": i, "start": steps_p[0][0][i].tolist()}
        if not bool(eq.any()):
            entry["cause"] = "selection"
        else:
            j = int(eq.nonzero()[0, 0])
            entry["distance_m"] = float((pk.xyz[i] - kk.xyz[j]).abs().max())
            sums_p, sums_k = steps_p[0][2][i], steps_k[0][2][j]
            entry["step0_sum_diff_rel"] = float(
                (sums_k - sums_p).abs().max() / sums_p.abs().max().clamp_min(1e-30))
            entry["steps"] = [
                {"moved": [bool(gp[1][i]), bool(gk[1][j])],
                 "well_ratio": [float(gp[0][i]), float(gk[0][j])],
                 "moved2_over_r2": [float(gp[2][i]), float(gk[2][j])],
                 "cond": [float(gp[3][i]), float(gk[3][j])],
                 "members": [int(sp[3][i]), int(sk[3][j])],
                 "gap_after_m": float((sp[1][i] - sk[1][j]).abs().max())}
                for gp, gk, sp, sk in zip(guards_p, guards_k, steps_p, steps_k)]
            flip = next((s for s, st in enumerate(entry["steps"])
                         if st["moved"][0] != st["moved"][1]), None)
            crossed = next((s for s, st in enumerate(entry["steps"])
                            if st["members"][0] != st["members"][1]), None)
            if flip is None and crossed is None:
                entry["cause"] = "no guard flipped, the same members"
            elif flip is None:
                entry["cause"] = f"no guard flipped, the members differ from step {crossed}"
            else:
                wr = entry["steps"][flip]["well_ratio"]
                guard = "well" if (wr[0] > 1) != (wr[1] > 1) else "radius"
                entry["cause"] = f"{guard} guard flipped at step {flip}"
        causes[entry["cause"]] = causes.get(entry["cause"], 0) + 1
        missed.append(entry)
    out["causes"] = causes
    out["missed"] = missed[:n_show]
    return out


def hold_harris_keypoints(label: str, seen: dict) -> None:
    """The path's first Harris extraction again on the same cloud, through
    kernel L and through its plain versions (plain_grid_reduce), both
    traced: at least KEYPOINT_AGREEMENT of the plain route's keypoints
    found within 1e-4 m (the refined positions carry the sums' rounding)
    with a response within 1e-3 relative; the keypoints that differ are
    counted, and why they differ is logged (harris_differences). These
    launches come after the path's counts were read."""
    args, kwargs = seen["harris_detect"]
    traced_k = _harris_traced(args, kwargs, {})
    traced_p = _harris_traced(args, kwargs, plain_grid_reduce())
    got, plain = traced_k[0], traced_p[0]
    pm, km = plain.mask, got.mask
    pxyz, kxyz = plain.xyz[pm], got.xyz[km]
    pr, kr = plain.response[pm], got.response[km]
    gap = (pxyz[:, None] - kxyz[None]).abs().amax(-1)
    same = (gap <= 1e-4) & ((pr[:, None] - kr[None]).abs() <= 1e-3 * pr[:, None].abs())
    found = same.any(dim=1)
    n_plain, n_found = int(pm.sum()), int(found.sum())
    share = n_found / max(n_plain, 1)
    largest = float(gap.amin(dim=1).max()) if gap.numel() else None
    log(f"{label}: Harris keypoints of the first cloud, kernel L against its plain "
        f"versions: {int(km.sum())} and {n_plain} keypoints, {n_found} of the plain route's "
        f"found ({share}), {n_plain - n_found} differ; the largest distance to the nearest "
        f"of L's {largest} m")
    if n_found < n_plain:
        rows = pm.nonzero()[:, 0][~found]
        log(f"{label}: why the Harris keypoints differ: "
            f"{json.dumps(harris_differences(args, kwargs, traced_k, traced_p, rows))}")
    require(n_plain > 0 and share >= KEYPOINT_AGREEMENT,
            f"{label}: {share} of the plain route's Harris keypoints found, gate "
            f"{KEYPOINT_AGREEMENT}")


def hold_harris_route(label: str, seen: dict) -> None:
    """The path's first Harris extraction's grids again (GridRoute), on the
    card through kernel L: the response's 6 channels (the upper triangle of
    n n^T) against all 9 through the same sweep, each mirrored entry
    required bit for bit (the sweep adds each channel on its own, in
    candidate order), the counts equal; and the suppression over the
    queries above the threshold against the suppression over every
    answered query, `keep` required bit for bit, the maxes of the queries
    swept too. Logs the share of the answered queries swept. These
    launches come after the path's counts were read."""
    import inspect

    from mapmerge_torch.ops import grid as grid_ops
    from mapmerge_torch.ops.keypoints import harris as harris_ops

    args, kwargs = seen["harris_detect"]
    bound = inspect.signature(harris_ops.detect_keypoints_harris).bind(*args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    cloud, normals, threshold = a["cloud"], a["normals"], a["threshold"]
    ok = cloud.mask & normals.valid
    route = harris_ops.GridRoute(cloud, ok, a["radius"], a["scan_cap"])
    outer = harris_ops._outer(normals).reshape(-1, 9)
    six = grid_ops.grid_reduce_query(route.grid, route.q, outer[:, list(harris_ops.UPPER)],
                                     "sum", qg=route.qg)
    nine = grid_ops.grid_reduce_query(route.grid, route.q, outer, "sum", qg=route.qg)
    mirrored = harris_ops._mirror(six[1]).reshape(-1, 9)
    require(torch.equal(six[0], nine[0]) and _same_bits(mirrored, nine[1]),
            f"{label}: the 6-channel response's mirrored sums differ from the 9-channel "
            f"sweep's in {int((mirrored != nine[1]).sum())} entries; bit for bit required")
    resp = harris_ops._response(nine[1].reshape(-1, 3, 3), ok)
    masked = route.suppression(resp, threshold)
    full = grid_ops.grid_reduce_query(route.grid, route.q, resp[:, None], "max",
                                      qg=route.qg)[1][:, 0]
    keep_m = ok & (resp >= masked) & (resp > threshold)
    keep_f = ok & (resp >= full) & (resp > threshold)
    above = resp > threshold
    answered = int(route.qg.cell_ok.sum())
    swept = int(grid_ops.masked_query_grid(route.qg, above, resp.shape[0]).cell_ok.sum())
    require(torch.equal(keep_m, keep_f) and _same_bits(masked[above], full[above]),
            f"{label}: the threshold-masked suppression keeps {int(keep_m.sum())} points, the "
            f"full one {int(keep_f.sum())}; bit for bit required")
    log(f"{label}: Harris through L on the first cloud: the 6-channel response's mirrored "
        f"sums bit for bit the 9-channel sweep's ({mirrored.shape[0]} queries); the "
        f"suppression swept {swept} of {answered} answered queries ({swept / answered}, "
        f"response above {threshold}), its keep ({int(keep_m.sum())} points) bit for bit the "
        f"full suppression's")
    del route, six, nine, outer
    torch.cuda.empty_cache()


def sift_stages():
    """SIFT's stage and its scale space and 26-NN, split by the engine each
    octave's capacity resolves to: (owner, function, label) for
    stage_recorder."""
    from mapmerge_torch.ops.keypoints import sift
    from mapmerge_torch.ops.neighbors import _resolve_engine
    from mapmerge_torch.pipeline import features

    def octaves(stage, engine, capacity):
        return f"SIFT {stage}, {_resolve_engine(engine, capacity)} octaves"

    return (
        (features, "detect_keypoints", "SIFT"),
        (sift, "_scale_space",
         lambda *a, **k: octaves("scale space", a[4], a[0].capacity)),
        (sift, "_knn", lambda *a, **k: octaves("26-NN", a[3], a[0].capacity)),
    )


def sift_octave_stats(clouds, params) -> dict:
    """Kernels C and D on config #1's dense octaves after the first (octaves
    1 and 2, at the query counts one merge gives them: the first call at
    each count), as the merge calls them: C's pairs in bound and bounds, D's
    bound, and D (on the octave's buffer) timed beside knn_library."""
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    calls: dict = {}

    def keep(name):
        def make(fn):
            def wrapper(*args, **kwargs):
                calls.setdefault((name, args[0].shape[0]), (args, kwargs))
                return fn(*args, **kwargs)

            return wrapper

        return make

    with patched({(ksift, "scale_space"): keep("C"), (ksift, "knn"): keep("D")}):
        estimate_maps_transforms(clouds, params, seed=0)
    sizes = sorted({n for _, n in calls}, reverse=True)[1:]
    out = {}
    for n in sizes:
        c_args, _ = calls[("C", n)]
        d_args, d_kwargs = calls[("D", n)]
        in_bound = scale_space_in_bound(c_args)
        c_bound, d_bound = scale_space_bound(c_args, in_bound), knn_bound(d_args)
        library = knn_library_stats(ksift, d_args)
        out[f"Q={n}"] = {
            "sift_scale_space_pairs_in_bound": in_bound,
            "sift_scale_space_bound_ms": c_bound["bound_ms"],
            "sift_scale_space_bound_by": c_bound["bound_by"],
            "sift_knn_ms": time_ms(lambda: ksift.knn(*d_args, **d_kwargs)),
            "sift_knn_bound_ms": d_bound["bound_ms"], "sift_knn_bound_by": d_bound["bound_by"],
            "sift_knn_library_ms": library["library_ms"],
            "library_index_agreement_unparked": library["library_index_agreement_unparked"],
        }
    return out


def sift_split(label: str, clouds, params, first) -> None:
    """One merge timed stage by stage through the kernels (its transforms
    bitwise `first`), then one with SIFT's dense octave on the plain
    versions (the parent's route), each synchronised around every stage;
    SIFT's ms and its split by engine logged for both."""
    from mapmerge_torch.parallel import pair_shard
    from mapmerge_torch.pipeline import merging

    for route, patches in (("kernels", {}), ("plain versions", plain_sift())):
        recorder = stage_recorder(sift_stages(), (pair_shard, "extract_features"),
                                  (merging, "estimate_pairs_batch"))
        with recorder as rec, patched(patches):
            out = merging.estimate_maps_transforms(clouds, params, seed=0)
        if route == "kernels":
            require(all(np.array_equal(a, b) for a, b in zip(out, first)),
                    f"{label}: the stage-timed run gave other transforms than the first")
        log(f"{label} SIFT stage ms of one merge ({len(clouds)} clouds), {route}: "
            f"{json.dumps(rec['ms'])}; calls {json.dumps(rec['calls'])}")


def config1_stages():
    """The stages of a config #1 merge: config2_stages with SIFT, split by
    engine into its scale space and 26-NN (sift_stages), for Harris."""
    return tuple(s for s in config2_stages() if s[2] != "Harris") + sift_stages()


def device_busy(fn) -> dict:
    """fn() under torch.profiler, ending in a synchronisation: its host wall,
    the device busy ms (the union of the intervals of the CUDA events: a
    kernel and the op that launched it each carry device time, so summing
    them counts twice), their share of the wall, and device ms by kernel
    name (the 12 largest)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    by_name: dict = {}
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms, "device_ms_by_kernel": dict(top)}


def profile_merge(label: str, clouds, params, first, stages) -> None:
    """One warm merge with every stage of `stages` between two
    synchronisations (stage_recorder: host ms a stage, summed over the
    clouds and pairs), then one under torch.profiler with none
    (device_busy). Both must give `first`'s transforms bit for bit."""
    from mapmerge_torch.parallel import pair_shard
    from mapmerge_torch.pipeline import merging
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    with stage_recorder(stages, (pair_shard, "extract_features"),
                        (merging, "estimate_pairs_batch")) as rec:
        runs = [list(estimate_maps_transforms(clouds, params, seed=0))]
    busy = device_busy(lambda: runs.append(list(estimate_maps_transforms(
        clouds, params, seed=0))))
    require(all(len(r) == len(first) and all(np.array_equal(a, b) for a, b in zip(r, first))
                for r in runs), f"{label}: a profiled merge gave other transforms")
    log(f"{label} stage ms of one warm merge (each stage between two "
        f"synchronisations): {json.dumps(rec['ms'])}; calls {json.dumps(rec['calls'])}")
    log(f"{label} one warm merge under torch.profiler: {json.dumps(busy)}")


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
    require_route(label, launches, "batched", seen["pairs"])
    hold_on_path_inputs(label, seen, nn, spfh, launches)
    hold_graph(label, seen)
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


def adjacent_errors(transforms, truths) -> list:
    """The relative pose error (deg, m) of each pair of adjacent maps that
    both registered (bench_configs.check_adjacent)."""
    from mapmerge_torch.core import transforms as tf

    return [
        tf.pose_error(np.linalg.inv(transforms[i]) @ transforms[i + 1],
                      np.linalg.inv(truths[i]) @ truths[i + 1])
        for i in range(len(truths) - 1)
        if np.asarray(transforms[i]).any() and np.asarray(transforms[i + 1]).any()
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
        (merging, "compute_global_transforms", "tree solve (native)"),
        (merging, "refine_global_transforms", "refinement"),
    )


def feature_counters(f) -> dict:
    """A cloud's feature-stage counters: its points after the voxel grid,
    the valid points the grid dropped, the probe's overflow (the fullest
    bucket beyond its cap), its keypoints and those the cap truncated."""
    return {
        "points": int(f.cloud.mask.sum()),
        "dropped_points": int(f.dropped_points),
        "scan_overflow": int(f.scan_overflow),
        "keypoints": int(f.keypoints.mask.sum()),
        "keypoints_truncated": int(f.keypoints.truncated),
    }


@contextlib.contextmanager
def stage_recorder(stages, features_at, pairs_at):
    """Host ms and calls of every stage of `stages` ((owner, attribute,
    label); a label may be a function of the call's arguments), each call
    between two synchronisations, summed over one run; and the counters of
    each cloud's features (the calls of `features_at`, an (owner,
    attribute)) and each pair's estimate (`pairs_at`, which returns one
    pair's estimate or a batch's)."""
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
            rec["clouds"].append(feature_counters(f))
            return f

        return wrapper

    def pair_counters(fn):
        def wrapper(*args, **kwargs):
            est = fn(*args, **kwargs)  # one pair, or a batch of them
            rec["pairs"] += [{"ok": bool(ok), "scan_overflow": int(over)} for ok, over
                             in zip(est.ok.reshape(-1), est.scan_overflow.reshape(-1))]
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


@contextlib.contextmanager
def harris_split():
    """Host ms of each Harris extraction on the grid
    (`detect_keypoints_harris`, between two synchronisations) split into
    its `build_grid` sorts (the target grid, built with the valid mask, and
    the query grid: two an extraction), its target's tile boxes, its kernel
    L calls (grid_reduce_query: the response, a 6-channel sum over every
    point; the suppression, a 1-channel max over the points above the
    threshold; each refinement step, a 9-channel sum over the keypoints),
    each between two synchronisations, and the rest of the extraction (the
    top-k, the solves) as `other_ms`; beside them the extraction's launches
    of grid_pack, grid_reduce and grid_reduce_list. One record a Harris
    extraction, in call order."""
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.ops import keypoints as keypoint_ops
    from mapmerge_torch.ops.keypoints import harris as harris_ops

    rec: list = []
    state: dict = {"cloud": None}
    counted = (kgrid.PACK_KERNEL, kgrid.REDUCE_KERNEL, kgrid.REDUCE_LIST_KERNEL)

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def detect(fn):
        def wrapper(*args, **kwargs):
            state["cloud"] = cloud = {"sorts": [], "boxes_ms": 0.0, "calls": []}
            before = [k.launches for k in counted]
            out, cloud["ms"] = timed(fn, *args, **kwargs)
            cloud["launches"] = {k.name: k.launches - b for k, b in zip(counted, before)}
            state["cloud"] = None
            cloud["other_ms"] = (cloud["ms"] - sum(c["ms"] for c in cloud["calls"])
                                 - sum(s["ms"] for s in cloud["sorts"]) - cloud["boxes_ms"])
            rec.append(cloud)
            return out

        return wrapper

    def reduce(fn):
        def wrapper(grid, q, values, reduce="sum", **kwargs):
            if state["cloud"] is None:
                return fn(grid, q, values, reduce, **kwargs)
            name = ("suppression" if reduce == "max"
                    else "response" if values.shape[1] == 6 else "refinement")
            qg = kwargs.get("qg")
            call = {"call": name, "queries": q.shape[0], "channels": values.shape[1],
                    "answered": q.shape[0] if qg is None else int(qg.cell_ok.sum())}
            out, call["ms"] = timed(fn, grid, q, values, reduce, **kwargs)
            state["cloud"]["calls"].append(call)
            return out

        return wrapper

    def sort(fn):
        def wrapper(xyz, mask, *args, **kwargs):
            if state["cloud"] is None:
                return fn(xyz, mask, *args, **kwargs)
            out, ms = timed(fn, xyz, mask, *args, **kwargs)
            state["cloud"]["sorts"].append({"grid": "query" if mask is None else "target",
                                            "ms": ms})
            return out

        return wrapper

    def boxes(fn):
        def wrapper(grid):
            if state["cloud"] is None:
                return fn(grid)
            out, ms = timed(fn, grid)
            state["cloud"]["boxes_ms"] += ms
            return out

        return wrapper

    with patched({(keypoint_ops, "detect_keypoints_harris"): detect,
                  (harris_ops, "grid_reduce_query"): reduce, (harris_ops, "build_grid"): sort,
                  (harris_ops.grid_kernels, "boxes"): boxes}):
        yield rec


def log_harris_split(label: str, rec: list) -> None:
    """The first Harris extraction's split (harris_split), and the run's
    sums by call and by sort; each extraction is required to sort twice
    (one target grid, one query grid) and to launch L twice on its sweep
    route and three times on its list route."""
    if not rec:
        return
    sums: dict = {}
    for cloud in rec:
        for call in cloud["calls"]:
            sums[call["call"]] = sums.get(call["call"], 0.0) + call["ms"]
        for s in cloud["sorts"]:
            key = f"{s['grid']} sorts"
            sums[key] = sums.get(key, 0.0) + s["ms"]
        sums["boxes"] = sums.get("boxes", 0.0) + cloud["boxes_ms"]
        sums["other"] = sums.get("other", 0.0) + cloud["other_ms"]
    kinds = [sorted(s["grid"] for s in cloud["sorts"]) for cloud in rec]
    log(f"{label} Harris split of the first cloud (ms): {json.dumps(rec[0])}")
    log(f"{label} Harris split summed over {len(rec)} extractions (ms): {json.dumps(sums)}, "
        f"Harris {sum(c['ms'] for c in rec)}; sorts an extraction "
        f"{[len(k) for k in kinds]}; launches an extraction "
        f"{[c['launches'] for c in rec]}")
    require(all(k == ["query", "target"] for k in kinds),
            f"{label}: Harris extractions sorted {kinds}, expected one target and one query "
            "grid each")
    require(all(c["launches"]["grid_reduce"] == 2 and c["launches"]["grid_reduce_list"] == 3
                for c in rec), f"{label}: L's launches an extraction "
            f"{[c['launches'] for c in rec]}, expected 2 sweeps and 3 list calls")


def run_config2(dev, kernels):
    """Eval config #2 on the cell-grid engine (phase 7). Returns (the views
    in host memory, truths, cold transforms, info_out of the cold run) for
    phase 12, which builds its own clouds: phases 8-10 hold none of these
    on the card."""
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
    require_route("config #2", launches, "grid", seen["pairs"])
    hold_on_path_inputs("config #2", seen, nn, spfh, launches,
                        exact=True)
    hold_harris_keypoints("config #2", seen)
    hold_harris_route("config #2", seen)
    hold_graph("config #2", seen)

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

    from mapmerge_torch.parallel import pair_shard
    from mapmerge_torch.pipeline import merging

    recorder = stage_recorder(config2_stages(), (pair_shard, "extract_features"),
                              (merging, "estimate_transform"))
    with recorder as rec, patched({(spfh, "spfh_grid"): keep}), harris_split() as split:
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
    log_harris_split("config #2", split)
    return views, truths, cold, info


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


def stateless_clouds(node) -> tuple[list, list]:
    """(robots, clouds) of a stateless node's next estimation tick, as the
    node builds them: each robot's latest map subsampled to the tick's
    capacity (the larger map's size, at most max_points) as the reference
    node does, in the node's robot order."""
    robots, raw = node._snapshot_clouds(node.get_robots())
    cap = min(max(len(x) for x, _ in raw), node.params.max_points)
    return robots, [
        node._cloud(*node._fit_to_capacity(x, r, cap, robot)[:2], cap)
        for robot, (x, r) in zip(robots, raw)
    ]


def run_node_config1(dev, kernels) -> None:
    """Phases 8 and 9: the online node on config #1's views, stateless and
    incremental."""
    from mapmerge_torch.core import transforms as tf
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
    require(launches["spfh"] > 0, f"{label}: kernel spfh was not launched")
    require_route(label, launches, "batched", seen["pairs"])
    hold_on_path_inputs(label, seen, nn, spfh, launches)
    hold_graph(label, seen)
    require(rot < 1.0 and trans < 0.1, f"{label}: pose gate 1 deg / 0.1 m failed")
    _, clouds = stateless_clouds(node)
    cap = clouds[0].capacity
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
    require_route(label, launches, "one pair", seen["pairs"])
    hold_on_path_inputs(label, seen, nn, spfh, launches)
    hold_graph(label, seen, solves=False)
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
    capacity resolves to (sift_stages)."""
    from mapmerge_torch.pipeline import features, incremental
    from mapmerge_torch.runtime import node

    return (
        (node, "features_for", "features"),
        (features, "voxel_downsample", "downsample"),
        (features, "overflow_probe", "probe"),
        (features, "remove_outliers", "outliers"),
        (features, "compute_surface_normals", "normals"),
        *sift_stages(),
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
    from mapmerge_torch.ops.keypoints import sift as sift_ops
    from mapmerge_torch.pipeline import features, incremental
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
    big_octave = []  # the first map's octave 0: _scale_space's arguments

    def keep_big_octave(fn):
        def wrapper(cloud, *args, **kwargs):
            if not big_octave and cloud.capacity == cap:
                big_octave.append([_copied(cloud), *(_copied(a) for a in args)])
            return fn(cloud, *args, **kwargs)

        return wrapper

    def record_overflow(fn):
        def wrapper(q, p, values, sigmas, p_mask=None, scan_cap=128, **kwargs):
            out, overflow = fn(q, p, values, sigmas, p_mask=p_mask,
                               scan_cap=scan_cap, **kwargs)
            built = grid.build_grid(p, p_mask, 3.0 * max(sigmas), None, scan_cap)
            smooth_overflow.append((p.shape[0], int(p_mask.sum()), int(overflow),
                                    int(built.overflow)))
            return out, overflow

        return wrapper

    big_radius = {}  # the first map's outlier and normal stages' clouds (2^19)

    def keep_big_radius(key):
        def make(fn):
            def wrapper(cloud, *args, **kwargs):
                if key not in big_radius and cloud.capacity == cap:
                    big_radius[key] = _copied(cloud)
                return fn(cloud, *args, **kwargs)

            return wrapper

        return make

    node, transport = new_node()
    recorder = stage_recorder(config5_stages(), (node_module, "features_for"),
                              (incremental, "estimate_transform"))
    with first_launch_inputs(nn, spfh) as seen, recorder as rec, patched(
        {(grid, "grid_gaussian_smooth"): record_overflow,
         (sift_ops, "_scale_space"): keep_big_octave,
         (features, "remove_outliers"): keep_big_radius("outliers"),
         (features, "compute_surface_normals"): keep_big_radius("normals")}
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
    require_route("config5_big", launches, "grid", seen["pairs"])
    require(launches["grid_smooth"] == launches["grid_knn"] == 2 * n_features,
            f"config5_big: grid_smooth {launches['grid_smooth']} and grid_knn "
            f"{launches['grid_knn']} launches for {n_features} extractions, expected two "
            "each (octaves 0 and 1 on the grid)")
    hold_on_path_inputs("config5_big", seen, nn, spfh, launches,
                        exact=True, sift_per_extraction=1)
    hold_sift_keypoints("config5_big (kernels J and K)", seen, plain_grid_sift())
    hold_graph("config5_big", seen, solves=False)

    poses = node.get_transforms()
    ordered = [poses[f"robot_{i:02d}"] for i in range(n)]
    require(len(poses) == n and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in ordered
    ), "config5_big: transforms are not finite 4x4 matrices, one a map")
    registered = sum(1 for t in ordered if t.any())
    adjacent = adjacent_errors(ordered, truths)
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

    require(big_octave, f"config5_big: no SIFT octave at capacity {cap} was recorded")
    log("config5_big octave 0, kernels C and D against the grid route (through J and "
        "K, and through their plain versions): "
        + json.dumps(big_octave_stats(*big_octave[0])))
    require(sorted(big_radius) == ["normals", "outliers"],
            f"config5_big: the radius stages' clouds at capacity {cap} were not recorded")
    log("config5_big first map, kernels E and F against the grid route: "
        + json.dumps(big_radius_stats(big_radius["outliers"], big_radius["normals"],
                                      params)))

    # repeatability: a second node streams the first batch
    again, again_transport = new_node()
    stream(again, again_transport, views, CONFIG5_BATCH)
    second = again.get_transforms()
    require(sorted(second) == sorted(first_tick) and all(
        np.array_equal(second[r], first_tick[r]) for r in first_tick
    ), "config5_big: a second node's first batch gave other poses than the first tick")
    log(f"repeat check (config5_big): a second node's first batch "
        f"({CONFIG5_BATCH} maps) bitwise equal to the first tick")


#: config5_big's octave-0 queries on which kernels C and D are held against
#: their plain versions: each query's row is independent of the others, so
#: a sample of rows is held exactly as the whole would be
BIG_OCTAVE_SAMPLE = 4096


def big_octave_stats(cloud, intensity, sigmas, tile, engine, scan_cap) -> dict:
    """Kernels C and D, culled, on config5_big's octave 0 (the first map's
    own cloud at capacity 2^19, whose octave the grid serves: `engine`
    resolves to it), beside that route's grid_gaussian_smooth and
    radius_neighbors on the same octave, as ops/keypoints/sift.py calls
    them: the whole ops (build_grid of both sides included) through kernels
    J and K and through their plain versions (`*_plain_ms`, the route before
    J and K), and J and K alone on the octave's grids. D held exactly and C
    within SCALE_SPACE_RTOL (0 at the parked queries, a second launch the
    same bits) against their plain versions on BIG_OCTAVE_SAMPLE sampled
    queries (J and K are held in full on this octave in grid_sift_stats);
    all timed (CUDA events, warm, median of 5, the grid routes' of 3).
    Measured only: no routing changes."""
    from mapmerge_torch.core.cloud import FAR
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.ops import grid
    from mapmerge_torch.ops.keypoints import sift as sift_ops
    from mapmerge_torch.ops.neighbors import _center, _f32, _resolve_engine, radius_neighbors

    require(_resolve_engine(engine, cloud.capacity) == "grid",
            "config5_big: octave 0 does not take the grid")
    qc, pc = _center(cloud.xyz, cloud.xyz, cloud.mask)
    vals = torch.where(cloud.mask, intensity, 0.0)
    c_args = (qc, pc, vals, cloud.mask, sigmas, _f32((3.0 * max(sigmas)) ** 2))
    k = min(sift_ops._KNN + 1, cloud.capacity)
    d_args = (qc, pc, cloud.mask, k, _f32(1.0e6 * 1.0e6))
    g = torch.Generator(device=qc.device).manual_seed(19)
    sample = torch.randperm(qc.shape[0], generator=g, device=qc.device)
    sample = sample[:BIG_OCTAVE_SAMPLE].sort().values
    field = ksift.scale_space(*c_args)
    ref = ksift.scale_space_ref(qc[sample], *c_args[1:])
    err = float((field[:, sample] - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    parked = qc[sample].abs().amax(-1) >= FAR / 2
    require(rel <= ksift.SCALE_SPACE_RTOL and bool((field[:, sample][:, parked] == 0).all())
            and torch.equal(field, ksift.scale_space(*c_args)),
            f"config5_big octave 0 sift_scale_space: off by {rel} of the field on "
            "the sample, or a parked query not 0, or a second launch other bits")
    idx, valid = ksift.knn(*d_args)
    ridx, rvalid = ksift.knn_ref(qc[sample], *d_args[1:])
    require(torch.equal(idx[sample], ridx) and torch.equal(valid[sample], rvalid),
            "config5_big octave 0 sift_knn: the sample differs from knn_ref")
    del ref, ridx, rvalid
    # knn_library over every query would hold a Q x P plane of 1.1 TB: it
    # is timed on the sample, and that time scaled by Q / the sample
    library = knn_library_stats(ksift, (qc[sample].contiguous(), *d_args[1:]))
    torch.cuda.empty_cache()
    in_bound = scale_space_in_bound(c_args)

    def grid_smooth():
        return grid.grid_gaussian_smooth(cloud.xyz, cloud.xyz, intensity, sigmas,
                                         p_mask=cloud.mask, scan_cap=scan_cap)

    def grid_knn():
        return radius_neighbors(cloud.xyz, cloud.xyz,
                                radius=sift_ops._GRID_KNN_RADIUS_SCALES * sigmas[0], k=k,
                                p_mask=cloud.mask, tile=tile, engine=engine,
                                scan_cap=scan_cap)

    # J and K alone, on the grids the two ops build
    r_bound = 3.0 * max(sigmas)
    r_knn = sift_ops._GRID_KNN_RADIUS_SCALES * sigmas[0]
    j_args = grid_operands(cloud.xyz, cloud.mask, cloud.xyz, None, r_bound, scan_cap)[:3] + (
        intensity, sigmas, _f32(r_bound * r_bound))
    k_args = grid_operands(cloud.xyz, cloud.mask, cloud.xyz, None, r_knn, scan_cap) + (
        k, _f32(r_knn * r_knn), False)
    alone = {"grid_smooth_ms": time_ms(lambda: kgrid.smooth(*j_args), reps=5, warmup=1),
             "grid_knn_ms": time_ms(lambda: kgrid.knn(*k_args), reps=5, warmup=1)}
    del j_args, k_args
    with patched(plain_grid_sift()):
        plain = {"grid_gaussian_smooth_plain_ms": time_ms(grid_smooth, reps=3, warmup=1),
                 "grid_radius_neighbors_plain_ms": time_ms(grid_knn, reps=3, warmup=1)}
    torch.cuda.empty_cache()

    c_bound, d_bound = scale_space_bound(c_args, in_bound), knn_bound(d_args)
    return {
        "shape": f"Q=P={qc.shape[0]} ({int(cloud.mask.sum())} valid) S={len(sigmas)} k={k}",
        "sample": BIG_OCTAVE_SAMPLE, "sift_scale_space_err_of_field": rel,
        "sift_knn_exact": True, "pairs_in_bound": in_bound,
        "sift_scale_space_ms": time_ms(lambda: ksift.scale_space(*c_args), reps=5, warmup=1),
        "sift_knn_ms": time_ms(lambda: ksift.knn(*d_args), reps=5, warmup=1),
        "grid_gaussian_smooth_ms": time_ms(grid_smooth, reps=3, warmup=1),
        "grid_radius_neighbors_ms": time_ms(grid_knn, reps=3, warmup=1), **plain, **alone,
        "sift_scale_space_bound_ms": c_bound["bound_ms"],
        "sift_scale_space_dense_bound_ms": c_bound["dense_bound_ms"],
        "sift_knn_bound_ms": d_bound["bound_ms"],
        "sift_knn_dense_bound_ms": d_bound["dense_bound_ms"],
        "sift_knn_library_sample_ms": library["library_ms"],
        "sift_knn_library_scaled_ms": library["library_ms"] * qc.shape[0] / BIG_OCTAVE_SAMPLE,
        "library_index_agreement_unparked": library["library_index_agreement_unparked"],
    }


def big_radius_stats(outlier_cloud, normal_cloud, params) -> dict:
    """Kernels E and F, culled, on config5_big's first map at capacity 2^19
    (the clouds its outlier and normal stages got, which the grid serves),
    beside that route's grid_radius_count and grid_neighbor_moments on the
    same clouds, as ops/neighbors.py calls them: through kernels I and H
    (grid_ms), and through their plain versions (grid_plain_ms, the route
    before kernels G-I). E held exactly and F within MOMENTS_RTOL (a second
    launch the same bits) against their plain versions on
    BIG_OCTAVE_SAMPLE sampled queries; all timed (CUDA events, warm,
    median of 5, the grid's of 3); E beside count_library on the sample,
    scaled to every query. Measured only: no routing changes."""
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.ops import grid
    from mapmerge_torch.ops.neighbors import _center, _f32, _resolve_engine

    out = {}
    for name, cloud, radius in (("radius_count", outlier_cloud, params.descriptor_radius),
                                ("radius_moments", normal_cloud, params.normal_radius)):
        require(_resolve_engine(params.neighbor_engine, cloud.capacity) == "grid",
                f"config5_big: the {name} stage does not take the grid")
        qc, pc = _center(cloud.xyz, cloud.xyz, cloud.mask)
        args = (qc, pc, cloud.mask, _f32(radius * radius))
        g = torch.Generator(device=qc.device).manual_seed(20)
        sample = torch.randperm(qc.shape[0], generator=g, device=qc.device)
        sample = sample[:BIG_OCTAVE_SAMPLE].sort().values
        if name == "radius_count":
            kernel, grid_fn = kradius.count, grid.grid_radius_count
            got = kernel(*args)
            require(torch.equal(got[sample], kradius.count_ref(qc[sample], *args[1:])),
                    "config5_big radius_count: the sample differs from count_ref")
            in_bound = int(got.to(torch.int64).sum())
            # count_library on the sample (a Q x P plane of all 2^19 would
            # not fit), scaled to every query, as grid_library_stats does for I
            lib_args = (qc[sample].contiguous(), pc, cloud.mask, args[3])
            lib_ms = time_ms(lambda: count_library(*lib_args))
            agree = count_library(*lib_args) == got[sample].long()
            held = {"library_sample_ms": lib_ms,
                    "library_ms": lib_ms * qc.shape[0] / sample.numel(),
                    "library_count_agreement": float(agree.double().mean())}
            bound = radius_count_bound(args, in_bound)
        else:
            kernel, grid_fn = kradius.moments, grid.grid_neighbor_moments
            got = kernel(*args)
            want = kradius.moments_ref(qc[sample], *args[1:])
            mine = tuple(a[sample] for a in got)
            _, rel = kradius.moments_error(mine, want)
            require(torch.equal(mine[0], want[0]) and rel <= kradius.MOMENTS_RTOL
                    and all(torch.equal(a, b) for a, b in zip(got, kernel(*args))),
                    f"config5_big radius_moments: off by {rel} of a second moment on the "
                    "sample, or other counts, or a second launch other bits")
            in_bound, held = int(got[0].to(torch.int64).sum()), {"err_of_second_moment": rel}
            bound = radius_moments_bound(args, in_bound)
        del got
        torch.cuda.empty_cache()

        def grid_route():
            return grid_fn(cloud.xyz, cloud.xyz, radius, p_mask=cloud.mask,
                           scan_cap=params.grid_scan_cap)

        plain = {(kgrid, "count"): lambda fn: kgrid.count_ref,
                 (kgrid, "moments"): lambda fn: kgrid.moments_ref}
        out[name] = {
            "shape": f"Q=P={qc.shape[0]} ({int(cloud.mask.sum())} valid) r={radius}",
            "sample": BIG_OCTAVE_SAMPLE, "pairs_in_bound": in_bound, **held,
            "ms": time_ms(lambda: kernel(*args), reps=5, warmup=1),
            "grid_ms": time_ms(grid_route, reps=3, warmup=1),
            "bound_ms": bound["bound_ms"], "dense_bound_ms": bound["dense_bound_ms"],
        }
        with patched(plain):
            out[name]["grid_plain_ms"] = time_ms(grid_route, reps=3, warmup=1)
    return out


def config1_argv() -> list[str]:
    """config1_params() as the tools' `--name value` arguments."""
    from mapmerge_torch.pipeline.merging import MergeParams

    argv = [
        "--keypoint_type", "SIFT", "--keypoint_threshold", "3.0",
        "--descriptor_type", "FPFH", "--refine_transform", "true",
        "--max_iterations", "60", "--max_points", "32768",
        "--max_keypoints", "512", "--max_neighbors", "48",
        "--ransac_hypotheses", "1024", "--neighbor_tile", "1024",
    ]
    require(MergeParams.from_command_line(argv) == config1_params(),
            "the tools' arguments do not give config #1's params")
    return argv


def captured(fn, *args, **kwargs):
    """(fn's result, its standard output), the output also logged."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    text = out.getvalue()
    log(text.rstrip())
    return result, text


def launched_on(label: str, dev, kernels, fn, route: str, solves: bool):
    """fn() with the launch counts reset just before and read just after,
    spfh required to have launched and the pairs to have taken `route`, the
    kernels held against their plain versions on the inputs of their first
    launch there, and its tree solves (`solves`) or none (hold_graph).
    Returns (fn's result, launches, wall s, the native call counts)."""
    from mapmerge_torch.kernels import nn, spfh

    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    log(f"{label}: {wall:.3f} s, launches {launches}")
    require(launches["spfh"] > 0, f"{label}: kernel spfh was not launched")
    require_route(label, launches, route, seen["pairs"])
    hold_on_path_inputs(label, seen, nn, spfh, launches, exact=True)
    hold_graph(label, seen, solves)
    return result, launches, wall, seen["native"]


def run_offline_tools(dev, kernels) -> None:
    """Phase 11: the offline tools on config #1's views at full size, as
    binary .pcd files."""
    import tempfile

    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.io.pcd import read_pcd_arrays, write_pcd
    from mapmerge_torch.ops import neighbors
    from mapmerge_torch.pipeline import merging
    from mapmerge_torch.testing.lzf import lzf_compress, pcd_payload, write_pcd_compressed
    from mapmerge_torch.testing.scene import config1_scene
    from mapmerge_torch.tools import merge_tool, registration_visualisation

    va, vb, _, truth = config1_scene()
    argv = config1_argv()
    with tempfile.TemporaryDirectory() as d:
        a, b, out = (str(Path(d) / f) for f in ("a.pcd", "b.pcd", "out.pcd"))
        write_pcd(a, va)
        write_pcd(b, vb)

        returned = []

        def keep(fn):
            def wrapper(*args, **kwargs):
                returned.append(fn(*args, **kwargs))
                return returned[-1]

            return wrapper

        with patched({(merging, "estimate_maps_transforms"): keep}):
            (rc, text), _, _, _ = launched_on(
                "merge_tool", dev, kernels,
                lambda: captured(merge_tool.main, [a, b, "--output", out, *argv],
                                 device=dev),
                "batched", solves=True,
            )
        require(rc == 0 and len(returned) == 1, f"merge_tool: exit code {rc}")
        tool_t = returned[0]
        raw = [read_pcd_arrays(p) for p in (a, b)]
        cap = max(len(x) for x, _ in raw)
        clouds = [PointCloud.from_numpy(x, r, capacity=cap, device=dev) for x, r in raw]
        params = config1_params()
        direct = merging.estimate_maps_transforms(clouds, params, seed=0)
        require(len(tool_t) == 2 and all(
            np.array_equal(x, y) for x, y in zip(tool_t, direct)
        ), "merge_tool: transforms differ from estimate_maps_transforms on the files")
        n_out = len(read_pcd_arrays(out)[0])
        n_compose = int(merging.compose_maps(clouds, direct, params.output_resolution).count)
        require(n_out == n_compose and f"merged map: {n_out} points" in text,
                f"merge_tool: out.pcd has {n_out} points, compose_maps {n_compose}")
        rot, trans = tf.pose_error(rel_pose(tool_t), truth)
        log(f"merge_tool: transforms bitwise equal to estimate_maps_transforms on "
            f"the files read back; out.pcd {n_out} points = compose_maps; pose "
            f"vs truth {rot} deg, {trans} m")
        require(rot < 1.0 and trans < 0.1, "merge_tool: pose gate 1 deg / 0.1 m failed")

        # the same views as binary_compressed files, read through the native
        # LZF decoder: the same transforms bit for bit
        ca, cb = (str(Path(d) / f) for f in ("a_lzf.pcd", "b_lzf.pcd"))
        t0 = time.perf_counter()
        payloads = [write_pcd_compressed(p, *v) for p, v in ((ca, va), (cb, vb))]
        log(f"binary_compressed files written in {time.perf_counter() - t0:.3f} s "
            f"(the test fixture's Python LZF compressor): payloads "
            f"{[len(x) for x in payloads]} bytes")
        returned.clear()
        with patched({(merging, "estimate_maps_transforms"): keep}):
            (rc, _), _, wall, calls = launched_on(
                "merge_tool (binary_compressed)", dev, kernels,
                lambda: captured(merge_tool.main, [ca, cb, *argv], device=dev),
                "batched", solves=True,
            )
        require(rc == 0 and len(returned) == 1,
                f"merge_tool (binary_compressed): exit code {rc}")
        require(calls["lzf_decompress"] > 0,
                f"merge_tool (binary_compressed): native decoder calls {calls}")
        require(len(returned[0]) == 2 and all(
            np.array_equal(x, y) for x, y in zip(returned[0], tool_t)
        ), "merge_tool (binary_compressed): transforms differ from the binary files' run")
        log(f"merge_tool (binary_compressed): {wall:.3f} s, native calls {calls}; "
            "transforms bitwise equal to the binary files' run")
        for name, payload, view in zip(("a", "b"), payloads, (va, vb)):
            hold_lzf(f"config #1 view {name}", payload, pcd_payload(*view))
        # one payload of config5_big's view size: view a tiled to 459,685
        # points, each copy moved 100 m along x
        reps = -(-CONFIG5_VIEW_POINTS // len(va[0]))
        xyz = np.concatenate([va[0] + np.float32([100.0 * k, 0, 0]) for k in range(reps)])
        rgb = np.concatenate([va[1]] * reps)
        big = pcd_payload(xyz[:CONFIG5_VIEW_POINTS], rgb[:CONFIG5_VIEW_POINTS])
        t0 = time.perf_counter()
        payload = lzf_compress(big)
        log(f"config5_big-size payload compressed in {time.perf_counter() - t0:.3f} s")
        hold_lzf("config5_big view size", payload, big)

        # the debugger keeps each view's own size (no max_points cut, as the
        # reference tool does): at 55,425 and 62,499 points ICP and the score
        # resolve the bounded 1-NN to the grid, so kernel A is bypassed
        require(min(len(x) for x, _ in raw) >= neighbors.GRID_NN_THRESHOLD,
                "config #1's views are below the grid 1-NN threshold")
        dump = str(Path(d) / "dump")
        (rc, text), _, wall, _ = launched_on(
            "registration_visualisation", dev, kernels,
            lambda: captured(registration_visualisation.main,
                             [a, b, "--dump-dir", dump, *argv], device=dev),
            "grid", solves=False,
        )
        require(rc == 0, f"registration_visualisation: exit code {rc}")
        lines = text.splitlines()
        stages = {ln.split(":")[0][len("[stage] "):]: float(ln.split(":")[1].split()[0])
                  for ln in lines if ln.startswith("[stage] ")}
        counts = {m.group(1): int(m.group(2)) for m in map(
            re.compile(r"^  (map\d \w[\w ]*|correspondences): (\d+)").match, lines) if m}
        files = sorted(os.listdir(dump))
        expect = sorted([f"map{i}_{k}.pcd" for i in (0, 1)
                         for k in ("downsampled", "inliers", "keypoints")]
                        + ["aligned_overlay.pcd"])
        require(files == expect and all(
            os.path.getsize(os.path.join(dump, f)) > 0 for f in files
        ), f"registration_visualisation: dump files {files}")
        # ICP's flag may be False: the reference's float32 Kabsch fails at
        # this size and ICP keeps the RANSAC pose (ROADMAP §3)
        require(len(stages) == 14 and len(counts) == 11 and all(
            n > 0 for n in counts.values()
        ) and "  ICP refined: ok=" in text,
            f"registration_visualisation: stages {list(stages)}, counts {counts}")
        log(f"registration_visualisation: {wall:.3f} s; StageTimes ms "
            f"{json.dumps(stages)}, sum {sum(stages.values())}; counts "
            f"{json.dumps(counts)}; dump files {files}")


def run_ranks(world: int, dev, fn, timeout_s: float = 900.0) -> list:
    """fn(rank, group) on `world` threads, each a rank of one gloo group
    built on one HashStore, each with `dev` as its current card; the
    results in rank order. A rank's failure is raised here."""
    import datetime
    import threading

    from torch.distributed import HashStore, ProcessGroupGloo

    store = HashStore()
    results: list = [None] * world
    errors: list = []

    def rank(r: int):
        try:
            torch.cuda.set_device(dev)
            group = ProcessGroupGloo(store, r, world, datetime.timedelta(seconds=timeout_s))
            results[r] = fn(r, group)
        except BaseException as e:  # re-raised below, on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout_s)
    require(not any(th.is_alive() for th in threads), "a rank is stuck")
    if errors:
        raise errors[0]
    return results


def run_config2_two_ranks(dev, kernels, views, truths, single, single_info) -> None:
    """Phase 12: eval config #2 over a two-rank mesh on the one card, held
    bit for bit against phase 7's single-rank transforms on the same views."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.parallel.mesh import make_mesh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    clouds = [PointCloud.from_numpy(x, r, capacity=CONFIG2_CAP, device=dev)
              for x, r in views]

    def rank(r, group):
        info: dict = {}
        out = estimate_maps_transforms(
            clouds, config2_params(), seed=0, mesh=make_mesh([dev], group),
            info_out=info,
        )
        torch.cuda.synchronize(dev)
        return out, info

    with first_launch_inputs(nn, spfh) as seen:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ranks = run_ranks(2, dev, rank)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    took = [info.pop("mesh") for _, info in ranks]
    log(f"config #2 over two ranks: {wall:.3f} s, launches {launches} (both "
        f"ranks), peak device memory {peak_gib:.2f} GiB, per rank "
        f"{json.dumps(took)}")
    require(launches["spfh"] == CONFIG2_MAPS and launches["nearest_neighbor"] == 0
            and "spfh_grid" in seen,
            f"config #2 over two ranks: launches {launches}, expected spfh "
            f"{CONFIG2_MAPS} through spfh_grid and nearest_neighbor 0")
    require_route("config #2, two ranks", launches, "grid", seen["pairs"])
    hold_on_path_inputs("config #2, two ranks", seen, nn, spfh, launches,
                        exact=True)
    hold_graph("config #2, two ranks", seen)
    for r, (out, info) in enumerate(ranks):
        require(len(out) == len(single) and all(
            np.array_equal(a, b) for a, b in zip(out, single)
        ), f"config #2 rank {r}: transforms differ from the single-rank run")
        require(info == single_info,
                f"config #2 rank {r}: info_out {info} != single-rank {single_info}")
    truth_err = chain_errors(ranks[0][0], truths)
    golden = json.loads((ROOT / "golden" / "config2.json").read_text())
    gold_err = golden_errors(ranks[0][0], golden)
    n_ok = sum(e is not None and e[0] < 2.0 and e[1] < 0.3 for e in truth_err)
    require(n_ok >= 4, f"config #2 over two ranks: only {n_ok} of 5 maps within 2 deg / 0.3 m")
    require(all(e is None or (e[0] < 2.0 and e[1] < 0.3) for e in gold_err),
            "config #2 over two ranks: golden pose gate (2 deg / 0.3 m) failed")
    log(f"config #2 over two ranks: both ranks bitwise equal to the single-rank "
        f"run, info_out equal; {n_ok} of 5 maps within 2 deg / 0.3 m of the truth")


def stateless_node_tick(watch, params, dev, mesh=None):
    """A stateless node (seed 0) over the maps in the directory `watch`:
    one discovery, estimation and compositing tick. Returns (robots it
    ingested, poses, merged points, estimation seconds)."""
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import DirectoryTransport

    node = MapMergeNode(DirectoryTransport(str(watch)), params, mesh=mesh, seed=0,
                        device=dev)
    node.discovery()
    t0 = time.perf_counter()
    node.transforms_estimation()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    est_s = time.perf_counter() - t0
    node.map_compositing()
    return node.get_robots(), node.get_transforms(), int(node.get_merged_map().count), est_s


def run_node_two_ranks(dev, kernels) -> None:
    """Phase 13: the stateless node over two ranks on config #1's views,
    each rank ingesting one robot through its own DirectoryTransport, the
    ticks in lockstep; held against one stateless node over both maps."""
    import tempfile

    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.io.pcd import write_pcd
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.parallel.mesh import make_mesh
    from mapmerge_torch.testing.scene import config1_scene

    va, vb, _, truth = config1_scene()
    params = config1_params()
    robots = ["robot0", "robot1"]
    with tempfile.TemporaryDirectory() as d:
        for r, (robot, view) in enumerate(zip(robots, (va, vb))):
            for watch in (Path(d) / f"rank{r}", Path(d) / "both"):
                watch.mkdir(exist_ok=True)
                write_pcd(watch / f"{robot}.pcd", view)

        def rank(r, group):
            return stateless_node_tick(Path(d) / f"rank{r}", params, dev,
                                       make_mesh([dev], group))

        with first_launch_inputs(nn, spfh) as seen:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            ranks = run_ranks(2, dev, rank)
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
        # one node over both maps as the transports read them (a .pcd holds
        # 8-bit colour)
        _, alone, _, _ = stateless_node_tick(Path(d) / "both", params, dev)
    label = "node stateless, two ranks"
    log(f"{label}: {wall:.3f} s (estimation ticks {[x[3] for x in ranks]} s), "
        f"launches {launches}, merged maps {[x[2] for x in ranks]} points")
    require(launches["spfh"] > 0, f"{label}: kernel spfh was not launched")
    require_route(label, launches, "batched", seen["pairs"])
    hold_on_path_inputs(label, seen, nn, spfh, launches, exact=True)
    hold_graph(label, seen)
    (s0, p0, n0, _), (s1, p1, n1, _) = ranks
    require([s0, s1] == [robots[:1], robots[1:]], f"{label}: ranks ingested {s0}, {s1}")
    require(sorted(p0) == sorted(p1) == robots and all(
        np.array_equal(p0[r], p1[r]) for r in robots
    ), f"{label}: the ranks hold different poses")
    require(n0 == n1 > 0, f"{label}: merged maps of {n0} and {n1} points")
    require(all(np.array_equal(p0[r], alone[r]) for r in robots),
            f"{label}: poses differ from one stateless node over both maps")
    rot, trans = tf.pose_error(np.linalg.inv(p0["robot0"]) @ p0["robot1"], truth)
    log(f"{label}: both ranks bitwise equal to one stateless node over the same "
        f"two maps; pose vs truth {rot} deg, {trans} m")
    require(rot < 1.0 and trans < 0.1, f"{label}: pose gate 1 deg / 0.1 m failed")


#: eval config #3 (bench_configs.py:306-348): two LiDAR-style town views
CONFIG3_VIEW_POINTS = 1_840_730
CONFIG3_CAP = 1 << 21


def config3_params():
    """bench_configs.py:318: _big_params(1 << 20) with 1024 hypotheses
    (config #2's params; the replace mirrors the reference's)."""
    return config2_params().replace(ransac_hypotheses=1024)


def run_config3(dev, kernels) -> None:
    """Phase 14: eval config #3, the JAX package's largest pair, through
    the library's lower entry points."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.ops import icp
    from mapmerge_torch.pipeline import features, merging, registration
    from mapmerge_torch.testing.scene import town_views

    t0 = time.perf_counter()
    views, truths = town_views(2, 800_000, keep=0.75, seed=9)
    sizes = [len(v[0]) for v in views]
    require(sizes == [CONFIG3_VIEW_POINTS] * 2, f"config #3 views have {sizes} points")
    clouds = [PointCloud.from_numpy(x, r, capacity=CONFIG3_CAP, device=dev)
              for x, r in views]
    del views
    params = config3_params()
    truth = np.linalg.inv(truths[1]) @ truths[0]
    log(f"config #3: 2 views of {sizes[0]} points, capacity {CONFIG3_CAP}, "
        f"max_points {params.max_points}; made in {time.perf_counter() - t0:.3f} s")

    def register():
        fa = features.extract_features(clouds[0], params)
        fb = features.extract_features(clouds[1], params)
        est = registration.estimate_transform(
            fa, fb, params, merging.seeded_generator([0], dev))
        return fa, fb, est

    # ICP's iterations (one 1-NN query each, grid or dense) and its flag
    icp_run = {"iterations": 0, "ok": None}

    def count(fn):
        def wrapper(*args, **kwargs):
            icp_run["iterations"] += 1
            return fn(*args, **kwargs)

        return wrapper

    def keep_flag(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            icp_run["ok"] = out[1]
            return out

        return wrapper

    icp_probe = {(icp, "grid_nn_query"): count, (icp, "nearest_neighbor"): count,
                 (registration, "icp_refine"): keep_flag}
    with first_launch_inputs(nn, spfh) as seen, patched(icp_probe):
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        fa, fb, est = register()
        cold = est.transform.cpu().numpy()
        cold_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    counters = [feature_counters(f) for f in (fa, fb)]
    del fa, fb
    log(f"config #3 cold run: {cold_s:.3f} s, launches {launches} (nearest_neighbor "
        f"expected 0: ICP and the score take the grid), peak device memory "
        f"{peak_gib:.2f} GiB")
    log(f"config #3 feature stage per cloud (scan_overflow: the fullest probe "
        f"bucket beyond grid_scan_cap {params.grid_scan_cap} at "
        f"{params.descriptor_radius} m or registration_scan_cap "
        f"{params.registration_scan_cap} at {params.max_correspondence_distance} "
        f"m): {json.dumps(counters)}")
    log(f"config #3 pair: ok {bool(est.ok)}, confidence {float(est.confidence)}, "
        f"inliers {int(est.inlier_count)}, coverage {float(est.coverage)}, "
        f"dropped source queries (scan_overflow) {int(est.scan_overflow)}; ICP ok "
        f"{icp_run['ok']} after {icp_run['iterations']} iterations")
    require(launches["spfh"] == 2 and "spfh_grid" in seen
            and launches["nearest_neighbor"] == 0,
            f"config #3: launches {launches}, expected spfh 2 through spfh_grid "
            "(one a cloud) and nearest_neighbor 0")
    require_route("config #3", launches, "grid", seen["pairs"])
    hold_on_path_inputs("config #3", seen, nn, spfh, launches, exact=True)
    hold_harris_keypoints("config #3", seen)
    hold_harris_route("config #3", seen)
    hold_graph("config #3", seen, solves=False)

    require(cold.shape == (4, 4) and np.isfinite(cold).all() and bool(est.ok),
            "config #3: no finite registration")
    rot, trans = tf.pose_error(cold, truth)
    log(f"config #3 pose vs truth: {rot} deg, {trans} m")
    require(rot < 2.0 and trans < 0.3, "config #3: pose gate 2 deg / 0.3 m failed")

    t0 = time.perf_counter()
    warm = register()[2].transform.cpu().numpy()
    warm_s = time.perf_counter() - t0
    recorder = stage_recorder(config2_stages(), (features, "extract_features"),
                              (registration, "estimate_transform"))
    with recorder as rec, harris_split() as split:
        staged = register()[2].transform.cpu().numpy()
    for label, out in (("warm", warm), ("stage-timed", staged)):
        require(np.array_equal(out, cold),
                f"config #3: the {label} run gave another transform than the cold run")
    log(f"config #3 wall s: cold {cold_s}, warm {warm_s}; the warm and the "
        "stage-timed run bitwise equal to the cold run")
    log(f"config #3 stage ms of one run (2 clouds, 1 pair): {json.dumps(rec['ms'])}, "
        f"sum {sum(rec['ms'].values())}")
    log_harris_split("config #3", split)


#: eval config #4 (bench_configs.py:351-369): 20 views of one town
CONFIG4_MAPS, CONFIG4_VIEW_POINTS = 20, 9_745
#: seconds a rank process of phase 15 may run; also its collectives' timeout
RANK_TIMEOUT_S = 300.0
#: the JAX package's stateless node (seed 0) on distributed_node_case's
#: maps, on the CPU: RANSAC alone misses 1 deg there, as the port does, so
#: phase 15 gates the node at tests/test_distributed_node.py's 3 deg and the
#: 0.1 m that both packages meet (ROADMAP.md §3)
NODE_JAX_ERROR = (1.5920073986053467, 0.0770241990685463)


def config4_params():
    """bench_configs.py:362-367: SIFT (3.0) + FPFH, ICP <= 30, max_points
    8192, K 384, M 48, 768 hypotheses, tile 256."""
    from mapmerge_torch.pipeline.merging import MergeParams

    return MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=30, max_points=8192,
        max_keypoints=384, max_neighbors=48, ransac_hypotheses=768,
        neighbor_tile=256,
    )


def raw_clouds(views, dev) -> list:
    """The views as clouds at their raw capacity, the next power of two
    above the largest (bench_configs._config4_fixture)."""
    from mapmerge_torch.core.cloud import PointCloud

    cap = 1 << int(np.ceil(np.log2(max(len(x) for x, _ in views))))
    return [PointCloud.from_numpy(x, r, capacity=cap, device=dev) for x, r in views]


def distributed_node_case():
    """tests/test_distributed_node.py:45-66: the box scene's views a and b
    (robot_a, robot_b), b moved by the truth, and that test's params
    (Harris + FPFH, RANSAC alone): (views by robot, truth, params)."""
    from mapmerge_torch.pipeline.merging import MergeParams
    from mapmerge_torch.testing.scene import make_scene, overlapping_views, rotation_z, se3

    xyz, rgb = make_scene(np.random.default_rng(7), n_boxes=6, extent=8.0, density=40.0)
    truth = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
    va, vb, _ = overlapping_views(np.random.default_rng(3), xyz, rgb, truth, overlap=0.65)
    params = MergeParams(
        keypoint_type="HARRIS", keypoint_threshold=5.0, descriptor_type="FPFH",
        refine_transform=False, max_points=4096, max_keypoints=128,
        max_neighbors=32, ransac_hypotheses=256, neighbor_tile=256,
    )
    return {"robot_a": va, "robot_b": vb}, truth, params


def rank_job(rank: int, world: int, address, dev, workdir, merge, node) -> None:
    """One rank of phase 15: join the job (initialize is a no-op at world
    1), merge `merge` = (views, params) over global_mesh(), then run the
    stateless node over `node` = (views by robot, params), this rank
    ingesting every world-th robot from rank on through its own
    DirectoryTransport under `workdir`, in lockstep with the other ranks.
    On the card each path's kernels are held on their first-launch inputs
    here. Prints one JSON line: the transforms, info_out (its "mesh" apart),
    the node's robots, poses and merged points, the launch counts, the
    kernel holds, the peak memory, the walls and the modules of JAX or
    mapmerge_tpu loaded."""
    from mapmerge_torch.io.pcd import write_pcd
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.parallel import multihost
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms

    t_start = time.perf_counter()
    kernels = all_kernels()
    on_card = dev.type == "cuda"
    multihost.initialize(address, world, rank, timeout=RANK_TIMEOUT_S)
    mesh = multihost.global_mesh(None if on_card else [dev])
    out: dict = {"rank": mesh.rank, "world": mesh.world,
                 "devices": [str(d) for d in mesh.devices]}
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def launched(label, fn):
        with first_launch_inputs(nn, spfh) as seen:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            result = fn()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
        if on_card:
            hold_on_path_inputs(label, seen, nn, spfh, launches, exact=True)
        hold_graph(label, seen)
        return result, launches, wall

    views, params = merge
    clouds = raw_clouds(views, dev)
    info: dict = {}
    transforms, out["merge_launches"], out["merge_s"] = launched(
        f"config #4, rank {rank}",
        lambda: estimate_maps_transforms(clouds, params, seed=0, mesh=mesh, info_out=info))
    out["mesh"] = info.pop("mesh")
    out["transforms"] = [t.tolist() for t in transforms]
    out["info"] = info

    node_views, node_params = node
    watch = Path(workdir) / f"rank{rank}"
    watch.mkdir(parents=True, exist_ok=True)
    for robot in sorted(node_views)[rank::world]:
        write_pcd(watch / f"{robot}.pcd", node_views[robot])
    tick, out["node_launches"], _ = launched(
        f"node two processes, rank {rank}",
        lambda: stateless_node_tick(watch, node_params, dev, mesh))
    out["node"] = dict(zip(("robots", "poses", "merged_points", "estimation_s"), tick))
    out["node"]["poses"] = {r: t.tolist() for r, t in tick[1].items()}
    out["kernels"] = {label: PATH_STATS[label] for label in PATH_STATS}
    out["graph"] = GRAPH_STATS
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    out["loaded"] = sorted(m for m in sys.modules
                           if m.startswith("jax") or m.startswith("mapmerge_tpu"))
    out["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, workdir) -> list[dict]:
    """`world` rank processes of this script (`--rank-job`), joined at a
    free local port; each one's JSON line, in rank order. A rank that
    fails or outlasts RANK_TIMEOUT_S kills every rank and fails the run."""
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-job", str(r), str(world),
         address, str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
    ) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    lines = []
    try:
        for r, proc in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"chip_smoke: rank {r} did not finish in "
                                   f"{RANK_TIMEOUT_S} s") from None
            require(proc.returncode == 0, f"rank {r} exited with code "
                    f"{proc.returncode}:\n{stderr[-4000:]}")
            lines.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return lines


#: the batched estimate of a pair against register_pair on the same pair:
#: ok flags equal, poses within this many deg and m (tests/
#: test_torch_pairs_batch.py's PAIR_TOL: the two round Kabsch's 3x3
#: products and the sums over the points differently, which an ICP that runs
#: to its iteration cap carries along its oscillation; a few times the
#: largest gap seen, 0.040 deg / 1.9 mm, and under the 1 deg / 0.1 m gates)
PAIR_TOL = (0.2, 0.02)


@contextlib.contextmanager
def first_chunk():
    """Keep the arguments and results of the first merging.register_chunk
    call while a path runs."""
    from mapmerge_torch.pipeline import merging

    kept: dict = {}

    def keep(fn):
        def wrapper(sources, targets, params, seed, pairs):
            out = fn(sources, targets, params, seed, pairs)
            if not kept:
                kept.update(sources=sources, targets=targets, seed=seed,
                            pairs=pairs, out=out)
            return out

        return wrapper

    with patched({(merging, "register_chunk"): keep}):
        yield kept


def against_one_pair(label: str, chunk: dict, params, n: int) -> None:
    """The first `n` pairs of a recorded chunk registered again one at a
    time (merging.register_pair, on the same features and generators):
    the same ok flags (a zero matrix is a failure) and poses within
    PAIR_TOL; the largest difference and the pairs that differ at all are
    printed. These launches come after the path's counts were read."""
    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.pipeline.merging import register_pair

    pairs = chunk["pairs"][:n]
    require(len(pairs) == n, f"{label}: the first chunk holds {len(chunk['pairs'])} pairs")
    worst, differ, n_ok, beyond = (0.0, 0.0), 0, 0, 0
    t0 = time.perf_counter()
    for b, (k, i, j) in enumerate(pairs):
        alone, over = register_pair(chunk["sources"][b], chunk["targets"][b], params,
                                    chunk["seed"], i, j, k)
        est, b_over = chunk["out"][b]
        ok = bool(est.transform.any())
        require(ok == bool(alone.transform.any()),
                f"{label}: pair ({i}, {j}) ok {ok} batched, {not ok} alone")
        differ += not np.array_equal(est.transform, alone.transform)
        if ok:
            n_ok += 1
            gap = tf.pose_error(est.transform, alone.transform)
            worst = (max(worst[0], gap[0]), max(worst[1], gap[1]))
            beyond += gap[0] > 0.05 or gap[1] > 0.005
    one_s = time.perf_counter() - t0
    log(f"{label}: the first {n} pairs batched against register_pair alone ({one_s:.3f} s): "
        f"ok flags equal ({n_ok} ok), {differ} transforms differ in any bit, "
        f"{beyond} by more than 0.05 deg / 5 mm, largest "
        f"difference {worst[0]} deg / {worst[1]} m (tolerance {PAIR_TOL[0]} deg / "
        f"{PAIR_TOL[1]} m)")
    require(worst[0] <= PAIR_TOL[0] and worst[1] <= PAIR_TOL[1],
            f"{label}: batched and one-pair poses differ by {worst}")


def run_config4_two_processes(dev, kernels) -> None:
    """Phase 15: eval config #4 and the distributed node over two rank
    processes on the one card, held against this process's single-rank
    runs."""
    import tempfile

    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.io.pcd import write_pcd
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.testing.scene import town_views

    views, truths = town_views(CONFIG4_MAPS, 4096, seed=3)
    sizes = [len(x) for x, _ in views]
    require(sizes == [CONFIG4_VIEW_POINTS] * CONFIG4_MAPS,
            f"config #4 views have {sizes} points")
    params = config4_params()
    clouds = raw_clouds(views, dev)
    info: dict = {}
    with first_launch_inputs(nn, spfh) as seen, first_chunk() as chunk:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        single = estimate_maps_transforms(clouds, params, seed=0, info_out=info)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"config #4, one rank: {CONFIG4_MAPS} views of {sizes[0]} points, capacity "
        f"{clouds[0].capacity}: {wall:.3f} s, launches {launches}, info_out {info}, "
        f"peak device memory {peak_gib:.2f} GiB")
    require(launches["spfh"] > 0, "config #4: kernel spfh was not launched")
    require_route("config #4", launches, "batched", seen["pairs"])
    hold_on_path_inputs("config #4", seen, nn, spfh, launches, exact=True)
    hold_graph("config #4", seen)
    against_one_pair("config #4", chunk, params, 20)
    require(len(single) == CONFIG4_MAPS and all(
        t.shape == (4, 4) and np.isfinite(t).all() for t in single
    ), "config #4: transforms are not 20 finite 4x4 matrices")
    hops = adjacent_errors(single, truths)
    per_map = chain_errors(single, truths)
    n_hops = sum(1 for rot, trans in hops if rot < 5.0 and trans < 0.5)
    n_maps = sum(1 for e in per_map if e is not None and e[0] < 1.0 and e[1] < 0.1)
    log(f"config #4: {n_hops} of {len(hops)} adjacent hops within 5 deg / 0.5 m, "
        f"{n_maps} of {CONFIG4_MAPS} maps within 1 deg / 0.1 m, drift "
        f"{max(e for e in per_map if e is not None)}; per map {per_map}")
    require(n_hops >= 14, f"config #4: {n_hops} adjacent hops ok, gate 14")
    require(n_maps >= 18, f"config #4: {n_maps} maps within 1 deg / 0.1 m, gate 18")

    node_views, node_truth, node_params = distributed_node_case()
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "both").mkdir()
        for robot, view in node_views.items():
            write_pcd(Path(d) / "both" / f"{robot}.pcd", view)
        _, alone, n_alone, _ = stateless_node_tick(Path(d) / "both", node_params, dev)
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, Path(d) / "ranks")
        ranks_s = time.perf_counter() - t0
    label = "config #4, two processes"
    log(f"{label}: {ranks_s:.3f} s for both rank processes (start-up included); "
        f"per rank " + json.dumps([{
            **{k: x[k] for k in ("rank", "world", "devices", "merge_s", "merge_launches",
                                 "node_launches", "peak_gib", "wall_s")},
            "gather_s": x["mesh"]["gather_s"], "clouds": len(x["mesh"]["clouds"]),
            "pairs": len(x["mesh"]["pairs"])} for x in ranks]))
    want_info = json.loads(json.dumps(info))
    for r, x in enumerate(ranks):
        require(x["rank"] == r and x["world"] == 2 and not x["loaded"],
                f"rank {r}: rank {x['rank']} of {x['world']}, loaded {x['loaded']}")
        require(all(np.array_equal(np.asarray(t, np.float32), s)
                    for t, s in zip(x["transforms"], single))
                and len(x["transforms"]) == len(single),
                f"{label}: rank {r}'s transforms differ from the single-rank merge")
        require(x["info"] == want_info,
                f"{label}: rank {r}'s info_out {x['info']} != single-rank {want_info}")
        require(x["merge_launches"]["spfh"] > 0, f"{label}: spfh not launched on rank {r}")
        require_route(f"config #4, rank {r}", x["merge_launches"], "batched")
        PATH_STATS.update(x["kernels"])
        require(sorted(x["graph"]) == [f"config #4, rank {r}",
                                       f"node two processes, rank {r}"],
                f"rank {r}: tree solves held on {sorted(x['graph'])}")
        GRAPH_STATS.update(x["graph"])
    robots = sorted(node_views)
    node_launches = {name: sum(x["node_launches"][name] for x in ranks)
                     for name in launches}
    for r, x in enumerate(ranks):
        nd = x["node"]
        require(nd["robots"] == robots[r::2] and sorted(nd["poses"]) == robots,
                f"node, rank {r}: robots {nd['robots']}, poses of {sorted(nd['poses'])}")
        require(all(np.array_equal(np.asarray(nd["poses"][k], np.float32), alone[k])
                    for k in robots),
                f"node, rank {r}: poses differ from one stateless node over both maps")
        require(nd["merged_points"] == n_alone > 1000,
                f"node, rank {r}: merged map of {nd['merged_points']} points, one "
                f"node {n_alone}")
    require(node_launches["spfh"] > 0, "node, two processes: spfh was not launched")
    require_route("node two processes", node_launches, "batched")
    rot, trans = tf.pose_error(np.linalg.inv(alone["robot_a"]) @ alone["robot_b"],
                               node_truth)
    log(f"{label}: both ranks bitwise equal to the single-rank merge, info_out "
        f"equal; the node over two processes (estimation ticks "
        f"{[x['node']['estimation_s'] for x in ranks]} s, launches {node_launches}) "
        f"bitwise equal to one node over both maps, merged maps {n_alone} points; "
        f"pose vs truth {rot} deg, {trans} m (1 deg / 0.1 m not gated: the JAX "
        f"package's node gives {NODE_JAX_ERROR[0]} deg / {NODE_JAX_ERROR[1]} m here)")
    require(rot < 3.0 and trans < 0.1, f"{label}: node pose gate 3 deg / 0.1 m failed")


#: config5 (bench_configs.py:615-675): 50 views of one town, 10 a tick
CONFIG5S_MAPS, CONFIG5S_BATCH, CONFIG5S_VIEW_POINTS = 50, 10, 6_747


def config5_params():
    """bench_configs.py:633-638: SIFT (3.0) + FPFH, ICP <= 20, max_points
    4096, K 128, M 32, 256 hypotheses, tile 256."""
    from mapmerge_torch.pipeline.merging import MergeParams

    return MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0, descriptor_type="FPFH",
        refine_transform=True, max_iterations=20, max_points=4096,
        max_keypoints=128, max_neighbors=32, ransac_hypotheses=256,
        neighbor_tile=256,
    )


def run_config5(dev, kernels) -> None:
    """Phase 16: config5, the 50-map stream through the stateless node,
    which registers every pair anew on each tick."""
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.parallel import pair_shard
    from mapmerge_torch.pipeline import merging, registration
    from mapmerge_torch.runtime import node as node_module
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport
    from mapmerge_torch.testing.scene import town_views

    n = CONFIG5S_MAPS
    views, truths = town_views(n, 2048, seed=5)
    sizes = [len(x) for x, _ in views]
    require(sizes == [CONFIG5S_VIEW_POINTS] * n, f"config5 views have {sizes} points")
    params = config5_params()

    def tick(node, transport, start):
        for i in range(start, start + CONFIG5S_BATCH):
            transport.publish(f"robot_{i:02d}", *views[i])
        node.discovery()
        node.transforms_estimation()
        node.map_compositing()
        torch.cuda.synchronize(dev)

    stages = (
        (pair_shard, "extract_features", "features"),
        (merging, "estimate_pairs_batch", "pair registrations"),
        (registration, "find_correspondences", "matching"),
        (registration, "ransac_transform", "RANSAC"),
        (registration, "icp_refine", "ICP"),
        (registration, "transform_score", "score"),
        (merging, "compute_global_transforms", "tree solve (native)"),
        (merging, "refine_global_transforms", "refinement"),
        (node_module, "compose_maps", "compositing"),
    )
    transport = InProcTransport()
    node = MapMergeNode(transport, params, seed=0, device=dev)
    ticks = []
    recorder = stage_recorder(stages, (pair_shard, "extract_features"),
                              (merging, "estimate_pairs_batch"))
    icp_loops = []  # per chunk: (pairs, loop iterations, iterations summed over pairs)

    def keep_iterations(fn):
        def wrapper(*args, **kwargs):
            info = {}
            out = fn(*args, info_out=info, **kwargs)
            it = info["iterations"]
            icp_loops.append((int(it.numel()), int(it.max()), int(it.sum())))
            return out

        return wrapper

    last_call = {}  # the node's last estimate_maps_transforms call

    def keep_call(fn):
        def wrapper(clouds, *args, **kwargs):
            out = fn(clouds, *args, **kwargs)
            last_call.update(clouds=clouds, args=args, kwargs=kwargs, out=out)
            return out

        return wrapper

    with first_launch_inputs(nn, spfh) as seen, recorder as rec, first_chunk() as chunk, \
            patched({(node_module, "estimate_maps_transforms"): keep_call,
                     (registration, "icp_refine"): keep_iterations}):
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t_stream = time.perf_counter()
        for start in range(0, n, CONFIG5S_BATCH):
            before = dict(rec["ms"])
            t0 = time.perf_counter()
            tick(node, transport, start)
            ticks.append({"maps": start + CONFIG5S_BATCH,
                          "s": time.perf_counter() - t0,
                          **{k: v - before.get(k, 0.0) for k, v in rec["ms"].items()}})
            if start == 0:
                first_tick = node.get_transforms()
        wall = time.perf_counter() - t_stream
        launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"config5 stream: {wall:.3f} s, {n / wall} maps a second, launches "
        f"{launches}, {len(rec['pairs'])} pair registrations in "
        f"{rec['calls'].get('pair registrations', 0)} chunks, "
        f"{rec['calls'].get('features', 0)} feature extractions, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"config5 ticks (s; stage ms): {json.dumps(ticks)}")
    log("config5 feature overflow, keypoints truncated, pairs ok: "
        f"{sum(c['scan_overflow'] for c in rec['clouds'])}, "
        f"{sum(c['keypoints_truncated'] for c in rec['clouds'])}, "
        f"{sum(p['ok'] for p in rec['pairs'])} of {len(rec['pairs'])}")
    log("config5 ICP per chunk (pairs, loop iterations, iterations summed over "
        f"the pairs): {json.dumps(icp_loops)}; batched nn launches expected "
        f"{sum(it for _, it, _ in icp_loops) + len(icp_loops)} (one an ICP iteration "
        "and one a score, a chunk)")
    require(launches["spfh"] > 0 and "spfh" in seen,
            f"config5: launches {launches}, expected spfh in shared mode")
    require_route("config5", launches, "batched", seen["pairs"])
    hold_on_path_inputs("config5", seen, nn, spfh, launches, exact=True)
    hold_graph("config5", seen)
    against_one_pair("config5, first tick", chunk, params, CONFIG5S_BATCH * (CONFIG5S_BATCH - 1) // 2)

    # the last tick is estimate_maps_transforms on the node's clouds: the
    # clouds it passed are those built here from the transport, bit for
    # bit, and its poses are what the call returned (a second call on the
    # same clouds would repeat 1,225 registrations; the second node below
    # shows that a tick repeats bit for bit)
    robots, clouds = stateless_clouds(node)
    poses = node.get_transforms()
    ordered = [poses[f"robot_{i:02d}"] for i in range(n)]
    passed = last_call["clouds"]
    require(robots == [f"robot_{i:02d}" for i in range(n)] and len(passed) == n
            and all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                    for a, b in zip(passed, clouds) for f in dataclasses.fields(a)),
            "config5: the last tick's clouds differ from the node's clouds")
    require(last_call["args"] == (params,) and last_call["kwargs"]["seed"] == 0
            and last_call["kwargs"]["mesh"] is None and all(
                np.array_equal(poses[r], t) for r, t in zip(robots, last_call["out"])),
            "config5: the last tick's poses are not estimate_maps_transforms' "
            "on its clouds")
    registered = sum(1 for t in ordered if t.any())
    hops = adjacent_errors(ordered, truths)
    n_hops = sum(1 for rot, trans in hops if rot < 8.0 and trans < 0.5)
    drift = max(e for e in chain_errors(ordered, truths) if e is not None)
    n_merged = int(node.get_merged_map().count)
    log(f"config5: {registered}/{n} maps registered, {n_hops}/{len(hops)} adjacent "
        f"hops within 8 deg / 0.5 m, drift {drift[0]} deg / {drift[1]} m, merged "
        f"map {n_merged} points; the last tick bitwise estimate_maps_transforms "
        f"on the node's {clouds[0].capacity}-point clouds")
    log(f"config5 adjacent hop errors (deg, m): {hops}")
    require(len(poses) == n and registered >= 35,
            f"config5: {registered} of {len(poses)} maps registered, gate 35 of 50")
    require(n_hops >= 38, f"config5: {n_hops} adjacent hops ok, gate 38")
    require(drift[0] < 10.0 and drift[1] < 0.5, "config5: drift gate 10 deg / 0.5 m failed")
    require(n_merged > 1000, f"config5: merged map of {n_merged} points")

    again_transport = InProcTransport()
    again = MapMergeNode(again_transport, params, seed=0, device=dev)
    tick(again, again_transport, 0)
    second = again.get_transforms()
    require(sorted(second) == sorted(first_tick) and all(
        np.array_equal(second[r], first_tick[r]) for r in first_tick
    ), "config5: a second node's first batch gave other poses than the first tick")
    log(f"repeat check (config5): a second node's first batch ({CONFIG5S_BATCH} "
        "maps) bitwise equal to the first tick")


#: the path whose run gives each kernel's launches and main numbers: the
#: batch route of config #1 for the batched entry and for spfh; the one-pair
#: entry's dense path, the incremental node on config #1's views (cut to
#: 32,768 points, config #1's shapes), since config #1's pairs now batch
MAIN_PATH = {"nearest_neighbor": "node incremental",
             "nearest_neighbor_batched": "config #1", "spfh": "config #1",
             "tiles_pack": "config #1", "sift_scale_space": "config #1",
             "sift_knn": "config #1", "radius_count": "config #1",
             "radius_moments": "config #1", "radius_order": "config #1",
             "grid_nn": "config #2",
             "grid_moments": "config #2", "grid_count": "config #2",
             "grid_smooth": "config5_big", "grid_knn": "config5_big",
             "grid_pack": "config #2", "grid_reduce": "config #2",
             "grid_reduce_list": "config #2"}


def all_kernels() -> tuple:
    """Every hand-written kernel, in the order of the `kernels` line: A's
    one-pair and batched entries, B, the pre-pass, C, D, E, F, E's and F's
    order pre-pass, G, H, I, J, K, the pre-pass of G-L and L's sweep and
    list routes."""
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.kernels import sift as ksift
    from mapmerge_torch.kernels import tiles as ktiles

    return (nn.KERNEL, nn.BATCHED_KERNEL, spfh.KERNEL, ktiles.PACK_KERNEL,
            ksift.SCALE_SPACE_KERNEL, ksift.KNN_KERNEL, kradius.COUNT_KERNEL,
            kradius.MOMENTS_KERNEL, kradius.ORDER_KERNEL, kgrid.NN_KERNEL, kgrid.MOMENTS_KERNEL,
            kgrid.COUNT_KERNEL, kgrid.SMOOTH_KERNEL, kgrid.KNN_KERNEL, kgrid.PACK_KERNEL,
            kgrid.REDUCE_KERNEL, kgrid.REDUCE_LIST_KERNEL)


def kernel_entry(k, stats: dict) -> dict:
    """A kernel's entry of the line before the last: its launches and
    numbers on its main path's own inputs (MAIN_PATH), then per path and on
    the synthetic shapes. library_ms is nn_library's time on kernel A's
    main-path inputs (one route to the same 1-NN, not held for bits),
    knn_library's on kernel D's and count_library's on kernel E's; for G,
    I and K nn_library's, count_library's and knn_library's time on 4,096
    of the answered queries, scaled to all of them (grid_library_stats: the
    whole plane would not fit), for L's routes `(cdist <= r).float() @
    values` so (reduce_library_stats); null for kernel B (nothing in PyTorch bins
    Darboux features), kernels C and J (no single call smooths over a
    radius), kernels F and H (none sums neighbourhood moments) and the
    pre-passes (no single call packs points and tile boxes, or boxes and
    work units)."""
    label = MAIN_PATH[k.name]
    main = PATH_STATS[label][k.name]
    errs = [stats[k.name]["max_abs_err"]] + [
        ps[k.name]["max_abs_err"] for ps in PATH_STATS.values() if k.name in ps
    ]
    return {
        "name": k.name, "route": k.route, "source": k.source,
        "replaces": k.replaces, "launches": main["launches"],
        "max_abs_err": max(errs), "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main.get("library_ms"),
        "main_path": label, "shape": main["shape"],
        "paths": {label: ps[k.name] for label, ps in PATH_STATS.items()
                  if k.name in ps},
        "synthetic": stats[k.name],
    }


def reduce_ptxas(build) -> dict:
    """The ptxas report of each of kernel L's instantiations in grid.cu's
    build log (its sum's grid_radius_kernel<ReduceOp<C>>, its max's
    grid_max_kernel<C>, its list route's grid_reduce_list_kernel<max, C>;
    C = 0 the generic width): registers a thread, spill stores and loads,
    stack frame and static shared memory, by the demangled name where
    c++filt is found."""
    import re
    import shutil
    import subprocess

    report = build.library_path("grid.cu").with_suffix(".log")
    if not report.exists():
        return {}
    out, name = {}, None
    for line in report.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if re.search(
                r"ReduceOp|grid_max_kernel|grid_reduce_list_kernel", m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            smem=int(smem.group(1)) if smem else 0)
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(out):
            out = {re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]: v
                   for n, v in zip(names, out.values())}
    return out


def phase(label: str, fn, *args):
    """fn(*args), its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.3f} s")
    return out


def rank_main(argv: list[str]) -> int:
    """`--rank-job RANK WORLD ADDRESS WORKDIR`: one rank process of phase 15
    (rank_job on config #4's views and the distributed node's scene)."""
    rank, world, address, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    require(torch.cuda.is_available(), f"rank {rank}: no CUDA device")
    import mapmerge_torch  # noqa: F401  (sets the TF32 flags off)
    from mapmerge_torch.kernels import build
    from mapmerge_torch.testing.scene import town_views

    build.load()
    views, _ = town_views(CONFIG4_MAPS, 4096, seed=3)
    node_views, _, node_params = distributed_node_case()
    rank_job(rank, world, address, torch.device("cuda", torch.cuda.current_device()),
             workdir, (views, config4_params()), (node_views, node_params))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank-job"]:
        return rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")
    t_main = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    import mapmerge_torch  # noqa: F401  (sets the TF32 flags off)
    from mapmerge_torch import native
    from mapmerge_torch.kernels import build, nn, spfh
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.kernels import sift as ksift

    require(
        not torch.backends.cuda.matmul.allow_tf32
        and not torch.backends.cudnn.allow_tf32,
        "TF32 is on",
    )

    t0 = time.perf_counter()
    build.load(build.HOST_SOURCES)
    log(f"native library build (g++) + load: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(build.library_path(s).name for s in build.HOST_SOURCES)})")
    t0 = time.perf_counter()
    build.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(build.library_path(s).name for s in build.KERNEL_SOURCES)})")
    for source in build.KERNEL_SOURCES:
        report = build.library_path(source).with_suffix(".log")
        if report.exists():
            log(report.read_text().strip())
    log(f"kernel L's instantiations (ptxas -v): {json.dumps(reduce_ptxas(build))}")

    stats = {"nearest_neighbor": check_nn(dev, nn),
             "nearest_neighbor_batched": check_nn_batched(dev, nn),
             "spfh": check_spfh(dev, spfh), **check_sift(dev, ksift),
             **check_radius(dev, kradius), **check_grid(dev, kgrid),
             **check_grid_sift(dev, kgrid), **check_grid_reduce(dev, kgrid)}
    kernels = all_kernels()
    phase("4 (config #1)", run_main_path, dev, kernels)
    phase("5 (config1_pfh)", run_default_operating_point, dev, kernels)
    phase("6 (registry sweep)", run_registry_sweep, dev, kernels)
    config2 = phase("7 (config #2)", run_config2, dev, kernels)
    phase("8-9 (node on config #1)", run_node_config1, dev, kernels)
    phase("10 (config5_big)", run_config5_big, dev, kernels)
    phase("11 (offline tools)", run_offline_tools, dev, kernels)
    phase("12 (config #2, two ranks)", run_config2_two_ranks, dev, kernels, *config2)
    del config2
    phase("13 (node, two ranks)", run_node_two_ranks, dev, kernels)
    phase("14 (config #3)", run_config3, dev, kernels)
    phase("15 (config #4, two processes)", run_config4_two_processes, dev, kernels)
    phase("16 (config5)", run_config5, dev, kernels)

    loaded = sorted(m for m in sys.modules
                    if m.startswith("jax") or m.startswith("mapmerge_tpu"))
    require(not loaded, f"modules of JAX or mapmerge_tpu were loaded: {loaded}")

    log(f"pair routes per path: {json.dumps(ROUTES)}")
    log(f"chip_smoke: {time.perf_counter() - t_main:.1f} s from the start of main")
    print(json.dumps({"native": {
        "functions": [{"name": c.name, "source": c.source, "replaces": c.replaces}
                      for c in (native.GRAPH_SOLVE, native.LZF_DECOMPRESS)],
        "graph": GRAPH_STATS, "lzf": LZF_STATS,
    }}))
    print(card)
    print(json.dumps({"kernels": [kernel_entry(k, stats) for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
