"""Dense against cell-grid engine on the card, at the sizes where "auto"
switches between them.

    python3 -m mapmerge_torch.testing.grid_crossover [SIZE ...]

For each size (default 65,536, 131,072 and 262,144 points) the script cuts
a cloud from eval config #2's first view, voxel-downsampled at 0.1 m as the
feature stage does: the points nearest one corner of the map (smallest
x + y), kept in the view's voxel order, so the cloud keeps the map's
density and the order the feature stage gives its clouds. On it, each
engine runs one radius_count at the descriptor radius (0.8 m, the outlier
pass), one neighbor_moments at the normal radius (0.6 m) and one bounded
nearest_neighbor at the correspondence bound (1.0 m) of the cloud moved by
a small rotation and shift against itself (ICP and the score), with the
default scan caps (128, and 256 for the 1-NN). The dense engine's radius
ops run kernels E and F (kernels/radius.py), the grid engine's ops kernels
G, H and I (kernels/grid.py); engines "plain" and "grid plain" are the same
ops through those kernels' plain versions, the routes before them.
Prints the card; for the whole view, at each of those radii, the fullest
bucket and the points the cap drops (the grid the pipeline builds at
capacity 2^20); then one JSON line per (size, op, engine): the median of 5
timed calls after one warm-up (CUDA events around the call, host work
included) and how many queries it answers otherwise than the dense engine
(the grid's bucket caps; counts only for neighbor_moments); the dense
engine's radius lines add the members its queries count and the bound of
kernel E or F on them (chip_smoke.py's radius_count_bound and
radius_moments_bound: the bytes over 3.35 TB/s, 9 float32 operations a
member and 16 more for F, over 67 TFLOP/s), and the grid engine's 1-NN
line the bound of kernel G: the pairs within the bound (kernel E's count
of them) at 9 operations, each query and point read once and an index
and a distance written a query. The thresholds of ops/neighbors.py are
not changed by it.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from mapmerge_torch.core import transforms as tf
from mapmerge_torch.core.cloud import PointCloud
from mapmerge_torch.kernels import grid as kgrid
from mapmerge_torch.kernels import radius as kradius
from mapmerge_torch.ops.downsample import voxel_downsample
from mapmerge_torch.ops.grid import build_grid
from mapmerge_torch.ops.neighbors import nearest_neighbor, neighbor_moments, radius_count
from mapmerge_torch.testing.scene import rotation_z, se3, town_views

SIZES = (65536, 131072, 262144)


def _ms(fn, reps: int = 5) -> float:
    fn()
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


@contextlib.contextmanager
def plain_versions(module, names):
    """The plain versions `<name>_ref` of `module`'s kernel wrappers in their
    place (ops/neighbors.py and ops/grid.py look the wrappers up at call
    time)."""
    saved = {n: getattr(module, n) for n in names}
    for n in names:
        setattr(module, n, _without_boxes(getattr(module, f"{n}_ref")))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _without_boxes(ref):
    """A plain version called as its kernel's wrapper is: the target's
    tile boxes that ICP's callers pass the grid 1-NN (`boxes=`) dropped."""
    def call(*args, boxes=None, **kwargs):
        return ref(*args, **kwargs)

    return call


#: engine -> (the engine ops/neighbors.py is asked for, the plain versions
#: put in place of the kernels, if any)
ENGINES = {
    "dense": ("dense", None),
    "plain": ("dense", (kradius, ("count", "moments"))),
    "grid": ("grid", None),
    "grid plain": ("grid", (kgrid, ("nn_query", "count", "moments"))),
}


def _bound(n: int, members: int, row_bytes: int, member_ops: int) -> dict:
    """Kernel E's, F's or G's least time on n queries against n points: each
    read once (12 B; the points' mask 1 B), the rows written once, the
    members' operations at the float32 rate."""
    t_bytes = (n * 25 + n * row_bytes) / 3.35e12 * 1e3
    t_ops = members * member_ops / 67e12 * 1e3
    return {"members": members, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main(sizes) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("grid_crossover: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()], flush=True)

    views, _ = town_views(5, 500_000)
    x, rgb = views[0]
    cap = 1 << int(np.ceil(np.log2(x.shape[0])))
    view = voxel_downsample(
        PointCloud.from_numpy(x, rgb, capacity=cap, device=dev), 0.1,
        out_capacity=1 << 20,
    )
    for radius, scan_cap in ((0.8, 128), (0.6, 128), (1.0, 256)):
        grid = build_grid(view.xyz, view.mask, radius, None, scan_cap)
        print(json.dumps({
            "view_points": int(view.mask.sum()), "cell": radius, "cap": scan_cap,
            "dims": grid.dims, "fullest_bucket": int(grid.raw_max),
            "points_dropped_by_cap": int(grid.overflow),
        }), flush=True)
    pts = view.xyz[view.mask]
    order = torch.argsort(pts[:, 0] + pts[:, 1])
    move = torch.from_numpy(se3(rotation_z(0.01), [0.05, -0.03, 0.0])).to(dev)
    for n in sizes:
        p = pts[order[:n].sort().values].contiguous()
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
        moved = tf.apply(move, p)

        def engine(e, fn):
            def call():
                asked, plain = ENGINES[e]
                with plain_versions(*plain) if plain else contextlib.nullcontext():
                    return fn(asked)

            return call

        def radius_op(fn, radius):
            return lambda asked: fn(p, p, radius, p_mask=mask, engine=asked)[0]

        every = tuple(ENGINES)
        calls = {
            "radius_count r=0.8": (radius_op(radius_count, 0.8), every, (4, 9)),
            "neighbor_moments r=0.6": (radius_op(neighbor_moments, 0.6), every, (52, 25)),
            "nearest_neighbor bound=1.0": (lambda asked: nearest_neighbor(
                moved, p, p_mask=mask, bound=1.0, engine=asked, scan_cap=256,
                q_mask=mask)[1], ("dense", "grid", "grid plain"), (8, 9)),
        }
        within = radius_count(moved, p, 1.0, p_mask=mask, engine="dense")[0]
        for op, (fn, engines, cost) in calls.items():
            out = {e: engine(e, fn)() for e in engines}
            for e in engines:
                if op.startswith("nearest"):  # matches within the bound only
                    near = out["dense"] <= 0.99
                    differ = int((out["dense"][near] != out[e][near]).sum())
                else:
                    differ = int((out["dense"] != out[e]).sum())
                line = {"points": n, "op": op, "engine": e,
                        "ms": _ms(engine(e, fn)), "queries_differing": differ}
                if op.startswith("nearest") and e == "grid":
                    line.update(_bound(n, int(within.to(torch.int64).sum()), *cost))
                elif not op.startswith("nearest") and e == "dense":
                    line.update(_bound(n, int(out[e].to(torch.int64).sum()), *cost))
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or SIZES))
