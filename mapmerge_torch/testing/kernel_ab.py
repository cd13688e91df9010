"""Time the hand-written kernels of two checkouts of the port on the same
inputs, on one card, for a before/after comparison.

    python3 mapmerge_torch/testing/kernel_ab.py record INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py record-radius INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py record-grid INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py record-harris INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py time INPUTS.pt ROOT [PREFIX]

`record` drives config #1 and the registry sweep's FPFH + SAC_IA path
(chip_smoke.py's scenes and parameters) through this checkout and saves the
arguments of each kernel's first launch in each (kernel A's batched entry,
which their pairs take), beside chip_smoke.py's
synthetic inputs; it also saves the inputs of the FPFH stage's grid sweep
on eval config #2's first view (the cloud, its normals, the needed points,
the radius and the bucket cap), the arguments of SIFT's kernels C
(`scale_space`) and D (`knn`) on the dense octaves of the first extraction
of config #1 (octaves 0-2), config #4 and config5 (octaves 0-2 each) and of
config5_big's first map (octave 2, its only dense one), with the tile
pre-pass's (`tiles.pack`; `sift.pack` in a checkout before it moved) on
each octave C packs, and the arguments of the dense radius
sweeps, kernels E (`radius.count`, the outlier pass) and F
(`radius.moments`, the normals), on the first extraction of config #1, the
sweep's FPFH + SAC_IA path, config #4, config5 and the debugger
(`registration_visualisation` on config #1's views at their own sizes);
`record-radius` saves those of E and F alone. `time` imports
`mapmerge_torch` from the checkout at ROOT (this one, or an earlier commit
unpacked with `git archive` into a directory that .gitignore lists), holds
each kernel against that checkout's plain version on every saved input
whose name starts with PREFIX (all by default): bit for bit, C within
SCALE_SPACE_RTOL of the field, F within MOMENTS_RTOL of each query's second
moment (a checkout without kernels E and F reports those inputs absent);
builds that checkout's grid of the config #2 view outside the timing and
times its `fpfh._spfh_grid` on it, and prints one JSON line: the card, and
per input three medians of 20 timed calls (CUDA events around the call,
after 3 warm-up calls), with a digest of the grid sweep's rows and of the
outputs of the pre-pass and of C, D, E and F so that two checkouts can be
seen to agree bit for bit. It also saves the arguments of the grid
selection kernels' first calls on their main paths, kernel G (`grid.
nn_query`) from ICP on eval config #2 and kernel K (`grid.knn`) at
config5_big's first map's octave 0, and times each checkout's wrapper on
them, held bit for bit against its plain version: each call whole (the
pre-pass's boxes made in it) and, for G in a checkout whose `nn_query`
takes the boxes made before (`boxes=`), given them as ICP gives them.
Beside them the grid radius kernels' first calls: kernel H
(`grid.moments`) and kernel I (`grid.count`) on config #2's first cloud
and on config5_big's first map, kernel J (`grid.smooth`) at config5_big's
first map's octaves 0 and 1, each timed whole, held against its plain
version (I bit for bit, H and J within their tolerances) and repeating,
with a digest of its output (equal digests: the checkouts agree bit for
bit) and its device time by kernel name under torch.profiler, as the tile
pre-pass's inputs also get; I's inputs also time the grid pre-pass alone
(`grid.pack`: "grid_pack config #2", "grid_pack config5_big"), held
against pack_ref, with its device time by kernel name (and memset).
Kernel L's calls of the first Harris extraction of eval config #2 and of
eval config #3 are made from that extraction's arguments with the plain
versions (harris_reduce_inputs: the response on 9 and on 6 channels, the
suppression over every query and over those above the threshold,
`grid.reduce`; the first refinement step on 12 and on 9 channels,
`grid.reduce_list`), so every checkout is timed on the same operands
through its own signature; they are held against the checkout's plain
versions (the count and the max bit for bit, the sum within
REDUCE_RTOL), L's device time split from the pre-pass's by kernel name;
a checkout without L reports them absent. `record-grid` saves the grid
kernels' inputs alone, `record-harris` L's alone (and prints the share of
the answered queries above Harris's threshold). PREFIX may name several
prefixes, separated by commas.
Compare in one process order on one card: parent, change, change, parent.
C, D, E and F are timed through their
wrappers with no `packed` buffer, so each time holds the pre-pass, as an
earlier checkout's wrapper, which takes no such buffer, is timed (E and F,
where they take their own order pre-pass, on the streamed route).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def record(out: Path) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.testing import scene

    dev = torch.device("cuda", torch.cuda.current_device())
    va, vb, cap, _ = scene.config1_scene()
    xyz, rgb = scene.make_scene(
        np.random.default_rng(7), n_boxes=12, extent=8.0, density=90.0
    )
    truth = scene.se3(scene.rotation_z(0.4), [1.5, -0.7, 0.2])
    wa, wb, wcap = scene.overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    paths = {
        "config #1": ((va, vb), cap, cs.config1_params()),
        "FPFH+SAC_IA": ((wa, wb), wcap, cs.sweep_params("FPFH", "SAC_IA")),
    }
    inputs = {}
    for label, (views, c, params) in paths.items():
        clouds = [PointCloud.from_numpy(*v, capacity=c, device=dev) for v in views]
        with cs.first_launch_inputs(nn, spfh) as seen, sift_octaves(cs, label) as sift:
            estimate_maps_transforms(clouds, params, seed=0)
            torch.cuda.synchronize()
        for name in ("radius_count", "radius_moments"):
            inputs[f"{name} {label}"] = seen[name]
        # config #1's and the sweep's pairs take kernel A's batched entry
        for entry, key in (("nearest_neighbor", "nn"), ("nearest_neighbor_batched", "nn_batched")):
            if entry in seen:
                inputs[f"{key} {label}"] = seen[entry]
        inputs[f"spfh {label}"] = seen["spfh"]
        if label == "config #1":
            inputs.update(sift)
    inputs.update(record_sift_paths(cs, dev))
    inputs.update(record_debugger(cs, dev))
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.rand((cs.NN_Q, 3), generator=g, device=dev) * 16.0
    p = torch.rand((cs.NN_P, 3), generator=g, device=dev) * 16.0
    inputs["nn synthetic"] = ((q, p, torch.rand((cs.NN_P,), generator=g, device=dev) > 0.2), {})
    g = torch.Generator(device=dev).manual_seed(12)
    inputs["spfh synthetic"] = (
        cs._spfh_inputs(g, dev, cs.SPFH_B, cs.SPFH_CQ, 1, cs.SPFH_M),
        {"r2": cs.DESC_R2},
    )
    inputs["fpfh grid config #2"] = record_config2_sweep(cs, dev)
    inputs.update(record_grid_select(cs, dev))
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


@contextlib.contextmanager
def sift_octaves(cs, label: str, octaves=(0, 1, 2)):
    """Keep the arguments of the first len(octaves) calls of kernels C and
    D (one a dense octave, in octave order: the first extraction's) while a
    path runs, under "sift_scale_space LABEL octave N" and "sift_knn ...",
    all but the shared `packed` buffer, and the pre-pass's arguments on
    the points C smooths ("tiles_pack ..."); the dict fills as the path
    runs."""
    from mapmerge_torch.kernels import sift as ksift

    kept: dict = {}

    def make(name):
        def wrap(fn):
            def wrapper(*args, **kwargs):
                n = sum(key.startswith(f"{name} ") for key in kept)
                if n < len(octaves):
                    kept[f"{name} {label} octave {octaves[n]}"] = (
                        [cs._copied(a) for a in args],
                        {k: v for k, v in kwargs.items() if k != "packed"})
                    if name == "sift_scale_space":  # (qc, pc, vals, mask, ...)
                        kept[f"tiles_pack {label} octave {octaves[n]}"] = (
                            [cs._copied(a) for a in args[1:4]], {})
                return fn(*args, **kwargs)

            return wrapper

        return wrap

    with cs.patched({(ksift, "scale_space"): make("sift_scale_space"),
                     (ksift, "knn"): make("sift_knn")}):
        yield kept


@contextlib.contextmanager
def radius_first(cs, label: str):
    """Keep the arguments of the first call of kernels E and F while a path
    runs, under "radius_count LABEL" and "radius_moments LABEL"."""
    from mapmerge_torch.kernels import radius as kradius

    kept: dict = {}

    def make(name):
        def wrap(fn):
            def wrapper(*args, **kwargs):
                kept.setdefault(f"{name} {label}", ([cs._copied(a) for a in args], kwargs))
                return fn(*args, **kwargs)

            return wrapper

        return wrap

    with cs.patched({(kradius, "count"): make("radius_count"),
                     (kradius, "moments"): make("radius_moments")}):
        yield kept


def record_radius(out: Path) -> None:
    """Kernels E's and F's arguments alone, on the first extraction of each
    path that runs them: config #1, the sweep's FPFH + SAC_IA path, config
    #4, config5 (record_sift_paths' runs) and the debugger."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.testing import scene

    dev = torch.device("cuda", torch.cuda.current_device())
    va, vb, cap, _ = scene.config1_scene()
    xyz, rgb = scene.make_scene(
        np.random.default_rng(7), n_boxes=12, extent=8.0, density=90.0
    )
    truth = scene.se3(scene.rotation_z(0.4), [1.5, -0.7, 0.2])
    wa, wb, wcap = scene.overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    inputs = {}
    for label, views, c, params in (
        ("config #1", (va, vb), cap, cs.config1_params()),
        ("FPFH+SAC_IA", (wa, wb), wcap, cs.sweep_params("FPFH", "SAC_IA")),
    ):
        clouds = [PointCloud.from_numpy(*v, capacity=c, device=dev) for v in views]
        with radius_first(cs, label) as radius:
            estimate_maps_transforms(clouds, params, seed=0)
        inputs.update(radius)
    inputs.update({k: v for k, v in record_sift_paths(cs, dev).items()
                   if k.startswith("radius")})
    inputs.update(record_debugger(cs, dev))
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


def record_debugger(cs, dev) -> dict:
    """Kernels E's and F's arguments on the debugger's first extraction
    (tools/registration_visualisation on config #1's views as .pcd files,
    each at its own size, as chip_smoke.run_offline_tools runs it)."""
    import io
    import tempfile

    from mapmerge_torch.io.pcd import write_pcd
    from mapmerge_torch.testing.scene import config1_scene
    from mapmerge_torch.tools import registration_visualisation

    va, vb, _, _ = config1_scene()
    with tempfile.TemporaryDirectory() as d, radius_first(cs, "debugger") as radius:
        a, b = str(Path(d) / "a.pcd"), str(Path(d) / "b.pcd")
        write_pcd(a, va)
        write_pcd(b, vb)
        with contextlib.redirect_stdout(io.StringIO()):
            registration_visualisation.main(
                [a, b, "--dump-dir", str(Path(d) / "dump"), *cs.config1_argv()], device=dev)
        torch.cuda.synchronize()
    return radius


def record_sift_paths(cs, dev) -> dict:
    """Kernels C's and D's arguments on the first extraction of config #4
    (one rank: the 20-map merge), of config5 (the stateless node's first
    tick, ten maps) and of config5_big (the incremental node's first map:
    octave 2, the only dense one), each path run as chip_smoke.py runs it."""
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport
    from mapmerge_torch.testing.scene import town_views

    kept: dict = {}
    views, _ = town_views(cs.CONFIG4_MAPS, 4096, seed=3)
    with sift_octaves(cs, "config #4") as sift, radius_first(cs, "config #4") as radius:
        estimate_maps_transforms(cs.raw_clouds(views, dev), cs.config4_params(), seed=0)
    kept.update(sift)
    kept.update(radius)

    views, _ = town_views(cs.CONFIG5S_MAPS, 2048, seed=5)
    transport = InProcTransport()
    node = MapMergeNode(transport, cs.config5_params(), seed=0, device=dev)
    for i in range(cs.CONFIG5S_BATCH):
        transport.publish(f"robot_{i:02d}", *views[i])
    with sift_octaves(cs, "config5") as sift, radius_first(cs, "config5") as radius:
        node.discovery()
        node.transforms_estimation()
    kept.update(sift)
    kept.update(radius)

    views, _ = town_views(cs.CONFIG5_MAPS, cs.CONFIG5_VIEW_TARGET, keep=0.8, seed=5)
    cap = 1 << int(np.ceil(np.log2(len(views[0][0]))))
    transport = InProcTransport()
    node = MapMergeNode(transport, cs.config5_big_params(cap), seed=0, incremental=True,
                        max_robots=64, device=dev)
    with sift_octaves(cs, "config5_big", octaves=(2,)) as sift:
        cs.stream(node, transport, views, 1)
    kept.update(sift)
    torch.cuda.synchronize()
    return kept


def record_config2_sweep(cs, dev) -> tuple:
    """The arguments of fpfh._spfh_grid's first call in the feature stage
    of eval config #2's first view, as tensors: ((xyz, rgb, mask, normals,
    curvature, valid, needed), {"radius", "cap"})."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.ops.descriptors import fpfh
    from mapmerge_torch.pipeline.features import extract_features
    from mapmerge_torch.testing import scene

    views, _ = scene.town_views(cs.CONFIG2_MAPS, cs.CONFIG2_VIEW_TARGET)
    cloud = PointCloud.from_numpy(*views[0], capacity=cs.CONFIG2_CAP, device=dev)
    seen = []

    def make(fn):
        def wrapper(cloud, normals, needed, radius, grid):
            if not seen:
                seen.append((
                    tuple(a.clone() for a in (
                        cloud.xyz, cloud.rgb, cloud.mask, normals.normals,
                        normals.curvature, normals.valid, needed,
                    )),
                    {"radius": float(radius), "cap": grid.cap},
                ))
            return fn(cloud, normals, needed, radius, grid)

        return wrapper

    with cs.patched({(fpfh, "_spfh_grid"): make}):
        extract_features(cloud, cs.config2_params())
    return seen[0]


def record_grid(out: Path) -> None:
    """The grid kernels' arguments alone (record_grid_select)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    inputs = record_grid_select(cs, torch.device("cuda", torch.cuda.current_device()))
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


def record_grid_select(cs, dev) -> dict:
    """The arguments of kernel G's first call from ICP and of kernels H's
    and I's first calls on eval config #2 (chip_smoke.run_config2's merge
    of its five views: the first cloud's normals and outliers), and of
    kernel K's first call, H's and I's first calls and J's first calls at
    octaves 0 and 1 on config5_big's first map (the incremental node's
    first tick), as chip_smoke.first_launch_inputs records them, with each
    cell grid as a dict of its fields ("grid_nn config #2", "grid_moments
    config #2", "grid_count config #2", "grid_knn config5_big",
    "grid_moments config5_big", "grid_count config5_big", "grid_smooth
    config5_big octave 0" and "... octave 1"); I's grids and queries again
    for the pre-pass alone ("grid_pack config #2", "grid_pack
    config5_big"); and kernel L's first calls on config #2's first cloud,
    Harris's response and suppression on its sweep route and a refinement
    step on its list route ("grid_reduce config #2 response", "...
    suppression", "grid_reduce_list config #2 refinement")."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.pipeline.merging import estimate_maps_transforms
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import InProcTransport
    from mapmerge_torch.testing.scene import town_views

    kept = {}
    views, _ = town_views(cs.CONFIG2_MAPS, cs.CONFIG2_VIEW_TARGET)
    clouds = [PointCloud.from_numpy(x, r, capacity=cs.CONFIG2_CAP, device=dev)
              for x, r in views]
    with cs.first_launch_inputs(nn, spfh) as seen:
        estimate_maps_transforms(clouds, cs.config2_params(), seed=0)
        torch.cuda.synchronize()
    kept["grid_nn config #2"] = seen["grid_nn icp"]
    kept["grid_moments config #2"] = seen["grid_moments"]
    kept["grid_count config #2"] = seen["grid_count"]
    del clouds, seen
    views, _ = town_views(cs.CONFIG5_MAPS, cs.CONFIG5_VIEW_TARGET, keep=0.8, seed=5)
    cap = 1 << int(np.ceil(np.log2(len(views[0][0]))))
    transport = InProcTransport()
    node = MapMergeNode(transport, cs.config5_big_params(cap), seed=0, incremental=True,
                        max_robots=64, device=dev)
    with cs.first_launch_inputs(nn, spfh) as seen:
        cs.stream(node, transport, views, 1)
        torch.cuda.synchronize()
    knn = [k for k in seen if k.startswith("grid_knn Q=")]
    kept["grid_knn config5_big"] = seen[max(knn, key=lambda k: int(k.split("=")[1]))]
    kept["grid_moments config5_big"] = seen["grid_moments"]
    kept["grid_count config5_big"] = seen["grid_count"]
    smooth = sorted((k for k in seen if k.startswith("grid_smooth Q=")),
                    key=lambda k: -int(k.split("=")[1]))
    for octave, key in enumerate(smooth[:2]):
        kept[f"grid_smooth config5_big octave {octave}"] = seen[key]
    for label in ("config #2", "config5_big"):  # the pre-pass on I's operands
        kept[f"grid_pack {label}"] = (kept[f"grid_count {label}"][0][:3], {})
    # the positional arguments only: G's `boxes` from ICP are the change's,
    # and each checkout makes its own
    kept = {name: ([_grid_fields(a) for a in args], {}) for name, (args, _) in kept.items()}
    kept.update(record_harris_reduce(cs, dev))
    return kept


def record_harris(out: Path) -> None:
    """Kernel L's Harris inputs alone (record_harris_reduce)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    inputs = record_harris_reduce(cs, torch.device("cuda", torch.cuda.current_device()))
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


#: Harris's distinct channels of n n^T in its row-major 3 x 3: the upper
#: triangle xx, xy, xz, yy, yz, zz (ops/keypoints/harris.UPPER)
UPPER = (0, 1, 2, 4, 5, 8)


def harris_arguments(cs, cloud, params) -> dict:
    """The arguments, defaults applied, of the first Harris extraction of
    the feature stage of `cloud` under `params` (detect_keypoints_harris,
    as pipeline/features calls it)."""
    import inspect

    from mapmerge_torch.ops import keypoints as keypoint_ops
    from mapmerge_torch.pipeline.features import extract_features

    seen: list = []

    def make(fn):
        signature = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            if not seen:
                bound = signature.bind(*args, **kwargs)
                bound.apply_defaults()
                seen.append(dict(bound.arguments))
            return fn(*args, **kwargs)

        return wrapper

    with cs.patched({(keypoint_ops, "detect_keypoints_harris"): make}):
        extract_features(cloud, params)
    return seen[0]


def harris_reduce_inputs(label: str, args: dict) -> tuple[dict, dict]:
    """Kernel L's calls of one Harris extraction on the grid, made here
    from its arguments with the plain versions, so that every checkout is
    timed on the same operands whatever its own Harris route: the target
    grid (the points valid in the mask and the normals) and the query grid
    of every point, built once; the response on all 9 channels of n n^T
    ("grid_reduce LABEL response") and on their upper triangle ("...
    response C=6"); the suppression, a max of the response, over every
    answered query ("... suppression") and over those whose response is
    above the threshold ("... suppression masked": the query grid's slots
    and-ed with it, core/grid.masked_query_grid); the first refinement step
    on the list route, on the 9 + 3 channels ("grid_reduce_list LABEL
    refinement") and on 6 + 3 ("... refinement C=9"). Returns (the inputs,
    the share of the answered queries above the threshold and their
    counts)."""
    from mapmerge_torch.core.grid import BIG, _f32, build_grid, masked_query_grid
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.ops.rigid import _det3

    cloud, normals, radius = args["cloud"], args["normals"], args["radius"]
    q = cloud.xyz.contiguous()
    ok = cloud.mask & normals.valid
    grid = build_grid(q, ok, radius, None, args["scan_cap"])
    qg = build_grid(q, None, grid.cell_size, grid.dims, grid.cap)
    r2 = _f32(radius * radius)
    n = torch.where(normals.valid[:, None], normals.normals, 0.0)
    outer = (n[:, :, None] * n[:, None, :]).reshape(-1, 9).contiguous()
    c = kgrid.reduce_ref(grid, qg, q, outer, r2, "sum")[1].reshape(-1, 3, 3)
    trace = c[:, 0, 0] + c[:, 1, 1] + c[:, 2, 2]
    resp = torch.where(ok, _det3(c) - 0.04 * trace * trace, -BIG)[:, None].contiguous()
    nmax = kgrid.reduce_ref(grid, qg, q, resp, r2, "max")[1][:, 0]
    above = resp[:, 0] > args["threshold"]
    keep = ok & (resp[:, 0] >= nmax) & above
    k = min(args["max_keypoints"], q.shape[0])
    kp = q[torch.topk(torch.where(keep, resp[:, 0], -BIG), k)[1]].contiguous()
    nntp = (outer.reshape(-1, 3, 3) * q[:, None, :]).sum(dim=-1)
    upper = outer[:, list(UPPER)].contiguous()
    mqg = masked_query_grid(qg, above, q.shape[0])
    answered, swept = int(qg.cell_ok.sum()), int(mqg.cell_ok.sum())
    share = {"answered": answered, "above_threshold": swept,
             "share": swept / max(answered, 1), "threshold": args["threshold"],
             "keypoints": int(keep.sum())}
    inputs = {
        f"grid_reduce {label} response": (grid, qg, q, outer, r2, "sum"),
        f"grid_reduce {label} response C=6": (grid, qg, q, upper, r2, "sum"),
        f"grid_reduce {label} suppression": (grid, qg, q, resp, r2, "max"),
        f"grid_reduce {label} suppression masked": (grid, mqg, q, resp, r2, "max"),
        f"grid_reduce_list {label} refinement": (
            grid, kp, torch.cat([outer, nntp], dim=-1).contiguous(), r2, "sum"),
        f"grid_reduce_list {label} refinement C=9": (
            grid, kp, torch.cat([upper, nntp], dim=-1).contiguous(), r2, "sum"),
    }
    return {name: ([_grid_fields(a) for a in a_], {}) for name, a_ in inputs.items()}, share


def record_harris_reduce(cs, dev) -> dict:
    """Kernel L's inputs on the first cloud of eval config #2 and of eval
    config #3 (harris_reduce_inputs on the arguments of its first Harris
    extraction, at chip_smoke.py's sizes and parameters), with the share of
    the answered queries whose response lies above the threshold, printed
    as one JSON line."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.testing.scene import town_views

    kept, shares = {}, {}
    for label, (maps, target, kw), cap, params in (
        ("config #2", (cs.CONFIG2_MAPS, cs.CONFIG2_VIEW_TARGET, {}), cs.CONFIG2_CAP,
         cs.config2_params()),
        ("config #3", (2, 800_000, {"keep": 0.75, "seed": 9}), cs.CONFIG3_CAP,
         cs.config3_params()),
    ):
        views, _ = town_views(maps, target, **kw)
        cloud = PointCloud.from_numpy(*views[0], capacity=cap, device=dev)
        del views
        inputs, shares[label] = harris_reduce_inputs(label, harris_arguments(cs, cloud, params))
        kept.update(inputs)
        del cloud
        torch.cuda.synchronize()
    print(json.dumps({"harris_above_threshold": shares}))
    return kept


def _grid_fields(a):
    """A cell grid as a dict of its fields (a saved file then holds only
    tensors and plain values); anything else as it is."""
    import dataclasses

    if not dataclasses.is_dataclass(a):
        return a
    return {"cell_grid": {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}}


def _as_grid(a):
    """_grid_fields undone with the imported checkout's CellGrid."""
    if not (isinstance(a, dict) and "cell_grid" in a):
        return a
    from mapmerge_torch.core.grid import CellGrid

    fields = dict(a["cell_grid"])
    fields["dims"] = tuple(fields["dims"])
    return CellGrid(**fields)


def time_grid_select(kgrid, name: str, args) -> dict:
    """Kernel G (`nn_query`) or K (`knn`) of the checkout on one saved
    input: held bit for bit against its plain version, a digest of its
    output, three medians of 20 timed calls, each whole (`ms`); for G, where
    the checkout's nn_query takes the target's boxes made before
    (kgrid.boxes), three more given them (`kept_ms`: ICP's iterations,
    which make them once), else null."""
    args = [_as_grid(a) for a in args]
    grid = args[0]
    nn = name.startswith("grid_nn")
    kernel, ref = (kgrid.nn_query, kgrid.nn_query_ref) if nn else (kgrid.knn, kgrid.knn_ref)
    got, want = kernel(*args), ref(*args)
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    kept = None
    if nn and hasattr(kgrid, "boxes"):
        boxes = kgrid.boxes(grid)
        again = kernel(*args, boxes=boxes)
        exact = exact and all(torch.equal(a, b) for a, b in zip(again, want))
        kept = [time_ms(lambda: kernel(*args, boxes=boxes)) for _ in range(3)]
    return {
        "shape": f"Q={args[2].shape[0]} grid {tuple(grid.cell_idx.shape)} dims {grid.dims}",
        "exact": exact, "digest": _digest(got),
        "ms": [time_ms(lambda: kernel(*args)) for _ in range(3)], "kept_ms": kept,
    }


def time_grid_radius(kgrid, name: str, args) -> dict:
    """Kernel H (`moments`) or J (`smooth`) of the checkout on one saved
    input: held against its plain version (H's count exactly, its mean and
    covariance within MOMENTS_RTOL; J within SCALE_SPACE_RTOL of the field)
    and against a second call bit for bit, a digest of its output, three
    medians of 20 timed calls, each whole (the pre-pass, where the checkout
    has one, in it), and the device time of a call by kernel name
    (device_ms)."""
    from mapmerge_torch.kernels import radius as kradius
    from mapmerge_torch.kernels import sift as ksift

    args = [_as_grid(a) for a in args]
    grid, q = args[0], args[2]
    if name.startswith("grid_moments"):
        kernel = kgrid.moments
        got, want = kernel(*args), kgrid.moments_ref(*args)
        _, err = kradius.moments_error(got, want, q)
        held = torch.equal(got[0], want[0]) and err <= kradius.MOMENTS_RTOL
        error = {"err_of_second_moment": err}
    else:
        kernel = kgrid.smooth
        got, want = (kernel(*args),), kgrid.smooth_ref(*args)
        err = float((got[0] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        held = err <= ksift.SCALE_SPACE_RTOL
        error = {"err_of_field": err}
    again = kernel(*args)
    again = again if isinstance(again, tuple) else (again,)
    return {
        "shape": f"Q={q.shape[0]} grid {tuple(grid.cell_idx.shape)} dims {grid.dims}",
        "held": held and all(torch.equal(a, b) for a, b in zip(got, again)), **error,
        "digest": _digest(got), "ms": [time_ms(lambda: kernel(*args)) for _ in range(3)],
        "device_ms": device_ms(lambda: kernel(*args)),
    }


def time_grid_count(kgrid, args) -> dict:
    """Kernel I (`count`) of the checkout on one saved input: held bit for
    bit against count_ref and against a second call, a digest of its
    output, three medians of 20 timed calls, each whole (the pre-pass,
    where the checkout has one, in it), the device time of a call by kernel
    name (device_ms), and, where the checkout's I counts (select_counters
    knows "grid_count"), its counters."""
    args = [_as_grid(a) for a in args]
    grid, q = args[0], args[2]
    got, again = kgrid.count(*args), kgrid.count(*args)
    held = torch.equal(got, kgrid.count_ref(*args)) and torch.equal(got, again)
    counters = (kgrid.select_counters("grid_count", *args)
                if hasattr(kgrid, "COUNT_COUNTERS") else None)
    return {
        "shape": f"Q={q.shape[0]} grid {tuple(grid.cell_idx.shape)} dims {grid.dims}",
        "held": held, "digest": _digest((got,)),
        "ms": [time_ms(lambda: kgrid.count(*args)) for _ in range(3)],
        "device_ms": device_ms(lambda: kgrid.count(*args)), "counters": counters,
    }


def time_grid_reduce(kgrid, name: str, args) -> dict:
    """Kernel L of the checkout on one saved input, its sweep route
    (`reduce`) or its list route (`reduce_list`), through the checkout's
    own signature: held against its plain version (the count exactly, the
    max bit for bit, the sum within REDUCE_RTOL of the members' sum of |v|)
    and against a second call bit for bit, a digest of its output, three
    medians of 20 timed calls through the wrapper, the device time of a call
    by kernel name (L's and the grid pre-pass's apart: device_ms) and, on
    the sweep route, its counters. Where the checkout's list route takes the
    target's tile boxes made before (`boxes=`, as Harris gives them), three
    more medians and the device time given them (`kept_ms`,
    `kept_device_ms`). A checkout without L reports the input absent."""
    import inspect

    if not hasattr(kgrid, "reduce"):
        return {"absent": True}
    args = [_as_grid(a) for a in args]
    list_route = name.startswith("grid_reduce_list")
    kernel = kgrid.reduce_list if list_route else kgrid.reduce
    plain = kgrid.reduce_list_ref if list_route else kgrid.reduce_ref
    grid, q, values = args[0], args[1 if list_route else 2], args[2 if list_route else 3]
    got, want, again = kernel(*args), plain(*args), kernel(*args)
    same = [bool(((a == b) | (a.isnan() & b.isnan())).all()) for a, b in zip(got, again)]
    held = torch.equal(got[0], want[0]) and all(same)
    err = 0.0
    if args[-1] == "max":
        held = held and bool(((got[1] == want[1]) | (got[1].isnan() & want[1].isnan())).all())
    else:
        magnitudes = [*args[:-1], "sum"]
        magnitudes[2 if list_route else 3] = values.abs()
        err = kgrid.reduce_error(got[1], want[1], plain(*magnitudes)[1])
        held = held and err <= kgrid.REDUCE_RTOL
    kept = kept_device = None
    if list_route and "boxes" in inspect.signature(kernel).parameters:
        boxes = kgrid.boxes(grid)
        given = kernel(*args, boxes=boxes)
        held = held and all(torch.equal(a, b) for a, b in zip(given, got))
        kept = [time_ms(lambda: kernel(*args, boxes=boxes)) for _ in range(3)]
        kept_device = device_ms(lambda: kernel(*args, boxes=boxes))
    answered = int(args[1].cell_ok.sum()) if not list_route else q.shape[0]
    return {
        "shape": f"Q={q.shape[0]} ({answered} answered) C={values.shape[1]} {args[-1]} grid "
                 f"{tuple(grid.cell_idx.shape)} dims {grid.dims}",
        "held": held, "err_of_members_abs": err, "digest": _digest(got),
        "ms": [time_ms(lambda: kernel(*args)) for _ in range(3)],
        "device_ms": device_ms(lambda: kernel(*args)),
        "kept_ms": kept, "kept_device_ms": kept_device,
        "counters": None if list_route else kgrid.select_counters("grid_reduce", *args),
    }


def time_grid_pack(kgrid, args) -> dict:
    """The grid pre-pass of the checkout alone (`pack`: the target's boxes
    and the query grid's units) on one saved input: its boxes of the filled
    tiles held equal to pack_ref's and its units the same set, three
    medians of 20 timed calls through the wrapper and the device time of a
    call by kernel name (a memset apart, where the checkout makes one);
    beside it the device time of the boxes alone (`boxes`) and of the units
    alone (the checkout's mm_grid_pack given no boxes buffer)."""
    from mapmerge_torch.kernels import build

    args = [_as_grid(a) for a in args]
    grid, qg = args[:2]
    dev = args[2].device

    def units_alone():
        h, cap = grid.cell_idx.shape
        err = build.load().mm_grid_pack(
            grid.cell_xyz.data_ptr(), grid.count.data_ptr(), qg.count.data_ptr(), h, cap,
            *grid.dims, None, alone.data_ptr(), alone.numel() - 1,
            torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, err

    boxes, units = kgrid.pack(*args)
    alone = torch.empty_like(units)
    rboxes, runits = kgrid.pack_ref(*args)
    filled = kgrid.filled_tiles(args[0])
    n = int(units[0])
    held = bool((boxes[filled] == rboxes[filled]).all()) and n == int(runits[0]) and (
        torch.equal(units[1 : n + 1].sort().values, runits[1 : n + 1].sort().values))
    return {
        "shape": f"grid {tuple(args[0].cell_idx.shape)}, {n} units, "
                 f"{int(filled.sum())} filled tiles",
        "held": held, "ms": [time_ms(lambda: kgrid.pack(*args)) for _ in range(3)],
        "device_ms": device_ms(lambda: kgrid.pack(*args)),
        "boxes_device_ms": device_ms(lambda: kgrid.boxes(grid)),
        "units_device_ms": device_ms(units_alone),
    }


def device_ms(fn, reps: int = 20) -> dict:
    """The device time of one call of fn by kernel name (and memset):
    torch.profiler's CUDA intervals over `reps` calls after a warm one,
    summed by name, over reps."""
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
            ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    return by_name


def time_config2_sweep(args, kwargs) -> dict:
    """The checkout's grid sweep of one config #2 cloud: its grid built
    outside the timing, as compute_fpfh builds it."""
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.ops.descriptors import fpfh
    from mapmerge_torch.ops.grid import build_grid
    from mapmerge_torch.ops.normals import SurfaceNormals

    xyz, rgb, mask, nrm, curv, valid, needed = args
    cloud = PointCloud(xyz=xyz, rgb=rgb, mask=mask)
    normals = SurfaceNormals(normals=nrm, curvature=curv, valid=valid)
    radius = kwargs["radius"]
    grid = build_grid(xyz, mask & valid, radius, None, kwargs["cap"])

    def sweep():
        return fpfh._spfh_grid(cloud, normals, needed, radius, grid)

    hist, total = sweep()
    digest = hashlib.sha256(hist.cpu().numpy().tobytes())
    digest.update(total.cpu().numpy().tobytes())
    return {
        "shape": f"{xyz.shape[0]} points, {int(needed.sum())} needed, grid "
                 f"{tuple(grid.cell_idx.shape)}",
        "rows_digest": digest.hexdigest()[:16],
        "counted_pairs": int(total.to(torch.int64).sum()),
        "ms": [time_ms(sweep) for _ in range(3)],
    }


def time_sift(ksift, name: str, args, kwargs) -> dict:
    """Kernel C or D of the checkout on one saved input: held against its
    plain version (D bit for bit, C within SCALE_SPACE_RTOL of the field),
    a digest of its output, three medians of 20 timed calls."""
    if name.startswith("sift_knn"):
        kernel = ksift.knn
        got, want = kernel(*args, **kwargs), ksift.knn_ref(*args, **kwargs)
        ok, err = all(torch.equal(a, b) for a, b in zip(got, want)), 0.0
    else:
        kernel = ksift.scale_space
        got, want = kernel(*args, **kwargs), ksift.scale_space_ref(*args, **kwargs)
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        ok = err <= ksift.SCALE_SPACE_RTOL
        got = (got,)
    return {
        "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]}",
        "held": ok, "err_of_field": err, "digest": _digest(got),
        "ms": [time_ms(lambda: kernel(*args, **kwargs)) for _ in range(3)],
    }


def time_pack(ktiles, args) -> dict:
    """The pre-pass of the checkout on one saved input: held against
    pack_ref (the same values, NaN where NaN, the int bits of the fourth
    columns), a digest of both outputs, three medians of 20 timed calls
    through the wrapper, and the device time of a call (device_ms)."""
    pts, boxes = ktiles.pack(*args)
    rpts, rboxes = ktiles.pack_ref(*args)
    ok = bool(((pts == rpts) | (pts.isnan() & rpts.isnan())).all()) and torch.equal(
        boxes[..., :3], rboxes[..., :3]) and torch.equal(
        boxes[..., 3].contiguous().view(torch.int32),
        rboxes[..., 3].contiguous().view(torch.int32))
    return {"shape": f"P={args[0].shape[0]}", "held": ok, "digest": _digest((pts, boxes)),
            "ms": [time_ms(lambda: ktiles.pack(*args)) for _ in range(3)],
            "device_ms": device_ms(lambda: ktiles.pack(*args))}


def time_radius(kradius, name: str, args, kwargs) -> dict:
    """Kernel E or F of the checkout on one saved input: held against its
    plain version (E bit for bit; F's count exactly, its mean and covariance
    within MOMENTS_RTOL), a digest of its output, three medians of 20 timed
    calls through the wrapper and the device time of a call by kernel name
    (device_ms)."""
    if name.startswith("radius_count"):
        kernel = kradius.count
        got = kernel(*args, **kwargs)
        ok, err = torch.equal(got, kradius.count_ref(*args, **kwargs)), 0.0
        got = (got,)
    else:
        kernel = kradius.moments
        got, want = kernel(*args, **kwargs), kradius.moments_ref(*args, **kwargs)
        _, err = kradius.moments_error(got, want)
        ok = torch.equal(got[0], want[0]) and err <= kradius.MOMENTS_RTOL
    return {
        "shape": f"Q={args[0].shape[0]} P={args[1].shape[0]}",
        "held": ok, "err_of_second_moment": err, "digest": _digest(got),
        "ms": [time_ms(lambda: kernel(*args, **kwargs)) for _ in range(3)],
        "device_ms": device_ms(lambda: kernel(*args, **kwargs)),
    }


def _digest(tensors) -> str:
    digest = hashlib.sha256()
    for a in tensors:
        digest.update(a.cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def time_root(inputs_path: Path, root: Path, prefix: str = "") -> None:
    sys.path.insert(0, str(root.resolve()))
    from mapmerge_torch.kernels import grid as kgrid
    from mapmerge_torch.kernels import nn, spfh
    from mapmerge_torch.kernels import sift as ksift

    try:  # kernels E and F, where the checkout has them
        from mapmerge_torch.kernels import radius as kradius
    except ImportError:
        kradius = None
    try:  # the pre-pass's own module, where the checkout has it
        from mapmerge_torch.kernels import tiles as ktiles
    except ImportError:
        ktiles = ksift

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    inputs = torch.load(inputs_path, map_location=f"cuda:{torch.cuda.current_device()}")
    result = {"root": str(root), "card": card, "kernels": {}}
    for name, (args, kwargs) in sorted(inputs.items()):
        if not name.startswith(tuple(prefix.split(","))):
            continue
        if name.startswith("tiles_pack"):
            result["kernels"][name] = time_pack(ktiles, args)
            continue
        if name.startswith("sift"):
            result["kernels"][name] = time_sift(ksift, name, args, kwargs)
            continue
        if name.startswith("radius"):
            result["kernels"][name] = ({"absent": True} if kradius is None
                                       else time_radius(kradius, name, args, kwargs))
            continue
        if name.startswith("fpfh grid"):
            result["kernels"][name] = time_config2_sweep(args, kwargs)
            continue
        if name.startswith(("grid_nn", "grid_knn")):
            result["kernels"][name] = time_grid_select(kgrid, name, args)
            continue
        if name.startswith(("grid_moments", "grid_smooth")):
            result["kernels"][name] = time_grid_radius(kgrid, name, args)
            continue
        if name.startswith("grid_count"):
            result["kernels"][name] = time_grid_count(kgrid, args)
            continue
        if name.startswith("grid_reduce"):
            result["kernels"][name] = time_grid_reduce(kgrid, name, args)
            continue
        if name.startswith("grid_pack"):
            result["kernels"][name] = time_grid_pack(kgrid, args)
            continue
        kernel, ref = {
            "nn": (nn.nearest_neighbor, nn.nearest_neighbor_ref),
            "nn_batched": (nn.nearest_neighbor_batched, nn.nearest_neighbor_batched_ref),
            "spfh": (spfh.spfh_tile, spfh.spfh_ref),
        }[name.split()[0]]
        got, want = kernel(*args, **kwargs), ref(*args, **kwargs)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        result["kernels"][name] = {
            "shape": " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a)),
            "exact": exact,
            "ms": [time_ms(lambda: kernel(*args, **kwargs)) for _ in range(3)],
        }
    print(json.dumps(result))
    if not all(k.get("exact", k.get("held", True)) for k in result["kernels"].values()):
        raise SystemExit("kernel_ab: a kernel disagrees with its plain version")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this script needs a GPU")
    if len(argv) == 2 and argv[0] == "record":
        record(Path(argv[1]))
    elif len(argv) == 2 and argv[0] == "record-radius":
        record_radius(Path(argv[1]))
    elif len(argv) == 2 and argv[0] == "record-grid":
        record_grid(Path(argv[1]))
    elif len(argv) == 2 and argv[0] == "record-harris":
        record_harris(Path(argv[1]))
    elif len(argv) in (3, 4) and argv[0] == "time":
        time_root(Path(argv[1]), Path(argv[2]), *argv[3:])
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
