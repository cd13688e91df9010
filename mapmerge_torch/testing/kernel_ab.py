"""Time the hand-written kernels of two checkouts of the port on the same
inputs, on one card, for a before/after comparison.

    python3 mapmerge_torch/testing/kernel_ab.py record INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py time INPUTS.pt ROOT

`record` drives config #1 and the registry sweep's FPFH + SAC_IA path
(chip_smoke.py's scenes and parameters) through this checkout and saves the
arguments of each kernel's first launch in each, beside chip_smoke.py's
synthetic inputs; it also saves the inputs of the FPFH stage's grid sweep
on eval config #2's first view (the cloud, its normals, the needed points,
the radius and the bucket cap). `time` imports `mapmerge_torch` from the
checkout at ROOT (this one, or an earlier commit unpacked with `git archive`
into a directory that .gitignore lists), holds each kernel against that
checkout's plain version bit for bit on every saved input, builds that
checkout's grid of the config #2 view outside the timing and times its
`fpfh._spfh_grid` on it, and prints one JSON line: the card, and per input
three medians of 20 timed calls (CUDA events around the call, after 3
warm-up calls), with a digest of the grid sweep's rows so that two
checkouts can be seen to agree bit for bit. Compare in one process order on
one card: parent, change, change, parent.
"""

from __future__ import annotations

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
        with cs.first_launch_inputs(nn, spfh) as seen:
            estimate_maps_transforms(clouds, params, seed=0)
            torch.cuda.synchronize()
        inputs[f"nn {label}"] = seen["nearest_neighbor"]
        inputs[f"spfh {label}"] = seen["spfh"]
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
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


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


def time_root(inputs_path: Path, root: Path) -> None:
    sys.path.insert(0, str(root.resolve()))
    from mapmerge_torch.kernels import nn, spfh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    inputs = torch.load(inputs_path, map_location=f"cuda:{torch.cuda.current_device()}")
    result = {"root": str(root), "card": card, "kernels": {}}
    for name, (args, kwargs) in sorted(inputs.items()):
        if name.startswith("fpfh grid"):
            result["kernels"][name] = time_config2_sweep(args, kwargs)
            continue
        kernel, ref = (
            (nn.nearest_neighbor, nn.nearest_neighbor_ref)
            if name.startswith("nn") else (spfh.spfh_tile, spfh.spfh_ref)
        )
        got, want = kernel(*args, **kwargs), ref(*args, **kwargs)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        result["kernels"][name] = {
            "shape": " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a)),
            "exact": exact,
            "ms": [time_ms(lambda: kernel(*args, **kwargs)) for _ in range(3)],
        }
    print(json.dumps(result))
    if not all(k.get("exact", True) for k in result["kernels"].values()):
        raise SystemExit("kernel_ab: a kernel disagrees with its plain version")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this script needs a GPU")
    if len(argv) == 2 and argv[0] == "record":
        record(Path(argv[1]))
    elif len(argv) == 3 and argv[0] == "time":
        time_root(Path(argv[1]), Path(argv[2]))
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
