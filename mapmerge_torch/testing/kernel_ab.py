"""Time the hand-written kernels of two checkouts of the port on the same
inputs, on one card, for a before/after comparison.

    python3 mapmerge_torch/testing/kernel_ab.py record INPUTS.pt
    python3 mapmerge_torch/testing/kernel_ab.py time INPUTS.pt ROOT

`record` drives config #1 and the registry sweep's FPFH + SAC_IA path
(chip_smoke.py's scenes and parameters) through this checkout and saves the
arguments of each kernel's first launch in each, beside chip_smoke.py's
synthetic inputs. `time` imports `mapmerge_torch.kernels` from the checkout
at ROOT (this one, or an earlier commit unpacked with `git archive` into a
directory that .gitignore lists), holds each kernel against that
checkout's plain version bit for bit on every saved input, and prints one
JSON line: the card, and per input three medians of 20 timed calls (CUDA
events around the wrapper, after 3 warm-up calls). Compare in one process
order on one card: parent, change, change, parent.
"""

from __future__ import annotations

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
    torch.save(inputs, out)
    print(f"recorded {sorted(inputs)} to {out}")


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
    if not all(k["exact"] for k in result["kernels"].values()):
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
