"""The readings that a cell's limits are set from, on the card.

    python3 -m mmbench.calibrate --workload <name> --seeds <n> [<n> ...] [--controls <k>]

For each seed, in one process: the cell's scenes, two steps of its
traffic (a round of merges, or a whole stream) through the program exactly
as a run's window drives them, and every number the judge reads: the lower
readings. For the first `--controls` seeds the control too: the reference
put in the program's place one precision below the float32 the
configuration states (TF32, and bfloat16 beside it), judged by the same
comparison: the upper readings. Beside them, whether the configuration's
caps bound the work: the most ICP iterations a pair ran against
`max_iterations`, the keypoints beyond `max_keypoints`, the points the
voxel grid dropped beyond `max_points`, and the FPFH neighbourhoods above
`max_neighbors` (the judge's). One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mmbench import harness, judge
from mmbench.run import ROOT, environment, forbidden_modules

CONTROLS = ("tf32", "bfloat16")


#: the program's ICP, as the pair registration calls it
ICP = "mapmerge_torch.pipeline.registration:icp_refine"


def icp_iterations(seen: list):
    """A wrapper of ICP that appends (the iterations each call ran, whether
    it converged) to `seen`."""

    def wrap(fn):
        def counted(*args, **kwargs):
            info: dict = {}
            out = fn(*args, info_out=info, **kwargs)
            seen.append((info["iterations"], out[1]))
            return out

        return counted

    return wrap


def readings(reg: harness.Registry, workload: str, seed: int, controls: bool, device) -> dict:
    import torch

    work = reg.workload(workload)
    config, traffic = reg.config(work["config"]), reg.traffic(work["traffic"])
    limits = reg.limits(workload)
    driver = reg.driver(traffic["driver"])
    t0 = time.perf_counter()
    state = driver.setup(config, traffic, seed, device, limits["feature_clouds"], warm=False)
    t1 = time.perf_counter()
    # a first step warms, the second is timed
    harness.run_steps(lambda: driver.step(state), harness.Record(), None, 1)
    rec = harness.Record()
    iterations: list = []
    with harness.patched({ICP: icp_iterations(iterations)}):
        harness.run_steps(lambda: driver.step(state), rec, None, 1)
    outputs = driver.outputs(state)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out = {"seed": seed, "setup_s": t1 - t0, "unit_s": rec.seconds,
           "attempted": outputs["attempted"], "failed": outputs["failed"],
           "points": [len(v) for s in outputs["scenes"] for v in s["views"]][:8]}
    out.update(judge.pose_numbers(outputs["units"], outputs["scenes"]))
    out.update(judge.unit_numbers(outputs, device, seed, limits["normal_queries"],
                                  CONTROLS if controls else ()))
    for key in ("scan_overflow", "keypoints_truncated", "dropped_points"):
        out[key] = max((f[key] for f in outputs["features"]), default=0)
    its = [int(i) for t, _ in iterations for i in torch.as_tensor(t).flatten().tolist()]
    converged = [bool(c) for _, t in iterations for c in torch.as_tensor(t).flatten().tolist()]
    out["icp_iterations_max"] = max(its, default=0)
    out["icp_iterations_mean"] = sum(its) / max(len(its), 1)
    out["icp_converged_share"] = sum(converged) / max(len(converged), 1)
    out["icp_calls"] = len(its)
    out["judge_s"] = time.perf_counter() - t2
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m mmbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("mmbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    reg = harness.Registry(ROOT)
    for k, seed in enumerate(args.seeds):
        print(json.dumps(readings(reg, args.workload, seed, k < args.controls, device)),
              flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"mmbench.calibrate: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
