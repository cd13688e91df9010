"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m mmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's scene from the seed,
loads the program's kernels (built into the checkout's build/ on its first
run) and runs one warm-up unit; the window then runs the cell's steps
(a round of merges, a whole stream) for `--seconds`: the step in flight at
the close ends it. With `--trace 0`
the line holds the cell's end-to-end metrics; with `--trace 1` its
per-layer metrics, from a profiler phase of a fixed number of steps, a
count phase of as many steps (the hooks' numbers, which read the device),
and a span phase over the rest of the window. Once the window has closed, the
outputs are judged against the plain reference (judge.py); the numbers
compared, each beside its limit, are the last lines on standard error and
the last key of the result line, which is the last line of standard
output. Without a card, or with fewer than the cell asks for, it exits 2
and prints no result.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mapmerge_tpu")


def environment(root: Path) -> None:
    """Set before torch loads: every build and kernel cache at a fixed path
    inside the checkout (the program builds its kernels into
    build/mapmerge_torch/ there by itself), and no library that would load
    JAX."""
    build = root / "build" / "mmbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names among the loaded modules, compared
    whole (mapmerge_torch is not mapmerge_tpu)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m mmbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window(driver, state, readers: dict, seconds: float, trace: bool, profile_steps: int,
           sync, started: float):
    """The measured window's record; a traced one holds the span phase's
    counts and spans and the profiler phase's profile."""
    from mmbench import harness, trace as tracing

    rec = harness.Record()
    step = lambda: driver.step(state)  # noqa: E731
    rec.setup_s = time.perf_counter() - started
    deadline = time.perf_counter() + seconds
    if not trace:
        harness.run_steps(step, rec, deadline)
        return rec
    hooks, targets = {}, []
    for r in readers.values():
        hooks.update(getattr(r, "PROFILE_HOOKS", {}))
        targets += [t for t in getattr(r, "SPANS", []) if t not in targets]
    prof_rec = harness.Record()
    profile = tracing.profiled(lambda: harness.run_steps(step, prof_rec, None, profile_steps),
                               hooks, targets, sync)
    profile["counts"] = dict(prof_rec.counts)
    # the same number of steps of the same work, untimed, for the hooks
    profile["bytes"], profile["bytes_calls"] = tracing.count_bytes(
        lambda: harness.run_steps(step, harness.Record(), None, profile_steps), hooks, sync)
    with harness.patched(harness.span_wrappers(targets, rec.spans, sync)):
        harness.run_steps(step, rec, deadline)
    rec.profile = profile
    return rec


def measure(reg, workload: str, seed: int, seconds: float, trace: bool, device,
            started: float) -> dict:
    """One run of the cell on `device` (the card; the tests drive it on the
    CPU at toy sizes): set-up, the window, then the judge. The
    result line, its `checks` last."""
    import torch

    from mmbench import judge, trace as tracing

    work = reg.workload(workload)
    config = reg.config(work["config"])
    traffic = reg.traffic(work["traffic"])
    limits = reg.limits(workload)
    driver = reg.driver(traffic["driver"])
    metrics = reg.metrics_of(workload, "per_layer" if trace else "end_to_end")
    readers = {m["name"]: reg.metric(m["name"]) for m in metrics}
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    state = driver.setup(config, traffic, seed, device, limits["feature_clouds"])
    rec = window(driver, state, readers, seconds, trace, traffic["profile_steps"], sync, started)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    values = {name: r.read(rec) for name, r in readers.items()}

    outputs = driver.outputs(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, correct, _ = judge.judge(
        outputs, {**limits, "checks": {**config["guarantees"], **limits["checks"]}},
        device, seed)
    units = {m["name"]: m["unit"] for m in metrics}
    result = {
        "correct": bool(correct),
        "attempted": outputs["attempted"],
        "failed": outputs["failed"],
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": work["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        p = rec.profile
        result["device"].update(busy_s=p["busy_s"], window_s=p["wall_s"])
        result["breakdown"] = {"device_ops": tracing.top(p["device_s"]),
                               "idle_gaps": tracing.top(p["gaps_s"])}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    environment(ROOT)
    import torch

    from mmbench import harness

    reg = harness.Registry(ROOT)
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mmbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = measure(reg, args.workload, args.seed, args.seconds, bool(args.trace), device,
                     _STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"mmbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
