"""Online merge node launcher (port of mapmerge_tpu/tools/node_cli.py).

The reference's map_merge_node executable and launch files
(src/map_merge_node.cpp:253-267, launch/map_merge.launch,
launch/from_pcds.launch): runs MapMergeNode on the card over a directory
transport (each `<robot>.pcd` in --watch-dir is a robot's latest map;
overwrite the file to publish an update), writes the latched merged map to
--output whenever it changes, and prints pose updates (the tf broadcast).

Usage:
  python -m mapmerge_torch.tools.node_cli --watch-dir maps/ \\
      [--config params.yaml|json] [--output merged.pcd]
      [--compositing-rate 0.3] [--discovery-rate 0.05]
      [--estimation-rate 0.01] [--run-seconds 0] [--param value ...]

`--config` gives node rates, watch dir, output and any merge parameter in
one YAML or JSON file (launch/map_merge.launch:1-15); flags on the command
line override the file.
"""

from __future__ import annotations

import json
import signal
import sys
import time

import numpy as np

from mapmerge_torch.core.params import MergeParams

#: node-level keys of a config file (map_merge.launch:5-13); every other key
#: is a MergeParams field
NODE_KEYS = (
    "watch_dir",
    "output",
    "compositing_rate",
    "discovery_rate",
    "estimation_rate",
    "run_seconds",
)


def load_config(path: str) -> dict:
    """A YAML or JSON params file as a flat dict."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError(f"config {path}: expected a mapping at top level")
    return data


def resolve_config(argv: list[str]) -> tuple[dict, MergeParams]:
    """Node settings and merge params from argv and an optional `--config`
    file: flags override the file, which overrides the defaults.
    Returns (node settings, MergeParams)."""
    cfg: dict = {}
    if "--config" in argv:
        cfg = load_config(argv[argv.index("--config") + 1])

    def opt(name: str, default):
        if name in argv:
            return type(default)(argv[argv.index(name) + 1])
        key = name[2:].replace("-", "_")
        if key in cfg:
            return type(default)(cfg[key])
        return default

    node_settings = dict(
        watch_dir=opt("--watch-dir", ""),
        output=opt("--output", "merged.pcd"),
        compositing_rate=opt("--compositing-rate", 0.3),
        discovery_rate=opt("--discovery-rate", 0.05),
        estimation_rate=opt("--estimation-rate", 0.01),
        run_seconds=opt("--run-seconds", 0.0),  # 0 = until SIGINT
    )
    merge_cfg = {k: v for k, v in cfg.items() if k not in NODE_KEYS}
    merge_cfg.update(MergeParams.command_line_overrides(argv))
    return node_settings, MergeParams.from_dict(merge_cfg)


def main(argv: list[str] | None = None, *, device=None) -> int:
    """Run the node until SIGINT / SIGTERM or --run-seconds. `device`: where
    the node runs (the current CUDA device when None)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    settings, params = resolve_config(argv)
    watch_dir = settings["watch_dir"]
    if not watch_dir:
        print("--watch-dir is required", file=sys.stderr)
        return 1
    output = settings["output"]
    rates = {
        k: settings[k]
        for k in ("compositing_rate", "discovery_rate", "estimation_rate")
    }
    run_seconds = settings["run_seconds"]

    from mapmerge_torch.io.pcd import write_pcd
    from mapmerge_torch.runtime.node import MapMergeNode
    from mapmerge_torch.runtime.transport import DirectoryTransport

    print(params)

    def on_pose(robot: str, t: np.ndarray):
        trans = t[:3, 3] if t.any() else None
        print(f"[tf] {robot}: {'FAILED' if trans is None else trans}", flush=True)

    node = MapMergeNode(
        DirectoryTransport(watch_dir),
        params=params,
        pose_callback=on_pose,
        device=device,
        **rates,
    )

    stop = {"flag": False}
    handlers = {
        sig: signal.signal(sig, lambda *_: stop.__setitem__("flag", True))
        for sig in (signal.SIGINT, signal.SIGTERM)
    }
    deadline = time.time() + run_seconds if run_seconds else None
    last_stamp = 0.0
    try:
        with node:
            print(f"watching {watch_dir} (Ctrl-C to stop)", flush=True)
            while not stop["flag"]:
                if deadline and time.time() > deadline:
                    break
                merged = node.get_merged_map()
                stamp = node._merged_stamp
                if merged is not None and stamp > last_stamp:
                    xyz, rgb = merged.to_numpy()
                    write_pcd(output, (xyz, rgb))
                    print(
                        f"[map] wrote {len(xyz)} points -> {output} "
                        f"(robots: {node.get_robots()})",
                        flush=True,
                    )
                    last_stamp = stamp
                time.sleep(0.5)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    print("node stopped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
