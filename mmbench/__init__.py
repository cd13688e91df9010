"""mmbench: the benchmark of mapmerge_torch, the PyTorch and CUDA port.

Run one cell of `BENCHMARK.json` from the root of a checkout:

    python3 -m mmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by its name (see README.md).
"""
