"""Where kernel L spends its time on one card: the attributes of each of
its instantiations, and a clock64 split of its sweep route.

    python3 mapmerge_torch/testing/reduce_split.py INPUTS.pt ROOT [PREFIX]

INPUTS.pt is a file of kernel_ab.py `record-harris` (or `record-grid`);
ROOT a checkout of the port (this one, or an earlier commit unpacked with
`git archive` into a directory that .gitignore lists). Nothing of ROOT is
edited: its `csrc/grid.cu` is copied into `build/reduce_split/` and built
twice with its own flags (kernels/build.NVCC_FLAGS):

- as it is, with one C function appended that reads, for each of L's
  instantiations (and H's and I's, for comparison), cudaFuncGetAttributes
  (registers a thread, bytes of local memory a thread, which is where
  spills go, static shared memory a block) and
  cudaOccupancyMaxActiveBlocksPerMultiprocessor at the kernel's own block
  size, so the resident warps an SM;
- with clock64 counters patched into `grid_radius_kernel` (the sweep
  route's kernel, L's sum and, where the checkout's max has no kernel of
  its own, L's max) and into `ReduceOp::tile`: per warp that takes a
  unit, lane 0's cycles from the unit's start to the end of its walk
  (`total`), those spent consuming a tile (`consume`: the values' loads
  issued and the tile rewritten as float4 points, `stage`; each lane's
  members marked, `mark`, the warp synchronised after it; the values
  stored to shared memory, which waits for their loads, `store`; the
  members' values added or maxed, `add`), summed over the warps with one
  atomic a warp at the end. The walk (the next tile found, issued and
  waited for) is total - consume. The counters' reads and syncs cost time
  of their own: the patched kernel's device time is printed beside the
  unpatched one's.

Every sweep input whose name starts with PREFIX ("grid_reduce " by
default) runs through ROOT's kernels/grid.reduce with the patched library
in place of the built one; one JSON line holds the card, the attributes,
and per input the device times and the split as shares of `total`.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import torch

#: L's instantiations, and H's and I's, by the form of the checkout's
#: grid.cu: a ReduceOp<kMax> for the sum and the max, or a ReduceOp of a
#: fixed width for the sum and the max on a kernel of its own
KERNELS = {
    "ReduceOp<true>": (
        ("L sweep sum", "grid_radius_kernel<ReduceOp<false>, false>"),
        ("L sweep max", "grid_radius_kernel<ReduceOp<true>, false>"),
        ("L list sum", "grid_reduce_list_kernel<false>"),
        ("L list max", "grid_reduce_list_kernel<true>"),
    ),
    "grid_max_kernel": (
        ("L sweep sum C=6", "grid_radius_kernel<ReduceOp<6>, false>"),
        ("L sweep sum C=9", "grid_radius_kernel<ReduceOp<9>, false>"),
        ("L sweep sum C=1", "grid_radius_kernel<ReduceOp<1>, false>"),
        ("L sweep sum generic", "grid_radius_kernel<ReduceOp<0>, false>"),
        ("L sweep max C=1", "grid_max_kernel<1, false>"),
        ("L sweep max C=6", "grid_max_kernel<6, false>"),
        ("L sweep max C=9", "grid_max_kernel<9, false>"),
        ("L sweep max generic", "grid_max_kernel<0, false>"),
        ("L list sum C=9", "grid_reduce_list_kernel<false, 9>"),
        ("L list sum C=6", "grid_reduce_list_kernel<false, 6>"),
        ("L list sum C=1", "grid_reduce_list_kernel<false, 1>"),
        ("L list sum generic", "grid_reduce_list_kernel<false, 0>"),
        ("L list max C=1", "grid_reduce_list_kernel<true, 1>"),
        ("L list max generic", "grid_reduce_list_kernel<true, 0>"),
    ),
}
COMMON = (("H", "grid_radius_kernel<MomentsOp, false>"), ("I", "grid_count_kernel<false>"))
#: the split's counters, summed over the warps
SPLIT = ("total", "consume", "stage", "mark", "store", "add", "units", "tiles")


def attributes_source(src: str) -> str:
    """grid.cu with mm_reduce_attributes appended: for kernel i of the
    checkout's list, 5 ints (registers a thread, local bytes a thread,
    static shared bytes a block, threads a block, resident blocks an
    SM)."""
    form = next(k for k in KERNELS if k in src)
    names = KERNELS[form] + COMMON
    table = ",\n".join(f"    reinterpret_cast<const void*>({fn})" for _, fn in names)
    return src + f"""
extern "C" int mm_reduce_attributes(int* out) {{
  const void* fns[] = {{
{table}
  }};
  for (int i = 0; i < {len(names)}; ++i) {{
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[5 * i] = a.numRegs;
    out[5 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[5 * i + 2] = static_cast<int>(a.sharedSizeBytes);
    out[5 * i + 3] = kThreads;
    out[5 * i + 4] = blocks;
  }}
  return 0;
}}
"""


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"reduce_split: the anchor {old!r} is not in grid.cu once")
    return text.replace(old, new)


def split_source(src: str) -> str:
    """grid.cu with the clock64 counters of the module docstring patched in
    (each anchor must occur once, or the script stops)."""
    head = ("__device__ unsigned long long g_split[8];\n"
            "extern \"C\" int mm_split_read(unsigned long long* out, int reset) {\n"
            "  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));\n"
            "  if (err == cudaSuccess && reset) {\n"
            "    unsigned long long zero[8] = {};\n"
            "    err = cudaMemcpyToSymbol(g_split, zero, sizeof(zero));\n"
            "  }\n"
            "  return static_cast<int>(err);\n"
            "}\n")
    src = _once(src, '#include "cull.cuh"\n', '#include "cull.cuh"\n' + head)
    # every op's scratch carries the warp's marking and adding cycles
    src = _once(src, "  struct Scratch {};\n",
                "  struct Scratch {\n    long long split_mark, split_store, split_add;\n  };\n")
    src = _once(src, "struct SmoothScratch {\n",
                "struct SmoothScratch {\n  long long split_mark, split_store, split_add;\n")
    src = re.sub(r"(struct ReduceScratch \{\n)",
                 r"\1  long long split_mark, split_store, split_add;\n", src, count=1)
    # ReduceOp::tile: marking, storing, adding
    i = src.index("struct ReduceOp")
    j = src.index("\n};\n", i)
    op = src[i:j]
    op = _once(op, "    unsigned m = 0;\n",
               "    unsigned m = 0;\n    __syncwarp();\n    const long long split_a = clock64();\n")
    op, n = re.subn(r"(\n    \}\n)(    const int (?:w = width\(\), )?total)",
                    r"\1    __syncwarp();\n    const long long split_b = clock64();\n\2", op,
                    count=1)
    if n != 1:
        raise SystemExit("reduce_split: ReduceOp::tile's marking has no end to patch")
    op = _once(op, "    __syncwarp();\n    const int added = __popc(m);\n",
               "    __syncwarp();\n    const long long split_c = clock64();\n"
               "    const int added = __popc(m);\n")
    op = _once(op, "    return added;\n",
               "    __syncwarp();\n    if ((threadIdx.x & 31) == 0) {\n"
               "      x.split_mark += split_b - split_a;\n"
               "      x.split_store += split_c - split_b;\n"
               "      x.split_add += clock64() - split_c;\n    }\n    return added;\n")
    src = src[:i] + op + src[j:]
    # grid_radius_kernel: the unit's total, its consumes and their staging
    i = src.index("grid_radius_kernel(")
    j = src.index("\n}\n", i)
    k = src[i:j]
    k = _once(k, "  NearTiles walk;\n",
              "  if (lane == 0) {\n    sh.scratch.split_mark = 0;\n    sh.scratch.split_store = 0;\n"
              "    sh.scratch.split_add = 0;\n  }\n  __syncwarp();\n"
              "  const long long split_t0 = clock64();\n"
              "  long long split_consume = 0, split_stage = 0, split_tiles = 0;\n"
              "  NearTiles walk;\n")
    k = _once(k, "    const GridStage& g = s;\n",
              "    const long long split_c0 = clock64();\n    const GridStage& g = s;\n")
    k = re.sub(r"(\n)(    const int added = op\.tile\([^\n]*\n)",
               r"\1    __syncwarp();\n    const long long split_s = clock64();\n\2"
               r"    __syncwarp();\n    split_stage += split_s - split_c0;\n"
               r"    split_consume += clock64() - split_c0;\n    ++split_tiles;\n",
               k, count=1)
    k = _once(k, "  if (active) op.write(",
              "  __syncwarp();\n  if (lane == 0) {\n"
              "    atomicAdd(&g_split[0], static_cast<unsigned long long>(clock64() - split_t0));\n"
              "    atomicAdd(&g_split[1], static_cast<unsigned long long>(split_consume));\n"
              "    atomicAdd(&g_split[2], static_cast<unsigned long long>(split_stage));\n"
              "    atomicAdd(&g_split[3], static_cast<unsigned long long>(sh.scratch.split_mark));\n"
              "    atomicAdd(&g_split[4], static_cast<unsigned long long>(sh.scratch.split_store));\n"
              "    atomicAdd(&g_split[5], static_cast<unsigned long long>(sh.scratch.split_add));\n"
              "    atomicAdd(&g_split[6], 1ull);\n"
              "    atomicAdd(&g_split[7], static_cast<unsigned long long>(split_tiles));\n"
              "  }\n  if (active) op.write(")
    return src[:i] + k + src[j:]


def build_copy(root: Path, out_dir: Path, name: str, text: str, build) -> ctypes.CDLL:
    """`text` compiled as out_dir/name.cu beside a copy of ROOT's headers,
    with the package's nvcc flags; the ptxas report printed to stderr."""
    for header in (root / "mapmerge_torch" / "csrc").glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                           str(cu)], capture_output=True, text=True, timeout=900)
    if done.returncode != 0:
        raise SystemExit(f"reduce_split: nvcc failed on {cu}:\n{done.stdout}{done.stderr}")
    (out_dir / f"{name}.log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(so))


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("reduce_split: no CUDA device; this script needs a GPU")
    inputs_path, root = Path(argv[0]), Path(argv[1]).resolve()
    prefix = argv[2] if len(argv) == 3 else "grid_reduce "
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from kernel_ab import _as_grid, device_ms

    from mapmerge_torch.kernels import build
    from mapmerge_torch.kernels import grid as kgrid

    src = (root / "mapmerge_torch" / "csrc" / "grid.cu").read_text()
    out_dir = Path(__file__).resolve().parents[2] / "build" / "reduce_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    form = next(k for k in KERNELS if k in src)
    names = KERNELS[form] + COMMON
    plain_lib = build_copy(root, out_dir, "grid_attributes", attributes_source(src), build)
    attrs = (ctypes.c_int * (5 * len(names)))()
    err = plain_lib.mm_reduce_attributes(attrs)
    if err != 0:
        raise SystemExit(f"reduce_split: mm_reduce_attributes failed with error {err}")
    table = {}
    for i, (label, fn) in enumerate(names):
        regs, local, shared, threads, blocks = attrs[5 * i : 5 * i + 5]
        table[label] = {"kernel": fn, "registers": regs, "local_bytes": local,
                        "shared_bytes": shared, "threads": threads, "blocks_per_sm": blocks,
                        "warps_per_sm": blocks * threads // 32}
    split_lib = build_copy(root, out_dir, "grid_split", split_source(src), build)
    split_lib.mm_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    patched = {}
    for name, argtypes in build.SOURCES["grid.cu"].items():
        fn = getattr(split_lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        patched[name] = fn
    patched_ns = types.SimpleNamespace(**patched)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    loaded = torch.load(inputs_path, map_location=f"cuda:{torch.cuda.current_device()}")
    result = {"root": str(root), "card": card, "attributes": table, "split": {}}
    buf = (ctypes.c_ulonglong * 8)()
    for name, (args, _) in sorted(loaded.items()):
        if not name.startswith(prefix) or name.startswith("grid_reduce_list"):
            continue
        args = [_as_grid(a) for a in args]
        kgrid.reduce(*args)
        unpatched = device_ms(lambda: kgrid.reduce(*args))
        load = build.load
        build.load = lambda *a: patched_ns
        try:
            kgrid.reduce(*args)  # warm
            torch.cuda.synchronize()
            split_lib.mm_split_read(ctypes.cast(buf, ctypes.c_void_p), 1)
            kgrid.reduce(*args)
            torch.cuda.synchronize()
            split_lib.mm_split_read(ctypes.cast(buf, ctypes.c_void_p), 1)
            counts = dict(zip(SPLIT, (int(v) for v in buf)))
            instrumented = device_ms(lambda: kgrid.reduce(*args))
        finally:
            build.load = load
        total = max(counts["total"], 1)
        shares = {k: counts[k] / total for k in ("consume", "stage", "mark", "store", "add")}
        shares["walk"] = (counts["total"] - counts["consume"]) / total
        result["split"][name] = {
            "cycles": counts, "shares": shares,
            "cycles_per_unit": counts["total"] / max(counts["units"], 1),
            "device_ms": unpatched, "instrumented_device_ms": instrumented,
        }
        del args
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
