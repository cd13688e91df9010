"""Build, load and guard the hand-written code of `csrc/`: the CUDA kernels
and the host C++ library.

Each source is compiled into its own shared library with a plain C
interface, loaded with ctypes: a `.cu` kernel source with nvcc for sm_90a,
the host library `mapmerge_native.cpp` with g++ (which needs no nvcc, so it
builds on a machine without CUDA too). The compilers of all the sources a
build needs run at once. The build runs at first use, into `BUILD_DIR`:
`build/mapmerge_torch/` of a source checkout (listed in .gitignore), or, for
an installed package, the user's cache directory
(`$XDG_CACHE_HOME/mapmerge_torch/`, `~/.cache/mapmerge_torch/` when that is
unset), since a site-packages may not be writable. Each library is keyed on
a hash of its source, its flags and, for a kernel, the headers of `csrc/`,
so a fresh checkout builds them on first use and a changed source or header
is rebuilt. There is no fallback: a compiler that is missing or fails
raises, and so does a build directory that cannot be created.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

import torch


def build_dir(package_root: Path) -> Path:
    """Where the libraries of the package at `package_root` are built: in a
    source checkout (the package's parent directory holds the repository's
    pyproject.toml, which names the package) `build/mapmerge_torch/` there;
    otherwise `mapmerge_torch/` in the user's cache directory, the
    platform's $XDG_CACHE_HOME (an absolute path) or ~/.cache."""
    pyproject = package_root.parent / "pyproject.toml"
    if pyproject.is_file() and "mapmerge_torch" in pyproject.read_text():
        return package_root.parent / "build" / "mapmerge_torch"
    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "mapmerge_torch"


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir(CSRC.parent)
#: -fmad=false: no FMA contraction, so the kernels round every product and
#: sum as the plain PyTorch versions do (see the notes in csrc/)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
#: the host library's flags, the JAX package's own (mapmerge_tpu/native/
#: __init__.py): no fast-math and no -march, so both libraries built on one
#: host give the same bits
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_vp, _ci, _cf, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: source -> {C function: argument types}; every function returns an int,
#: for a kernel the CUDA error code of its launches
SOURCES = {
    "nn.cu": {
        "mm_nearest_neighbor_batched": [
            _vp, _ci, _ci, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _vp,
        ],
    },
    "spfh.cu": {
        "mm_spfh_shared": [
            _vp, _vp, _ci, _ci, _vp, _vp, _vp, _ci, _cf, _cf, _cf, _vp, _vp, _vp,
            _vp, _vp,
        ],
        "mm_spfh_grid": [
            _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _vp, _cf, _cf, _vp,
            _vp, _vp,
        ],
    },
    "tiles.cu": {
        "mm_tiles_pack": [_vp, _vp, _vp, _ci, _vp, _vp, _vp],
    },
    "sift.cu": {
        # the reciprocals of 2 s^2 in host memory (a ctypes float array)
        "mm_sift_scale_space": [
            _vp, _vp, _ci, _vp, _ci, ctypes.POINTER(_cf), _ci, _cf, _vp, _vp,
        ],
        "mm_sift_knn": [_vp, _vp, _ci, _vp, _ci, _ci, _cf, _ci, _vp, _vp, _vp],
    },
    "radius.cu": {
        # the workspace: null on the resident route
        "mm_radius_count": [_vp, _vp, _ci, _vp, _ci, _cf, _vp, _vp, _vp],
        "mm_radius_moments": [_vp, _vp, _ci, _vp, _ci, _cf, _vp, _vp, _vp],
        "mm_radius_order": [_vp, _vp, _ci, _cf, _vp, _vp],
    },
    "grid.cu": {
        # G and K: the pre-pass's buffers; the counters (null on the
        # package's calls) and their length; H, I and J take the same
        "mm_grid_pack": [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _ci, _vp],
        "mm_grid_nn": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _ci, _vp,
            _ci, _vp, _ci, _vp, _vp, _vp, _cll, _vp,
        ],
        "mm_grid_moments": [
            _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _vp, _vp, _ci, _vp,
            _vp, _vp, _vp, _cll, _vp,
        ],
        "mm_grid_count": [
            _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _ci, _vp, _vp, _ci,
            _vp, _vp, _cll, _vp,
        ],
        # the reciprocals of 2 s^2 in host memory (a ctypes float array)
        "mm_grid_smooth": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf,
            ctypes.POINTER(_cf), _ci, _vp, _vp, _ci, _vp, _vp, _cll, _vp,
        ],
        "mm_grid_knn": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _ci, _ci, _ci,
            _vp, _vp, _ci, _vp, _vp, _vp, _vp, _cll, _vp,
        ],
        # L: the values and their channels, 1 for the max, then H's operands
        "mm_grid_reduce": [
            _vp, _vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf,
            _vp, _vp, _ci, _vp, _vp, _vp, _cll, _vp,
        ],
        # L's list route: the target's tile boxes, no query grid, the cell
        # edge's float32 reciprocal
        "mm_grid_reduce_list": [
            _vp, _vp, _vp, _vp, _vp, _ci, _ci, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _cf, _cf,
            _vp, _vp, _vp,
        ],
    },
    "mapmerge_native.cpp": {
        # the decoded size, or -1 for a malformed payload
        "lzf_decompress": [ctypes.c_char_p, _ci, _vp, _ci],
        # the number of maps, or -1 if the output is too small
        "merge_graph_solve": [_vp, _vp, _vp, _vp, _ci, _cf, _vp, _ci],
    },
}
#: the CUDA kernels' sources and the host library's
KERNEL_SOURCES = ("nn.cu", "spfh.cu", "tiles.cu", "sift.cu", "radius.cu", "grid.cu")
HOST_SOURCES = ("mapmerge_native.cpp",)

_lock = threading.Lock()
#: sources -> their C functions, loaded
_loaded: dict[tuple[str, ...], types.SimpleNamespace] = {}


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel, or a function of the host library, and its
    launch count.

    `launches` grows by one each time the wrapper launches the kernel (calls
    the host function), and nowhere else, so a run can show that it went
    through it. It is one count for the whole process: rank threads add to
    it under a lock."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel it replaces
    route: str = "cuda"
    launches: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def launched(self) -> None:
        """Count one launch (called by the wrapper after the launch)."""
        with self._lock:
            self.launches += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "mapmerge_torch are built from source on first use"
        )
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found (PATH): the host library of mapmerge_torch "
            "(csrc/mapmerge_native.cpp) is built from source on first use"
        )
    return gxx


def _flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS


def library_path(source: str) -> Path:
    """Where `source`'s library is built: keyed on its flags, its bytes and,
    for a kernel source, the names and bytes of every header `csrc/*.cuh`
    (which it may include), so an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(_flags(source)).encode())
    h.update((CSRC / source).read_bytes())
    if source.endswith(".cu"):
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(sources=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every one of `sources` whose library does not exist yet, all
    at once, each with its own compiler: nvcc for a `.cu`, g++ otherwise.

    The compiler's report (for nvcc -Xptxas -v: registers, shared memory,
    spills per kernel) is kept beside each library as `<name>.log`."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    # every compiler is found before any starts, so a missing one leaves no
    # process behind
    cmds = {
        s: ("nvcc", [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v"]) if s.endswith(".cu")
        else ("g++", [_gxx(), *GXX_FLAGS])
        for s in todo
    }
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f"cannot create the build directory {BUILD_DIR} of mapmerge_torch's "
            f"kernels and host library: {e}"
        ) from e
    procs = {}
    for source, (compiler, cmd) in cmds.items():
        tmp = todo[source].with_name(f"{todo[source].name}.{os.getpid()}.tmp")
        procs[source] = (compiler, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = {}
    for source, (compiler, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed[f"{source}: {compiler} exit code {proc.returncode}:\n{out}"] = compiler
            continue
        path = todo[source]
        path.with_suffix(".log").write_text(out)
        os.replace(tmp, path)  # atomic: another process never loads a partial file
    if failed:
        raise RuntimeError(" and ".join(sorted(set(failed.values()))) + " failed\n"
                           + "\n".join(failed))
    return paths


def load(sources=KERNEL_SOURCES) -> types.SimpleNamespace:
    """The C functions of `sources` (the CUDA kernels unless named), as
    attributes, built on first use."""
    sources = tuple(sources)
    with _lock:
        if sources not in _loaded:
            fns = {}
            for source, path in build(sources).items():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SOURCES[source].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _ci
                    fns[name] = fn
            _loaded[sources] = types.SimpleNamespace(**fns)
        return _loaded[sources]


def cuda_device(kernel: Kernel, t: torch.Tensor) -> torch.device:
    """The CUDA device of a launch's operand `t`; any other device raises
    (a wrapper takes its plain version only on the CPU)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {t.device}")
    return t.device


def check_launch(kernel: Kernel, err: int) -> None:
    """Raise if the launch returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")


def require(
    name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
    device: torch.device,
) -> None:
    """Check a kernel operand: device, dtype, shape (None = any) and
    contiguity. The kernels take nothing else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The handle of PyTorch's current stream on `device`, the raw value of
    torch.cuda.current_stream(device).cuda_stream without building a Stream
    object (0.1 µs against 3-7 µs a call on an H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device_guard(device: torch.device):
    """torch.cuda.device(device) where `device` is not the current CUDA
    device, else a context that does nothing (entering the guard costs 2-3
    µs a call on an H100's host)."""
    if device.type == "cuda" and device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
