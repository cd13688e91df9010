"""Build, load and guard the hand-written CUDA kernels of `csrc/`.

Each source is compiled with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes; the nvcc processes of all
sources run at once. The build runs at first use, into
`build/mapmerge_torch/` beside the package (listed in .gitignore), and each
library is keyed on a hash of its source and the flags, so a fresh checkout
builds them on its first kernel launch and a changed source is rebuilt.
"""

from __future__ import annotations

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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mapmerge_torch"
#: -fmad=false: no FMA contraction, so the kernels round every product and
#: sum as the plain PyTorch versions do (see the notes in csrc/)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: source -> {C function: argument types}; every function returns the CUDA
#: error code of its launches
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
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel and its launch count.

    `launches` grows by one each time the wrapper launches the kernel, and
    nowhere else, so a run can show that it went through the kernel. It is
    one count for the whole process: rank threads add to it under a lock."""

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


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library does not exist yet, all at once.

    The compiler's report (-Xptxas -v: registers, shared memory, spills per
    kernel) is kept beside each library as `<name>.log`."""
    paths = {s: library_path(s) for s in SOURCES}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for source, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / source)]
        procs[source] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for source, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}: nvcc exit code {proc.returncode}:\n{out}")
            continue
        path = todo[source]
        path.with_suffix(".log").write_text(out)
        os.replace(tmp, path)  # atomic: another process never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return paths


def load() -> types.SimpleNamespace:
    """The kernels' C functions, as attributes, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for source, path in build().items():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SOURCES[source].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _ci
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
    return _lib


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
    return torch.cuda.current_stream(device).cuda_stream
