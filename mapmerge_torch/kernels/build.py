"""Build, load and guard the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use, into
`build/mapmerge_torch/` beside the package (listed in .gitignore), and is
keyed on a hash of the sources and flags, so a fresh checkout builds them on
its first kernel launch and a changed source is rebuilt.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("nn.cu", "spfh.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mapmerge_torch"
#: -fmad=false: no FMA contraction, so the kernels round every product and
#: sum as the plain PyTorch versions do (see the notes in csrc/)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel and its launch count.

    `launches` grows by one each time the wrapper launches the kernel, and
    nowhere else, so a run can show that it went through the kernel."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel it replaces
    route: str = "cuda"
    launches: int = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "mapmerge_torch are built from source on first use"
        )
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmapmerge_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compiler's report (-Xptxas -v: registers, shared memory, spills per
    kernel) is kept beside the library as `<name>.log`."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
        *(str(CSRC / s) for s in SOURCES),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{res.stderr}"
        )
    path.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, path)  # atomic: another process never loads a partial file
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mm_nearest_neighbor.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp]
            lib.mm_nearest_neighbor.restype = ci
            lib.mm_spfh.argtypes = [
                vp, vp, ci, ci, vp, vp, vp, ci, ctypes.c_longlong,
                ctypes.c_float, vp, vp, vp,
            ]
            lib.mm_spfh.restype = ci
            _lib = lib
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
