"""The host C++ of mapmerge_torch: the merge-graph solve and the LZF decoder.

ctypes bindings of `csrc/mapmerge_native.cpp` (the port's copy of the JAX
package's `mapmerge_tpu/native`), with that package's names and
signatures. The library is built with g++ at first use by
`kernels/build.py` (no nvcc needed). Where the JAX binding returns None,
these raise: a build failure is a RuntimeError and a malformed payload a
ValueError; nothing falls back to the plain Python versions
(`graph/merge_graph.compute_global_transforms_plain`,
`io/pcd._lzf_decompress`), which the tests and `chip_smoke.py` hold these
against. Each function counts its calls (`GRAPH_SOLVE.launches`,
`LZF_DECOMPRESS.launches`) as the kernel wrappers count their launches.
"""

from __future__ import annotations

import numpy as np

from mapmerge_torch.kernels import build

_SOURCE = "mapmerge_torch/csrc/mapmerge_native.cpp"
GRAPH_SOLVE = build.Kernel(
    "merge_graph_solve", _SOURCE, "mapmerge_tpu/native/mapmerge_native.cpp:136",
    route="host",
)
LZF_DECOMPRESS = build.Kernel(
    "lzf_decompress", _SOURCE, "mapmerge_tpu/native/mapmerge_native.cpp:101",
    route="host",
)
#: the C functions take int sizes
_INT_MAX = 2**31 - 1


def get_lib():
    """The host library's C functions (`lzf_decompress`, `merge_graph_solve`)
    as attributes, built with g++ on the first call. Where the JAX package's
    `get_lib` returns None, this raises: there is no fallback and no switch
    to turn the library off, so a missing or failing g++ is a RuntimeError."""
    return build.load(build.HOST_SOURCES)


def lzf_decompress(data: bytes, expected: int) -> bytes:
    """Decode a liblzf payload (PCD binary_compressed) of at most `expected`
    bytes. Raises ValueError for a malformed or truncated payload, or one
    that decodes to more than `expected` bytes."""
    data = bytes(data)
    if not 0 <= expected <= _INT_MAX or len(data) > _INT_MAX:
        raise ValueError(f"LZF sizes out of range: {len(data)} -> {expected} bytes")
    out = np.empty(expected, np.uint8)
    n = get_lib().lzf_decompress(data, len(data), out.ctypes.data, expected)
    LZF_DECOMPRESS.launched()
    if n < 0:
        raise ValueError(
            f"malformed LZF payload ({len(data)} bytes, at most {expected} expected)"
        )
    return out[:n].tobytes()


def merge_graph_solve(
    src: np.ndarray,
    tgt: np.ndarray,
    conf: np.ndarray,
    transforms: np.ndarray,
    conf_threshold: float,
) -> np.ndarray:
    """The global-consistency solve of the pairwise estimates (edge i: map
    src[i] -> map tgt[i], confidence conf[i], (4, 4) transform
    transforms[i]): (n_maps, 4, 4) float32 map -> reference transforms, a
    zero matrix for a map outside the largest component or beyond a failed
    pair. Confidences and the threshold are taken as float32."""
    src = np.ascontiguousarray(src, np.int32).reshape(-1)
    tgt = np.ascontiguousarray(tgt, np.int32).reshape(-1)
    conf = np.ascontiguousarray(conf, np.float32).reshape(-1)
    transforms = np.ascontiguousarray(transforms, np.float32).reshape(-1, 16)
    n_edges = len(src)
    if not len(tgt) == len(conf) == len(transforms) == n_edges:
        raise ValueError(
            f"{n_edges} sources, {len(tgt)} targets, {len(conf)} confidences "
            f"and {len(transforms)} transforms"
        )
    if n_edges and min(src.min(), tgt.min()) < 0:
        raise ValueError("negative map index")
    cap = int(max(src.max(), tgt.max())) + 1 if n_edges else 0
    out = np.zeros((max(cap, 1), 16), np.float32)
    n = get_lib().merge_graph_solve(
        src.ctypes.data, tgt.ctypes.data, conf.ctypes.data, transforms.ctypes.data,
        n_edges, float(conf_threshold), out.ctypes.data, out.shape[0],
    )
    GRAPH_SOLVE.launched()
    if n < 0:  # the C function's error return (its output too small)
        raise RuntimeError(f"merge_graph_solve: {cap} maps do not fit its output")
    return out[:n].reshape(n, 4, 4)
