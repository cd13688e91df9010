"""mapmerge_torch.native (csrc/mapmerge_native.cpp, built with g++ at first
use) against mapmerge_tpu.native and against the port's plain Python
versions.

Tolerances: the merge-graph solve is bit for bit the JAX package's native
solve (the same source, flags and host) on every case; against the plain
version (`compute_global_transforms_plain`, float32 chaining) the same maps
are registered and the transforms agree within 1e-5. The LZF decoder gives
the same bytes as the plain decoder and the JAX package's, and both port
decoders raise ValueError on a malformed payload. `get_lib` exposes the JAX
binding's functions, and every source the port builds ships as package
data, so an installed port can build it.
"""

import fnmatch
import hashlib
import pathlib
import tomllib

import numpy as np
import pytest

from mapmerge_tpu.graph import merge_graph as jmg
from mapmerge_torch import native
from mapmerge_torch.graph import merge_graph as tmg
from mapmerge_torch.io import pcd as tpcd
from mapmerge_torch.kernels import build
from mapmerge_torch.testing.lzf import lzf_compress, pcd_payload, write_pcd_compressed
from test_torch_graph import GRAPHS, _graph, _rigid
from torch_parity import jax_native  # noqa: F401  (a fixture)

#: native against plain: the plain chain rounds to float32 at every step
PLAIN_TOL = 1e-5


def _both(ests):
    """(source, target, transform, confidence, ambiguous) tuples as both
    packages' estimates."""
    return ([jmg.TransformEstimate(*e) for e in ests],
            [tmg.TransformEstimate(*e) for e in ests])


def _chain(rng, n, bad=None):
    """A chain 0-1-...-(n-1) of noisy rigid pairs; edge (i, i+1) holds
    `bad` when i == 1."""
    truth = [_rigid(rng) for _ in range(n)]
    ests = []
    for i in range(n - 1):
        t = np.linalg.inv(truth[i + 1]) @ truth[i] @ _rigid(rng, 0.005, 0.02)
        if i == 1 and bad is not None:
            t = bad
        ests.append((i, i + 1, np.asarray(t, np.float32), 0.5, False))
    return ests


def config5_tick(seed=50, n=50):
    """Every pair of n maps (n = 50: 1,225 edges, config5's last tick),
    noisy rigid estimates, about a tenth failed, a fifth ambiguous."""
    rng = np.random.default_rng(seed)
    truth = [_rigid(rng) for _ in range(n)]
    ests = []
    for i in range(n - 1):
        for j in range(i + 1, n):
            t = np.linalg.inv(truth[j]) @ truth[i] @ _rigid(rng, 0.01, 0.05)
            if rng.random() < 0.1:
                t = np.zeros((4, 4))
            ests.append((i, j, t.astype(np.float32), float(rng.uniform(0.05, 1.0)),
                         bool(rng.random() < 0.2)))
    return ests, 0.2


#: a rank-3 transform (its last row zero): no inverse, though not a zero matrix
SINGULAR = np.array([[1, 0, 0, 1], [0, 1, 0, 2], [0, 0, 1, 3], [0, 0, 0, 0]], np.float32)


def _tie():
    """A triangle whose edges (1, 2) and (0, 2) tie in float32 and differ in
    float64: the stable order on float32 puts (1, 2) into the tree."""
    rng = np.random.default_rng(11)
    c = 0.7
    assert np.float32(c + 1e-9) == np.float32(c) and c + 1e-9 != c
    return [(0, 1, _rigid(rng).astype(np.float32), 0.9, False),
            (1, 2, _rigid(rng).astype(np.float32), c, False),
            (0, 2, _rigid(rng).astype(np.float32), c + 1e-9, False)], 0.0


def _cases():
    cases = {f"graph_seed{g[0]}": (lambda g=g: (_graph(*g), g[-1])) for g in GRAPHS}
    cases.update({
        "config5_50_maps": lambda: (_both(config5_tick()[0]), config5_tick()[1]),
        "failed_pair_on_tree": lambda: (
            _both(_chain(np.random.default_rng(1), 4, np.zeros((4, 4)))), 0.0),
        "singular_on_tree": lambda: (
            _both(_chain(np.random.default_rng(2), 4, SINGULAR)), 0.0),
        "float32_tie": lambda: (_both(_tie()[0]), 0.0),
        "all_below_threshold": lambda: (
            _both(config5_tick(seed=3, n=6)[0]), 2.0),
        "no_edges": lambda: (([], []), 0.0),
    })
    return cases


CASES = _cases()


def _arrays(ests):
    return (np.asarray([e.source_idx for e in ests], np.int32),
            np.asarray([e.target_idx for e in ests], np.int32),
            np.asarray([e.confidence for e in ests], np.float32),
            np.asarray([e.transform for e in ests], np.float32).reshape(-1, 4, 4))


@pytest.mark.parametrize("case", list(CASES))
def test_graph_solve_matches_jax_native(case, jax_native):
    (j_est, t_est), threshold = CASES[case]()
    ours = native.merge_graph_solve(*_arrays(t_est), threshold)
    theirs = jax_native.merge_graph_solve(*_arrays(j_est), threshold)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    entry = tmg.compute_global_transforms(t_est, threshold)
    assert len(entry) == len(jmg.compute_global_transforms(j_est, threshold))
    for a, b in zip(entry, jmg.compute_global_transforms(j_est, threshold)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_graph_solve_matches_plain(case):
    (_, t_est), threshold = CASES[case]()
    ours = tmg.compute_global_transforms(t_est, threshold)
    plain = tmg.compute_global_transforms_plain(t_est, threshold)
    assert len(ours) == len(plain)
    assert [bool(t.any()) for t in ours] == [bool(t.any()) for t in plain]
    for a, b in zip(ours, plain):
        assert b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=PLAIN_TOL)


def test_singular_transform_leaves_the_maps_beyond_unregistered():
    """The maps beyond a singular, non-zero estimate on the tree are zeros
    in both port paths (np.linalg.inv raises on it, as the JAX package's
    pure-Python path did)."""
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.inv(SINGULAR)
    (_, t_est), threshold = CASES["singular_on_tree"]()
    for solve in (tmg.compute_global_transforms, tmg.compute_global_transforms_plain):
        out = solve(t_est, threshold)
        # centre 1: map 0 is reached directly, 2 across the singular edge, 3 beyond
        assert [bool(t.any()) for t in out] == [True, True, False, False]


def test_float32_tie_keeps_the_stable_order():
    """Confidences that tie in float32 keep their input order: the tree takes
    edge (1, 2), as with an exact tie, and not (0, 2), as float64 would."""
    ests, threshold = _tie()
    solve = tmg.compute_global_transforms
    got = solve(_both(ests)[1], threshold)
    exact_tie = [e if e[:2] != (0, 2) else (*e[:3], 0.7, False) for e in ests]
    above = [e if e[:2] != (0, 2) else (*e[:3], 0.8, False) for e in ests]
    for a, b in zip(got, solve(_both(exact_tie)[1], threshold)):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b)
                   for a, b in zip(got, solve(_both(above)[1], threshold)))


def test_graph_solve_counts_its_calls():
    (_, t_est), threshold = CASES["graph_seed0"]()
    before = native.GRAPH_SOLVE.launches
    tmg.compute_global_transforms(t_est, threshold)
    tmg.compute_global_transforms_plain(t_est, threshold)
    assert native.GRAPH_SOLVE.launches == before + 1


def _literals(payload: bytes) -> bytes:
    return b"".join(bytes([len(payload[s:s + 32]) - 1]) + payload[s:s + 32]
                    for s in range(0, len(payload), 32))


def _backref(length: int, offset: int) -> bytes:
    """A back reference of `length` (>= 3) bytes from `offset` (>= 1) bytes
    back: the length-extension byte from 9 bytes on."""
    code, off = length - 2, offset - 1
    if code < 7:
        return bytes([(code << 5) | (off >> 8), off & 0xFF])
    return bytes([(7 << 5) | (off >> 8), code - 7, off & 0xFF])


def _points_payload():
    rng = np.random.default_rng(5)
    xyz = (rng.integers(0, 200, (20_000, 3)) * 0.05).astype(np.float32)
    rgb = rng.integers(0, 4, (20_000, 3)).astype(np.float32) / 3.0
    raw = pcd_payload(xyz, rgb)
    return lzf_compress(raw), raw


LZF = {
    "literals": lambda: (_literals(bytes(range(256)) * 2 + b"tail"),
                         bytes(range(256)) * 2 + b"tail"),
    "back_reference": lambda: (_literals(b"abcdef") + _backref(3, 6), b"abcdefabc"),
    "overlapping_back_reference": lambda: (_literals(b"ab") + _backref(8, 2),
                                           b"ab" * 5),
    "length_extension": lambda: (
        _literals(bytes(range(40))) + _backref(20, 39) + _backref(264, 1),
        bytes(range(40)) + bytes(range(1, 21)) + bytes([20]) * 264),
    "points_20000": _points_payload,
}


@pytest.mark.parametrize("case", list(LZF))
def test_lzf_bytes_equal(case, jax_native):
    stream, raw = LZF[case]()
    before = native.LZF_DECOMPRESS.launches
    assert native.lzf_decompress(stream, len(raw)) == raw
    assert native.LZF_DECOMPRESS.launches == before + 1
    assert tpcd._lzf_decompress(stream, len(raw)) == raw
    assert jax_native.lzf_decompress(stream, len(raw)) == raw


MALFORMED = {
    # a literal run of 10 bytes with 5 left; a back reference without its
    # offset byte; without its length-extension byte
    "truncated_literals": (b"\x09abcde", 10),
    "truncated_back_reference": (_literals(b"abc") + b"\x20", 10),
    "truncated_extension": (_literals(b"abc") + b"\xe0", 40),
    "reference_before_start": (_literals(b"abc") + _backref(3, 4), 10),
    "past_expected": (_literals(b"abcd") + _backref(4, 4), 6),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_lzf_malformed_raises(case, jax_native):
    stream, expected = MALFORMED[case]
    for decode in (native.lzf_decompress, tpcd._lzf_decompress):
        with pytest.raises(ValueError, match="malformed LZF"):
            decode(stream, expected)
    assert jax_native.lzf_decompress(stream, expected) is None


def test_read_pcd_binary_compressed(tmp_path):
    """read_pcd_arrays decodes through the native decoder, and a truncated
    payload raises ValueError."""
    rng = np.random.default_rng(6)
    xyz = (rng.normal(size=(300, 3)) * 5).astype(np.float32)
    path = tmp_path / "map.pcd"
    write_pcd_compressed(path, xyz, None)
    before = native.LZF_DECOMPRESS.launches
    np.testing.assert_array_equal(tpcd.read_pcd_arrays(path)[0], xyz)
    assert native.LZF_DECOMPRESS.launches == before + 1
    data = path.read_bytes()
    path.write_bytes(data[:-7])
    with pytest.raises(ValueError):
        tpcd.read_pcd_arrays(path)


def test_library_built_under_its_source_hash_and_reused(monkeypatch):
    """The library lands in build/mapmerge_torch/ under the hash of its
    flags and source, and a second load reuses it: with g++ hidden, a fresh
    load still succeeds and the file is untouched."""
    source = "mapmerge_native.cpp"
    path = build.library_path(source)
    h = hashlib.sha256(" ".join(build.GXX_FLAGS).encode())
    h.update((build.CSRC / source).read_bytes())
    assert path == build.BUILD_DIR / f"libmapmerge_native_{h.hexdigest()[:16]}.so"
    assert build.BUILD_DIR.parts[-2:] == ("build", "mapmerge_torch")
    native.lzf_decompress(_literals(b"abc"), 3)
    stat = path.stat()
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    assert native.lzf_decompress(_literals(b"abc"), 3) == b"abc"
    assert (path.stat().st_ino, path.stat().st_mtime_ns) == (stat.st_ino, stat.st_mtime_ns)


def test_missing_gxx_raises(monkeypatch, tmp_path):
    """No g++ and no library yet: the first call raises a RuntimeError that
    names g++; nothing runs the plain version in its place."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    (_, t_est), threshold = CASES["graph_seed0"]()
    before = (native.GRAPH_SOLVE.launches, native.LZF_DECOMPRESS.launches)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tmg.compute_global_transforms(t_est, threshold)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.lzf_decompress(_literals(b"abc"), 3)
    assert (native.GRAPH_SOLVE.launches, native.LZF_DECOMPRESS.launches) == before
    assert list(tmp_path.iterdir()) == []


def test_failed_gxx_raises_with_its_output(monkeypatch, tmp_path):
    """A g++ that fails: a RuntimeError that names g++ and carries its
    output."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "GXX_FLAGS", (*build.GXX_FLAGS, "--no-such-flag"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*no-such-flag"):
        native.lzf_decompress(_literals(b"abc"), 3)


def test_get_lib_exposes_the_reference_functions(jax_native):
    """The port's library has the C functions of the JAX package's, and the
    port's bindings call through it."""
    lib = native.get_lib()
    for name in ("lzf_decompress", "merge_graph_solve"):
        assert callable(getattr(lib, name))
        assert callable(getattr(jax_native.get_lib(), name))
    assert lib is native.get_lib() is build.load(build.HOST_SOURCES)


def test_every_source_ships_as_package_data():
    """Every source of kernels/build.SOURCES, and every header csrc/*.cuh
    that a kernel source may include, matches a package-data pattern of
    mapmerge_torch in pyproject.toml: an installed port reads its sources
    from csrc/ at first use, with no fallback."""
    root = pathlib.Path(__file__).resolve().parent.parent
    config = tomllib.loads((root / "pyproject.toml").read_text())
    patterns = config["tool"]["setuptools"]["package-data"]["mapmerge_torch"]
    assert build.CSRC == root / "mapmerge_torch" / "csrc"
    headers = sorted(h.name for h in build.CSRC.glob("*.cuh"))
    assert "cull.cuh" in headers
    for source in [*build.SOURCES, *headers]:
        assert (build.CSRC / source).is_file()
        assert any(fnmatch.fnmatch(f"csrc/{source}", pat) for pat in patterns), (
            f"csrc/{source} is not shipped: {patterns}"
        )
