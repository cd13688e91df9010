"""SIFT's dense octave: the plain versions of kernels C and D
(mapmerge_torch/kernels/sift.py: scale_space_ref, knn_ref) against the JAX
package's dense `_scale_space` and dense `radius_neighbors(k=26)`, the
whole dense `detect_keypoints_sift` against the reference, the wrappers'
routing, and the build directory of kernels/build.py. The `cuda` cases
hold the kernels against their plain versions on the card and skip here;
on a machine with a GPU: `python -m pytest tests/test_torch_sift_kernels.py
-m cuda --noconftest`.

The parity clouds lie on a lattice of 1/8 m, their valid points in mirrored
pairs (x and -x), so the valid mean is exactly 0 and every squared distance
is exact in both packages: the reference's matmul expansion and the port's
direct expansion give the same d2, so the bound test, the ties and the
neighbour order are the same, and only exp and the sums round apart.
"""

import contextlib
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapmerge_tpu.core.cloud import PointCloud as JaxCloud
from mapmerge_tpu.ops import neighbors as jn
from mapmerge_tpu.ops.keypoints import sift as jsift
from mapmerge_torch import native
from mapmerge_torch.core.cloud import FAR
from mapmerge_torch.core.cloud import PointCloud as TorchCloud
from mapmerge_torch.kernels import build
from mapmerge_torch.kernels import sift as ksift
from mapmerge_torch.kernels import tiles as ktiles
from mapmerge_torch.ops import neighbors as tn
from mapmerge_torch.ops.keypoints import sift as tsift

from torch_parity import SLICE_PARAMS, both_clouds, small_scene, t
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

#: the JAX field against the port's, as a share of the field's largest
#: magnitude: exp and the float32 sums round apart, nothing else differs
FIELD_RTOL = 1e-5


def lattice_cloud(seed, pairs=1400, masked_pairs=150, dup=40, pad=300):
    """(xyz, mask, intensity) of 2 * pairs lattice points, mirrored so the
    valid sum is exactly 0, `dup` of them duplicated (with their mirrors),
    `masked_pairs` pairs masked where they lie, shuffled, then `pad` slots
    parked at FAR (masked)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-24, 25, size=(pairs, 3)).astype(np.float32) / 8
    half[:dup] = half[dup : 2 * dup]
    xyz = np.concatenate([half, -half])
    pair_masked = np.zeros(pairs, bool)
    pair_masked[rng.choice(pairs, masked_pairs, replace=False)] = True
    mask = np.concatenate([~pair_masked, ~pair_masked])
    perm = rng.permutation(2 * pairs)
    xyz, mask = xyz[perm], mask[perm]
    xyz = np.concatenate([xyz, np.full((pad, 3), FAR, np.float32)])
    mask = np.concatenate([mask, np.zeros(pad, bool)])
    intensity = (rng.random(len(xyz)) * 255).astype(np.float32)
    intensity[~mask] = 0.0
    return xyz, mask, intensity


def clouds(xyz, mask):
    rgb = np.zeros_like(xyz)
    return (JaxCloud(xyz=jnp.asarray(xyz), rgb=jnp.asarray(rgb), mask=jnp.asarray(mask)),
            TorchCloud(xyz=t(xyz), rgb=t(rgb), mask=t(mask)))


def sigmas_of(base, scales):
    return [base * (2.0 ** (s / scales)) for s in range(scales + 3)]


@pytest.mark.parametrize("scales,tile", [(3, 512), (6, 1024)])
def test_scale_space_ref_matches_jax_dense(scales, tile):
    """The dense branch of `_scale_space` in both packages on the same
    cloud (ragged mask, duplicates, FAR padding): within FIELD_RTOL of the
    field's largest magnitude, and exactly 0 at the padded queries. Six
    sigmas (config #1's) and nine (more than the kernel's group of 8)."""
    xyz, mask, intensity = lattice_cloud(1 + scales)
    jc, tc = clouds(xyz, mask)
    sigmas = sigmas_of(0.25, scales)
    want = np.asarray(jsift._scale_space(jc, jnp.asarray(intensity), sigmas, tile,
                                         engine="dense"))
    got = tsift._scale_space(tc, t(intensity), sigmas, tile, engine="dense")
    assert got.shape == (len(sigmas), len(xyz)) and got.dtype == torch.float32
    got = got.numpy()
    scale = np.abs(want).max()
    assert scale > 100.0
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_RTOL * scale)
    pad = np.abs(xyz).max(axis=1) >= FAR
    assert (got[:, pad] == 0).all()
    # the plain version itself, on the centred inputs the wrapper gets
    qc, pc = tn._center(tc.xyz, tc.xyz, tc.mask)
    vals = torch.where(tc.mask, t(intensity), 0.0)
    r2 = tn._f32((3.0 * max(sigmas)) ** 2)
    assert torch.equal(ksift.scale_space_ref(qc, pc, vals, tc.mask, sigmas, r2, tile),
                       torch.from_numpy(got))


@pytest.mark.parametrize("seed", [11, 12])
def test_knn_ref_matches_jax_dense_radius_neighbors(seed):
    """knn_ref against the reference's dense radius_neighbors(k=26,
    radius=1e6) on a lattice cloud with duplicated points, masked slots and
    padding: indices and valid exactly equal on every row, the padded ones
    included (their nearest are the first masked slots, at BIG)."""
    xyz, mask, _ = lattice_cloud(seed)
    ji, _, jv, _ = jn.radius_neighbors(jnp.asarray(xyz), jnp.asarray(xyz), 1.0e6, 26,
                                       p_mask=jnp.asarray(mask), tile=512,
                                       engine="dense")
    qc, pc = tn._center(t(xyz), t(xyz), t(mask))
    idx, valid = ksift.knn_ref(qc, pc, t(mask), 26, tn._f32(1.0e12), 512)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert valid.all()  # the masked slots at BIG meet r2 = BIG, as today
    # ties: a duplicated point's twin sits in slot 0 or 1, the lower index first
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    twins = [(i, j) for i, j in zip(*np.nonzero(d2 == 0)) if i < j and mask[i] and mask[j]]
    assert len(twins) >= 20
    for i, j in twins:
        assert list(idx[i, :2].numpy()) == [i, j] and list(idx[j, :2].numpy()) == [i, j]


def test_knn_ref_short_cloud():
    """Fewer points than 26: k = P, every point ranked. A padded query
    (at FAR) ranks its 8 masked slots first, at BIG, in both; its real
    points lie beyond BIG, where the reference's matmul expansion keeps no
    bits of their order, so only its masked slots compare."""
    xyz, mask, _ = lattice_cloud(3, pairs=8, masked_pairs=2, dup=1, pad=4)
    ji, _, jv, _ = jn.radius_neighbors(jnp.asarray(xyz), jnp.asarray(xyz), 1.0e6, 20,
                                       p_mask=jnp.asarray(mask), engine="dense")
    qc, pc = tn._center(t(xyz), t(xyz), t(mask))
    idx, valid = ksift.knn_ref(qc, pc, t(mask), 20, tn._f32(1.0e12))
    ji, jv, real = np.asarray(ji), np.asarray(jv), np.abs(xyz).max(axis=1) < FAR
    np.testing.assert_array_equal(idx.numpy()[real], ji[real])
    np.testing.assert_array_equal(valid.numpy(), jv)
    n_masked = int((~mask).sum())
    assert n_masked == 8
    np.testing.assert_array_equal(idx.numpy()[~real, :n_masked], ji[~real, :n_masked])
    assert (idx.numpy()[~real, :n_masked] == np.flatnonzero(~mask)).all()


@pytest.fixture(scope="module")
def surface_cloud():
    """The slice scene's view A after the reference's downsample and
    outlier removal, in both packages."""
    from mapmerge_tpu.ops.downsample import voxel_downsample as j_voxel
    from mapmerge_tpu.ops.outliers import remove_outliers as j_outliers
    from mapmerge_torch import convert

    (a_xyz, a_rgb), _, cap, _ = small_scene()
    jc, _ = both_clouds(a_xyz, a_rgb, capacity=cap)
    p = SLICE_PARAMS
    jc = j_voxel(jc, p.resolution, out_capacity=min(cap, p.max_points))
    jc = j_outliers(jc, p.descriptor_radius, p.outliers_min_neighbours, tile=512)
    return jc, convert.cloud_from_numpy(jc, "cpu")


@pytest.mark.parametrize("scales", [3, 6])
def test_detect_keypoints_sift_dense_keeps_the_gate(surface_cloud, scales, monkeypatch):
    """The whole detector on the dense engine through the wrappers (their
    plain versions here), against the reference: tests/test_torch_features.py
    ::TestSift's gate, >= 95% of the reference's keypoints at the same point
    with the same response (1e-3 relative); both wrappers called once an
    octave."""
    jc, tc = surface_cloud
    calls = {"scale_space": 0, "knn": 0}
    for name in calls:
        fn = getattr(ksift, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ksift, name, counted)
    kw = dict(min_scale=0.1, octaves=3, scales_per_octave=scales, min_contrast=3.0,
              max_keypoints=256, tile=512, engine="dense")
    jk = jsift.detect_keypoints_sift(jc, **kw)
    tk = tsift.detect_keypoints_sift(tc, **kw)
    assert calls == {"scale_space": 3, "knn": 3}
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() > 30
    assert abs(int(tm.sum()) - int(jm.sum())) <= max(2, 0.03 * jm.sum())
    jxyz, txyz = np.asarray(jk.xyz)[jm], tk.xyz.numpy()[tm]
    jr, tr = np.asarray(jk.response)[jm], tk.response.numpy()[tm]
    same = (np.abs(jxyz[:, None] - txyz[None]).max(-1) < 1e-6) & (
        np.abs(jr[:, None] - tr[None]) <= 1e-3 * jr[:, None]
    )
    assert same.any(axis=1).mean() >= 0.95


def test_dense_octave_packed_once_for_both_kernels(surface_cloud, monkeypatch):
    """Each dense octave is centred and packed once, with its intensities,
    and kernels C and D get that one buffer; the keypoints are the same
    bits as without the recording."""
    _, tc = surface_cloud
    kw = dict(min_scale=0.1, octaves=3, scales_per_octave=3, min_contrast=3.0,
              max_keypoints=256, tile=512, engine="dense")
    packs, given = [], {"scale_space": [], "knn": []}
    pack, scale_space, knn = ktiles.pack, ksift.scale_space, ksift.knn

    def counted_pack(p, vals, mask):
        packs.append((vals is not None, pack(p, vals, mask)))
        return packs[-1][1]

    def taking(name, fn):
        def wrapper(*args, packed=None, **kwargs):
            given[name].append(packed)
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(ktiles, "pack", counted_pack)
    monkeypatch.setattr(ksift, "scale_space", taking("scale_space", scale_space))
    monkeypatch.setattr(ksift, "knn", taking("knn", knn))
    got = tsift.detect_keypoints_sift(tc, **kw)
    # 3 octaves, one pre-pass each (a CPU wrapper takes its plain version,
    # which packs nothing)
    assert [with_vals for with_vals, _ in packs] == [True] * 3
    shared = [buf for _, buf in packs]
    for name in given:
        assert [id(b) for b in given[name]] == [id(b) for b in shared], name
    monkeypatch.undo()
    want = tsift.detect_keypoints_sift(tc, **kw)
    for field in ("xyz", "response", "mask", "truncated"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_wrappers_take_the_plain_version_on_cpu_without_building(monkeypatch):
    """A CPU tensor goes to the plain version: nothing is built or loaded and
    no launch is counted; the results are the plain versions' bits."""
    def no_build(*args, **kwargs):
        raise AssertionError("the CPU path built or loaded a kernel")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    xyz, mask, intensity = lattice_cloud(5, pairs=300, masked_pairs=30, dup=5, pad=20)
    qc, pc = tn._center(t(xyz), t(xyz), t(mask))
    vals, m = t(intensity), t(mask)
    sigmas = sigmas_of(0.25, 3)
    before = (ksift.SCALE_SPACE_KERNEL.launches, ksift.KNN_KERNEL.launches)
    out = ksift.scale_space(qc, pc, vals, m, sigmas, 5.0, 128)
    assert torch.equal(out, ksift.scale_space_ref(qc, pc, vals, m, sigmas, 5.0, 128))
    idx, valid = ksift.knn(qc, pc, m, 26, 1e12, 128)
    ridx, rvalid = ksift.knn_ref(qc, pc, m, 26, 1e12, 128)
    assert torch.equal(idx, ridx) and torch.equal(valid, rvalid)
    assert (ksift.SCALE_SPACE_KERNEL.launches, ksift.KNN_KERNEL.launches) == before


@pytest.mark.parametrize("entry", ["scale_space", "knn"])
def test_forced_build_or_launch_failure_raises(monkeypatch, entry):
    """A tensor off the CPU never gets the plain version: a device that is
    not a card is refused, a build that fails raises its error, and a launch
    that returns a CUDA error raises it. The card's entry points are stood in
    for by the meta device (no data), so the wrapper's own path runs here;
    the pre-pass `pack` launches first and succeeds."""
    meta = torch.device("meta")
    q = torch.empty((64, 3), device=meta)
    mask = torch.ones((64,), dtype=torch.bool, device=meta)
    vals = torch.empty((64,), device=meta)
    call = {
        "scale_space": lambda: ksift.scale_space(q, q, vals, mask, [0.1, 0.2], 0.36),
        "knn": lambda: ksift.knn(q, q, mask, 26, 1e12),
    }[entry]
    kernel = {"scale_space": ksift.SCALE_SPACE_KERNEL, "knn": ksift.KNN_KERNEL}[entry]
    with pytest.raises(ValueError, match="unsupported device meta"):
        call()

    monkeypatch.setattr(build, "cuda_device", lambda kernel, x: x.device)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load", failed_build)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call()
    assert kernel.launches == before
    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_tiles_pack=lambda *args: 0, mm_sift_scale_space=lambda *args: 700,
        mm_sift_knn=lambda *args: 700))
    with pytest.raises(RuntimeError, match=f"{kernel.name}: CUDA launch failed with error 700"):
        call()


def _meta_entry(monkeypatch, entry):
    """The card's path of a wrapper on meta tensors (no data), as
    test_forced_build_or_launch_failure_raises runs it: (call, kernel)."""
    meta = torch.device("meta")
    q = torch.empty((64, 3), device=meta)
    mask = torch.ones((64,), dtype=torch.bool, device=meta)
    vals = torch.empty((64,), device=meta)
    monkeypatch.setattr(build, "cuda_device", lambda kernel, x: x.device)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_handle", lambda dev: 0)
    call = {
        "scale_space": lambda **kw: ksift.scale_space(q, q, vals, mask, [0.1, 0.2], 0.36,
                                                      **kw),
        "knn": lambda **kw: ksift.knn(q, q, mask, 26, 1e12, **kw),
    }[entry]
    kernel = {"scale_space": ksift.SCALE_SPACE_KERNEL, "knn": ksift.KNN_KERNEL}[entry]
    return call, kernel


def _never(*args):
    raise AssertionError("launched after a failed pre-pass")


@pytest.mark.parametrize("entry", ["scale_space", "knn"])
def test_forced_pack_failure_raises_before_the_kernel(monkeypatch, entry):
    """A pre-pass launch that returns a CUDA error raises it under the
    pre-pass's name; kernel C or D is never launched on its buffer, and its
    launch count does not move."""
    call, kernel = _meta_entry(monkeypatch, entry)
    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_tiles_pack=lambda *args: 700, mm_sift_scale_space=_never, mm_sift_knn=_never))
    before = (ksift.SCALE_SPACE_KERNEL.launches, ksift.KNN_KERNEL.launches)
    with pytest.raises(RuntimeError, match="tiles_pack: CUDA launch failed with error 700"):
        call()
    assert (ksift.SCALE_SPACE_KERNEL.launches, ksift.KNN_KERNEL.launches) == before


@pytest.mark.parametrize("entry", ["scale_space", "knn"])
def test_a_given_buffer_skips_the_pre_pass(monkeypatch, entry):
    """With `packed`, the wrapper launches its kernel on that buffer and no
    pre-pass; a buffer of another size is refused before any launch."""
    call, kernel = _meta_entry(monkeypatch, entry)
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_tiles_pack=_never, mm_sift_scale_space=launch, mm_sift_knn=launch))
    meta = torch.device("meta")
    pts = torch.empty((64, 4), device=meta)
    boxes = torch.empty((2, 2, 4), device=meta)
    before = (ktiles.PACK_KERNEL.launches, kernel.launches)
    call(packed=(pts, boxes))
    assert (ktiles.PACK_KERNEL.launches, kernel.launches) == (before[0], before[1] + 1)
    assert len(seen) == 1
    with pytest.raises(ValueError, match="packed boxes has shape"):
        call(packed=(pts, torch.empty((3, 2, 4), device=meta)))
    with pytest.raises(ValueError, match="packed points has shape"):
        call(packed=(torch.empty((32, 4), device=meta), boxes))
    assert len(seen) == 1


# ---- the build directory (kernels/build.py) ----


def test_build_dir_in_the_checkout():
    """A source checkout builds into build/mapmerge_torch/ beside the
    package, which .gitignore lists."""
    root = build.CSRC.parent.parent
    assert (root / "pyproject.toml").is_file()
    assert build.build_dir(build.CSRC.parent) == root / "build" / "mapmerge_torch"
    assert build.BUILD_DIR == root / "build" / "mapmerge_torch"
    assert "build/" in (root / ".gitignore").read_text().splitlines()


@pytest.fixture
def installed_root(tmp_path):
    """A read-only package directory outside any checkout, as a
    site-packages the user cannot write (its parent holds no
    pyproject.toml)."""
    site = tmp_path / "site-packages"
    (site / "mapmerge_torch").mkdir(parents=True)
    site.chmod(0o555)
    yield site / "mapmerge_torch"
    site.chmod(0o755)


def test_installed_package_builds_in_the_user_cache(installed_root, tmp_path, monkeypatch):
    """Outside a checkout the libraries build under $XDG_CACHE_HOME/
    mapmerge_torch/: the host library builds and runs there, keyed on its
    source hash as before."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    where = build.build_dir(installed_root)
    assert where == cache / "mapmerge_torch"
    monkeypatch.setattr(build, "BUILD_DIR", where)
    monkeypatch.setattr(build, "_loaded", {})
    assert native.lzf_decompress(bytes([2]) + b"abc", 3) == b"abc"
    (lib,) = where.glob("libmapmerge_native_*.so")
    assert lib == build.library_path("mapmerge_native.cpp")
    assert list(installed_root.parent.iterdir()) == [installed_root]
    assert not any(installed_root.iterdir())


def test_installed_package_cache_defaults_to_home(installed_root, tmp_path, monkeypatch):
    """$XDG_CACHE_HOME unset, or not an absolute path (which the platform's
    rule ignores): ~/.cache/mapmerge_torch/."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    want = tmp_path / "home" / ".cache" / "mapmerge_torch"
    assert build.build_dir(installed_root) == want
    monkeypatch.setenv("XDG_CACHE_HOME", "relative/cache")
    assert build.build_dir(installed_root) == want


def test_a_foreign_pyproject_is_not_a_checkout(tmp_path, monkeypatch):
    """A pyproject.toml beside the package that does not name it (another
    project's directory) does not make a checkout."""
    (tmp_path / "mapmerge_torch").mkdir()
    (tmp_path / "pyproject.toml").write_text('[project]\nname = "other"\n')
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(tmp_path / "mapmerge_torch") == tmp_path / "cache" / "mapmerge_torch"


def test_uncreatable_build_dir_raises_with_its_path(tmp_path, monkeypatch):
    """A build directory that cannot be made raises a RuntimeError that
    names it; nothing falls back to another place or to Python."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    where = blocker / "mapmerge_torch"
    monkeypatch.setattr(build, "BUILD_DIR", where)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match=f"cannot create the build directory {where}"):
        native.lzf_decompress(bytes([2]) + b"abc", 3)
    assert not os.path.exists(where)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(dev, nq, np_, seed, keep=0.8):
    """Lattice points of 1/8 m (many equal distances), a ragged mask, the
    first queries drawn from the points, some queries and targets at FAR."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.round(torch.rand((np_, 3), generator=g, device=dev) * 80 - 40) / 8
    q = torch.round(torch.rand((nq, 3), generator=g, device=dev) * 80 - 40) / 8
    q[: min(nq, np_) // 2] = p[: min(nq, np_) // 2]
    mask = torch.rand((np_,), generator=g, device=dev) < keep
    p[-5:] = FAR
    mask[-5:] = False
    q[-3:] = FAR
    vals = torch.where(mask, torch.rand((np_,), generator=g, device=dev) * 255, 0.0)
    return q, p, mask, vals


def _field_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,np_,scales", [(3001, 5003, 3), (300, 20000, 3),
                                            (1000, 1000, 9), (7, 40, 1)])
def test_scale_space_kernel_within_tolerance(cuda, nq, np_, scales):
    """Kernel C against its plain version: within SCALE_SPACE_RTOL of the
    field's largest magnitude, 0 at the FAR queries, one launch, and the
    same bits on a second launch. A small Q against a large P; twelve
    sigmas take two lanes a query or more."""
    q, p, mask, vals = _card_case(cuda, nq, np_, nq + np_)
    sigmas = sigmas_of(0.5, scales)
    r2 = tn._f32((3.0 * max(sigmas)) ** 2)
    before = ksift.SCALE_SPACE_KERNEL.launches
    got = ksift.scale_space(q, p, vals, mask, sigmas, r2)
    assert ksift.SCALE_SPACE_KERNEL.launches == before + 1
    ref = ksift.scale_space_ref(q, p, vals, mask, sigmas, r2)
    assert got.shape == ref.shape == (len(sigmas), nq)
    assert _field_err(got, ref) <= ksift.SCALE_SPACE_RTOL
    assert bool((got[:, -3:] == 0).all())
    assert torch.equal(got, ksift.scale_space(q, p, vals, mask, sigmas, r2))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,np_,k", [(3001, 5003, 26), (300, 20000, 26), (128, 26, 26),
                                       (9, 12, 12), (5000, 70001, 26)])
def test_knn_kernel_exact(cuda, nq, np_, k):
    """Kernel D against its plain version: indices and valid bit for bit,
    on lattice points (ties everywhere), masks, FAR queries and targets, a
    small Q whose P is split, and P below 26."""
    q, p, mask, _ = _card_case(cuda, nq, np_, 7 * nq + np_)
    before = ksift.KNN_KERNEL.launches
    idx, valid = ksift.knn(q, p, mask, k, tn._f32(1.0e12))
    assert ksift.KNN_KERNEL.launches == before + 1
    ridx, rvalid = ksift.knn_ref(q, p, mask, k, tn._f32(1.0e12))
    assert torch.equal(idx, ridx) and torch.equal(valid, rvalid)
    idx2, valid2 = ksift.knn(q, p, mask, k, 0.5)  # a bounded radius: valid moves
    _, rvalid2 = ksift.knn_ref(q, p, mask, k, 0.5)
    assert torch.equal(idx2, ridx) and torch.equal(valid2, rvalid2)


@pytest.mark.cuda
def test_knn_kernel_all_equal_and_all_masked(cuda):
    """Every target at one point: the first 26 indices in order, though
    every tile reaches every query; every target masked: the first 26
    indices at BIG, valid."""
    q = torch.zeros((200, 3), device=cuda)
    p = torch.zeros((30000, 3), device=cuda)
    idx, valid = ksift.knn(q, p, None, 26, 1.0)
    assert bool((idx == torch.arange(26, device=cuda, dtype=torch.int32)).all())
    assert bool(valid.all())
    mask = torch.zeros((30000,), dtype=torch.bool, device=cuda)
    idx, valid = ksift.knn(q, p + 1.0, mask, 26, tn._f32(1.0e12))
    assert bool((idx == torch.arange(26, device=cuda, dtype=torch.int32)).all())
    assert bool(valid.all())


@pytest.mark.cuda
def test_kernels_raise_on_a_forced_failure_on_the_card(cuda, monkeypatch):
    """On CUDA tensors a failed build or launch raises; the plain version is
    never returned."""
    q, p, mask, vals = _card_case(cuda, 100, 100, 1)
    monkeypatch.setattr(build, "load", lambda *a: types.SimpleNamespace(
        mm_tiles_pack=lambda *args: 0, mm_sift_scale_space=lambda *args: 1,
        mm_sift_knn=lambda *args: 1))
    with pytest.raises(RuntimeError, match="CUDA launch failed with error 1"):
        ksift.scale_space(q, p, vals, mask, [0.5, 0.7], 4.0)
    with pytest.raises(RuntimeError, match="CUDA launch failed with error 1"):
        ksift.knn(q, p, mask, 26, 1e12)

    def failed_build(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ksift.knn(q, p, mask, 26, 1e12)
    with pytest.raises(ValueError, match="k=27"):
        ksift.knn(q, p, mask, 27, 1e12)
