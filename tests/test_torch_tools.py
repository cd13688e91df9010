"""mapmerge_torch's offline tools, renders and stage profiler against
mapmerge_tpu/tools/ and utils/profiling.py, on the CPU (`device="cpu"`).

Both packages' tools run in-process on the same .pcd pair (two views of
tests/test_distributed_node.py's scene, cut to one size so that the JAX
tool compiles each stage once), each once per module. Tolerances: the
transforms agree within 1 deg / 0.1 m (RANSAC cannot replay JAX's key
stream, so the check is at the pose level, ROADMAP §1), and lie within
1 deg / 0.1 m of the truth; the printed params, the debugger's stage names
and its deterministic counts (downsampled points, outlier survivors, valid
normals, keypoints, descriptors, correspondences) are equal exactly, as
are the dump files' names and point counts; the merge tool's output file
equals, byte for byte, the port's own compose_maps of the clouds read back
under the transforms its estimate_maps_transforms call returned.
"""

import contextlib
import io
import os
import re
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

from mapmerge_tpu.tools import merge_tool as j_merge_tool
from mapmerge_tpu.tools import registration_visualisation as j_viz
from mapmerge_torch.core import transforms as ttf
from mapmerge_torch.core.params import MergeParams
from mapmerge_torch.io.pcd import read_pcd_arrays, write_pcd
from mapmerge_torch.pipeline import merging
from mapmerge_torch.pipeline.merging import compose_maps
from mapmerge_torch.testing.scene import make_scene, overlapping_views, rotation_z, se3
from mapmerge_torch.tools import merge_tool, registration_visualisation, render
from mapmerge_torch.utils import profiling
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUTH = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
#: tests/test_distributed_node.py's parameters, with ICP and a short SAC-IA
ARGS = [
    "--keypoint_type", "HARRIS", "--keypoint_threshold", "5.0",
    "--descriptor_type", "FPFH", "--refine_transform", "true",
    "--max_iterations", "20", "--max_points", "4096", "--max_keypoints", "128",
    "--max_neighbors", "32", "--ransac_hypotheses", "256",
    "--sacia_hypotheses", "256", "--neighbor_tile", "256",
]
COUNT_LINE = re.compile(r"^  (map\d \w[\w ]*|correspondences): (\d+)")


@pytest.fixture(scope="module")
def pcds(tmp_path_factory):
    """Two views of one scene, cut to the same number of points, as binary
    .pcd files: (directory, a.pcd, b.pcd)."""
    xyz, rgb = make_scene(np.random.default_rng(7), n_boxes=6, extent=8.0, density=40.0)
    va, vb, _ = overlapping_views(np.random.default_rng(3), xyz, rgb, TRUTH, overlap=0.65)
    n = min(len(va[0]), len(vb[0]))
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("pcds")
    paths = []
    for name, (x, r) in (("a", va), ("b", vb)):
        keep = np.sort(rng.choice(len(x), n, replace=False))
        paths.append(str(d / f"{name}.pcd"))
        write_pcd(paths[-1], (x[keep], r[keep]))
    return d, *paths


def run(main, argv, **kwargs) -> tuple[int, str]:
    """(exit code, standard output) of a tool's main, in-process. The JAX
    tools set the compilation cache directory; it is restored after."""
    cache_dir = jax.config.jax_compilation_cache_dir
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv, **kwargs)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def merged(pcds):
    """Both merge tools on the pair: {package: (exit code, stdout, out.pcd)},
    and the clouds and transforms of the port tool's estimate_maps_transforms
    call."""
    d, a, b = pcds
    res = {}
    calls = []

    def recording(clouds, *args, **kwargs):
        calls.append((clouds, estimate(clouds, *args, **kwargs)))
        return list(calls[-1][1])

    estimate = merging.estimate_maps_transforms
    merging.estimate_maps_transforms = recording
    try:
        for name, main, extra, kwargs in (
            ("jax", j_merge_tool.main, [], {}),
            ("torch", merge_tool.main, ["--mesh"], {"device": "cpu"}),
        ):
            out = str(d / f"{name}_out.pcd")
            res[name] = (*run(main, [a, b, "--output", out, *ARGS, *extra], **kwargs), out)
    finally:
        merging.estimate_maps_transforms = estimate
    assert len(calls) == 1
    return res, calls[0]


@pytest.fixture(scope="module")
def debugged(pcds):
    """Both debuggers on the pair: {package: (exit code, stdout, dump dir)}."""
    d, a, b = pcds
    res = {}
    for name, main, kwargs in (
        ("jax", j_viz.main, {}), ("torch", registration_visualisation.main, {"device": "cpu"}),
    ):
        dump = str(d / f"{name}_dump")
        res[name] = (*run(main, [a, b, "--dump-dir", dump, *ARGS], **kwargs), dump)
    return res


def printed_matrix(lines: list[str], at: int) -> np.ndarray:
    """The 4x4 matrix np.array2string printed on lines[at:at + 4]."""
    return np.array(
        [[float(v) for v in row.strip(" []").split()] for row in lines[at: at + 4]],
        np.float32,
    )


def printed_transforms(text: str) -> list[np.ndarray]:
    lines = text.splitlines()
    return [
        printed_matrix(lines, i + 1)
        for i, line in enumerate(lines) if line.startswith("transform for map ")
    ]


def params_block(text: str) -> str:
    return text[: text.index("loaded ")]


class TestMergeTool:
    def test_transforms_match_reference_and_truth(self, merged):
        rels = {}
        for name, (rc, text, _) in merged[0].items():
            assert rc == 0, text
            t = printed_transforms(text)
            assert len(t) == 2
            rels[name] = np.linalg.inv(t[0]) @ t[1]
        rot, trans = ttf.pose_error(rels["torch"], rels["jax"])
        assert rot < 1.0 and trans < 0.1, (rot, trans)
        rot, trans = ttf.pose_error(rels["torch"], TRUTH)
        assert rot < 1.0 and trans < 0.1, (rot, trans)

    def test_prints_the_reference_lines(self, merged):
        (_, j_text, _), (_, t_text, _) = merged[0]["jax"], merged[0]["torch"]
        assert params_block(t_text) == params_block(j_text)
        shape = [re.sub(r"[-\d.]+", "#", line) for line in t_text.splitlines()
                 if not line.startswith((" [", "[["))]
        j_shape = [re.sub(r"[-\d.]+", "#", line) for line in j_text.splitlines()
                   if not line.startswith((" [", "[["))]
        assert shape == [line.replace("jax_out", "torch_out") for line in j_shape]
        assert "sharding pairs" not in t_text  # --mesh on one device: unsharded

    def test_output_is_its_own_compose(self, pcds, merged):
        """The tool estimates on the files read back, and out.pcd is
        compose_maps of those clouds under the transforms it got, byte for
        byte."""
        d, a, b = pcds
        res, (clouds, transforms) = merged
        for cloud, path in zip(clouds, (a, b)):
            xyz, rgb = read_pcd_arrays(path)
            np.testing.assert_array_equal(cloud.to_numpy()[0], xyz)
            np.testing.assert_array_equal(cloud.to_numpy()[1], rgb)
        params = MergeParams.from_command_line(ARGS)
        expected = str(d / "expected.pcd")
        write_pcd(expected, compose_maps(clouds, transforms, params.output_resolution))
        with open(expected, "rb") as f, open(res["torch"][2], "rb") as g:
            assert f.read() == g.read()
        n_ours = len(read_pcd_arrays(res["torch"][2])[0])
        assert f"merged map: {n_ours} points" in res["torch"][1]

    def test_usage_and_device(self, pcds):
        _, a, b = pcds
        for main in (merge_tool.main, registration_visualisation.main):
            assert run(main, [a], device="cpu")[0] == 1
        assert run(j_merge_tool.main, [a])[0] == 1
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="NVIDIA GPU"):
                merge_tool.main([a, b])


class TestRegistrationVisualisation:
    def test_counts_match_reference_exactly(self, debugged):
        counts = {}
        for name, (rc, text, _) in debugged.items():
            assert rc == 0, text
            counts[name] = [m.groups() for m in map(COUNT_LINE.match, text.splitlines()) if m]
        assert len(counts["torch"]) == 11
        assert counts["torch"] == counts["jax"]
        desc, j_desc = (
            [line for line in debugged[k][1].splitlines()
             if line.startswith("  map") and "descriptors:" in line]
            for k in ("torch", "jax")
        )
        assert desc == j_desc and len(desc) == 2

    def test_stages_and_refined_pose_match_reference(self, debugged):
        stages, refined = {}, {}
        for name, (_, text, _) in debugged.items():
            lines = text.splitlines()
            stages[name] = [line.split(":")[0] for line in lines if line.startswith("[stage]")]
            at = next(i for i, line in enumerate(lines) if line.startswith("  ICP refined: ok=True"))
            refined[name] = printed_matrix(lines, at + 1)
        assert stages["torch"] == stages["jax"] and len(stages["torch"]) == 14
        rot, trans = ttf.pose_error(refined["torch"], refined["jax"])
        assert rot < 1.0 and trans < 0.1, (rot, trans)
        for line in ("  RANSAC: ok=True", "  SAC-IA: ok=True"):
            assert line in debugged["torch"][1]

    def test_dump_files_match_reference(self, debugged):
        names = {k: sorted(os.listdir(v[2])) for k, v in debugged.items()}
        assert names["torch"] == names["jax"] and len(names["torch"]) == 7
        for f in names["torch"]:
            if f.startswith("aligned"):
                continue  # the overlay is moved by each package's own pose
            n_ours = len(read_pcd_arrays(os.path.join(debugged["torch"][2], f))[0])
            assert n_ours == len(read_pcd_arrays(os.path.join(debugged["jax"][2], f))[0]), f

    def test_render_needs_matplotlib(self, pcds, monkeypatch):
        """Without matplotlib, --render fails before any stage runs, with an
        ImportError that names it."""
        _, a, b = pcds
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            registration_visualisation.main([a, b, "--render", "png"], device="cpu")


def test_render_five_views(tmp_path):
    """The five reference views (visualise.cpp:20-95) as PNG files."""
    rng = np.random.default_rng(0)
    xyz = (rng.random((800, 3)) * 4.0).astype(np.float32)
    rgb = rng.random((800, 3)).astype(np.float32)
    normals = np.tile([0.0, 0.0, 1.0], (800, 1)).astype(np.float32)
    pairs = np.stack([np.arange(20), np.arange(20)], axis=1)
    paths = [
        render.render_cloud(str(tmp_path / "cloud.png"), xyz, rgb),
        render.render_normals(str(tmp_path / "normals.png"), xyz, normals,
                              valid=np.ones(800, bool)),
        render.render_keypoints(str(tmp_path / "keypoints.png"), xyz, xyz[:40],
                                kp_mask=np.ones(40, bool)),
        render.render_correspondences(str(tmp_path / "corr.png"), xyz[:40], xyz[:40],
                                      pairs, inlier_mask=np.arange(20) % 2 == 0),
        render.render_alignment(str(tmp_path / "aligned.png"), xyz, xyz),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8).startswith(b"\x89PNG"), p


def test_stage_times_and_trace(tmp_path, capsys):
    """StageTimes sums repeated stages and prints each; trace writes a
    Chrome trace of the block, and nothing with no directory."""
    timer = profiling.StageTimes("cpu")
    for _ in range(2):
        with timer.stage("sum"):
            torch.ones(1000).sum()
    assert list(timer.times) == ["sum"] and timer.times["sum"] > 0
    assert capsys.readouterr().out.count("[stage] sum: ") == 2
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(1000).cumsum(0)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "traceEvents" in text and "cumsum" in text


def test_console_scripts():
    """pyproject.toml installs the port's three tools beside the reference's."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["mapmerge-torch-tool"] == "mapmerge_torch.tools.merge_tool:main"
    assert scripts["mapmerge-torch-node"] == "mapmerge_torch.tools.node_cli:main"
    assert scripts["mapmerge-torch-viz"] == (
        "mapmerge_torch.tools.registration_visualisation:main"
    )
    assert scripts["mapmerge-tool"] == "mapmerge_tpu.tools.merge_tool:main"
