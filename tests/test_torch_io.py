"""mapmerge_torch's PCD I/O, transports and metrics against their
mapmerge_tpu originals (io/pcd.py, runtime/transport.py, utils/metrics.py).

Tolerances: every array read back is exactly equal, in both directions
(the JAX package writes and the port reads, and the reverse), for ascii,
binary and binary_compressed (LZF) files; transports give the same robots,
versions and arrays; metrics snapshots are equal with the timing summaries
left out (they time the host).
"""

import json

import numpy as np
import pytest
import torch

from mapmerge_tpu.io import pcd as jpcd
from mapmerge_tpu.runtime import transport as jtr
from mapmerge_tpu.utils import metrics as jmet
from mapmerge_torch.io import pcd as tpcd
from mapmerge_torch.runtime import transport as ttr
from mapmerge_torch.testing.lzf import lzf_compress, write_pcd_compressed
from mapmerge_torch.utils import metrics as tmet


@pytest.fixture
def cloud(rng):
    xyz = (rng.normal(size=(500, 3)) * 10).astype(np.float32)
    rgb = rng.integers(0, 256, size=(500, 3)).astype(np.float32) / 255.0
    return xyz, rgb


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pcd_round_trip(tmp_path, cloud, binary, writer):
    path = tmp_path / "map.pcd"
    (jpcd if writer == "jax" else tpcd).write_pcd(path, cloud, binary=binary)
    got, ref = tpcd.read_pcd_arrays(path), jpcd.read_pcd_arrays(path)
    _assert_same(got, ref)
    if binary:  # ascii keeps 6 decimals
        np.testing.assert_array_equal(got[0], cloud[0])
    np.testing.assert_allclose(got[1], cloud[1], atol=0.5 / 255)


def test_pcd_lzf(tmp_path, cloud):
    """binary_compressed: the same file read by both packages; with a
    repeated run the compressor's back references overlap."""
    xyz, rgb = cloud
    xyz[100:300] = xyz[100]
    path = tmp_path / "map.pcd"
    write_pcd_compressed(path, xyz, rgb)
    got, ref = tpcd.read_pcd_arrays(path), jpcd.read_pcd_arrays(path)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[0], xyz)


def test_lzf_decompress_matches_reference(rng):
    data = bytes(rng.integers(0, 4, size=20000, dtype=np.uint8)) + b"\x07" * 3000
    comp = lzf_compress(data)
    assert len(comp) < len(data)
    assert tpcd._lzf_decompress(comp, len(data)) == data
    assert jpcd._lzf_decompress(comp, len(data)) == data


def test_pcd_cloud_io(tmp_path, cloud):
    """write_pcd takes the port's PointCloud (valid points only); read_pcd
    gives one on the named device, padded to `capacity`."""
    from mapmerge_torch.core.cloud import PointCloud

    pc = PointCloud.from_numpy(*cloud, capacity=600, device="cpu")
    tpcd.write_pcd(tmp_path / "a.pcd", pc)
    back = tpcd.read_pcd(tmp_path / "a.pcd", capacity=512, device="cpu")
    assert back.capacity == 512 and int(back.count) == 500
    assert back.device == torch.device("cpu")
    np.testing.assert_array_equal(back.to_numpy()[0], cloud[0])
    nan = tmp_path / "nan.pcd"
    xyz = cloud[0].copy()
    xyz[3] = np.nan  # non-finite points are dropped
    tpcd.write_pcd(nan, (xyz, None))
    _assert_same(tpcd.read_pcd_arrays(nan), jpcd.read_pcd_arrays(nan))
    assert len(tpcd.read_pcd_arrays(nan)[0]) == 499


def test_directory_transport(tmp_path, cloud):
    xyz, rgb = cloud
    tpcd.write_pcd(tmp_path / "r1.pcd", (xyz, rgb))
    (tmp_path / "r2").mkdir()
    tpcd.write_pcd(tmp_path / "r2" / "map.pcd", (xyz[:50], None))
    (tmp_path / "notes.txt").write_text("not a map")
    jt, tt = jtr.DirectoryTransport(str(tmp_path)), ttr.DirectoryTransport(str(tmp_path))
    assert tt.discover() == jt.discover() == ["r1", "r2"]
    for robot in ("r1", "r2"):
        (tv, tx, trgb), (jv, jx, jrgb) = tt.latest(robot), jt.latest(robot)
        assert tv == jv
        _assert_same((tx, trgb), (jx, jrgb))
    assert tt.latest("missing") is None
    assert ttr.DirectoryTransport(str(tmp_path / "none")).discover() == []


def test_inproc_transport(cloud):
    jt, tt = jtr.InProcTransport(), ttr.InProcTransport()
    for t in (jt, tt):
        t.publish("b", cloud[0])
        t.publish("a", cloud[0], cloud[1])
        t.publish("b", cloud[0][:10])
    assert tt.discover() == jt.discover() == ["a", "b"]
    for robot in ("a", "b"):
        (tv, tx, trgb), (jv, jx, jrgb) = tt.latest(robot), jt.latest(robot)
        assert tv == jv and tx.dtype == np.float32
        np.testing.assert_array_equal(tx, jx)
        assert (trgb is None) == (jrgb is None)
    assert tt.latest("b")[0] == 2 and tt.latest("c") is None
    with pytest.raises(NotImplementedError):
        ttr.Transport().discover()


def test_metrics_match_reference(tmp_path):
    """The same calls on both registries give equal snapshots (timings
    left out, they time the host), and both sinks write lines each
    package's read_jsonl reads back."""
    regs = (jmet.MetricsRegistry(), tmet.MetricsRegistry())
    for reg in regs:
        reg.inc("robots_discovered")
        reg.inc("robots_discovered", 2)
        reg.set_gauge("maps_registered", 3)
        reg.set_gauge("mode", "incremental")
        for s in (0.5, 0.25, 1.0):
            reg.observe("estimation", s)
        with reg.time_stage("compositing"):
            pass
    snaps = [r.snapshot() for r in regs]
    timings = [s.pop("timings") for s in snaps]
    assert snaps[0] == snaps[1]
    assert timings[0]["estimation"] == timings[1]["estimation"] == {
        "count": 3, "total_s": 1.75, "mean_s": 0.583333, "min_s": 0.25,
        "max_s": 1.0, "last_s": 1.0,
    }
    assert timings[1]["compositing"]["count"] == 1
    assert tmet.TimingSummary().snapshot() == jmet.TimingSummary().snapshot()

    record = {"job": "estimation", "tick": 1, "wall_s": 0.5}
    for sink_mod, name in ((jmet, "j.jsonl"), (tmet, "t.jsonl")):
        sink = sink_mod.maybe_sink(str(tmp_path / name))
        sink.write(record)
        sink.write(dict(record, tick=2))
    assert tmet.maybe_sink(None) is None
    with open(tmp_path / "t.jsonl", "a") as f:
        f.write("\n")  # a blank line is skipped
    for path in ("j.jsonl", "t.jsonl"):
        rows = tmet.read_jsonl(str(tmp_path / path))
        assert rows == jmet.read_jsonl(str(tmp_path / path))
        assert [r["tick"] for r in rows] == [1, 2]
    assert json.loads((tmp_path / "t.jsonl").read_text().splitlines()[0]) == record
