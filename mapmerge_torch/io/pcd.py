"""PCD (Point Cloud Data) file I/O (the port's copy of mapmerge_tpu/io/pcd.py).

The reference's pcl::io::loadPCDFile / savePCDFileBinary
(map_merge_3d/src/map_merge_tool.cpp:27,52): reads ascii, binary and
binary_compressed (LZF) files, writes ascii and binary, for XYZ(+RGB/RGBA)
clouds. Host numpy; `read_pcd` puts the cloud on a device. A
binary_compressed payload is decoded by the native decoder
(`native.lzf_decompress`, csrc/mapmerge_native.cpp), as the JAX package
does by default; `_lzf_decompress` is its plain Python version.
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from mapmerge_torch import native
from mapmerge_torch.core.cloud import PointCloud

_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
}


def _parse_header(f: io.BufferedReader) -> dict:
    header = {}
    while True:
        line = f.readline().decode("ascii", errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        header[key] = rest.split()
        if key == "DATA":
            header["DATA"] = rest.strip()
            break
    for k in ("FIELDS", "SIZE", "TYPE", "COUNT", "POINTS", "DATA"):
        if k not in header:
            raise ValueError(f"PCD header missing {k}")
    return header


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Decompress PCL's LZF (the liblzf format of binary_compressed): the
    plain version of native.lzf_decompress, with its checks. Raises
    ValueError for a malformed or truncated payload, or one that decodes to
    more than `expected` bytes."""
    out = bytearray(expected)
    i, o, n = 0, 0, len(data)

    def malformed():
        return ValueError(
            f"malformed LZF payload ({n} bytes, at most {expected} expected)"
        )

    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl + 1 bytes
            length = ctrl + 1
            if i + length > n or o + length > expected:
                raise malformed()
            out[o : o + length] = data[i : i + length]
            i += length
            o += length
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise malformed()
                length += data[i]
                i += 1
            if i >= n:
                raise malformed()
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            length += 2
            if ref < 0 or o + length > expected:
                raise malformed()
            if o - ref >= length:  # source and destination do not overlap
                out[o : o + length] = out[ref : ref + length]
                o += length
            else:  # an overlapping copy repeats the bytes it has written
                for _ in range(length):
                    out[o] = out[ref]
                    o += 1
                    ref += 1
    return bytes(out[:o])


def read_pcd_arrays(path: str | os.PathLike) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a .pcd file -> (xyz float32 (n, 3), rgb float32 (n, 3) in [0, 1]
    or None); points with a non-finite coordinate are dropped."""
    with open(path, "rb") as f:
        h = _parse_header(f)
        fields = h["FIELDS"]
        sizes = [int(s) for s in h["SIZE"]]
        types = h["TYPE"]
        counts = [int(c) for c in h["COUNT"]]
        n_points = int(h["POINTS"][0])
        data_mode = h["DATA"]

        np_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            dt = _DTYPES[(typ, size)]
            np_fields.append((name, dt) if count == 1 else (name, dt, (count,)))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            text = f.read().decode("ascii", errors="replace")
            width = sum(counts)
            raw = np.array(text.split(), dtype=np.float64)
            raw = raw[: n_points * width].reshape(n_points, width)
            rec = np.zeros(n_points, dtype=dtype)
            col = 0
            for name, size, typ, count in zip(fields, sizes, types, counts):
                vals = raw[:, col : col + count]
                col += count
                if name in ("rgb", "rgba") and typ == "F":
                    # ascii rgb may be written as the bitcast float
                    rec[name] = vals.squeeze(-1).astype(np.float32)
                else:
                    rec[name] = (
                        vals.squeeze(-1).astype(dtype[name])
                        if count == 1
                        else vals.astype(dtype[name].base)
                    )
        elif data_mode == "binary":
            buf = f.read(dtype.itemsize * n_points)
            rec = np.frombuffer(buf, dtype=dtype, count=n_points)
        elif data_mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), dtype=np.uint32)
            raw = native.lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            if len(raw) != uncomp_size:
                raise ValueError(f"LZF payload decodes to {len(raw)} bytes, the "
                                 f"header says {uncomp_size}")
            # binary_compressed stores the fields one after another (all x,
            # then all y, ...)
            rec = np.zeros(n_points, dtype=dtype)
            off = 0
            for name, size, typ, count in zip(fields, sizes, types, counts):
                nbytes = size * count * n_points
                arr = np.frombuffer(raw[off : off + nbytes], dtype=_DTYPES[(typ, size)])
                off += nbytes
                rec[name] = arr if count == 1 else arr.reshape(n_points, count)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")

    xyz = np.stack(
        [rec["x"].astype(np.float32), rec["y"].astype(np.float32),
         rec["z"].astype(np.float32)],
        axis=-1,
    )
    rgb = None
    color_field = "rgb" if "rgb" in fields else ("rgba" if "rgba" in fields else None)
    if color_field is not None:
        cf = rec[color_field]
        packed = cf.astype(np.float32).view(np.uint32) if cf.dtype.kind == "f" else (
            cf.astype(np.uint32)
        )
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        rgb = np.stack([r, g, b], axis=-1).astype(np.float32) / 255.0

    finite = np.isfinite(xyz).all(axis=-1)
    if not finite.all():
        xyz = xyz[finite]
        if rgb is not None:
            rgb = rgb[finite]
    return xyz, rgb


def read_pcd(
    path: str | os.PathLike, capacity: Optional[int] = None, device=None
) -> PointCloud:
    """A .pcd file as a padded cloud on `device` (the current CUDA device
    when None)."""
    xyz, rgb = read_pcd_arrays(path)
    return PointCloud.from_numpy(xyz, rgb, capacity=capacity, device=device)


def write_pcd(
    path: str | os.PathLike,
    cloud: PointCloud | tuple[np.ndarray, Optional[np.ndarray]],
    binary: bool = True,
) -> None:
    """Write a .pcd with fields x y z rgb (packed float), binary by default
    (savePCDFileBinary, map_merge_tool.cpp:52)."""
    if isinstance(cloud, PointCloud):
        xyz, rgb = cloud.to_numpy()
    else:
        xyz, rgb = cloud
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    if rgb is None:
        rgb = np.zeros((n, 3), np.float32)
    rgb8 = np.clip(np.asarray(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint32)
    packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
    packed_f = packed.view(np.float32)

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            rec = np.empty(
                n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<f4")]
            )
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            rec["rgb"] = packed_f
            f.write(rec.tobytes())
        else:
            lines = [
                f"{xyz[i, 0]:.6f} {xyz[i, 1]:.6f} {xyz[i, 2]:.6f} {packed_f[i]:.9g}"
                for i in range(n)
            ]
            f.write(("\n".join(lines) + "\n").encode("ascii"))
