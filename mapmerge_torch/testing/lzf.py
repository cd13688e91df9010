"""A greedy LZF compressor and a binary_compressed PCD writer, the test
fixtures that make the files `io/pcd.py` decodes (the port reads
binary_compressed files but, like the reference, never writes them).

Used by the tests and by `chip_smoke.py`; not a package API.
"""

from __future__ import annotations

import numpy as np


def lzf_compress(data: bytes) -> bytes:
    """A greedy LZF compressor (liblzf's format): literal runs of up to 32
    bytes and back references of 3-264 bytes within 8 KiB, overlapping
    ones included."""
    out, lit, table = bytearray(), bytearray(), {}

    def flush():
        for s in range(0, len(lit), 32):
            chunk = lit[s : s + 32]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    i, n = 0, len(data)
    while i < n:
        ref = table.get(data[i : i + 3]) if i + 3 <= n else None
        if i + 3 <= n:
            table[data[i : i + 3]] = i
        if ref is not None and i - ref - 1 < 8192:
            length = 3
            while i + length < n and length < 264 and data[ref + length] == data[i + length]:
                length += 1
            flush()
            off, code = i - ref - 1, length - 2
            if code < 7:
                out.append((code << 5) | (off >> 8))
            else:
                out.extend([(7 << 5) | (off >> 8), code - 7])
            out.append(off & 0xFF)
            i += length
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def pcd_payload(xyz: np.ndarray, rgb: np.ndarray | None) -> bytes:
    """The uncompressed payload of a binary_compressed PCD with fields x y z
    rgb: each field's values one after another (all x, then all y, ...),
    rgb packed as write_pcd packs it (zeros when None)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    if rgb is None:
        rgb = np.zeros_like(xyz)
    rgb8 = np.clip(np.asarray(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint32)
    packed = ((rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]).view(np.float32)
    return b"".join(
        np.ascontiguousarray(a, np.float32).tobytes()
        for a in (xyz[:, 0], xyz[:, 1], xyz[:, 2], packed)
    )


def write_pcd_compressed(path, xyz: np.ndarray, rgb: np.ndarray | None) -> bytes:
    """Write a binary_compressed PCD (fields x y z rgb); returns its LZF
    payload."""
    raw = pcd_payload(xyz, rgb)
    payload = lzf_compress(raw)
    n = len(raw) // 16
    header = (
        "VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary_compressed\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.array([len(payload), len(raw)], np.uint32).tobytes())
        f.write(payload)
    return payload
