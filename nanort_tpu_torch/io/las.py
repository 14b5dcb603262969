"""Minimal LAS (LiDAR) point-cloud reader (port of ``nanort_tpu.io.las``:
the file I/O is a NumPy copy; ``to_spheres`` builds the port's
``ops.sphere.Spheres`` on ``device``).

The reference's las example loads LAS points with libLAS and renders them
as spheres (examples/las/render.cc:84-270). This reads LAS 1.0-1.4
headers directly (no external lib): scaled int32 XYZ + intensity from
point formats 0-10, returning arrays ready for ops.sphere.Spheres.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class LasCloud(NamedTuple):
    points: np.ndarray  # (N, 3) float32 (scale/offset applied)
    intensity: np.ndarray  # (N,) float32 normalized [0, 1]


def load_las(path: str) -> LasCloud:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"LASF":
        raise ValueError("not a LAS file")
    (point_offset,) = struct.unpack_from("<I", data, 96)
    (fmt,) = struct.unpack_from("<B", data, 104)
    fmt &= 0x3F  # high bits flag compression (laszip unsupported)
    (rec_len,) = struct.unpack_from("<H", data, 105)
    (n_legacy,) = struct.unpack_from("<I", data, 107)
    sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", data, 131)
    n = n_legacy
    ver = (data[24], data[25])
    if n == 0 and ver >= (1, 4):
        (n,) = struct.unpack_from("<Q", data, 247)
    if rec_len < 20:
        raise ValueError(f"point record length {rec_len} unsupported")

    raw = np.frombuffer(
        data, np.uint8, count=n * rec_len, offset=point_offset
    ).reshape(n, rec_len)
    xyz = raw[:, :12].copy().view("<i4").reshape(n, 3).astype(np.float64)
    pts = xyz * [sx, sy, sz] + [ox, oy, oz]
    inten = raw[:, 12:14].copy().view("<u2").reshape(n).astype(np.float32)
    return LasCloud(
        points=pts.astype(np.float32),
        intensity=inten / 65535.0,
    )


def save_las(path: str, points: np.ndarray, intensity=None) -> None:
    """Write a minimal LAS 1.2 format-0 file (test fixtures, export)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    lo = points.min(axis=0) if n else np.zeros(3)
    hi = points.max(axis=0) if n else np.zeros(3)
    scale = np.maximum((hi - lo) / 2**30, 1e-9)
    header = bytearray(227)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<H", header, 94, 227)  # header size
    struct.pack_into("<I", header, 96, 227)  # point data offset
    struct.pack_into("<I", header, 100, 0)  # VLR count
    struct.pack_into("<B", header, 104, 0)  # format 0
    struct.pack_into("<H", header, 105, 20)  # record length
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<6d", header, 131, *scale, *lo)
    struct.pack_into("<6d", header, 179, hi[0], lo[0], hi[1], lo[1], hi[2], lo[2])

    q = np.round((points - lo) / scale).astype(np.int32)
    if intensity is None:
        intensity = np.zeros(n)
    inten = (np.asarray(intensity, np.float64) * 65535).astype(np.uint16)
    rec = np.zeros((n, 20), np.uint8)
    rec[:, :12] = q.astype("<i4").view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = inten.astype("<u2").view(np.uint8).reshape(n, 2)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def to_spheres(cloud: LasCloud, radius: float | None = None,
               device="cuda"):
    """Points -> sphere primitives (las example: constant radius derived
    from the cloud extent when not given), as tensors on ``device`` (the
    card unless the caller asks for another device)."""
    import torch

    from ..ops.sphere import Spheres

    pts = cloud.points
    if radius is None:
        ext = pts.max(axis=0) - pts.min(axis=0)
        radius = float(np.linalg.norm(ext)) / max(len(pts) ** (1 / 3), 1) * 0.05
        radius = max(radius, 1e-6)
    return Spheres(
        centers=torch.as_tensor(np.asarray(pts), device=device),
        radii=torch.full((len(pts),), radius, dtype=torch.float32,
                         device=device),
    )
