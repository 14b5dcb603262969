"""Particle-file IO (partio equivalent, PDA/PDB subset; port of
``nanort_tpu.io.partio``: the file I/O is a NumPy copy, ``to_spheres``
builds the port's ``ops.sphere.Spheres`` on ``device``).

The reference's partio_view example links Disney's partio to load
particle files and view them as spheres (examples/partio_view/, external
lib required there too). This is a self-contained reader/writer for the
two classic Wavefront/partio interchange formats the library is most
used for:

* PDA — ascii: ATTRIBUTES / <name> <V|R|I> / NUMPARTICLES / BEGIN DATA
* PDB — binary v1.0 (magic 0x0bedebed, 32-byte channel names, typed
  channel blocks)

``to_spheres`` bridges a cloud to ops.sphere for raytracing, matching
the LAS example's sphere rendering path.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_PDB_MAGIC = 0x0BEDEBED
# PDB channel types
_PDB_VECTOR, _PDB_REAL, _PDB_LONG = 1, 2, 3


class ParticleCloud(NamedTuple):
    positions: np.ndarray  # (N, 3) f32
    attributes: dict  # name -> (N,) or (N, 3) arrays

    @property
    def count(self) -> int:
        return self.positions.shape[0]


# ---------------------------------------------------------------------------
# PDA (ascii)
# ---------------------------------------------------------------------------


def save_pda(path: str, cloud: ParticleCloud) -> None:
    attrs = [("position", cloud.positions, "V")]
    for name, arr in cloud.attributes.items():
        arr = np.asarray(arr)
        kind = "V" if arr.ndim == 2 else (
            "I" if np.issubdtype(arr.dtype, np.integer) else "R"
        )
        attrs.append((name, arr, kind))
    with open(path, "w") as f:
        f.write("ATTRIBUTES\n")
        for name, _, kind in attrs:
            f.write(f"{name} {kind}\n")
        f.write(f"NUMPARTICLES\n{cloud.count}\n")
        f.write("BEGIN DATA\n")
        for i in range(cloud.count):
            cols = []
            for _, arr, kind in attrs:
                if kind == "V":
                    cols.extend(f"{x:.9g}" for x in np.asarray(arr[i]))
                elif kind == "I":
                    cols.append(str(int(arr[i])))
                else:
                    cols.append(f"{float(arr[i]):.9g}")
            f.write(" ".join(cols) + "\n")


def load_pda(path: str) -> ParticleCloud:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines or lines[0] != "ATTRIBUTES":
        raise ValueError("not a PDA file (missing ATTRIBUTES)")
    i = 1
    attrs: list[tuple[str, str]] = []
    while i < len(lines) and lines[i] != "NUMPARTICLES":
        parts = lines[i].split()
        if len(parts) != 2 or parts[1] not in ("V", "R", "I"):
            raise ValueError(f"bad attribute line {lines[i]!r}")
        attrs.append((parts[0], parts[1]))
        i += 1
    if i + 1 >= len(lines):
        raise ValueError("truncated PDA header")
    n = int(lines[i + 1])
    i += 2
    if lines[i] != "BEGIN DATA":
        raise ValueError("missing BEGIN DATA")
    rows = [ln.split() for ln in lines[i + 1: i + 1 + n]]
    if len(rows) != n:
        raise ValueError(f"expected {n} data rows, got {len(rows)}")
    cols: dict[str, np.ndarray] = {}
    c = 0
    for name, kind in attrs:
        w = 3 if kind == "V" else 1
        block = np.asarray(
            [[float(r[c + j]) for j in range(w)] for r in rows]
        )
        cols[name] = (
            block.astype(np.float32)
            if kind == "V"
            else block[:, 0].astype(np.int32 if kind == "I" else np.float32)
        )
        c += w
    if "position" not in cols:
        raise ValueError("PDA file lacks a position attribute")
    pos = cols.pop("position")
    return ParticleCloud(positions=pos, attributes=cols)


# ---------------------------------------------------------------------------
# PDB (binary v1.0)
# ---------------------------------------------------------------------------


def save_pdb(path: str, cloud: ParticleCloud) -> None:
    chans = [("position", np.asarray(cloud.positions, np.float32))]
    for name, arr in cloud.attributes.items():
        chans.append((name, np.asarray(arr)))
    with open(path, "wb") as f:
        f.write(struct.pack("<ifi", _PDB_MAGIC, 1.0, len(chans)))
        f.write(struct.pack("<i", cloud.count))
        for name, arr in chans:
            if arr.ndim == 2:
                typ, payload = _PDB_VECTOR, arr.astype("<f4").tobytes()
            elif np.issubdtype(arr.dtype, np.integer):
                typ, payload = _PDB_LONG, arr.astype("<i4").tobytes()
            else:
                typ, payload = _PDB_REAL, arr.astype("<f4").tobytes()
            f.write(struct.pack("<32s", name.encode()[:31]))
            f.write(struct.pack("<ii", typ, len(payload)))
            f.write(payload)


def load_pdb(path: str) -> ParticleCloud:
    with open(path, "rb") as f:
        data = f.read()
    magic, _ver, n_chan = struct.unpack_from("<ifi", data, 0)
    if magic != _PDB_MAGIC:
        raise ValueError("not a PDB particle file")
    (count,) = struct.unpack_from("<i", data, 12)
    off = 16
    pos = None
    attrs = {}
    for _ in range(n_chan):
        (raw_name,) = struct.unpack_from("<32s", data, off)
        name = raw_name.split(b"\x00")[0].decode()
        typ, nbytes = struct.unpack_from("<ii", data, off + 32)
        off += 40
        payload = data[off: off + nbytes]
        off += nbytes
        if typ == _PDB_VECTOR:
            arr = np.frombuffer(payload, "<f4").reshape(count, 3).copy()
        elif typ == _PDB_LONG:
            arr = np.frombuffer(payload, "<i4").copy()
        else:
            arr = np.frombuffer(payload, "<f4").copy()
        if name == "position":
            pos = arr
        else:
            attrs[name] = arr
    if pos is None:
        raise ValueError("PDB file lacks a position channel")
    return ParticleCloud(positions=pos.astype(np.float32), attributes=attrs)


def load_particles(path: str) -> ParticleCloud:
    """Sniff PDA vs PDB by content."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == struct.pack("<i", _PDB_MAGIC):
        return load_pdb(path)
    return load_pda(path)


def to_spheres(cloud: ParticleCloud, radius: float | None = None,
               device="cuda"):
    """Particles -> ops.sphere.Spheres (the partio_view flow: particles
    as spheres, radius from the ``radius``/``pscale`` attribute when
    present), as tensors on ``device`` (the card unless the caller asks
    for another device)."""
    import torch

    from ..ops.sphere import Spheres

    n = cloud.count
    r = cloud.attributes.get("radius", cloud.attributes.get("pscale"))
    if radius is not None:
        rr = np.full(n, radius, np.float32)
    elif r is not None:
        rr = np.asarray(r, np.float32)
    else:
        ext = cloud.positions.max(0) - cloud.positions.min(0)
        rr = np.full(n, max(float(ext.max()), 1e-6) / 200.0, np.float32)
    return Spheres(
        centers=torch.as_tensor(np.asarray(cloud.positions), device=device),
        radii=torch.as_tensor(rr, device=device),
    )
