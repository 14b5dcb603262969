"""Minecraft Anvil region (.mca) loader — enkiMI equivalent (a copy of
``nanort_tpu.io.minecraft``, NumPy only; it meshes with the port's
``io.voxels``).

The reference's minecraft example vendors enkiMI (C) + miniz to read
region files and raytraces the blocks as cubes
(examples/minecraft/main.cc:401-430 LoadMI/BuildBVH). This is an
independent pure-Python reader of the same formats:

* NBT (Named Binary Tag) parser — full tag set, big-endian, zlib/gzip.
* Region container: 4 KiB sector table (1024 chunk locations +
  timestamps), per-chunk [length u32][compression u8][payload].
* Chunk voxel extraction for both schema generations:
  - legacy (< 1.13): ``Level.Sections[].Blocks`` 4096-byte YZX array;
  - flattened (1.13+): ``BlockStates`` packed palette indices +
    ``Palette``/``palette`` name list (handles the 1.16 change where
    entries stopped straddling longs).

``region_to_voxels`` returns a dense bool occupancy grid ready for
io.voxels.voxels_to_mesh -> BVH -> raytrace.
"""

from __future__ import annotations

import gzip
import io as _io
import struct
import zlib

import numpy as np

# NBT tag ids
TAG_END, TAG_BYTE, TAG_SHORT, TAG_INT, TAG_LONG = 0, 1, 2, 3, 4
TAG_FLOAT, TAG_DOUBLE, TAG_BYTE_ARRAY, TAG_STRING = 5, 6, 7, 8
TAG_LIST, TAG_COMPOUND, TAG_INT_ARRAY, TAG_LONG_ARRAY = 9, 10, 11, 12


def _read_payload(buf, tag):
    if tag == TAG_BYTE:
        return struct.unpack(">b", buf.read(1))[0]
    if tag == TAG_SHORT:
        return struct.unpack(">h", buf.read(2))[0]
    if tag == TAG_INT:
        return struct.unpack(">i", buf.read(4))[0]
    if tag == TAG_LONG:
        return struct.unpack(">q", buf.read(8))[0]
    if tag == TAG_FLOAT:
        return struct.unpack(">f", buf.read(4))[0]
    if tag == TAG_DOUBLE:
        return struct.unpack(">d", buf.read(8))[0]
    if tag == TAG_BYTE_ARRAY:
        n = struct.unpack(">i", buf.read(4))[0]
        return np.frombuffer(buf.read(n), np.int8)
    if tag == TAG_STRING:
        n = struct.unpack(">H", buf.read(2))[0]
        return buf.read(n).decode("utf-8", "replace")
    if tag == TAG_LIST:
        etag = struct.unpack(">b", buf.read(1))[0]
        n = struct.unpack(">i", buf.read(4))[0]
        return [_read_payload(buf, etag) for _ in range(n)]
    if tag == TAG_COMPOUND:
        out = {}
        while True:
            t = struct.unpack(">b", buf.read(1))[0]
            if t == TAG_END:
                return out
            ln = struct.unpack(">H", buf.read(2))[0]
            name = buf.read(ln).decode("utf-8", "replace")
            out[name] = _read_payload(buf, t)
    if tag == TAG_INT_ARRAY:
        n = struct.unpack(">i", buf.read(4))[0]
        return np.frombuffer(buf.read(4 * n), ">i4").astype(np.int32)
    if tag == TAG_LONG_ARRAY:
        n = struct.unpack(">i", buf.read(4))[0]
        return np.frombuffer(buf.read(8 * n), ">i8").astype(np.int64)
    raise ValueError(f"unknown NBT tag {tag}")


def parse_nbt(data: bytes):
    """Parse an uncompressed NBT blob; returns (root_name, root_dict)."""
    buf = _io.BytesIO(data)
    tag = struct.unpack(">b", buf.read(1))[0]
    if tag != TAG_COMPOUND:
        raise ValueError(f"NBT root must be a compound, got tag {tag}")
    ln = struct.unpack(">H", buf.read(2))[0]
    name = buf.read(ln).decode("utf-8", "replace")
    return name, _read_payload(buf, TAG_COMPOUND)


def _decompress(raw: bytes, scheme: int) -> bytes:
    if scheme == 1:
        return gzip.decompress(raw)
    if scheme == 2:
        return zlib.decompress(raw)
    if scheme == 3:
        return raw
    raise ValueError(f"unknown chunk compression scheme {scheme}")


def read_region(data: bytes):
    """Parse one .mca region file. Returns a list of chunk NBT roots
    (dicts) for every populated chunk."""
    if len(data) < 8192:
        raise ValueError("region file shorter than its 8 KiB header")
    chunks = []
    for i in range(1024):
        off, cnt = struct.unpack_from(">I", data, i * 4)[0] >> 8, data[i * 4 + 3]
        if off == 0 or cnt == 0:
            continue
        base = off * 4096
        (length,) = struct.unpack_from(">I", data, base)
        scheme = data[base + 4]
        raw = data[base + 5: base + 4 + length]
        _, root = parse_nbt(_decompress(raw, scheme))
        chunks.append(root)
    return chunks


def _section_blocks(section) -> np.ndarray | None:
    """One 16x16x16 section -> (16,16,16) bool occupancy (y, z, x order
    flattened as the format stores it; we return [x, y, z] indexed)."""
    occ = None
    if "Blocks" in section:  # legacy: byte per block, YZX order
        ids = np.asarray(section["Blocks"], np.uint8).reshape(16, 16, 16)
        occ = ids != 0  # [y, z, x]
    else:
        states = section.get("BlockStates")
        pal = section.get("Palette", section.get("palette"))
        if states is None and isinstance(section.get("block_states"), dict):
            bs = section["block_states"]
            states = bs.get("data")
            pal = bs.get("palette", pal)
        if states is None or pal is None:
            return None
        pal_solid = np.asarray(
            [
                (p.get("Name", p.get("name", "")) if isinstance(p, dict)
                 else str(p)) not in ("minecraft:air", "minecraft:cave_air",
                                     "minecraft:void_air", "air")
                for p in pal
            ],
            bool,
        )
        n_pal = len(pal_solid)
        bits = max(4, (n_pal - 1).bit_length())
        longs = np.asarray(states, np.uint64)
        per_long = 64 // bits  # 1.16+: indices never straddle longs
        idx = np.zeros(4096, np.int64)
        mask = np.uint64((1 << bits) - 1)
        pos = np.arange(4096)
        li = pos // per_long
        sh = (pos % per_long) * bits
        if li.max(initial=0) < len(longs):
            idx = ((longs[li] >> sh.astype(np.uint64)) & mask).astype(
                np.int64
            )
        else:  # pre-1.16 straddling packing
            bitpos = pos * bits
            li = bitpos // 64
            sh = bitpos % 64
            lo = longs[np.minimum(li, len(longs) - 1)] >> sh.astype(np.uint64)
            hi = np.where(
                sh + bits > 64,
                longs[np.minimum(li + 1, len(longs) - 1)]
                << (np.uint64(64) - sh.astype(np.uint64)),
                np.uint64(0),
            )
            idx = ((lo | hi) & mask).astype(np.int64)
        idx = np.clip(idx, 0, n_pal - 1)
        occ = pal_solid[idx].reshape(16, 16, 16)  # [y, z, x]
    return np.transpose(occ, (2, 0, 1))  # -> [x, y, z]


def chunk_to_voxels(chunk) -> tuple[np.ndarray, int, int, int] | None:
    """One chunk NBT -> (occ [16, Y, 16] bool, chunk_x, y_min, chunk_z)."""
    level = chunk.get("Level", chunk)
    sections = level.get("Sections", level.get("sections"))
    if not sections:
        return None
    xpos = int(level.get("xPos", 0))
    zpos = int(level.get("zPos", 0))
    parts = {}
    for s in sections:
        if not isinstance(s, dict):
            continue
        occ = _section_blocks(s)
        if occ is None:
            continue
        parts[int(s.get("Y", 0))] = occ
    if not parts:
        return None
    y_lo, y_hi = min(parts), max(parts)
    occ = np.zeros((16, (y_hi - y_lo + 1) * 16, 16), bool)
    for y, sec in parts.items():
        occ[:, (y - y_lo) * 16: (y - y_lo + 1) * 16, :] = sec
    return occ, xpos, y_lo * 16, zpos


def region_to_voxels(data: bytes):
    """Whole region -> (occ dense bool grid [X, Y, Z], origin (x0,y0,z0)).
    Only populated chunks contribute; the grid covers their bounds."""
    chunks = [c for c in (chunk_to_voxels(ch) for ch in read_region(data))
              if c is not None]
    if not chunks:
        raise ValueError("region contains no block data")
    xs = [c[1] for c in chunks]
    zs = [c[3] for c in chunks]
    y0 = min(c[2] for c in chunks)
    y1 = max(c[2] + c[0].shape[1] for c in chunks)
    x0, z0 = min(xs), min(zs)
    nx = (max(xs) - x0 + 1) * 16
    nz = (max(zs) - z0 + 1) * 16
    occ = np.zeros((nx, y1 - y0, nz), bool)
    for sec, cx, cy, cz in chunks:
        occ[
            (cx - x0) * 16: (cx - x0 + 1) * 16,
            cy - y0: cy - y0 + sec.shape[1],
            (cz - z0) * 16: (cz - z0 + 1) * 16,
        ] = sec
    return occ, (x0 * 16, y0, z0 * 16)


def load_region_mesh(path_or_bytes, voxel_size: float = 1.0):
    """.mca file -> (vertices, faces) cube mesh (the reference's
    LoadMI -> BuildBVH flow, examples/minecraft/main.cc:401-430)."""
    from .voxels import voxels_to_mesh

    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    occ, origin = region_to_voxels(bytes(data))
    v, f = voxels_to_mesh(occ, voxel_size=voxel_size)
    v += np.asarray(origin, np.float32) * voxel_size
    return v, f
