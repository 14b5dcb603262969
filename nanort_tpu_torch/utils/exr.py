"""Minimal OpenEXR writer/reader (uncompressed float32 scanlines; a copy
of ``nanort_tpu.utils.exr``, NumPy only).

The reference vendors tinyexr for HDR output (SaveImageEXR in most
examples). This implements the EXR 2.0 container with compression=NONE
and float32 RGB(A) channels — readable by any EXR tool, dependency-free.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def save_exr(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3|4) float32, linear."""
    img = np.asarray(img, np.float32)
    h, w, c = img.shape
    names = ["B", "G", "R"] if c == 3 else ["A", "B", "G", "R"]
    src = {"R": 0, "G": 1, "B": 2, "A": 3}

    chl = b""
    for n in names:  # alphabetical channel list
        chl += n.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)  # FLOAT
    chl += b"\0"

    header = b""
    header += _attr("channels", "chlist", chl)
    header += _attr("compression", "compression", b"\0")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_off = len(preamble) + 8 * h
    line_bytes = 8 + len(names) * w * 4
    with open(path, "wb") as f:
        f.write(preamble)
        for y in range(h):
            f.write(struct.pack("<Q", table_off + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<ii", y, len(names) * w * 4))
            for n in names:
                f.write(img[y, :, src[n]].tobytes())


def load_exr(path: str) -> np.ndarray:
    """Reads files written by save_exr (NONE compression, float32)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, ver = struct.unpack_from("<ii", data, 0)
    assert magic == _MAGIC, "not an EXR file"
    off = 8
    channels = []
    dw = None
    comp = None
    while data[off] != 0:
        z = data.index(b"\0", off)
        name = data[off:z].decode()
        off = z + 1
        z = data.index(b"\0", off)
        off = z + 1
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        payload = data[off : off + n]
        off += n
        if name == "channels":
            p = 0
            while payload[p] != 0:
                zz = payload.index(b"\0", p)
                cn = payload[p:zz].decode()
                (ptype,) = struct.unpack_from("<i", payload, zz + 1)
                assert ptype == 2, "only FLOAT channels supported"
                channels.append(cn)
                p = zz + 17
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
        elif name == "compression":
            comp = payload[0]
    assert comp == 0, "only NONE compression supported"
    off += 1  # header terminator
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    off += 8 * h  # skip line offset table
    out = np.zeros((h, w, len(channels)), np.float32)
    for _ in range(h):
        y, nb = struct.unpack_from("<ii", data, off)
        off += 8
        for ci, cn in enumerate(channels):
            out[y - dw[1], :, ci] = np.frombuffer(data, np.float32, w, off)
            off += 4 * w
    order = {"R": 0, "G": 1, "B": 2, "A": 3}
    rgb = np.zeros((h, w, len(channels)), np.float32)
    for ci, cn in enumerate(channels):
        rgb[:, :, order.get(cn, ci)] = out[:, :, ci]
    return rgb[:, :, :3] if len(channels) == 3 else rgb
