"""ESON — LTE's binary JSON-like serialization (examples/common/eson.h;
a copy of ``nanort_tpu.io.eson``, NumPy only).

The reference caches meshes with this format (gui RenderConfig
``eson_filename``). Byte-compatible implementation of the subset the
examples use: OBJECT / FLOAT64 / INT64 / STRING / BINARY (nested objects
supported). Layout (little endian):

  object  := [i64 total_size] payload   (size INCLUDES the 8-byte field)
  payload := { [u8 type] [key bytes]\\0 [value] }*
  float64 := 8 bytes; int64 := 8 bytes
  string/binary := [i64 n] [n bytes]

NumPy arrays map to BINARY (callers re-view dtype/shape; the reference
does the same with raw vertex/face blobs).
"""

from __future__ import annotations

import struct

import numpy as np

NULL_T, FLOAT64_T, INT64_T, STRING_T, ARRAY_T, BINARY_T, OBJECT_T = (
    0, 1, 2, 4, 5, 6, 7,
)


def _ser_value(v) -> tuple[int, bytes]:
    if isinstance(v, bool):
        return INT64_T, struct.pack("<q", int(v))
    if isinstance(v, (int, np.integer)):
        return INT64_T, struct.pack("<q", int(v))
    if isinstance(v, (float, np.floating)):
        return FLOAT64_T, struct.pack("<d", float(v))
    if isinstance(v, str):
        b = v.encode()
        return STRING_T, struct.pack("<q", len(b)) + b
    if isinstance(v, (bytes, bytearray)):
        return BINARY_T, struct.pack("<q", len(v)) + bytes(v)
    if isinstance(v, np.ndarray):
        b = np.ascontiguousarray(v).tobytes()
        return BINARY_T, struct.pack("<q", len(b)) + b
    if isinstance(v, dict):
        return OBJECT_T, _ser_object(v)
    raise TypeError(f"eson cannot serialize {type(v)}")


def _ser_object(d: dict) -> bytes:
    payload = b""
    for k, v in d.items():
        ty, body = _ser_value(v)
        payload += struct.pack("<B", ty) + k.encode() + b"\0" + body
    # the reference's size field is self-inclusive (eson.h ComputeSize:
    # ComputeObjectSize() + sizeof(int64_t))
    return struct.pack("<q", len(payload) + 8) + payload


def dumps(d: dict) -> bytes:
    return _ser_object(d)


def dump(d: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(d))


def _parse_object(buf: bytes, off: int) -> tuple[dict, int]:
    (size,) = struct.unpack_from("<q", buf, off)
    off += 8
    end = off + size - 8  # self-inclusive size
    out = {}
    while off < end:
        ty = buf[off]
        off += 1
        z = buf.index(b"\0", off)
        key = buf[off:z].decode()
        off = z + 1
        if ty == FLOAT64_T:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
        elif ty == INT64_T:
            (val,) = struct.unpack_from("<q", buf, off)
            off += 8
        elif ty in (STRING_T, BINARY_T):
            (n,) = struct.unpack_from("<q", buf, off)
            off += 8
            raw = buf[off : off + n]
            off += n
            val = raw.decode() if ty == STRING_T else bytes(raw)
        elif ty == OBJECT_T:
            val, off = _parse_object(buf, off)
        else:
            raise ValueError(f"eson type {ty} unsupported")
        out[key] = val
    return out, off


def loads(buf: bytes) -> dict:
    d, _ = _parse_object(bytes(buf), 0)
    return d


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return loads(f.read())


# --- mesh cache helpers (the reference's use case) ---

def save_mesh(path: str, vertices, faces, **extra) -> None:
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.uint32)
    d = {
        "num_vertices": int(len(v)),
        "num_faces": int(len(f)),
        "vertices": v,
        "faces": f,
    }
    d.update(extra)
    dump(d, path)


def load_mesh(path: str):
    d = load(path)
    v = np.frombuffer(d["vertices"], np.float32).reshape(-1, 3)
    f = np.frombuffer(d["faces"], np.uint32).reshape(-1, 3)
    assert len(v) == d["num_vertices"] and len(f) == d["num_faces"]
    return v.copy(), f.copy(), d
