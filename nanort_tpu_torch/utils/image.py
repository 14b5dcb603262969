"""Image output: PPM and dependency-free PNG (a copy of
``nanort_tpu.utils.image``, NumPy only; the reference vendors
stb_image_write for this, here ~40 lines of zlib+struct do it)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Tonemap [0,1] float to u8 with gamma (reference examples apply
    pow(1/2.2), e.g. objrender/main.cc SaveImagePNG path)."""
    img = np.clip(np.asarray(img, np.float64), 0.0, 1.0)
    if gamma and gamma != 1.0:
        img = img ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    u8 = to_u8(img, gamma)
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(u8.tobytes())


def encode_png(img: np.ndarray, gamma: float = 2.2) -> bytes:
    """Minimal RGB(A) PNG encoder (8-bit, no interlace) returning bytes
    (the live HTTP viewer serves these directly)."""
    u8 = to_u8(img, gamma)
    if u8.ndim == 2:
        u8 = u8[..., None].repeat(3, -1)
    h, w, c = u8.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + u8[r].tobytes() for r in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """Minimal RGB(A) PNG writer (8-bit, no interlace)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, gamma))
