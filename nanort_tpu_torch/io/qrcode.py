"""QR code generator (byte mode, versions 1-10, EC levels L/M/Q/H; a
copy of ``nanort_tpu.io.qrcode``, NumPy only).

The reference's qrcode example vendors qrcodegen.c to turn a string into
a module grid, then extrudes modules to boxes and raytraces them
(examples/qrcode/main.cc). This is an independent from-scratch encoder
of the same capability (ISO/IEC 18004): byte-mode segmentation,
Reed-Solomon EC over GF(256) (poly 0x11D), interleaved blocks, all 8
masks with penalty scoring, format + version info. Feed the resulting
boolean grid to io.voxels.grid_to_boxes for the raytraced symbol.

Self-checking: ``verify_qr`` re-reads a generated matrix (format BCH,
de-zigzag, de-interleave, RS syndromes, payload parse) so tests close a
real encode->decode loop without an external library.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# GF(256)
# ---------------------------------------------------------------------------

_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_EXP[255:510] = _EXP[0:255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _rs_generator(n: int) -> list[int]:
    g = [1]
    for i in range(n):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, int(_EXP[i]))
            g2[j + 1] ^= c
        g = g2
    return g


def _rs_encode(data: list[int], n_ec: int) -> list[int]:
    # _rs_generator returns ascending-degree coefficients; the division
    # loop wants descending (gen[0] = monic x^n term)
    gen = _rs_generator(n_ec)[::-1]
    rem = [0] * n_ec
    for d in data:
        factor = d ^ rem[0]
        rem = rem[1:] + [0]
        for j in range(n_ec):
            rem[j] ^= _gf_mul(gen[j + 1], factor)
    return rem


# ---------------------------------------------------------------------------
# Version tables (ISO 18004, versions 1-10)
# (ec_per_block, [(num_blocks, data_cw_per_block), ...]) per level
# ---------------------------------------------------------------------------

_BLOCKS = {
    # version: {level: (ec_per_block, [(blocks, data_cw), ...])}
    1: {"L": (7, [(1, 19)]), "M": (10, [(1, 16)]),
        "Q": (13, [(1, 13)]), "H": (17, [(1, 9)])},
    2: {"L": (10, [(1, 34)]), "M": (16, [(1, 28)]),
        "Q": (22, [(1, 22)]), "H": (28, [(1, 16)])},
    3: {"L": (15, [(1, 55)]), "M": (26, [(1, 44)]),
        "Q": (18, [(2, 17)]), "H": (22, [(2, 13)])},
    4: {"L": (20, [(1, 80)]), "M": (18, [(2, 32)]),
        "Q": (26, [(2, 24)]), "H": (16, [(4, 9)])},
    5: {"L": (26, [(1, 108)]), "M": (24, [(2, 43)]),
        "Q": (18, [(2, 15), (2, 16)]), "H": (22, [(2, 11), (2, 12)])},
    6: {"L": (18, [(2, 68)]), "M": (16, [(4, 27)]),
        "Q": (24, [(4, 19)]), "H": (28, [(4, 15)])},
    7: {"L": (20, [(2, 78)]), "M": (18, [(4, 31)]),
        "Q": (18, [(2, 14), (4, 15)]), "H": (26, [(4, 13), (1, 14)])},
    8: {"L": (24, [(2, 97)]), "M": (22, [(2, 38), (2, 39)]),
        "Q": (22, [(4, 18), (2, 19)]), "H": (26, [(4, 14), (2, 15)])},
    9: {"L": (30, [(2, 116)]), "M": (22, [(3, 36), (2, 37)]),
        "Q": (20, [(4, 16), (4, 17)]), "H": (24, [(4, 12), (4, 13)])},
    10: {"L": (18, [(2, 68), (2, 69)]), "M": (26, [(4, 43), (1, 44)]),
         "Q": (24, [(6, 19), (2, 20)]), "H": (28, [(6, 15), (2, 16)])},
}

_ALIGN = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
    6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46],
    10: [6, 28, 50],
}

_LEVEL_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}


def _data_capacity(version: int, level: str) -> int:
    _, groups = _BLOCKS[version][level]
    return sum(b * c for b, c in groups)


def _bit_stream(payload: bytes, version: int, level: str) -> list[int]:
    cap = _data_capacity(version, level)
    bits: list[int] = []

    def put(value, n):
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    put(0b0100, 4)  # byte mode
    put(len(payload), 16 if version >= 10 else 8)
    for b in payload:
        put(b, 8)
    # terminator + pad to byte
    bits.extend([0] * min(4, cap * 8 - len(bits)))
    bits.extend([0] * ((8 - len(bits) % 8) % 8))
    # pad codewords
    pads = [0xEC, 0x11]
    i = 0
    while len(bits) < cap * 8:
        put(pads[i % 2], 8)
        i += 1
    return bits[: cap * 8]


def _codewords(payload: bytes, version: int, level: str) -> list[int]:
    """Data codewords -> RS blocks -> interleaved final sequence."""
    bits = _bit_stream(payload, version, level)
    data = [
        int("".join(map(str, bits[i: i + 8])), 2)
        for i in range(0, len(bits), 8)
    ]
    ec_n, groups = _BLOCKS[version][level]
    blocks, ecs = [], []
    pos = 0
    for nb, cw in groups:
        for _ in range(nb):
            blk = data[pos: pos + cw]
            pos += cw
            blocks.append(blk)
            ecs.append(_rs_encode(blk, ec_n))
    out = []
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(ec_n):
        for e in ecs:
            out.append(e[i])
    return out


# ---------------------------------------------------------------------------
# matrix construction
# ---------------------------------------------------------------------------


def _function_patterns(version: int):
    """Returns (matrix, is_function) with finders/timing/alignment/dark
    placed and format/version areas reserved."""
    size = 17 + 4 * version
    m = np.zeros((size, size), np.uint8)
    func = np.zeros((size, size), bool)

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < size and 0 <= cc < size):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                ring = inside and (dr in (0, 6) or dc in (0, 6))
                core = 2 <= dr <= 4 and 2 <= dc <= 4
                m[rr, cc] = 1 if (ring or core) else 0
                func[rr, cc] = True

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    # timing
    for i in range(8, size - 8):
        v = 1 - (i & 1)
        for r, c in ((6, i), (i, 6)):
            m[r, c] = v
            func[r, c] = True
    # alignment
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            if func[r, c]:  # overlaps a finder
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    ring = max(abs(dr), abs(dc)) != 1
                    m[r + dr, c + dc] = 1 if ring else 0
                    func[r + dr, c + dc] = True
    # format info areas
    for i in range(9):
        func[8, i] = func[i, 8] = True
    for i in range(8):
        func[8, size - 1 - i] = func[size - 1 - i, 8] = True
    # dark module
    m[size - 8, 8] = 1
    func[size - 8, 8] = True
    # version info (v >= 7)
    if version >= 7:
        func[size - 11: size - 8, 0:6] = True
        func[0:6, size - 11: size - 8] = True
    return m, func


def _zigzag_coords(size: int, func: np.ndarray):
    coords = []
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if not func[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


def _mask_bit(mask: int, r: int, c: int) -> bool:
    if mask == 0:
        return (r + c) % 2 == 0
    if mask == 1:
        return r % 2 == 0
    if mask == 2:
        return c % 3 == 0
    if mask == 3:
        return (r + c) % 3 == 0
    if mask == 4:
        return (r // 2 + c // 3) % 2 == 0
    if mask == 5:
        return (r * c) % 2 + (r * c) % 3 == 0
    if mask == 6:
        return ((r * c) % 2 + (r * c) % 3) % 2 == 0
    return ((r + c) % 2 + (r * c) % 3) % 2 == 0


def _penalty(m: np.ndarray) -> int:
    size = m.shape[0]
    score = 0
    for grid in (m, m.T):
        for line in grid:
            run = 1
            for i in range(1, size):
                if line[i] == line[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + run - 5
                    run = 1
            if run >= 5:
                score += 3 + run - 5
    blocks = (
        (m[:-1, :-1] == m[1:, :-1])
        & (m[:-1, :-1] == m[:-1, 1:])
        & (m[:-1, :-1] == m[1:, 1:])
    )
    score += 3 * int(blocks.sum())
    pat1 = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], np.uint8)
    for grid in (m, m.T):
        for line in grid:
            for i in range(size - 10):
                w = line[i: i + 11]
                if np.array_equal(w, pat1) or np.array_equal(w, pat1[::-1]):
                    score += 40
    dark = int(m.sum())
    k = abs(dark * 100 // (size * size) - 50) // 5
    score += 10 * k
    return score


def _format_bits(level: str, mask: int) -> int:
    data = (_LEVEL_BITS[level] << 3) | mask
    rem = data << 10
    g = 0b10100110111
    for i in range(14, 9, -1):
        if (rem >> i) & 1:
            rem ^= g << (i - 10)
    return ((data << 10) | rem) ^ 0b101010000010010


def _version_bits(version: int) -> int:
    rem = version << 12
    g = 0b1111100100101
    for i in range(17, 11, -1):
        if (rem >> i) & 1:
            rem ^= g << (i - 12)
    return (version << 12) | rem


def _place_format(m: np.ndarray, bits: int):
    size = m.shape[0]
    seq = [(bits >> i) & 1 for i in range(14, -1, -1)]  # bit 14 first
    # around the top-left finder
    coords_a = (
        [(8, c) for c in range(6)] + [(8, 7), (8, 8), (7, 8)]
        + [(r, 8) for r in range(5, -1, -1)]
    )
    # split copy: right of top-right + below bottom-left
    coords_b = (
        [(r, 8) for r in range(size - 1, size - 8, -1)]
        + [(8, c) for c in range(size - 8, size)]
    )
    for (r, c), b in zip(coords_a, seq):
        m[r, c] = b
    for (r, c), b in zip(coords_b, seq):
        m[r, c] = b


def _place_version(m: np.ndarray, version: int):
    if version < 7:
        return
    size = m.shape[0]
    bits = _version_bits(version)
    for i in range(18):
        b = (bits >> i) & 1
        m[size - 11 + i % 3, i // 3] = b
        m[i // 3, size - 11 + i % 3] = b


def generate_qr(text: str | bytes, level: str = "M",
                version: int | None = None) -> np.ndarray:
    """Encode ``text`` as a QR symbol; returns a (size, size) bool grid
    (True = dark module). Picks the smallest version 1-10 that fits
    unless ``version`` forces one."""
    payload = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    if level not in _LEVEL_BITS:
        raise ValueError(f"EC level must be one of L/M/Q/H, got {level!r}")
    if version is None:
        for v in range(1, 11):
            overhead = 4 + (16 if v >= 10 else 8)
            if len(payload) * 8 + overhead <= _data_capacity(v, level) * 8:
                version = v
                break
        else:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds version-10 "
                f"capacity at level {level}"
            )
    cw = _codewords(payload, version, level)
    base, func = _function_patterns(version)
    coords = _zigzag_coords(base.shape[0], func)
    assert len(coords) >= len(cw) * 8
    bits = []
    for w in cw:
        bits.extend((w >> i) & 1 for i in range(7, -1, -1))
    bits.extend([0] * (len(coords) - len(bits)))  # remainder bits

    best = None
    for mask in range(8):
        m = base.copy()
        for (r, c), b in zip(coords, bits):
            m[r, c] = b ^ (1 if _mask_bit(mask, r, c) else 0)
        _place_format(m, _format_bits(level, mask))
        _place_version(m, version)
        p = _penalty(m)
        if best is None or p < best[0]:
            best = (p, m)
    return best[1].astype(bool)


# ---------------------------------------------------------------------------
# verifier (test oracle): decode the matrix back
# ---------------------------------------------------------------------------


def verify_qr(matrix: np.ndarray) -> bytes:
    """Re-read a generated QR matrix: format BCH, unmask, de-zigzag,
    de-interleave, RS syndrome check, payload parse. Raises on any
    inconsistency; returns the decoded payload bytes."""
    m = np.asarray(matrix).astype(np.uint8)
    size = m.shape[0]
    version = (size - 17) // 4
    if size != 17 + 4 * version or version not in _BLOCKS:
        raise ValueError(f"bad matrix size {size}")
    # read format (copy A), try all (level, mask) and match the BCH word
    seq = [int(m[8, c]) for c in range(6)] + [int(m[8, 7]), int(m[8, 8]),
                                              int(m[7, 8])]
    seq += [int(m[r, 8]) for r in range(5, -1, -1)]
    got = 0
    for b in seq:
        got = (got << 1) | b
    found = None
    for level in _LEVEL_BITS:
        for mask in range(8):
            if _format_bits(level, mask) == got:
                found = (level, mask)
    if found is None:
        raise ValueError("format word fails BCH check")
    level, mask = found

    _, func = _function_patterns(version)
    coords = _zigzag_coords(size, func)
    bits = [
        int(m[r, c]) ^ (1 if _mask_bit(mask, r, c) else 0)
        for (r, c) in coords
    ]
    ec_n, groups = _BLOCKS[version][level]
    n_data = sum(b * c for b, c in groups)
    n_blocks = sum(b for b, _ in groups)
    total = n_data + ec_n * n_blocks
    cw = [
        int("".join(map(str, bits[i * 8: i * 8 + 8])), 2)
        for i in range(total)
    ]
    # de-interleave
    sizes = [c for b, c in groups for _ in range(b)]
    blocks = [[] for _ in sizes]
    it = iter(cw[:n_data])
    for i in range(max(sizes)):
        for j, sz in enumerate(sizes):
            if i < sz:
                blocks[j].append(next(it))
    ecs = [[] for _ in sizes]
    it = iter(cw[n_data:])
    for i in range(ec_n):
        for j in range(n_blocks):
            ecs[j].append(next(it))
    # RS syndromes must vanish
    for blk, ec in zip(blocks, ecs):
        msg = blk + ec
        for i in range(ec_n):
            s = 0
            for c in msg:
                s = _gf_mul(s, int(_EXP[i])) ^ c
            if s != 0:
                raise ValueError("nonzero RS syndrome")
    data = [b for blk in blocks for b in blk]
    stream = 0
    nbits = 0
    for d in data:
        stream = (stream << 8) | d
        nbits += 8

    def take(n):
        nonlocal nbits
        nbits -= n
        return (stream >> nbits) & ((1 << n) - 1)

    mode = take(4)
    if mode != 0b0100:
        raise ValueError(f"expected byte mode, got {mode:04b}")
    count = take(16 if version >= 10 else 8)
    return bytes(take(8) for _ in range(count))
