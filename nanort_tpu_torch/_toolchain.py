"""Compile-once helper for the port's native libraries.

Every shared library the port loads (the g++ SAH builder, the nvcc
traversal kernel) is built at first use from sources in the checkout
into ``nanort_tpu_torch/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the compiler command and every source byte, so a
changed source or flag builds anew and a fresh checkout builds
everything. Concurrent builders (pytest-xdist workers) each compile to a
private temporary name and publish with an atomic rename.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_shared_library(name: str, sources: list[str], cmd: list[str],
                         timeout: float = 600.0) -> str:
    """Return the path of ``name``'s library built by ``cmd + sources +
    ["-o", out]``, compiling only when no library with the same hash
    exists. Raises ``RuntimeError`` with the compiler's output when the
    build fails, ``FileNotFoundError`` when the compiler is missing."""
    h = hashlib.sha256("\0".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(cmd + sources + ["-o", tmp], capture_output=True,
                           text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
