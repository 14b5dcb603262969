"""Build and load the CUDA traversal kernel (``csrc/packet_traverse.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, bound with ``ctypes`` (no PyTorch headers: the
build takes seconds, not minutes). The build happens at first use, into
``nanort_tpu_torch/_build/``, keyed by a hash of source and flags.
``--fmad=false`` keeps every product separately rounded, as the plain
torch version computes it (see the note at the top of the source).
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from .._toolchain import build_shared_library

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc",
    "packet_traverse.cu"))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``. Raises ``RuntimeError`` when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA traversal kernel is "
        "built from csrc/packet_traverse.cu at first use")


def load():
    """The loaded kernel library, building it on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_shared_library(
                "packet_traverse", [SOURCE], [find_nvcc()] + NVCC_FLAGS)
            lib = ctypes.CDLL(path)
            fn = lib.nrt_packet_traverse
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int64]
                + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            )
            _lib = lib
    return _lib
