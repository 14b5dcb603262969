"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). The build happens at first
use, into ``nanort_tpu_torch/_build/``, keyed by a hash of flags, source
and the headers it includes. ``--fmad=false`` keeps every product
separately rounded, as the plain torch versions compute them (see the
note at the top of each source). Nothing is built or imported when this
module is imported.

    packet_traverse.cu  K1 (with its modes), K1-woop and K1b,
                        traverse/packet.py::traverse_bvh8
    bvh16_trace.cu      K2 on its own, traverse/fused_trace.py::trace_bvh16
    pt_fused.cu         K3 and K4, pooled and lane schedules (K4 runs K2),
                        models/pt_fused.py
    ao_fused.cu         K5 (runs K2 watertight), models/ao_fused.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

from .._toolchain import BUILD_DIR, build_shared_library

CSRC = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc"))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# library -> (source, included headers, {C function: argtypes}); every
# function returns cudaGetLastError() as an int
KERNELS = {
    "packet_traverse": ("packet_traverse.cu", (), {
        "nrt_packet_traverse": [_P] * 14 + [_L] * 2 + [_I] * 12 + [_P],
    }),
    "bvh16_trace": ("bvh16_trace.cu", ("bvh16_trace.cuh",), {
        "nrt_bvh16_trace": [_P] * 16 + [_L] + [_I] * 4 + [_P],
    }),
    "pt_fused": ("pt_fused.cu", ("bvh16_trace.cuh",), {
        "nrt_pt_fused_brute": ([_P, _I, _P, _I, _P, _I, _F, _P, _P, _P, _L]
                               + [_I] * 6 + [_P]),
        "nrt_pt_fused_bvh_lane": ([_P, _I, _P, _I, _F, _P, _P, _P, _P, _P,
                                   _P, _P, _L] + [_I] * 8 + [_P]),
        "nrt_pt_fused_bvh_pool": ([_P, _I, _P, _I, _F, _P, _P, _P, _P, _P,
                                   _P, _P, _L] + [_I] * 10
                                  + [_P, _P, _P]),
        "nrt_pt_fused_bvh_occupancy": [_P],
    }),
    "ao_fused": ("ao_fused.cu", ("bvh16_trace.cuh",), {
        "nrt_ao_fused": [_P] * 15 + [_L, _I, _F, _F, _I, _P],
    }),
}

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``. Raises ``RuntimeError`` when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "nanort_tpu_torch/csrc/ at first use")


def _build(name: str) -> str:
    src, deps, _ = KERNELS[name]
    return build_shared_library(
        name, [os.path.join(CSRC, src)], [find_nvcc()] + NVCC_FLAGS,
        deps=tuple(os.path.join(CSRC, d) for d in deps))


def _bind(name: str, path: str):
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in KERNELS[name][2].items():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def load(name: str):
    """The loaded library ``name`` (a key of ``KERNELS``), building it on
    first call."""
    with _lock:
        if name not in _libs:
            _libs[name] = _bind(name, _build(name))
        return _libs[name]


def load_all() -> dict:
    """Build every library at once, one ``nvcc`` per source started
    together, and load them. Returns ``{name: seconds to build or find}``.
    Raises the first build error."""
    import time

    def timed(name):
        t0 = time.perf_counter()
        path = _build(name)
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        futs = {n: ex.submit(timed, n) for n in KERNELS}
        done = {n: f.result() for n, f in futs.items()}
    with _lock:
        for n, (path, _) in done.items():
            if n not in _libs:
                _libs[n] = _bind(n, path)
    return {n: s for n, (_, s) in done.items()}


def resource_usage(name: str) -> str:
    """What ``ptxas -v`` reports for library ``name``'s kernels (registers,
    spill stores and loads, stack frame), compiled with the same flags
    into a throwaway cubin under ``_build/``."""
    src = KERNELS[name][0]
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        r = subprocess.run(
            [find_nvcc()] + flags + ["-Xptxas", "-v", "-cubin", "-o",
                                     os.path.join(d, "k.cubin"),
                                     os.path.join(CSRC, src)],
            capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"ptxas report for {name} failed:\n{r.stderr}")
    return r.stderr + r.stdout
