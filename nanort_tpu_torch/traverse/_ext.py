"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). The build happens at first
use, into ``nanort_tpu_torch/_build/``, keyed by a hash of flags, source
and the headers it includes. ``--fmad=false`` keeps every product
separately rounded, as the plain torch versions compute them (see the
note at the top of each source). Nothing is built or loaded when this
module is imported. Every launch and occupancy query goes through
``launch`` and ``occupancy`` below: they pass tensors as pointers, enter
the device and append its current stream, so a kernel never runs on
another stream than the torch ops around it.

    packet_traverse.cu  K1 (with its modes), K1-woop and K1b,
                        traverse/packet.py::traverse_bvh8
    bvh16_trace.cu      K2 on its own, traverse/fused_trace.py::trace_bvh16
    pt_fused.cu         K3 and K4 (K4 runs K2), models/pt_fused.py
    ao_fused.cu         K5 (runs K2 watertight), models/ao_fused.py
    aovs.cu             objrender's AOVs from primary-hit records,
                        models/objrender.py::aovs_from_hits
    camera.cu           the perspective camera's rays,
                        models/cameras.py::pinhole_rays
    sphere_aovs.cu      the sphere frame's AOVs from primary-hit records,
                        models/pointcloud.py::render_sphere_aovs
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from .._toolchain import BUILD_DIR, build_shared_library
from ..utils import trace

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
        "nrt_packet_traverse": [_P] * 14 + [_L] * 2 + [_I] * 14 + [_P],
        "nrt_packet_traverse_occupancy": [_I] * 6 + [_P],
    }),
    "bvh16_trace": ("bvh16_trace.cu", ("bvh16_trace.cuh",), {
        "nrt_bvh16_trace": [_P] * 16 + [_L] + [_I] * 4 + [_P],
    }),
    "pt_fused": ("pt_fused.cu", ("bvh16_trace.cuh",), {
        "nrt_pt_fused_brute": ([_P, _I, _P, _I, _P, _I, _F, _P, _P, _P, _P,
                                _L] + [_I] * 7 + [_P]),
        "nrt_pt_fused_brute_occupancy": [_P],
        "nrt_pt_fused_bvh_pool": ([_P, _I, _P, _I, _F, _P, _P, _P, _P, _P,
                                   _P, _P, _L] + [_I] * 10
                                  + [_P, _P, _P]),
        "nrt_pt_fused_bvh_occupancy": [_P],
    }),
    "ao_fused": ("ao_fused.cu", ("bvh16_trace.cuh",), {
        "nrt_ao_fused": [_P] * 16 + [_L, _I, _F, _F, _I, _I, _P],
        "nrt_ao_fused_occupancy": [_P],
    }),
    "aovs": ("aovs.cu", (), {
        "nrt_aovs": [_P] * 7 + [_I] + [_P] * 8 + [_L, _L, _L, _P],
    }),
    "camera": ("camera.cu", (), {
        "nrt_pinhole": [_P] * 8 + [_L, _L, _F, _F, _F, _P],
    }),
    "sphere_aovs": ("sphere_aovs.cu", (), {
        "nrt_sphere_aovs": [_P] * 13 + [_L, _L, _P],
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


_SCALARS = frozenset((int, float, bool))


def launch(name: str, fn: str, *args, device, count) -> None:
    """Launch the C function ``fn`` of library ``name`` on ``device``'s
    current stream: a tensor passes as its data pointer, ``None`` as a
    null pointer, ints and floats as they are (``KERNELS`` declares each
    argument), and the stream is appended as the last argument. Raises
    ``RuntimeError`` on a non-zero return (``cudaGetLastError()``), else
    adds one to each launch counter in ``count`` (a key or a tuple of
    keys)."""
    lib = _libs.get(name) or load(name)
    # numbers first: isinstance(n, torch.Tensor) on a number costs more
    # than the launch's own pointer conversions used to
    args = [a if a is None or a.__class__ in _SCALARS
            else a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    if count.__class__ is str:
        trace.count(count)
    else:
        for key in count:
            trace.count(key)


_OCCUPANCY: dict = {}


def occupancy(name: str, fn: str, fields, *args, device=None) -> dict:
    """What the card's occupancy API and a compiled kernel say of it: the
    C function ``fn`` of library ``name``, given the leading ``args``
    (ints), fills one int per name in ``fields``; the card's ``sms`` is
    added. Cached per function, arguments and device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (fn, args, dev.index)
    occ = _OCCUPANCY.get(key)
    if occ is None:
        out = (ctypes.c_int * len(fields))()
        with torch.cuda.device(dev):
            rc = getattr(load(name), fn)(*args, out)
        if rc != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {rc}")
        occ = dict(zip(fields, out))
        occ["sms"] = torch.cuda.get_device_properties(
            dev).multi_processor_count
        _OCCUPANCY[key] = occ
    return occ


def resident_grid(n: int, blocks_per_sm: int, sms: int, threads: int) -> int:
    """A persistent kernel's grid for ``n`` items, one a thread at a time:
    the blocks that stay resident (``blocks_per_sm`` from the occupancy
    API, times ``sms``), or fewer when the items would not give every
    thread of that grid one."""
    if blocks_per_sm < 1:
        raise ValueError(f"the kernel does not fit an SM: {blocks_per_sm} "
                         "blocks")
    return max(1, min(blocks_per_sm * sms, -(-n // threads)))


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
