"""ctypes bridge to the native C++ SAH builder.

A copy of ``nanort_tpu.build.native`` that compiles the port's own copy
of the builder, ``nanort_tpu_torch/csrc/sah_builder.cc``, with the same
g++ flags into the port's build directory (``nanort_tpu_torch/_build/``,
keyed by a hash of source and flags), so both packages build
bit-identical trees. The BVH build is host-side,
once-per-scene work where the reference uses multithreaded C++
(nanort.h:1997-2073); the NumPy builder is correct but ~0.03 Mtris/s.
When no toolchain is available the builder falls back to the NumPy path
(and says so on stderr); ``native_available()`` tells a caller which
one will run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import time

import numpy as np

from .._toolchain import build_shared_library
from ..core.bvh import BVH
from ..core.options import BVHBuildOptions, BVHBuildStatistics

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "sah_builder.cc")
_CMD = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread"]

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compile() -> str | None:
    try:
        return build_shared_library("libsah", [os.path.normpath(_SRC)], _CMD,
                                    timeout=240)
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"[nanort_tpu_torch] native build unavailable: {e}\n")
        return None


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _compile()
        if path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.nanort_tpu_build_sah.restype = ctypes.c_int
        lib.nanort_tpu_build_sah.argtypes = [
            f32p, f32p, f32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, u32p, u32p, i64p, i64p,
        ]
        lib.nanort_tpu_triangle_bounds.restype = None
        lib.nanort_tpu_triangle_bounds.argtypes = [
            f32p, i32p, ctypes.c_int64, f32p, f32p, f32p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def triangle_bounds_native(vertices: np.ndarray, faces: np.ndarray):
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    n = f.shape[0]
    bmin = np.empty((n, 3), np.float32)
    bmax = np.empty((n, 3), np.float32)
    ctr = np.empty((n, 3), np.float32)
    lib.nanort_tpu_triangle_bounds(v, f, n, bmin, bmax, ctr)
    return bmin, bmax, ctr


def build_sah_native(
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
    prim_centers: np.ndarray | None = None,
    options: BVHBuildOptions = BVHBuildOptions(),
    n_threads: int = 0,
) -> tuple[BVH, BVHBuildStatistics]:
    """Native binned-SAH build; same contract as build.sah.build_sah."""
    lib = _load()
    if lib is None:
        from .sah import build_sah

        return build_sah(prim_bmin, prim_bmax, prim_centers, options)

    t0 = time.perf_counter()
    bmin = np.ascontiguousarray(prim_bmin, np.float32)
    bmax = np.ascontiguousarray(prim_bmax, np.float32)
    if prim_centers is None:
        prim_centers = 0.5 * (bmin + bmax)
    ctr = np.ascontiguousarray(prim_centers, np.float32)
    n = bmin.shape[0]
    if n == 0:
        raise ValueError("no primitives (reference Build returns false, nanort.h:1907)")

    cap = max(2 * n, 16)
    nb_lo = np.empty((cap, 3), np.float32)
    nb_hi = np.empty((cap, 3), np.float32)
    flag = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    data = np.empty((cap, 2), np.uint32)
    indices = np.empty(n, np.uint32)
    out_nn = np.zeros(1, np.int64)
    out_st = np.zeros(3, np.int64)

    rc = lib.nanort_tpu_build_sah(
        bmin, bmax, ctr, n,
        options.min_leaf_primitives, options.max_leaf_primitives,
        options.max_tree_depth, options.bin_size, options.shallow_depth + 2,
        n_threads,
        nb_lo.reshape(-1), nb_hi.reshape(-1), flag, axis, data.reshape(-1),
        indices, out_nn, out_st,
    )
    if rc != 0:
        raise RuntimeError(f"native SAH build failed (rc={rc})")
    nn = int(out_nn[0])
    st = BVHBuildStatistics(
        max_tree_depth=int(out_st[0]),
        num_leaf_nodes=int(out_st[1]),
        num_branch_nodes=int(out_st[2]),
        build_secs=time.perf_counter() - t0,
    )
    bvh = BVH(
        bmin=nb_lo[:nn].copy(),
        bmax=nb_hi[:nn].copy(),
        flag=flag[:nn].copy(),
        axis=axis[:nn].copy(),
        data=data[:nn].copy(),
        indices=indices,
    )
    return bvh, st
