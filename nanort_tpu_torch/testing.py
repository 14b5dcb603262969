"""Hit-record comparison under the repository's parity rules.

Two traversals agree when they report the same hit mask; the same
``prim_id`` except where both hits sit at exactly equal t (ties resolve
by traversal order, which legally differs between engines); ``t``
within a few ulp; and ``u``/``v`` within an absolute error, since ulp
distance is meaningless near a zero barycentric. Used by the tests (port
against the JAX package) and by ``chip_smoke.py`` (kernel against the
brute-force oracle on the card). Works on NumPy arrays and tensors.

``zero_edge_rays`` makes the axis-aligned case that the zero-edge flags
and the two-pass exact traversals are tested on.

``run_without_fma`` runs a test file's JAX side in a process whose XLA
CPU backend emits no FMA instructions, so the JAX package's kernels in
interpret mode round every product separately, as the port's kernels
(built with ``--fmad=false``) and their plain versions do.

``build_with_cuda_mock`` compiles a CUDA source of ``csrc/`` with g++
against ``CUDA_MOCK``, a small host stand-in for what the sources use of
the CUDA API, so that a test can run a kernel's per-thread functions one
thread at a time on a machine without a card.

``ring_glb`` writes a ``.glb`` of one mesh instanced by TRS nodes, the
glTF input of the loader tests and of ``chip_smoke.py``.

``aov_case`` makes the inputs that the AOV kernel's tests hold it to its
plain version on: degenerate triangles, hits and misses.
``sphere_aov_case`` does the same for the sphere AOV kernel: spheres at
a LiDAR tile's distance, grazing rays, normals at the poles.

``mesh_checks`` is the rank body that the multi-device tests spawn on
each rank of a gloo group (``parallel.dryrun.spawn_ranks``).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np

from .core.options import INVALID_PRIM_ID

T_ULPS = 4
UV_ATOL = 2e-6


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def same_bits(a, b) -> bool:
    """True when two arrays have one dtype, one shape and equal bytes
    (NaN payloads and the sign of zero included)."""
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 ulps (int64; +0 and -0 are 0
    apart, and the count runs through zero across signs)."""
    ia = np.ascontiguousarray(_np(a), np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(_np(b), np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def compare_hits(got, want, t_ulps: int = T_ULPS,
                 uv_atol: float = UV_ATOL) -> dict:
    """Compare two hit records (anything with ``t/u/v/prim_id``).

    Returns counts and maxima with ``ok`` set when: the hit masks are
    equal; prim ids differ only where t is bit-equal; t is within
    ``t_ulps`` on every common hit; u/v are within ``uv_atol`` wherever
    the prim ids agree."""
    gp = _np(got.prim_id).astype(np.int64)
    wp = _np(want.prim_id).astype(np.int64)
    gt, wt = _np(got.t), _np(want.t)
    gh = gp != INVALID_PRIM_ID
    wh = wp != INVALID_PRIM_ID
    both = gh & wh
    same = both & (gp == wp)
    diff = both & (gp != wp)
    ties = diff & (gt == wt)
    t_ulp = int(ulp_distance(gt[both], wt[both]).max(initial=0))
    uv = 0.0
    if same.any():
        uv = float(max(np.abs(_np(got.u)[same] - _np(want.u)[same]).max(),
                       np.abs(_np(got.v)[same] - _np(want.v)[same]).max()))
    r = dict(
        n=int(gh.size), hits=int(gh.sum()),
        hit_mismatch=int((gh != wh).sum()),
        prim_mismatch=int((diff & ~ties).sum()), ties=int(ties.sum()),
        t_max_ulp=t_ulp, uv_max_err=uv,
    )
    r["ok"] = (r["hit_mismatch"] == 0 and r["prim_mismatch"] == 0
               and t_ulp <= t_ulps and uv <= uv_atol)
    return r


def zero_edge_rays(n: int, seed: int = 4):
    """A scene and rays whose edge functions round to 0: the Cornell box
    (axis-aligned quads, each split along a diagonal) and ``n`` rays
    parallel to -z onto its back wall's diagonal, offset from it by less
    than an ulp of the edge products. Returns NumPy ``(vertices, faces,
    org, dir)``; about two in three rays test a triangle with a zero
    edge function, and a few of them change their record under the
    exact-edge recompute."""
    from .io.procedural import make_cornell_box

    v, f = make_cornell_box(2.0)
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    eps = rng.choice(np.asarray([0.0, 1e-9, -1e-9, 3e-8, -3e-8], np.float32),
                     n)
    org = np.stack([a, -a + eps, np.full(n, 0.5, np.float32)], 1)
    d = np.zeros_like(org)
    d[:, 2] = -1.0
    return v, f, org, d


def overlap_soup(n_tris: int, n_rays: int, seed: int = 3):
    """A scene whose traversal stacks run deep: ``n_tris`` large
    triangles scattered over [-1.9, 1.9]^3, overlapping so much that a
    ray hits most child boxes of every node and leaves nearly ``width -
    1`` entries behind a level; and ``n_rays`` rays with origins in
    [-2, 2]^3 and normal directions. Returns NumPy ``(vertices, faces,
    org, dir)``."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n_tris, 1, 3))
    v = (c + rng.uniform(-0.9, 0.9, (n_tris, 3, 3))).reshape(-1, 3)
    f = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    org = rng.uniform(-2.0, 2.0, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (v.astype(np.float32), f, org.astype(np.float32),
            d.astype(np.float32))


MAX_LEAF_SLOTS = 10  # triangles a leaf row holds (build/bvh8.py)


def _leaf_prims(leafs, rows, count, kind: str):
    """The prims of leaf rows ``rows`` holding ``count`` prims of
    ``kind`` (build/bvh8.py's layouts): ``(held, pids, lo, hi)``, held
    (rows, slots) and per slot the prim id and the box its row gives of
    it (a triangle's vertices, a sphere's centre +- radius, a curve's
    control points with p0 +- r0 and p3 +- r1)."""
    slots = 6 if kind == "curve" else MAX_LEAF_SLOTS
    t = np.arange(slots)
    held = t < count[:, None]
    pid_lane = 90 if kind == "triangle" else 108
    pids = leafs[rows[:, None], pid_lane + t]
    if kind == "triangle":
        pts = np.stack([leafs[rows[:, None], 9 * t + j] for j in range(9)],
                       -1).reshape(len(rows), slots, 3, 3)
        return held, pids, pts.min(2), pts.max(2)
    if kind == "sphere":
        q = np.stack([leafs[rows[:, None], 4 * t + j] for j in range(4)], -1)
        return held, pids, q[..., :3] - q[..., 3:], q[..., :3] + q[..., 3:]
    q = np.stack([leafs[rows[:, None], 16 * t + j] for j in range(16)],
                 -1).reshape(len(rows), slots, 4, 4)
    p, r = q[..., :3], q[..., 3:]
    ends, r_ends = p[..., ::3, :], r[..., ::3, :]  # p0 r0, p3 r1
    pts = np.concatenate([p, ends - r_ends, ends + r_ends], 2)
    return held, pids, pts.min(2), pts.max(2)


def wide_table_report(scene, n_prims: int) -> dict:
    """Structural checks of BVH8/BVH16 tables (host NumPy, vectorized),
    walked level by level from root row 0: ``prims_once`` (every prim id
    in exactly one reachable leaf slot), ``enclosed`` (each child node's
    slot boxes inside its parent's slot box, and each leaf prim inside its
    slot box: a triangle's vertices, a sphere's box, a curve's control
    points and its end points' radii; exact comparisons), ``acyclic`` (no row
    reached twice), ``leaf_rows_once``, ``pad_rows_empty`` (every slot
    box of a row past ``num_nodes`` inverted) and ``depth_ok`` (the
    levels walked equal ``scene.depth``), with ``ok`` when all hold."""
    nodes, leafs = _np(scene.nodes), _np(scene.leafs)
    W = scene.width
    box0 = (6 if W == 16 else 8) * np.arange(W)
    meta_lane, cnt_lane = (96, 112) if W == 16 else (64, 72)
    lo = np.stack([nodes[:, box0 + k] for k in range(3)], -1)  # (N, W, 3)
    hi = np.stack([nodes[:, box0 + 3 + k] for k in range(3)], -1)
    live = lo[..., 0] <= hi[..., 0]
    meta = nodes[:, meta_lane + np.arange(W)].astype(np.int64)
    cnt = nodes[:, cnt_lane + np.arange(W)].astype(np.int64)
    if W == 16:
        cnt &= 15  # child 0's count lane also carries 16 * axis
    frontier = np.zeros(1, np.int64)
    seen = [frontier]
    enclosed, levels, leaf_slots = True, 0, []
    while frontier.size and levels <= nodes.shape[0]:  # a cycle stops
        levels += 1
        p, s = np.nonzero(live[frontier])
        p = frontier[p]
        internal = meta[p, s] >= 0
        kids = meta[p, s][internal]
        kp, ks = p[internal], s[internal]
        # a child's live slot boxes lie inside the parent's slot box
        kl = live[kids]
        big = np.float32(3.0e38)
        klo = np.where(kl[..., None], lo[kids], big).min(1)
        khi = np.where(kl[..., None], hi[kids], -big).max(1)
        enclosed &= bool((klo >= lo[kp, ks]).all() and
                         (khi <= hi[kp, ks]).all())
        leaf_slots.append((p[~internal], s[~internal]))
        frontier = kids
        seen.append(kids)
    seen = np.concatenate(seen)
    lp = np.concatenate([x[0] for x in leaf_slots])
    ls = np.concatenate([x[1] for x in leaf_slots])
    rows = -meta[lp, ls] - 1
    count = cnt[lp, ls]
    held, pids, plo, phi = _leaf_prims(
        leafs, rows, count, getattr(scene, "leaf_kind", "triangle"))
    pids = pids[held].astype(np.int64)
    vmin = np.where(held[..., None], plo, np.inf)
    vmax = np.where(held[..., None], phi, -np.inf)
    enclosed &= bool((vmin >= lo[lp, ls][:, None]).all()
                     and (vmax <= hi[lp, ls][:, None]).all())
    r = dict(
        nodes_reached=int(seen.size), leaf_slots=int(rows.size),
        levels=levels,
        prims_once=bool(np.array_equal(np.sort(pids),
                                       np.arange(n_prims))),
        enclosed=enclosed,
        acyclic=bool(np.unique(seen).size == seen.size),
        leaf_rows_once=bool(np.unique(rows).size == rows.size
                            and rows.size == scene.num_leaf_rows),
        pad_rows_empty=bool(not live[scene.num_nodes:].any()),
        depth_ok=levels == scene.depth,
    )
    r["ok"] = all(v for k, v in r.items() if isinstance(v, bool))
    return r


def run_without_fma(script: str, inputs: dict, timeout: float = 600.0) -> dict:
    """Run ``python script IN OUT`` and return the arrays it saved.

    ``inputs`` (name -> array) are saved to the npz ``IN``; the script
    writes its results to the npz ``OUT``. The child's XLA CPU backend
    is held to AVX (``--xla_cpu_max_isa=AVX``), which has no FMA: jitted
    XLA on an FMA machine otherwise contracts ``a * b + c``, and a
    kernel run in interpret mode then differs from the same kernel with
    separately rounded products in the last ulp."""
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(inp, **inputs)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_cpu_max_isa=AVX").strip()
        r = subprocess.run([sys.executable, script, inp, out], env=env,
                           capture_output=True, text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(f"{script} failed:\n{r.stdout[-2000:]}"
                               f"{r.stderr[-6000:]}")
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


# What the kernel sources use of the CUDA API, for one thread at a time:
# warp operations see a warp of one active lane, atomics run in order.
CUDA_MOCK = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct longlong2 { long long x, y; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
extern uint3 threadIdx, blockIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9
};
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes, sharedSizeBytes; };
template <class T> T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline int __all_sync(unsigned, int p) { return p; }
template <class T> unsigned __match_any_sync(unsigned, T) { return 1u; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
struct cuda_mock_trap {};  // __trap() ends the launch: a harness catches it
[[noreturn]] inline void __trap() { throw cuda_mock_trap{}; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T> T atomicOr(T* p, T v) { const T o = *p; *p |= v; return o; }
template <class T> T atomicAdd(T* p, T v) { const T o = *p; *p += v; return o; }
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_up_sync(unsigned, T v, unsigned) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) { return 0; }
template <class T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, T) { return 0; }
template <class T>
cudaError_t cudaFuncSetAttribute(T, int, int) { return 0; }
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T, int, size_t) {
  return 0;
}
"""


def build_with_cuda_mock(source: str, harness: str, directory) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` followed by ``harness`` (C++ that calls
    the kernel's functions and exports a C interface) with g++ against
    ``CUDA_MOCK`` in ``directory``, and load it. Launches (``<<<...>>>``)
    become plain calls, which a harness never makes. g++ builds with
    -ffp-contract=off and no -ffast-math, as nvcc builds with
    --fmad=false: every product rounded on its own, IEEE division and
    square root."""
    from .traverse._ext import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    directory = str(directory)
    with open(os.path.join(CSRC, source)) as fh:
        src = re.sub(r"<<<.*?>>>", "", fh.read(), flags=re.S)
    with open(os.path.join(directory, "cuda_runtime.h"), "w") as fh:
        fh.write(CUDA_MOCK)
    cpp = os.path.join(directory, os.path.splitext(source)[0] + ".cpp")
    with open(cpp, "w") as fh:
        fh.write(src + harness)
    so = os.path.splitext(cpp)[0] + ".so"
    r = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-shared", "-fPIC", "-w",
                        f"-I{directory}", f"-I{CSRC}", "-o", so, cpp],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ build of {source} failed:\n{r.stderr[-6000:]}")
    return ctypes.CDLL(so)


def aov_case(bs, seed: int, face_dtype=np.int64, facevarying=False,
             dtype="float32", device="cpu"):
    """``(mesh, attrs, rays, hits)`` for ``objrender.aovs_from_hits`` over
    the batch shape ``bs``. The mesh: config A's box and sphere, then a
    zero-area triangle (three equal corners), a collinear one, one whose
    normal's length (1e-20) falls under normalize's 1e-17 guard and one
    whose (1e-16) does not. Random rays; a third of the records miss (t =
    the largest float, as ``no_hits`` starts them), a tenth name the four
    degenerate faces. ``facevarying``: random normals (F, 3, 3), one
    face's all zero, in ``attrs``; else ``attrs`` is None."""
    import torch

    from .core.ray import Hits, make_rays
    from .io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
    from .models.objrender import MeshAttributes
    from .ops.triangle import TriangleMesh

    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    extra = np.array([[0.1, 0.2, 0.3]] * 3
                     + [[0, 0, 0], [1, 1, 1], [2, 2, 2]]
                     + [[0, 0, 0], [1e-10, 0, 0], [0, 1e-10, 0]]
                     + [[0, 0, 0], [1e-8, 0, 0], [0, 1e-8, 0]], np.float32)
    f = np.concatenate([f, np.arange(len(v), len(v) + len(extra)).reshape(
        -1, 3)]).astype(face_dtype)
    v = np.concatenate([v, extra]).astype(np.float32)
    F = len(f)
    rng = np.random.default_rng(seed)
    n = int(np.prod(bs))
    prim = rng.integers(0, F, n)
    prim[rng.random(n) < 0.1] = F - 1 - rng.integers(0, 4)
    miss = rng.random(n) < 0.3
    prim[miss] = INVALID_PRIM_ID
    t = rng.uniform(0.1, 10.0, n).astype(np.float32)
    t[miss] = np.finfo(np.float32).max
    u = rng.uniform(0, 1, n).astype(np.float32)
    w = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    org = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    dt = getattr(torch, dtype)

    def on(x, *s):
        return torch.from_numpy(x).reshape(tuple(bs) + s).to(device, dt)

    attrs = None
    if facevarying:
        fn = rng.normal(size=(F, 3, 3))
        fn[F - 2] = 0.0
        attrs = MeshAttributes(normals=torch.from_numpy(fn).to(device, dt))
    mesh = TriangleMesh(torch.from_numpy(v).to(device, dt),
                        torch.from_numpy(f).to(device))
    hits = Hits(on(t), on(u), on(w),
                torch.from_numpy(prim).reshape(tuple(bs)).to(device))
    return mesh, attrs, make_rays(on(org, 3), on(d, 3)), hits


# sphere_aov_case's spheres: the LiDAR tile's radius and distance
SPHERE_RADIUS = 0.33
SPHERE_DIST = 740.0
# its pole normals' y: lengths that underflow to 0 (the 1e-30 guard, then
# the clamp of n.y to [-1, 1]), that are subnormal (no -ftz), and ordinary
POLE_Y = (0.33, -0.33, 1.0, 1e-20, -1e-20, 3.7e-19, 1e-25, -1e-25, 0.0)


def sphere_aov_case(bs, seed: int, device="cpu", dtype="float32"):
    """``(spheres, rays, hits)`` for ``models.pointcloud``'s sphere AOVs
    over the batch shape ``bs``: 48 spheres of 0.33 m about 740 m down the
    z axis (a LiDAR tile's sizes), half of them within 0.25 m of the other
    half, so that they overlap; rays from the origin aimed within 1.6
    radii of a sphere's centre, a third of them at its silhouette (1 +-
    1e-4 radii out: grazing rays); each record the nearest hit by brute
    force with K1's test (``ops.sphere.sphere_hit``), a miss the miss id
    and the largest float. The last sphere, centred at the origin, takes
    the pole cases: a ray from (0, y, 0) with t = 0, so that n = (0, y,
    0), for each y of ``POLE_Y``, and one from (-0, 0, -0), as many as
    half the batch holds. Every record, hit or miss, carries a random u
    and v (a miss keeps them)."""
    import torch

    from .core.ray import Hits, make_rays
    from .ops.sphere import Spheres, sphere_hit

    rng = np.random.default_rng(seed)
    n = int(np.prod(bs))
    k = 48
    c = np.stack([rng.uniform(-6.0, 6.0, k), rng.uniform(-3.0, 3.0, k),
                  SPHERE_DIST + rng.uniform(-1.5, 1.5, k)], 1)
    c[k // 2:] = c[:k // 2] + rng.uniform(-0.25, 0.25, (k // 2, 3))
    off = rng.normal(size=(n, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    scale = rng.uniform(0.0, 1.6, n)
    graze = rng.random(n) < 0.33
    scale[graze] = 1.0 + rng.choice([-1e-4, 1e-4], int(graze.sum()))
    target = c[rng.integers(0, k, n)] + SPHERE_RADIUS * scale[:, None] * off
    dirs = torch.from_numpy((target / np.linalg.norm(
        target, axis=1, keepdims=True)).astype(np.float32))
    centers = torch.from_numpy(c.astype(np.float32))
    org = torch.zeros(n, 3)
    big = float(np.finfo(np.float32).max)
    valid, t = sphere_hit(org[:, None], dirs[:, None], centers[None],
                          torch.full((1, k), SPHERE_RADIUS),
                          torch.zeros(n, 1), torch.full((n, 1), big))
    t, prim = torch.where(valid, t, float("inf")).min(dim=1)
    hit = torch.isfinite(t)
    t = torch.where(hit, t, big)
    prim = torch.where(hit, prim, INVALID_PRIM_ID)
    poles = [(0.0, y, 0.0) for y in POLE_Y] + [(-0.0, 0.0, -0.0)]
    at = rng.choice(n, min(len(poles), n // 2), replace=False)
    for i, o in zip(at, poles):
        org[i] = torch.tensor(o)
        t[i], prim[i] = 0.0, k
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    dt = getattr(torch, dtype)

    def on(x, *tail):
        x = torch.as_tensor(x)
        return x.reshape(tuple(bs) + tail).to(device, dt)

    s = Spheres(torch.cat([centers, torch.zeros(1, 3)]).to(device, dt),
                torch.full((k + 1,), SPHERE_RADIUS).to(device, dt))
    hits = Hits(on(t), on(u), on(v), prim.reshape(tuple(bs)).to(device))
    return s, make_rays(on(org, 3), on(dirs, 3)), hits


def ring_glb(path, v, f, xfs):
    """A glTF of one mesh buffer (float32 positions, uint32 indices)
    instanced by one TRS node per ``(translation, axis, angle)`` of
    ``xfs``, written to ``path`` as a ``.glb``."""
    pos, idx = v.astype(np.float32).tobytes(), f.astype(np.uint32).tobytes()
    nodes = []
    for k, (t, axis, ang) in enumerate(xfs):
        a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        q = list(a * math.sin(0.5 * ang)) + [math.cos(0.5 * ang)]  # x y z w
        nodes.append({"mesh": 0, "name": f"ring{k}",
                      "translation": [float(c) for c in t],
                      "rotation": [float(c) for c in q]})
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(pos) + len(idx)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
            {"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": f.size,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "nodes": nodes,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "scene": 0,
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    buf = pos + idx
    buf += b"\0" * (-len(buf) % 4)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2,
                             12 + 8 + len(js) + 8 + len(buf)))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        fh.write(struct.pack("<II", len(buf), 0x004E4942) + buf)


def mesh_checks(mesh, inputs: dict) -> dict:
    """The rank body of the multi-device tests (``parallel.dryrun.
    spawn_ranks("nanort_tpu_torch.testing:mesh_checks", n, inputs)``):
    the mesh engines, the render step and, when the mesh has one rank a
    chunk, the chunk rings, on the state the test passes in. Returns the
    whole batch's records (the same on every rank) and the statistics.

    ``inputs``: the mesh ``v``/``f``, its BVH's six fields ``bvh_*``, the
    rays ``org``/``dir``/``min_t``/``max_t``, the JAX draws of an
    ``n``-rank mesh ``draws<n>``, and the fields of two JAX
    ``ShardedScene``s with both table sets, ``sc_*`` (leaves of at most 4
    triangles) and ``wide_*`` (at most 8)."""
    from .core.bvh import BVH
    from .core.ray import Rays
    from .interop import (bvh_from_numpy, rays_from_numpy,
                          sharded_scene_from_numpy)
    from .ops.triangle import TriangleMesh
    from .parallel import mesh as pm
    from .parallel.sharded_scene import sharded_scene_traverse
    from .traverse.packed import pack_scene

    z = inputs
    bvh = bvh_from_numpy(*(z[f"bvh_{k}"] for k in BVH._fields))
    geom = TriangleMesh(z["v"], z["f"])
    rays = rays_from_numpy(z["org"], z["dir"], z["min_t"], z["max_t"],
                           device=mesh.device)
    out = {}

    def put(name, hits, n_hit=None):
        for k, x in zip(("t", "u", "v", "prim_id"), hits):
            out[f"{name}_{k}"] = x.cpu().numpy()
        if n_hit is not None:
            out[f"{name}_n"] = np.int64(int(n_hit))

    put("stack", *pm.sharded_traverse_triangles(bvh, geom, rays, mesh))
    put("wavefront", *pm.sharded_traverse_wavefront(
        pack_scene(bvh, z["v"], z["f"]), rays, mesh, tile=64))
    ao, n_hit, mean_ao = pm.sharded_render_step(
        bvh, geom, rays, mesh, draws=z[f"draws{mesh.size}"])
    out.update(ao=ao.cpu().numpy(), ao_n=np.int64(int(n_hit)),
               ao_mean=np.float32(float(mean_ao)))
    _, _, seeded = pm.sharded_render_step(bvh, geom, rays, mesh, seed=5)
    out["seeded_mean"] = np.float32(float(seeded))
    scenes = {p: sharded_scene_from_numpy(
        *(z[f"{p}_{k}"] for k in ("nodes", "soups", "perms", "num_nodes",
                                  "num_chunks", "nodes8", "leafs8", "depth8",
                                  "max_leaf8"))) for p in ("sc", "wide")}
    if mesh.size == scenes["sc"].num_chunks:
        for p, sc in scenes.items():
            put(f"{p}_ring", sharded_scene_traverse(sc, rays, mesh, tile=64))
            put(f"{p}_packet", sharded_scene_traverse(sc, rays, mesh,
                                                      engine="packet"))
    if mesh.size > 1:
        cut = Rays(*(x[:-1] for x in rays))
        try:
            pm.sharded_traverse_triangles(bvh, geom, cut, mesh)
        except ValueError:
            out["indivisible_raises"] = np.int64(1)
    return out
