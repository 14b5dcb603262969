#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a),
``nvcc`` and ``g++``; builds every kernel from this checkout and imports
nothing of JAX. Phases, one line or more each:

1. the card (``nvidia-smi`` name and power limit);
2. the builds: the four CUDA sources (one nvcc each, started together)
   and the native SAH builder (g++), with their seconds (and, beside
   them, a ``ptxas -v`` report of K5 and K2, printed in phase 14);
3. small-scene parity: cornell box + UV sphere, 3,000 seeded rays, the
   kernel at widths 16 and 8 against the brute-force oracle on the card,
   for closest-hit, skip_prim_id, cull_back_face, prim_ids_range,
   any-hit and degenerate rays;
4. the main-path scene: a ~1M-triangle subdivided sphere, native SAH
   build with leaf size 9, BVH16 collapse;
5. kernel against its plain torch version on the card at full scene
   size: 65,536 tiled camera rays + 65,536 seeded incoherent rays, which
   must agree bit for bit;
6. the main path: look_at at 8192^2 (67M rays, the bench.py frame),
   tile_image_rays(128, 64), detect_specialization, traverse_bvh8 — one
   warm-up and 3 timed repetitions with CUDA events; the hit fraction is
   held to the analytic disc coverage, and 1,024 sampled pixels to the
   brute-force oracle;
7. K2, K3 and K4 against their plain torch versions on the card:
   K2 (``trace_bvh16``) on the 99,236-triangle dense Cornell scene with
   65,536 seeded incoherent rays, closest-hit with aux rows and
   occlusion, and 1,024 of them against a brute-force Moller-Trumbore
   sweep; K3 (``render_fused``) on the 32-triangle Cornell box and K4
   (``render_fused_bvh``, spp_lanes 1 and 4; its pooled kernel and its
   lane kernel, ``_schedule="lane"``) on the dense scene, each at 4,096
   rays x 4 spp x 10 bounces; K4 against K3 on the Cornell box with
   BVH16 tables attached. ``trig="poly"`` must agree bit for bit,
   ``"native"`` to 99% of pixels; ``ptxas -v`` of K3 and K4's two
   kernels, and their resident blocks per SM; K4's two kernels in turns
   at 16,384 to 1,048,576 paths (4,096 rays x 4 to 256 spp);
8. config B: ``render_path_traced`` on the Cornell box at 512^2 x 100
   spp x 10 bounces (K3), one warm-up and 3 timed repetitions;
9. midscale: the same on the dense scene (K4's pooled kernel on K2, 25
   sample-major lanes, 4 azimuth strata, 32 x 128 pixel tiles), with the
   pool's waves and regenerations; then the lane and pooled kernels in
   turns (lane, pooled, pooled, lane) on the same render, whose images
   must be equal bit for bit, one more pooled render in two launches of
   2 sample iterations each (equal bit for bit), both kernels' lane sums
   with ``trig="poly"`` (equal bit for bit) and 4,096 sampled lanes of
   them against the plain version (``lane_ids=``), bit for bit;
10. K1-woop against its plain version on the card: the dense scene built
    with ``engine="turbo"`` (leaf 9, Woop table) and phase 7's 65,536
    incoherent rays, closest-hit and any-hit, which must agree bit for
    bit; then woop against watertight on the same rays (hit-mask and prim
    agreement, kernel ms and their ratio);
11. the megabatch route at full width: ``render_path_traced(...,
    fused=False)`` on the midscale scene at 512^2 x 100 spp x 10 bounces,
    ``engine="turbo"`` then ``"pallas"``, one warm-up and 3 timed
    renders each; 80 K1 launches a render (4 megabatches of 6,553,600
    rays x 10 bounces x closest + shadow) and no other kernel; the image
    mean within 2% of phase 9's; for each engine, one more render keeps
    the kernel's input and records of bounce 2 of the first megabatch
    (the closest-hit and the shadow trace: 6,553,600 sorted rays each,
    the dead ones at the tail; bounce 2 is the first whose closest-hit
    trace holds ended paths), which must agree bit for bit with the
    plain version on the same tensors; then one more turbo render split into
    its layers (trace kernel, sort and unsort, shading) with CUDA events;
12. the two megabatch engines without a kernel: the wavefront walk on the
    midscale scene at 512^2 x 4 spp, and brute force on the Cornell box
    at 512^2 x 16 spp;
13. config A on the K1 route: ``render_ao`` at 512^2 x 8 AO samples on
    the Cornell box + UV sphere (16,138 triangles, leaf 8, BVH16), one
    warm-up and 3 renders timed with CUDA events; 2 K1 launches a render
    and no other kernel; both traces of one render (the 262,144 tiled
    primary rays and the 2,097,152 tile-ordered occlusion rays, skipping
    the hit prim, dead where the pixel missed) held to the plain version
    on the same tensors, bit for bit;
14. K2's watertight test with and without a per-ray skip on phase 7's
    rays against its plain version and 1,024 of them against brute
    force, then K5: ``render_ao_fused`` on phase 13's scene, rays and
    draws (1 launch a render, a warm-up and 3 timed), the kernel against
    its plain version on the full 512^2 x 8-sample input bit for bit,
    and against phase 13's render under the tie contract;
15. the stack engine (plain torch, no kernel): ``render_aovs`` at 512^2
    on config A's scene against phase 13's primary records, ``render_ao``
    at 128^2 against the K1 route, and the graft entry's shape (16^2
    rays, 234 triangles) against brute force;
16. incoherent random (``bench_matrix.py:322-365``): the ~1M-triangle
    sphere at leaf 8, BVH8, ``make_treelets(1024)``, 4,194,304 random
    rays (seed 11) through ``traverse_bvh8_binned(K=8, octant_major,
    sub=16)``, one warm-up and 3 runs timed by the host clock; one more
    run split into its layers with CUDA events; the records against
    global ``traverse_bvh8`` (t bit-equal), global K1 unsorted and
    sorted beside it; the first 64 packets of a captured round-1 K1
    launch held to the plain version with the same roots, bit for bit;
17. incoherent bounce (``bench_matrix.py:367-411``): 1024^2 primaries
    on phase 16's scene, 4 cosine AO rays a hit (max_t 0.5, dead where
    the pixel missed), ``traverse_bvh8_sorted(occlusion=True)``, a
    warm-up and 3 timed; 131,072 of its sorted rays held to the plain
    version bit for bit;
18. K1's modes: the counters on phase 5's rays (== plain) and over the
    8192^2 frame (the frame's work and bound); the zero-edge flags on
    phase 5's rays (== plain, sound) and on an axis-aligned case, and
    ``traverse_bvh8_exact`` / ``_exact_fused`` against single-pass
    exact; ``interleave`` 2 and 4 on the frame, on phase 16's rays and
    (== plain) on phase 5's rays; K1's ``ptxas -v`` report.

It then prints one JSON line with every kernel (its launches on the main
path, its error against its plain version, its time, its plain
version's time, and its bound: the larger of the bytes it must move over
3.35 TB/s and the operations this run's inputs need over 67 TFLOP/s,
counted by the plain version) and, last, the ok line. Any failed phase
exits non-zero without the ok line; so does a machine without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

FAILURES: list[str] = []

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations of one unit of work, counted from the kernels'
# source: one child's slab test (6 sub, 9 mul, 7 compare/select), one
# watertight triangle test (9 sub, 12 shear, 9 edge, 2 det, 8 t, 1 div,
# 3 mul, 6 compare), one Woop test (3 sub, 10 for o'z and d'z, 1 div,
# 1 mul, 24 for u and v, 5 compare), one Moller-Trumbore test, and one
# path vertex's shading (fresnel, lobe pick, light sample, ONB, next
# direction; about 200), and one AO sample's share of the fused AO pass
# (15 for its world direction, plus an eighth of the pixel's ~40 for the
# normal flip, the offset point and the basis: about 20)
SLAB_OPS, WT_OPS, WOOP_OPS, MT_OPS, SHADE_OPS = 22, 50, 44, 51, 200
AO_OPS = 20


def check(cond: bool, what: str):
    if not cond:
        FAILURES.append(what)
        print(f"FAIL: {what}", flush=True)


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-repetition milliseconds of ``fn()`` measured with CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def same_frac(a, b) -> float:
    """Fraction of rows (rays, pixels) of ``a`` equal to ``b`` bit for
    bit."""
    import torch

    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(eq.all(1).float().mean())


def max_abs(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def median(xs):
    return sorted(xs)[len(xs) // 2]


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_b = n_bytes / HBM_BYTES_S * 1e3
    t_o = n_ops / F32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def row_bytes(stats: dict) -> int:
    """Bytes of the distinct node and leaf rows (128 float32 lanes each)
    that a plain traversal read: the table bytes its rays need."""
    return (stats["node_rows"] + stats["leaf_rows"]) * 128 * 4


def trace_ops(stats: dict, width: int, tri_ops: int) -> float:
    """Operations of the node pops and triangle tests a plain traversal
    counted."""
    return stats.get("nodes", 0) * width * SLAB_OPS + stats.get(
        "tris", 0) * tri_ops


@contextlib.contextmanager
def patched(mod, name, fn):
    """``mod.name`` replaced by ``fn`` inside the block."""
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)


def record_err(got, want) -> float:
    """Largest |difference| of two traversal records' t (where both are
    finite), u and v."""
    import torch

    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
    return max(max_abs(got[0], want[0], fin), max_abs(got[1], want[1]),
               max_abs(got[2], want[2]))


def capture_bounce(scene, cam_rays, bounce: int) -> list:
    """One more megabatch render (seed 3, 100 spp, 10 bounces) that keeps
    what the traversal kernel was given and gave back on bounce
    ``bounce`` of the first megabatch: its closest-hit trace and its
    shadow trace, each ``(sorted rays, keyword arguments, hits)``."""
    from nanort_tpu_torch.models import path_tracer
    from nanort_tpu_torch.traverse import packet

    kept, calls = [], [0]
    real = packet.traverse_bvh8

    def keep(scene8, rays, *a, **k):
        out = real(scene8, rays, *a, **k)
        if calls[0] in (2 * bounce, 2 * bounce + 1):
            kept.append((rays, dict(k), out))
        calls[0] += 1
        return out

    with patched(packet, "traverse_bvh8", keep):
        path_tracer.render_path_traced(scene, cam_rays, 3, spp=100,
                                       max_bounces=10, fused=False)
    return kept


def hold_megabatch_trace(scene8, rays, kw, got) -> dict:
    """A trace captured from the megabatch route against the plain
    version on the same tensors (bit for bit), with the kernel
    relaunched on them for its time, and the plain version's work
    count."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.traverse import packet

    woop = kw.get("intersector") == "woop"
    occ = kw.get("occlusion", False)
    check(kw.get("skip_prim_id") is None and kw.get("options") is None,
          f"megabatch trace with unexpected arguments {sorted(kw)}")
    n = rays.org.shape[0]
    dead = rays.max_t <= rays.min_t
    n_dead = int(dead.sum())
    stats = {}

    def plain():
        holder["want"] = packet._traverse_reference(
            scene8.nodes, scene8.leafs_woop if woop else scene8.leafs,
            scene8.width, rays.org, rays.dir, rays.min_t, rays.max_t, None,
            None, False, nt.BVHTraceOptions().exact_edge_fallback and not woop,
            occ, packet.stack_slots(scene8), woop=woop, stats=stats)

    holder = {}
    p_ms = cuda_ms(plain, 1)[0]
    want = holder.pop("want")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = record_err(got, want)
    del want
    k_ms = median(cuda_ms(lambda: packet.traverse_bvh8(scene8, rays, **kw),
                          5))
    return {"rays": n, "dead": n_dead,
            "dead_tail": bool(dead[n - n_dead:].all()),
            "dead_hits": int(got.hit[dead].sum()),
            "hits": int(got.hit.sum()), "same": same, "err": err,
            "ms": k_ms, "plain_ms": p_ms, "stats": stats}


def path_tracer_phases(dev, usage_pt) -> tuple[list[dict], int, float,
                                                tuple]:
    """Phases 7-12 (K2, K3, K4, the config-B and midscale renders, K1-woop
    and the megabatch route); returns their entries of the ``kernels``
    line, the watertight K1 launches of phase 11, that kernel's largest
    error on its phase-11 traces, and phase 7's K2 inputs (the dense
    scene's BVH16 and aux tables, its incoherent rays and its mesh).
    ``usage_pt``: a future of K3's and K4's ``ptxas -v`` report."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_dense_pt_scene, make_cornell_pt_scene)
    from nanort_tpu_torch.models import path_tracer, pt_fused
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import fused_trace

    # ---- 7. K2, K3, K4 against their plain versions
    t0 = time.perf_counter()
    dv, df, dm, dmats = make_cornell_dense_pt_scene(100_000)
    dense = path_tracer.make_pt_scene(dv, df, dm, dmats, engine="pallas",
                                      device=dev)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    s8 = dense.scene8
    say(f"# phase 7: dense Cornell scene {len(df)} tris, scene + BVH16 + aux "
        f"tables on the host {dense_s:.2f} s: {s8.num_nodes} nodes, "
        f"{s8.num_leaf_rows} leaf rows, depth {s8.depth}, max leaf "
        f"{s8.max_leaf}")
    check(len(df) == 99_236, f"dense scene has {len(df)} tris, not 99,236")
    check(pt_fused.fused_bvh_eligible(dense)
          and not pt_fused.fused_eligible(dense),
          "the dense scene does not take the K4 route")

    # K2: seeded incoherent rays inside the box, every 7th axis-parallel,
    # every 13th with a zero direction, every 11th with a short tmax
    n = 65_536
    rng = np.random.default_rng(17)
    org = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1:] = 0.0
    d[::7, 0] = np.where(d[::7, 0] < 0, -1.0, 1.0)
    d[3::13] = 0.0
    tmax = np.full(n, 1e30, np.float32)
    tmax[5::11] = rng.uniform(0.1, 1.0, tmax[5::11].shape)
    rays = nt.Rays(torch.from_numpy(org).to(dev), torch.from_numpy(d).to(dev),
                   torch.full((n,), 0.001, device=dev),
                   torch.from_numpy(tmax).to(dev))
    nodes, leafs, aux, slots = fused_trace._check_tables(
        s8, dense.fused_aux, dev)

    def k2(occ):
        return fused_trace.trace_bvh16(s8, rays, dense.fused_aux,
                                       occlusion=occ, want_aux=not occ)

    def k2_plain(occ, stats=None):
        return fused_trace.trace_bvh16_reference(
            nodes, leafs, None if occ else aux, rays.org, rays.dir,
            rays.min_t, rays.max_t, occ, slots, stats=stats)

    k2_stats = {}
    got, want = k2(False), k2_plain(False, k2_stats)
    occ, occ_want = k2(True), k2_plain(True)
    fields = ("t", "u", "v", "prim_id", "hit", "material_id", "normal")
    frac = {f: same_frac(getattr(got, f), getattr(want, f)) for f in fields}
    k2_err = max(max_abs(got.t, want.t, got.hit), max_abs(got.u, want.u),
                 max_abs(got.v, want.v), max_abs(got.normal, want.normal))
    occ_frac = same_frac(occ, occ_want)
    k2_ms = median(cuda_ms(lambda: k2(False), 5))
    k2_occ_ms = median(cuda_ms(lambda: k2(True), 5))
    k2_plain_ms = min(cuda_ms(lambda: k2_plain(False), 1))
    say(f"K2 bvh16_trace, {n} incoherent rays, {int(got.hit.sum())} hits, "
        f"{int(occ.sum())} occluded: bit-identical fraction {frac}, "
        f"occlusion {occ_frac}; max abs err {k2_err}; kernel closest+aux "
        f"{k2_ms:.3f} ms, occlusion {k2_occ_ms:.3f} ms (medians of 5); "
        f"plain {k2_plain_ms:.1f} ms")
    check(min(frac.values()) == 1.0 and occ_frac == 1.0,
          "K2 disagrees with its plain version")
    # outputs: t, u, v f32, pid, hit, material id i32, normal 3 x f32
    k2_bound = bound(n * (32 + 36) + nbytes(nodes, leafs, aux),
                     trace_ops(k2_stats, 16, MT_OPS))
    say(f"K2 work on these rays (plain version's count): {k2_stats}; "
        f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    # 1,024 of them against a brute Moller-Trumbore sweep (the same
    # per-triangle arithmetic; equal-t ties may pick either prim)
    tri = pt_fused.build_fused_tables(dense)[0]
    sel = torch.arange(0, n, n // 1024, device=dev)[:1024]
    bt, bhit, bocc = [], [], []
    for c in sel.split(64):
        s_tmax = rays.max_t[c]
        # the zero-direction rays have det == 0 against every triangle
        tt, _, _, ok = pt_fused._brute_mt(
            tri, *rays.org[c].unbind(1), *rays.dir[c].unbind(1),
            rays.min_t[c], s_tmax)
        t_min = torch.where(ok, tt, float("inf")).amin(1)
        bhit.append(ok.any(1) & (t_min < s_tmax))
        bt.append(torch.where(bhit[-1], t_min, s_tmax))
        bocc.append(ok.any(1))
    bhit, bt, bocc = torch.cat(bhit), torch.cat(bt), torch.cat(bocc)
    brute_ok = (torch.equal(bhit, got.hit[sel]) and torch.equal(bt, got.t[sel])
                and torch.equal(bocc, occ[sel]))
    say(f"K2 vs brute force on 1024 rays: hit, t and occlusion equal: "
        f"{brute_ok} ({int(bhit.sum())} hits)")
    check(brute_ok, "K2 disagrees with brute force")

    # K3 on the 32-triangle Cornell box, K4 on the dense scene
    cv, cf, cm, cmats = make_cornell_pt_scene(2.0)
    cornell = path_tracer.make_pt_scene(cv, cf, cm, cmats, engine="pallas",
                                        device=dev)
    check(pt_fused.fused_eligible(cornell) and cornell.scene8 is None,
          "the Cornell box does not take the K3 route")

    def cam_rays(w, h, eye_z):
        cam = look_at(eye=(0, 0.0, eye_z), center=(0, 0, 0), width=w,
                      height=h, fov=45.0, device=dev)
        r = pinhole_rays(cam)
        return r.org.reshape(-1, 3), r.dir.reshape(-1, 3)

    SPP, MB, AZ, SEED = 4, 10, 4, 11
    k3_res = {}
    k3_count = {"tris": 0, "shade": 0}

    def counting_mt(tri, *c):
        # the plain K3's sweeps: closest (tmin = eps_t) and shadow
        tmin, tmax = c[-2], c[-1]
        live = int((tmax > tmin).sum())
        k3_count["tris"] += live * tri.shape[0]
        if tmin.numel() and float(tmin[0]) == pt_fused._EPS_T:
            k3_count["shade"] += live
        return real_mt(tri, *c)

    real_mt = pt_fused._brute_mt
    c_org, c_dir = cam_rays(64, 64, 5.0)
    tri3, face3, light3 = pt_fused.build_fused_tables(cornell)
    lights3 = pt_fused._lights(cornell, dev)
    for trig in ("poly", "native"):
        def k3():
            return pt_fused.render_fused(cornell, c_org, c_dir, SEED, SPP,
                                         max_bounces=MB, trig=trig,
                                         azimuth_strata=AZ)

        def k3_plain():
            return pt_fused._render_fused_reference(
                tri3, face3, lights3, c_org, c_dir, SEED, SPP, MB, 3, trig,
                AZ) / float(SPP)

        got = k3()
        with (patched(pt_fused, "_brute_mt", counting_mt) if trig == "poly"
              else contextlib.nullcontext()):
            want = k3_plain()
        fr, err = same_frac(got, want), max_abs(got, want)
        ms = median(cuda_ms(k3, 5))
        p_ms = min(cuda_ms(k3_plain, 1))
        k3_res[trig] = (fr, err, ms, p_ms, float(got.mean()))
        say(f"K3 pt_fused_brute trig={trig}, {c_org.shape[0]} rays x {SPP} "
            f"spp x {MB} bounces: bit-identical pixels {fr}, max abs err "
            f"{err}, mean {float(got.mean())} vs {float(want.mean())}; "
            f"kernel {ms:.3f} ms (median of 5), plain {p_ms:.1f} ms")
        check(fr == 1.0 if trig == "poly" else fr > 0.99,
              f"K3 trig={trig} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), f"K3 trig={trig} not finite")

    R3 = c_org.shape[0]
    k3_bound = bound(R3 * (24 + 12) + nbytes(tri3, face3, light3),
                     k3_count["tris"] * MT_OPS + k3_count["shade"] * SHADE_OPS)
    say(f"K3 work (plain version's count, poly): {k3_count}; bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]})")

    d_org, d_dir = cam_rays(64, 64, 2.6)
    mat4, light4, _, _, _ = pt_fused.build_fused_bvh_tables(dense)
    lights4 = pt_fused._lights(dense, dev)
    k4_res = {}
    k4_count = {}
    real_tr = fused_trace.trace_bvh16_reference

    def counting_tr(nodes, leafs, aux, org, dir, tmin, tmax, occlusion,
                    slots):
        if not occlusion:
            k4_count["shade"] = k4_count.get("shade", 0) + int(
                (tmax > tmin).sum())
        return real_tr(nodes, leafs, aux, org, dir, tmin, tmax, occlusion,
                       slots, stats=k4_count)

    k4_lane = {}
    for lanes in (1, 4):
        o_l = d_org.repeat_interleave(lanes, 0)
        d_l = d_dir.repeat_interleave(lanes, 0)

        def k4(schedule="pool"):
            return pt_fused.render_fused_bvh(
                dense, d_org, d_dir, SEED, SPP, max_bounces=MB, trig="poly",
                azimuth_strata=AZ, spp_lanes=lanes, _schedule=schedule)

        def k4_plain():
            sums = pt_fused._render_fused_bvh_reference(
                mat4, lights4, nodes, leafs, aux, slots, o_l, d_l, SEED,
                SPP // lanes, MB, 3, "poly", AZ, lanes)
            return pt_fused.lane_sums(sums, lanes) / float(SPP)

        got = k4()
        if lanes == 4:
            k4_count.clear()
        with (patched(fused_trace, "trace_bvh16_reference", counting_tr)
              if lanes == 4 else contextlib.nullcontext()):
            want = k4_plain()
        fr, err = same_frac(got, want), max_abs(got, want)
        ms = median(cuda_ms(k4, 5))
        p_ms = min(cuda_ms(k4_plain, 1))
        k4_res[lanes] = (fr, err, ms, p_ms)
        say(f"K4 pt_fused_bvh spp_lanes={lanes}, {d_org.shape[0]} rays x "
            f"{SPP} spp x {MB} bounces: bit-identical pixels {fr}, max abs "
            f"err {err}, mean {float(got.mean())} vs {float(want.mean())}; "
            f"kernel {ms:.3f} ms (median of 5), plain {p_ms:.1f} ms")
        check(fr == 1.0, f"K4 spp_lanes={lanes} disagrees with its plain "
              "version")
        check(bool(torch.isfinite(got).all()), "K4 image not finite")
        # the lane kernel, the pooled kernel's yardstick, on the same input
        got_l = k4("lane")
        fr_l, err_l = same_frac(got_l, want), max_abs(got_l, want)
        ms_l = median(cuda_ms(lambda: k4("lane"), 5))
        k4_lane[lanes] = (fr_l, err_l, ms_l)
        say(f"K4 lane kernel (_schedule='lane') spp_lanes={lanes}: "
            f"bit-identical pixels {fr_l}, max abs err {err_l}; kernel "
            f"{ms_l:.3f} ms (median of 5) vs pooled {ms:.3f} ms")
        check(fr_l == 1.0, f"K4's lane kernel spp_lanes={lanes} disagrees "
              "with the plain version")

    R4 = d_org.shape[0] * 4
    k4_bound = bound(R4 * (24 + 12) + nbytes(mat4, light4, nodes, leafs, aux),
                     trace_ops(k4_count, 16, MT_OPS)
                     + k4_count.get("shade", 0) * SHADE_OPS)
    say(f"K4 work (plain version's count, spp_lanes 4): {k4_count}; bound "
        f"{k4_bound[0]:.4f} ms ({k4_bound[1]})")
    occ = pt_fused.pool_occupancy()
    say(f"K4 resident blocks per SM: lane kernel {occ['lane']} x 128 "
        f"threads, pooled kernel {occ['pool']} x 512 threads "
        f"({occ['pool_smem_bytes']} bytes of shared pool a block); ptxas "
        "-v: " + " | ".join(ptxas_lines(usage_pt.result())))
    check(occ["pool"] >= 1, "the pooled kernel does not fit an SM")
    # where the pooled kernel starts to win: 4,096 rays at 4 sample-major
    # lanes, more samples a step, the two kernels in turns
    sizes = []
    for spp in (4, 16, 64, 256):
        ms_of = {}
        for schedule in ("lane", "pool", "pool", "lane"):
            ms_of.setdefault(schedule, []).extend(cuda_ms(
                lambda: pt_fused.render_fused_bvh(
                    dense, d_org, d_dir, SEED, spp, max_bounces=MB,
                    azimuth_strata=AZ, spp_lanes=4, _schedule=schedule), 2))
        sizes.append(f"{d_org.shape[0] * spp} paths: lane "
                     f"{min(ms_of['lane']):.3f}, pooled "
                     f"{min(ms_of['pool']):.3f}")
    say("K4 by render size (64x64 rays x spp, 10 bounces, spp_lanes 4, "
        "best of 4 each, ms): " + "; ".join(sizes))

    # K4 against K3 on the Cornell box with BVH16 tables attached (leaf 4)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(cv, cf), nt.BVHBuildOptions(
        min_leaf_primitives=4, max_leaf_primitives=4))
    c8 = collapse_bvh8(bvh, cv, cf, width=16)
    c_aux = fused_trace.build_aux_rows(
        c8.leafs, cm, cf, cv, c8.max_leaf,
        gn_unit=cornell.face_table[:, 0:3].cpu().numpy())
    both = cornell._replace(scene8=c8.to(dev),
                            fused_aux=torch.from_numpy(c_aux).to(dev))
    img3 = pt_fused.render_fused(both, c_org, c_dir, 7, 6, max_bounces=4)
    img4 = pt_fused.render_fused_bvh(both, c_org, c_dir, 7, 6, max_bounces=4)
    fr = same_frac(img3, img4)
    rel = abs(float(img4.mean() - img3.mean())) / float(img3.mean())
    say(f"K4 vs K3 on the Cornell box (BVH16 attached), {c_org.shape[0]} rays x 6 spp x "
        f"4 bounces: bit-identical pixels {fr} (only equal-t ties may "
        f"differ), image means {float(img4.mean())} vs {float(img3.mean())}")
    check(fr > 0.9 and rel < 0.05, "K4 and K3 disagree on the Cornell box")

    # ---- 8. config B at full size through render_path_traced (K3)
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=512,
                  height=512, fov=45.0, device=dev)
    img, ms_b, busy, counts = time_render(cornell, pinhole_rays(cam))
    report_render("phase 8: config B, procedural_cornell 32 tris, K3", img,
                  ms_b, busy, counts, {"pt_fused_brute": 4})
    launches_b = counts["pt_fused_brute"]
    mean_b = float(img.mean())
    # the render's work, scaled from phase 7's 4,096-ray x 4-spp sample
    # of the same view (per-sample work does not depend on resolution)
    scale = 512 * 512 * 100 / (R3 * SPP)
    rb = bound(512 * 512 * (24 + 12) + nbytes(tri3, face3, light3),
               (k3_count["tris"] * MT_OPS + k3_count["shade"] * SHADE_OPS)
               * scale)
    say(f"phase 8 render bound (phase 7's K3 work x {scale:.0f}): "
        f"{rb[0]:.4f} ms ({rb[1]})")

    # ---- 9. midscale at full size (K4 on K2)
    cam = look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0), width=512,
                  height=512, fov=45.0, device=dev)
    img, ms_m, busy, counts = time_render(dense, pinhole_rays(cam))
    report_render(f"phase 9: midscale, {len(df)} tris (host scene + tables "
                  f"{dense_s:.2f} s), K4 on K2, spp_lanes "
                  f"{path_tracer.default_spp_lanes(100, 4)}", img, ms_m,
                  busy, counts, {"pt_fused_bvh": 4, "bvh16_trace": 4})
    launches_m, launches_k2 = counts["pt_fused_bvh"], counts["bvh16_trace"]
    mean_m = float(img.mean())
    scale = 512 * 512 * 100 / (d_org.shape[0] * SPP)
    rb = bound(512 * 512 * (24 + 12)
               + nbytes(mat4, light4, nodes, leafs, aux),
               (trace_ops(k4_count, 16, MT_OPS)
                + k4_count.get("shade", 0) * SHADE_OPS) * scale)
    say(f"phase 9 render bound (phase 7's K4 work x {scale:.0f}): "
        f"{rb[0]:.4f} ms ({rb[1]})")
    st = dict(zip(pt_fused.POOL_STATS, pt_fused.LAST_POOL_STATS.tolist()))
    say(f"phase 9 pool (last render): {st['blocks']} blocks, {st['waves']} "
        f"waves ({st['waves'] / max(st['blocks'], 1):.1f} a block), "
        f"{st['paths']} regenerations (paths started), {st['closest']} "
        f"closest-hit and {st['shadows']} shadow traces")
    check(st["paths"] == 512 * 512 * 100,
          f"the pool ran {st['paths']} paths")
    img_m = img
    launches_lane = k4_schedules(dense, cam, img_m, mat4, light4, lights4,
                                 nodes, leafs, aux, slots)
    del img, img_m
    torch.cuda.empty_cache()

    woop_entry, launches_pallas, pallas_err = megabatch_phases(
        dev, (dv, df, dm, dmats), dense, cornell, rays, mean_b, mean_m)

    return [{
        "name": "bvh16_trace",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/bvh16_trace.cuh",
        "replaces": "nanort_tpu/traverse/fused_trace.py:104",
        "launches": launches_k2,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "pt_fused_brute",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/pt_fused.cu",
        "replaces": "nanort_tpu/models/pt_fused.py:314",
        "launches": launches_b,
        "max_abs_err": k3_res["poly"][1],
        "ms": k3_res["poly"][2],
        "plain_ms": k3_res["poly"][3],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }, {
        "name": "pt_fused_bvh",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/pt_fused.cu",
        "replaces": "nanort_tpu/models/pt_fused.py:532",
        "launches": launches_m,
        "max_abs_err": max(r[1] for r in k4_res.values()),
        "ms": k4_res[4][2],
        "plain_ms": k4_res[4][3],
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": None,
    }, {
        # the yardstick: launched by phase 9's turns on the same render
        "name": "pt_fused_bvh[lane]",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/pt_fused.cu",
        "replaces": "nanort_tpu/models/pt_fused.py:532",
        "launches": launches_lane,
        "max_abs_err": max(r[1] for r in k4_lane.values()),
        "ms": k4_lane[4][2],
        "plain_ms": k4_res[4][3],
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": None,
    }, woop_entry], launches_pallas, pallas_err, (s8, dense.fused_aux, rays,
                                                  dense.mesh)


def ptxas_lines(text: str) -> list[str]:
    """K3's and K4's kernels in a ``ptxas -v`` report: each kernel's
    name, registers, spills and stack."""
    out, name = [], None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in ("pt_bvh_pool_kernel",
                                     "pt_bvh_lane_kernel", "pt_brute_kernel")
                         if k in ln), None)
        elif name and ("Used" in ln or "spill" in ln):
            out.append(f"{name.split('I')[0]}: {' '.join(ln.split())}")
    return out


def k4_schedules(dense, cam, img_pool, mat, light, lights, nodes, leafs, aux,
                 slots) -> int:
    """Phase 9's comparison of K4's two kernels on the midscale render:
    the lane and pooled kernels in turns through ``render_path_traced``
    (images equal bit for bit, and equal to the main path's), one pooled
    render in two slices of sample iterations, both kernels' lane sums with
    ``trig="poly"`` (equal bit for bit) and 4,096 sampled lanes against
    the plain version. Returns the lane kernel's launches in the turns."""
    import functools

    import torch

    from nanort_tpu_torch.models import path_tracer, pt_fused
    from nanort_tpu_torch.models.cameras import pinhole_rays

    rays = pinhole_rays(cam)
    real = pt_fused.render_fused_bvh
    zero_launch_counts()

    def render(schedule):
        pt_fused.render_fused_bvh = functools.partial(real,
                                                      _schedule=schedule)
        try:
            holder = {}
            ms = cuda_ms(lambda: holder.__setitem__(
                "img", path_tracer.render_path_traced(
                    dense, rays, 3, spp=100, max_bounces=10)), 1)[0]
            return holder["img"], ms
        finally:
            pt_fused.render_fused_bvh = real

    turns = []
    for schedule in ("lane", "pool", "pool", "lane"):
        img, ms = render(schedule)
        turns.append((schedule, ms, torch.equal(img, img_pool)))
    launches = launch_counts()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lane_ms = [ms for sch, ms, _ in turns if sch == "lane"]
    pool_ms = [ms for sch, ms, _ in turns if sch == "pool"]
    say(f"phase 9 K4 schedules in turns on {smi} (512x512 x 100 spp x 10 "
        "bounces, render_path_traced, ms): "
        + ", ".join(f"{sch} {ms:.1f}" for sch, ms, _ in turns)
        + f"; lane/pooled {min(lane_ms) / min(pool_ms):.3f}x; images equal "
        f"to the main path's bit for bit: {[e for _, _, e in turns]}; "
        f"launches {launches}")
    check(all(e for _, _, e in turns),
          "K4's lane and pooled kernels give different midscale images")
    check(launches["pt_fused_bvh"] == 2 and launches["pt_fused_bvh[lane]"]
          == 2, f"phase 9 turns launched {launches}")
    check(min(pool_ms) < min(lane_ms),
          "the pooled kernel is not faster than the lane kernel")

    # a render whose per-sample buffer passes the cap runs one launch a
    # slice of its sample iterations: half the 4 iterations a slice here
    K = path_tracer.default_spp_lanes(100, 4)
    rl = 512 * 512 * K
    zero_launch_counts()
    with patched(pt_fused, "POOL_SLICE_BYTES", 2 * rl * 12):
        img, ms_s = render("pool")
    sliced = launch_counts()["pt_fused_bvh"]
    say(f"phase 9 pooled kernel in slices of 2 sample iterations "
        f"({2 * rl * 12} bytes a buffer, {sliced} launches): {ms_s:.1f} ms; "
        f"image equal to the main path's bit for bit: "
        f"{torch.equal(img, img_pool)}")
    check(sliced == 2 and torch.equal(img, img_pool),
          "the sliced pooled render disagrees with the main path's")

    # both kernels' lane sums with trig="poly" on the route's own input
    H = W = 512
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    perm = torch.arange(H * W, device=org.device).reshape(
        H // 32, 32, W // 128, 128).transpose(1, 2).reshape(-1)
    org = org[perm].repeat_interleave(K, 0).contiguous()
    d = d[perm].repeat_interleave(K, 0).contiguous()
    args = (mat, light, lights, nodes, leafs, aux, slots, org, d, 3,
            100 // K, 10, 3, "poly", 4, K)
    sums = {sch: pt_fused._launch_fused_bvh(sch, *args)
            for sch in ("pool", "lane")}
    same = torch.equal(sums["pool"], sums["lane"])
    pick = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        org.shape[0], 4096, replace=False))).to(org.device)
    t0 = time.perf_counter()
    want = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org[pick], d[pick], 3,
        100 // K, 10, 3, "poly", 4, K, lane_ids=pick)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    held = torch.equal(sums["pool"][pick], want)
    say(f"phase 9 trig='poly': pooled == lane lane sums bit for bit on all "
        f"{org.shape[0]} lanes: {same}; 4,096 sampled lanes == plain "
        f"version (lane_ids=) bit for bit: {held} (plain {plain_s:.1f} s), "
        f"max abs err {max_abs(sums['pool'][pick], want)}")
    check(same and held, "K4's pooled kernel disagrees on the full-size "
          "poly input")
    return launches["pt_fused_bvh[lane]"]


def megabatch_phases(dev, dense_arrays, dense, cornell, rays, mean_b,
                     mean_m) -> tuple[dict, int, float]:
    """Phases 10-12: K1-woop against its plain version and against the
    watertight test, the megabatch route at full width (turbo, pallas)
    with each engine's bounce-2 traces held to the plain version, and
    its two engines without a kernel. Returns K1-woop's entry of the
    ``kernels`` line, the watertight K1 launches of phase 11 and the
    watertight kernel's largest error on its phase-11 traces."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.models import path_tracer
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.traverse import packet, ray_sort

    # ---- 10. K1-woop against its plain version
    t0 = time.perf_counter()
    turbo = path_tracer.make_pt_scene(*dense_arrays, engine="turbo",
                                      device=dev)
    torch.cuda.synchronize()
    s8 = turbo.scene8
    say(f"# phase 10: turbo scene (leaf 9, Woop table) on the host "
        f"{time.perf_counter() - t0:.2f} s: {s8.num_nodes} nodes, "
        f"{s8.num_leaf_rows} leaf rows, depth {s8.depth}, max leaf "
        f"{s8.max_leaf}")
    check(s8.leafs_woop is not None and s8.max_leaf <= 9,
          "the turbo scene has no Woop table")
    n = rays.org.shape[0]
    slots = packet.stack_slots(s8)

    def kern(occ, inter="woop"):
        return packet.traverse_bvh8(s8, rays, occlusion=occ,
                                    intersector=inter)

    def plain(occ, stats=None):
        return packet._traverse_reference(
            s8.nodes, s8.leafs_woop, 16, rays.org, rays.dir, rays.min_t,
            rays.max_t, None, None, False, False, occ, slots, woop=True,
            stats=stats)

    woop_stats = {}
    res = {}
    for occ in (False, True):
        got = kern(occ)
        want = plain(occ, woop_stats if not occ else None)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = record_err(got, want)
        res[occ] = (got, same, err)
        say(f"K1-woop {'any-hit' if occ else 'closest'} on {n} incoherent "
            f"rays at {len(dense_arrays[1])} tris: {int(got.hit.sum())} hits; "
            f"kernel == plain bit for bit: {same}; max abs err {err}")
        check(same, f"K1-woop (occlusion={occ}) disagrees with its plain "
              "version")
    wt = kern(False, "watertight")
    wh, gh = wt.hit, res[False][0].hit
    both = wh & gh
    hit_agree = float((wh == gh).float().mean())
    prim_agree = float((wt.prim_id[both] == res[False][0].prim_id[both])
                       .float().mean())
    ms_w = median(cuda_ms(lambda: kern(False), 10))
    ms_wt = median(cuda_ms(lambda: kern(False, "watertight"), 10))
    ms_wo = median(cuda_ms(lambda: kern(True), 10))
    ms_wto = median(cuda_ms(lambda: kern(True, "watertight"), 10))
    plain_ms = min(cuda_ms(lambda: plain(False), 1))
    woop_bound = bound(n * (32 + 20) + row_bytes(woop_stats),
                       trace_ops(woop_stats, 16, WOOP_OPS))
    say(f"K1-woop vs watertight on the same rays: hit masks agree on "
        f"{hit_agree} of rays, prims on {prim_agree} of common hits; "
        f"closest woop {ms_w:.4f} ms vs watertight {ms_wt:.4f} ms (ratio "
        f"{ms_w / ms_wt:.3f}), any-hit {ms_wo:.4f} vs {ms_wto:.4f} (ratio "
        f"{ms_wo / ms_wto:.3f}) (medians of 10); plain {plain_ms:.1f} ms; "
        f"work {woop_stats}, bound {woop_bound[0]:.4f} ms ({woop_bound[1]})")
    check(hit_agree > 0.999, "woop and watertight hit masks disagree")
    woop_err = max(res[False][2], res[True][2])
    del res, wt, wh, gh, both
    torch.cuda.empty_cache()

    # ---- 11. the megabatch route at full width
    cam = look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0), width=512,
                  height=512, fov=45.0, device=dev)
    cam_rays = pinhole_rays(cam)
    launches, held = {}, {}
    for name, scene, key in (("turbo", turbo, "packet_traverse_woop"),
                             ("pallas", dense, "packet_traverse")):
        torch.cuda.reset_peak_memory_stats(dev)
        img, ms, busy, counts = time_render(scene, cam_rays, fused=False)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        report_render(f"phase 11: megabatch route, engine {name!r}, "
                      f"{len(dense_arrays[1])} tris, 4 megabatches of "
                      f"6,553,600 rays; peak device memory {peak:.2f} GiB",
                      img, ms, busy, counts, {key: 4 * 80})
        rel = abs(float(img.mean()) - mean_m) / mean_m
        say(f"phase 11 {name}: image mean {float(img.mean())} vs phase 9's "
            f"K4 {mean_m} (relative {rel:.5f})")
        check(rel < 0.02, f"megabatch {name} image mean far from K4's")
        launches[name] = counts[key]
        del img
        torch.cuda.empty_cache()
        # the kernel's records on bounce 2 of the first megabatch (sorted
        # bounce and shadow rays, dead rays at the tail: the first bounce
        # whose closest-hit trace holds ended paths) against its plain
        # version on the same tensors
        for kind, (r, kw, got) in zip(("closest", "shadow"),
                                      capture_bounce(scene, cam_rays, 2)):
            h = hold_megabatch_trace(scene.scene8, r, kw, got)
            del r, got
            torch.cuda.empty_cache()
            held[name, kind] = h
            say(f"phase 11 {name}, bounce 2 {kind} trace of the first "
                f"megabatch: {h['rays']} sorted rays, {h['dead']} dead (at "
                f"the tail: {h['dead_tail']}, hits among them "
                f"{h['dead_hits']}), {h['hits']} hits; kernel == plain bit "
                f"for bit: {h['same']}; max abs err {h['err']}; kernel "
                f"{h['ms']:.3f} ms (median of 5), plain {h['plain_ms']:.1f} "
                f"ms; work {h['stats']}")
            check(h["same"], f"megabatch {name} {kind} trace disagrees with "
                  "the plain version")
            check(h["rays"] == 6_553_600 and h["dead"] > 0 and h["dead_tail"]
                  and h["dead_hits"] == 0,
                  f"megabatch {name} {kind} trace: {h}")

    # for each engine, one more render split into its layers with CUDA
    # events, and one more counting the work of every trace on every
    # 1,000th of its sorted rays with the plain version (not timed)
    for name, scene, woop in (("turbo", turbo, True), ("pallas", dense,
                                                        False)):
        spans = {"trace_paths": [], "_trace": [], "traverse_bvh8": []}

        def timed(fn, what):
            def wrapped(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                spans[what].append((e0, e1))
                return out
            return wrapped

        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for mod, what in ((path_tracer, "trace_paths"),
                              (path_tracer, "_trace"),
                              (packet, "traverse_bvh8")):
                stack.enter_context(patched(mod, what,
                                            timed(getattr(mod, what), what)))
            total = cuda_ms(lambda: path_tracer.render_path_traced(
                scene, cam_rays, 3, spp=100, max_bounces=10, fused=False),
                1)[0]
        wall = (time.perf_counter() - t0) * 1e3
        sums = {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in spans.items()}
        layers = {
            "trace kernel": sums["traverse_bvh8"],
            "sort, permute, unsort": sums["_trace"] - sums["traverse_bvh8"],
            "shading, RNG": sums["trace_paths"] - sums["_trace"],
            "megabatch setup, accumulate": total - sums["trace_paths"],
        }
        say(f"phase 11 {name} render by layer (CUDA events; {total:.1f} ms "
            f"on the device, {wall:.1f} ms host wall): "
            + ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})"
                        for k, v in layers.items())
            + f"; {len(spans['traverse_bvh8'])} traversal launches")
        del spans
        torch.cuda.empty_cache()

        work = {"rays": 0, "bytes": 0, "nodes": 0, "tris": 0}

        def counting(s8, r, *a, **k):
            out = real_traverse(s8, r, *a, **k)
            sample = type(r)(*(x[::1000].contiguous() for x in r))
            st = {}
            leafs = s8.leafs_woop if woop else s8.leafs
            packet._traverse_reference(
                s8.nodes, leafs, 16, sample.org, sample.dir, sample.min_t,
                sample.max_t, None, None, False,
                nt.BVHTraceOptions().exact_edge_fallback and not woop,
                k.get("occlusion", False), packet.stack_slots(s8),
                woop=woop, stats=st)
            work["rays"] += r.org.shape[0]
            work["bytes"] += r.org.shape[0] * (32 + 20) + nbytes(s8.nodes,
                                                                 leafs)
            work["nodes"] += st.get("nodes", 0) * 1000
            work["tris"] += st.get("tris", 0) * 1000
            return out

        real_traverse = packet.traverse_bvh8
        with patched(packet, "traverse_bvh8", counting):
            path_tracer.render_path_traced(scene, cam_rays, 3, spp=100,
                                           max_bounces=10, fused=False)
        rb = bound(work["bytes"],
                   trace_ops(work, 16, WOOP_OPS if woop else WT_OPS))
        say(f"phase 11 {name} render, {'K1-woop' if woop else 'K1'}'s work "
            f"over its 80 launches (every 1,000th sorted ray, x1000): "
            f"{work}; bound {rb[0]:.4f} ms ({rb[1]}) against "
            f"{layers['trace kernel']:.1f} ms measured")

    # ---- 12. the engines without a kernel
    wf = path_tracer.make_pt_scene(*dense_arrays, device=dev)
    for what, scene, spp, ref in (
            ("wavefront walk, midscale scene", wf, 4, mean_m),
            ("brute force, Cornell box", cornell, 16, mean_b)):
        cam = look_at(eye=(0, 0.0, 2.6 if scene is wf else 5.0),
                      center=(0, 0, 0), width=512, height=512, fov=45.0,
                      device=dev)
        holder = {}
        zero_launch_counts()
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: holder.__setitem__(
            "img", path_tracer.render_path_traced(
                scene, pinhole_rays(cam), 3, spp=spp, max_bounces=10,
                fused=False)), 1)[0]
        wall = time.perf_counter() - t0
        counts = launch_counts()
        img = holder["img"]
        rel = abs(float(img.mean()) - ref) / ref
        samples = 512 * 512 * spp
        say(f"# phase 12: {what}, 512x512 x {spp} spp x 10 bounces: "
            f"{ms / 1e3:.4f} s on the device ({wall:.4f} s host wall) = "
            f"{samples / (ms / 1e3) / 1e6:.2f} Msamples/s; image mean "
            f"{float(img.mean())} vs the fused route's {ref} (relative "
            f"{rel:.5f}); launches {counts}")
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"phase 12 {what}: bad image")
        check(rel < 0.03, f"phase 12 {what}: image mean far from the "
              "fused route's")
        check(sum(counts.values()) == 0, f"phase 12 {what} launched a kernel")
    turbo_tables = (turbo.scene8.nodes, turbo.scene8.leafs_woop)
    del wf, turbo
    torch.cuda.empty_cache()

    # K1-woop's entry at the main path's shape: the turbo render's bounce-2
    # closest-hit trace (6,553,600 sorted rays)
    mb = held["turbo", "closest"]
    mb_bound = bound(mb["rays"] * (32 + 20) + nbytes(*turbo_tables),
                     trace_ops(mb["stats"], 16, WOOP_OPS))
    say(f"phase 11 K1-woop on the bounce-2 closest trace: bound "
        f"{mb_bound[0]:.4f} ms ({mb_bound[1]}) against {mb['ms']:.3f} ms")
    return {
        "name": "packet_traverse_woop",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:283",
        "launches": launches["turbo"],
        "max_abs_err": max([woop_err] + [held["turbo", k]["err"]
                                         for k in ("closest", "shadow")]),
        "ms": mb["ms"],
        "plain_ms": mb["plain_ms"],
        "bound_ms": mb_bound[0],
        "bound_by": mb_bound[1],
        "library_ms": None,
    }, launches["pallas"], max(held["pallas", k]["err"]
                               for k in ("closest", "shadow"))


def capture_traces(render) -> list:
    """Run ``render()`` once more and keep what the K1 kernel was given
    and gave back on each of its launches: ``(rays, positional
    arguments, keyword arguments, hits)``."""
    from nanort_tpu_torch.traverse import packet

    kept = []
    real = packet.traverse_bvh8

    def keep(scene8, rays, *a, **k):
        out = real(scene8, rays, *a, **k)
        kept.append((rays, a, dict(k), out))
        return out

    with patched(packet, "traverse_bvh8", keep):
        render()
    return kept


def hold_k1_trace(scene8, rays, args, kw, got, m: int | None = None) -> dict:
    """A captured K1 trace (its rays, positional and keyword arguments
    and records), or its first ``m`` rays, against the plain version on
    the same tensors (bit for bit, per-packet roots included), the
    kernel relaunched on them for its time, and the plain version's work
    count."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.traverse import packet

    opts = args[0] if args else kw.get("options", nt.BVHTraceOptions())
    occ = kw.get("occlusion", False)
    flat = nt.Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                   rays.min_t.reshape(-1), rays.max_t.reshape(-1))
    n = flat.org.shape[0] if m is None else m
    flat = nt.Rays(*(x[:n].contiguous() for x in flat))
    kw = dict(kw)
    skip = kw.get("skip_prim_id")
    if skip is not None:
        skip = skip.reshape(-1)[:n].long()
        kw["skip_prim_id"] = skip
    start = None
    if kw.get("packet_roots") is not None:
        pk = kw["sub"] * packet.LANES
        check(n % pk == 0, f"a slice of {n} rays is not whole packets of {pk}")
        kw["packet_roots"] = kw["packet_roots"][:n // pk].contiguous()
        start = kw["packet_roots"].long().repeat_interleave(pk)
    dead = flat.max_t < flat.min_t
    stats, holder = {}, {}

    def plain():
        holder["want"] = packet._traverse_reference(
            scene8.nodes, scene8.leafs, scene8.width, flat.org, flat.dir,
            flat.min_t, flat.max_t, skip, None, opts.cull_back_face,
            opts.exact_edge_fallback, occ, packet.stack_slots(scene8),
            stats=stats, start=start)

    p_ms = cuda_ms(plain, 1)[0]
    want = holder.pop("want")
    got_flat = [x.reshape(-1)[:n] for x in got]
    same = all(torch.equal(a, b) for a, b in zip(got_flat, want))
    err = record_err(got_flat, want)
    del want
    k_ms = median(cuda_ms(lambda: packet.traverse_bvh8(scene8, flat, *args,
                                                       **kw), 5))
    hit = got_flat[3] != nt.INVALID_PRIM_ID
    return {"rays": n, "dead": int(dead.sum()),
            "dead_hits": int(hit[dead].sum()), "hits": int(hit.sum()),
            "skip": skip is not None, "occlusion": occ, "same": same,
            "err": err, "ms": k_ms, "plain_ms": p_ms, "stats": stats,
            "roots": 0 if start is None else kw["packet_roots"].numel()}


def config_a_phases(dev, k2_inputs, usage, res: int = 512,
                    sphere=(64, 128), stack_res: int = 128) -> tuple:
    """Phases 13-15: config A on the K1 route, K2's watertight test and
    K5, and the stack engine. ``k2_inputs``: phase 7's dense BVH16 scene,
    aux rows, incoherent rays and mesh; ``usage``: a future of the
    ``ptxas -v`` reports. Returns the ``kernels`` entries of K2-watertight
    and K5, and K1's launches and largest error in phase 13."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_uv_sphere, merge_meshes)
    from nanort_tpu_torch.models import ao_fused, objrender
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import compare_hits
    from nanort_tpu_torch.traverse import fused_trace, packet

    S = 8
    n_px = res * res
    # ---- 13. config A on the K1 route
    t0 = time.perf_counter()
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(*sphere, 0.6))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    setup_s = time.perf_counter() - t0
    say(f"# phase 13: config A scene {len(f)} tris, native build + BVH16 "
        f"collapse {setup_s:.2f} s: {s16.num_nodes} nodes, "
        f"{s16.num_leaf_rows} leaf rows, depth {s16.depth}, max leaf "
        f"{s16.max_leaf}")
    if sphere == (64, 128):
        check(len(f) == 16_138, f"config A has {len(f)} tris, not 16,138")
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=res,
                  height=res, fov=45.0, device=dev)
    rays = pinhole_rays(cam)
    spec = packet.detect_specialization(rays)
    holder = {}

    def render_k1():
        holder["k1"] = objrender.render_ao(
            bvh, mesh, rays, seed=7, n_samples=S, max_leaf=8, scene8=s16,
            specialize=spec)

    ms_k1, busy_k1, counts = time_calls(render_k1)
    aovs_k1, hits_k1 = holder.pop("k1")
    best = min(ms_k1) / 1e3
    launches_k1 = counts["packet_traverse"]
    say(f"# phase 13: config A on K1, render_ao {res}x{res} x {S} AO "
        f"samples: seconds {[round(t / 1e3, 5) for t in ms_k1]}, best "
        f"{best:.5f} s = {n_px * (1 + S) / best / 1e6:.1f} effective "
        f"Mrays/s; device busy {busy_k1:.4f} of the host wall; hit "
        f"fraction {float(aovs_k1['hit'].float().mean()):.5f}, AO mean over "
        f"hits {float(aovs_k1['ao'][aovs_k1['hit']].mean()):.5f}; launches "
        f"{counts}")
    check(counts == {**{k: 0 for k in counts}, "packet_traverse": 8},
          f"config A on K1: launches {counts}, expected 2 K1 a render")
    ao = aovs_k1["ao"]
    check(tuple(ao.shape) == (res, res) and bool(torch.isfinite(ao).all())
          and 0.0 < float(ao.mean()) < 1.0, "config A: bad AO image")
    held = {}
    for kind, (r, a, kw, got) in zip(("primary", "occlusion"),
                                     capture_traces(render_k1)):
        h = hold_k1_trace(s16, r, a, kw, got)
        held[kind] = h
        say(f"phase 13 K1 {kind} trace: {h['rays']} rays (skip "
            f"{h['skip']}, any-hit {h['occlusion']}), {h['dead']} dead "
            f"(hits among them {h['dead_hits']}), {h['hits']} hits; kernel "
            f"== plain bit for bit: {h['same']}; max abs err {h['err']}; "
            f"kernel {h['ms']:.3f} ms (median of 5), plain "
            f"{h['plain_ms']:.1f} ms; work {h['stats']}")
        check(h["same"], f"config A K1 {kind} trace disagrees with the "
              "plain version")
    check(held["primary"]["rays"] == n_px
          and held["occlusion"]["rays"] == S * n_px
          and held["occlusion"]["skip"] and held["occlusion"]["occlusion"]
          and held["occlusion"]["dead_hits"] == 0,
          f"config A's K1 traces are not the route's: {held}")
    holder.clear()
    torch.cuda.empty_cache()

    # ---- 14. K2 watertight alone, then K5
    d_s8, d_aux, k2_rays, d_mesh = k2_inputs
    nodes, leafs, aux_t, slots = fused_trace._check_tables(d_s8, d_aux, dev)
    first = fused_trace.trace_bvh16(d_s8, k2_rays, intersector="watertight")
    n2 = k2_rays.org.shape[0]
    skip = torch.where(torch.arange(n2, device=dev) % 2 == 0,
                       first.prim_id, -1)

    def k2(occ, sk=None):
        return fused_trace.trace_bvh16(
            d_s8, k2_rays, d_aux, occlusion=occ, want_aux=not occ,
            intersector="watertight", skip=sk)

    def k2_plain(occ, sk=None, stats=None):
        return fused_trace.trace_bvh16_reference(
            nodes, leafs, None if occ else aux_t, k2_rays.org, k2_rays.dir,
            k2_rays.min_t, k2_rays.max_t, occ, slots, stats=stats,
            intersector="watertight", skip=sk)

    k2_stats, k2_err, k2_same = {}, 0.0, True
    for name, occ, sk in (("closest+aux", False, None),
                          ("closest+aux, skip", False, skip),
                          ("occlusion", True, None),
                          ("occlusion, skip", True, skip)):
        got = k2(occ, sk)
        want = k2_plain(occ, sk, k2_stats if name == "closest+aux" else None)
        if occ:
            got, want = (got,), (want,)
        same = all(torch.equal(a, b) for a, b in zip(got, want)
                   if b is not None)
        k2_same &= same
        if not occ:
            k2_err = max(k2_err, max_abs(got.t, want.t, got.hit),
                         max_abs(got.u, want.u), max_abs(got.v, want.v),
                         max_abs(got.normal, want.normal))
        say(f"K2 watertight {name}, {n2} incoherent rays: "
            f"{int(got[0].sum()) if occ else int(got.hit.sum())} "
            f"{'occluded' if occ else 'hits'}; kernel == plain bit for bit: "
            f"{same}")
    check(k2_same, "K2 watertight disagrees with its plain version")
    k2w_ms = median(cuda_ms(lambda: k2(False), 5))
    k2w_skip_ms = median(cuda_ms(lambda: k2(True, skip), 5))
    k2w_plain_ms = min(cuda_ms(lambda: k2_plain(False), 1))
    k2w_bound = bound(n2 * (32 + 36) + nbytes(nodes, leafs, aux_t),
                      trace_ops(k2_stats, 16, WT_OPS))
    say(f"K2 watertight: kernel closest+aux {k2w_ms:.3f} ms, occlusion with "
        f"skip {k2w_skip_ms:.3f} ms (medians of 5); plain {k2w_plain_ms:.1f} "
        f"ms; max abs err {k2_err}; work {k2_stats}, bound "
        f"{k2w_bound[0]:.4f} ms ({k2w_bound[1]})")
    # 1,024 well-formed rays against brute force (the watertight test;
    # K2 rejects a hit at exactly tt == tmax, which these rays never meet)
    good = ((k2_rays.dir.abs().sum(1) > 0)
            & torch.isfinite(k2_rays.org).all(1)).nonzero().squeeze(1)
    sel = good[:: max(1, good.numel() // 1024)][:1024]
    sub = nt.Rays(*(x[sel].contiguous() for x in k2_rays))
    rec = fused_trace.trace_bvh16(d_s8, sub, intersector="watertight")
    got = nt.Hits(rec.t, rec.u, rec.v,
                  torch.where(rec.hit, rec.prim_id.long(), nt.INVALID_PRIM_ID))
    brute = nt.brute_force_traverse(d_mesh, sub)
    c = compare_hits(got, brute)
    occ = fused_trace.trace_bvh16(d_s8, sub, occlusion=True,
                                  intersector="watertight")
    occ_ok = torch.equal(occ, brute.hit)
    say(f"K2 watertight vs brute force on {sel.numel()} rays: {c}; "
        f"occlusion equal to brute hits: {occ_ok}")
    check(c["ok"] and occ_ok, "K2 watertight disagrees with brute force")
    del first, skip, got, want
    torch.cuda.empty_cache()

    # K5 on phase 13's scene, rays and draws (seed 7)
    aux_a = ao_fused.build_ao_aux(mesh, s16)

    def render_k5():
        holder["k5"] = ao_fused.render_ao_fused(mesh, rays, 7, s16, aux_a,
                                                n_samples=S)

    ms_k5, busy_k5, counts = time_calls(render_k5)
    aovs_k5, hits_k5 = holder.pop("k5")
    best5 = min(ms_k5) / 1e3
    launches_k5 = counts["ao_fused"]
    launches_k2w = counts["bvh16_trace_watertight"]
    say(f"# phase 14: config A on K5, render_ao_fused {res}x{res} x {S}: "
        f"seconds {[round(t / 1e3, 5) for t in ms_k5]}, best {best5:.5f} s "
        f"= {n_px * (1 + S) / best5 / 1e6:.1f} effective Mrays/s; device "
        f"busy {busy_k5:.4f} of the host wall; K5/K1 render time "
        f"{best5 / best:.3f}; launches {counts}")
    check(counts == {**{k: 0 for k in counts}, "ao_fused": 4,
                     "bvh16_trace_watertight": 4},
          f"config A on K5: launches {counts}, expected 1 K5 a render")
    # the kernel against its plain version on the full input
    flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in rays]
    draws = objrender.resolve_draws(rays, 7, S, True).reshape(
        S, n_px, 3).contiguous()
    n5, l5, a5, slots5 = fused_trace._check_tables(s16, aux_a, dev)
    args5 = (n5, l5, a5, *flat, draws, 1e30, slots5)
    got5 = ao_fused.ao_fused_outputs(*args5)
    k5_stats = {}
    p5_ms = cuda_ms(lambda: holder.__setitem__(
        "want", ao_fused._ao_fused_reference(*args5, stats=k5_stats)), 1)[0]
    want5 = holder.pop("want")
    names5 = ("ao", "t", "u", "v", "prim_id", "hit")
    frac5 = {k: same_frac(a, b) for k, a, b in zip(names5, got5, want5)}
    k5_err = max(max_abs(got5[0], want5[0]),
                 max_abs(got5[1], want5[1], got5[5]),
                 max_abs(got5[2], want5[2]), max_abs(got5[3], want5[3]))
    k5_ms = median(cuda_ms(lambda: ao_fused.ao_fused_outputs(*args5), 3))
    say(f"K5 on the full {n_px}-pixel x {S}-sample input: bit-identical "
        f"fraction {frac5}; max abs err {k5_err}; kernel {k5_ms:.3f} ms "
        f"(median of 3), plain {p5_ms:.1f} ms; work {k5_stats}")
    check(min(frac5.values()) == 1.0, "K5 disagrees with its plain version")
    # outputs: ao, t, u, v f32, pid, hit i32; inputs: rays, draws, tables
    k5_bound = bound(n_px * (32 + S * 12 + 24) + nbytes(n5, l5, a5),
                     trace_ops(k5_stats, 16, WT_OPS)
                     + k5_stats.get("samples", 0) * AO_OPS)
    say(f"K5 bound {k5_bound[0]:.4f} ms ({k5_bound[1]}) against "
        f"{k5_ms:.3f} ms measured")
    # K5 against phase 13's render under the tie contract
    c = compare_hits(hits_k5, hits_k1)
    same_ao = float((aovs_k5["ao"] == aovs_k1["ao"]).float().mean())
    say(f"K5 vs render_ao (K1 route): {c}; identical AO pixels {same_ao:.5f}")
    check(torch.equal(aovs_k5["hit"], aovs_k1["hit"]) and c["ok"]
          and same_ao >= 0.97, "K5 and render_ao disagree")
    text = usage.result()
    say("ptxas -v (K5, then K2 alone): " + " | ".join(
        " ".join(ln.split()) for ln in text.splitlines()
        if "Used" in ln or "spill" in ln))
    del got5, want5, args5, draws, flat, aovs_k5, hits_k5
    torch.cuda.empty_cache()

    # ---- 15. the stack engine on the card (plain torch, no kernel)
    zero_launch_counts()
    t0 = time.perf_counter()
    aovs_s, hits_s = objrender.render_aovs(bvh, mesh, rays, max_leaf=8)
    torch.cuda.synchronize()
    s_aovs = time.perf_counter() - t0
    c = compare_hits(hits_s, hits_k1)
    say(f"# phase 15: stack engine render_aovs {res}x{res}, {len(f)} tris: "
        f"{s_aovs:.3f} s; against phase 13's K1 primary records: {c}")
    check(c["ok"], "stack render_aovs disagrees with K1")
    # render_ao on the stack engine, cut to stack_res^2 (the lockstep walk
    # syncs with the host every step), against the K1 route
    cam_s = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=stack_res,
                    height=stack_res, fov=45.0, device=dev)
    rays_s = pinhole_rays(cam_s)
    t0 = time.perf_counter()
    ao_s, hao_s = objrender.render_ao(bvh, mesh, rays_s, seed=7,
                                      n_samples=S, max_leaf=8)
    torch.cuda.synchronize()
    s_ao = time.perf_counter() - t0
    counts = launch_counts()
    ao_r, hao_r = objrender.render_ao(bvh, mesh, rays_s, seed=7, n_samples=S,
                                      max_leaf=8, scene8=s16)
    c = compare_hits(hao_s, hao_r)
    same_ao = float((ao_s["ao"] == ao_r["ao"]).float().mean())
    say(f"phase 15: stack engine render_ao {stack_res}x{stack_res} x {S} "
        f"(cut from {res}^2): {s_ao:.3f} s; against the K1 route: {c}, "
        f"identical AO pixels {same_ao:.5f}")
    check(c["ok"] and same_ao >= 0.97, "stack render_ao disagrees with K1")
    check(sum(counts.values()) == 0, f"the stack engine launched {counts}")
    # the graft entry's shape: 16^2 rays, 234 triangles, default build
    gv, gf = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    gmesh = TriangleMesh(torch.from_numpy(gv).to(dev),
                         torch.from_numpy(gf).to(dev))
    gbvh, _ = nt.build_triangle_bvh(TriangleMesh(gv, gf))
    grays = pinhole_rays(look_at(eye=(0.0, 0.0, 2.5), center=(0, 0, 0),
                                 width=16, height=16, fov=60.0, device=dev))
    zero_launch_counts()
    t0 = time.perf_counter()
    gaovs, ghits = objrender.render_aovs(gbvh, gmesh, grays)
    torch.cuda.synchronize()
    s_g = time.perf_counter() - t0
    counts = launch_counts()
    c = compare_hits(ghits, nt.brute_force_traverse(gmesh, grays))
    say(f"phase 15: graft shape render_aovs 16x16, {len(gf)} tris: "
        f"{s_g:.3f} s, rgb {tuple(gaovs['rgb'].shape)}, against brute force: "
        f"{c}; launches {counts}")
    check(len(gf) == 234 and tuple(gaovs["rgb"].shape) == (16, 16, 3)
          and bool(torch.isfinite(gaovs["rgb"]).all()) and c["ok"],
          "graft-shape render_aovs failed")
    check(sum(counts.values()) == 0, f"the stack engine launched {counts}")

    k1_err = max(h["err"] for h in held.values())
    return [{
        "name": "bvh16_trace_watertight",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/bvh16_trace.cuh",
        "replaces": "nanort_tpu/traverse/fused_trace.py:104",
        "launches": launches_k2w,
        "max_abs_err": k2_err,
        "ms": k2w_ms,
        "plain_ms": k2w_plain_ms,
        "bound_ms": k2w_bound[0],
        "bound_by": k2w_bound[1],
        "library_ms": None,
    }, {
        "name": "ao_fused",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/ao_fused.cu",
        "replaces": "nanort_tpu/models/ao_fused.py:42",
        "launches": launches_k5,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": p5_ms,
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None,
    }], launches_k1, k1_err


def span_timer():
    """``(wrap, spans)``: ``wrap(name, fn)`` records CUDA events around
    each call of ``fn``; ``spans()`` synchronises and returns the device
    ms of each name, summed over its calls."""
    import torch

    pending = []

    def wrap(name, fn):
        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            pending.append((name, e0, e1))
            return out

        return timed

    def spans():
        torch.cuda.synchronize()
        out = {}
        for name, e0, e1 in pending:
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1)
        return out

    return wrap, spans


def incoherent_phases(dev, n_tris: int = 1_000_000, R: int = 4_194_304,
                      n_treelets: int = 1024, res: int = 1024,
                      hold_packets: int = 64, hold_rays: int = 131_072
                      ) -> tuple:
    """Phases 16 and 17: the incoherent-ray workloads of
    ``bench_matrix.py:322-411`` (the defaults are theirs). Returns the
    ``packet_traverse[roots]`` entry of the ``kernels`` line, phase 16's
    BVH8 scene (on the card) and its random rays, and phase 17's
    watertight K1 launches and largest error."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import make_subdivided_sphere_scene
    from nanort_tpu_torch.models import objrender
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import compare_hits
    from nanort_tpu_torch.traverse import packet, ray_sort, treelet

    # ---- 16. incoherent random: the treelet-binned engine
    t0 = time.perf_counter()
    v, f = make_subdivided_sphere_scene(n_tris)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s8h = collapse_bvh8(bvh, v, f)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tl, s8h = treelet.make_treelets(s8h, n_treelets)
    tl_s = time.perf_counter() - t0
    s8 = s8h.to(dev)
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(bvh.bmin[0]), np.asarray(bvh.bmax[0])
    org = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = nt.make_rays(torch.from_numpy(org).to(dev),
                        torch.from_numpy(d.astype(np.float32)).to(dev))
    del org, d
    say(f"# phase 16: {len(f)} tris, leaf 8, BVH8 {s8.num_nodes} nodes, "
        f"{s8.num_leaf_rows} leaf rows, depth {s8.depth}; scene + build + "
        f"collapse {build_s:.2f} s; make_treelets({n_treelets}) {tl_s:.2f} s: "
        f"{tl.count} treelets, {s8.nodes.shape[0] - s8.num_nodes - 1} "
        f"synthetic rows; {R} random rays (seed 11)")
    # the greedy frontier stops where no split fits the target
    check(len(f) >= 0.95 * n_tris and n_treelets - 8 < tl.count <= n_treelets,
          f"phase 16 scene: {len(f)} tris, {tl.count} treelets")
    kw = dict(treelets=tl, K=8, octant_major=True, sub=16)
    holder = {}

    def run():
        holder["h"] = treelet.traverse_bvh8_binned(s8, rays, **kw)

    zero_launch_counts()
    run()
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    launches = counts["packet_traverse[roots]"]
    h = holder.pop("h")
    best = min(secs)
    say(f"# phase 16: traverse_bvh8_binned(K=8, octant_major, sub=16) "
        f"seconds {[round(s, 4) for s in secs]}, best {best:.4f} s = "
        f"{R / best / 1e6:.2f} Mrays/s; hits {int(h.hit.sum())}; launches "
        f"{counts}")
    check(launches >= 8 and sum(counts.values()) == launches,
          f"phase 16 launches {counts}")

    # layer split of one more run, CUDA events around each stage
    wrap, spans = span_timer()
    names = (("_morton_presort", "Morton sort"),
             ("_treelet_klists", "dense K-lists"),
             ("_pair_order", "pair order"), ("_pair_fill", "pair fill"),
             ("_pair_merge", "merge"),
             ("_completion_sweep", "completion sweep"))
    with contextlib.ExitStack() as stack:
        for attr, name in names:
            stack.enter_context(patched(treelet, attr,
                                        wrap(name, getattr(treelet, attr))))
        stack.enter_context(patched(packet, "traverse_bvh8", wrap(
            "K1 with roots", packet.traverse_bvh8)))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        split = spans()
    total = e0.elapsed_time(e1)
    top = sum(v for k, v in split.items() if k != "completion sweep")
    say("phase 16 layer split (device ms of one run; the completion "
        "sweep's K-lists, pairs and K1 are counted in their rows too): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f", other {total - top:.2f}; total {total:.2f}")

    # the records against global K1 on the same rays (t bit-equal)
    glob = packet.traverse_bvh8(s8, rays)
    c = compare_hits(h, glob, t_ulps=0)
    say(f"phase 16 binned vs global traverse_bvh8: {c}; t bit-equal "
        f"{torch.equal(h.t, glob.t)}")
    check(c["ok"] and torch.equal(h.t, glob.t),
          "binned records disagree with global K1")
    del h, glob
    g_ms = median(cuda_ms(lambda: packet.traverse_bvh8(s8, rays), 5))
    s_ms = median(cuda_ms(lambda: ray_sort.traverse_bvh8_sorted(s8, rays), 3))
    say(f"phase 16 yardsticks on the same rays: global K1 unsorted "
        f"{g_ms:.3f} ms = {R / g_ms / 1e3:.1f} Mrays/s; "
        f"traverse_bvh8_sorted {s_ms:.3f} ms; binned / global "
        f"{best * 1e3 / g_ms:.1f}x")

    # one round-1 K1 launch, its first 64 packets held to the plain version
    kept = capture_traces(run)
    say("phase 16 K1 launches of one run (slots, packets): "
        + ", ".join(f"{r.org.shape[0]} / {k['packet_roots'].shape[0]}"
                    for r, _, k, _ in kept))
    r1, a1, k1kw, out1 = kept[0]
    held = hold_k1_trace(s8, r1, a1, k1kw, out1,
                         hold_packets * 16 * packet.LANES)
    # the slice's packets reach a few of the 1,023 treelet subtrees: only
    # the rows its rays read count, not the whole tables
    roots_bound = bound(held["rays"] * (32 + 20) + row_bytes(held["stats"])
                        + 4 * held["roots"],
                        trace_ops(held["stats"], 8, WT_OPS))
    say(f"phase 16 round-1 launch, first {hold_packets} packets "
        f"({held['rays']} slots, "
        f"{held['dead']} padding, {held['hits']} hits): kernel == plain "
        f"with the same roots bit for bit: {held['same']}; max abs err "
        f"{held['err']}; kernel {held['ms']:.3f} ms (median of 5), plain "
        f"{held['plain_ms']:.1f} ms; work {held['stats']}; bound "
        f"{roots_bound[0]:.4f} ms ({roots_bound[1]})")
    check(held["same"], "K1 with roots disagrees with its plain version")
    # the run's 3 launches: the slice's work scaled by their slots (the
    # slice is 131,072 of them), the rows read at most the whole tables
    slots = sum(r.org.shape[0] for r, _, _, _ in kept)
    scale = slots / held["rays"]
    run_stats = {k: v * scale for k, v in held["stats"].items()}
    run_bound = bound(
        slots * (32 + 20) + 4 * sum(k["packet_roots"].numel()
                                    for _, _, k, _ in kept)
        + min(row_bytes(held["stats"]) * scale, nbytes(s8.nodes, s8.leafs)),
        trace_ops(run_stats, 8, WT_OPS))
    say(f"phase 16 K1 with roots over the run's {len(kept)} launches "
        f"({slots} slots; the slice's work x {scale:.2f}, by slots): bound "
        f"{run_bound[0]:.4f} ms ({run_bound[1]}) against "
        f"{split['K1 with roots']:.2f} ms measured")
    del kept, r1, out1
    torch.cuda.empty_cache()

    # ---- 17. incoherent bounce: AO rays off 1024^2 primaries, sorted
    cam = look_at(eye=(0, 0, 2.2), center=(0, 0, 0), width=res,
                  height=res, fov=60.0, device=dev)
    rays_p, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 32)
    hp = packet.traverse_bvh8(s8, rays_p, specialize=packet.detect_specialization(
        rays_p))
    hitm = hp.hit
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev).long())
    S = 4
    n = objrender.face_normals(mesh, hp.prim_id)
    x = rays_p.org + rays_p.dir * hp.t[:, None]
    n = torch.where((n * rays_p.dir).sum(-1, keepdim=True) > 0, -n, n)
    t_o, b_o = objrender.build_onb(n)
    local = objrender._cosine_hemisphere(
        torch.Generator(device=dev).manual_seed(3), (S, n.shape[0]),
        torch.float32, dev)
    wdir = (local[..., 0:1] * t_o + local[..., 1:2] * b_o
            + local[..., 2:3] * n)
    borg = (x + n * 1e-3).expand(S, -1, -1).reshape(-1, 3)
    bmax = torch.where(hitm.expand(S, -1).reshape(-1), 0.5, -1.0)
    brays = nt.make_rays(borg, wdir.reshape(-1, 3), max_t=bmax)
    RB = brays.org.shape[0]
    del x, n, t_o, b_o, local, wdir, borg

    def run_ao():
        holder["hb"] = ray_sort.traverse_bvh8_sorted(s8, brays,
                                                     occlusion=True)

    ms, busy, counts = time_calls(run_ao)
    hb = holder.pop("hb")
    live = brays.max_t > brays.min_t
    best = min(ms) / 1e3
    say(f"# phase 17: {RB} AO rays ({res}^2 primaries x {S}, hit fraction "
        f"{float(hitm.float().mean()):.5f}, {int(live.sum())} live), "
        f"traverse_bvh8_sorted(occlusion=True) ms "
        f"{[round(t, 3) for t in ms]}, best {best * 1e3:.3f} ms = "
        f"{RB / best / 1e6:.1f} Mrays/s; device busy {busy:.4f}; occluded "
        f"{int(hb.hit.sum())}; launches {counts}")
    check(counts["packet_traverse"] == 4 and sum(counts.values()) == 4,
          f"phase 17 launches {counts}")
    check(not bool(hb.hit[~live].any()), "a dead AO ray hit")
    (sr, sa, skw, sout), = capture_traces(run_ao)
    held_b = hold_k1_trace(s8, sr, sa, skw, sout, hold_rays)
    say(f"phase 17 sorted trace, first {held_b['rays']} rays ({held_b['hits']} "
        f"occluded): kernel == plain bit for bit: {held_b['same']}; max abs "
        f"err {held_b['err']}; kernel {held_b['ms']:.3f} ms, plain "
        f"{held_b['plain_ms']:.1f} ms; work {held_b['stats']}")
    check(held_b["same"], "the phase-17 trace disagrees with the plain version")
    launches_17 = counts["packet_traverse"]
    del brays, hb, sr, sout, rays_p, hp, mesh
    torch.cuda.empty_cache()
    entry = {
        "name": "packet_traverse[roots]",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:256",
        "launches": launches,
        "max_abs_err": held["err"],
        "ms": held["ms"],
        "plain_ms": held["plain_ms"],
        "bound_ms": roots_bound[0],
        "bound_by": roots_bound[1],
        "library_ms": None,
    }
    return entry, s8, rays, launches_17, held_b["err"]


def edge_rays(dev, n: int):
    """Phase 18's axis-aligned case, ``testing.zero_edge_rays``: the
    Cornell box (leaf 2, BVH8) on the card and ``n`` rays parallel to z
    onto its back wall's diagonal, whose edge functions round to 0."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import zero_edge_rays

    v, f, org, d = zero_edge_rays(n)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2))
    return (collapse_bvh8(bvh, v, f).to(dev),
            nt.make_rays(torch.from_numpy(org).to(dev),
                         torch.from_numpy(d).to(dev)))


def k1_mode_phases(dev, scene, sub, s8i, rays_i, usage_k1, res: int = 8192,
                   n_edge: int = 65_536) -> tuple:
    """Phase 18: K1's counters, zero-edge flags and K1b on the card.
    ``scene``/``sub``: phase 4's BVH16 scene and phase 5's 131,072 rays;
    ``s8i``/``rays_i``: phase 16's BVH8 scene and random rays;
    ``usage_k1``: a future of K1's ``ptxas -v`` report. Returns the
    entries of the ``kernels`` line and the frame's bound from the
    counters."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.traverse import packet

    m2 = sub.org.shape[0]
    slots = packet.stack_slots(scene)
    tables = nbytes(scene.nodes, scene.leafs)
    fast = nt.BVHTraceOptions(exact_edge_fallback=False)

    def plain(**k):
        stats = {}
        holder = {}

        def run():
            holder["out"] = packet._traverse_reference(
                scene.nodes, scene.leafs, 16, sub.org, sub.dir, sub.min_t,
                sub.max_t, None, None, False,
                k.get("exact", True), False, slots, stats=stats,
                debug_counts=k.get("debug_counts", False),
                flag_zero_edges=k.get("flags", False))

        ms = cuda_ms(run, 1)[0]
        return holder["out"], ms, stats

    def kernel_ms(**k):
        return median(cuda_ms(lambda: packet.traverse_bvh8(scene, sub, **k),
                              10))

    # ---- 18. counters: phase 5's rays, then the 8192^2 frame
    got = packet.traverse_bvh8(scene, sub, debug_counts=True)
    want, c_plain_ms, st = plain(debug_counts=True)
    c_same = all(torch.equal(a, b) for a, b in zip(got, want))
    c_err = record_err(list(got), want)
    c_ms = kernel_ms(debug_counts=True)
    base_ms = kernel_ms()
    sums = (int(got.u.sum()), int(got.v.sum()))
    check(c_same and sums == (st["nodes"], st["leaves"]),
          "the counts kernel disagrees with its plain version")
    tris_per_leaf = st["tris"] / max(st["leaves"], 1)
    c_bound = bound(m2 * (32 + 20) + row_bytes(st),
                    (sums[0] * 16 * SLAB_OPS
                     + sums[1] * tris_per_leaf * WT_OPS))
    say(f"# phase 18 counters on phase 5's {m2} rays: kernel == plain bit "
        f"for bit: {c_same}; node pops {sums[0]}, leaf pops {sums[1]} "
        f"(plain stats {st}); counts kernel {c_ms:.3f} ms vs plain K1 "
        f"{base_ms:.3f} ms (medians of 10); plain {c_plain_ms:.1f} ms; bound "
        f"{c_bound[0]:.4f} ms ({c_bound[1]})")
    del got, want
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res, height=res,
                  fov=60.0, device=dev)
    rays_t, _ = packet.tile_image_rays(pinhole_rays(cam), min(128, res), 64)
    spec = packet.detect_specialization(rays_t, sub=packet.DEF_SUB)
    zero_launch_counts()
    holder = {}

    def frame_counts():
        holder["c"] = packet.traverse_bvh8(scene, rays_t, specialize=spec,
                                           debug_counts=True)

    f_ms = cuda_ms(frame_counts, 1)[0]
    counts_launches = launch_counts()["packet_traverse[counts]"]
    fc = holder.pop("c")
    f_nodes = int(fc.u.double().sum())
    f_leaves = int(fc.v.double().sum())
    f_ops = f_nodes * 16 * SLAB_OPS + f_leaves * tris_per_leaf * WT_OPS
    frame_bound = bound(res * res * (32 + 20) + tables, f_ops)
    say(f"phase 18 {res}^2 frame counters ({counts_launches} launch, "
        f"{f_ms:.3f} ms): node pops {f_nodes}, leaf pops {f_leaves} "
        f"(x {tris_per_leaf:.3f} tris a leaf pop, phase 5's plain ratio) "
        f"-> {f_ops / 1e9:.3f} G operations; frame bound "
        f"{frame_bound[0]:.4f} ms ({frame_bound[1]})")
    check(counts_launches == 1 and f_nodes > 0, "frame counters")
    del fc

    # ---- 18. interleave: the frame, phase 16's rays, phase 5's rays
    zero_launch_counts()
    il = {}
    for what, s, r, kw in ((f"{res}^2 frame", scene, rays_t,
                            dict(specialize=spec)),
                           ("phase 16 random", s8i, rays_i, {})):
        ref = packet.traverse_bvh8(s, r, **kw)
        line = []
        for K in (1, 2, 4):
            out = packet.traverse_bvh8(s, r, interleave=K, **kw)
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            ms = median(cuda_ms(lambda: packet.traverse_bvh8(
                s, r, interleave=K, **kw), 3))
            il[(what, K)] = ms
            line.append(f"K={K} {ms:.3f} ms (same as K=1: {same})")
            check(same, f"interleave={K} on the {what} changes records")
            del out
        say(f"phase 18 interleave on the {what} ({r.org.shape[0]} rays, "
            f"medians of 3): " + "; ".join(line))
        del ref
    il_launches = launch_counts()
    del rays_t
    torch.cuda.empty_cache()
    want, p_ms, st5 = plain()
    k_bound = bound(m2 * (32 + 20) + row_bytes(st5),
                    trace_ops(st5, 16, WT_OPS))
    il_entries = []
    for K in (2, 4):
        got = packet.traverse_bvh8(scene, sub, interleave=K)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = record_err(list(got), want)
        ms = kernel_ms(interleave=K)
        say(f"phase 18 interleave={K} on phase 5's rays: kernel == plain bit "
            f"for bit: {same}; {ms:.3f} ms vs K=1 {base_ms:.3f} ms (medians "
            f"of 10); launches on the frame and phase 16's rays "
            f"{il_launches[f'packet_traverse[interleave={K}]']}")
        check(same, f"interleave={K} disagrees with the plain version")
        il_entries.append({
            "name": f"packet_traverse[interleave={K}]",
            "route": "cuda",
            "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
            "replaces": "nanort_tpu/traverse/pallas_packet.py:1060",
            "launches": il_launches[f"packet_traverse[interleave={K}]"],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": k_bound[0],
            "bound_by": k_bound[1],
            "library_ms": None,
        })
    del got, want

    # ---- 18. zero-edge flags: phase 5's rays, then the axis-aligned case
    (fh, fl) = packet.traverse_bvh8(scene, sub, fast, _flag_zero_edges=True)
    want, f_plain_ms, st_f = plain(exact=False, flags=True)
    f_same = (all(torch.equal(a, b) for a, b in zip(fh, want[:4]))
              and torch.equal(fl, want[4]))
    f_err = max(record_err(list(fh), want), max_abs(fl, want[4]))
    fl_ms = kernel_ms(options=fast, _flag_zero_edges=True)
    exact = packet.traverse_bvh8(scene, sub)
    differ = torch.zeros_like(fl, dtype=torch.bool)
    for a, b in zip(fh, exact):
        differ |= a != b
    sound = not bool((differ & (fl == 0)).any())
    say(f"# phase 18 flags on phase 5's {m2} rays: kernel == plain bit for "
        f"bit: {f_same}; flagged {int(fl.sum())}, records changed by the "
        f"recompute {int(differ.sum())}, all flagged: {sound}; flags kernel "
        f"{fl_ms:.3f} ms vs exact K1 {base_ms:.3f} ms; plain "
        f"{f_plain_ms:.1f} ms")
    check(f_same and sound, "the flags kernel is wrong on phase 5's rays")
    f_bound = bound(m2 * (32 + 24) + row_bytes(st_f),
                    trace_ops(st_f, 16, WT_OPS))
    del fh, fl, want, exact
    box, erays = edge_rays(dev, n_edge)
    hb, fb = packet.traverse_bvh8(box, erays, fast, _flag_zero_edges=True)
    wb = packet._traverse_reference(
        box.nodes, box.leafs, 8, erays.org, erays.dir, erays.min_t,
        erays.max_t, None, None, False, False, False,
        packet.stack_slots(box), flag_zero_edges=True)
    e_same = (all(torch.equal(a, b) for a, b in zip(hb, wb[:4]))
              and torch.equal(fb, wb[4]))
    e_err = max(record_err(list(hb), wb), max_abs(fb, wb[4]))
    eb = packet.traverse_bvh8(box, erays)
    differ = torch.zeros_like(fb, dtype=torch.bool)
    for a, b in zip(hb, eb):
        differ |= a != b
    sound = not bool((differ & (fb == 0)).any())
    say(f"phase 18 flags on the axis-aligned case (Cornell box, {n_edge} "
        f"z-parallel rays onto the back wall's diagonal): kernel == plain "
        f"(records and flags) bit for bit: {e_same}; max abs err {e_err}; "
        f"flagged {int(fb.sum())} (plain {int(wb[4].sum())}), changed by "
        f"the recompute {int(differ.sum())}, all flagged: {sound}")
    check(e_same and sound and int(fb.sum()) > 0,
          "the flags kernel is wrong on the axis-aligned case")
    del wb
    zero_launch_counts()
    lines = []
    for what, s, r in (("phase 5", scene, sub), ("axis-aligned", box, erays)):
        single = packet.traverse_bvh8(s, r)
        for name, fn in (
                ("exact", lambda: packet.traverse_bvh8_exact(s, r)),
                ("exact_fused", lambda: packet.traverse_bvh8_exact_fused(s, r))):
            out = fn()
            ovf = False
            if name == "exact_fused":
                out, ovf = out
                ovf = bool(ovf)
            same = all(torch.equal(a, b) for a, b in zip(out, single))
            ms = median(cuda_ms(fn, 5))
            lines.append(f"{what} {name} {ms:.3f} ms, == single-pass exact "
                         f"{same} (overflow {ovf})")
            check(same or ovf, f"{name} on {what} differs from single pass")
        lines.append(f"{what} single-pass exact {median(cuda_ms(lambda: packet.traverse_bvh8(s, r), 5)):.3f} ms")
    flags_launches = launch_counts()["packet_traverse[flags]"]
    say("phase 18 two-pass exact (medians of 5): " + "; ".join(lines)
        + f"; flags launches {flags_launches}")
    text = usage_k1.result()
    say("ptxas -v (K1, all instantiations): " + " | ".join(
        " ".join(ln.split()) for ln in text.splitlines()
        if "Compiling" in ln or "Used" in ln or "spill" in ln))

    def entry(name, replaces, launches, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda",
                "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    entries = [entry("packet_traverse[counts]",
                     "nanort_tpu/traverse/pallas_packet.py:556",
                     counts_launches, c_err, c_ms, c_plain_ms, c_bound),
               entry("packet_traverse[flags]",
                     "nanort_tpu/traverse/pallas_packet.py:376",
                     flags_launches, max(f_err, e_err), fl_ms, f_plain_ms,
                     f_bound)]
    return entries + il_entries, frame_bound


def time_calls(fn):
    """``fn()`` once to warm up and 3 times timed with CUDA events, the
    launch counts zeroed first. Returns the 3 times in ms, the device's
    share of their host wall time, and every kernel's launches over the
    4 calls."""
    import torch

    zero_launch_counts()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = cuda_ms(fn, 3)
    busy = sum(ms) / ((time.perf_counter() - t0) * 1e3)
    return ms, busy, launch_counts()


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from nanort_tpu_torch.models import ao_fused, pt_fused
    from nanort_tpu_torch.traverse import fused_trace, packet

    return {**packet.LAUNCHES, **fused_trace.LAUNCHES, **pt_fused.LAUNCHES,
            "ao_fused": ao_fused.LAUNCHES}


def zero_launch_counts():
    from nanort_tpu_torch.models import ao_fused, pt_fused
    from nanort_tpu_torch.traverse import fused_trace, packet

    ao_fused.LAUNCHES = 0
    for counts in (packet.LAUNCHES, fused_trace.LAUNCHES, pt_fused.LAUNCHES):
        for k in counts:
            counts[k] = 0


def time_render(scene, rays, **kw):
    """``render_path_traced(seed=3, spp=100, max_bounces=10, **kw)``: one
    warm-up and 3 repetitions timed with CUDA events (``time_calls``).
    Returns the last image, the 3 times in ms, the device's share of the
    3 calls' host wall time and every kernel's launches across the 4
    renders."""
    from nanort_tpu_torch.models import path_tracer

    holder = {}

    def run():
        holder["img"] = path_tracer.render_path_traced(
            scene, rays, 3, spp=100, max_bounces=10, **kw)

    ms, busy, counts = time_calls(run)
    return holder["img"], ms, busy, counts


def report_render(what, img, ms, busy, launches, expect):
    """Print and check one full-size render; ``expect``: the launches of
    each kernel the path must make (every other kernel: none)."""
    import torch

    samples = 512 * 512 * 100
    best = min(ms) / 1e3
    say(f"# {what}: 512x512 x 100 spp x 10 bounces, seconds "
        f"{[round(t / 1e3, 4) for t in ms]}, best {best:.4f} s = "
        f"{samples / best / 1e6:.1f} Msamples/s; device busy {busy:.4f} of "
        f"the host wall; image mean {float(img.mean())}; launches "
        f"{launches}")
    check(tuple(img.shape) == (512, 512, 3), f"{what}: image shape")
    check(bool(torch.isfinite(img).all()), f"{what}: NaN or inf in the image")
    check(float(img.mean()) > 0.0, f"{what}: black image")
    want = {k: expect.get(k, 0) for k in launches}
    check(launches == want, f"{what}: launches {launches}, expected {want}")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build import native
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_subdivided_sphere_scene, make_uv_sphere,
        merge_meshes)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import (
        TriangleMesh, gather_triangle_vertices, intersect_triangles,
        ray_coeffs)
    from nanort_tpu_torch.testing import compare_hits
    from nanort_tpu_torch.traverse import _ext, packet

    dev = torch.device("cuda", 0)

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"# phase 1: card {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)

    # ---- 2. builds (and, beside them, the ptxas reports of K5 and K2)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    # first the report that phase 7 prints, the others by phases 14, 18
    usage_pt = pool.submit(lambda: _ext.resource_usage("pt_fused"))
    usage = pool.submit(lambda: _ext.resource_usage("ao_fused")
                        + _ext.resource_usage("bvh16_trace"))
    usage_k1 = pool.submit(lambda: _ext.resource_usage("packet_traverse"))
    t0 = time.perf_counter()
    k_build = _ext.load_all()
    k_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    has_native = native.native_available()
    n_build = time.perf_counter() - t0
    say(f"# phase 2: kernels built in parallel (nvcc sm_90a, --fmad=false) "
        f"in {k_wall:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in k_build.items())
        + f"; native SAH builder (g++) "
        f"{'ready' if has_native else 'UNAVAILABLE'} in {n_build:.2f} s")
    check(has_native, "the native SAH builder did not build")

    # ---- 3. small-scene parity against brute force on the card
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    bvh, _ = nt.build_triangle_bvh(
        TriangleMesh(v, f),
        nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    rng = np.random.default_rng(5)
    n = 3000
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = nt.make_rays(torch.from_numpy(org).to(dev),
                        torch.from_numpy(d).to(dev))
    dorg, ddir = org.copy(), d.copy()  # degenerate batch: 1 in 4 broken
    dorg[0::12, 0] = np.nan
    ddir[3::12] = 0.0
    ddir[6::12, 1] = np.inf
    ddir[9::12, 2] = 3.1e38  # finite, above the 3e38 threshold
    drays = nt.make_rays(torch.from_numpy(dorg).to(dev),
                         torch.from_numpy(ddir).to(dev))
    closest = nt.brute_force_traverse(mesh, rays)
    modes = [
        ("closest", rays, nt.BVHTraceOptions(), None),
        ("skip", rays, nt.BVHTraceOptions(), closest.prim_id),
        ("cull", rays, nt.BVHTraceOptions(cull_back_face=True), None),
        ("range", rays, nt.BVHTraceOptions(prim_ids_range=(100, 900)), None),
        ("degenerate", drays, nt.BVHTraceOptions(), None),
    ]
    say(f"# phase 3: {len(f)} tris, {n} seeded rays; tolerance: equal hit "
        f"masks, equal prim ids except at bit-equal t, t within 4 ulp, "
        f"u/v within 2e-06")
    # degenerate rays must miss with t = +inf; the oracle does not
    # sanitize them, so it is held to the well-formed rays only
    bad = ~(torch.isfinite(drays.org).all(1) & (drays.dir.abs() < 3e38).all(1)
            & (drays.dir.abs().sum(1) > 0))
    for width in (16, 8):
        scene = collapse_bvh8(bvh, v, f, width=width).to(dev)
        for name, r, opts, skip in modes:
            got = packet.traverse_bvh8(scene, r, opts, skip_prim_id=skip)
            want = nt.brute_force_traverse(mesh, r, opts, skip_prim_id=skip)
            if name == "degenerate":
                inert = bool((~got.hit[bad]).all()
                             and torch.isposinf(got.t[bad]).all())
                got = nt.Hits(*(x[~bad] for x in got))
                want = nt.Hits(*(x[~bad] for x in want))
            c = compare_hits(got, want)
            if name == "degenerate":
                c["degenerate_inert"] = inert
                c["ok"] &= inert
            check(c["ok"], f"parity w{width} {name}: {c}")
            say(f"parity w{width} {name:10s} {c}")
        # any-hit: same hit mask as closest-hit; each reported (t, prim)
        # is a genuine intersection of that ray and that triangle
        got = packet.traverse_bvh8(scene, rays, occlusion=True)
        c = compare_hits(got, closest, t_ulps=2**31)
        h = got.hit
        p0, p1, p2 = gather_triangle_vertices(mesh.vertices,
                                              mesh.faces[got.prim_id[h]])
        co = ray_coeffs(rays.dir[h])
        ok, tt, _, _ = intersect_triangles(
            co, rays.org[h], rays.min_t[h], rays.max_t[h], p0, p1, p2)
        genuine = bool(ok.all()) and torch.equal(tt, got.t[h])
        check(c["hit_mismatch"] == 0 and genuine,
              f"parity w{width} any-hit: {c}, genuine={genuine}")
        say(f"parity w{width} any-hit    hit_mismatch={c['hit_mismatch']} "
            f"hits={c['hits']} genuine={genuine}")

    # ---- 4. the main-path scene
    t0 = time.perf_counter()
    v, f = make_subdivided_sphere_scene(1_000_000)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh, stats = nt.build_triangle_bvh(
        TriangleMesh(v, f),
        nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_h = collapse_bvh8(bvh, v, f, width=16)
    collapse_s = time.perf_counter() - t0
    scene = scene_h.to(dev)
    mb = (scene_h.nodes.nbytes + scene_h.leafs.nbytes) / 1e6
    say(f"# phase 4: scene {len(f)} tris (generated in {gen_s:.2f} s); "
        f"builder {'native' if has_native else 'numpy'}: {build_s:.2f} s "
        f"({len(f) / build_s / 1e6:.2f} Mtris/s), {bvh.num_nodes} binary "
        f"nodes, depth {stats.max_tree_depth}; collapse_bvh8(width=16) "
        f"{collapse_s:.2f} s: {scene.num_nodes} nodes, {scene.num_leaf_rows} "
        f"leaf rows, depth {scene.depth}, max leaf {scene.max_leaf}, "
        f"tables {mb:.1f} MB")
    check(len(f) >= 990_000, "scene is not ~1M triangles")
    check(has_native and build_s < 60, "the 1M-tri build did not go native")

    # ---- 5. kernel == plain version at full scene size
    res = 8192
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res, height=res,
                  fov=60.0, device=dev)
    rays_t, untile = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    m = 65536
    g = np.random.default_rng(7)
    iorg = g.uniform(-1.5, 1.5, (m, 3)).astype(np.float32)
    idir = g.normal(size=(m, 3))
    idir = (idir / np.linalg.norm(idir, axis=1, keepdims=True)).astype(np.float32)
    sub = nt.Rays(
        torch.cat([rays_t.org[:m], torch.from_numpy(iorg).to(dev)]),
        torch.cat([rays_t.dir[:m], torch.from_numpy(idir).to(dev)]),
        torch.cat([rays_t.min_t[:m], torch.zeros(m, device=dev)]),
        torch.cat([rays_t.max_t[:m], torch.full((m,), 3.4e38, device=dev)]),
    )
    slots = packet.stack_slots(scene)

    def plain(rays=sub, stats=None):
        return packet._traverse_reference(
            scene.nodes, scene.leafs, 16, rays.org, rays.dir, rays.min_t,
            rays.max_t, None, None, False, True, False, slots, stats=stats)

    k1_stats = {}
    got = packet.traverse_bvh8(scene, sub)
    ref = plain(stats=k1_stats)
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    fin = torch.isfinite(got.t) & torch.isfinite(ref[0])
    max_abs = max(float((got.t - ref[0])[fin].abs().max()),
                  float((got.u - ref[1]).abs().max()),
                  float((got.v - ref[2]).abs().max()))
    k_ms = cuda_ms(lambda: packet.traverse_bvh8(scene, sub), 10)
    p_ms = cuda_ms(plain, 2)
    kernel_ms, plain_ms = sorted(k_ms)[len(k_ms) // 2], min(p_ms)
    say(f"# phase 5: {2 * m} rays ({m} tiled camera + {m} incoherent), "
        f"{int(got.hit.sum())} hits; kernel == plain bit for bit: {same}; "
        f"max abs err {max_abs}; kernel {kernel_ms:.3f} ms (median of 10), "
        f"plain {plain_ms:.1f} ms (best of 2)")
    check(same, "kernel and plain version disagree at full scene size")
    tables = nbytes(scene.nodes, scene.leafs)
    k1_bound = bound(2 * m * (32 + 20) + row_bytes(k1_stats),
                     trace_ops(k1_stats, 16, WT_OPS))
    say(f"phase 5 work (plain version's count): {k1_stats}; bound "
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]})")
    # the frame's work, counted on every 1,024th ray of the tiled frame
    frame_stats = {}
    plain(nt.Rays(*(x[::1024].contiguous() for x in rays_t)), frame_stats)
    frame_bound = bound(res * res * (32 + 20) + tables,
                        trace_ops(frame_stats, 16, WT_OPS) * 1024)
    say(f"8192^2 frame work (every 1,024th ray, x1024): {frame_stats}; "
        f"bound {frame_bound[0]:.4f} ms ({frame_bound[1]})")

    # ---- 6. the main path, 8192^2
    del rays_t, untile, got, ref  # sub: phase 5's rays, for phase 18
    torch.cuda.empty_cache()
    stage_ms = {}

    def stage(name, fn):
        stage_ms[name] = cuda_ms(lambda: holder.__setitem__(name, fn()), 1)[0]
        return holder[name]

    holder = {}
    zero_launch_counts()
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res, height=res,
                  fov=60.0, device=dev)
    rays = stage("pinhole_rays", lambda: pinhole_rays(cam))
    rays_t, untile = stage("tile_image_rays",
                           lambda: packet.tile_image_rays(rays, 128, 64))
    spec = stage("detect_specialization", lambda: packet.detect_specialization(
        rays_t, sub=packet.DEF_SUB))
    stage("traverse_bvh8 (warm-up)",
          lambda: packet.traverse_bvh8(scene, rays_t, specialize=spec))

    def frame():
        holder["h"] = packet.traverse_bvh8(scene, rays_t, specialize=spec)

    ms = cuda_ms(frame, 3)
    hits = stage("untile", lambda: untile(holder["h"]))
    counts = launch_counts()
    launches = counts["packet_traverse"]
    say("stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    n_rays = res * res
    mrays = [n_rays / (t * 1e-3) / 1e6 for t in ms]
    frac = float(hits.hit.float().mean())
    r_img = 1.0 / math.sqrt(2.2 ** 2 - 1.0)  # disc radius on the z=-1 plane
    expect = math.pi * r_img ** 2 / (2.0 * math.tan(math.radians(30.0))) ** 2
    say(f"# phase 6: {n_rays} rays, specialization {spec}; traverse_bvh8 "
        f"ms {[round(t, 3) for t in ms]} -> Mrays/s best {max(mrays):.1f} "
        f"median {sorted(mrays)[1]:.1f}; hit fraction {frac:.5f} (disc "
        f"coverage {expect:.5f}); LAUNCHES {launches}; plain version on the "
        f"{2 * m}-ray subset {plain_ms:.1f} ms vs kernel {kernel_ms:.3f} ms")
    h = hits.hit
    check(tuple(hits.t.shape) == (res, res), "frame hits have the wrong shape")
    check(launches >= 4 and sum(counts.values()) == launches,
          f"main path launches {counts}")
    check(abs(frac - expect) < 5e-3, "hit fraction far from disc coverage")
    check(bool(torch.isfinite(hits.t[h]).all() and (hits.t[h] > 0).all()),
          "non-finite or non-positive t on a hit")
    uv_ok = (hits.u[h] >= -1e-6) & (hits.v[h] >= -1e-6) & (
        hits.u[h] + hits.v[h] <= 1 + 1e-5)
    check(bool(uv_ok.all()), "barycentrics outside the triangle")
    pick = torch.from_numpy(
        np.random.default_rng(11).choice(n_rays, 1024, replace=False)).to(dev)
    fr = nt.Rays(*(x.reshape(n_rays, *x.shape[2:])[pick] for x in rays))
    fh = nt.Hits(*(x.reshape(n_rays)[pick] for x in hits))
    c = compare_hits(fh, nt.brute_force_traverse(
        TriangleMesh(torch.from_numpy(v).to(dev), torch.from_numpy(f).to(dev)),
        fr, chunk_size=8192))
    say(f"frame sample vs brute force (1024 pixels): {c}")
    check(c["ok"], "full-frame sample disagrees with brute force")

    # phase 4's scene and phase 5's rays stay for phase 18
    del rays, rays_t, untile, hits, holder, scene_h, bvh, fr, fh
    torch.cuda.empty_cache()
    k2k5, launches_pt, err_pt, k2_inputs = path_tracer_phases(dev, usage_pt)
    torch.cuda.empty_cache()
    entries_a, launches_a, err_a = config_a_phases(dev, k2_inputs, usage)
    del k2_inputs
    torch.cuda.empty_cache()
    roots_entry, s8i, rays_i, launches_17, err_17 = incoherent_phases(dev)
    entries_18, frame_bound_18 = k1_mode_phases(dev, scene, sub, s8i, rays_i,
                                                usage_k1)
    pool.shutdown()
    say(f"packet_traverse launches on the main paths: {launches} (phase 6) "
        f"+ {launches_pt} (phase 11, pallas) + {launches_a} (phase 13) + "
        f"{launches_17} (phase 17); the 8192^2 frame's bound from its "
        f"counters {frame_bound_18[0]:.4f} ms ({frame_bound_18[1]})")
    say(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s from its start "
        "to the kernels line")

    say(json.dumps({"kernels": [{
        "name": "packet_traverse",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:66",
        "launches": launches + launches_pt + launches_a + launches_17,
        "max_abs_err": max(max_abs, err_pt, err_a, err_17),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }] + k2k5 + entries_a + [roots_entry] + entries_18}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
