#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a),
``nvcc`` and ``g++``; builds every kernel from this checkout and imports
nothing of JAX. Phases, one line or more each:

1. the card (``nvidia-smi`` name and power limit);
2. the builds: the seven CUDA sources (one nvcc each, started together)
   and the native SAH builder (g++), with their seconds (and, beside
   them, ``ptxas -v`` reports of the AOV and camera kernels, printed in
   phase 6, and of K5 and K2, printed in phase 14);
3. small-scene parity: cornell box + UV sphere, 3,000 seeded rays, the
   kernel at widths 16 and 8 against the brute-force oracle on the card,
   for closest-hit, skip_prim_id, cull_back_face, prim_ids_range,
   any-hit and degenerate rays;
4. the main-path scene: a ~1M-triangle subdivided sphere, native SAH
   build with leaf size 9, BVH16 collapse;
5. kernel against its plain torch version on the card at full scene
   size: 65,536 tiled camera rays + 65,536 seeded incoherent rays, which
   must agree bit for bit;
6. the camera kernel (csrc/camera.cu, one launch) == its plain version
   bit for bit at 8192^2 and 3840 x 2160, its device ms beside its byte
   bound and the plain version's; the main path: look_at at 8192^2
   (67M rays, the bench.py frame, one camera launch),
   tile_image_rays(128, 64), detect_specialization, traverse_bvh8 — one
   warm-up and 3 timed repetitions with CUDA events; the hit fraction is
   held to the analytic disc coverage, and 1,024 sampled pixels to the
   brute-force oracle; the frame's AOVs (csrc/aovs.cu, one launch) ==
   their plain version bit for bit, the kernel's device ms beside its
   bound (phase 13 does the same at 512^2);
7. K2, K3 and K4 against their plain torch versions on the card:
   K2 (``trace_bvh16``) on the 99,236-triangle dense Cornell scene with
   65,536 seeded incoherent rays, closest-hit with aux rows and
   occlusion, and 1,024 of them against a brute-force Moller-Trumbore
   sweep; K3 (``render_fused``) on the 32-triangle Cornell box and K4
   (``render_fused_bvh``, spp_lanes 1 and 4) on the dense scene, each at
   4,096 rays x 4 spp x 10 bounces; K4 against K3 on the Cornell box with
   BVH16 tables attached. ``trig="poly"`` must agree bit for bit,
   ``"native"`` to 99% of pixels; K3's sweeps against the plain
   version's live bounces (equal), its live-bounce fraction and bounces a
   sample, its registers and resident blocks, and K3 == plain (poly, bit
   for bit) at its persistent schedule's edge shapes (7 and 45 pixels,
   one sample and one bounce, no bounce, 256 triangles, no lights,
   face-varying normals, a one-block grid launched twice, more pixels
   than resident lanes); ``ptxas -v`` of K3 and K4, and their resident
   blocks per SM;
8. config B: ``render_path_traced`` on the Cornell box at 512^2 x 100
   spp x 10 bounces (K3), one warm-up and 3 timed repetitions, and the
   kernel's bounces and shadow rays a sample;
9. midscale: the same on the dense scene (K4's pooled kernel on K2, 25
   sample-major lanes, 4 azimuth strata, 32 x 128 pixel tiles), with the
   pool's waves and regenerations; then one more render in two launches
   of 2 sample iterations each (equal to the first bit for bit), and the
   kernel's lane sums with ``trig="poly"`` on 4,096 sampled lanes
   against the plain version (``lane_ids=``), bit for bit;
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
    warm-up and 3 renders timed with CUDA events; 2 K1 launches and one
    of the AOV kernel a render, and no other kernel; both traces of one render (the 262,144 tiled
    primary rays and the 2,097,152 tile-ordered occlusion rays, skipping
    the hit prim, dead where the pixel missed) held to the plain version
    on the same tensors, bit for bit;
14. K2's watertight test with and without a per-ray skip on phase 7's
    rays against its plain version and 1,024 of them against brute
    force, then K5: ``render_ao_fused`` on phase 13's scene, rays and
    draws (1 launch a render, a warm-up and 3 timed), the kernel against
    its plain version on the full 512^2 x 8-sample input bit for bit
    (its live items, hit pixels x 8, against the plain version's
    samples), its time beside the sum of phase 13's two K1 traces, and
    against phase 13's render under the tie contract; K5 == plain at its
    persistent schedule's edge shapes (7 and 45 pixels, no hit, hits
    only, 1 and 32 samples, a one-block grid launched twice, more tiles
    than resident warps); K5's registers, spills, shared bytes and
    resident blocks (``ptxas -v``, the occupancy API);
15. the stack engine (plain torch, no traversal kernel; the AOVs launch
    their kernel): ``render_aovs`` at 512^2
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
    exact; K1b (``interleave`` 1, 2 and 4, each equal to K = 1 bit for
    bit) on five shapes: the frame, phase 5's rays (== plain), phase
    16's random rays, phase 17's sorted AO rays and phase 11's pallas
    bounce-2 closest-hit trace, each with its bound from the counts
    kernel's pops (a plain sample's triangles a leaf pop and rows read)
    and, on the last three, every 64th ray's records == plain; each
    shape again with the plan's claim size turned the other way
    (== K = 1, timed beside the plan's);
    each K1 and K1b instantiation's registers,
    spills and stack frame (``ptxas -v``) and its shared bytes and
    resident warps an SM (the occupancy API); the persistent schedule's
    edge shapes (ray counts of 1, 31, 32, 33 and a claim count the grid
    does not divide, every mode on grids of 1 and 3 blocks, dead rays,
    roots across claims, deep walks, K1b's small batches with the plan's
    claims and with claims of 32 K rays forced, a stack too small, which
    must set the overflow word) == plain;
19. the device build: ``collapse_lbvh_device(width=16, max_leaf=9)`` on
    the card over phase 4's sphere (a warm-up, then 3 builds timed with
    CUDA events, the peak allocation), its tables held to
    ``testing.wide_table_report`` (every prim once, parents enclose
    children, pad rows empty, depth equal to the levels); the build and
    the frame run as the slice's path with the counts zeroed before and
    read after (one K1 launch); the midscale scene (99,236 tris) built on
    the card and on the CPU at widths 16 and 8 and with ``woop=True``,
    whose tables must be equal bit for bit; K1 on the device tables ==
    plain on 131,072 of the frame's rays (every 512th); the 8192^2
    frame's records on the device tables against the host-built tree's
    (equal hit masks, t bit for bit, prim ids differing only at equal-t
    ties) and both frames in turns (host, device, device, host) with
    their Mrays/s; the woop path (``woop=True`` tables, K1-woop on the
    frame, one launch) and K1-woop == plain; then ~10M triangles: the
    build's seconds and ``torch.cuda.max_memory_allocated()``, the
    structure, the frame (hit fraction, 1,024 pixels against brute
    force, 16,384 rays == plain);
20. the traversal features on the card (plain torch, no kernel): 1M
    spheres on a LiDAR-like terrain at 512^2 rays, 100,000 cylinders at
    512^2 rays and 100,000 curves (4 subdivisions) at 256^2 rays, and
    ``multi_hit_traverse`` and ``multi_hit_wavefront`` at K = 8 on the
    midscale scene (262,144 rays inside the box), each with its seconds
    and Mrays/s and held to the same code on the CPU over every 64th ray
    (4,096 of 512^2, spread over the image: the same mask and prim ids,
    t within 4 ulp); and, in phase 19's ~10M cell, the device build with
    ``merge_leaves=True, preorder=True`` asked for explicitly (its
    seconds, peak allocation, structure, K1 == plain, and the frame on
    its tables against the default tables' in turns);
21. the Embree-style API and the scene graph at real size: an rtc scene
    of 10 copies of the midscale mesh (99,236 tris each) turned and set
    on a ring (992,360 world tris), committed on the card (the seconds
    of 10 graph builds and the BVH8 of the world-space union);
    ``intersect`` and ``occluded`` on 2048^2 pinhole rays (a warm-up and
    3 timed with CUDA events, Mrays/s; one K1 launch a call, counted),
    each call's K1 launch held to the plain version bit for bit on every
    32nd of its 4,194,304 sorted rays; the card against the CPU on 4,096
    spread rays for the fast route and ``Scene.traverse`` (the same hit
    mask, geometry and local prim ids, t within 4 ulp); the fast route
    against the graph walk on 65,536 spread rays (masks differing on at
    most 1% of rays, ids on 1% of shared hits, relative t error 1e-5:
    the CPU test's bounds); then the glTF path: the same mesh as one
    buffer under 10 TRS nodes in a ``.glb``, ``load_gltf``,
    ``to_scene_graph``, ``commit`` (one build), ``traverse`` of 256^2
    rays, and a re-commit after one ``translate`` that builds nothing;
22. the renderers: ``render_pbr`` on config A's scene with BVH16 tables
    at 1024^2 (2 K1 launches and one AOV launch a render, finite and
    not black, card ==
    CPU on 4,096 spread pixels), ``trace_bdpt`` on the midscale
    ``PTScene`` with BVH16 tables at 256^2 x 1 sample (K1) and on its
    Woop twin at 128^2 (K1-woop), every launch counted and each
    captured launch held to the plain version on its first 16,384
    sorted rays, ``rasterize_uv_atlas`` at 256^2 and every camera model
    at 512^2 against the CPU, and a ``ProgressiveRenderer`` of
    ``render_pbr`` passes whose pass 2 is cancelled in flight (the
    snapshots are the means of the kept passes only);
23. the loaders at the sizes their users load, each mesh through the
    native build (leaf 9) and BVH16 to K1 (a warm-up and 3 launches
    timed and counted, every 64th ray held to the plain version bit for
    bit): a 1024^2 heightmap (``heightmap_to_mesh``, 2,093,058 tris)
    under 2048^2 pinhole rays from ``camera_from_quat``, and
    ``sample_tri_hits`` of per-face textures on its hits (card == CPU
    on 4,096 spread pixels); a vector-displaced 512^2 grid
    (``apply_vector_displacement``) at 1024^2; a version-10 QR code
    (57^2 modules, ``grid2d_to_boxes``) under 1024^2 rays looking
    straight down, whose hit mask read at the module centres must
    ``verify_qr`` to the payload; a Minecraft region of 8x8
    full-height chunks written here (``load_region_mesh``) at 1024^2;
    and a 1,000,000-point LAS round trip (``save_las`` / ``load_las`` /
    ``save_las``: files byte-equal) drawn as spheres
    (``to_spheres(device="cuda")``, ``traverse_spheres`` at 256^2 on the
    stack engine, card == CPU on spread rays; and beside it through K1's
    sphere leaf test, ``traverse_spheres(..., scene8=)`` over the
    ``collapse_bvh8(..., spheres=)`` tables: 4 launches timed, every 64th
    ray == plain bit for bit, the stack engine's precise test on it
    record for record, both rates printed); and the benchmark's
    10M-point LiDAR tile at its own shape, the tables its ``las_view``
    entry builds (width 8, the builder's default leaves), one 3840x2160
    frame through ``traverse_image``: one launch over the rays in raster
    order, every 64th ray == plain bit for bit on t and prim id, and its
    records == the tiled route's, timed beside it; the frame's sphere AOVs
    (csrc/sphere_aovs.cu, one launch) == their plain version bit for bit,
    the kernel's device ms beside its byte bound and the plain version's,
    and its ``ptxas -v`` report;
24. the multi-device layer on one card: a one-rank NCCL group through a
    ``file://`` store in a temporary directory, ``ray_mesh(1)``;
    ``sharded_traverse_triangles``, ``sharded_traverse_wavefront`` and
    ``sharded_render_step`` on config A's scene at 512^2 (equal hit
    counts through ``all_reduce``, mean AO in [0, 1], no kernel); phase
    4's sphere in 4 packet chunks (``build_scene_chunks(4, packet=True)``)
    under 2048^2 pinhole rays through ``sequential_chunk_traverse`` (4
    K1 launches, each == plain on every 64th sorted ray), its records
    against one K1 trace of the unsplit sphere (phase 16's BVH8: equal
    hit masks, t bit for bit, prim ids differing only at equal-t ties),
    both timed in turns; and ``sharded_scene_traverse(engine="packet")``
    on a one-chunk scene of config A through the group (1 K1 launch)
    against the unsplit trace; the group is destroyed after;
25. the example programs (``nanort_tpu_torch/examples``) through their
    ``main(argv)`` at their own defaults: objrender on the procedural
    scene at 512^2 and on phase 4's sphere written as an OBJ at 1024^2
    (load, build, tables and render seconds; K1's launches, each held to
    the plain version on every 64th ray bit for bit), path_tracer at
    256^2 x 64 spp x 8 bounces (K3; Msamples/s), bidir_path_tracer at
    128^2 x 16 spp (no kernel: the Cornell box sweeps brute force),
    gltfrender on a ``.glb`` of 8 spheres on a ring at 512^2 (commit and
    walk seconds), the viewer's terminal surface for ~3 s a route with
    stdout captured (the BVH16 route, 2 K1 launches a pass, and the graph
    route; passes and passes/s) and its HTTP surface on 127.0.0.1:0
    (page, PNG, a gizmo nudge that re-commits, status, quit), and the
    graft entry's step, whose rgb must equal the CPU run's bit for bit;

then one line per
    K1 shape (phases 5, 6, 11, 13, 16-19, 21, 23) and K1b shape (phase 18)
    with its time and its bound.

It then prints one JSON line with every kernel (its launches on the main
path, its error against its plain version, its time, its plain
version's time, and its bound: the larger of the bytes it must move over
3.35 TB/s and the operations this run's inputs need over 67 TFLOP/s
(``rtbench/roofline.py``'s peaks), counted by the plain version;
``packet_traverse[rtc]`` is K1 at the API's shape, on phase 21's sorted
rays, its launches counted in ``packet_traverse``'s too) and, last, the
ok line. Any failed phase exits non-zero without the ok line; so does a
machine without CUDA.
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

from rtbench.roofline import F32_OPS_S, HBM_BYTES_S, SHADE_OPS, SLAB_OPS

FAILURES: list[str] = []
# K1's and K1b's shapes for the summary lines: (kernel, what, card ms,
# bound)
K1_SHAPES: list[tuple] = []
# traces that phases 11 and 17 capture for phase 18's K1b shapes:
# {shape: (scene8, sorted rays, positional, keyword arguments)}
K1B_TRACES: dict = {}

# float32 operations of one unit of work, counted from the kernels'
# source, beside the benchmark's one child's slab test (6 sub, 9 mul, 7
# compare/select) and one path vertex's shading (``SLAB_OPS``,
# ``SHADE_OPS``): one watertight triangle test (9 sub, 12 shear, 9 edge,
# 2 det, 8 t, 1 div, 3 mul, 6 compare), one Woop test (3 sub, 10 for o'z
# and d'z, 1 div, 1 mul, 24 for u and v, 5 compare), one Moller-Trumbore
# test, and one AO sample's share of the fused AO pass (15 for its world
# direction, plus an eighth of the pixel's ~40 for the normal flip, the
# offset point and the basis: about 20)
WT_OPS, WOOP_OPS, MT_OPS, AO_OPS = 50, 44, 51, 20


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


def queued_ms(fn, reps: int) -> float:
    """Device ms a call of ``fn()``: ``reps`` calls queued behind a 50-ms
    sleep that outlasts their enqueueing, between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(50e-3 * 2e9))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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


def k1_shape(what: str, ms: float, b: tuple, kernel: str = "K1"):
    """Record one K1 (or K1b) shape for the summary lines: its card ms
    and its bound."""
    K1_SHAPES.append((kernel, what, ms, b))


def report_k1_shapes():
    """One line per K1 shape: card ms beside its bound."""
    for kernel, what, ms, b in K1_SHAPES:
        say(f"{kernel} shape {what}: {ms:.3f} ms on the card, bound "
            f"{b[0]:.4f} ms ({b[1]}), {ms / b[0]:.1f}x the bound")


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


def one_packet_plan(one: bool):
    """``packet.launch_plan`` with K1b's claims forced to one packet of 32
    rays (``one``) or to K packets, the grid sized for them: the claims
    the plan would not pick for a launch, for holding and timing them."""
    import dataclasses

    from nanort_tpu_torch.traverse import packet

    real = packet.launch_plan

    def plan(n, blocks_per_sm, sms, interleave=1, occlusion=False):
        p = real(n, blocks_per_sm, sms, interleave, occlusion)
        if interleave == 1:
            return p
        packets = 1 if one else interleave
        claims = packet.k1b_claims(n, packets)
        grid = max(1, min(blocks_per_sm * sms,
                          -(-claims // (packet.K1_THREADS // 32))))
        return dataclasses.replace(p, grid=grid,
                                   claim=packet.K1_CLAIM * packets)

    return plan


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
    k3_sweeps = {}
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
        k3_sweeps[trig] = pt_fused.LAST_BRUTE_STATS.tolist()
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
    # the live bounces: the plain version's closest sweeps of live rays
    # against the nest's R x spp x max_bounces, and the kernel's own count
    closest, shadows = k3_sweeps["poly"]
    say(f"K3 live bounces (plain version's count): {k3_count['shade']} of "
        f"{R3 * SPP * MB} = {k3_count['shade'] / (R3 * SPP * MB):.4f}; the "
        f"kernel's sweeps: {closest} closest-hit ({closest / (R3 * SPP):.3f} "
        f"bounces a sample), {shadows} shadow ({shadows / (R3 * SPP):.3f} a "
        f"sample); trig='native': {k3_sweeps['native']}")
    check(closest == k3_count["shade"],
          "K3 swept other bounces than the plain version's live ones")
    occ3 = pt_fused.brute_occupancy(dev)
    say(f"K3 resources: {occ3['registers']} registers, {occ3['local_bytes']} "
        f"local bytes a thread, {occ3['blocks_per_sm']} resident blocks of "
        f"{occ3['threads']} threads an SM x {occ3['sms']} SMs "
        f"(occupancy API); grid at phase 7's shape "
        f"{pt_fused.brute_grid(R3, occ3['blocks_per_sm'], occ3['sms'])}, at "
        f"config B's "
        f"{pt_fused.brute_grid(512 * 512, occ3['blocks_per_sm'], occ3['sms'])}"
        "; ptxas -v: " + " | ".join(
            x for x in ptxas_lines(usage_pt.result())
            if x.startswith("pt_brute_kernel")))
    check(occ3["blocks_per_sm"] >= 1, "K3 does not fit an SM")

    k3_edge_shapes(dev, cornell, cv, cf, cm, cmats, cam_rays)

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

    for lanes in (1, 4):
        o_l = d_org.repeat_interleave(lanes, 0)
        d_l = d_dir.repeat_interleave(lanes, 0)

        def k4():
            return pt_fused.render_fused_bvh(
                dense, d_org, d_dir, SEED, SPP, max_bounces=MB, trig="poly",
                azimuth_strata=AZ, spp_lanes=lanes)

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

    R4 = d_org.shape[0] * 4
    k4_bound = bound(R4 * (24 + 12) + nbytes(mat4, light4, nodes, leafs, aux),
                     trace_ops(k4_count, 16, MT_OPS)
                     + k4_count.get("shade", 0) * SHADE_OPS)
    say(f"K4 work (plain version's count, spp_lanes 4): {k4_count}; bound "
        f"{k4_bound[0]:.4f} ms ({k4_bound[1]})")
    occ = pt_fused.pool_occupancy(dev)
    say(f"K4 resident blocks per SM: {occ['pool']} x 512 threads "
        f"({occ['pool_smem_bytes']} bytes of shared pool a block); ptxas "
        "-v: " + " | ".join(ptxas_lines(usage_pt.result())))
    check(occ["pool"] >= 1, "the pooled kernel does not fit an SM")

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
    closest, shadows = pt_fused.LAST_BRUTE_STATS.tolist()
    say(f"phase 8 K3 sweeps (last render): {closest} closest-hit = "
        f"{closest / (512 * 512 * 100):.4f} bounces a sample of 10, "
        f"{shadows} shadow = {shadows / (512 * 512 * 100):.4f} a sample")
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
    k4_slices_and_lanes(dense, cam, img, mat4, light4, lights4, nodes,
                        leafs, aux, slots)
    del img
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
    }, woop_entry], launches_pallas, pallas_err, (s8, dense.fused_aux, rays,
                                                  dense.mesh)


def k3_edge_shapes(dev, cornell, cv, cf, cm, cmats, cam_rays):
    """Phase 7: K3 against its plain version on the card (``trig="poly"``,
    bit for bit) at the persistent schedule's edge shapes: fewer pixels
    than a warp, a count no warp divides, one sample and one bounce, no
    bounce, 256 triangles, no lights, face-varying normals, a grid of one
    block (every lane claims many pixels), more pixels than the resident
    lanes, and two launches in a row giving one image."""
    import torch

    from nanort_tpu_torch.models import path_tracer, pt_fused

    k = pt_fused.PT_FUSED_MAX_TRIS - len(cf)
    rng = np.random.default_rng(8)
    c = rng.uniform(-0.8, 0.8, (k, 1, 3))
    tv = (c + rng.uniform(-0.2, 0.2, (k, 3, 3))).reshape(-1, 3)
    big = path_tracer.make_pt_scene(
        np.concatenate([cv, tv]).astype(np.float32),
        np.concatenate([cf, len(cv) + np.arange(3 * k).reshape(-1, 3)]
                       ).astype(np.int32),
        np.concatenate([cm, np.zeros(k, np.int32)]), cmats, device=dev)
    dark = cornell._replace(light_table=cornell.light_table[:0],
                            light_faces=cornell.light_faces[:0])
    f = cornell.face_table
    fvn = f[:, None, 0:3] + torch.from_numpy(rng.normal(
        0, 0.2, (f.shape[0], 3, 3)).astype(np.float32)).to(dev)
    fv = cornell._replace(face_table=torch.cat([f, fvn.reshape(-1, 9)],
                                               1).contiguous())
    occ = pt_fused.brute_occupancy(dev)
    lanes = occ["blocks_per_sm"] * occ["sms"] * occ["threads"]
    cases = {  # name: (scene, (w, h), spp, max_bounces, grid)
        "n7": (cornell, (7, 1), 3, 5, None),
        "n45": (cornell, (9, 5), 3, 5, None),
        "spp1_mb1": (cornell, (24, 20), 1, 1, None),
        "mb0": (cornell, (24, 20), 3, 0, None),
        "f256": (big, (24, 20), 3, 6, None),
        "no_lights": (dark, (24, 20), 4, 6, None),
        "facevarying": (fv, (24, 20), 3, 5, None),
        "grid1": (cornell, (24, 20), 5, 6, 1),
        "more_than_resident": (cornell, (512, -(-(lanes + 1000) // 512)), 1,
                               2, None),
    }
    real_grid = pt_fused.brute_grid
    bad = []
    for name, (scene, (w, h), spp, mb, grid) in cases.items():
        org, d = cam_rays(w, h, 5.0)
        tri, face, light = pt_fused.build_fused_tables(scene)
        with (patched(pt_fused, "brute_grid", lambda *a: grid) if grid
              else contextlib.nullcontext()):
            got = [pt_fused.render_fused(scene, org, d, 4, spp,
                                         max_bounces=mb, trig="poly",
                                         azimuth_strata=2)
                   for _ in range(2 if name == "grid1" else 1)]
        # the wrapper's mean is a true division (on the card torch turns
        # a division by a Python number into a product with its inverse)
        want = pt_fused._div(pt_fused._render_fused_reference(
            tri, face, pt_fused._lights(scene, dev), org, d, 4, spp, mb, 3,
            "poly", 2), float(spp))
        if not all(torch.equal(g, want) for g in got):
            bad.append(name)
    check(pt_fused.brute_grid is real_grid, "brute_grid left patched")
    say(f"K3 edge shapes against the plain version (poly, bit for bit; "
        f"{lanes} resident lanes): {len(cases) - len(bad)} of {len(cases)} "
        f"equal {sorted(cases)}; the grid-1 case twice in a row")
    check(not bad, f"K3 disagrees with its plain version at {bad}")


def ptxas_lines(text: str) -> list[str]:
    """K3's and K4's kernels in a ``ptxas -v`` report: each kernel's
    name, registers, spills and stack."""
    out, name = [], None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in ("pt_bvh_pool_kernel", "pt_brute_kernel")
                         if k in ln), None)
        elif name and ("Used" in ln or "spill" in ln):
            out.append(f"{name.split('I')[0]}: {' '.join(ln.split())}")
    return out


def k4_slices_and_lanes(dense, cam, img_m, mat, light, lights, nodes, leafs,
                        aux, slots) -> None:
    """Phase 9's checks of K4 on the midscale render: one more render in
    two slices of sample iterations through ``render_path_traced``
    (equal to the main path's image bit for bit), and the kernel's lane
    sums with ``trig="poly"`` on 4,096 sampled lanes against the plain
    version."""
    import torch

    from nanort_tpu_torch.models import path_tracer, pt_fused
    from nanort_tpu_torch.models.cameras import pinhole_rays

    rays = pinhole_rays(cam)
    # a render whose per-sample buffer passes the cap runs one launch a
    # slice of its sample iterations: half the 4 iterations a slice here
    K = path_tracer.default_spp_lanes(100, 4)
    rl = 512 * 512 * K
    zero_launch_counts()
    holder = {}
    with patched(pt_fused, "POOL_SLICE_BYTES", 2 * rl * 12):
        ms_s = cuda_ms(lambda: holder.__setitem__(
            "img", path_tracer.render_path_traced(
                dense, rays, 3, spp=100, max_bounces=10)), 1)[0]
    img = holder.pop("img")
    sliced = launch_counts()["pt_fused_bvh"]
    say(f"phase 9 pooled kernel in slices of 2 sample iterations "
        f"({2 * rl * 12} bytes a buffer, {sliced} launches): {ms_s:.1f} ms; "
        f"image equal to the main path's bit for bit: "
        f"{torch.equal(img, img_m)}")
    check(sliced == 2 and torch.equal(img, img_m),
          "the sliced pooled render disagrees with the main path's")

    # the kernel's lane sums with trig="poly" on the route's own input
    H = W = 512
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    perm = torch.arange(H * W, device=org.device).reshape(
        H // 32, 32, W // 128, 128).transpose(1, 2).reshape(-1)
    org = org[perm].repeat_interleave(K, 0).contiguous()
    d = d[perm].repeat_interleave(K, 0).contiguous()
    sums = pt_fused._launch_fused_bvh(mat, light, lights, nodes, leafs, aux,
                                      slots, org, d, 3, 100 // K, 10, 3,
                                      "poly", 4, K)
    pick = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        org.shape[0], 4096, replace=False))).to(org.device)
    t0 = time.perf_counter()
    want = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org[pick], d[pick], 3,
        100 // K, 10, 3, "poly", 4, K, lane_ids=pick)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    held = torch.equal(sums[pick], want)
    say(f"phase 9 trig='poly': 4,096 sampled lanes of {org.shape[0]} == "
        f"plain version (lane_ids=) bit for bit: {held} (plain "
        f"{plain_s:.1f} s), max abs err {max_abs(sums[pick], want)}")
    check(held, "K4's pooled kernel disagrees on the full-size poly input")


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
            if name == "pallas" and kind == "closest":
                K1B_TRACES["bounce2_closest"] = (scene.scene8, r, (), kw)
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
            woop = name == "turbo"
            k1_shape(f"phase 11 {'K1-woop' if woop else 'K1'}, {name} "
                     f"bounce-2 {kind} trace ({h['rays']} sorted rays, "
                     f"{h['dead']} dead)", h["ms"],
                     bound(h["rays"] * (32 + 20) + row_bytes(h["stats"]),
                           trace_ops(h["stats"], 16,
                                     WOOP_OPS if woop else WT_OPS)))

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
        check(nonzero(counts) == {"pinhole_fused": 1},
              f"phase 12 {what} launched {nonzero(counts)}: the camera "
              "kernel alone expected")
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
    return [c[1:] for c in capture_k1(render)[0]]


def capture_k1(run, only=None) -> tuple[list, int]:
    """Run ``run()`` and keep what K1 was given and gave back on the
    launches whose index (from 0, in launch order) is in ``only`` (all
    when None): ``(scene8, rays, positional arguments, keyword
    arguments, hits)``. Returns the kept launches and the count of all."""
    from nanort_tpu_torch.traverse import packet

    kept, n = [], [0]
    real = packet.traverse_bvh8

    def keep(scene8, rays, *a, **k):
        out = real(scene8, rays, *a, **k)
        if only is None or n[0] in only:
            kept.append((scene8, rays, a, dict(k), out))
        n[0] += 1
        return out

    with patched(packet, "traverse_bvh8", keep):
        run()
    return kept, n[0]


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
    woop = kw.get("intersector") == "woop"
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
            scene8.nodes, scene8.leafs_woop if woop else scene8.leafs,
            scene8.width, flat.org, flat.dir, flat.min_t, flat.max_t, skip,
            None, opts.cull_back_face, opts.exact_edge_fallback and not woop,
            occ, packet.stack_slots(scene8), woop, stats=stats, start=start)

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
    and K5, K1's launches and largest error in phase 13, and the AOV
    kernel's launches in phases 13-15."""
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
    check(counts == {**{k: 0 for k in counts}, "packet_traverse": 8,
                     "aovs_fused": 4},
          f"config A on K1: launches {counts}, expected 2 K1 and 1 AOV "
          "kernel a render")
    aov_launches = counts["aovs_fused"]
    ao = aovs_k1["ao"]
    check(tuple(ao.shape) == (res, res) and bool(torch.isfinite(ao).all())
          and 0.0 < float(ao.mean()) < 1.0, "config A: bad AO image")
    aov = hold_aovs(mesh, rays, hits_k1, 200)
    say_aovs(f"phase 13: config A's {res}^2", aov, 200)
    aov_launches += aov["total"]
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
        k1_shape(f"phase 13 config A {kind} trace ({h['rays']} rays)",
                 h["ms"], bound(h["rays"] * (32 + 20) + row_bytes(h["stats"])
                                + (4 * h["rays"] if h["skip"] else 0),
                                trace_ops(h["stats"], 16, WT_OPS)))
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
                     "bvh16_trace_watertight": 4, "aovs_fused": 4},
          f"config A on K5: launches {counts}, expected 1 K5 and 1 AOV "
          "kernel a render")
    aov_launches += counts["aovs_fused"]
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
    items5 = int(ao_fused.LAST_ITEMS)
    say(f"K5 live items (hit pixels x {S}): {items5}, the plain version's "
        f"samples {k5_stats.get('samples')}; hit fraction "
        f"{float(want5[5].float().mean()):.5f}")
    check(items5 == k5_stats.get("samples"),
          "K5 traced other items than the plain version's samples")
    k1_pair = held["primary"]["ms"] + held["occlusion"]["ms"]
    say(f"K5 yardstick: K5 {k5_ms:.3f} ms against phase 13's two K1 traces "
        f"on the same scene and rays, {held['primary']['ms']:.3f} + "
        f"{held['occlusion']['ms']:.3f} = {k1_pair:.3f} ms (K5 / K1 pair "
        f"{k5_ms / k1_pair:.3f})")
    k5_edge_shapes(dev, s16, aux_a, n5, l5, a5, slots5)
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
    occ5 = ao_fused.ao_occupancy(dev)
    say(f"K5 resources (occupancy API): {occ5['registers']} registers, "
        f"{occ5['local_bytes']} local bytes (stack and spill) a thread, "
        f"{occ5['shared_bytes']} shared bytes a block of {occ5['threads']}, "
        f"{occ5['blocks_per_sm']} resident blocks an SM x {occ5['sms']} SMs; "
        f"grid at config A {ao_fused.ao_grid(n_px, occ5['blocks_per_sm'], occ5['sms'])}")
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
    # the AOVs of the 512^2 render_aovs and of the 128^2 render_ao, and
    # the latter's camera
    check(nonzero(counts) == {"aovs_fused": 2, "pinhole_fused": 1},
          f"the stack engine launched {nonzero(counts)}")
    aov_launches += counts["aovs_fused"]
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
    check(nonzero(counts) == {"aovs_fused": 1},
          f"the stack engine launched {nonzero(counts)}")
    aov_launches += counts["aovs_fused"]

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
    }], launches_k1, k1_err, aov_launches


def k5_edge_shapes(dev, s16, aux, nodes, leafs, aux_t, slots):
    """Phase 14: K5 against its plain version on the card, bit for bit,
    and its items against the plain version's samples, at its persistent
    schedule's edge shapes on config A's scene: fewer pixels than a tile,
    a count no tile divides, no hit (looking away from the box), hits only
    (a camera inside the box), one and 32 samples, a grid of one block
    (every warp claims many tiles) launched twice, and more tiles than
    the resident warps."""
    import torch

    from nanort_tpu_torch.models import ao_fused, objrender
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    occ = ao_fused.ao_occupancy(dev)
    warps = occ["blocks_per_sm"] * occ["sms"] * occ["threads"] // 32
    eye = (0.31, 0.17, 5.0)
    cases = {  # name: (eye, center, (w, h), S, grid)
        "n7": (eye, (0, 0, 0), (7, 1), 8, None),
        "n45": (eye, (0, 0, 0), (9, 5), 8, None),
        "all_miss": ((0, 0, -5.0), (0, 0, -10.0), (64, 48), 8, None),
        "all_hit": ((0, 0, 0.9), (0, 0, 0), (64, 48), 8, None),
        "s1": (eye, (0, 0, 0), (64, 48), 1, None),
        "s32": (eye, (0, 0, 0), (64, 48), 32, None),
        "grid1": (eye, (0, 0, 0), (64, 48), 8, 1),
        "more_than_resident": (eye, (0, 0, 0),
                               (512, -(-(32 * warps + 1000) // 512)), 2,
                               None),
    }
    real_grid = ao_fused.ao_grid
    bad, hits = [], {}
    for name, (e, c, (w, h), S, grid) in cases.items():
        rays = pinhole_rays(look_at(eye=e, center=c, width=w, height=h,
                                    fov=45.0, device=dev))
        flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in rays]
        draws = objrender.resolve_draws(rays, 3, S, True).reshape(
            S, w * h, 3).contiguous()
        args = (nodes, leafs, aux_t, *flat, draws, 1e30, slots)
        stats = {}
        want = ao_fused._ao_fused_reference(*args, stats=stats)
        with (patched(ao_fused, "ao_grid", lambda *a: grid) if grid
              else contextlib.nullcontext()):
            for _ in range(2 if name == "grid1" else 1):
                got = ao_fused.ao_fused_outputs(*args)
                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                        and int(ao_fused.LAST_ITEMS) == stats["samples"]):
                    bad.append(name)
        hits[name] = float(want[5].float().mean())
    check(ao_fused.ao_grid is real_grid, "ao_grid left patched")
    say(f"K5 edge shapes against the plain version (bit for bit, items == "
        f"samples; {warps} resident warps): {len(cases) - len(bad)} of "
        f"{len(cases)} equal {sorted(cases)}; hit fractions {hits}; the "
        f"grid-1 case twice in a row")
    check(hits["all_miss"] == 0.0 and hits["all_hit"] == 1.0,
          f"K5 edge shapes: all_miss / all_hit are not: {hits}")
    check(not bad, f"K5 disagrees with its plain version at {bad}")


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
    k1_shape(f"phase 16 K1 with roots, the first {hold_packets} packets of "
             f"a round-1 launch ({held['rays']} slots)", held["ms"],
             roots_bound)
    # the whole round-1 launch, its work the slice's scaled by slots
    r1_ms = median(cuda_ms(lambda: packet.traverse_bvh8(s8, r1, *a1, **k1kw),
                           5))
    scale1 = r1.org.shape[0] / held["rays"]
    k1_shape(f"phase 16 K1 with roots, the whole round-1 launch "
             f"({r1.org.shape[0]} slots; the slice's work x {scale1:.2f})",
             r1_ms, bound(r1.org.shape[0] * (32 + 20)
                          + 4 * k1kw["packet_roots"].numel()
                          + min(row_bytes(held["stats"]) * scale1,
                                nbytes(s8.nodes, s8.leafs)),
                          trace_ops({k: v * scale1 for k, v in
                                     held["stats"].items()}, 8, WT_OPS)))
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
    K1B_TRACES["ao_sorted"] = (s8, sr, sa, skw)
    held_b = hold_k1_trace(s8, sr, sa, skw, sout, hold_rays)
    say(f"phase 17 sorted trace, first {held_b['rays']} rays ({held_b['hits']} "
        f"occluded): kernel == plain bit for bit: {held_b['same']}; max abs "
        f"err {held_b['err']}; kernel {held_b['ms']:.3f} ms, plain "
        f"{held_b['plain_ms']:.1f} ms; work {held_b['stats']}")
    check(held_b["same"], "the phase-17 trace disagrees with the plain version")
    st17 = {}
    smp = type(sr)(*(x[::32].contiguous() for x in sr))
    packet._traverse_reference(
        s8.nodes, s8.leafs, 8, smp.org, smp.dir, smp.min_t, smp.max_t, None,
        None, False, True, True, packet.stack_slots(s8), stats=st17)
    k1_shape(f"phase 17 AO bounce run, sort + K1 any-hit + unsort ({RB} "
             f"rays; K1's work on every 32nd sorted ray x32, its rows as a "
             f"floor)", min(ms),
             bound(RB * (32 + 20) + row_bytes(st17),
                   trace_ops({k: st17.get(k, 0) * 32 for k in ("nodes",
                                                              "tris")},
                             8, WT_OPS)))
    del smp
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


def k1_edge_shapes(dev) -> int:
    """Phase 18's edge shapes of K1's persistent schedule, each held to
    the plain version (the wrapper on CPU copies) bit for bit: ray counts
    of 1, 31, 32 and 33 and a claim count that the resident grid's warps
    do not divide; every mode on a grid of 1 and 3 blocks (so each warp
    claims several times); all rays dead and a sorted dead tail; packet
    roots whose packets span several claims; deep walks (an
    overlapping triangle soup); K1b at K = 2 and 4 on 1, 33 and 1,000
    rays and on grids of 1 and 3 blocks (closest, any-hit, Woop), each
    with the plan's claims (K packets of 32 rays, one on any-hit) and
    with the other size forced (``one_packet_plan``); and a
    stack too small for the walks, which must set the overflow word.
    Returns the number of shapes held."""
    import dataclasses

    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_uv_sphere, merge_meshes)
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import overlap_soup
    from nanort_tpu_torch.traverse import packet, treelet

    def build(v, f, leaf, width, woop=False):
        bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
            min_leaf_primitives=leaf, max_leaf_primitives=leaf))
        return collapse_bvh8(bvh, v, f, width=width, woop=woop)

    def rays_of(n, seed):
        rng = np.random.default_rng(seed)
        org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        d = rng.uniform(-0.8, 0.8, (n, 3)) - org
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))

    vb, fb = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    box = {(w, woop): build(vb, fb, 9, w, woop) for w in (8, 16)
           for woop in (False, True)}
    vs, fs, so, sd = overlap_soup(600, 1500)
    soup = {(w, woop): build(vs, fs, 1, w, woop) for w in (8, 16)
            for woop in (False, True)}
    soup_rays = nt.make_rays(torch.from_numpy(so), torch.from_numpy(sd))
    fast = nt.BVHTraceOptions(exact_edge_fallback=False)
    modes = {"closest": {}, "any_hit": dict(occlusion=True),
             "cull": dict(options=nt.BVHTraceOptions(cull_back_face=True)),
             "range": dict(options=nt.BVHTraceOptions(
                 prim_ids_range=(100, 900))),
             "woop": dict(intersector="woop"),
             "woop_any_hit": dict(intersector="woop", occlusion=True),
             "counts": dict(debug_counts=True),
             "flags": dict(options=fast, _flag_zero_edges=True)}
    real_plan = packet.launch_plan

    def held(scene, rays, grid=None, one=None, **kw):
        def on(dev_):
            return {k: (x.to(dev_) if isinstance(x, torch.Tensor) else x)
                    for k, x in kw.items()}

        base = real_plan if one is None else one_packet_plan(one)
        plan = base if grid is None else (
            lambda *a: dataclasses.replace(base(*a), grid=grid))
        with patched(packet, "launch_plan", plan):
            got = packet.traverse_bvh8(scene.to(dev), nt.Rays(
                *(x.to(dev) for x in rays)), **on(dev))
        want = packet.traverse_bvh8(scene, rays, **kw)
        if not isinstance(want, nt.Hits):
            got = list(got[0]) + [got[1]]
            want = list(want[0]) + [want[1]]
        return all(torch.equal(a.cpu(), b) for a, b in zip(got, want))

    results = {}
    for w in (8, 16):
        for n in (1, 31, 32, 33):
            results[f"w{w} n={n}"] = held(box[w, False], rays_of(n, 12))
    s16 = box[16, False]
    occ = packet.k1_occupancy(16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = occ["blocks_per_sm"] * sms * packet.K1_THREADS // 32
    n_odd = packet.K1_CLAIM * (warps + 3) + 5
    results[f"w16 n={n_odd} (claims do not divide {warps} warps)"] = held(
        s16, rays_of(n_odd, 13))
    for grid in (1, 3):
        for w in (8, 16):
            for name, kw in modes.items():
                results[f"grid {grid} w{w} {name}"] = held(
                    box[w, "intersector" in kw], rays_of(935, 14), grid, **kw)
    r = rays_of(935, 15)
    results["grid 2 w16 skip"] = held(
        s16, r, 2, skip_prim_id=packet.traverse_bvh8(s16, r).prim_id)
    for case in ("all dead", "dead tail"):
        r = rays_of(3001, 16)
        dead = torch.ones(3001, dtype=torch.bool)
        if case == "dead tail":
            dead[:1800] = False
        r = r._replace(max_t=torch.where(dead, -1.0, r.max_t))
        for occ_ in (False, True):
            results[f"grid 2 {case} any-hit={occ_}"] = held(s16, r, 2,
                                                           occlusion=occ_)
    tl, s8t = treelet.make_treelets(box[8, False], 24)
    for sub_ in (1, 3):
        n_pk = -(-3001 // (sub_ * packet.LANES))
        roots = torch.from_numpy(tl.roots[np.random.default_rng(2).integers(
            0, tl.count, n_pk)])
        for grid in (None, 2):
            results[f"roots sub={sub_} grid {grid}"] = held(
                s8t, rays_of(3001, 17), grid, sub=sub_, packet_roots=roots)
    for w in (8, 16):
        st = {}
        sc = soup[w, False]
        packet._traverse_reference(
            torch.as_tensor(sc.nodes), torch.as_tensor(sc.leafs), w,
            soup_rays.org, soup_rays.dir, soup_rays.min_t, soup_rays.max_t,
            None, None, False, True, False, packet.stack_slots(sc), stats=st)
        deep = 2 * (w - 1)
        check(st["max_sp"] > deep, f"the soup's walks stay shallow "
              f"({st['max_sp']} <= {deep} entries)")
        for name in ("closest", "any_hit", "woop", "counts", "flags"):
            kw = modes[name]
            results[f"deep stack w{w} {name} (peak {st['max_sp']} of "
                    f"{packet.stack_slots(sc)})"] = held(
                        soup[w, "intersector" in kw], soup_rays, **kw)
        results[f"deep stack w{w} interleave=2"] = held(sc, soup_rays,
                                                        interleave=2)
    # K1b's claims: ray counts below and across a claim, and grids of 1
    # and 3 blocks, so that warps claim and refill many times; the plan's
    # claims, then claims of 32 K rays forced (refilled lanes)
    for K in (2, 4):
        for flip in (False, True):
            tag = " other claims" if flip else ""
            for n in (1, 33, 1000):
                results[f"K1b K={K} w16 n={n}{tag}"] = held(
                    box[16, False], rays_of(n, 18), one=True if flip else None,
                    interleave=K)
            for grid in (1, 3):
                for name in ("closest", "any_hit", "woop"):
                    kw = modes[name]
                    one = not kw.get("occlusion", False) if flip else None
                    results[f"K1b K={K} grid {grid} w8 {name}{tag}"] = held(
                        box[8, "intersector" in kw], rays_of(935, 19), grid,
                        one=one, interleave=K, **kw)
    # a stack too small for the walks: the overflow word, not a wrong record
    words = []
    with patched(packet, "stack_slots", lambda s: 3), \
            patched(packet, "_check_overflow",
                    lambda err, slots: words.append(int(err.item()))):
        packet.traverse_bvh8(soup[16, False].to(dev), nt.Rays(
            *(x[:64].to(dev) for x in soup_rays)))
    results["stack of 3 slots sets the overflow word"] = words == [1]
    bad = [k for k, ok in results.items() if not ok]
    say(f"phase 18 K1 edge shapes against the plain version ({len(results)} "
        f"held, {len(bad)} differ): " + "; ".join(
            f"{k} {'ok' if ok else 'DIFFERS'}" for k, ok in results.items()))
    check(not bad, f"K1 edge shapes differ from the plain version: {bad}")
    return len(results)


def k1_resources(text: str) -> list[str]:
    """One line per K1 and K1b instantiation: ``ptxas -v``'s registers,
    spills and stack frame (from ``text``), then the occupancy API's
    registers, local and shared bytes and resident warps an SM for each
    of K1's modes and each K1b instantiation (width, leaf test)."""
    import re

    from nanort_tpu_torch.traverse import packet

    out = []
    cur = None
    usage = {}
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            usage[cur] = []
        elif cur and ("Used" in ln or "spill" in ln):
            usage[cur].append(" ".join(ln.split()))
    for fn, lines in usage.items():
        # _ZN..traverse_kernelILi16ELb0E...EEv.. -> traverse_kernel<16,0,...>
        m = re.search(r"(traverse_kernel(?:_il)?)I(.*?)EEv", fn)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(2) + "E")
            fn = f"{m.group(1)}<{','.join(args)}>"
        out.append(f"{fn}: " + "; ".join(lines))
    for w in (8, 16):
        for name, kw in (("watertight", {}), ("woop", dict(woop=True)),
                         ("roots", dict(roots=True)),
                         ("woop roots", dict(woop=True, roots=True)),
                         ("counts", dict(counts=True)),
                         ("woop counts", dict(woop=True, counts=True)),
                         ("flags", dict(flags=True))):
            o = packet.k1_occupancy(w, **kw)
            out.append(
                f"K1 w{w} {name}: {o['registers']} registers, "
                f"{o['local_bytes']} local bytes a thread, "
                f"{o['shared_bytes']} shared bytes a block, "
                f"{o['blocks_per_sm']} blocks of {o['threads']} threads = "
                f"{o['blocks_per_sm'] * o['threads'] // 32} resident warps "
                f"an SM")
    for w in (8, 16):
        for woop in (False, True):
            o = packet.k1_occupancy(w, woop, interleave=2)
            out.append(
                f"K1b w{w}{' woop' if woop else ''} (K = 2 and 4): "
                f"{o['registers']} registers, {o['local_bytes']} local bytes "
                f"a thread, {o['blocks_per_sm']} blocks of {o['threads']} "
                f"threads = {o['blocks_per_sm'] * o['threads'] // 32} "
                f"resident warps an SM, 32 K rays a claim")
    return out


def k1_mode_phases(dev, scene, sub, s8i, rays_i, usage_k1, res: int = 8192,
                   n_edge: int = 65_536) -> tuple:
    """Phase 18: K1's counters, zero-edge flags and K1b on the card.
    ``scene``/``sub``: phase 4's BVH16 scene and phase 5's 131,072 rays;
    ``s8i``/``rays_i``: phase 16's BVH8 scene and random rays; the
    traces phases 11 and 17 left in ``K1B_TRACES``;
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
    k1_shape(f"phase 18 counts on phase 5's {m2} rays", c_ms, c_bound)
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

    # ---- 18. K1b (interleave 2, 4) on its five shapes against K = 1: the
    # frame, phase 5's rays, phase 16's random rays, phase 17's sorted AO
    # rays and phase 11's bounce-2 closest-hit trace; each shape's bound
    # from the counts kernel's pops (a plain sample's triangles a leaf pop
    # and rows read, as the frame's)
    shapes = {"frame": (f"the {res}^2 frame", scene, rays_t, (),
                        dict(specialize=spec)),
              "phase5": (f"phase 5's {m2} rays", scene, sub, (), {}),
              "random": (f"phase 16's {rays_i.org.shape[0]} random rays",
                         s8i, rays_i, (), {})}
    for key, what in (("ao_sorted", "phase 17's sorted AO rays"),
                      ("bounce2_closest", "phase 11's pallas bounce-2 "
                                          "closest-hit trace")):
        sc8, r, a, kw = K1B_TRACES.pop(key)
        shapes[key] = (f"{what} ({r.org.shape[0]} sorted rays)", sc8, r, a,
                       kw)
    il_bound = {"frame": frame_bound, "phase5": c_bound}
    sampled = {}  # every 64th ray's plain records, K1b held to them
    for key, (what, s, r, a, kw) in shapes.items():
        if key in il_bound:
            continue
        cnt = packet.traverse_bvh8(s, r, *a, debug_counts=True, **kw)
        pops = (int(cnt.u.double().sum()), int(cnt.v.double().sum()))
        del cnt
        smp = type(r)(*(x.reshape(-1, *x.shape[1:])[::64].contiguous()
                        for x in r))
        opts = a[0] if a else (kw.get("options") or nt.BVHTraceOptions())
        woop = kw.get("intersector") == "woop"
        skip = kw.get("skip_prim_id")
        st_s = {}
        sampled[key] = packet._traverse_reference(
            s.nodes, s.leafs_woop if woop else s.leafs, s.width, smp.org,
            smp.dir, smp.min_t, smp.max_t,
            None if skip is None else skip.reshape(-1)[::64].long(), None,
            opts.cull_back_face, opts.exact_edge_fallback and not woop,
            kw.get("occlusion", False), packet.stack_slots(s), woop,
            stats=st_s)
        tpl = st_s.get("tris", 0) / max(st_s.get("leaves", 0), 1)
        il_bound[key] = bound(
            r.org.shape[0] * (32 + 20) + row_bytes(st_s),
            pops[0] * s.width * SLAB_OPS + pops[1] * tpl * WT_OPS)
        say(f"phase 18 {what}: K1 counters node pops {pops[0]}, leaf pops "
            f"{pops[1]} (x {tpl:.3f} tris a leaf pop, every 64th ray's "
            f"plain ratio); bound {il_bound[key][0]:.4f} ms "
            f"({il_bound[key][1]})")
    zero_launch_counts()
    il = {}
    il_err = {2: 0.0, 4: 0.0}
    for key, (what, s, r, a, kw) in shapes.items():
        ref = packet.traverse_bvh8(s, r, *a, **kw)
        line = []
        for K in (1, 2, 4):
            out = packet.traverse_bvh8(s, r, *a, interleave=K, **kw)
            same = all(torch.equal(x, y) for x, y in zip(out, ref))
            if K > 1 and key in sampled:
                got_s = [x.reshape(-1)[::64] for x in out]
                same_s = all(torch.equal(x, y)
                             for x, y in zip(got_s, sampled[key]))
                il_err[K] = max(il_err[K], record_err(got_s, sampled[key]))
                line.append(f"K={K} every 64th ray == plain: {same_s}")
                check(same_s, f"interleave={K} on {what} disagrees with "
                      "the plain version")
            del out
            ms = median(cuda_ms(lambda: packet.traverse_bvh8(
                s, r, *a, interleave=K, **kw), 10 if key == "phase5" else 3))
            il[key, K] = ms
            line.append(f"K={K} {ms:.3f} ms (same as K=1: {same})")
            check(same, f"interleave={K} on {what} changes records")
            if K > 1:
                k1_shape(f"K={K} on {what}", ms, il_bound[key],
                         kernel="K1b")
            elif key in ("random", "ao_sorted"):
                k1_shape(f"K1 alone on {what}", ms, il_bound[key])
        say(f"phase 18 interleave on {what} (medians of "
            f"{10 if key == 'phase5' else 3}; bound {il_bound[key][0]:.4f} "
            f"ms, {il_bound[key][1]}): " + "; ".join(line)
            + f"; K=2 / K=1 {il[key, 2] / il[key, 1]:.3f}, K=4 / K=2 "
            f"{il[key, 4] / il[key, 2]:.3f}")
        del ref
    il_launches = launch_counts()
    # the plan's claims against the other size on every shape: one packet
    # of 32 rays (the plan's on any-hit) or K packets
    for key, (what, s, r, a, kw) in shapes.items():
        n = r.org.reshape(-1, 3).shape[0]
        ref = packet.traverse_bvh8(s, r, *a, **kw)
        line = []
        for K in (2, 4):
            occ_ = packet.k1_occupancy(s.width, kw.get("intersector") == "woop",
                                       interleave=K)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chosen = packet.launch_plan(
                n, occ_["blocks_per_sm"], sms, K,
                kw.get("occlusion", False)).claim == packet.K1_CLAIM
            with patched(packet, "launch_plan", one_packet_plan(not chosen)):
                out = packet.traverse_bvh8(s, r, *a, interleave=K, **kw)
                same = all(torch.equal(x, y) for x, y in zip(out, ref))
                del out
                ms = median(cuda_ms(lambda: packet.traverse_bvh8(
                    s, r, *a, interleave=K, **kw),
                    10 if key == "phase5" else 3))
            check(same, f"interleave={K} with one-packet claims {not chosen} "
                  f"on {what} "
                  "changes records")
            line.append(f"K={K} plan's claims of {1 if chosen else K} "
                        f"packets {il[key, K]:.3f} ms, of {K if chosen else 1}"
                        f" {ms:.3f} ms (same as K=1: "
                        f"{same}; plan / other {il[key, K] / ms:.3f})")
        say(f"phase 18 K1b claim size on {what}: " + "; ".join(line))
        del ref
    del rays_t, shapes
    torch.cuda.empty_cache()
    want, p_ms, st5 = plain()
    k_bound = bound(m2 * (32 + 20) + row_bytes(st5),
                    trace_ops(st5, 16, WT_OPS))
    il_entries = []
    for K in (2, 4):
        got = packet.traverse_bvh8(scene, sub, interleave=K)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(record_err(list(got), want), il_err[K])
        say(f"phase 18 interleave={K} on phase 5's rays: kernel == plain bit "
            f"for bit: {same}; {il['phase5', K]:.3f} ms vs K=1 "
            f"{il['phase5', 1]:.3f} ms (medians of 10); launches on the five "
            f"shapes {il_launches[f'packet_traverse[interleave={K}]']}")
        check(same, f"interleave={K} disagrees with the plain version")
        il_entries.append({
            "name": f"packet_traverse[interleave={K}]",
            "route": "cuda",
            "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
            "replaces": "nanort_tpu/traverse/pallas_packet.py:1060",
            "launches": il_launches[f"packet_traverse[interleave={K}]"],
            "max_abs_err": err,
            "ms": il["phase5", K],
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
    k1_shape(f"phase 18 flags on phase 5's {m2} rays", fl_ms, f_bound)
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
            if what == "phase 5" and name == "exact":
                k1_shape(f"phase 18 traverse_bvh8_exact (two passes) on "
                         f"phase 5's rays (the flags pass's bound)", ms,
                         f_bound)
            check(same or ovf, f"{name} on {what} differs from single pass")
        lines.append(f"{what} single-pass exact {median(cuda_ms(lambda: packet.traverse_bvh8(s, r), 5)):.3f} ms")
    flags_launches = launch_counts()["packet_traverse[flags]"]
    say("phase 18 two-pass exact (medians of 5): " + "; ".join(lines)
        + f"; flags launches {flags_launches}")
    say("K1 resources (ptxas -v; the occupancy API):")
    for ln in k1_resources(usage_k1.result()):
        say("  " + ln)
    k1_edge_shapes(dev)

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


def _tables_equal(a, b) -> bool:
    """Two BVH8Scenes with the same sizes and bit-identical tables."""
    import torch

    for k in ("nodes", "leafs", "leafs_woop"):
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(
                x.cpu().view(torch.int32), y.cpu().view(torch.int32)):
            return False
    return all(getattr(a, k) == getattr(b, k)
               for k in ("num_nodes", "num_leaf_rows", "depth", "width"))


def frame_records_agree(got, want) -> dict:
    """Two records of one frame on two trees, on the card: the hit
    masks, t bit for bit, prim ids (where they differ t is bit-equal,
    so every difference is an equal-t tie), u/v where the prims agree."""
    import torch

    gh, wh = got.hit, want.hit
    both = gh & wh
    same_p = both & (got.prim_id == want.prim_id)
    uv = max(max_abs(got.u, want.u, same_p), max_abs(got.v, want.v, same_p))
    r = dict(rays=int(gh.numel()), hits=int(wh.sum()),
             hit_mismatch=int((gh != wh).sum()),
             t_bits_equal=torch.equal(got.t.view(torch.int32),
                                      want.t.view(torch.int32)),
             ties=int((both & ~same_p).sum()), uv_max_err=uv)
    r["ok"] = (r["hit_mismatch"] == 0 and r["t_bits_equal"]
               and uv <= 2e-6)
    return r


def device_build_phases(dev, v, f, scene, res: int = 8192):
    """Phase 19: the device build on the card (phase 4's sphere), its
    tables against the CPU's (midscale) and their structure, K1 and
    K1-woop against their plain versions on them, the frame on them
    against the host-built tree's records, and the same at ~10M
    triangles. Returns (K1 launches on the phase's paths, K1's largest
    error, K1-woop's launches, K1-woop's largest error)."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.device_collapse import collapse_lbvh_device
    from nanort_tpu_torch.io.procedural import (make_cornell_dense_pt_scene,
                                                make_subdivided_sphere_scene)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import compare_hits, wide_table_report
    from nanort_tpu_torch.traverse import packet

    t_phase = time.perf_counter()
    n_rays = res * res
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res, height=res,
                  fov=60.0, device=dev)
    rays_t, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    del cam
    sub = nt.Rays(*(x[::512].contiguous() for x in rays_t))  # 131,072

    def plain(s, rays, woop=False, stats=None):
        return packet._traverse_reference(
            s.nodes, s.leafs_woop if woop else s.leafs, s.width, rays.org,
            rays.dir, rays.min_t, rays.max_t, None, None, False, not woop,
            False, packet.stack_slots(s), woop, stats=stats)

    def path(vt, ft, woop=False):
        """The slice's path, counts zeroed before and read after: the
        device build, then K1 (or K1-woop) on the frame."""
        zero_launch_counts()
        t0 = time.perf_counter()
        s = collapse_lbvh_device(vt, ft, width=16, max_leaf=9, woop=woop)
        h = packet.traverse_bvh8(s, rays_t, intersector="woop" if woop
                                 else "watertight")
        torch.cuda.synchronize()
        return s, h, time.perf_counter() - t0, launch_counts()

    # ---- 19. the 1M build, timed after a warm-up
    vt, ft = torch.from_numpy(v).to(dev), torch.from_numpy(f).to(dev)
    holder = {"s": collapse_lbvh_device(vt, ft, width=16, max_leaf=9)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    b_ms = cuda_ms(lambda: holder.__setitem__(
        "s", collapse_lbvh_device(vt, ft, width=16, max_leaf=9)), 3)
    wall = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated() - base
    del holder
    s16, h_dev, path_s, counts = path(vt, ft)
    rep = wide_table_report(s16, len(f))
    say(f"# phase 19: collapse_lbvh_device(width=16, max_leaf=9) on the "
        f"card over phase 4's {len(f)} tris: ms "
        f"{[round(x, 3) for x in b_ms]} (CUDA events, after a warm-up; "
        f"{wall:.4f} s host wall a build, one sync); peak "
        f"{peak / 2**20:.1f} MiB above the {base / 2**30:.2f} GiB held; "
        f"{s16.num_nodes} nodes in {s16.nodes.shape[0]} rows, "
        f"{s16.num_leaf_rows} leaf rows in {s16.leafs.shape[0]}, depth "
        f"{s16.depth} (host-built BVH16: {scene.num_nodes} nodes, "
        f"{scene.num_leaf_rows} leaf rows, depth {scene.depth}); structure "
        f"{rep}")
    check(rep["ok"], f"phase 19: device tables fail the checks: {rep}")
    say(f"phase 19 path (build + frame, {path_s:.3f} s host wall): "
        f"launches {counts}")
    check(counts["packet_traverse"] == 1 and sum(counts.values()) == 1,
          f"phase 19 path launches {counts}")
    k1_launches = counts["packet_traverse"]

    # ---- 19. midscale: the card's tables are the CPU's
    dv, df, _, _ = make_cornell_dense_pt_scene(100_000)
    same = {}
    for name, kw in (("w16", dict(width=16)), ("w8", dict(width=8)),
                     ("w16 woop", dict(width=16, woop=True))):
        a = collapse_lbvh_device(dv, df, max_leaf=9, device="cpu", **kw)
        b = collapse_lbvh_device(torch.from_numpy(dv).to(dev),
                                 torch.from_numpy(df).to(dev), max_leaf=9,
                                 **kw)
        same[name] = _tables_equal(a, b) and wide_table_report(
            b, len(df))["ok"]
    say(f"phase 19 midscale ({len(df)} tris): card tables == CPU tables bit "
        f"for bit and well formed: {same}")
    check(all(same.values()), f"phase 19 midscale tables differ: {same}")

    # ---- 19. K1 on the device tables == plain, 131,072 frame rays
    got = packet.traverse_bvh8(s16, sub)
    st = {}
    ref = plain(s16, sub, stats=st)
    k1_same = all(torch.equal(a, b) for a, b in zip(got, ref))
    k1_err = record_err(got, ref)
    k_ms = median(cuda_ms(lambda: packet.traverse_bvh8(s16, sub), 10))
    p_ms = min(cuda_ms(lambda: plain(s16, sub), 2))
    k1_b = bound(sub.org.shape[0] * (32 + 20) + row_bytes(st),
                 trace_ops(st, 16, WT_OPS))
    say(f"phase 19 K1 on the device tables, {sub.org.shape[0]} of the "
        f"frame's rays (every 512th): kernel == plain bit for bit: "
        f"{k1_same} (max abs err {k1_err}); kernel {k_ms:.3f} ms (median of "
        f"10), plain {p_ms:.1f} ms; work {st}")
    check(k1_same, "phase 19: K1 differs from its plain version on device "
          "tables")
    k1_shape(f"phase 19 K1 on device-built BVH16, {sub.org.shape[0]} frame "
             f"rays", k_ms, k1_b)

    # ---- 19. the frame on both trees, in turns (host, device, device, host)
    h_host = packet.traverse_bvh8(scene, rays_t)
    c = frame_records_agree(h_dev, h_host)
    say(f"phase 19 frame records, device tree vs host tree: {c}")
    check(c["ok"], f"phase 19: frame records differ: {c}")
    del h_dev, h_host, got, ref
    holder = {}

    def frame(s):
        holder.pop("h", None)  # the last records back to the allocator
        holder["h"] = packet.traverse_bvh8(s, rays_t)

    frame(s16)
    turns = {"host": [], "device": []}
    for who in ("host", "device", "device", "host"):
        s = scene if who == "host" else s16
        turns[who] += cuda_ms(lambda: frame(s), 1)
    holder.clear()
    best = {k: min(x) for k, x in turns.items()}
    say(f"phase 19 the {res}^2 frame in turns (host, device, device, host): "
        f"host-built BVH16 ms {[round(x, 3) for x in turns['host']]} = "
        f"{n_rays / best['host'] / 1e3:.1f} Mrays/s, device-built "
        f"{[round(x, 3) for x in turns['device']]} = "
        f"{n_rays / best['device'] / 1e3:.1f} Mrays/s; traversal tax "
        f"{best['device'] / best['host'] - 1:+.4f}")
    # the frame's work on each tree, counted on every 1,024th ray
    work = {}
    for who, s in (("host", scene), ("device", s16)):
        work[who] = {}
        plain(s, nt.Rays(*(x[::1024].contiguous() for x in rays_t)),
              stats=work[who])
    frame_b = bound(n_rays * (32 + 20) + nbytes(s16.nodes, s16.leafs),
                    trace_ops(work["device"], 16, WT_OPS) * 1024)
    say(f"phase 19 frame work (every 1,024th ray, x1024): host tree "
        f"{work['host']}, device tree {work['device']}; device bound "
        f"{frame_b[0]:.4f} ms ({frame_b[1]})")
    k1_shape(f"phase 19: the {res}^2 frame on the device-built BVH16 (best "
             f"of 2)", best["device"], frame_b)

    # ---- 19. K1-woop on woop tables: its path, then == plain
    sw, h_w, w_s, counts = path(vt, ft, woop=True)
    say(f"phase 19 woop path (build woop=True + K1-woop frame, {w_s:.3f} s "
        f"host wall): launches {counts}; hit fraction "
        f"{float(h_w.hit.float().mean()):.5f}")
    check(counts["packet_traverse_woop"] == 1 and sum(counts.values()) == 1,
          f"phase 19 woop path launches {counts}")
    woop_launches = counts["packet_traverse_woop"]
    del h_w
    got = packet.traverse_bvh8(sw, sub, intersector="woop")
    ref = plain(sw, sub, woop=True)
    w_same = all(torch.equal(a, b) for a, b in zip(got, ref))
    woop_err = record_err(got, ref)
    w_ms = median(cuda_ms(lambda: packet.traverse_bvh8(
        sw, sub, intersector="woop"), 10))
    say(f"phase 19 K1-woop on device woop tables, {sub.org.shape[0]} frame "
        f"rays: kernel == plain bit for bit: {w_same} (max abs err "
        f"{woop_err}); kernel {w_ms:.3f} ms (median of 10)")
    check(w_same, "phase 19: K1-woop differs from its plain version")
    del sw, got, ref, s16, vt, ft
    torch.cuda.empty_cache()

    # ---- 19. ~10M triangles: the build's seconds and peak memory, then
    # the frame (no host-built tree at this size: the frame's sampled
    # pixels are held to brute force, a subset to the plain version)
    t0 = time.perf_counter()
    v10, f10 = make_subdivided_sphere_scene(10_000_000)
    gen_s = time.perf_counter() - t0
    vt, ft = torch.from_numpy(v10).to(dev), torch.from_numpy(f10).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s10 = collapse_lbvh_device(vt, ft, width=16, max_leaf=9)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del s10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s10 = collapse_lbvh_device(vt, ft, width=16, max_leaf=9)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rep = wide_table_report(s10, len(f10))
    say(f"# phase 19 at {len(f10)} tris (generated in {gen_s:.2f} s): "
        f"collapse_lbvh_device(width=16, max_leaf=9) {cold_s:.3f} s first, "
        f"{warm_s:.3f} s warm (host wall, synced); "
        f"torch.cuda.max_memory_allocated() {peak} B = "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before the build); {s10.num_nodes} "
        f"nodes, {s10.num_leaf_rows} leaf rows, depth {s10.depth}, merge and "
        f"preorder off (above 4M prims); structure {rep}")
    check(rep["ok"], f"phase 19 10M: tables fail the checks: {rep}")
    del s10
    s10, h10, p10_s, counts = path(vt, ft)
    check(counts["packet_traverse"] == 1 and sum(counts.values()) == 1,
          f"phase 19 10M path launches {counts}")
    k1_launches += counts["packet_traverse"]
    frac = float(h10.hit.float().mean())
    r_img = 1.0 / math.sqrt(2.2 ** 2 - 1.0)
    expect = math.pi * r_img ** 2 / (2.0 * math.tan(math.radians(30.0))) ** 2
    pick = torch.from_numpy(np.random.default_rng(12).choice(
        n_rays, 1024, replace=False)).to(dev)
    c = compare_hits(nt.Hits(*(x[pick] for x in h10)), nt.brute_force_traverse(
        TriangleMesh(vt, ft), nt.Rays(*(x[pick] for x in rays_t)),
        chunk_size=16384))
    del h10
    sub10 = nt.Rays(*(x[::4096].contiguous() for x in rays_t))
    got = packet.traverse_bvh8(s10, sub10)
    ref = plain(s10, sub10)
    same10 = all(torch.equal(a, b) for a, b in zip(got, ref))
    k1_err = max(k1_err, record_err(got, ref))
    holder = {}
    ms10 = cuda_ms(lambda: frame(s10), 3)
    holder.clear()
    say(f"phase 19 10M path (build + frame, {p10_s:.3f} s host wall): "
        f"launches {counts}; frame ms {[round(x, 3) for x in ms10]} = "
        f"{n_rays / min(ms10) / 1e3:.1f} Mrays/s best; hit fraction "
        f"{frac:.5f} (disc coverage {expect:.5f}); 1,024 sampled pixels vs "
        f"brute force: {c}; K1 == plain on {sub10.org.shape[0]} frame rays: "
        f"{same10}")
    check(abs(frac - expect) < 5e-3 and c["ok"] and same10,
          "phase 19 10M: the frame is wrong")

    # ---- 19. ~10M with leaf merging and preorder asked for explicitly
    # (the default turns both off above 4M prims, a TPU memory threshold)
    del got, ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s10x = collapse_lbvh_device(vt, ft, width=16, max_leaf=9,
                                merge_leaves=True, preorder=True)
    torch.cuda.synchronize()
    x_cold = time.perf_counter() - t0
    del s10x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_x = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s10x = collapse_lbvh_device(vt, ft, width=16, max_leaf=9,
                                merge_leaves=True, preorder=True)
    torch.cuda.synchronize()
    x_warm = time.perf_counter() - t0
    peak_x = torch.cuda.max_memory_allocated()
    rep_x = wide_table_report(s10x, len(f10))
    got = packet.traverse_bvh8(s10x, sub10)
    ref = plain(s10x, sub10)
    same_x = all(torch.equal(a, b) for a, b in zip(got, ref))
    k1_err = max(k1_err, record_err(got, ref))
    del got, ref
    c_x = frame_records_agree(packet.traverse_bvh8(s10x, rays_t),
                              packet.traverse_bvh8(s10, rays_t))
    frame(s10x)
    turns = {"default": [], "merged": []}
    for who in ("default", "merged", "merged", "default"):
        s = s10 if who == "default" else s10x
        turns[who] += cuda_ms(lambda: frame(s), 1)
    holder.clear()
    work = {}
    for who, s in (("default", s10), ("merged", s10x)):
        work[who] = {}
        plain(s, nt.Rays(*(x[::1024].contiguous() for x in rays_t)),
              stats=work[who])
    best = {k: min(x) for k, x in turns.items()}
    say(f"phase 19 10M with merge_leaves=True, preorder=True: build "
        f"{x_cold:.3f} s first, {x_warm:.3f} s warm (host wall, synced); "
        f"torch.cuda.max_memory_allocated() {peak_x / 2**30:.3f} GiB "
        f"({(peak_x - base_x) / 2**30:.3f} above the {base_x / 2**30:.3f} "
        f"held); {s10x.num_nodes} nodes, {s10x.num_leaf_rows} leaf rows, "
        f"depth {s10x.depth} (default: {s10.num_nodes}, "
        f"{s10.num_leaf_rows}, {s10.depth}); structure {rep_x['ok']}; K1 == "
        f"plain on {sub10.org.shape[0]} frame rays: {same_x}; frame records "
        f"vs the default tables {c_x}; the {res}^2 frame in turns (default, "
        f"merged, merged, default): default ms "
        f"{[round(x, 3) for x in turns['default']]}, merged "
        f"{[round(x, 3) for x in turns['merged']]}, ratio "
        f"{best['merged'] / best['default']:.4f}; work on every 1,024th ray: "
        f"default {work['default']}, merged {work['merged']}")
    check(rep_x["ok"] and same_x and c_x["ok"],
          "phase 19 10M merged tables: wrong structure or records")
    del s10x
    del s10, vt, ft, rays_t, sub, sub10
    torch.cuda.empty_cache()
    say(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return k1_launches, k1_err, woop_launches, woop_err


def lidar_spheres(n: int, seed: int = 21):
    """A LiDAR-like point cloud: ``n`` points on a 100 m x 100 m rolling
    terrain (z up to +-2 m plus 5 cm of noise), one sphere of 4-8 cm a
    point, as the LAS viewer draws them."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-50.0, 50.0, (n, 2))
    z = 2.0 * np.sin(xy[:, 0] / 7.0) * np.cos(xy[:, 1] / 5.0) \
        + rng.normal(0.0, 0.05, n)
    c = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    return c, rng.uniform(0.04, 0.08, n).astype(np.float32)


def branch_cylinders(n: int, seed: int = 22):
    """``n`` capped segments (branches) in a 20 m box, 2-10 cm thick."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-10.0, 10.0, (n, 3))
    p1 = p0 + rng.normal(0.0, 0.5, (n, 3))
    return (p0.astype(np.float32), p1.astype(np.float32),
            rng.uniform(0.02, 0.1, n).astype(np.float32),
            rng.uniform(0.02, 0.1, n).astype(np.float32))


def hair_curves(n: int, seed: int = 23):
    """``n`` cubic Bezier strands rooted on a unit sphere, growing
    outwards about 0.3 with a random curl, 2-5 mm thick, thinning."""
    rng = np.random.default_rng(seed)
    root = rng.normal(size=(n, 3))
    root /= np.linalg.norm(root, axis=1, keepdims=True)
    steps = root[:, None, :] * np.asarray([0.0, 0.1, 0.2, 0.3])[None, :, None]
    curl = np.cumsum(rng.normal(0.0, 0.03, (n, 4, 3)), axis=1)
    curl[:, 0] = 0.0
    pts = (root[:, None, :] + steps + curl).astype(np.float32)
    r = np.linspace(1.0, 0.4, 4)[None, :] * rng.uniform(0.002, 0.005, (n, 1))
    return pts, r.astype(np.float32)


def feature_phases(dev, cpu_every: int = 64):
    """Phase 20: spheres (1M, 512^2 rays), cylinders (100,000, 512^2
    rays), curves (100,000, 4 subdivisions, 256^2 rays) and K = 8
    multi-hit (both engines, midscale, 262,144 rays) on the card, each
    held to the same port code on the CPU over every ``cpu_every``-th ray
    (4,096 of 512^2, spread over the image: its first rows are sky).
    Plain torch: no kernel may launch."""
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch import interop
    from nanort_tpu_torch.io.procedural import make_cornell_dense_pt_scene
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops import curve, cylinder, sphere
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import compare_hits, ulp_distance
    from nanort_tpu_torch.traverse import multi_hit
    from nanort_tpu_torch.traverse.packed import pack_scene

    t_phase = time.perf_counter()

    def camera(eye, center, res=512, fov=50.0):
        r = pinhole_rays(look_at(eye, center, width=res, height=res,
                                 fov=fov, device=dev))
        return nt.Rays(*(x.reshape((res * res,) + x.shape[2:]).contiguous()
                         for x in r))

    def cpu(rays):
        return nt.Rays(*(x[::cpu_every].cpu() for x in rays))

    def head(tree):
        """The rays (records) the CPU run traces, on the host."""
        return type(tree)(*(x[::cpu_every].cpu() for x in tree))

    def timed(fn):
        """``fn()`` once, timed, with the launch counts zeroed first:
        (result, seconds, launches). Plain torch has nothing to compile,
        so no warm-up run: the phase keeps inside the script's time."""
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    runs = []
    # spheres: the LiDAR viewer's scale
    c, r = lidar_spheres(1_000_000)
    t0 = time.perf_counter()
    s_card = interop.spheres_from_numpy(c, r, device=dev)
    bvh, _ = sphere.build_sphere_bvh(s_card)
    build_s = time.perf_counter() - t0
    rays = camera((0.0, -60.0, 40.0), (0.0, 0.0, 0.0))
    runs.append(("spheres", len(r), build_s, rays,
                 lambda: sphere.traverse_spheres(bvh, s_card, rays),
                 lambda: sphere.traverse_spheres(
                     bvh, interop.spheres_from_numpy(c, r, device="cpu"),
                     cpu(rays))))
    cyl = branch_cylinders(100_000)
    t0 = time.perf_counter()
    c_card = interop.cylinders_from_numpy(*cyl, device=dev)
    cbvh, _ = cylinder.build_cylinder_bvh(c_card)
    cbuild_s = time.perf_counter() - t0
    crays = camera((0.0, -30.0, 8.0), (0.0, 0.0, 0.0))
    runs.append(("cylinders", len(cyl[2]), cbuild_s, crays,
                 lambda: cylinder.traverse_cylinders(cbvh, c_card, crays),
                 lambda: cylinder.traverse_cylinders(
                     cbvh, interop.cylinders_from_numpy(*cyl, device="cpu"),
                     cpu(crays))))
    hair = hair_curves(100_000)
    t0 = time.perf_counter()
    h_card = interop.curves_from_numpy(*hair, device=dev)
    hbvh, _ = curve.build_curve_bvh(h_card)
    hbuild_s = time.perf_counter() - t0
    hrays = camera((0.0, -4.0, 0.5), (0.0, 0.0, 0.0), res=256, fov=40.0)
    runs.append(("curves (4 subdivisions)", len(hair[1]), hbuild_s, hrays,
                 lambda: curve.traverse_curves(hbvh, h_card, hrays,
                                               num_subdivisions=4),
                 lambda: curve.traverse_curves(
                     hbvh, interop.curves_from_numpy(*hair, device="cpu"),
                     cpu(hrays), num_subdivisions=4)))
    for what, n, b_s, rr, on_card, on_cpu in runs:
        got, secs, counts = timed(on_card)
        want = on_cpu()
        cmp_ = compare_hits(head(got), want, uv_atol=1e-6)
        R = rr.org.shape[0]
        say(f"# phase 20 {what}: {n} prims (host BVH {b_s:.2f} s), {R} "
            f"rays: {secs:.3f} s = {R / secs / 1e6:.3f} Mrays/s (one "
            f"run), hit fraction {float(got.hit.float().mean()):.4f}; "
            f"every {cpu_every}th ray on the card vs the CPU: {cmp_}; "
            f"launches {counts}")
        check(cmp_["ok"] and cmp_["ties"] == 0 and cmp_["hits"] > 0,
              f"phase 20 {what}: the card differs from the CPU")
        check(sum(counts.values()) == 0, f"phase 20 {what} launched a kernel")
    del runs, s_card, c_card, h_card, bvh, cbvh, hbvh
    torch.cuda.empty_cache()

    # multi-hit at K = 8 on the midscale scene, both engines
    dv, df, _, _ = make_cornell_dense_pt_scene(100_000)
    mbvh, _ = nt.build_triangle_bvh(TriangleMesh(dv, df))
    packed = pack_scene(mbvh, dv, df)
    mesh = TriangleMesh(torch.from_numpy(dv).to(dev),
                        torch.from_numpy(df).to(dev))
    g = np.random.default_rng(24)
    R = 262_144
    org = g.uniform(-0.9, 0.9, (R, 3)).astype(np.float32)
    d = g.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mrays = nt.make_rays(torch.from_numpy(org).to(dev),
                         torch.from_numpy(d).to(dev))
    cmesh = TriangleMesh(torch.from_numpy(dv), torch.from_numpy(df))
    for engine, on_card, on_cpu in (
            ("multi_hit_traverse",
             lambda: multi_hit.multi_hit_traverse(mbvh, mesh, mrays, 8),
             lambda: multi_hit.multi_hit_traverse(mbvh, cmesh, cpu(mrays),
                                                  8)),
            ("multi_hit_wavefront",
             lambda: multi_hit.multi_hit_wavefront(packed, mrays, 8),
             lambda: multi_hit.multi_hit_wavefront(packed, cpu(mrays), 8))):
        got, secs, counts = timed(on_card)
        want = on_cpu()
        part = head(got)
        valid = want.prim_id != nt.INVALID_PRIM_ID
        same = (torch.equal(part.count, want.count)
                and torch.equal(part.prim_id, want.prim_id))
        t_ulp = int(ulp_distance(part.t[valid], want.t[valid]).max(initial=0))
        say(f"# phase 20 {engine}, K = 8, midscale {len(df)} tris, {R} "
            f"rays inside the box: {secs:.3f} s = {R / secs / 1e6:.3f} "
            f"Mrays/s (one run); hits a ray: mean "
            f"{float(got.count.float().mean()):.3f}, max "
            f"{int(got.count.max())}; every {cpu_every}th ray on the card vs "
            f"the CPU: counts and prim ids equal {same}, t max ulp {t_ulp}; "
            f"launches {counts}")
        check(same and t_ulp <= 4 and int(got.count.max()) >= 2,
              f"phase 20 {engine}: the card differs from the CPU")
        check(sum(counts.values()) == 0, f"phase 20 {engine} launched a "
              "kernel")
    say(f"phase 20: {time.perf_counter() - t_phase:.1f} s")


def _rtc_cpu_copy(sc):
    """A committed ``RTCScene`` whose tables are copies of ``sc``'s on the
    CPU (same geometry, same build): the card's calls against the CPU's
    on the same tables."""
    import dataclasses

    import torch

    from nanort_tpu_torch.api import rtc
    from nanort_tpu_torch.scene.graph import CommittedScene, Scene

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    out = rtc.new_device(device="cpu").new_scene()
    out._geoms, out._node_of = sc._geoms, sc._node_of
    cs = sc._sg.committed
    out._sg = Scene(device="cpu")
    out._sg._committed = CommittedScene(
        *(dataclasses.replace(x, nodes=x.nodes.cpu(), soup=x.soup.cpu())
          if k == "packed" else cpu(x) for k, x in zip(cs._fields, cs)))
    out._scene8 = dataclasses.replace(sc._scene8, nodes=sc._scene8.nodes.cpu(),
                                      leafs=sc._scene8.leafs.cpu())
    out._flat_pack = tuple(x.cpu() for x in sc._flat_pack)
    out._committed = True
    return out


def _card_vs_cpu(got, want) -> dict:
    """Scene hit records of the card against the CPU's: the same hit mask,
    geometry (node) and local prim ids, t within 4 ulp where both hit."""
    from nanort_tpu_torch.testing import ulp_distance

    g = type(got)(*(x.cpu() for x in got))
    h = want.hit
    r = {"rays": int(h.numel()), "hits": int(h.sum()),
         "hit_mismatch": int((g.hit != h).sum()),
         "id_mismatch": int(((g.node_id != want.node_id)
                             | (g.prim_id != want.prim_id)).sum()),
         "t_ulp_max": int(ulp_distance(g.t[h], want.t[h]).max(initial=0))}
    r["ok"] = (r["hit_mismatch"] == 0 and r["id_mismatch"] == 0
               and r["t_ulp_max"] <= 4 and r["hits"] > 0)
    return r


def api_phases(dev, res: int = 2048, n_geoms: int = 10) -> tuple:
    """Phase 21: the Embree-style API and the scene graph at real size.
    Returns (K1 launches on the phase's paths, K1's largest error against
    its plain version, the ``packet_traverse[rtc]`` entry)."""
    import tempfile

    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.api import rtc
    from nanort_tpu_torch.io import gltf
    from nanort_tpu_torch.io.procedural import make_cornell_dense_pt_scene
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.scene import matrix as mat
    from nanort_tpu_torch.testing import ring_glb
    from nanort_tpu_torch.traverse import packet

    t_phase = time.perf_counter()
    dv, df, _, _ = make_cornell_dense_pt_scene(100_000)
    # the ring: each copy turned about its own tilted axis and set on a
    # circle of radius 3.5 around the origin
    ring = []
    for k in range(n_geoms):
        a = 2.0 * np.pi * k / n_geoms
        ring.append(((3.5 * np.cos(a), 0.25 * (k % 3) - 0.25, 3.5 * np.sin(a)),
                     (0.15 * k - 0.6, 1.0, 0.2), 0.6 * k + 0.3))
    sc = rtc.new_device(device=dev).new_scene()
    for t, axis, ang in ring:
        g = sc.new_triangle_mesh(len(df), len(dv))
        sc.map_buffer(g, rtc.BufferType.VERTEX)[:] = dv
        sc.map_buffer(g, rtc.BufferType.INDEX)[:] = df
        sc.set_transform(g, mat.compose(mat.translate(t),
                                        mat.rotate(axis, ang)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    s8 = sc._scene8
    n_tris = n_geoms * len(df)
    say(f"# phase 21: rtc scene of {n_geoms} transformed copies of midscale "
        f"({len(df)} tris each, {n_tris} world tris); commit on the card "
        f"{commit_s:.3f} s host wall ({n_geoms} graph builds, the packed "
        f"tables, one BVH8 of the world-space union: {s8.num_nodes} nodes, "
        f"{s8.num_leaf_rows} leaf rows, depth {s8.depth})")
    check(n_tris == 992_360 and s8 is not None and s8.nodes.is_cuda,
          "phase 21: the fast tables are not on the card")

    cam = look_at((0.0, 5.0, 9.0), (0.0, 0.0, 0.0), width=res, height=res,
                  fov=55.0, device=dev)
    rays = pinhole_rays(cam)
    del cam
    n_rays = res * res
    launches = 0
    holder = {}
    results = {}
    for name, call in (("intersect", lambda: sc.intersect(rays)),
                       ("occluded", lambda: sc.occluded(rays))):
        ms, counts = [], []
        for rep in range(4):  # a warm-up, then 3 timed
            zero_launch_counts()
            t = cuda_ms(lambda: holder.__setitem__(name, call()), 1)[0]
            counts.append(launch_counts())
            if rep:
                ms.append(t)
        launches += sum(c["packet_traverse"] for c in counts)
        one = all(c["packet_traverse"] == 1 and sum(c.values()) == 1
                  for c in counts)
        results[name] = (ms, one)
        say(f"phase 21 {name} on {n_rays} pinhole rays: ms "
            f"{[round(x, 3) for x in ms]} (CUDA events, after a warm-up) = "
            f"{n_rays / min(ms) / 1e3:.1f} Mrays/s best; K1 launches a call "
            f"{[c['packet_traverse'] for c in counts]}, others none: {one}")
        check(one, f"phase 21 {name}: K1 launches "
              f"{[c['packet_traverse'] for c in counts]}, all "
              f"{[sum(c.values()) for c in counts]}")
    hits = holder["intersect"]
    frac = float(hits.hit.float().mean())
    check(0.05 < frac < 0.95 and torch.equal(holder["occluded"], hits.hit),
          f"phase 21: hit fraction {frac}, or occluded differs from "
          "intersect's hit mask")

    # K1 against its plain version on every 32nd of each call's sorted rays
    err = 0.0
    entry = None
    for name, call in (("intersect", lambda: sc.intersect(rays)),
                       ("occluded", lambda: sc.occluded(rays))):
        (srays, a, kw, got), = capture_traces(call)
        sub = nt.Rays(*(x.reshape(-1, *x.shape[1:])[::32].contiguous()
                        for x in srays))
        g = nt.Hits(*(x[::32] for x in got))
        h = hold_k1_trace(s8, sub, a, kw, g)
        err = max(err, h["err"])
        b = bound(h["rays"] * (32 + 20) + row_bytes(h["stats"]),
                  trace_ops(h["stats"], s8.width, WT_OPS))
        full_ms = median(cuda_ms(lambda: packet.traverse_bvh8(
            s8, srays, *a, **kw), 3))
        full_b = bound(n_rays * (32 + 20) + nbytes(s8.nodes, s8.leafs),
                       trace_ops(h["stats"], s8.width, WT_OPS) * 32)
        say(f"phase 21 {name}'s K1 launch, every 32nd of its {n_rays} sorted "
            f"rays ({h['rays']}, {h['hits']} hits): kernel == plain bit for "
            f"bit: {h['same']} (max abs err {h['err']}); kernel "
            f"{h['ms']:.3f} ms (median of 5), plain {h['plain_ms']:.1f} ms; "
            f"bound {b[0]:.4f} ms ({b[1]}); work {h['stats']}; the whole "
            f"launch {full_ms:.3f} ms (median of 3), bound {full_b[0]:.4f} "
            f"({full_b[1]})")
        check(h["same"], f"phase 21: K1 differs from its plain version on "
              f"{name}'s sorted rays")
        k1_shape(f"phase 21 rtc.{name}, {n_rays} sorted rays over "
                 f"{n_tris} world tris (median of 3)", full_ms, full_b)
        if name == "intersect":
            entry = {
                "name": "packet_traverse[rtc]",
                "route": "cuda",
                "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
                "replaces": "nanort_tpu/traverse/pallas_packet.py:66",
                "launches": launches,
                "max_abs_err": h["err"],
                "ms": h["ms"],
                "plain_ms": h["plain_ms"],
                "bound_ms": b[0],
                "bound_by": b[1],
                "library_ms": None,
            }

    # the card against the CPU on 4,096 rays spread over the image
    cpu_sc = _rtc_cpu_copy(sc)
    flat = nt.Rays(*(x.reshape(n_rays, *x.shape[2:]) for x in rays))
    spread = nt.Rays(*(x[::1024].contiguous() for x in flat))
    spread_cpu = nt.Rays(*(x.cpu() for x in spread))
    c_fast = _card_vs_cpu(sc.intersect(spread), cpu_sc.intersect(spread_cpu))
    c_graph = _card_vs_cpu(sc._sg.traverse(spread),
                           cpu_sc._sg.traverse(spread_cpu))
    say(f"phase 21 card vs CPU on {spread.org.shape[0]} spread rays: fast "
        f"route {c_fast}; Scene.traverse {c_graph}")
    check(c_fast["ok"] and c_graph["ok"], "phase 21: the card differs from "
          "the CPU")

    # the fast route against the graph walk on 65,536 spread rays
    wide = nt.Rays(*(x[::64].contiguous() for x in flat))
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = sc._sg.traverse(wide)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    walk_counts = launch_counts()
    fast = sc.intersect(wide)
    hf, hw = fast.hit, walk.hit
    both = hf & hw
    geom_walk = torch.tensor(sorted(sc._geoms), device=dev)[
        walk.node_id.clamp(max=n_geoms - 1)]
    mism = float((hf != hw).float().mean())
    ids = float(((fast.node_id != geom_walk) | (fast.prim_id != walk.prim_id)
                 )[both].float().mean())
    rel = float(((fast.t - walk.t).abs() / walk.t.abs())[both].max())
    n_w = wide.org.shape[0]
    say(f"phase 21 fast route vs graph walk on {n_w} spread rays: hit masks "
        f"differ on {mism:.6f} of rays, ids on {ids:.6f} of {int(both.sum())} "
        f"rays both hit, largest relative t error {rel:.3e} (bounds 0.01, "
        f"0.01, 1e-5, the CPU test's); the walk {walk_s:.3f} s = "
        f"{n_w / walk_s / 1e6:.3f} Mrays/s, launches {nonzero(walk_counts)}")
    check(mism <= 0.01 and ids <= 0.01 and rel <= 1e-5 and int(both.sum()),
          "phase 21: the fast route and the graph walk disagree")
    check(sum(walk_counts.values()) == 0, "phase 21: the graph walk launched "
          "a kernel")
    del holder, hits, fast, walk, cpu_sc

    # the glTF path: one buffer, 10 TRS nodes, in a .glb on disk
    import nanort_tpu_torch

    builds = []
    real_build = nanort_tpu_torch.build_triangle_bvh

    def counted(*a, **k):
        builds.append(1)
        return real_build(*a, **k)

    gres = 256
    with tempfile.TemporaryDirectory() as d, \
            patched(nanort_tpu_torch, "build_triangle_bvh", counted):
        path = os.path.join(d, "ring.glb")
        ring_glb(path, dv, df, ring)
        t0 = time.perf_counter()
        g = gltf.load_gltf(path)
        load_s = time.perf_counter() - t0
        gsc = gltf.to_scene_graph(g, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gsc.commit()
        torch.cuda.synchronize()
        gcommit_s = time.perf_counter() - t0
        n_builds = len(builds)
        gcam = look_at((0.0, 5.0, 9.0), (0.0, 0.0, 0.0), width=gres,
                       height=gres, fov=55.0, device=dev)
        grays = pinhole_rays(gcam)
        zero_launch_counts()
        t0 = time.perf_counter()
        gh = gsc.traverse(grays)
        torch.cuda.synchronize()
        gtrav_s = time.perf_counter() - t0
        gcounts = launch_counts()
        gsc.find_node("ring3#3").translate(dx=0.5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gsc.commit()
        torch.cuda.synchronize()
        recommit_s = time.perf_counter() - t0
        gh2 = gsc.traverse(grays)
        rebuilt = len(builds) - n_builds
    nodes_seen = sorted(set(gh.node_id[gh.hit].tolist()))
    moved = int((gh2.t != gh.t).sum())
    say(f"phase 21 glTF: {len(g.instances)} TRS nodes over one {len(df)}-tri "
        f"buffer, load_gltf {load_s:.3f} s, commit {gcommit_s:.3f} s "
        f"({n_builds} BVH build), traverse {gres}^2 rays {gtrav_s:.3f} s = "
        f"{gres * gres / gtrav_s / 1e6:.3f} Mrays/s, hit fraction "
        f"{float(gh.hit.float().mean()):.4f}, instances seen {nodes_seen}, "
        f"launches {nonzero(gcounts)}; re-commit after one translate {recommit_s:.3f} "
        f"s with {rebuilt} builds, {moved} rays' t changed")
    check(n_builds == 1 and rebuilt == 0 and len(nodes_seen) >= 5
          and moved > 0 and recommit_s < gcommit_s,
          "phase 21: the glTF path is wrong")
    say(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return launches, err, entry


def renderer_phases(dev, res: int = 1024, sphere=(64, 128)) -> tuple:
    """Phase 22: PBR, BDPT, the UV atlas, the cameras and the progressive
    loop on the card. Returns (K1 launches, K1's largest error, K1-woop
    launches, K1-woop's largest error, the AOV kernel's launches)."""
    import threading

    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_cornell_dense_pt_scene, make_uv_sphere,
        merge_meshes)
    from nanort_tpu_torch.models import bdpt, cameras, pbr, path_tracer
    from nanort_tpu_torch.models.progressive import ProgressiveRenderer
    from nanort_tpu_torch.models.uv_raster import rasterize_uv_atlas
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import ulp_distance

    t_phase = time.perf_counter()
    # ---- PBR on config A's scene with BVH16 tables
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(*sphere, 0.6))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    mat = pbr.PBRMaterial(torch.tensor([0.75, 0.6, 0.45], device=dev),
                          torch.tensor(0.2, device=dev),
                          torch.tensor(0.45, device=dev))
    cam = cameras.look_at((0.3, 0.4, 2.6), (0.0, -0.1, 0.0), width=res,
                          height=res, fov=55.0, device=dev)
    rays = cameras.pinhole_rays(cam)
    holder = {}
    ms, busy, counts = time_calls(lambda: holder.__setitem__(
        "out", pbr.render_pbr(bvh, mesh, rays, mat, scene8=s16)))
    aovs, hits = holder.pop("out")
    rgb = aovs["rgb"]
    k1 = counts["packet_traverse"]
    say(f"# phase 22: render_pbr on config A's scene ({len(f)} tris, BVH16) "
        f"at {res}^2 with shadows: ms {[round(x, 3) for x in ms]} (CUDA "
        f"events, after a warm-up; device busy {busy:.3f}), launches over "
        f"4 renders {nonzero(counts)}; image mean {float(rgb.mean()):.5f}")
    check(nonzero(counts) == {"packet_traverse": 8, "aovs_fused": 4},
          f"phase 22 render_pbr launches {nonzero(counts)}, expected 2 K1 "
          "and 1 AOV kernel a render")
    aov_launches = counts.get("aovs_fused", 0)
    check(bool(torch.isfinite(rgb).all()) and float(rgb.mean()) > 0.01,
          "phase 22: the PBR image is not finite or black")
    pick = torch.arange(0, res * res, 256, device=dev)  # 4,096 spread pixels
    flat = nt.Rays(*(x.reshape(res * res, *x.shape[2:])[pick] for x in rays))
    ca, ch = pbr.render_pbr(
        bvh, TriangleMesh(mesh.vertices.cpu(), mesh.faces.cpu()),
        nt.Rays(*(x.cpu() for x in flat)),
        pbr.PBRMaterial(*(x.cpu() for x in mat)), scene8=s16.to("cpu"))
    got_rgb = rgb.reshape(res * res, 3)[pick].cpu()
    ids = torch.equal(hits.prim_id.reshape(-1)[pick].cpu(), ch.prim_id)
    perr = float((got_rgb - ca["rgb"]).abs().max())
    psame = float((got_rgb == ca["rgb"]).all(1).float().mean())
    say(f"phase 22 render_pbr card vs CPU on {pick.numel()} spread pixels: "
        f"prim ids equal {ids}, rgb bit-identical on {psame:.4f}, max abs "
        f"diff {perr:.3e} ({int(ch.hit.sum())} hits)")
    check(ids and perr <= 1e-5, "phase 22: render_pbr on the card differs "
          "from the CPU")
    launches, err = k1, 0.0
    del holder, aovs, rgb, hits, ca, ch

    # ---- BDPT on the midscale PTScene (BVH16 tables: K1), then on its
    # Woop twin (K1-woop), each launch held to the plain version
    woop_launches, woop_err = 0, 0.0
    dv, df, dm, dmats = make_cornell_dense_pt_scene(100_000)
    for engine, bres in (("pallas", 256), ("turbo", 128)):
        scene = path_tracer.make_pt_scene(dv, df, dm, dmats, engine=engine,
                                          device=dev)
        bcam = cameras.look_at((0.0, 0.0, 2.6), (0.0, 0.0, 0.0), width=bres,
                               height=bres, fov=45.0, device=dev)
        br = cameras.pinhole_rays(bcam)
        org, d = br.org.reshape(-1, 3), br.dir.reshape(-1, 3)
        cdf, total = bdpt._light_sampler_arrays(scene)

        def run():
            return bdpt.trace_bdpt(scene, org, d, cdf, 5, total)

        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        col = run()
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        counts = launch_counts()
        key = "packet_traverse_woop" if engine == "turbo" else "packet_traverse"
        kept = capture_traces(run)
        same, e = True, 0.0
        for srays, a, kw, got in kept:
            h = hold_k1_trace(scene.scene8, srays, a, kw, got, m=16384)
            same &= h["same"]
            e = max(e, h["err"])
        n_l = counts[key]
        say(f"phase 22 trace_bdpt, midscale {len(df)} tris (engine "
            f"{engine!r}), {bres}^2 x 1 sample, 5 eye + 4 light bounces: "
            f"{b_s:.3f} s, launches {nonzero(counts)}; each of its {len(kept)} "
            f"captured launches == plain on its first 16,384 sorted rays: "
            f"{same} (max abs err {e}); image mean {float(col.mean()):.5f}")
        check(n_l == len(kept) and n_l > 0 and sum(counts.values()) == n_l
              and same, f"phase 22 trace_bdpt ({engine}): launches {nonzero(counts)}, "
              f"captured {len(kept)}, == plain {same}")
        check(bool(torch.isfinite(col).all()) and float(col.mean()) > 0,
              f"phase 22 trace_bdpt ({engine}): the image is not finite or "
              "black")
        if engine == "turbo":
            woop_launches, woop_err = n_l, e
        else:
            launches += n_l
            err = max(err, e)
        del scene, col, kept

    # ---- the UV atlas (stack engine), card against the CPU
    n = len(f)
    cells = int(np.ceil(np.sqrt(n)))
    corner = np.stack([np.arange(n) % cells, np.arange(n) // cells], 1)
    tri = np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]])
    uvs = ((corner[:, None, :] + tri[None]) / cells).astype(np.float32)
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atlas = rasterize_uv_atlas(mesh, uvs, 256, device=dev)
    torch.cuda.synchronize()
    uv_s = time.perf_counter() - t0
    uv_counts = launch_counts()
    want = rasterize_uv_atlas(TriangleMesh(v, f), uvs, 256, device="cpu")
    uv_same = torch.equal(atlas["prim_id"].cpu(), want["prim_id"])
    uv_err = float((atlas["position"].cpu() - want["position"]).abs().max())
    cov = float((atlas["prim_id"] != nt.INVALID_PRIM_ID).float().mean())
    say(f"phase 22 rasterize_uv_atlas 256^2 over {n} tris: {uv_s:.3f} s, "
        f"coverage {cov:.4f}, launches {nonzero(uv_counts)}; card vs CPU prim ids "
        f"equal {uv_same}, position max abs diff {uv_err:.3e}")
    check(uv_same and uv_err <= 1e-5 and cov > 0.2
          and sum(uv_counts.values()) == 0, "phase 22: the UV atlas is wrong")

    # ---- every camera model at 512^2, card against the CPU
    cres = 512
    cam_c = cameras.look_at((0.3, 0.4, 2.6), (0, 0, 0), width=cres,
                            height=cres, fov=70.0, device=dev)
    cam_h = cameras.look_at((0.3, 0.4, 2.6), (0, 0, 0), width=cres,
                            height=cres, fov=70.0, device="cpu")
    lines, cam_ok = [], True
    for name in list(cameras.CAMERA_REGISTRY) + ["vr"]:
        if name == "vr":
            a = cameras.vr_omnistereo_rays(2 * cres, cres, device=dev)
            b = cameras.vr_omnistereo_rays(2 * cres, cres, device="cpu")
        else:
            a = cameras.generate_rays(cam_c, name)
            b = cameras.generate_rays(cam_h, name)
        same_frac, ulp = 1.0, 0
        for x, y in zip(a, b):
            x = x.cpu()
            eq = x.view(torch.int32) == y.view(torch.int32)
            close = (torch.from_numpy(ulp_distance(x, y)) <= 8) | (
                (x - y).abs() <= 2e-7)
            cam_ok &= bool(close.all())
            same_frac = min(same_frac, float(eq.float().mean()))
            ulp = max(ulp, int(ulp_distance(x, y).max()))
        cam_ok &= same_frac >= 0.99
        lines.append(f"{name} {same_frac:.5f}/{ulp}")
    say(f"phase 22 cameras at {cres}^2 (VR {2 * cres}x{cres}), card vs CPU, "
        f"share of bit-identical components / largest ulp: "
        + ", ".join(lines))
    check(cam_ok, "phase 22: a camera model differs between card and CPU")

    # ---- the progressive loop: render_pbr passes with subpixel jitter,
    # pass 2 cancelled in flight, then a restart and 4 passes
    pres = 512
    pcam = cameras.look_at((0.3, 0.4, 2.6), (0.0, -0.1, 0.0), width=pres,
                           height=pres, fov=55.0, device=dev)
    outs, gate, box = [], threading.Event(), {}

    def one_pass(p, gen):
        x, y = cameras.pixel_grid(pcam)
        j = torch.rand((2,), generator=gen, device=dev) - 0.5
        img = pbr.render_pbr(bvh, mesh, cameras.pinhole_rays(
            pcam, (x + j[0], y + j[1])), mat, scene8=s16)[0]["rgb"]
        if p == 2 and not gate.is_set():
            box["r"].cancel()
            gate.set()
        outs.append((p, img.double().cpu().numpy()))
        return {"rgb": img}

    r = ProgressiveRenderer(one_pass, max_passes=4, seed=9, device=dev)
    box["r"] = r
    t0 = time.perf_counter()
    r.start()
    ok = gate.wait(60)
    time.sleep(0.05)
    done_at_cancel = r.passes_done
    snap = r.snapshot()
    first = [o for p, o in outs[:2]]
    ok &= done_at_cancel == 2 and np.array_equal(
        snap["rgb"], (first[0] + first[1]) / 2)
    n_calls = len(outs)
    r.request_render()
    ok &= r.wait_for(4, timeout=60)
    snap = r.snapshot()
    r.quit()
    prog_s = time.perf_counter() - t0
    kept4 = {p: o for p, o in outs[n_calls:]}  # the last pass p of each p
    ok &= sorted(kept4) == [0, 1, 2, 3] and np.array_equal(
        snap["rgb"], sum(kept4[p] for p in range(4)) / 4)
    say(f"phase 22 ProgressiveRenderer, render_pbr passes at {pres}^2: "
        f"{n_calls} calls before the restart (pass 2 cancelled in flight, "
        f"{done_at_cancel} kept), then 4 passes; the snapshots equal the "
        f"means of the kept passes only: {bool(ok)}; {prog_s:.3f} s")
    check(bool(ok), "phase 22: the progressive loop averaged a discarded "
          "pass or lost one")
    say(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return launches, err, woop_launches, woop_err, aov_launches


def region_bytes(cols: int = 8, seed: int = 31) -> tuple[bytes, int]:
    """A Minecraft region of ``cols`` x ``cols`` full-height chunks in the
    legacy schema (16 sections of 16^3 blocks each, zlib), over a
    rolling terrain 40-100 blocks high with cave pockets carved out.
    Returns the .mca bytes and the solid block count."""
    import struct
    import zlib

    rng = np.random.default_rng(seed)
    n = 16 * cols
    x, z = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    h = (70 + 18 * np.sin(x / 13.0) * np.cos(z / 17.0)
         + 8 * np.sin((x + 2 * z) / 7.0)).astype(np.int64)
    y = np.arange(256)[None, :, None]
    solid = y < h[:, None, :]  # [x, y, z]
    for cx, cy, cz in rng.integers([0, 10, 0], [n, 40, n], (40, 3)):
        r2 = (np.arange(n)[:, None, None] - cx) ** 2 + (
            np.arange(256)[None, :, None] - cy) ** 2 + (
            np.arange(n)[None, None, :] - cz) ** 2
        solid &= r2 > 36

    def tag(value):
        if isinstance(value, int):
            return 3, struct.pack(">i", value)
        if isinstance(value, np.ndarray):
            return 7, struct.pack(">i", value.size) + value.tobytes()
        if isinstance(value, list):
            body = b"".join(tag(v)[1] for v in value)
            return 9, struct.pack(">bi", tag(value[0])[0], len(value)) + body
        body = b""
        for k, v in value.items():
            t, payload = tag(v)
            body += struct.pack(">bH", t, len(k)) + k.encode() + payload
        return 10, body + b"\x00"

    header = bytearray(8192)
    body = b""
    sector = 2
    for cx in range(cols):
        for cz in range(cols):
            blk = solid[16 * cx:16 * cx + 16, :, 16 * cz:16 * cz + 16]
            sections = [{"Y": s, "Blocks": np.ascontiguousarray(
                blk[:, 16 * s:16 * s + 16, :].transpose(1, 2, 0)
            ).astype(np.int8)} for s in range(16)]  # [y, z, x]
            root = {"Level": {"xPos": cx, "zPos": cz, "Sections": sections}}
            t, payload = tag(root)
            blob = zlib.compress(struct.pack(">bH", t, 0) + payload)
            chunk = struct.pack(">I", len(blob) + 1) + b"\x02" + blob
            chunk += b"\x00" * (-len(chunk) % 4096)
            struct.pack_into(">I", header, 4 * (cx + 32 * cz),
                             (sector << 8) | (len(chunk) // 4096))
            body += chunk
            sector += len(chunk) // 4096
    return bytes(header) + body, int(solid.sum())


def loader_phases(dev, hres: int = 1024, res: int = 2048, dres: int = 512,
                  qres: int = 1024, mres: int = 1024, n_las: int = 1_000_000,
                  sres: int = 256, every: int = 64) -> tuple:
    """Phase 23: the loaders at the sizes their users load, each mesh
    through the native build and BVH16 to K1 on the card. Returns (K1
    launches on the phase's paths, K1's largest error against its plain
    version)."""
    import tempfile

    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io import (displacement, heightmap, las, minecraft,
                                     ptex, qrcode, voxels)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops import sphere
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.testing import compare_hits
    from nanort_tpu_torch.traverse import _ext, packet
    from nanort_tpu_torch.utils.trackball import camera_from_quat

    t_phase = time.perf_counter()
    launches, err = 0, 0.0

    def k1_frame(what, v, f, rays, grid=None):
        """Build (native, leaf 9, BVH16), then K1 on ``rays`` as the path:
        a warm-up and 3 launches timed, counted; every ``every``-th ray
        held to the plain version. Returns (scene, hits)."""
        nonlocal launches, err
        t0 = time.perf_counter()
        bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
            min_leaf_primitives=9, max_leaf_primitives=9))
        s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
        build_s = time.perf_counter() - t0
        holder = {}
        zero_launch_counts()
        times = [cuda_ms(lambda: holder.__setitem__(
            "h", packet.traverse_bvh8(s16, rays)), 1)[0] for _ in range(4)][1:]
        counts = launch_counts()
        n_l = counts["packet_traverse"]
        launches += n_l
        hits = holder["h"]
        R = hits.t.numel()
        sub = nt.Rays(*(x.reshape(R, *x.shape[len(hits.t.shape):])[::every]
                        .contiguous() for x in rays))
        g = nt.Hits(*(x.reshape(R)[::every] for x in hits))
        h = hold_k1_trace(s16, sub, (), {}, g)
        err = max(err, h["err"])
        frac = float(hits.hit.float().mean())
        b = bound(R * (32 + 20) + nbytes(s16.nodes, s16.leafs),
                  trace_ops(h["stats"], 16, WT_OPS) * every)
        say(f"phase 23 {what}: {len(f)} tris, native build + BVH16 "
            f"{build_s:.2f} s ({s16.num_nodes} nodes, depth {s16.depth}); "
            f"K1 on {R} rays: ms {[round(t, 3) for t in times]} (CUDA "
            f"events, after a warm-up) = {R / min(times) / 1e3:.1f} "
            f"Mrays/s best; hit fraction {frac:.5f}; launches "
            f"{nonzero(counts)}; every {every}th ray ({h['rays']}) == plain "
            f"bit for bit: {h['same']} (max abs err {h['err']}, plain "
            f"{h['plain_ms']:.1f} ms); bound {b[0]:.4f} ms ({b[1]})")
        check(n_l == 4 and sum(counts.values()) == 4,
              f"phase 23 {what}: launches {nonzero(counts)}, expected 4 K1")
        check(h["same"], f"phase 23 {what}: K1 differs from its plain "
              "version")
        check(0.0 < frac < 1.0, f"phase 23 {what}: hit fraction {frac}")
        k1_shape(f"phase 23 {what}, {R} rays over {len(f)} tris (best of 3)",
                 min(times), b)
        return s16, hits

    # ---- the heightmap: a 1024^2 terrain, 2,093,058 tris
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:hres, 0:hres] / hres
    hgt = (0.12 * np.sin(9.0 * xx) * np.cos(7.0 * yy)
           + 0.05 * np.sin(31.0 * (xx + yy))
           + 0.004 * rng.standard_normal((hres, hres))).astype(np.float32)
    t0 = time.perf_counter()
    hv, hf = heightmap.heightmap_to_mesh(hgt, scale_xy=2.0 / (hres - 1))
    mesh_s = time.perf_counter() - t0
    phi = math.radians(55.0)  # the trackball tilted down 55 degrees
    q = np.array([-math.sin(phi / 2), 0.0, 0.0, math.cos(phi / 2)])
    cam = camera_from_quat(q, (1.0, 0.0, 1.0), 2.6, res, res, 50.0,
                           device=dev)
    say(f"# phase 23: heightmap_to_mesh {hres}^2 -> {len(hf)} tris in "
        f"{mesh_s:.2f} s; camera_from_quat (55 degrees down) at {res}^2")
    check(len(hf) == 2 * (hres - 1) ** 2, "phase 23: heightmap tris")
    hrays = pinhole_rays(cam)
    _, hh = k1_frame("heightmap", hv, hf, hrays)

    # per-face textures on the heightmap's hits: one 1x1-2x2 RGB grid a
    # triangle, on the card against the same textures on the CPU
    gen = torch.Generator(device=dev).manual_seed(5)
    n_f = len(hf)
    tex = ptex.FaceTextures(
        texels=torch.rand((n_f, 2, 2, 3), generator=gen, device=dev),
        ures=torch.randint(1, 3, (n_f,), generator=gen, device=dev,
                           dtype=torch.int32),
        vres=torch.randint(1, 3, (n_f,), generator=gen, device=dev,
                           dtype=torch.int32))
    zero_launch_counts()
    t0 = time.perf_counter()
    col = ptex.sample_tri_hits(tex, hh, quad_faces=False)
    torch.cuda.synchronize()
    tex_s = time.perf_counter() - t0
    R = hh.t.numel()
    pick = torch.arange(0, R, R // 4096, device=dev)[:4096]
    sub_h = nt.Hits(*(x.reshape(R)[pick].cpu() for x in hh))
    want = ptex.sample_tri_hits(ptex.FaceTextures(*(x.cpu() for x in tex)),
                                sub_h, quad_faces=False)
    same_tex = torch.equal(col.reshape(R, 3)[pick].cpu(), want)
    say(f"phase 23 sample_tri_hits on {R} heightmap hits ({n_f} face "
        f"textures): {tex_s * 1e3:.1f} ms host wall; card == CPU on "
        f"{pick.numel()} spread pixels bit for bit: {same_tex}")
    check(same_tex and sum(launch_counts().values()) == 0
          and float(col.mean()) > 0, "phase 23: sample_tri_hits differs "
          "between card and CPU")
    del hh, col, tex, hrays

    # ---- a vector-displaced 512^2 grid
    g = np.linspace(0.0, 2.0, dres, dtype=np.float32)
    gv, gf = heightmap.heightmap_to_mesh(np.zeros((dres, dres), np.float32),
                                         scale_xy=2.0 / (dres - 1))
    uvg = np.stack(np.meshgrid(g / 2.0, 1.0 - g / 2.0, indexing="xy"),
                   -1).reshape(-1, 2)
    # a sculpted vector field: 8 cm bumps along the normal, 1 cm of
    # tangent swirl, 2 mm of grain (the grid's cells are 4 mm)
    my, mx = np.mgrid[0:256, 0:256] * (2.0 * np.pi / 256)
    dmap = np.stack([0.01 * np.sin(3 * my), 0.01 * np.cos(5 * mx),
                     0.08 * np.sin(4 * mx) * np.cos(3 * my)], -1)
    dmap = (dmap + 0.002 * rng.standard_normal((256, 256, 3))).astype(
        np.float32)
    t0 = time.perf_counter()
    tri_pos = gv[gf]
    tri_uv = uvg[gf].astype(np.float32)
    disp = displacement.apply_vector_displacement(tri_pos, tri_uv, dmap,
                                                  1.0, "tangent")
    disp_s = time.perf_counter() - t0
    dv = disp.reshape(-1, 3).astype(np.float32)
    df = np.arange(dv.shape[0], dtype=np.int32).reshape(-1, 3)
    say(f"phase 23 apply_vector_displacement: {len(df)} facevarying tris, "
        f"256^2 map, tangent space, {disp_s:.2f} s")
    check(bool(np.isfinite(dv).all()) and float(np.abs(dv - tri_pos.reshape(
        -1, 3)).max()) > 0.01, "phase 23: the displacement did nothing")
    dcam = camera_from_quat(q, (1.0, 0.0, 1.0), 2.6, qres, qres, 50.0,
                            device=dev)
    k1_frame("vector-displaced grid", dv, df, pinhole_rays(dcam))

    # ---- a version-10 QR code, looking straight down
    text = "nanort on the card: " + "q" * 251  # 271 bytes: version 10, L
    m = qrcode.generate_qr(text, "L")
    n_mod = m.shape[0]
    qv, qf = voxels.grid2d_to_boxes(m, box_height=0.5, cell_size=1.0)
    xs = (torch.arange(qres, device=dev, dtype=torch.float32) + 0.5) * (
        n_mod / qres)
    ox, oz = torch.meshgrid(xs, xs, indexing="ij")
    qorg = torch.stack([ox, torch.full_like(ox, 3.0), oz], -1).contiguous()
    qdir = torch.zeros_like(qorg)
    qdir[..., 1] = -1.0
    qrays = nt.make_rays(qorg, qdir)
    _, qh = k1_frame(f"QR version {(n_mod - 17) // 4} ({n_mod}^2 modules), "
                     "top-down", qv, qf, qrays)
    centre = ((torch.arange(n_mod, device=dev) + 0.5) * qres / n_mod).long()
    read = qh.hit[centre][:, centre].cpu().numpy()
    try:
        payload = qrcode.verify_qr(read)
    except ValueError as e:
        payload = repr(e).encode()
    say(f"phase 23 QR read back from the K1 hit mask at the {n_mod}^2 module "
        f"centres: equal to the symbol {bool((read == m).all())}; verify_qr "
        f"returns the payload: {payload == text.encode()}")
    check(n_mod == 57 and payload == text.encode(), "phase 23: the QR symbol "
          "does not read back from the traced image")

    # ---- a Minecraft region of 8x8 full-height chunks, written here
    t0 = time.perf_counter()
    data, n_solid = region_bytes()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r.0.0.mca")
        with open(path, "wb") as fh:
            fh.write(data)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mv, mf = minecraft.load_region_mesh(path)
        load_s = time.perf_counter() - t0
    occ, _ = minecraft.region_to_voxels(data)
    say(f"phase 23 Minecraft: region of 64 chunks x 16 sections "
        f"({len(data) / 1e6:.2f} MB, {n_solid} solid blocks) written in "
        f"{write_s:.2f} s; load_region_mesh {load_s:.2f} s -> {len(mf)} "
        f"tris")
    check(occ.shape == (128, 256, 128) and int(occ.sum()) == n_solid,
          "phase 23: the region's voxels differ from the blocks written")
    mcam = look_at((-40.0, 160.0, -40.0), (64.0, 60.0, 64.0), width=mres,
                   height=mres, fov=60.0, device=dev)
    k1_frame("Minecraft region", mv, mf, pinhole_rays(mcam))

    # ---- a 1,000,000-point LAS round trip, drawn as spheres
    pts = np.stack([rng.uniform(1000.0, 1400.0, n_las),
                    rng.uniform(2000.0, 2400.0, n_las),
                    np.zeros(n_las)], 1)
    pts[:, 2] = 110.0 + 6.0 * np.sin(pts[:, 0] / 23.0) * np.cos(
        pts[:, 1] / 17.0) + rng.normal(0.0, 0.05, n_las)
    pts = pts.astype(np.float32).astype(np.float64)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.las"), os.path.join(d, "b.las")
        t0 = time.perf_counter()
        las.save_las(a, pts)
        cloud = las.load_las(a)
        las.save_las(b, cloud.points)
        las_s = time.perf_counter() - t0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same_file = fa.read() == fb.read()
    same_pts = bool((cloud.points == pts.astype(np.float32)).all())
    say(f"phase 23 LAS: {n_las} points saved, loaded and saved again in "
        f"{las_s:.2f} s: files byte-equal {same_file}, points equal "
        f"{same_pts}")
    check(same_file and same_pts, "phase 23: the LAS round trip changed "
          "the records")
    t0 = time.perf_counter()
    sp = las.to_spheres(cloud, device=dev)
    sbvh, _ = sphere.build_sphere_bvh(sp)
    sb_s = time.perf_counter() - t0
    srays = pinhole_rays(look_at((1200.0, 1700.0, 400.0),
                                 (1200.0, 2200.0, 110.0), (0.0, 0.0, 1.0),
                                 width=sres, height=sres, fov=45.0,
                                 device=dev))
    srays = nt.Rays(*(x.reshape(sres * sres, *x.shape[2:]).contiguous()
                      for x in srays))
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = sphere.traverse_spheres(sbvh, sp, srays)
    torch.cuda.synchronize()
    s_s = time.perf_counter() - t0
    cpu_sp = las.to_spheres(cloud, device="cpu")
    pick = slice(None, None, every)
    want = sphere.traverse_spheres(sbvh, cpu_sp, nt.Rays(
        *(x[pick].cpu() for x in srays)))
    c = compare_hits(nt.Hits(*(x[pick].cpu() for x in sh)), want,
                     uv_atol=1e-6)
    same_sp = all(torch.equal(x.cpu(), y) for x, y in zip(sp, cpu_sp))
    say(f"phase 23 to_spheres(device=cuda) + build_sphere_bvh {sb_s:.2f} s; "
        f"traverse_spheres on {sres}^2 rays: {s_s:.3f} s = "
        f"{sres * sres / s_s / 1e6:.3f} Mrays/s, hit fraction "
        f"{float(sh.hit.float().mean()):.5f}; card vs CPU on "
        f"{want.t.numel()} spread rays: {c}; spheres equal {same_sp}")
    check(sp.centers.is_cuda and same_sp and c["ok"] and c["hits"] > 0
          and sum(launch_counts().values()) == 0,
          "phase 23: the LAS spheres differ between card and CPU")

    # ---- the same cloud, tree and rays through K1's sphere leaf test
    t0 = time.perf_counter()
    s8k = collapse_bvh8(sbvh, width=8, spheres=cpu_sp).to(dev)
    k_build = time.perf_counter() - t0
    holder = {}
    zero_launch_counts()
    k_times = [cuda_ms(lambda: holder.__setitem__(
        "h", sphere.traverse_spheres(None, sp, srays, scene8=s8k)), 1)[0]
        for _ in range(4)][1:]
    counts = launch_counts()
    n_l = counts["packet_traverse[sphere]"]
    launches += n_l
    kh = holder["h"]
    sub = nt.Rays(*(x[pick].contiguous() for x in srays))
    want_k = packet._traverse_reference(
        s8k.nodes, s8k.leafs, 8, sub.org, sub.dir, sub.min_t, sub.max_t,
        None, None, False, False, False, packet.stack_slots(s8k),
        sphere=True)
    got_k = [x[pick] for x in packet.traverse_bvh8(s8k, srays)]
    same_k = all(torch.equal(a, b) for a, b in zip(got_k, want_k))
    err = max(err, record_err(got_k, want_k))
    precise = sphere.traverse_spheres(sbvh, sp, sub, max_leaf=None,
                                      precise=True)
    c_k = compare_hits(nt.Hits(*(x[pick] for x in kh)), precise, t_ulps=0,
                       uv_atol=1e-6)
    c_q = compare_hits(nt.Hits(*(x[pick] for x in kh)),
                       nt.Hits(*(x[pick] for x in sh)), uv_atol=1e-6)
    say(f"phase 23 LAS through K1's sphere leaf (the stack engine's tree, "
        f"BVH8 collapsed and moved in {k_build:.2f} s, {s8k.num_nodes} "
        f"nodes): ms "
        f"{[round(t, 3) for t in k_times]} = "
        f"{sres * sres / min(k_times) / 1e3:.1f} Mrays/s best, against the "
        f"stack engine's {sres * sres / s_s / 1e6:.3f} Mrays/s; launches "
        f"{nonzero(counts)}; every {every}th ray == plain bit for bit: "
        f"{same_k}; against the stack engine's precise test: {c_k}; "
        f"against its b^2 - 4ac (the JAX package's): {c_q}")
    check(n_l == 4 and sum(counts.values()) == 4 and same_k and c_k["ok"]
          and c_k["hits"] > 0, "phase 23: K1's spheres differ from the "
          "plain version or the stack engine")

    # ---- the benchmark's LiDAR tile at its own shape: the 10M points and
    # the tables that its las_view entry builds (width 8, the builder's
    # default leaves), one 3840x2160 frame through traverse_image
    import json
    from types import SimpleNamespace

    from rtbench import scenes
    from rtbench.entries import las_view

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "rtbench/configs/las_tile_10m.json")) as fh:
        recipe = json.load(fh)["scene"]
    with open(os.path.join(root, "rtbench/traffic/view_4k.json")) as fh:
        traffic = json.load(fh)
    t0 = time.perf_counter()
    run = SimpleNamespace(cell=SimpleNamespace(traffic=traffic),
                          scene=scenes.make_scene(recipe), device=dev,
                          seed=2**31 + 23, spans={})
    st = las_view.setup(run)
    tile_s = time.perf_counter() - t0
    rays = pinhole_rays(look_at(
        las_view.eye_of(st.cam, st.center, st.a0, 0), st.center,
        width=st.W, height=st.H, fov=float(st.cam["fov"]), device=dev))
    holder = {}
    zero_launch_counts()
    t_ms = cuda_ms(lambda: holder.__setitem__(
        "h", packet.traverse_image(st.s8, rays)), 1)[0]
    counts = launch_counts()
    launches += counts["packet_traverse[sphere]"]
    n = st.W * st.H
    flat = nt.Rays(*(x.reshape(n, *x.shape[2:])[::every].contiguous()
                     for x in rays))
    t0 = time.perf_counter()
    want_t = packet._traverse_reference(
        st.s8.nodes, st.s8.leafs, las_view.WIDTH, flat.org, flat.dir,
        flat.min_t, flat.max_t, None, None, False, False, False,
        packet.stack_slots(st.s8), sphere=True)
    ref_s = time.perf_counter() - t0
    got_t = [x.reshape(n)[::every] for x in holder["h"]]
    same_t = (torch.equal(got_t[0], want_t[0])
              and torch.equal(got_t[3], want_t[3]))
    hit_t = float(got_t[3].ne(nt.INVALID_PRIM_ID).float().mean())
    say(f"phase 23 the benchmark's LiDAR tile ({len(st.pts)} points, "
        f"generated, built and moved with las_view's set-up in "
        f"{tile_s:.1f} s: {st.s8.num_nodes} nodes at width "
        f"{las_view.WIDTH}): one {st.W}x{st.H} frame through traverse_image "
        f"in {t_ms:.3f} ms, launches {nonzero(counts)}; every {every}th ray "
        f"({want_t[0].numel()}, plain version {ref_s:.1f} s) == plain bit "
        f"for bit on t and prim id: {same_t}; hit fraction {hit_t:.4f}")
    check(counts["packet_traverse[sphere]"] == 1
          and sum(counts.values()) == 1 and same_t and 0.3 < hit_t < 1.0,
          "phase 23: K1's spheres on the benchmark's tile differ from the "
          "plain version or did not take one launch")
    sa = hold_sphere_aovs(st.spheres, rays, holder["h"], 10)
    say(f"phase 23 the benchmark's LiDAR tile: the {st.W}x{st.H} frame's "
        f"sphere AOVs (csrc/sphere_aovs.cu; launches {sa['launches']}): == "
        f"plain bit for bit {sa['same']}; kernel {sa['ms']:.4f} ms a call "
        f"(device, mean of 10) vs bound {sa['bound'][0]:.4f} ms "
        f"({sa['bound'][1]}, {sa['bytes'] / 1e9:.3f} GB); plain "
        f"{sa['plain_ms']:.3f} ms; ptxas -v: " + " | ".join(
            " ".join(ln.split()) for ln in _ext.resource_usage(
                "sphere_aovs").splitlines()
            if "Used" in ln or "spill" in ln))
    check(sa["same"] and sa["launches"] == {"sphere_aovs_fused": 1},
          "phase 23: the sphere AOV kernel differs from its plain version "
          f"or did not launch once ({sa['launches']})")
    del holder, flat, sa
    torch.cuda.empty_cache()
    say_route("phase 23 the benchmark's LiDAR tile",
              route_split(st.s8, rays), st.H, st.W, 5)
    del st, run, rays
    say(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def multidevice_phases(dev, v, f, s8_unsplit, res: int = 2048,
                       ares: int = 512, every: int = 64) -> tuple:
    """Phase 24: the multi-device layer on one card, through a one-rank
    NCCL group, and the chunk-sharded scene's K1 path. ``v``/``f``: phase
    4's sphere; ``s8_unsplit``: its BVH8 (leaf 8) on the card (phase
    16's). Returns (K1 launches on the phase's paths, K1's largest error
    against its plain version)."""
    import datetime
    import tempfile

    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_uv_sphere, merge_meshes)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.parallel import mesh as pm
    from nanort_tpu_torch.parallel import sharded_scene as pss
    from nanort_tpu_torch.testing import compare_hits
    from nanort_tpu_torch.traverse import packet
    from nanort_tpu_torch.traverse.packed import pack_scene
    from nanort_tpu_torch.traverse.ray_sort import traverse_bvh8_sorted

    t_phase = time.perf_counter()
    dist = torch.distributed
    launches, err = 0, 0.0
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(d, "store"),
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = pm.ray_mesh(1, device=dev.type)
            init_s = time.perf_counter() - t0
            say(f"# phase 24: one-rank {dist.get_backend()} group through a "
                f"file store ({init_s:.2f} s); ray_mesh(1): rank "
                f"{mesh.rank} of {mesh.size} on {mesh.device}")
            check(mesh.device.type == dev.type and mesh.group is not None,
                  "phase 24: the mesh is not on the card")

            # ---- config A's scene at 512^2: the three mesh engines
            av, af = merge_meshes(make_cornell_box(2.0),
                                  make_uv_sphere(64, 128, 0.6))
            abvh, _ = nt.build_triangle_bvh(TriangleMesh(av, af))
            geom = TriangleMesh(av, af)
            arays = pinhole_rays(look_at((0, 0.0, 5.0), (0, 0, 0), width=ares,
                                         height=ares, fov=45.0, device=dev))
            arays = nt.Rays(*(x.reshape(ares * ares, *x.shape[2:])
                              .contiguous() for x in arays))
            stats, secs = {}, {}
            zero_launch_counts()
            for name, fn in (
                    ("stack", lambda: pm.sharded_traverse_triangles(
                        abvh, geom, arays, mesh)),
                    ("wavefront", lambda: pm.sharded_traverse_wavefront(
                        pack_scene(abvh, av, af), arays, mesh)),
                    ("render_step", lambda: pm.sharded_render_step(
                        abvh, geom, arays, mesh, seed=3))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats[name] = fn()
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
            counts = launch_counts()
            n_hits = {k: int(s[1]) for k, s in stats.items()}
            ao, _, mean_ao = stats["render_step"]
            agree = compare_hits(stats["stack"][0], stats["wavefront"][0])
            say(f"phase 24 mesh engines, config A ({len(af)} tris) at "
                f"{ares}^2 through all_reduce/all_gather: hit counts "
                f"{n_hits}, seconds "
                f"{ {k: round(s, 3) for k, s in secs.items()} }; mean AO "
                f"{float(mean_ao):.5f}; AO image {tuple(ao.shape)}; stack "
                f"against wavefront records: {agree}")
            check(len(set(n_hits.values())) == 1 and agree["ok"]
                  and 0 < n_hits["stack"]
                  < ares * ares and 0.0 <= float(mean_ao) <= 1.0
                  and ao.is_cuda == (dev.type == "cuda")
                  and tuple(ao.shape) == (ares * ares,)
                  and sum(counts.values()) == 0,
                  f"phase 24: the mesh engines disagree ({n_hits}, mean AO "
                  f"{float(mean_ao)}, launches {nonzero(counts)})")

            # ---- phase 4's sphere in 4 packet chunks, traced in turn
            t0 = time.perf_counter()
            sc = pss.build_scene_chunks(TriangleMesh(v, f), 4,
                                        nt.BVHBuildOptions(8, 8), packet=True)
            chunk_s = time.perf_counter() - t0
            sc_d = sc.to(dev)
            say(f"phase 24 build_scene_chunks(4, packet=True) over {len(f)} "
                f"tris: {chunk_s:.2f} s; BVH8 rows {sc.nodes8.shape[1]} a "
                f"chunk (padded), chunk depths {sc.depths8} (JAX's one "
                f"depth: {sc.depth8})")
            cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res,
                          height=res, fov=60.0, device=dev)
            rays = pinhole_rays(cam)
            kept = []
            real = packet.traverse_bvh8

            def keep(scene8, r, *a, **k):
                out = real(scene8, r, *a, **k)
                kept.append((scene8, r, a, dict(k), out))
                return out

            zero_launch_counts()
            with patched(packet, "traverse_bvh8", keep):
                got = pss.sequential_chunk_traverse(sc_d, rays)
            counts = launch_counts()
            n_l = counts["packet_traverse"]
            launches += n_l
            same_all = True
            for c_i, (s8c, r, a, k, out) in enumerate(kept):
                sub = nt.Rays(*(x[::every].contiguous() for x in r))
                h = hold_k1_trace(s8c, sub, a, k,
                                  nt.Hits(*(x[::every] for x in out)))
                same_all &= h["same"]
                err = max(err, h["err"])
                say(f"phase 24 chunk {c_i}: K1 on {r.org.shape[0]} sorted "
                    f"rays ({int(out.hit.sum())} hits in the chunk), every "
                    f"{every}th == plain bit for bit: {h['same']} (max abs "
                    f"err {h['err']}); kernel on the sample {h['ms']:.3f} "
                    f"ms, plain {h['plain_ms']:.1f} ms")
            check(n_l == 4 and len(kept) == 4 and sum(counts.values()) == 4
                  and same_all, f"phase 24: chunk launches "
                  f"{nonzero(counts)}, == plain {same_all}")
            del kept
            want = traverse_bvh8_sorted(s8_unsplit, rays)
            c = compare_hits(got, want, t_ulps=0)
            say(f"phase 24 the 4 chunks against one K1 trace of the unsplit "
                f"sphere ({res}^2 rays): {c}")
            check(c["ok"], "phase 24: the chunked records differ from the "
                  "unsplit trace")
            ms = {"unsplit": [], "chunks": []}
            for name in ("unsplit", "chunks", "chunks", "unsplit"):
                fn = (lambda: traverse_bvh8_sorted(s8_unsplit, rays)) \
                    if name == "unsplit" else \
                    (lambda: pss.sequential_chunk_traverse(sc_d, rays))
                ms[name].append(cuda_ms(fn, 1)[0])
            say(f"phase 24 in turns (unsplit, chunks, chunks, unsplit), "
                f"{res}^2 rays, sort + K1 + unsort: unsplit "
                f"{[round(t, 3) for t in ms['unsplit']]} ms, 4 chunks "
                f"{[round(t, 3) for t in ms['chunks']]} ms")
            del got, want, sc_d

            # ---- the packet ring on a one-chunk scene, through the group
            sc1 = pss.build_scene_chunks(geom, 1, nt.BVHBuildOptions(8, 8),
                                         packet=True)
            zero_launch_counts()
            ring = pss.sharded_scene_traverse(sc1, arays, mesh,
                                              engine="packet")
            counts = launch_counts()
            launches += counts["packet_traverse"]
            from nanort_tpu_torch.build.bvh8 import collapse_bvh8

            ab8, _ = nt.build_triangle_bvh(geom, nt.BVHBuildOptions(8, 8))
            u8 = collapse_bvh8(ab8, av, af).to(dev)
            c = compare_hits(ring, traverse_bvh8_sorted(u8, arays), t_ulps=0)
            say(f"phase 24 sharded_scene_traverse(engine='packet') on one "
                f"chunk of config A, {ares}^2 rays through the group: "
                f"launches {nonzero(counts)}; against the unsplit BVH8 "
                f"trace: {c}")
            check(counts["packet_traverse"] == 1 and sum(counts.values()) == 1
                  and c["ok"], "phase 24: the packet ring differs from the "
                  "unsplit trace")
        finally:
            dist.destroy_process_group()
    say(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def hold_k1_launch(scene8, rays, args, kw, hits, every: int) -> dict:
    """A captured K1 launch held to the plain version on every
    ``every``th ray (with its skip ids), as ``hold_k1_trace``; then the
    whole launch relaunched for its card ms (``full_ms``, median of 5)
    and its bound (``bound``: the rays, skip ids, records and tables
    once; the plain version's work on the sample, times ``every``)."""
    import nanort_tpu_torch as nt
    from nanort_tpu_torch.traverse import packet

    R = rays.org.numel() // 3
    sub = nt.Rays(rays.org.reshape(-1, 3)[::every],
                  rays.dir.reshape(-1, 3)[::every],
                  rays.min_t.reshape(-1)[::every],
                  rays.max_t.reshape(-1)[::every])
    kw_sub = dict(kw)
    skip = kw.get("skip_prim_id")
    if skip is not None:
        kw_sub["skip_prim_id"] = skip.reshape(-1)[::every]
    h = hold_k1_trace(scene8, sub, args, kw_sub,
                      [x.reshape(-1)[::every] for x in hits])
    h["R"] = R
    h["full_ms"] = median(cuda_ms(
        lambda: packet.traverse_bvh8(scene8, rays, *args, **kw), 5))
    h["bound"] = bound(R * (32 + 20) + nbytes(skip, scene8.nodes,
                                              scene8.leafs),
                       trace_ops(h["stats"], scene8.width, WT_OPS) * every)
    return h


def hold_aovs(mesh, rays, hits, reps: int) -> dict:
    """objrender's AOVs of ``hits``: ``aovs_from_hits`` (one launch of
    csrc/aovs.cu) against ``_aovs_plain`` on the same card tensors, bit
    for bit; the kernel's device ms (``queued_ms``), its bound (each
    pixel's record and ray read once, 44 B, its AOVs written once, 49 B,
    the mesh read once; 39 operations a pixel), the plain version's ms
    (CUDA events, best of 2) and the AOV kernel's launches in all
    (``total``: the held call and the timed ones)."""
    import torch

    from nanort_tpu_torch.models import objrender

    zero_launch_counts()
    got = objrender.aovs_from_hits(mesh, None, rays, hits)
    launches = nonzero(launch_counts())
    want = objrender._aovs_plain(mesh, None, rays, hits)
    same = all(torch.equal(got[k], want[k]) for k in want)
    del got, want
    plain_ms = min(cuda_ms(
        lambda: objrender._aovs_plain(mesh, None, rays, hits), 2))
    ms = queued_ms(lambda: objrender.aovs_from_hits(mesh, None, rays, hits),
                   reps)
    total = launch_counts()["aovs_fused"]
    n = hits.t.numel()
    return {"same": same, "launches": launches, "total": total,
            "ms": ms, "plain_ms": plain_ms,
            "bound": bound(n * 93 + nbytes(mesh.vertices, mesh.faces),
                           n * 39)}


def hold_sphere_aovs(spheres, rays, hits, reps: int) -> dict:
    """The sphere frame's AOVs of ``hits``: ``sphere_aovs_from_hits`` (one
    launch of csrc/sphere_aovs.cu) against ``_sphere_aovs_plain`` on the
    same card tensors, bit for bit (the AOVs and the records' UV); the
    kernel's device ms (``queued_ms``), its bound (each pixel's t, prim id
    and ray read once, 36 B, a miss's u and v, 8 B, each sphere hit once
    its centre, 12 B, and the AOVs written once, 49 B; 31 operations a
    hit, atan2f and acosf one each) and the plain version's ms (CUDA
    events, best of 2)."""
    import torch

    from nanort_tpu_torch.models import pointcloud

    zero_launch_counts()
    got = pointcloud.sphere_aovs_from_hits(spheres, rays, hits)
    launches = nonzero(launch_counts())
    want = pointcloud._sphere_aovs_plain(spheres, rays, hits)
    same = (all(torch.equal(got[0][k], want[0][k]) for k in want[0])
            and all(torch.equal(a, b) for a, b in zip(got[1], want[1])))
    del got, want
    plain_ms = min(cuda_ms(
        lambda: pointcloud._sphere_aovs_plain(spheres, rays, hits), 2))
    ms = queued_ms(
        lambda: pointcloud.sphere_aovs_from_hits(spheres, rays, hits), reps)
    hit = hits.hit
    n, n_hit = hit.numel(), int(hit.sum())
    spheres_hit = int(torch.unique(hits.prim_id[hit]).numel())
    n_bytes = n * (36 + 49) + (n - n_hit) * 8 + spheres_hit * 12
    return {"same": same, "launches": launches, "bytes": n_bytes,
            "ms": ms, "plain_ms": plain_ms,
            "bound": bound(n_bytes, n_hit * 31)}


def say_aovs(what: str, h: dict, reps: int):
    say(f"{what} AOVs (csrc/aovs.cu; launches {h['launches']}): == plain "
        f"bit for bit {h['same']}; kernel {h['ms']:.4f} ms a call (device, "
        f"mean of {reps}) vs bound {h['bound'][0]:.4f} ms "
        f"({h['bound'][1]}); plain {h['plain_ms']:.3f} ms")
    check(h["same"] and h["launches"] == {"aovs_fused": 1},
          f"{what}: the AOV kernel differs from its plain version or did "
          f"not launch once ({h['launches']})")


def route_split(scene, rays, reps: int = 5) -> dict:
    """``traverse_image``'s launch over a camera's (H, W) rays as they
    lie (raster order) against the route it replaced: device ms, the
    median of ``reps`` turns, of K1 in raster order (``raster``), of the
    copy into padded pixel tiles of ``min(128, H) x min(64, W)``
    (``tile``), of K1 over that copy (``tiled``) and of the copy back
    (``untile``); and whether the two routes' records are equal bit for
    bit."""
    import torch

    from nanort_tpu_torch.traverse import packet

    h, w = rays.batch_shape
    tile = (min(128, h), min(64, w))
    held = {}

    def put(name, fn):
        held.pop(name, None)  # the last turn's result goes back first
        held[name] = fn()

    steps = {
        "raster": lambda: packet.traverse_image(scene, rays),
        "tile": lambda: packet.tile_image_rays(rays, *tile, pad=True),
        "tiled": lambda: packet.traverse_bvh8(scene, held["tile"][0]),
        "untile": lambda: held["tile"][1](held["tiled"]),
    }
    ms = {k: [] for k in steps}
    for _ in range(reps):
        for k, fn in steps.items():
            ms[k] += cuda_ms(lambda: put(k, fn), 1)
    out = {"tile": tile, "ms": {k: median(v) for k, v in ms.items()},
           "same": all(torch.equal(a, b) for a, b in
                       zip(held["raster"], held["untile"]))}
    out["copies"] = out["ms"]["tile"] + out["ms"]["untile"]
    return out


def say_route(what: str, s: dict, h: int, w: int, reps: int):
    m = s["ms"]
    say(f"{what}: a {w}x{h} camera batch through K1, device ms (median of "
        f"{reps}, in turns): K1 over the rays in raster order "
        f"{m['raster']:.3f}; the tiled route (tiles {s['tile'][0]}x"
        f"{s['tile'][1]}): tile copy {m['tile']:.3f} + K1 over the copy "
        f"{m['tiled']:.3f} + untile copy {m['untile']:.3f} = "
        f"{m['tile'] + m['tiled'] + m['untile']:.3f} (copies "
        f"{s['copies']:.3f}); records equal bit for bit: {s['same']}")
    check(s["same"], f"{what}: K1 in raster order differs from the tiled "
          "route")


def hold_camera(dev, w: int, h: int, reps: int) -> dict:
    """The perspective camera's w x h batch: ``pinhole_rays`` (one launch
    of csrc/camera.cu) against ``_pinhole_plain`` on the same card, bit
    for bit; the kernel's device ms (``queued_ms``), its bound (32 B
    written a ray, nothing read but the basis) and the plain version's ms
    (CUDA events, best of 2)."""
    import torch

    from nanort_tpu_torch.models import cameras

    cam = cameras.look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=w,
                          height=h, fov=60.0, device=dev)
    zero_launch_counts()
    got = cameras.pinhole_rays(cam)
    launches = nonzero(launch_counts())
    want = cameras._pinhole_plain(cam)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    del got, want
    plain_ms = min(cuda_ms(lambda: cameras._pinhole_plain(cam), 2))
    return {"shape": (w, h), "same": same, "launches": launches,
            "ms": queued_ms(lambda: cameras.pinhole_rays(cam), reps),
            "plain_ms": plain_ms,
            "bound": bound(w * h * 32, 0)}


def say_camera(what: str, h: dict, reps: int):
    w, ht = h["shape"]
    say(f"{what} camera {w}x{ht} (csrc/camera.cu; launches "
        f"{h['launches']}): == plain bit for bit {h['same']}; kernel "
        f"{h['ms']:.4f} ms a call (device, mean of {reps}) vs bound "
        f"{h['bound'][0]:.4f} ms ({h['bound'][1]}), "
        f"{100 * h['bound'][0] / h['ms']:.1f}% of it; plain "
        f"{h['plain_ms']:.3f} ms")
    check(h["same"] and h["launches"] == {"pinhole_fused": 1},
          f"{what}: the camera kernel at {w}x{ht} differs from its plain "
          f"version or did not launch once ({h['launches']})")


def example_phases(dev, v, f, every: int = 64) -> tuple:
    """Phase 25: the example programs through their ``main(argv)`` on the
    card at their own defaults, and the graft entry. ``v``/``f``: phase
    4's sphere, written as an OBJ for objrender. Runs in a temporary
    directory (the programs write their PNGs to the working directory).
    Every K1 launch of objrender and the viewer's first pass before and
    after its orbit, and path_tracer's K3 render, are held to their plain
    versions on every ``every``th ray or pixel. Returns (K1 launches on
    the phase's paths, K1's largest error against its plain version, K3
    launches, K3's largest error, the AOV kernel's launches)."""
    import io
    import tempfile
    import threading
    import urllib.request

    import torch

    from nanort_tpu_torch import graft_entry
    from nanort_tpu_torch.examples import (bidir_path_tracer, gltfrender,
                                           objrender, path_tracer, viewer)
    from nanort_tpu_torch.io.obj import save_obj
    from nanort_tpu_torch.io.procedural import make_uv_sphere
    from nanort_tpu_torch.models import pt_fused
    from nanort_tpu_torch.testing import ring_glb

    t_phase = time.perf_counter()
    k1 = k3 = aov = 0
    err = err3 = 0.0

    def held(what, holds):
        for h in holds:
            k1_shape(f"phase 25 {what}, {h['R']} rays"
                     + (", any-hit with skip" if h["occlusion"] else ""),
                     h["full_ms"], h["bound"])
        return ", ".join(
            f"{h['rays']} of {h['R']} rays"
            f"{' (any-hit, skip)' if h['occlusion'] else ''}"
            f" same={h['same']} err={h['err']} plain {h['plain_ms']:.1f} "
            f"ms, whole launch {h['full_ms']:.3f} ms vs bound "
            f"{h['bound'][0]:.4f} ms ({h['bound'][1]})" for h in holds)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # ---- objrender: the procedural scene at 512^2, then phase
            # 4's sphere loaded from an OBJ at 1024^2
            t0 = time.perf_counter()
            save_obj("sphere.obj", v, f)
            say(f"# phase 25 objrender: wrote phase 4's {len(f)}-tri sphere "
                f"as an OBJ in {time.perf_counter() - t0:.2f} s")
            for what, argv in (("procedural scene, 512^2", []),
                               ("OBJ sphere, 1024^2",
                                ["sphere.obj", "objrender_obj.png", "1024"])):
                out = {}
                zero_launch_counts()
                kept, n_k1 = capture_k1(lambda: out.update(objrender.main(argv)))
                counts = nonzero(launch_counts())
                k1 += counts.get("packet_traverse", 0)
                aov += counts.get("aovs_fused", 0)
                sec = out["seconds"]
                holds = [hold_k1_launch(*c, every) for c in kept]
                err = max([err] + [h["err"] for h in holds])
                hit = float(out["hits"].hit.float().mean())
                say(f"phase 25 objrender, {what}: load "
                    f"{sec.get('load', 0.0):.3f} s, build {sec['build']:.3f} "
                    f"s, tables {sec['tables']:.3f} s, render "
                    f"{sec['render'] * 1e3:.3f} ms (host clock, the image "
                    f"copied back), hit {hit:.4f}; launches {counts}; every "
                    f"{every}th ray == plain: " + held(f"objrender {what}",
                                                       holds))
                check(counts == {"packet_traverse": n_k1, "aovs_fused": 1,
                                 "pinhole_fused": 1}
                      and n_k1 >= 1 and len(holds) == n_k1,
                      f"phase 25 objrender ({what}): launches {counts}")
                check(all(h["same"] for h in holds) and hit > 0.05,
                      f"phase 25 objrender ({what}): K1 != plain or no hit")
                del out, kept, holds
                torch.cuda.empty_cache()

            # ---- path_tracer: 256^2 x 64 spp x 8 bounces (K3), its
            # render held on every 64th pixel to K3's plain version under
            # those pixels' own random numbers
            k3_kept = []
            real_fused = pt_fused.render_fused

            def keep_fused(scene, org, dirs, seed, spp, **kw):
                img = real_fused(scene, org, dirs, seed, spp, **kw)
                k3_kept.append((scene, org, dirs, seed, spp, kw, img))
                return img

            zero_launch_counts()
            with patched(pt_fused, "render_fused", keep_fused):
                out = path_tracer.main([])
            counts = nonzero(launch_counts())
            k3 += counts.get("pt_fused_brute", 0)
            img = out["img"]
            scene, org, dirs, seed, spp, kw, got = k3_kept[0]
            o, d = pt_fused._flat_rays(org, dirs, dev)
            ids = torch.arange(0, o.shape[0], every, device=dev)
            tri, face, light = pt_fused.build_fused_tables(scene)
            work = {"tris": 0, "shade": 0}
            real_mt = pt_fused._brute_mt

            def counting_mt(tri_, *c):
                tmin, tmax = c[-2], c[-1]
                live = int((tmax > tmin).sum())
                work["tris"] += live * tri_.shape[0]
                if tmin.numel() and float(tmin[0]) == pt_fused._EPS_T:
                    work["shade"] += live
                return real_mt(tri_, *c)

            t0 = time.perf_counter()
            with patched(pt_fused, "_brute_mt", counting_mt):
                want = pt_fused._div(pt_fused._render_fused_reference(
                    tri, face, pt_fused._lights(scene, dev), o[ids], d[ids],
                    pt_fused._seed32(seed), spp, kw["max_bounces"],
                    kw.get("rr_start", 3), kw.get("trig", "native"),
                    kw["azimuth_strata"], lane_ids=ids), float(spp))
            plain_s = time.perf_counter() - t0
            fr, err3 = same_frac(got[ids], want), max_abs(got[ids], want)
            k3_ms = median(cuda_ms(lambda: real_fused(
                scene, org, dirs, seed, spp, **kw), 5))
            b3 = bound(o.shape[0] * (24 + 12) + nbytes(tri, face, light),
                       (work["tris"] * MT_OPS + work["shade"] * SHADE_OPS)
                       * every)
            say(f"phase 25 path_tracer, 256^2 x 64 spp x 8 bounces: "
                f"{out['seconds']:.4f} s (host clock, the image copied "
                f"back) = {256 * 256 * 64 / out['seconds'] / 1e6:.1f} "
                f"Msamples/s; image mean {float(img.mean())}; launches "
                f"{counts}; K3 relaunched {k3_ms:.3f} ms (CUDA events, "
                f"median of 5) vs bound {b3[0]:.4f} ms ({b3[1]}); every "
                f"{every}th pixel ({ids.numel()}, trig "
                f"{kw.get('trig', 'native')}, {kw['azimuth_strata']} "
                f"azimuth strata) == plain bit for bit: {fr} (max abs err "
                f"{err3}, plain {plain_s:.1f} s with its work counted)")
            check(set(counts) == {"pt_fused_brute", "pinhole_fused"}
                  and counts["pinhole_fused"] == 1 and len(k3_kept) == 1,
                  f"phase 25 path_tracer: launches {counts}")
            check(fr > 0.99, f"phase 25 path_tracer: K3 != plain on "
                  f"{1 - fr} of the sampled pixels")
            check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                  "phase 25 path_tracer: non-finite or black image")
            del k3_kept, out, img, got, want

            # ---- bidir_path_tracer: 128^2 x 16 spp
            zero_launch_counts()
            out = bidir_path_tracer.main([])
            counts = nonzero(launch_counts())
            img = out["img"]
            say(f"phase 25 bidir_path_tracer, 128^2 x 16 spp: "
                f"{out['seconds']:.3f} s; image mean {float(img.mean())}; "
                f"launches {counts} (the 32-triangle box sweeps brute "
                f"force: at most BRUTE_MAX_TRIS triangles; the camera "
                f"kernel makes its rays)")
            check(counts == {"pinhole_fused": 1},
                  f"phase 25 bidir: launches {counts}")
            check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                  "phase 25 bidir: non-finite or black image")

            # ---- gltfrender: 8 spheres on a ring in a .glb, 512^2
            sv, sf = make_uv_sphere(32, 64, 0.5)
            ring_glb("ring.glb", sv, sf, [
                ((1.6 * np.cos(a), 0.2 * np.sin(3 * a), 1.6 * np.sin(a)),
                 (0.3, 1.0, 0.1), a) for a in np.arange(8) * np.pi / 4])
            zero_launch_counts()
            out = gltfrender.main(["ring.glb"])
            counts = nonzero(launch_counts())
            hit = float(out["hits"].hit.float().mean())
            say(f"phase 25 gltfrender, 8 instances of {len(sf)} tris, "
                f"512^2: commit {out['seconds']['commit']:.3f} s, walk "
                f"{out['seconds']['walk']:.3f} s = "
                f"{512 * 512 / out['seconds']['walk'] / 1e6:.3f} Mrays/s; "
                f"hit {hit:.4f}; launches {counts}")
            check(counts == {"pinhole_fused": 1} and hit > 0.05,
                  f"phase 25 gltfrender: launches {counts}, hit {hit}")

            # ---- viewer: the terminal surface at its default 5 s, stdout
            # captured. Each half-run (before and after the orbit) renders
            # up to the cap of MAX_PASSES passes and then idles, so the
            # run is 2 x MAX_PASSES passes of 2 K1 launches each; a card
            # that does not reach the cap in a half-run fails here. The
            # first pass of each half is held to the plain version.
            cap = viewer.MAX_PASSES
            res = {}
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out_txt:
                kept, n_k1 = capture_k1(
                    lambda: res.update(r=viewer.main([])),
                    only={0, 1, 2 * cap, 2 * cap + 1})
            wall = time.perf_counter() - t0
            counts = nonzero(launch_counts())
            r = res["r"]
            n = len(r.pass_times)
            k1 += counts.get("packet_traverse", 0)
            aov += counts.get("aovs_fused", 0)
            holds = [hold_k1_launch(*c, every) for c in kept]
            err = max([err] + [h["err"] for h in holds])
            say(f"phase 25 viewer terminal, 128^2, 5 s: {n} passes in "
                f"{wall:.2f} s (median pass {median(r.pass_times) * 1e3:.2f} "
                f"ms; {r.passes_done} since the orbit's restart); "
                f"{len(out_txt.getvalue().splitlines())} status lines; "
                f"launches {counts}; the first pass of each half, every "
                f"{every}th ray == plain: "
                + held("viewer pass (first of a half-run)", holds))
            check(n == 2 * cap and r.passes_done == cap
                  and counts == {"packet_traverse": 4 * cap,
                                 "aovs_fused": 2 * cap,
                                 "pinhole_fused": 2 * cap}
                  and n_k1 == 4 * cap,
                  f"phase 25 viewer terminal: {n} passes, "
                  f"{r.passes_done} since the orbit, launches {counts}; "
                  f"expected {2 * cap} passes, {cap} since the orbit, "
                  f"{4 * cap} K1 and {2 * cap} AOV launches")
            check(len(holds) == 4 and all(h["same"] for h in holds),
                  "phase 25 viewer terminal: K1 != plain")
            del kept, holds, r, res

            # ---- viewer: the HTTP surface on 127.0.0.1:0, its graph pass
            # timed over ~3.5 s of serving
            ports, res = [], {}
            ready = threading.Event()

            def serve():
                with contextlib.redirect_stdout(io.StringIO()):
                    res["r"] = viewer.run_http(
                        0, 60, dev,
                        ready=lambda p: (ports.append(p), ready.set()))

            zero_launch_counts()
            th = threading.Thread(target=serve, daemon=True)
            th.start()
            status, png, commits = {}, b"", None
            t0 = time.perf_counter()
            if ready.wait(60):
                t0 = time.perf_counter()

                def call(path, body=None):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{ports[0]}{path}",
                        data=None if body is None else json.dumps(
                            body).encode(),
                        method="GET" if body is None else "POST")
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        status[f"{req.method} {path}"] = resp.status
                        return resp.read()

                call("/")
                png = call("/frame.png")
                time.sleep(max(0.0, 3.5 - (time.perf_counter() - t0)))
                call("/node", {"name": "ball_a", "dx": 0.25})
                commits = json.loads(call("/status"))["commits"]
                call("/quit", {})
            th.join(60)
            wall = time.perf_counter() - t0
            counts = nonzero(launch_counts())
            times = res["r"].pass_times if "r" in res else []
            say(f"phase 25 viewer http on 127.0.0.1:"
                f"{ports[0] if ports else '-'}: {status}; frame.png "
                f"{len(png)} bytes; commits after the nudge {commits}; "
                f"stopped {not th.is_alive()}; the graph pass, 128^2: "
                f"{len(times)} passes in {wall:.2f} s of serving (median "
                f"pass {median(times) * 1e3 if times else float('nan'):.2f}"
                f" ms); launches {counts}")
            check(len(status) == 5 and set(status.values()) == {200}
                  and commits == 2 and not th.is_alive()
                  and len(times) >= 1
                  and counts == {"pinhole_fused": len(times)},
                  f"phase 25 viewer http: {status}, {len(times)} passes, "
                  f"launches {counts}")

            # ---- the graft entry: card == CPU (K1's plain version)
            zero_launch_counts()
            fn, args = graft_entry.entry()
            got = fn(*args)
            counts = nonzero(launch_counts())
            k1 += counts.get("packet_traverse", 0)
            aov += counts.get("aovs_fused", 0)
            cfn, cargs = graft_entry.entry(device="cpu")
            want = cfn(*cargs)
            same = torch.equal(got.cpu(), want)
            say(f"phase 25 graft entry: rgb {tuple(got.shape)}, mean "
                f"{float(got.mean())}; launches {counts}; card == CPU bit "
                f"for bit: {same}")
            check(same and counts == {"packet_traverse": 1,
                                      "aovs_fused": 1, "pinhole_fused": 1},
                  f"phase 25 graft entry: same={same}, launches {counts}")
        finally:
            os.chdir(cwd)
    say(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    return k1, err, k3, err3, aov


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


_LAUNCH_BASE: dict = {}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since ``zero_launch_counts``,
    by kernel name."""
    from nanort_tpu_torch.utils import trace

    return trace.launches(_LAUNCH_BASE)


def nonzero(counts: dict) -> dict:
    """The kernels of ``counts`` that launched."""
    return {k: v for k, v in counts.items() if v}


def zero_launch_counts():
    global _LAUNCH_BASE
    from nanort_tpu_torch.utils import trace

    _LAUNCH_BASE = trace.counts()


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
    from nanort_tpu_torch.utils import trace

    dev = torch.device("cuda", 0)

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"# phase 1: card {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)

    # ---- 2. builds (and, beside them, the ptxas reports of the kernels)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    # first the reports that phases 6 and 7 print, the others by phases
    # 14, 18 (phase 6 prints the AOV and camera kernels')
    usage_aovs = pool.submit(lambda: _ext.resource_usage("aovs"))
    usage_camera = pool.submit(lambda: _ext.resource_usage("camera"))
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
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); peak stack "
        f"{k1_stats['max_sp']} of {slots} slots")
    k1_shape(f"phase 5: {2 * m} rays ({m} tiled camera + {m} incoherent)",
             kernel_ms, k1_bound)
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

    cams = [hold_camera(dev, w, h, 10) for w, h in ((res, res),
                                                    (3840, 2160))]
    for h in cams:
        say_camera("phase 6", h, 10)
    say("phase 6 camera kernel, ptxas -v: " + " | ".join(
        " ".join(ln.split()) for ln in usage_camera.result().splitlines()
        if "Used" in ln or "spill" in ln))
    torch.cuda.empty_cache()
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
    del holder["traverse_bvh8 (warm-up)"]

    def frame():
        # the last frame's 1.3 GB of records go back to the allocator
        # first: a repetition that had to allocate its own would time the
        # allocation's host gap between the events
        holder.pop("h", None)
        holder["h"] = packet.traverse_bvh8(scene, rays_t, specialize=spec)

    ms = cuda_ms(frame, 3)
    frame_ms = median(ms)
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
        f"coverage {expect:.5f}); launches {launches}; plain version on the "
        f"{2 * m}-ray subset {plain_ms:.1f} ms vs kernel {kernel_ms:.3f} ms")
    h = hits.hit
    check(tuple(hits.t.shape) == (res, res), "frame hits have the wrong shape")
    check(launches >= 4 and counts["pinhole_fused"] == 1
          and sum(counts.values()) == launches + 1,
          f"main path launches {counts}: K1 and one camera expected")
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
    aov = hold_aovs(TriangleMesh(torch.from_numpy(v).to(dev),
                                 torch.from_numpy(f).to(dev)), rays, hits, 10)
    say_aovs(f"phase 6: the {res}^2 frame's", aov, 10)
    say("phase 6 AOV kernel, ptxas -v: " + " | ".join(
        " ".join(ln.split()) for ln in usage_aovs.result().splitlines()
        if "Used" in ln or "spill" in ln))
    del holder
    torch.cuda.empty_cache()
    say_route("phase 6", route_split(scene, rays), res, res, 5)
    holder = {}

    # phase 4's scene and phase 5's rays stay for phase 18
    del rays, rays_t, untile, hits, holder, scene_h, bvh, fr, fh
    torch.cuda.empty_cache()
    k2k5, launches_pt, err_pt, k2_inputs = path_tracer_phases(dev, usage_pt)
    torch.cuda.empty_cache()
    entries_a, launches_a, err_a, aov_a = config_a_phases(dev, k2_inputs,
                                                          usage)
    del k2_inputs
    torch.cuda.empty_cache()
    roots_entry, s8i, rays_i, launches_17, err_17 = incoherent_phases(dev)
    entries_18, frame_bound_18 = k1_mode_phases(dev, scene, sub, s8i, rays_i,
                                                usage_k1)
    pool.shutdown()
    del rays_i, sub  # phase 16's BVH8 stays for phase 24
    torch.cuda.empty_cache()
    launches_19, err_19, woop_19, woop_err_19 = device_build_phases(
        dev, v, f, scene)
    feature_phases(dev)
    torch.cuda.empty_cache()
    launches_21, err_21, rtc_entry = api_phases(dev)
    torch.cuda.empty_cache()
    launches_22, err_22, woop_22, woop_err_22, aov_22 = renderer_phases(dev)
    torch.cuda.empty_cache()
    launches_23, err_23 = loader_phases(dev)
    torch.cuda.empty_cache()
    launches_24, err_24 = multidevice_phases(dev, v, f, s8i)
    del s8i
    torch.cuda.empty_cache()
    launches_25, err_25, k3_25, k3_err_25, aov_25 = example_phases(dev, v, f)
    for e in k2k5:  # K1-woop's entry gains phase 19's and 22's woop paths
        if e["name"] == "packet_traverse_woop":
            e["launches"] += woop_19 + woop_22
            e["max_abs_err"] = max(e["max_abs_err"], woop_err_19,
                                   woop_err_22)
        if e["name"] == "pt_fused_brute":  # K3 gains phase 25's render
            e["launches"] += k3_25
            e["max_abs_err"] = max(e["max_abs_err"], k3_err_25)
    k1_shape(f"phase 6: the {res}^2 frame (median of 3; bound from phase "
             f"18's counters)", frame_ms, frame_bound_18)
    report_k1_shapes()
    say(f"packet_traverse launches on the main paths: {launches} (phase 6) "
        f"+ {launches_pt} (phase 11, pallas) + {launches_a} (phase 13) + "
        f"{launches_17} (phase 17) + {launches_19} (phase 19, device-built "
        f"tables) + {launches_21} (phase 21, rtc) + {launches_22} (phase 22, "
        f"render_pbr and trace_bdpt) + {launches_23} (phase 23, the "
        f"loaders' frames) + {launches_24} (phase 24, the chunk-sharded "
        f"scene) + {launches_25} (phase 25, the example programs and the "
        f"graft entry); pt_fused_brute gains {k3_25} (phase 25, "
        f"path_tracer); packet_traverse_woop gains {woop_19} "
        f"(phase 19) + {woop_22} (phase 22, trace_bdpt on the Woop scene); "
        f"the 8192^2 frame's bound from its "
        f"counters {frame_bound_18[0]:.4f} ms ({frame_bound_18[1]}); "
        f"aovs_fused launches: {aov['total']} (phase 6, the held call and "
        f"the timed ones) + {aov_a} (phases 13-15, config A's renders and "
        f"the held and timed 512^2 calls) + {aov_22} (phase 22, "
        f"render_pbr) + {aov_25} (phase 25, the example programs and the "
        f"graft entry)")
    say(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s from its start "
        "to the kernels line")

    say(json.dumps({"kernels": [{
        "name": "packet_traverse",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:66",
        "launches": (launches + launches_pt + launches_a + launches_17
                     + launches_19 + launches_21 + launches_22 + launches_23
                     + launches_24 + launches_25),
        "max_abs_err": max(max_abs, err_pt, err_a, err_17, err_19, err_21,
                           err_22, err_23, err_24, err_25),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, rtc_entry, {
        "name": "aovs",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/aovs.cu",
        "replaces": None,
        "launches": aov["total"] + aov_a + aov_22 + aov_25,
        "max_abs_err": 0.0 if aov["same"] else None,
        "ms": aov["ms"],
        "plain_ms": aov["plain_ms"],
        "bound_ms": aov["bound"][0],
        "bound_by": aov["bound"][1],
        "library_ms": None,
    }, {
        "name": "camera",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/camera.cu",
        "replaces": None,
        "launches": trace.counts()["pinhole_fused"],
        "max_abs_err": 0.0 if all(h["same"] for h in cams) else None,
        "ms": cams[0]["ms"],
        "plain_ms": cams[0]["plain_ms"],
        "bound_ms": cams[0]["bound"][0],
        "bound_by": cams[0]["bound"][1],
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
