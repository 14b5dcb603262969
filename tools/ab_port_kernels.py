#!/usr/bin/env python3
"""A/B of the PyTorch port's kernels between two checkouts, on one card,
in turns.

    python3 tools/ab_port_kernels.py OTHER_CHECKOUT [--out FILE]

Runs one child process a turn, in the order A, B, B, A, where A imports
``nanort_tpu_torch`` from OTHER_CHECKOUT and B from the checkout that
holds this script; each builds its kernels into its own
``nanort_tpu_torch/_build``. A turn measures with CUDA events, after a
warm-up:

- K1 (``packet.traverse_bvh8``; ``k1_cases``): the 8192^2 frame over the
  ~1M-triangle BVH16 (``chip_smoke.py`` phase 6), phase 5's 131,072
  rays plain, with counters, with zero-edge flags and through the
  two-pass ``traverse_bvh8_exact``; the bounce-2 closest-hit and shadow
  traces of the midscale megabatch render on K1-woop (turbo) and K1
  (pallas), 6,553,600 sorted rays each (phase 11), and both whole
  renders; config A's K1 route (``render_ao``, phase 13) and its two
  traces; the round-1 launch of the treelet engine with its roots
  (phase 16); the AO bounce run (``traverse_bvh8_sorted(occlusion=True)``,
  4,194,304 rays, phase 17); K1 alone on phase 16's random rays and
  phase 17's sorted AO rays;
- K1b (``traverse_bvh8(..., interleave=K)``, ``k1b{K}_*``, K = 2 and 4):
  the frame, phase 5's rays, phase 16's random rays, phase 17's sorted
  AO rays and phase 11's bounce-2 closest-hit trace (``k1b_shapes``);
- K2 alone (``fused_trace.trace_bvh16``): closest hit with aux rows and
  occlusion on 65,536 seeded incoherent rays over the 99,236-triangle
  dense Cornell scene (phase 7's rays), median of 20;
- K5: config A, 512^2 x 8 AO samples on the 16,138-triangle Cornell
  box + UV sphere (phase 14), the whole render
  (``ao_fused.render_ao_fused``, median of 10) and the kernel alone
  (``ao_fused.ao_fused_outputs`` on fixed arguments, median of 20), and
  a hash of the AO image (``k5_hash``);
- K3 (``pt_fused.render_fused``; ``k3_cases``): phase 7's 4,096 rays x
  4 spp x 10 bounces with ``trig="poly"`` and ``"native"``, median of 20,
  and config B (512^2 x 100 spp x 10 bounces on the 32-triangle Cornell
  box) through ``render_path_traced`` and with ``"poly"``, median of 5;
  the images' hashes (``*_hash``) show whether both sides give the same
  bits;
- K4's route (``path_tracer.render_path_traced``) on the dense scene at
  512^2 x 100 spp x 10 bounces (phase 9), median of 3, and, where the
  checkout has it, the same render on the lane kernel
  (``_schedule="lane"``).

Prints one JSON line a turn (each number the median of its repetitions)
and, last, the card's name and power limit with each side's two turns
and their least (for a hash: the one value, or the two that differ); ``--out`` also writes that last line to FILE (which
``chip_smoke.py`` reads from ``chiprun_out/ab_port_kernels.json`` to
print the parent's K1 times). Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return sorted(out)[len(out) // 2]


def capture_k1(render, calls) -> list:
    """``render()`` once, keeping the K1 launches numbered ``calls``
    (0-based): ``(scene8, rays, positional, keyword arguments)`` each."""
    from nanort_tpu_torch.traverse import packet

    kept, n = [], [0]
    real = packet.traverse_bvh8

    def keep(scene8, rays, *a, **k):
        if n[0] in calls:
            kept.append((scene8, rays, a, dict(k)))
        n[0] += 1
        return real(scene8, rays, *a, **k)

    packet.traverse_bvh8 = keep
    try:
        render()
    finally:
        packet.traverse_bvh8 = real
    return kept


def sphere_shapes(dev) -> dict:
    """The ~1M-triangle sphere's K1 shapes: the BVH16 scene (leaf 9) with
    the tiled 8192^2 frame (phases 4-6) and phase 5's 131,072 rays, and
    the BVH8 scene (leaf 8, 1,024 treelets) with phase 16's 4,194,304
    random rays and phase 17's AO rays off 1024^2 primaries."""
    import numpy as np
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import make_subdivided_sphere_scene
    from nanort_tpu_torch.models import objrender
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import packet, treelet

    v, f = make_subdivided_sphere_scene(1_000_000)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=9, max_leaf_primitives=9))
    s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=8192, height=8192,
                  fov=60.0, device=dev)
    frame, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    spec = packet.detect_specialization(frame, sub=packet.DEF_SUB)
    m = 65_536
    g = np.random.default_rng(7)
    iorg = g.uniform(-1.5, 1.5, (m, 3)).astype(np.float32)
    idir = g.normal(size=(m, 3))
    idir = (idir / np.linalg.norm(idir, axis=1, keepdims=True)).astype(
        np.float32)
    sub = nt.Rays(
        torch.cat([frame.org[:m], torch.from_numpy(iorg).to(dev)]),
        torch.cat([frame.dir[:m], torch.from_numpy(idir).to(dev)]),
        torch.cat([frame.min_t[:m], torch.zeros(m, device=dev)]),
        torch.cat([frame.max_t[:m], torch.full((m,), 3.4e38, device=dev)]))

    bvh8, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    tl, s8h = treelet.make_treelets(collapse_bvh8(bvh8, v, f), 1024)
    s8 = s8h.to(dev)
    rng = np.random.default_rng(11)
    R = 4_194_304
    org = rng.uniform(np.asarray(bvh8.bmin[0]), np.asarray(bvh8.bmax[0]),
                      (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_i = nt.make_rays(torch.from_numpy(org).to(dev),
                          torch.from_numpy(d.astype(np.float32)).to(dev))
    cam_b = look_at(eye=(0, 0, 2.2), center=(0, 0, 0), width=1024,
                    height=1024, fov=60.0, device=dev)
    rays_p, _ = packet.tile_image_rays(pinhole_rays(cam_b), 128, 32)
    hp = packet.traverse_bvh8(s8, rays_p,
                              specialize=packet.detect_specialization(rays_p))
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev).long())
    n = objrender.face_normals(mesh, hp.prim_id)
    x = rays_p.org + rays_p.dir * hp.t[:, None]
    n = torch.where((n * rays_p.dir).sum(-1, keepdim=True) > 0, -n, n)
    t_o, b_o = objrender.build_onb(n)
    local = objrender._cosine_hemisphere(
        torch.Generator(device=dev).manual_seed(3), (4, n.shape[0]),
        torch.float32, dev)
    wdir = (local[..., 0:1] * t_o + local[..., 1:2] * b_o
            + local[..., 2:3] * n)
    brays = nt.make_rays((x + n * 1e-3).expand(4, -1, -1).reshape(-1, 3),
                         wdir.reshape(-1, 3),
                         max_t=torch.where(hp.hit.expand(4, -1).reshape(-1),
                                           0.5, -1.0))
    return dict(v=v, f=f, s16=s16, frame=frame, spec=spec, sub=sub, s8=s8,
                tl=tl, rays_i=rays_i, brays=brays)


def k1b_shapes(dev, sph=None, bounce2=None) -> dict:
    """K1b's shapes: ``{name: (scene8, rays, positional, keyword
    arguments)}`` of the K1 call each one makes without ``interleave``:
    the 8192^2 frame, phase 5's 131,072 rays, phase 16's 4,194,304
    random rays (unsorted), phase 17's sorted AO rays (the trace that
    ``traverse_bvh8_sorted(occlusion=True)`` launches) and phase 11's
    bounce-2 closest-hit trace of the pallas megabatch render
    (6,553,600 sorted rays; ``bounce2`` when the caller captured it)."""
    from nanort_tpu_torch.io.procedural import make_cornell_dense_pt_scene
    from nanort_tpu_torch.models import path_tracer
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.traverse import ray_sort

    sph = sphere_shapes(dev) if sph is None else sph
    (sa,) = capture_k1(lambda: ray_sort.traverse_bvh8_sorted(
        sph["s8"], sph["brays"], occlusion=True), (0,))
    if bounce2 is None:
        dense = path_tracer.make_pt_scene(
            *make_cornell_dense_pt_scene(100_000), engine="pallas",
            device=dev)
        cam512 = pinhole_rays(look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0),
                                      width=512, height=512, fov=45.0,
                                      device=dev))
        (bounce2,) = capture_k1(lambda: path_tracer.render_path_traced(
            dense, cam512, 3, spp=100, max_bounces=10, fused=False), (4,))
    return {
        "frame_8192": (sph["s16"], sph["frame"], (),
                       dict(specialize=sph["spec"])),
        "phase5": (sph["s16"], sph["sub"], (), {}),
        "random": (sph["s8"], sph["rays_i"], (), {}),
        "ao_sorted": sa,
        "bounce2_closest": bounce2,
    }


def k1_cases(dev) -> dict:
    """K1's shapes: ``{name: (fn, repetitions)}``, each ``fn`` one call
    through the port's entry points that returns what it computed (hits
    or an image), and K1b's (``k1b{K}_*``, K = 2 and 4, on
    ``k1b_shapes``; K1 on the two of them it has no case for). Uses only
    entry points that the other checkout of an A/B has too."""
    import numpy as np
    import torch

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_cornell_dense_pt_scene, make_uv_sphere,
        merge_meshes)
    from nanort_tpu_torch.models import objrender, path_tracer
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import packet, ray_sort, treelet

    cases = {}
    call = packet.traverse_bvh8  # looked up now: capture_k1 patches it

    def k1(scene, rays, *a, **k):
        return lambda: call(scene, rays, *a, **k)

    # phases 4-6 and 18: the ~1M-triangle sphere, leaf 9, BVH16
    sph = sphere_shapes(dev)
    s16, sub = sph["s16"], sph["sub"]
    cases["k1_frame_8192"] = (k1(s16, sph["frame"], specialize=sph["spec"]),
                              3)
    fast = nt.BVHTraceOptions(exact_edge_fallback=False)
    cases["k1_phase5"] = (k1(s16, sub), 10)
    cases["k1_phase5_counts"] = (k1(s16, sub, debug_counts=True), 10)
    cases["k1_phase5_flags"] = (k1(s16, sub, fast, _flag_zero_edges=True), 10)
    cases["k1_phase5_exact_two_pass"] = (
        lambda: packet.traverse_bvh8_exact(s16, sub), 5)

    # phase 11: bounce 2 of the first megabatch, closest hit and shadow
    dense = make_cornell_dense_pt_scene(100_000)
    cam512 = pinhole_rays(look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0),
                                  width=512, height=512, fov=45.0,
                                  device=dev))
    bounce2 = None
    for engine, name in (("turbo", "k1woop"), ("pallas", "k1")):
        scene = path_tracer.make_pt_scene(*dense, engine=engine, device=dev)

        def render(scene=scene):
            return path_tracer.render_path_traced(
                scene, cam512, 3, spp=100, max_bounces=10, fused=False)

        for kind, kept in zip(("closest", "shadow"),
                              capture_k1(render, (4, 5))):
            s8, r, a, k = kept
            cases[f"{name}_bounce2_{kind}"] = (k1(s8, r, *a, **k), 5)
            if engine == "pallas" and kind == "closest":
                bounce2 = kept
        cases[f"megabatch_{engine}"] = (render, 3)

    # phase 13: config A on the K1 route and its two traces
    va, fa = merge_meshes(make_cornell_box(2.0), make_uv_sphere(64, 128, 0.6))
    bvh_a, _ = nt.build_triangle_bvh(TriangleMesh(va, fa), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16a = collapse_bvh8(bvh_a, va, fa, width=16).to(dev)
    mesh_a = TriangleMesh(torch.from_numpy(va).to(dev),
                          torch.from_numpy(fa).to(dev))
    rays_a = pinhole_rays(look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0),
                                  width=512, height=512, fov=45.0,
                                  device=dev))
    spec_a = packet.detect_specialization(rays_a)

    def route_a():
        return objrender.render_ao(bvh_a, mesh_a, rays_a, seed=7,
                                   n_samples=8, max_leaf=8, scene8=s16a,
                                   specialize=spec_a)[0]["ao"]

    cases["config_a_k1_route"] = (route_a, 5)
    for kind, (s8, r, a, k) in zip(("primary", "occlusion"),
                                   capture_k1(route_a, (0, 1))):
        cases[f"k1_config_a_{kind}"] = (k1(s8, r, *a, **k), 5)

    # phases 16-17: the ~1M-triangle sphere, leaf 8, BVH8 with treelets
    s8, rays_i, tl = sph["s8"], sph["rays_i"], sph["tl"]
    (s8r, r1, a1, k1kw), = capture_k1(lambda: treelet.traverse_bvh8_binned(
        s8, rays_i, treelets=tl, K=8, octant_major=True, sub=16), (0,))
    cases["k1_roots_round1"] = (k1(s8r, r1, *a1, **k1kw), 5)
    brays = sph["brays"]
    cases["k1_ao_bounce"] = (lambda: ray_sort.traverse_bvh8_sorted(
        s8, brays, occlusion=True), 5)

    # K1b on its five shapes, and K1 on the two that have no case above
    reps = {"frame_8192": 3, "phase5": 10}
    for shape, (sc, r, a, k) in k1b_shapes(dev, sph, bounce2).items():
        if shape in ("random", "ao_sorted"):
            cases[f"k1_{shape}"] = (k1(sc, r, *a, **k), 5)
        for K in (2, 4):
            cases[f"k1b{K}_{shape}"] = (k1(sc, r, *a, interleave=K, **k),
                                        reps.get(shape, 5))
    return cases


def k3_cases(dev) -> tuple[dict, dict]:
    """K3's shapes: ``({name: (fn, repetitions)}, {name: fn})``, the
    first timed, the second hashed (``image_hash``): phase 7's 64x64 rays
    from the config-B eye x 4 spp x 10 bounces, 4 azimuth strata, with
    ``trig="poly"`` and ``"native"`` (``render_fused``), and config B,
    512^2 x 100 spp x 10 bounces on the 32-triangle Cornell box, through
    ``render_path_traced`` (``"native"``) and through ``render_fused``
    with ``"poly"``. Uses only ``render_fused`` and
    ``render_path_traced``, which every checkout of the port has."""
    from nanort_tpu_torch.io.procedural import make_cornell_pt_scene
    from nanort_tpu_torch.models import path_tracer, pt_fused
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    cornell = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                        device=dev)

    def cam(w):
        return pinhole_rays(look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0),
                                    width=w, height=w, fov=45.0, device=dev))

    c64, c512 = cam(64), cam(512)
    org, d = c512.org.reshape(-1, 3), c512.dir.reshape(-1, 3)
    az = path_tracer.default_azimuth_strata(100)

    def phase7(trig):
        return lambda: pt_fused.render_fused(
            cornell, c64.org.reshape(-1, 3), c64.dir.reshape(-1, 3), 11, 4,
            max_bounces=10, trig=trig, azimuth_strata=4)

    def route():
        return path_tracer.render_path_traced(cornell, c512, 3, spp=100,
                                              max_bounces=10)

    def route_poly():
        return pt_fused.render_fused(cornell, org, d, 3, 100, max_bounces=10,
                                     trig="poly", azimuth_strata=az)

    timed = {"k3_poly": (phase7("poly"), 20),
             "k3_native": (phase7("native"), 20),
             "k3_route": (route, 5), "k3_route_poly": (route_poly, 5)}
    hashed = {"k3_poly": phase7("poly"), "k3_route": route,
              "k3_route_poly": route_poly}
    return timed, hashed


def image_hash(img) -> str:
    """sha256 of an image's float32 bytes (the first 16 hex digits)."""
    import hashlib

    return hashlib.sha256(
        img.detach().float().contiguous().cpu().numpy().tobytes()
    ).hexdigest()[:16]


def child() -> dict:
    """One turn, in the checkout given as the working directory."""
    import functools
    import inspect

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.io.procedural import (
        make_cornell_box, make_cornell_dense_pt_scene, make_uv_sphere,
        merge_meshes)
    from nanort_tpu_torch.models import (ao_fused, objrender, path_tracer,
                                         pt_fused)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import _ext, fused_trace

    dev = torch.device("cuda", 0)
    _ext.load_all()
    res = {}
    for name, (fn, reps) in k1_cases(dev).items():
        res[f"{name}_ms"] = _ms(fn, reps)
    torch.cuda.empty_cache()
    timed, hashed = k3_cases(dev)
    for name, (fn, reps) in timed.items():
        res[f"{name}_ms"] = _ms(fn, reps)
    for name, fn in hashed.items():
        res[f"{name}_hash"] = image_hash(fn())
    del timed, hashed
    dense = path_tracer.make_pt_scene(*make_cornell_dense_pt_scene(100_000),
                                      engine="pallas", device=dev)
    # phase 7's rays: every 7th axis-parallel, every 13th zero, every 11th
    # with a short tmax
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
    res["k2_closest_ms"] = _ms(lambda: fused_trace.trace_bvh16(
        dense.scene8, rays, dense.fused_aux, want_aux=True), 20)
    res["k2_occlusion_ms"] = _ms(lambda: fused_trace.trace_bvh16(
        dense.scene8, rays, occlusion=True), 20)

    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(64, 128, 0.6))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    cam_a = pinhole_rays(look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0),
                                 width=512, height=512, fov=45.0,
                                 device=dev))
    aux = ao_fused.build_ao_aux(mesh, s16)
    res["k5_ms"] = _ms(lambda: ao_fused.render_ao_fused(
        mesh, cam_a, 7, s16, aux, n_samples=8), 10)
    res["k5_hash"] = image_hash(ao_fused.render_ao_fused(
        mesh, cam_a, 7, s16, aux, n_samples=8)[0]["ao"])
    flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in cam_a]
    draws = objrender.resolve_draws(cam_a, 7, 8, True).reshape(
        8, -1, 3).contiguous()
    nodes, leafs, aux_t, slots = fused_trace._check_tables(s16, aux, dev)
    res["k5_kernel_ms"] = _ms(lambda: ao_fused.ao_fused_outputs(
        nodes, leafs, aux_t, *flat, draws, 1e30, slots), 20)

    cam = pinhole_rays(look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0),
                               width=512, height=512, fov=45.0, device=dev))

    def route():
        path_tracer.render_path_traced(dense, cam, 3, spp=100,
                                       max_bounces=10)

    res["k4_route_ms"] = _ms(route, 3)
    real = pt_fused.render_fused_bvh
    if "_schedule" in inspect.signature(real).parameters:
        pt_fused.render_fused_bvh = functools.partial(real,
                                                      _schedule="lane")
        try:
            res["k4_lane_ms"] = _ms(route, 3)
        finally:
            pt_fused.render_fused_bvh = real
    return res


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(child()), flush=True)
        return 0
    args = sys.argv[1:]
    out = None
    if len(args) == 3 and args[1] == "--out":
        out = args.pop()
        args.pop()
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"A": os.path.abspath(args[0]), "B": here}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = {"A": [], "B": []}
    for side in "ABBA":
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child"], cwd=trees[side], capture_output=True,
                           text=True, timeout=1500)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(r.stdout.strip().splitlines()[-1])
        turns[side].append(got)
        print(json.dumps({"side": side, "tree": trees[side], **got}),
              flush=True)
    summary = {}
    for side, runs in turns.items():
        keys = sorted(set().union(*runs))
        summary[side] = {
            k: (min(r[k] for r in runs if k in r) if k.endswith("_ms")
                else sorted({r[k] for r in runs if k in r}))
            for k in keys}
    same = {k: summary["A"][k] == summary["B"][k] for k in summary["B"]
            if k.endswith("_hash") and k in summary["A"]}
    line = json.dumps({"card": smi, "turns_ms": turns,
                       "best_of_turns_ms": summary, "same_bits": same})
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
