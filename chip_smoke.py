#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernel is built for sm_90a), ``nvcc``
and ``g++``; builds every kernel from this checkout and imports nothing
of JAX. Phases, one line or more each:

1. the card (``nvidia-smi`` name and power limit);
2. the builds: the CUDA traversal kernel (nvcc) and the native SAH
   builder (g++), with their seconds;
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
   brute-force oracle.

It then prints one JSON line per kernel and, last, the ok line. Any
failed phase exits non-zero without the ok line; so does a machine
without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

FAILURES: list[str] = []


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


def main() -> int:
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

    # ---- 2. builds
    t0 = time.perf_counter()
    _ext.load()
    k_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    has_native = native.native_available()
    n_build = time.perf_counter() - t0
    say(f"# phase 2: kernel packet_traverse built (nvcc sm_90a, "
        f"--fmad=false) in {k_build:.2f} s; native SAH builder (g++) "
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

    def plain():
        return packet._traverse_reference(
            scene.nodes, scene.leafs, 16, sub.org, sub.dir, sub.min_t,
            sub.max_t, None, None, False, True, False, slots)

    got = packet.traverse_bvh8(scene, sub)
    ref = plain()
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

    # ---- 6. the main path, 8192^2
    del rays_t, untile, sub, got, ref
    torch.cuda.empty_cache()
    stage_ms = {}

    def stage(name, fn):
        stage_ms[name] = cuda_ms(lambda: holder.__setitem__(name, fn()), 1)[0]
        return holder[name]

    holder = {}
    packet.LAUNCHES = 0
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
    launches = packet.LAUNCHES
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
    check(launches >= 4, f"main path launched the kernel {launches} times")
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

    say(json.dumps({"kernels": [{
        "name": "packet_traverse",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:66",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
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
