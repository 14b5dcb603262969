#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a),
``nvcc`` and ``g++``; builds every kernel from this checkout and imports
nothing of JAX. Phases, one line or more each:

1. the card (``nvidia-smi`` name and power limit);
2. the builds: the three CUDA sources (one nvcc each, started together)
   and the native SAH builder (g++), with their seconds;
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
   (``render_fused_bvh``, spp_lanes 1 and 4) on the dense scene, each at
   4,096 rays x 4 spp x 10 bounces; K4 against K3 on the Cornell box with
   BVH16 tables attached. ``trig="poly"`` must agree bit for bit,
   ``"native"`` to 99% of pixels;
8. config B: ``render_path_traced`` on the Cornell box at 512^2 x 100
   spp x 10 bounces (K3), one warm-up and 3 timed repetitions;
9. midscale: the same on the dense scene (K4 on K2, 25 sample-major
   lanes, 4 azimuth strata, 32 x 128 pixel tiles).

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


def path_tracer_phases(dev) -> list[dict]:
    """Phases 7-9 (K2, K3, K4 and the config-B and midscale renders);
    returns their entries of the ``kernels`` line."""
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

    def k2_plain(occ):
        return fused_trace.trace_bvh16_reference(
            nodes, leafs, None if occ else aux, rays.org, rays.dir,
            rays.min_t, rays.max_t, occ, slots)

    got, want = k2(False), k2_plain(False)
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
    entries = []
    k3_res = {}
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

        got, want = k3(), k3_plain()
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

    d_org, d_dir = cam_rays(64, 64, 2.6)
    mat4, light4, _, _, _ = pt_fused.build_fused_bvh_tables(dense)
    lights4 = pt_fused._lights(dense, dev)
    k4_res = {}
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

        got, want = k4(), k4_plain()
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

    # ---- 9. midscale at full size (K4 on K2)
    cam = look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0), width=512,
                  height=512, fov=45.0, device=dev)
    img, ms_m, busy, counts = time_render(dense, pinhole_rays(cam))
    report_render(f"phase 9: midscale, {len(df)} tris (host scene + tables "
                  f"{dense_s:.2f} s), K4 on K2, spp_lanes "
                  f"{path_tracer.default_spp_lanes(100, 4)}", img, ms_m,
                  busy, counts, {"pt_fused_bvh": 4, "bvh16_trace": 4})
    launches_m, launches_k2 = counts["pt_fused_bvh"], counts["bvh16_trace"]

    return [{
        "name": "bvh16_trace",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/bvh16_trace.cuh",
        "replaces": "nanort_tpu/traverse/fused_trace.py:104",
        "launches": launches_k2,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }, {
        "name": "pt_fused_brute",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/pt_fused.cu",
        "replaces": "nanort_tpu/models/pt_fused.py:314",
        "launches": launches_b,
        "max_abs_err": k3_res["poly"][1],
        "ms": k3_res["poly"][2],
        "plain_ms": k3_res["poly"][3],
    }, {
        "name": "pt_fused_bvh",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/pt_fused.cu",
        "replaces": "nanort_tpu/models/pt_fused.py:532",
        "launches": launches_m,
        "max_abs_err": max(r[1] for r in k4_res.values()),
        "ms": k4_res[4][2],
        "plain_ms": k4_res[4][3],
    }]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from nanort_tpu_torch.models import pt_fused
    from nanort_tpu_torch.traverse import fused_trace, packet

    return {"packet_traverse": packet.LAUNCHES,
            "bvh16_trace": fused_trace.LAUNCHES, **pt_fused.LAUNCHES}


def zero_launch_counts():
    from nanort_tpu_torch.models import pt_fused
    from nanort_tpu_torch.traverse import fused_trace, packet

    packet.LAUNCHES = fused_trace.LAUNCHES = 0
    for k in pt_fused.LAUNCHES:
        pt_fused.LAUNCHES[k] = 0


def time_render(scene, rays):
    """``render_path_traced(seed=3, spp=100, max_bounces=10)``: one
    warm-up and 3 repetitions timed with CUDA events. Returns the last
    image, the 3 times in ms, the device's share of the 3 calls' host
    wall time (call to synchronised end) and every kernel's launches
    counted from 0 across the 4 renders."""
    import torch

    from nanort_tpu_torch.models import path_tracer

    holder = {}
    zero_launch_counts()

    def run():
        holder["img"] = path_tracer.render_path_traced(
            scene, rays, 3, spp=100, max_bounces=10)

    run()
    torch.cuda.synchronize()  # the warm-up's kernel is not in the wall
    t0 = time.perf_counter()
    ms = cuda_ms(run, 3)
    busy = sum(ms) / ((time.perf_counter() - t0) * 1e3)
    return holder["img"], ms, busy, launch_counts()


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

    del rays, rays_t, untile, hits, holder, scene, scene_h, bvh, fr, fh
    torch.cuda.empty_cache()
    k2k4 = path_tracer_phases(dev)

    say(json.dumps({"kernels": [{
        "name": "packet_traverse",
        "route": "cuda",
        "source": "nanort_tpu_torch/csrc/packet_traverse.cu",
        "replaces": "nanort_tpu/traverse/pallas_packet.py:66",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }] + k2k4}))
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
