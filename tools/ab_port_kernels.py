#!/usr/bin/env python3
"""A/B of the PyTorch port's BVH16 kernels between two checkouts, on one
card, in turns.

    python3 tools/ab_port_kernels.py OTHER_CHECKOUT

Runs one child process a turn, in the order A, B, B, A, where A imports
``nanort_tpu_torch`` from OTHER_CHECKOUT and B from the checkout that
holds this script; each builds its kernels into its own
``nanort_tpu_torch/_build``. A turn measures with CUDA events, after a
warm-up:

- K2 alone (``fused_trace.trace_bvh16``): closest hit with aux rows and
  occlusion on 65,536 seeded incoherent rays over the 99,236-triangle
  dense Cornell scene (``chip_smoke.py`` phase 7's rays), median of 20;
- K5 (``ao_fused.render_ao_fused``): config A, 512^2 x 8 AO samples on
  the 16,138-triangle Cornell box + UV sphere (phase 14), median of 10;
- K4's route (``path_tracer.render_path_traced``) on the dense scene at
  512^2 x 100 spp x 10 bounces (phase 9), median of 3, and, where the
  checkout has it, the same render on the lane kernel
  (``_schedule="lane"``).

Prints one JSON line a turn (each number the median of its repetitions)
and, last, the least of each side's two turns with the card's name and
power limit. Needs one NVIDIA GPU; imports no JAX.
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
    from nanort_tpu_torch.models import ao_fused, path_tracer, pt_fused
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import _ext, fused_trace

    dev = torch.device("cuda", 0)
    _ext.load_all()
    res = {}
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
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"A": os.path.abspath(sys.argv[1]), "B": here}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = {"A": [], "B": []}
    for side in "ABBA":
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child"], cwd=trees[side], capture_output=True,
                           text=True, timeout=900)
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
        summary[side] = {k: min(r[k] for r in runs if k in r) for k in keys}
    print(json.dumps({"card": smi, "best_of_turns_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
