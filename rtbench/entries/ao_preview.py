"""Entry ``ao_preview``: a preview loop of ``models.objrender.render_ao``
frames (the viewer's and objrender's AO route on BVH16 tables, K1), each
frame from its call to its AO image in host memory (one of ``keep``
page-locked framebuffers, reused in turn).

Set-up builds the tree with leaves of 8 and its BVH16 tables, as the
viewer does, and makes the camera rays of ``poses`` positions of an
orbit drawn from the seed; frame i takes pose i mod ``poses`` and a new
AO seed. Traffic parameters: ``camera`` (radius, center, fov, width,
height, azimuth and elevation swing), ``poses``, ``samples``,
``check_frames`` of the last ``keep`` frames and ``check_pixels`` a
frame, ``limits``.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from rtbench import camera, roofline
from rtbench.harness import sync, unit_seed
from rtbench.ref.checks import ao_local_draws, ao_reference, records_off
from rtbench.ref.tracer import RefMesh


def orbit(cam: dict, poses: int, seed: int) -> list:
    """Eye positions of the orbit: one swing in azimuth and two in
    elevation about the camera's centre over the ``poses`` positions.
    Every seed gets the same positions; the seed picks where the loop
    starts, so the work of a run does not depend on it."""
    start = int(np.random.default_rng([seed & (2**63 - 1), 3]).integers(
        poses))
    c = np.asarray(cam["center"], np.float64)
    out = []
    for j in range(poses):
        k = (start + j) % poses
        a = cam["azimuth_swing"] * math.sin(2 * math.pi * k / poses)
        e = cam["elevation_swing"] * math.sin(4 * math.pi * k / poses + 0.5)
        r = cam["radius"]
        out.append(c + r * np.array([math.cos(e) * math.sin(a), math.sin(e),
                                     math.cos(e) * math.cos(a)]))
    return out


def setup(run):
    from nanort_tpu_torch import (BVHBuildOptions, TriangleMesh,
                                  build_triangle_bvh)
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.core.ray import Rays
    from nanort_tpu_torch.models.objrender import render_ao

    tr, sc, dev = run.cell.traffic, run.scene, run.device
    v, f = sc.world(np.float32)
    f = f.astype(np.int32)
    t0 = time.perf_counter()
    bvh, _ = build_triangle_bvh(TriangleMesh(v, f), BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s8 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0
    cam = tr["camera"]
    W, H = int(cam["width"]), int(cam["height"])
    eyes = orbit(cam, int(tr["poses"]), run.seed)
    pool = []
    for eye in eyes:
        o, d = camera.rays(eye, cam["center"], W, H, cam["fov"], dev)
        pool.append(Rays(o, d, torch.zeros((H, W), device=dev),
                         torch.full((H, W), 1e30, device=dev)))
    keep = int(tr["keep"])
    # the viewer's framebuffers: page-locked host images, reused in turn
    pinned = dev.type == "cuda"
    st = SimpleNamespace(bvh=bvh, s8=s8, mesh=mesh, pool=pool, W=W, H=H,
                         v=v, f=f, samples=int(tr["samples"]), kept=[],
                         keep=keep, render=render_ao,
                         host=torch.empty((keep, H, W, 3), pin_memory=pinned),
                         per_unit={"rays": W * H})
    for k in range(2):
        st.render(bvh, mesh, pool[k], seed=unit_seed(~run.seed, k),
                  n_samples=st.samples, max_leaf=8, scene8=s8)
    sync(dev)
    return st


def unit(run, i):
    st = run.state
    k = i % len(st.pool)
    s = unit_seed(run.seed, i)
    aovs, hits = st.render(st.bvh, st.mesh, st.pool[k], seed=s,
                           n_samples=st.samples, max_leaf=8, scene8=st.s8)
    img = st.host[i % st.keep]
    img.copy_(aovs["rgb"])
    st.kept.append((k, s, img, hits.t, hits.prim_id))
    if len(st.kept) > st.keep:
        st.kept.pop(0)


def finish(run):
    st = run.state
    st.bvh = st.s8 = st.mesh = st.render = None


def check(run, control=False):
    """The share of sampled pixels of sampled frames whose primary record
    or AO value the reference does not give (``ref.checks``), in %.
    ``control``: the reference in bfloat16 takes the program's place."""
    st, tr, dev = run.state, run.cell.traffic, run.device
    mesh = RefMesh(st.v, st.f, dev, torch.float64)
    low = RefMesh(st.v, st.f, dev, torch.bfloat16) if control else None
    rng = np.random.default_rng([run.seed & (2**63 - 1), 4])
    n_f = min(int(tr["check_frames"]), len(st.kept))
    off = total = 0
    for j in rng.choice(len(st.kept), n_f, replace=False):
        k, s, img, t, prim = st.kept[j]
        px = torch.as_tensor(rng.choice(st.H * st.W, int(tr["check_pixels"]),
                                        replace=False), device=dev)
        rays = st.pool[k]
        o, d = rays.org.reshape(-1, 3)[px], rays.dir.reshape(-1, 3)[px]
        local = ao_local_draws(s, st.samples, (st.H, st.W), dev)
        local = local.reshape(st.samples, -1, 3)[:, px]
        ref, ao = ao_reference(mesh, st.v, st.f, o, d, local)
        if control:
            (t, _, _, p), got = ao_reference(low, st.v, st.f, o, d, local)
        else:
            t, p = t.reshape(-1)[px], prim.reshape(-1)[px]
            p = torch.where(p == 0xFFFFFFFF, -1, p)
            got = img.reshape(-1, 3)[px.cpu(), 0].to(dev)
        n = px.numel()
        bad = records_off(mesh, o, d, torch.zeros(n, device=dev),
                          torch.full((n,), 1e30, device=dev), t, p, ref=ref)
        got = got.double()
        bad |= (got - ao).abs() > 1e-6
        off += int(bad.sum())
        total += n
    return [("ao_off_pct", 100.0 * off / max(total, 1),
             float(tr["limits"]["ao_off_pct"]))]


def work(run):
    st = run.state
    n = st.W * st.H
    return {"k1": [roofline.k1_work(n, len(st.v), len(st.f)),
                   roofline.k1_work(n * st.samples, len(st.v), len(st.f))]}
