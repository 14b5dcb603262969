"""Entry ``path_traced``: ``models.path_tracer.render_path_traced`` on a
fixed camera, a new seed each render, the image copied to the host (one
of ``keep`` page-locked images, reused in turn).

Traffic parameters: ``camera`` (eye, center, fov, width, height),
``spp``, ``max_bounces``, ``keep``, ``check_renders`` and
``check_pixels`` (the renders among the last ``keep`` and the pixels a
render the comparison draws from the seed), ``limits``. The scene goes
to the program through ``make_pt_scene(..., engine="pallas")``: BVH16
tables with aux rows, the K4 route.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from rtbench import camera, roofline
from rtbench.harness import sync, unit_seed
from rtbench.ref.pathtrace import (PTRef, azimuth_strata, spp_lanes,
                                   tile_launch_positions)

RR_START = 3  # the path tracer's Russian-roulette start (its default)


def tables(sc):
    """(vertices float32, faces int32, material ids, materials) of the
    scene's world-space union."""
    v, f = sc.world(np.float32)
    return v, f.astype(np.int32), sc.world_material_ids(), sc.materials


def setup(run):
    from nanort_tpu_torch.core.ray import Rays
    from nanort_tpu_torch.models import path_tracer

    tr, sc, dev = run.cell.traffic, run.scene, run.device
    t0 = time.perf_counter()
    scene = path_tracer.make_pt_scene(*tables(sc), engine="pallas",
                                      device=dev)
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0
    cam = tr["camera"]
    W, H = int(cam["width"]), int(cam["height"])
    org, d = camera.rays(cam["eye"], cam["center"], W, H, cam["fov"], dev)
    rays = Rays(org, d, torch.zeros((H, W), device=dev),
                torch.full((H, W), 1e30, device=dev))
    keep = int(tr["keep"])
    st = SimpleNamespace(scene=scene, rays=rays, W=W, H=H,
                         spp=int(tr["spp"]), bounces=int(tr["max_bounces"]),
                         images=[], seeds=[], keep=keep,
                         host=torch.empty((keep, H, W, 3),
                                          pin_memory=dev.type == "cuda"),
                         per_unit={"samples": W * H * int(tr["spp"])})
    # warm-up at the cell's own shape
    for k in range(2):
        path_tracer.render_path_traced(scene, rays, unit_seed(~run.seed, k),
                                       spp=st.spp, max_bounces=st.bounces)
    sync(dev)
    st.render = path_tracer.render_path_traced
    return st


def unit(run, i):
    st = run.state
    s = unit_seed(run.seed, i)
    img = st.render(st.scene, st.rays, s, spp=st.spp, max_bounces=st.bounces)
    host = st.host[i % st.keep]
    host.copy_(img)
    st.images.append(host)
    st.seeds.append(s)
    if len(st.images) > st.keep:
        st.images.pop(0)
        st.seeds.pop(0)


def finish(run):
    st = run.state
    st.scene = None
    st.render = None


def check(run, control=False):
    """The share of sampled pixels of sampled renders whose radiance the
    reference does not give: off where a channel differs by more than
    1e-4 x (1 + the reference's largest channel). ``control``: the
    reference in bfloat16 takes the program's place."""
    st, tr, sc, dev = run.state, run.cell.traffic, run.scene, run.device
    rng = np.random.default_rng([run.seed & (2**63 - 1), 1])
    n_r = min(int(tr["check_renders"]), len(st.images))
    which = rng.choice(len(st.images), n_r, replace=False)
    ref = PTRef(*tables(sc), dev, torch.float32)
    pos = tile_launch_positions(st.H, st.W, dev)
    org = st.rays.org.reshape(-1, 3)
    dirs = st.rays.dir.reshape(-1, 3)
    strata = azimuth_strata(st.spp)
    lanes = spp_lanes(st.spp, strata)
    low = PTRef(*tables(sc), dev, torch.bfloat16) if control else None
    off = total = 0
    for r in which:
        px = torch.as_tensor(rng.choice(st.H * st.W, int(tr["check_pixels"]),
                                        replace=False), device=dev)
        want = ref.render(org[px], dirs[px], pos[px], st.seeds[r], st.spp,
                          st.bounces, RR_START, strata, lanes)
        if control:
            got = low.render(org[px], dirs[px], pos[px], st.seeds[r], st.spp,
                             st.bounces, RR_START, strata, lanes).float()
        else:
            got = st.images[r].reshape(-1, 3)[px.cpu()].to(dev)
        tol = 1e-4 * (1.0 + want.abs().amax(1))
        off += int(((got - want).abs().amax(1) > tol).sum())
        total += px.numel()
    return [("pt_off_pct", 100.0 * off / max(total, 1),
             float(tr["limits"]["pt_off_pct"]))]


def work(run):
    """K4's (bytes, operations) of one render, from the inputs: the
    camera rays that hit count one shading a sample (the reference's
    closest hit of each camera ray)."""
    st, sc = run.state, run.scene
    if not hasattr(st, "hits"):
        ref = PTRef(*tables(sc), run.device, torch.float32)
        org = st.rays.org.reshape(-1, 3)
        n = org.shape[0]
        prim = ref.mesh.closest(
            org, st.rays.dir.reshape(-1, 3),
            torch.full((n,), 0.001, device=run.device),
            torch.full((n,), 1e30, device=run.device))[3]
        st.hits = int((prim >= 0).sum())
    return {"k4": [roofline.k4_work(st.W * st.H, st.spp, st.hits,
                                    len(sc.vertices) * len(sc.xforms),
                                    sc.n_tris,
                                    len(sc.materials["ior"]))]}
