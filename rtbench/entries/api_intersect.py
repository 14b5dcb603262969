"""Entry ``api_intersect``: the Embree-style API's ``intersect`` on
batches of bounce rays, one call at a time (ray sort, K1, unsort,
geometry-id remap).

Set-up hands the program each copy's local mesh and its transform
through ``new_triangle_mesh``/``map_buffer``/``set_transform`` and
commits on the card. Traffic parameters: ``rays`` a batch, ``pool``
batches made in set-up from the seed and cycled, ``offset`` along the
normal, ``check_rays`` sampled from each of the pool's last records,
``limits``. A bounce ray starts at an area-weighted point of a world
triangle, on a side drawn with equal odds, ``offset`` off the surface
along that side's normal, and leaves in a cosine-weighted direction
about it.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from rtbench import roofline
from rtbench.harness import sync
from rtbench.ref.checks import records_off
from rtbench.ref.tracer import RefMesh


def bounce_rays(world_v, world_f, n: int, offset: float, gen, device):
    """(org, dir) (n, 3) float32 of ``n`` bounce rays over the world
    triangles, drawn with ``gen`` (a ``torch.Generator`` on ``device``)."""
    v = torch.as_tensor(world_v, device=device).double()
    f = torch.as_tensor(world_f, device=device).long()
    tri = v[f]
    cr = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = cr.norm(dim=1)
    nrm = cr / area[:, None].clamp(min=1e-300)
    u = torch.rand((n, 5), generator=gen, device=device,
                   dtype=torch.float64)
    cdf = torch.cumsum(area, 0)
    k = torch.searchsorted(cdf, u[:, 0] * cdf[-1]).clamp(max=len(f) - 1)
    r1 = torch.sqrt(u[:, 1])
    b0, b1 = 1.0 - r1, r1 * (1.0 - u[:, 2])
    t = tri[k]
    p = b0[:, None] * t[:, 0] + b1[:, None] * t[:, 1] + (
        1.0 - b0 - b1)[:, None] * t[:, 2]
    side = torch.where(u[:, 3] < 0.5, -1.0, 1.0)[:, None]
    nn = nrm[k] * side
    # cosine-weighted about nn (revised ONB)
    sgn = torch.where(nn[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sgn + nn[:, 2])
    b = nn[:, 0] * nn[:, 1] * a
    tb = torch.stack([1.0 + sgn * nn[:, 0] ** 2 * a, sgn * b,
                      -sgn * nn[:, 0]], 1)
    bt = torch.stack([b, sgn + nn[:, 1] ** 2 * a, -nn[:, 1]], 1)
    phi = 2.0 * math.pi * u[:, 4]
    rr = torch.sqrt(torch.rand(n, generator=gen, device=device,
                               dtype=torch.float64))
    z = torch.sqrt((1.0 - rr * rr).clamp(min=0.0))
    d = (rr * torch.cos(phi))[:, None] * tb + (
        rr * torch.sin(phi))[:, None] * bt + z[:, None] * nn
    d = d / d.norm(dim=1, keepdim=True)
    return (p + offset * nn).float().contiguous(), d.float().contiguous()


def setup(run):
    from nanort_tpu_torch.api import rtc
    from nanort_tpu_torch.core.ray import Rays

    tr, sc, dev = run.cell.traffic, run.scene, run.device
    t0 = time.perf_counter()
    scene = rtc.new_device(device=dev).new_scene()
    for m in sc.xforms:
        g = scene.new_triangle_mesh(len(sc.faces), len(sc.vertices))
        scene.map_buffer(g, rtc.BufferType.VERTEX)[:] = sc.vertices
        scene.map_buffer(g, rtc.BufferType.INDEX)[:] = sc.faces
        scene.set_transform(g, m)
    scene.commit(fast=True)
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0

    n = int(tr["rays"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed & 0xFFFFFFFFFFFFFFFF)
    wv, wf = sc.world(np.float64)
    pool = []
    for _ in range(int(tr["pool"])):
        o, d = bounce_rays(wv, wf, n, float(tr["offset"]), gen, dev)
        pool.append(Rays(o, d, torch.zeros(n, device=dev),
                         torch.full((n,), 1e30, device=dev)))
    st = SimpleNamespace(scene=scene, pool=pool, last={},
                         per_unit={"rays": n})
    for k in range(2):
        scene.intersect(pool[k % len(pool)])
    sync(dev)
    return st


def unit(run, i):
    st = run.state
    k = i % len(st.pool)
    st.last[k] = st.scene.intersect(st.pool[k])
    sync(run.device)


def finish(run):
    run.state.scene = None


def check(run, control=False):
    """The share of sampled records (t, u, v, prim id, geometry id) of
    the last call on each batch of the pool that the reference does not
    give (``ref.checks.records_off``), in %. ``control``: the reference
    in bfloat16 takes the program's place."""
    st, tr, sc, dev = run.state, run.cell.traffic, run.scene, run.device
    wv, wf = sc.world(np.float64)
    mesh = RefMesh(wv, wf, dev, torch.float64)
    low = RefMesh(wv, wf, dev, torch.bfloat16) if control else None
    per = len(sc.faces)
    rng = np.random.default_rng([run.seed & (2**63 - 1), 2])
    off = total = 0
    for k in sorted(st.last):
        h, rays = st.last[k], st.pool[k]
        idx = torch.as_tensor(rng.choice(rays.org.shape[0],
                                         int(tr["check_rays"]),
                                         replace=False), device=dev)
        o, d = rays.org[idx], rays.dir[idx]
        if control:
            t, u, v, prim = low.closest(o, d, rays.min_t[idx],
                                        rays.max_t[idx])
        else:
            miss = h.prim_id[idx] == 0xFFFFFFFF
            prim = torch.where(miss, -1,
                               h.node_id[idx] * per + h.prim_id[idx])
            t, u, v = h.t[idx], h.u[idx], h.v[idx]
        bad = records_off(mesh, o, d, rays.min_t[idx], rays.max_t[idx],
                          t, prim, u, v)
        off += int(bad.sum())
        total += idx.numel()
    return [("api_off_pct", 100.0 * off / max(total, 1),
             float(tr["limits"]["api_off_pct"]))]


def work(run):
    sc = run.scene
    n_v = len(sc.vertices) * len(sc.xforms)
    return {"k1": [roofline.k1_work(run.state.per_unit["rays"], n_v,
                                    sc.n_tris)]}
