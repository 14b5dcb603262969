"""Entry ``api_occluded``: the Embree-style API's ``occluded`` on batches of
shadow rays, one call at a time (ray sort, K1's any-hit walk, unsort):
the visibility queries a renderer makes towards an area light.

Set-up hands the program each copy's local mesh and its transform
through ``new_triangle_mesh``/``map_buffer``/``set_transform`` and
commits on the card, as ``api_intersect`` does. Traffic parameters:
``rays`` a batch, ``pool`` batches made in set-up from the seed and
cycled, ``offset`` along the normal, ``light`` (``side`` and ``height``,
each a share of the world bounds' x extent), ``check_rays`` sampled from
each of the pool's last answers, ``limits``. A shadow ray starts where a
bounce ray of ``api_intersect`` does (an area-weighted point of a world
triangle, on a side drawn with equal odds, ``offset`` off the surface
along that side's normal) and is aimed at a uniform point of a square
light of side ``side`` x the extent, level, centred above the bounds'
centre at the bounds' top + ``height`` x the extent; it ends 1e-4 of its
length short of the light (``max_t``), so the light itself never
occludes.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from rtbench import roofline
from rtbench.entries.api_intersect import bounce_rays
from rtbench.harness import sync
from rtbench.ref.tracer import RefMesh

# a ray's max_t: its distance to the light point times (1 - SHORT)
SHORT = 1e-4
# rays whose float64 nearest hit lies within T_TOL x (t + 1) of their
# max_t are left out of the comparison: a float32 ray may end either side
# of such a blocker
T_TOL = 1e-5


def shadow_rays(world_v, world_f, n: int, offset: float, light: dict, gen,
                device):
    """(org, dir, max_t) of ``n`` shadow rays over the world triangles,
    drawn with ``gen`` (a ``torch.Generator`` on ``device``): float32
    (n, 3), (n, 3), (n,)."""
    org, _ = bounce_rays(world_v, world_f, n, offset, gen, device)
    v = torch.as_tensor(world_v, device=device).double()
    lo, hi = v.amin(0), v.amax(0)
    ext = float(hi[0] - lo[0])
    side = float(light["side"]) * ext
    u = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)
    centre = 0.5 * (lo + hi)
    p = torch.stack([centre[0] + (u[:, 0] - 0.5) * side,
                     torch.full((n,), float(hi[1]) + float(light["height"])
                                * ext, dtype=torch.float64, device=device),
                     centre[2] + (u[:, 1] - 0.5) * side], 1)
    dvec = p - org.double()
    dist = dvec.norm(dim=1)
    return (org, (dvec / dist[:, None]).float().contiguous(),
            (dist * (1.0 - SHORT)).float().contiguous())


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
        o, d, max_t = shadow_rays(wv, wf, n, float(tr["offset"]),
                                  tr["light"], gen, dev)
        pool.append(Rays(o, d, torch.zeros(n, device=dev), max_t))
    st = SimpleNamespace(scene=scene, pool=pool, last={},
                         per_unit={"rays": n})
    for k in range(2):
        scene.occluded(pool[k % len(pool)])
    sync(dev)
    return st


def unit(run, i):
    st = run.state
    k = i % len(st.pool)
    st.last[k] = st.scene.occluded(st.pool[k])
    sync(run.device)


def finish(run):
    run.state.scene = None


def check(run, control=False):
    """The share of sampled answers (occluded or not) of the last call on
    each batch of the pool that the float64 reference
    (``ref.tracer.RefMesh.any_hit``: a triangle with 0 <= t <= max_t) does
    not give, in %, over the rays whose float64 nearest hit does not lie
    within T_TOL x (t + 1) of their max_t. ``control``: the reference in
    bfloat16 takes the program's place."""
    st, tr, sc, dev = run.state, run.cell.traffic, run.scene, run.device
    wv, wf = sc.world(np.float64)
    mesh = RefMesh(wv, wf, dev, torch.float64)
    low = RefMesh(wv, wf, dev, torch.bfloat16) if control else None
    rng = np.random.default_rng([run.seed & (2**63 - 1), 2])
    off = total = 0
    for k in sorted(st.last):
        rays = st.pool[k]
        idx = torch.as_tensor(rng.choice(rays.org.shape[0],
                                         int(tr["check_rays"]),
                                         replace=False), device=dev)
        o, d = rays.org[idx], rays.dir[idx]
        tmin, tmax = rays.min_t[idx].double(), rays.max_t[idx].double()
        want = mesh.any_hit(o, d, tmin, tmax)
        near_t, _, _, near_p = mesh.closest(
            o, d, tmin, tmax + 2.0 * T_TOL * (tmax + 1.0))
        keep = ~((near_p >= 0) & ((near_t - tmax).abs()
                                  <= T_TOL * (near_t.abs() + 1.0)))
        if control:
            got = low.any_hit(o, d, tmin, tmax)
        else:
            got = st.last[k][idx]
        off += int(((got != want) & keep).sum())
        total += int(keep.sum())
    return [("occ_off_pct", 100.0 * off / max(total, 1),
             float(tr["limits"]["occ_off_pct"]))]


def work(run):
    sc = run.scene
    n_v = len(sc.vertices) * len(sc.xforms)
    return {"k1": [roofline.k1_work(run.state.per_unit["rays"], n_v,
                                    sc.n_tris)]}
