"""Entry ``las_view``: the LAS viewer's frame of a LiDAR tile drawn as
spheres, inside the frame: ``models.cameras.look_at`` and
``pinhole_rays`` make the camera's rays, ``models.pointcloud.
render_sphere_aovs`` traces them through K1's sphere leaf test (the
frame in pixel tiles, padded to whole tiles) and derives the AOVs; records
and AOVs stay on the card, and the frame ends with a synchronise.

Set-up hands the configuration's points to the program as the LAS
viewer's loader does (``io/las.py::to_spheres``: the points as centres,
one radius, the configuration's), builds the binary tree with the
builder's defaults (``ops.sphere.build_sphere_bvh``: leaves of at most 4
spheres) and its sphere tables (``collapse_bvh8(..., width=WIDTH,
spheres=)``) and moves them to the card, all timed into
``run.spans["build"]``. Why these (an H100, PERF.md §6): at width 8 and
leaves of at most 4 K1 took 5.1-5.4 ms a 4K frame, against 6.9-7.3 at
leaves of 10 and 8.3-8.8 at width 16; leaves of 2 took 4.6-4.8 ms but
collapsed in 31 s against 19. The camera orbits the tile's centre at the
points' mean height by ``step``
radians a frame; the seed picks the position it starts from, so every
seed visits the same positions. Traffic parameters: ``camera`` (radius,
elevation, step, fov, width, height), ``check_pixels`` of the last frame,
``limits``.

The program's names are imported here, at the top: a program without
``render_sphere_aovs`` fails as the entry loads, before any scene work.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.models import cameras
from nanort_tpu_torch.models.pointcloud import render_sphere_aovs
from nanort_tpu_torch.ops.sphere import Spheres, build_sphere_bvh
from rtbench import camera, roofline
from rtbench.harness import sync
from rtbench.ref.spheres import RefSpheres, records_off

WIDTH = 8  # the tables' fan-out
# bytes of one sphere as K1's inputs hold it (centre and radius, float32)
SPHERE_BYTES = 16


def eye_of(cam: dict, center, a0: float, i: int):
    a = a0 + cam["step"] * i
    e, r = cam["elevation"], cam["radius"]
    return np.asarray(center, np.float64) + r * np.array(
        [math.cos(e) * math.sin(a), math.sin(e), math.cos(e) * math.cos(a)])


def setup(run):
    tr, sc, dev = run.cell.traffic, run.scene, run.device
    pts = np.ascontiguousarray(sc.vertices, np.float32)
    radius = float(sc.materials["radius"])
    t0 = time.perf_counter()
    host = Spheres(torch.from_numpy(pts),
                   torch.full((len(pts),), radius, dtype=torch.float32))
    bvh, _ = build_sphere_bvh(host)
    s8 = collapse_bvh8(bvh, width=WIDTH, spheres=host).to(dev)
    spheres = Spheres(host.centers.to(dev), host.radii.to(dev))
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0
    cam = tr["camera"]
    rng = np.random.default_rng([run.seed & (2**63 - 1), 5])
    st = SimpleNamespace(
        s8=s8, spheres=spheres, pts=pts, radius=radius, cam=cam,
        center=[0.0, float(pts[:, 1].astype(np.float64).mean()), 0.0],
        a0=float(cam["step"] * rng.integers(round(2 * math.pi
                                                  / cam["step"]))),
        W=int(cam["width"]), H=int(cam["height"]), look_at=cameras.look_at,
        pinhole=cameras.pinhole_rays, render=render_sphere_aovs, last=None)
    st.per_unit = {"rays": st.W * st.H}
    for k in (-2, -1):
        frame(run, st, k)
    st.last = None
    sync(dev)
    return st


def frame(run, st, i):
    st.last = None
    eye = eye_of(st.cam, st.center, st.a0, i)
    c = st.look_at(eye, st.center, width=st.W, height=st.H,
                   fov=float(st.cam["fov"]), device=run.device)
    rays = st.pinhole(c)
    aovs, hits = st.render(st.spheres, rays, scene8=st.s8)
    sync(run.device)
    st.last = (eye, rays, hits, aovs)


def unit(run, i):
    frame(run, run.state, i)


def finish(run):
    st = run.state
    st.s8 = st.spheres = st.render = None


def check(run, control=False):
    """The share of sampled pixels of the last frame whose camera ray,
    record (t, sphere), normal, UV, depth, position or colour the
    reference does not give, in %:
    the ray off by more than 1e-6 in a direction component or in the
    origin (relative) from the benchmark's float64 camera; the record and
    the AOVs as ``ref.spheres.records_off`` judges them against the
    float64 reference on the same rays. ``control``: the reference in
    bfloat16 (its camera, its spheres, its AOVs) takes the program's
    place."""
    st, tr, dev = run.state, run.cell.traffic, run.device
    eye, rays, hits, aovs = st.last
    cam = st.cam
    rng = np.random.default_rng([run.seed & (2**63 - 1), 6])
    px = torch.as_tensor(rng.choice(st.H * st.W, int(tr["check_pixels"]),
                                    replace=False), device=dev)
    o, d = camera.rays(eye, st.center, st.W, st.H, cam["fov"], dev,
                       torch.float64, pixels=px)
    radii = np.full(len(st.pts), st.radius)
    ref = RefSpheres(st.pts, radii, dev, torch.float64)
    n = px.numel()
    tmin = torch.zeros(n, dtype=torch.float64, device=dev)
    tmax = torch.full((n,), 3.0e38, dtype=torch.float64, device=dev)
    if control:
        po, pd = camera.rays(eye, st.center, st.W, st.H, cam["fov"], dev,
                             torch.bfloat16, pixels=px)
        low = RefSpheres(st.pts, radii, dev, torch.bfloat16)
        t, prim = low.closest(po, pd, tmin, tmax)
        got_p, got_n, got_uv = low.surface(po, pd, t, prim)
        hit = prim >= 0
        got_d = torch.where(hit, t, 0.0)
        got_rgb = torch.where(hit[:, None], 0.5 * got_n + 0.5, 0.0)
        po, pd = po.double(), pd.double()
    else:
        po = rays.org.reshape(-1, 3)[px].double()
        pd = rays.dir.reshape(-1, 3)[px].double()
        prim = hits.prim_id.reshape(-1)[px]
        prim = torch.where(prim == 0xFFFFFFFF, -1, prim)
        t = hits.t.reshape(-1)[px]
        got_n, got_uv, got_p, got_rgb = (
            aovs[k].reshape(-1, aovs[k].shape[-1])[px]
            for k in ("normal", "texcoord", "position", "rgb"))
        got_d = aovs["depth"].reshape(-1)[px]
    bad = ((po - o).abs().amax(1) > 1e-6 * (1.0 + o.abs().amax(1))) | (
        (pd - d).abs().amax(1) > 1e-6)
    bad |= records_off(ref, po, pd, tmin, tmax, t, prim, got_n, got_uv,
                       position=got_p, depth=got_d, rgb=got_rgb)
    return [("las_off_pct", 100.0 * float(bad.sum()) / n,
             float(tr["limits"]["las_off_pct"]))]


def sphere_k1_work(n_rays: int, n_spheres: int) -> tuple[int, int]:
    """(bytes, operations) of one K1 launch over ``n_rays`` rays and
    ``n_spheres`` spheres, a floor from the inputs alone: each ray read
    (origin, direction, min_t, max_t: 32 B) and its record written (t, u,
    v, prim id: 16 B), each sphere read once (centre and radius, 16 B);
    one root box test a ray (``roofline.SLAB_OPS``, as ``roofline.
    k1_work`` counts K1's). The tree and the spheres a ray tests are not
    counted: no input fixes them."""
    return (n_rays * (roofline.RAY_BYTES + roofline.RECORD_BYTES)
            + n_spheres * SPHERE_BYTES, n_rays * roofline.SLAB_OPS)


def work(run):
    st = run.state
    return {"k1": [sphere_k1_work(st.W * st.H, len(st.pts))]}
