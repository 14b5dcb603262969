"""Entry ``primary_aovs``: objrender's path at a large frame, inside the
frame: ``models.cameras.look_at`` and ``pinhole_rays`` make the camera's
rays, ``models.objrender.render_aovs`` traces them through the BVH16
tables (K1) and derives the AOVs; records and AOVs stay on the card, and
the frame ends with a synchronise.

Set-up bakes the configuration's copies into one world-space mesh (the
benchmark's float32 arrays, handed to the program as they are), builds
the tree with the builder's defaults and its BVH16 tables, as objrender
does. The camera moves along an orbit about ``center`` by ``step``
radians a frame (2 pi / step positions a turn); the seed picks the
position it starts from, so every seed visits the same positions.
Traffic parameters: ``camera`` (radius, elevation, step, center, fov,
width, height), ``check_pixels`` of the last frame, ``limits``.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from rtbench import camera, roofline
from rtbench.harness import sync
from rtbench.ref.checks import face_normals, records_off
from rtbench.ref.tracer import RefMesh


def eye_of(cam: dict, a0: float, i: int):
    a = a0 + cam["step"] * i
    e, r = cam["elevation"], cam["radius"]
    c = np.asarray(cam["center"], np.float64)
    return c + r * np.array([math.cos(e) * math.sin(a), math.sin(e),
                             math.cos(e) * math.cos(a)])


def setup(run):
    from nanort_tpu_torch import TriangleMesh, build_triangle_bvh
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.models import cameras
    from nanort_tpu_torch.models.objrender import render_aovs

    tr, sc, dev = run.cell.traffic, run.scene, run.device
    v, f = sc.world(np.float32)
    f = f.astype(np.int32)
    t0 = time.perf_counter()
    mesh = TriangleMesh(v, f)
    bvh, _ = build_triangle_bvh(mesh)
    s8 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    mesh_d = TriangleMesh(torch.from_numpy(v).to(dev),
                          torch.from_numpy(f).to(dev))
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0
    cam = tr["camera"]
    rng = np.random.default_rng([run.seed & (2**63 - 1), 5])
    st = SimpleNamespace(bvh=bvh, s8=s8, mesh=mesh_d, v=v, f=f, cam=cam,
                         a0=float(cam["step"] * rng.integers(
                             round(2 * math.pi / cam["step"]))),
                         W=int(cam["width"]), H=int(cam["height"]),
                         look_at=cameras.look_at,
                         pinhole=cameras.pinhole_rays, render=render_aovs,
                         last=None)
    st.per_unit = {"rays": st.W * st.H}
    for k in (-2, -1):
        frame(run, st, k)
    st.last = None
    sync(dev)
    return st


def frame(run, st, i):
    st.last = None
    eye = eye_of(st.cam, st.a0, i)
    c = st.look_at(eye, st.cam["center"], width=st.W, height=st.H,
                   fov=float(st.cam["fov"]), device=run.device)
    rays = st.pinhole(c)
    aovs, hits = st.render(st.bvh, st.mesh, rays, scene8=st.s8)
    sync(run.device)
    st.last = (eye, rays, hits, aovs["normal"])


def unit(run, i):
    frame(run, run.state, i)


def finish(run):
    st = run.state
    st.bvh = st.s8 = st.mesh = st.render = None


def check(run, control=False):
    """The share of sampled pixels of the last frame whose camera ray,
    record (t, u, v, prim id) or normal AOV the reference does not give:
    the ray off by more than 1e-6 in a direction component or in the
    origin, the record as ``ref.checks.records_off`` judges it, the
    normal by more than 1e-5 in a component from the unit normal of the
    triangle the record names. ``control``: the reference in bfloat16
    takes the program's place."""
    st, tr, dev = run.state, run.cell.traffic, run.device
    eye, rays, hits, normal = st.last
    cam = st.cam
    rng = np.random.default_rng([run.seed & (2**63 - 1), 6])
    px = torch.as_tensor(rng.choice(st.H * st.W, int(tr["check_pixels"]),
                                    replace=False), device=dev)
    o, d = camera.rays(eye, cam["center"], st.W, st.H, cam["fov"], dev,
                       torch.float64, pixels=px)
    mesh = RefMesh(st.v, st.f, dev, torch.float64)
    n = px.numel()
    if control:
        po, pd = camera.rays(eye, cam["center"], st.W, st.H, cam["fov"], dev,
                             torch.bfloat16, pixels=px)
        low = RefMesh(st.v, st.f, dev, torch.bfloat16)
        t, u, v, prim = low.closest(po, pd, torch.zeros(n, device=dev),
                                    torch.full((n,), 3.0e38, device=dev))
        got = face_normals(st.v, st.f, prim, dev, torch.bfloat16)
        po, pd = po.double(), pd.double()
    else:
        po = rays.org.reshape(-1, 3)[px].double()
        pd = rays.dir.reshape(-1, 3)[px].double()
        prim = hits.prim_id.reshape(-1)[px]
        prim = torch.where(prim == 0xFFFFFFFF, -1, prim)
        t, u, v = (x.reshape(-1)[px] for x in (hits.t, hits.u, hits.v))
        got = normal.reshape(-1, 3)[px]
    bad = ((po - o).abs().amax(1) > 1e-6 * (1.0 + o.abs().amax(1))) | (
        (pd - d).abs().amax(1) > 1e-6)
    bad |= records_off(mesh, o, d, torch.zeros(n, device=dev),
                       torch.full((n,), 3.0e38, device=dev), t, prim, u, v)
    want = face_normals(st.v, st.f, prim, dev, torch.float64)
    bad |= (got.double() - want).abs().amax(1) > 1e-5
    return [("primary_off_pct", 100.0 * float(bad.sum()) / n,
             float(tr["limits"]["primary_off_pct"]))]


def work(run):
    st = run.state
    return {"k1": [roofline.k1_work(st.W * st.H, len(st.v), len(st.f))]}
