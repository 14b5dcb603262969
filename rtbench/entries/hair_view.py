"""Entry ``hair_view``: a hair renderer's primary-visibility frame of a head
of hair drawn as cubic Bezier curves, inside the frame:
``models.cameras.look_at`` and ``pinhole_rays`` make the camera's rays,
``models.hair.render_curve_aovs`` traces them through K1's curve leaf
test (one launch over the frame's rays in raster order) and derives the
AOVs; records and AOVs stay on the card, and the frame ends with a
synchronise.

Set-up hands the configuration's control points and radii to the program
as ``ops.curve.Curves``, builds the binary tree (``build_curve_bvh``,
leaves of ``LEAF`` curves) and its curve tables (``collapse_bvh8(...,
width=WIDTH, curves=)``) and moves them to the card, all timed into
``run.spans["build"]``. Why these (an NVIDIA H100 80GB HBM3 at 700 W,
K1's ms a 3840 x 2160 frame at three orbit positions, PERF.md §6): at
width 8, leaves of 1 curve took 51-73 ms, of 2 65-90, of 4 88-119 and of
6 107-142; at width 16 62-72, 77-89, 96-112 and 111-129. A curve test
costs about as much as 20 box tests, so the tree gives each curve its
own box; leaves of 1 collapse in 13.6 s against 5.8 at 4. The camera
orbits the head's centre (the traffic's ``center``) by ``step`` radians
a frame; the seed picks the position it starts from, so every seed
visits the same positions. Traffic parameters: ``camera`` (radius,
elevation, step, fov, width, height, center), ``check_pixels`` of the
last frame, ``limits``.

The program's names are imported here, at the top: a program without
``models.hair`` fails as the entry loads, before any scene work.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.core.options import BVHBuildOptions
from nanort_tpu_torch.models import cameras
from nanort_tpu_torch.models.hair import render_curve_aovs
from nanort_tpu_torch.ops.curve import Curves, build_curve_bvh
from rtbench import camera, roofline
from rtbench.entries.las_view import eye_of
from rtbench.harness import sync
from rtbench.ref.curves import RefCurves, records_off

WIDTH = 8  # the tables' fan-out
LEAF = 1  # curves a leaf of the binary tree
# bytes of one curve as K1's inputs hold it (4 control points and 2 radii
# in four float4s)
CURVE_BYTES = 64
# float32 operations of K1's curve leaf, counted from csrc/
# packet_traverse.cu: the ray's z-align frame once a ray (curve_ray: dxz
# 4, the compare 1, the frame's quotients and products 7, the translation
# 3 x 6), and one curve test (hit_curve: 4 control points projected, 4 x
# 3 x 6; the largest z 3; the near reject 4; the half-widths 3; 5 de
# Casteljau points, 5 x (1 + 3 x 6 x 3); 4 spans of 33 each; the min_t
# test 1)
CURVE_RAY_OPS = 30
CURVE_TEST_OPS = 490


def setup(run):
    tr, sc, dev = run.cell.traffic, run.scene, run.device
    radii = np.ascontiguousarray(sc.materials["radii"], np.float32)
    pts = np.ascontiguousarray(sc.vertices, np.float32).reshape(-1, 4, 3)
    t0 = time.perf_counter()
    host = Curves(torch.from_numpy(pts), torch.from_numpy(radii))
    bvh, _ = build_curve_bvh(host, BVHBuildOptions(
        min_leaf_primitives=LEAF, max_leaf_primitives=LEAF))
    s8 = collapse_bvh8(bvh, width=WIDTH, curves=host).to(dev)
    curves = Curves(host.points.to(dev), host.radii.to(dev))
    sync(dev)
    run.spans["build"] = time.perf_counter() - t0
    cam = tr["camera"]
    rng = np.random.default_rng([run.seed & (2**63 - 1), 5])
    st = SimpleNamespace(
        s8=s8, curves=curves, pts=pts, radii=radii, cam=cam,
        center=[float(x) for x in cam["center"]],
        a0=float(cam["step"] * rng.integers(round(2 * math.pi
                                                  / cam["step"]))),
        W=int(cam["width"]), H=int(cam["height"]), look_at=cameras.look_at,
        pinhole=cameras.pinhole_rays, render=render_curve_aovs, last=None)
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
    aovs, hits = st.render(st.curves, rays, scene8=st.s8)
    sync(run.device)
    st.last = (eye, rays, hits, aovs)


def unit(run, i):
    frame(run, run.state, i)


def finish(run):
    st = run.state
    st.s8 = st.curves = st.render = None


def check(run, control=False):
    """The share of sampled pixels of the last frame whose camera ray,
    record (hit or miss, t, curve, u, v) or AOVs (tangent, position,
    depth, colour) the reference does not give, in %: the ray off by more
    than 1e-6 in a direction component or in the origin (relative) from
    the benchmark's float64 camera; the record and the AOVs as
    ``ref.curves.records_off`` judges them against the float64 reference
    on the same rays. ``control``: the reference in bfloat16 (its camera,
    its curves, its AOVs) takes the program's place."""
    st, tr, dev = run.state, run.cell.traffic, run.device
    eye, rays, hits, aovs = st.last
    cam = st.cam
    rng = np.random.default_rng([run.seed & (2**63 - 1), 6])
    px = torch.as_tensor(rng.choice(st.H * st.W, int(tr["check_pixels"]),
                                    replace=False), device=dev)
    o, d = camera.rays(eye, st.center, st.W, st.H, cam["fov"], dev,
                       torch.float64, pixels=px)
    ref = RefCurves(st.pts, st.radii, dev, torch.float64)
    n = px.numel()
    tmin = torch.zeros(n, dtype=torch.float64, device=dev)
    tmax = torch.full((n,), 3.0e38, dtype=torch.float64, device=dev)
    if control:
        po, pd = camera.rays(eye, st.center, st.W, st.H, cam["fov"], dev,
                             torch.bfloat16, pixels=px)
        low = RefCurves(st.pts, st.radii, dev, torch.bfloat16)
        t, u, v, prim = low.closest(po, pd, tmin, tmax)
        hit = prim >= 0
        tan = low.tangent(prim, u)
        got_t = torch.where(hit[:, None], tan, 0.0)
        got_p = torch.where(hit[:, None], po + t[:, None] * pd, 0.0)
        got_d = torch.where(hit, t, 0.0)
        got_rgb = torch.where(hit[:, None], 0.5 * tan + 0.5, 0.0)
        po, pd = po.double(), pd.double()
    else:
        po = rays.org.reshape(-1, 3)[px].double()
        pd = rays.dir.reshape(-1, 3)[px].double()
        prim = hits.prim_id.reshape(-1)[px]
        prim = torch.where(prim == 0xFFFFFFFF, -1, prim)
        t, u, v = (x.reshape(-1)[px] for x in (hits.t, hits.u, hits.v))
        got_t, got_p, got_rgb = (
            aovs[k].reshape(-1, 3)[px] for k in ("tangent", "position",
                                                 "rgb"))
        got_d = aovs["depth"].reshape(-1)[px]
    bad = ((po - o).abs().amax(1) > 1e-6 * (1.0 + o.abs().amax(1))) | (
        (pd - d).abs().amax(1) > 1e-6)
    bad |= records_off(ref, po, pd, tmin, tmax, t, u, v, prim, got_t,
                       position=got_p, depth=got_d, rgb=got_rgb)
    return [("hair_off_pct", 100.0 * float(bad.sum()) / n,
             float(tr["limits"]["hair_off_pct"]))]


def curve_k1_work(n_rays: int, n_curves: int) -> tuple[int, int]:
    """(bytes, operations) of one K1 launch over ``n_rays`` rays and
    ``n_curves`` curves, a floor from the inputs alone: each ray read
    (origin, direction, min_t, max_t: 32 B) and its record written (t, u,
    v, prim id: 16 B), each curve read once (``CURVE_BYTES``); one root
    box test (``roofline.SLAB_OPS``, as ``roofline.k1_work`` counts K1's),
    the ray's z-align frame (``CURVE_RAY_OPS``) and one curve test
    (``CURVE_TEST_OPS``) a ray. The tree and the curves a ray tests
    beyond one are not counted: no input fixes them."""
    return (n_rays * (roofline.RAY_BYTES + roofline.RECORD_BYTES)
            + n_curves * CURVE_BYTES,
            n_rays * (roofline.SLAB_OPS + CURVE_RAY_OPS + CURVE_TEST_OPS))


def work(run):
    st = run.state
    return {"k1": [curve_k1_work(st.W * st.H, len(st.pts))]}
