"""Cubic Bezier curve primitive kind, hair and fur ribbons (port of
``nanort_tpu.ops.curve``; plain torch on the stack engine
``traverse/stack.py``, or K1 with its curve leaf test over the wide tables
of ``build.bvh8.collapse_bvh8(..., curves=)``).

Re-derivation of examples/curves_primitive/main.cc:382-800 (CurvePred /
CurveGeometry / CurveIntersector), the Nakamaru-Ohno / Woop-style method:

* ``GetZAlign`` (main.cc:382-417): the rotation+translation taking the
  ray to the +z axis through the origin (with the reference's
  degenerate-dxz branch for near-vertical rays),
* project the 4 control points into ray space, reject when the curve is
  too close (t_z < 4 * max_radius / 2, main.cc:676-680),
* evaluate the Bezier by de Casteljau at S+1 parameters, treat each of
  the S spans as a 2D line segment with lerped half-radius width, find
  the closest point to the z axis, accept when dist^2 <= radius^2 and
  t = P.z improves (main.cc:686-760),
* u = global curve parameter of the closest point, v = sqrt(d2).

The JAX package projects with ``einsum``; here each projected coordinate
is summed over its three products in order, as separate roundings, and
the span parameter is clamped to [0, 1] with comparisons (a NaN stays
NaN), so that ``curve_hit`` is K1's curve test (``csrc/packet_traverse.cu
::hit_curve``) operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import sqrt
from ..core.ray import Hits, Rays
from ..utils import trace
from .protocol import _build_bvh
from .triangle import _to_numpy

# the spans of K1's curve test (``kSpans`` in csrc/packet_traverse.cu)
K1_SUBDIVISIONS = 4


class Curves(NamedTuple):
    """SoA cubic Bezier set: control points (N, 4, 3), radii (N, 4)."""

    points: torch.Tensor
    radii: torch.Tensor

    @property
    def num_prims(self) -> int:
        return self.points.shape[0]


class CurveRayCtx(NamedTuple):
    rot: torch.Tensor  # (..., 3, 3) z-align rotation
    trans: torch.Tensor  # (..., 3)
    min_t: torch.Tensor


def curve_prim_bounds(c: Curves):
    """Control-hull box inflated per-point radius (CurveGeometry::
    BoundingBox, main.cc:513-556); centroid = control-point mean
    (CurvePred, main.cc:491-504). Host NumPy."""
    p = _to_numpy(c.points)
    r = _to_numpy(c.radii)[..., None]
    return (p - r).min(1), (p + r).max(1), p.mean(1)


def _project(x, rot):
    """x (..., K, 3) @ rot (..., 3, 3): each output coordinate summed
    over i = 0, 1, 2 in order."""
    return (x[..., 0:1] * rot[..., None, 0, :] + x[..., 1:2]
            * rot[..., None, 1, :] + x[..., 2:3] * rot[..., None, 2, :])


def _z_align(org, d):
    """GetZAlign vectorized (main.cc:382-417). org/d: (..., 3)."""
    lx, ly, lz = d[..., 0], d[..., 1], d[..., 2]
    dxz = sqrt(lx * lx + lz * lz)
    ok = dxz > 0
    sd = torch.where(ok, dxz, torch.ones_like(dxz))
    zeros = torch.zeros_like(lx)
    ones = torch.ones_like(lx)
    m_ok = torch.stack([
        torch.stack([lz / sd, -lx / sd * ly, lx], -1),
        torch.stack([zeros, dxz, ly], -1),
        torch.stack([-lx / sd, -ly / sd * lz, lz], -1),
    ], -2)
    sgn = torch.where(ly > 0, ones, -ones)
    m_deg = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, zeros, -sgn], -1),
        torch.stack([zeros, sgn, zeros], -1),
    ], -2)
    rot = torch.where(ok[..., None, None], m_ok, m_deg)
    trans = -_project(org[..., None, :], rot)[..., 0, :]
    return rot, trans


def curve_prepare(c: Curves, rays) -> CurveRayCtx:
    del c
    rot, trans = _z_align(rays.org, rays.dir)
    return CurveRayCtx(rot=rot, trans=trans, min_t=rays.min_t)


def _bezier(cp, t: float):
    """de Casteljau at parameter t. cp: (..., 4, 3); t a Python float."""
    u = 1.0 - t
    a = u * cp[..., 0, :] + t * cp[..., 1, :]
    b = u * cp[..., 1, :] + t * cp[..., 2, :]
    cc = u * cp[..., 2, :] + t * cp[..., 3, :]
    d = u * a + t * b
    e = u * b + t * cc
    return u * d + t * e


def curve_hit(cps, r0, r1, min_t, t_cur, num_subdivisions: int = 4):
    """``(valid, t, u, v)`` of curves whose control points ``cps`` (..., 4,
    3) lie in the ray's z-align space (``_project`` by ``_z_align``'s
    frame), with radii ``r0`` at p0 and ``r1`` at p3, against ``min_t``
    and ``t_cur`` (all broadcasting over ``cps``' leading axes):
    main.cc:676-760's test, and K1's (``csrc/packet_traverse.cu::
    hit_curve``) operation for operation.

    A curve whose largest projected z lies below 4 max(r0, r1) / 2 is
    rejected. Of the ``num_subdivisions`` spans between de Casteljau
    points at s / S, each is a 2D segment with a width lerped from r0 / 2
    to r1 / 2; its closest point to the z axis is taken, clamped to the
    span, and accepted when d2 <= width^2 and its t (z) lies below the
    best so far (first ``t_cur``). u = (u_s + s) / S of the best span, v
    = sqrt(d2). A curve whose best span lies before ``min_t`` is a miss,
    though a later span of it may lie after."""
    n = int(num_subdivisions)
    t_z = cps[..., 2].amax(-1)
    uw = torch.maximum(r0, r1) / 2.0
    near_reject = t_z < 4.0 * uw  # main.cc:676-680

    best_t = t_cur.expand_as(t_z)
    best_u = torch.zeros_like(t_z)
    best_v = torch.zeros_like(t_z)
    got = torch.zeros_like(t_z, dtype=torch.bool)
    inv_n = 1.0 / n
    w0 = 0.5 * r0
    w1 = 0.5 * r1
    bw = w1 - w0
    p0 = _bezier(cps, 0.0)
    for s in range(n):
        p1 = _bezier(cps, (s + 1) * inv_n)
        bx = p1[..., 0] - p0[..., 0]
        by = p1[..., 1] - p0[..., 1]
        bz = p1[..., 2] - p0[..., 2]
        d0 = -p0[..., 0] * bx + -p0[..., 1] * by
        d1 = bx * bx + by * by
        u = d0 / torch.where(d1 != 0, d1, torch.ones_like(d1))
        u = torch.where(u < 0.0, 0.0, torch.where(u > 1.0, 1.0, u))
        px = p0[..., 0] + u * bx
        py = p0[..., 1] + u * by
        t = p0[..., 2] + u * bz
        r = w0 + u * bw
        d2 = px * px + py * py
        ok = (d2 <= r * r) & (t < best_t) & ~near_reject
        best_t = torch.where(ok, t, best_t)
        best_u = torch.where(ok, (u + s) * inv_n, best_u)
        best_v = torch.where(ok, sqrt(d2), best_v)
        got = got | ok
        p0 = p1
    valid = got & (best_t >= min_t)
    return valid, best_t, best_u, best_v


def make_curve_intersect(num_subdivisions: int = 4):
    """Leaf intersect fn for the traversal protocol, ``S`` spans a
    curve (``curve_hit``)."""
    n = int(num_subdivisions)

    def intersect(c: Curves, ctx: CurveRayCtx, prim_ids, t_cur):
        ids = prim_ids.long()
        ocps = c.points[ids]  # (..., L, 4, 3)
        radii = c.radii[ids]  # (..., L, 4)
        rot = ctx.rot[..., None, :, :]
        trans = ctx.trans[..., None, :]
        cps = _project(ocps, rot) + trans[..., None, :]
        return curve_hit(cps, radii[..., 0], radii[..., 3],
                         ctx.min_t[..., None], t_cur[..., None], n)

    return intersect


def curve_tangent(c: Curves, hits: Hits) -> torch.Tensor:
    """The unit world-space tangent B'(u) / |B'(u)| of each record's curve
    at its curve parameter u (the input of Kajiya-Kay hair shading); a
    miss reads curve 0 at its u, whose value means nothing. B'(u) = 3 ((1
    - u)^2 (p1 - p0) + 2 (1 - u) u (p2 - p1) + u^2 (p3 - p2))."""
    ids = torch.where(hits.hit, hits.prim_id, 0)
    p = c.points[ids]  # (..., 4, 3)
    u = hits.u[..., None].to(p.dtype)
    s = 1.0 - u
    d = 3.0 * (s * s * (p[..., 1, :] - p[..., 0, :])
               + 2.0 * s * u * (p[..., 2, :] - p[..., 1, :])
               + u * u * (p[..., 3, :] - p[..., 2, :]))
    n = sqrt((d * d).sum(-1))
    return d / torch.clamp(n, min=1e-30)[..., None]


@trace.span("build.sah")
def build_curve_bvh(c: Curves, options=None):
    """Binned-SAH binary BVH over the curves' boxes (host). Like
    ``build_triangle_bvh``, it takes the native C++ builder when it is
    available (float32 boxes), where the JAX package's ``build_curve_bvh``
    takes the NumPy builder (~0.03 Mprims/s). The trees differ; the
    records do not, except which prim wins an exactly-equal-t tie.
    ``build.bvh8.collapse_bvh8(bvh, width=..., curves=c)`` collapses the
    tree (leaves of at most 6) into K1's curve tables."""
    return _build_bvh(*curve_prim_bounds(c), options)


def traverse_curves(bvh, c: Curves, rays: Rays, options=None,
                    num_subdivisions: int = 4, max_leaf: int = 4,
                    max_stack: int | None = None, skip_prim_id=None,
                    scene8=None) -> Hits:
    """BVHAccel<float>::Traverse with the curve intersector, on the rays'
    device (the curve tensors must be there too).

    With ``scene8`` (``collapse_bvh8(..., curves=c)`` on the rays'
    device) the rays go through K1's curve leaf test, whose arithmetic is
    ``curve_hit``'s with 4 spans: an image-shaped batch in raster order
    (``packet.traverse_image``, which takes no ``skip_prim_id``), any
    other shape as it comes (``traverse_bvh8``). Without it the stack
    engine walks ``bvh``. The two engines give the same t bit for bit and
    the same curves but between hits at exactly equal t; K1 takes only
    ``num_subdivisions`` 4 (another count stays on the stack engine)."""
    from ..core.options import BVHTraceOptions

    options = options or BVHTraceOptions()
    if scene8 is not None:
        from ..traverse.packet import traverse_bvh8, traverse_image

        if scene8.leaf_kind != "curve":
            raise ValueError("scene8 holds no curves: collapse the curve "
                             "tree with collapse_bvh8(..., curves=)")
        if num_subdivisions != K1_SUBDIVISIONS:
            raise ValueError(f"K1's curve test has {K1_SUBDIVISIONS} spans;"
                             f" {num_subdivisions} run on the stack engine "
                             "(scene8=None)")
        if skip_prim_id is None and len(rays.batch_shape) == 2:
            return traverse_image(scene8, rays, options)
        return traverse_bvh8(scene8, rays, options,
                             skip_prim_id=skip_prim_id)
    from ..traverse.stack import traverse

    return traverse(bvh, c, rays, options, prepare_fn=curve_prepare,
                    intersect_fn=make_curve_intersect(num_subdivisions),
                    max_leaf=max_leaf, skip_prim_id=skip_prim_id,
                    max_stack=max_stack)
