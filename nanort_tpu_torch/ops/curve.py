"""Cubic Bezier curve primitive kind, hair and fur ribbons (port of
``nanort_tpu.ops.curve``; plain torch on the stack engine).

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
is summed over its three products in order, as separate roundings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import sqrt
from ..core.ray import Hits, Rays
from .protocol import _build_bvh
from .triangle import _to_numpy


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


def make_curve_intersect(num_subdivisions: int = 4):
    """Leaf intersect fn for the traversal protocol, ``S`` spans a
    curve."""
    n = int(num_subdivisions)

    def intersect(c: Curves, ctx: CurveRayCtx, prim_ids, t_cur):
        ids = prim_ids.long()
        ocps = c.points[ids]  # (..., L, 4, 3)
        radii = c.radii[ids]  # (..., L, 4)
        rot = ctx.rot[..., None, :, :]
        trans = ctx.trans[..., None, :]
        cps = _project(ocps, rot) + trans[..., None, :]

        t_z = cps[..., 2].amax(-1)
        r0 = radii[..., 0]
        r1 = radii[..., 3]
        uw = torch.maximum(r0, r1) / 2.0
        near_reject = t_z < 4.0 * uw  # main.cc:676-680

        best_t = t_cur[..., None].expand(t_z.shape)
        best_u = torch.zeros_like(t_z)
        best_v = torch.zeros_like(t_z)
        got = torch.zeros_like(t_z, dtype=torch.bool)
        inv_n = 1.0 / n
        for s in range(n):
            p0 = _bezier(cps, s * inv_n)
            p1 = _bezier(cps, (s + 1) * inv_n)
            w0 = 0.5 * r0
            w1 = 0.5 * r1
            bx = p1[..., 0] - p0[..., 0]
            by = p1[..., 1] - p0[..., 1]
            bz = p1[..., 2] - p0[..., 2]
            bw = w1 - w0
            d0 = -p0[..., 0] * bx + -p0[..., 1] * by
            d1 = bx * bx + by * by
            u = (d0 / torch.where(d1 != 0, d1, torch.ones_like(d1))).clamp(
                0.0, 1.0)
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
        valid = got & (best_t >= ctx.min_t[..., None])
        return valid, best_t, best_u, best_v

    return intersect


def build_curve_bvh(c: Curves, options=None):
    """Binned-SAH binary BVH over the curves' boxes (host). Like
    ``build_triangle_bvh``, it takes the native C++ builder when it is
    available (float32 boxes), where the JAX package's ``build_curve_bvh``
    takes the NumPy builder (~0.03 Mprims/s). The trees differ; the
    records do not, except which prim wins an exactly-equal-t tie."""
    return _build_bvh(*curve_prim_bounds(c), options)


def traverse_curves(bvh, c: Curves, rays: Rays, options=None,
                    num_subdivisions: int = 4, max_leaf: int = 4,
                    max_stack: int | None = None, skip_prim_id=None) -> Hits:
    """BVHAccel<float>::Traverse with the curve intersector."""
    from ..core.options import BVHTraceOptions
    from ..traverse.stack import traverse

    options = options or BVHTraceOptions()
    return traverse(bvh, c, rays, options, prepare_fn=curve_prepare,
                    intersect_fn=make_curve_intersect(num_subdivisions),
                    max_leaf=max_leaf, skip_prim_id=skip_prim_id,
                    max_stack=max_stack)
