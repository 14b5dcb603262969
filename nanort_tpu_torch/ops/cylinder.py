"""Cylinder primitive kind, capped, with a radius at each end (port of
``nanort_tpu.ops.cylinder``; plain torch on the stack engine).

Re-derivation of examples/cylinder_primitive/main.cc:94-345
(CylinderPred / CylinderGeometry / CylinderIntersector + solve2e): each
primitive is a segment (p0, p1) with radii (r0, r1); the intersector
tests the two cap planes first, then the infinite-cylinder quadratic
(Ericson's A = dd*nn - nd^2 form) clipped to 0 <= s <= 1, using
rr = max(r0, r1) like the reference. u/v: caps report (sqrt(dist^2),
0 or 1), the body reports (0, s). Dot products are summed x, y, z in
order and float32 square roots are correctly rounded, as in
``ops/sphere.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import dot, sqrt
from ..core.ray import Hits, Rays
from .protocol import _build_bvh
from .triangle import _to_numpy


class Cylinders(NamedTuple):
    """SoA segments: p0/p1 (N, 3), r0/r1 (N,) tensors."""

    p0: torch.Tensor
    p1: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor

    @property
    def num_prims(self) -> int:
        return self.p0.shape[0]


class CylRayCtx(NamedTuple):
    org: torch.Tensor
    dir: torch.Tensor
    min_t: torch.Tensor


def cylinder_prim_bounds(c: Cylinders):
    """Segment box inflated by the endpoint radii (CylinderGeometry::
    BoundingBox, cylinder_primitive/main.cc:135-175); host NumPy."""
    import numpy as np

    p0 = _to_numpy(c.p0)
    p1 = _to_numpy(c.p1)
    r0 = _to_numpy(c.r0)[:, None]
    r1 = _to_numpy(c.r1)[:, None]
    bmin = np.minimum(p0 - r0, p1 - r1)
    bmax = np.maximum(p0 + r0, p1 + r1)
    return bmin, bmax, 0.5 * (p0 + p1)


def cylinder_prepare(c: Cylinders, rays) -> CylRayCtx:
    del c
    return CylRayCtx(org=rays.org, dir=rays.dir, min_t=rays.min_t)


def _solve2e(A, B, C):
    """Smallest real root of A t^2 + 2 B t + C = 0 in the reference's
    formulation (solve2e, cylinder_primitive/main.cc:61-92). Returns
    (has_root, t_small)."""
    one = torch.ones_like(A)
    lin = A.abs() <= 1.0e-6
    safe_B = torch.where(B != 0, B, one)
    x_lin = -C / safe_B
    D = B * B - A * C
    safe_A = torch.where(lin, one, A)
    sqrtD = sqrt(torch.clamp(D, min=0.0))
    x1 = (B.abs() + sqrtD) / safe_A
    x1 = torch.where(B >= 0.0, -x1, x1)
    safe_x1 = torch.where(x1 != 0, x1, one)
    x2 = C / (safe_A * safe_x1)
    lo = torch.minimum(x1, x2)
    x_dbl = -B / safe_A
    root = torch.where(lin, x_lin, torch.where(D == 0.0, x_dbl, lo))
    has = torch.where(lin, B != 0, D >= 0.0)
    return has, root


def cylinder_intersect(c: Cylinders, ctx: CylRayCtx, prim_ids, t_cur,
                       test_cap: bool = True):
    """(valid, t, u, v) for (..., L) prim ids."""
    ids = prim_ids.long()
    p0 = c.p0[ids]
    p1 = c.p1[ids]
    rr = torch.maximum(c.r0[ids], c.r1[ids])

    org = ctx.org[..., None, :]
    n = ctx.dir[..., None, :]
    tmax = t_cur[..., None]
    d = p1 - p0
    m = org - p0
    md = dot(m, d)
    nd = dot(n, d)
    dd = dot(d, d)

    kEPS = 1.0e-6
    big = torch.finfo(org.dtype).max

    # --- caps (cylinder_primitive/main.cc:269-309) ---
    cap_t = torch.full_like(md, big)
    cap_u = torch.zeros_like(cap_t)
    cap_v = torch.zeros_like(cap_t)
    hit_cap = torch.zeros_like(md, dtype=torch.bool)
    if test_cap:
        one = torch.ones_like(md)
        dlen = sqrt(torch.clamp(dd, min=1e-30))
        dn0 = (p0 - p1) / dlen[..., None]
        rd = n / torch.clamp(sqrt(dot(n, n)), min=1e-30)[..., None]
        denom0 = dot(rd, dn0)
        plane_ok = dot(n, dn0).abs() > kEPS
        p0D = -dot(p0, dn0)
        p1D = -dot(p1, -dn0)
        safe0 = torch.where(denom0 != 0, denom0, one)
        p0T = -(dot(org, dn0) + p0D) / safe0
        p1T = -(dot(org, -dn0) + p1D) / torch.where(-denom0 != 0, -denom0,
                                                    one)
        q0 = org + p0T[..., None] * rd
        q1 = org + p1T[..., None] * rd
        e0 = q0 - p0
        e1 = q1 - p1
        qp0 = dot(e0, e0)
        qp1 = dot(e1, e1)
        hit0 = plane_ok & (p0T > 0.0) & (p0T < tmax) & (qp0 < rr * rr)
        cap_t = torch.where(hit0, p0T, cap_t)
        cap_u = torch.where(hit0, sqrt(qp0), cap_u)
        cap_v = torch.where(hit0, 0.0, cap_v)
        hit1 = (plane_ok & (p1T > 0.0) & (p1T < tmax) & (p1T < cap_t)
                & (qp1 < rr * rr))
        cap_t = torch.where(hit1, p1T, cap_t)
        cap_u = torch.where(hit1, sqrt(qp1), cap_u)
        cap_v = torch.where(hit1, 1.0, cap_v)
        hit_cap = hit0 | hit1

    # --- body (cylinder_primitive/main.cc:311-338) ---
    outside = ((md <= 0.0) & (nd <= 0.0)) | ((md >= dd) & (nd >= 0.0))
    nn = dot(n, n)
    mn = dot(m, n)
    A = dd * nn - nd * nd
    k = dot(m, m) - rr * rr
    C = dd * k - md * md
    B = dd * mn - nd * md
    has_root, t_body = _solve2e(A, B, C)
    s = (md + t_body * nd) / torch.where(dd != 0, dd, torch.ones_like(dd))
    body_ok = (~outside & has_root & (t_body >= 0) & (t_body <= tmax)
               & (t_body <= cap_t) & (s >= 0) & (s <= 1))

    t = torch.where(body_ok, t_body, cap_t)
    u = torch.where(body_ok, 0.0, cap_u)
    v = torch.where(body_ok, s, cap_v)
    # the JAX package's `body_ok | (hit_cap & ~outside) | (hit_cap &
    # outside)`, which is body_ok | hit_cap
    valid = (body_ok | hit_cap) & (t <= tmax) & (t >= ctx.min_t[..., None])
    return valid, t, u, v


def build_cylinder_bvh(c: Cylinders, options=None):
    """Binned-SAH binary BVH over the cylinders' boxes (host). Like
    ``build_triangle_bvh``, it takes the native C++ builder when it is
    available (float32 boxes), where the JAX package's ``build_cylinder_bvh``
    takes the NumPy builder (~0.03 Mprims/s). The trees differ; the
    records do not, except which prim wins an exactly-equal-t tie."""
    return _build_bvh(*cylinder_prim_bounds(c), options)


def traverse_cylinders(bvh, c: Cylinders, rays: Rays, options=None,
                       max_leaf: int = 4, max_stack: int | None = None,
                       skip_prim_id=None) -> Hits:
    """BVHAccel<float>::Traverse with the cylinder intersector."""
    from ..core.options import BVHTraceOptions
    from ..traverse.stack import traverse

    options = options or BVHTraceOptions()
    return traverse(bvh, c, rays, options, prepare_fn=cylinder_prepare,
                    intersect_fn=cylinder_intersect, max_leaf=max_leaf,
                    skip_prim_id=skip_prim_id, max_stack=max_stack)
