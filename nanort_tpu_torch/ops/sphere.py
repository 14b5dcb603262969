"""Sphere / particle primitive kind (port of ``nanort_tpu.ops.sphere``;
plain torch on the stack engine ``traverse/stack.py``).

Re-derivation of examples/particle_primitive/main.cc:82-291 (SpherePred /
SphereGeometry / SphereIntersection / SphereIntersector), the primitive
of the LAS LiDAR viewer (examples/las/render.cc:84-270).

Numerics follow the reference: the numerically stable q-form of the
quadratic (q = (-b -/+ sqrt(disc))/2 by sign of b), the |disc| < eps
double-root branch, nearest root in the ray's window, strict
``t > t_inout`` rejection (equal-t replaces). UV is assigned only to the
final hit (reference PostTraversal): u = (atan2(n.x, n.z) + pi)/(2 pi),
v = acos(n.y)/pi. Every dot product is summed x, y, z in order as its own
products and sums (no fused ops), and float32 square roots are correctly
rounded (``core.math.sqrt``); ``atan2`` and ``acos`` differ from XLA's in
the last ulp, so u and v are held to the JAX package by absolute error.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.math import dot, sqrt
from ..core.ray import Hits, Rays
from .protocol import _build_bvh
from .triangle import _to_numpy


class Spheres(NamedTuple):
    """SoA particle set: centers (N, 3), radii (N,) tensors."""

    centers: torch.Tensor
    radii: torch.Tensor

    @property
    def num_prims(self) -> int:
        return self.centers.shape[0]


class SphereRayCtx(NamedTuple):
    org: torch.Tensor
    dir: torch.Tensor
    min_t: torch.Tensor


def sphere_prim_bounds(s: Spheres):
    """Center +/- radius boxes (SphereGeometry::BoundingBox,
    particle_primitive/main.cc:120-140); host NumPy for the builder."""
    c = _to_numpy(s.centers)
    r = _to_numpy(s.radii)[:, None]
    return c - r, c + r, c


def sphere_prepare(s: Spheres, rays) -> SphereRayCtx:
    del s
    return SphereRayCtx(org=rays.org, dir=rays.dir, min_t=rays.min_t)


def sphere_intersect(s: Spheres, ctx: SphereRayCtx, prim_ids, t_cur):
    """(valid, t, u, v) for (..., L) prim ids; uv zeros (PostTraversal
    fills them for the winning hit only, like the reference)."""
    ids = prim_ids.long()
    center = s.centers[ids]  # (..., L, 3)
    radius = s.radii[ids]
    org = ctx.org[..., None, :]
    d = ctx.dir[..., None, :]
    oc = org - center
    a = dot(d, d)
    b = 2.0 * dot(d, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    eps = torch.finfo(disc.dtype).eps

    no_roots = disc < 0.0
    double_root = disc.abs() < eps
    dist_sqrt = sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, (-b - dist_sqrt) / 2.0, (-b + dist_sqrt) / 2.0)
    one = torch.ones_like(a)
    safe_a = torch.where(a != 0, a, one)
    safe_q = torch.where(q != 0, q, one)
    t0 = torch.where(double_root, -0.5 * b / safe_a, q / safe_a)
    t1 = torch.where(double_root, t0, c / safe_q)
    t0, t1 = torch.minimum(t0, t1), torch.maximum(t0, t1)

    # nearest root inside [min_t, t_cur]. As in the JAX package (a
    # deviation from the reference, which never consults ray.min_t here):
    # min_t is honoured like the triangle path, falling through to the
    # far root when the near one is below the window.
    lo = ctx.min_t[..., None]
    t = torch.where(t0 >= lo, t0, t1)
    valid = ~no_roots & (a != 0) & (t >= lo) & (t <= t_cur[..., None])
    z = torch.zeros_like(t)
    return valid, t, z, z


def sphere_post(s: Spheres, rays: Rays, hits: Hits) -> Hits:
    """Fill spherical UV for final hits (PostTraversal,
    particle_primitive/main.cc:268-283)."""
    hit = hits.hit
    ids = torch.where(hit, hits.prim_id, 0)
    center = s.centers[ids]
    p = rays.org + hits.t[..., None] * rays.dir
    n = p - center
    n = n / torch.clamp(sqrt(dot(n, n)), min=1e-30)[..., None]
    u = (torch.atan2(n[..., 0], n[..., 2]) + math.pi) * (0.5 / math.pi)
    v = torch.acos(n[..., 1].clamp(-1.0, 1.0)) / math.pi
    return hits._replace(
        u=torch.where(hit, u.to(hits.u.dtype), hits.u),
        v=torch.where(hit, v.to(hits.v.dtype), hits.v),
    )


def build_sphere_bvh(s: Spheres, options=None):
    """Binned-SAH binary BVH over the spheres' boxes (host). Like
    ``build_triangle_bvh``, it takes the native C++ builder when it is
    available (float32 boxes), where the JAX package's ``build_sphere_bvh``
    takes the NumPy builder (~0.03 Mprims/s). The trees differ; the
    records do not, except which prim wins an exactly-equal-t tie."""
    return _build_bvh(*sphere_prim_bounds(s), options)


def traverse_spheres(bvh, s: Spheres, rays: Rays, options=None,
                     max_leaf: int = 4, max_stack: int | None = None,
                     skip_prim_id=None) -> Hits:
    """BVHAccel<float>::Traverse with the sphere intersector, on the
    rays' device (the sphere tensors must be there too)."""
    from ..core.options import BVHTraceOptions
    from ..traverse.stack import traverse

    options = options or BVHTraceOptions()
    hits = traverse(bvh, s, rays, options, prepare_fn=sphere_prepare,
                    intersect_fn=sphere_intersect, max_leaf=max_leaf,
                    skip_prim_id=skip_prim_id, max_stack=max_stack)
    return sphere_post(s, rays, hits)
