"""Sphere / particle primitive kind (port of ``nanort_tpu.ops.sphere``;
plain torch on the stack engine ``traverse/stack.py``, or K1 with its
sphere leaf test over the wide tables of ``build.bvh8.collapse_bvh8(...,
spheres=)``).

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
from ..utils import trace
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


def sphere_hit(org, d, center, radius, min_t, t_cur):
    """``(valid, t)`` of rays against spheres, broadcasting ``org``/``d``
    (..., 3) against ``center`` (..., 3), ``radius``, ``min_t`` and
    ``t_cur``: K1's sphere test (``csrc/packet_traverse.cu::hit_sphere``)
    operation for operation, ``sphere_intersect``'s rules with a precise
    discriminant.

    ``sphere_intersect`` (the JAX package's) takes the discriminant as
    b^2 - 4ac, a difference of two numbers of the order of |o - c|^2
    whose float32 rounding (~|o - c|^2 * 2^-24) passes 4 a r^2 once the
    centre lies ~10^3 radii away: at a LiDAR tile's 740 m, 0.33-m spheres
    flip hit and miss on 13% of the rays that pass within 1.2 radii, and
    t errs by up to 0.4 m (PERF.md §6). Here the discriminant is 4 a (r^2
    - |l|^2), l = (o - c) - ((d . (o - c)) / a) d the centre's offset from
    the ray's closest approach (Haines et al., "Precision Improvements
    for Ray/Sphere Intersection", Ray Tracing Gems, ch. 7), whose
    rounding is that of |l|^2 ~ r^2. The rest is ``sphere_intersect``'s:
    the q-form roots q / a and c / q, the |disc| < eps double root, the
    nearest root in [min_t, t_cur] or else the far one, an equal t
    accepted; min and max of the roots take NaN from either and, between
    equal roots, the second (torch.minimum's vector path). Every sum is
    x, y, z in order and every product its own operation."""
    ox, oy, oz = org[..., 0], org[..., 1], org[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ocx, ocy, ocz = ox - center[..., 0], oy - center[..., 1], \
        oz - center[..., 2]
    a = dx * dx + dy * dy + dz * dz
    beta = dx * ocx + dy * ocy + dz * ocz
    k = beta / a
    lx, ly, lz = ocx - k * dx, ocy - k * dy, ocz - k * dz
    disc = 4.0 * (a * (radius * radius - (lx * lx + ly * ly + lz * lz)))
    b = 2.0 * beta
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
    double_root = disc.abs() < torch.finfo(disc.dtype).eps
    ds = sqrt(torch.where(disc < 0.0, 0.0, disc))
    q = torch.where(b < 0, (-b - ds) / 2.0, (-b + ds) / 2.0)
    sa = torch.where(a != 0, a, 1.0)
    sq = torch.where(q != 0, q, 1.0)
    r0 = torch.where(double_root, -0.5 * b / sa, q / sa)
    r1 = torch.where(double_root, r0, c / sq)
    nan = torch.isnan(r0) | torch.isnan(r1)
    t0 = torch.where(nan, float("nan"), torch.where(r0 < r1, r0, r1))
    t1 = torch.where(nan, float("nan"), torch.where(r0 > r1, r0, r1))
    t = torch.where(t0 >= min_t, t0, t1)
    valid = ~(disc < 0.0) & (a != 0) & (t >= min_t) & (t <= t_cur)
    return valid, t


def sphere_intersect_precise(s: Spheres, ctx: SphereRayCtx, prim_ids,
                             t_cur):
    """``sphere_intersect`` with ``sphere_hit``'s precise discriminant:
    K1's sphere test in plain torch, the stack engine's with
    ``traverse_spheres(..., precise=True)``."""
    ids = prim_ids.long()
    valid, t = sphere_hit(ctx.org[..., None, :], ctx.dir[..., None, :],
                          s.centers[ids], s.radii[ids],
                          ctx.min_t[..., None], t_cur[..., None])
    z = torch.zeros_like(t)
    return valid, t, z, z


def sphere_surface(s: Spheres, rays: Rays, hits: Hits):
    """``(p, n)``: each record's hit point o + t d and the unit normal
    (p - c) / |p - c| of the sphere it names (a miss reads sphere 0; its
    values mean nothing)."""
    ids = torch.where(hits.hit, hits.prim_id, 0)
    center = s.centers[ids]
    p = rays.org + hits.t[..., None] * rays.dir
    n = p - center
    n = n / torch.clamp(sqrt(dot(n, n)), min=1e-30)[..., None]
    return p, n


def sphere_uv(hits: Hits, n: torch.Tensor) -> Hits:
    """``hits`` with the spherical UV of the unit normals ``n`` on its
    hits: u = (atan2(n.x, n.z) + pi) / (2 pi), v = acos(n.y) / pi."""
    hit = hits.hit
    u = (torch.atan2(n[..., 0], n[..., 2]) + math.pi) * (0.5 / math.pi)
    v = torch.acos(n[..., 1].clamp(-1.0, 1.0)) / math.pi
    return hits._replace(
        u=torch.where(hit, u.to(hits.u.dtype), hits.u),
        v=torch.where(hit, v.to(hits.v.dtype), hits.v),
    )


@trace.span("sphere.post")
def sphere_post(s: Spheres, rays: Rays, hits: Hits) -> Hits:
    """Fill spherical UV for final hits (PostTraversal,
    particle_primitive/main.cc:268-283)."""
    return sphere_uv(hits, sphere_surface(s, rays, hits)[1])


@trace.span("build.sah")
def build_sphere_bvh(s: Spheres, options=None):
    """Binned-SAH binary BVH over the spheres' boxes (host). Like
    ``build_triangle_bvh``, it takes the native C++ builder when it is
    available (float32 boxes), where the JAX package's ``build_sphere_bvh``
    takes the NumPy builder (~0.03 Mprims/s). The trees differ; the
    records do not, except which prim wins an exactly-equal-t tie.
    ``build.bvh8.collapse_bvh8(bvh, width=..., spheres=s)`` collapses the
    tree (leaves of at most 10) into K1's sphere tables."""
    return _build_bvh(*sphere_prim_bounds(s), options)


def traverse_spheres(bvh, s: Spheres, rays: Rays, options=None,
                     max_leaf: int = 4, max_stack: int | None = None,
                     skip_prim_id=None, scene8=None, precise: bool = False,
                     post: bool = True) -> Hits:
    """BVHAccel<float>::Traverse with the sphere intersector, on the
    rays' device (the sphere tensors must be there too), then
    PostTraversal's UV (``post``; without it u = v = 0).

    With ``scene8`` (``collapse_bvh8(..., spheres=s)`` on the rays'
    device) the rays go through K1's sphere leaf test, whose arithmetic
    is ``sphere_hit``'s: an image-shaped batch in raster order
    (``packet.traverse_image``, which takes no ``skip_prim_id``), any
    other shape as it comes (``traverse_bvh8``). Without it the stack
    engine walks ``bvh`` with the JAX package's ``sphere_intersect``, or,
    with ``precise``, with ``sphere_intersect_precise``, K1's test in
    plain torch: the two engines then give the same t bit for bit and
    the same prims but between hits at exactly equal t.

    Two tests, because they differ where b^2 - 4ac rounds: by up to 128
    ulp of t on the port's JAX comparison scenes (spheres within 4 units
    of the rays' origins), whose 4-ulp tolerance the precise test would
    fail, and by whole spheres at a LiDAR tile's distances, where only
    the precise test matches the float64 reference (PERF.md §6)."""
    from ..core.options import BVHTraceOptions

    options = options or BVHTraceOptions()
    if scene8 is not None:
        from ..traverse.packet import traverse_bvh8, traverse_image

        if scene8.leaf_kind != "sphere":
            raise ValueError("scene8 holds triangles: collapse the sphere "
                             "tree with collapse_bvh8(..., spheres=)")
        if skip_prim_id is None and len(rays.batch_shape) == 2:
            hits = traverse_image(scene8, rays, options)
        else:
            hits = traverse_bvh8(scene8, rays, options,
                                 skip_prim_id=skip_prim_id)
    else:
        from ..traverse.stack import traverse

        hits = traverse(bvh, s, rays, options, prepare_fn=sphere_prepare,
                        intersect_fn=sphere_intersect_precise if precise
                        else sphere_intersect, max_leaf=max_leaf,
                        skip_prim_id=skip_prim_id, max_stack=max_stack)
    return sphere_post(s, rays, hits) if post else hits
