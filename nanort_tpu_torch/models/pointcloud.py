"""The LAS viewer's frame: a point cloud drawn as spheres, with objrender's
AOV set (examples/las/render.cc:84-270, its spheres traced with the
particle primitive of examples/particle_primitive/main.cc:82-291).

``render_sphere_aovs`` is ``objrender.render_aovs`` for a sphere scene:
with ``scene8`` (``build.bvh8.collapse_bvh8(bvh, width=..., spheres=s)``
on the rays' device) an image-shaped frame goes through K1's sphere leaf
test in one launch over the rays in raster order
(``traverse.packet.traverse_image``: no tiled copy, never the ray sort),
on the CPU through K1's plain version; without it, through the stack
engine over the binary tree. The AOVs follow from the records in one
span ``sphere.post``: PostTraversal's UV (``ops.sphere.sphere_post``)
and the normal, colour, position and depth of each hit, from one hit
point and one normal. On a CUDA device that is one launch of
``csrc/sphere_aovs.cu`` (counted as ``sphere_aovs_fused``) over float32
records, rays and centres, and card input it cannot take raises; off the
card it is the plain torch version ``_sphere_aovs_plain``, which the
kernel equals bit for bit on the card.
"""

from __future__ import annotations

import torch

from ..core.options import BVHTraceOptions
from ..core.ray import Hits, Rays
from ..ops.sphere import (Spheres, sphere_surface, sphere_uv,
                          traverse_spheres)
from ..traverse import _ext
from ..utils import trace

trace.declare_launches("sphere_aovs_fused")


@trace.span("render_sphere_aovs")
def render_sphere_aovs(spheres: Spheres, rays: Rays, bvh=None,
                       options: BVHTraceOptions = BVHTraceOptions(),
                       scene8=None):
    """One primary-visibility pass over spheres, returning ``(aovs,
    hits)`` with objrender's AOV keys: ``normal`` (p - c) / |p - c|,
    ``rgb`` 0.5 n + 0.5, ``position`` o + t d, ``depth`` t, ``texcoord``
    PostTraversal's (u, v), ``prim_id`` and ``hit``; every AOV 0 on a
    miss but ``prim_id``. ``hits`` carries the UV. Pass ``scene8`` to
    trace through K1; without it the stack engine walks ``bvh``
    (``ops.sphere.build_sphere_bvh``). The AOVs come from
    ``sphere_aovs_from_hits``: one kernel launch on the card, the plain
    version off it."""
    if scene8 is None and bvh is None:
        raise ValueError("render_sphere_aovs needs scene8 or bvh")
    hits = traverse_spheres(bvh, spheres, rays, options, max_leaf=None,
                            scene8=scene8, precise=True, post=False)
    with trace.span("sphere.post"):
        return sphere_aovs_from_hits(spheres, rays, hits)


def sphere_aovs_from_hits(spheres: Spheres, rays: Rays, hits: Hits):
    """``render_sphere_aovs``'s ``(aovs, hits)`` from its records. On a
    CUDA device this is one launch of ``csrc/sphere_aovs.cu`` (counted as
    ``sphere_aovs_fused``), whose records' u and v are views of
    ``texcoord``'s columns; card input the kernel cannot take (float64,
    int32 prim ids, records that are not ``Hits``, shapes that do not
    match) raises a ``TypeError`` naming it. Off the card the plain
    version ``_sphere_aovs_plain`` runs, whose bits the kernel gives on
    the card. A hit's prim id that names no sphere fails the launch, as
    the plain version's gather fails."""
    if rays.org.device.type != "cuda":
        return _sphere_aovs_plain(spheres, rays, hits)
    refusal = _fused_refusal(spheres.centers, rays, hits)
    if refusal is not None:
        raise TypeError(f"sphere_aovs_from_hits: the CUDA kernel takes "
                        f"no {refusal}")
    return _sphere_aovs_fused(spheres.centers, rays, hits)


def _fused_refusal(centers, rays, hits) -> str | None:
    """The input of these that ``_sphere_aovs_fused`` cannot take, or
    None where it takes them all."""
    if not isinstance(hits, Hits):
        return f"records of type {type(hits).__name__} (not Hits)"
    dev = rays.org.device
    named = {"rays.org": rays.org, "rays.dir": rays.dir, "hits.t": hits.t,
             "hits.u": hits.u, "hits.v": hits.v, "spheres.centers": centers,
             "hits.prim_id": hits.prim_id}
    for name, x in named.items():
        want = torch.int64 if name == "hits.prim_id" else torch.float32
        if x.dtype != want:
            return f"{name} of dtype {x.dtype} (not {want})"
        if x.device != dev:
            return f"{name} on {x.device} (the rays are on {dev})"
    bs = rays.batch_shape
    if rays.org.shape[-1] != 3 or rays.dir.shape != rays.org.shape:
        return (f"rays of shapes {tuple(rays.org.shape)} and "
                f"{tuple(rays.dir.shape)} (not both {bs + (3,)})")
    for name, x in zip(Hits._fields, hits):
        if tuple(x.shape) != bs:
            return f"hits.{name} of shape {tuple(x.shape)} (not {bs})"
    if centers.ndim != 2 or centers.shape[1] != 3:
        return f"spheres.centers of shape {tuple(centers.shape)} (not (N, 3))"
    return None


def _sphere_aovs_fused(centers, rays, hits):
    """``_sphere_aovs_plain``'s ``(aovs, hits)`` from one launch of
    ``csrc/sphere_aovs.cu``; the records' u and v are views of
    ``texcoord``'s columns."""
    dev = rays.org.device
    bs = rays.batch_shape
    f32 = dict(dtype=torch.float32, device=dev)
    rgb, nrm, pos = (torch.empty(bs + (3,), **f32) for _ in range(3))
    depth = torch.empty(bs, **f32)
    uv = torch.empty(bs + (2,), **f32)
    hit = torch.empty(bs, dtype=torch.bool, device=dev)
    t, u, v, pid, org, dir, centers = (
        x.contiguous() for x in (*hits, rays.org, rays.dir, centers))
    _ext.launch(
        "sphere_aovs", "nrt_sphere_aovs", t, u, v, pid, org, dir, centers,
        rgb, nrm, pos, depth, uv, hit, t.numel(), centers.shape[0],
        device=dev, count="sphere_aovs_fused")
    aovs = {"rgb": rgb, "normal": nrm, "position": pos, "depth": depth,
            "texcoord": uv, "prim_id": hits.prim_id, "hit": hit}
    return aovs, hits._replace(u=uv[..., 0], v=uv[..., 1])


def _sphere_aovs_plain(spheres: Spheres, rays: Rays, hits: Hits):
    """The AOVs and the records with their UV in plain torch, the
    kernel's reference."""
    p, n = sphere_surface(spheres, rays, hits)
    hits = sphere_uv(hits, n)
    hit = hits.hit
    h3 = hit[..., None]
    zero = torch.zeros((), dtype=n.dtype, device=n.device)
    aovs = {
        "rgb": torch.where(h3, 0.5 * n + 0.5, zero),
        "normal": torch.where(h3, n, zero),
        "position": torch.where(h3, p, zero),
        "depth": torch.where(hit, hits.t, zero),
        "texcoord": torch.stack([hits.u, hits.v], dim=-1),
        "prim_id": hits.prim_id,
        "hit": hit,
    }
    return aovs, hits
