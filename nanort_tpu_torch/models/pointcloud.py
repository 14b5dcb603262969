"""The LAS viewer's frame: a point cloud drawn as spheres, with objrender's
AOV set (examples/las/render.cc:84-270, its spheres traced with the
particle primitive of examples/particle_primitive/main.cc:82-291).

``render_sphere_aovs`` is ``objrender.render_aovs`` for a sphere scene:
with ``scene8`` (``build.bvh8.collapse_bvh8(bvh, width=..., spheres=s)``
on the rays' device) an image-shaped frame goes through K1's sphere leaf
test in one launch over the rays in raster order
(``traverse.packet.traverse_image``: no tiled copy, never the ray sort),
on the CPU through K1's plain version; without it, through the stack
engine over the binary tree. The AOVs follow in plain torch from the
records, in one span ``sphere.post``: PostTraversal's UV
(``ops.sphere.sphere_post``) and the normal, colour, position and depth
of each hit, from one hit point and one normal.
"""

from __future__ import annotations

import torch

from ..core.options import BVHTraceOptions
from ..core.ray import Rays
from ..ops.sphere import (Spheres, sphere_surface, sphere_uv,
                          traverse_spheres)
from ..utils import trace


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
    (``ops.sphere.build_sphere_bvh``)."""
    if scene8 is None and bvh is None:
        raise ValueError("render_sphere_aovs needs scene8 or bvh")
    hits = traverse_spheres(bvh, spheres, rays, options, max_leaf=None,
                            scene8=scene8, precise=True, post=False)
    with trace.span("sphere.post"):
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
