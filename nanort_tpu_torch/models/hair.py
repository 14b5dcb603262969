"""A head of hair drawn as cubic Bezier curves, with objrender's AOV set
and the tangent that hair shading reads (upstream
examples/curves_primitive/main.cc:481-800, the Nakamaru-Ohno curve test).

``render_curve_aovs`` is ``pointcloud.render_sphere_aovs`` for a curve
scene: with ``scene8`` (``build.bvh8.collapse_bvh8(bvh, width=...,
curves=c)`` on the rays' device) an image-shaped frame goes through K1's
curve leaf test in one launch over the rays in raster order
(``traverse.packet.traverse_image``: no tiled copy, never the ray sort),
on the CPU through K1's plain version; without it, through the stack
engine over the binary tree. The AOVs follow in plain torch from the
records, in one span ``curve.post``.
"""

from __future__ import annotations

import torch

from ..core.options import BVHTraceOptions
from ..core.ray import Rays
from ..ops.curve import Curves, curve_tangent, traverse_curves
from ..utils import trace


@trace.span("render_curve_aovs")
def render_curve_aovs(curves: Curves, rays: Rays, bvh=None,
                      options: BVHTraceOptions = BVHTraceOptions(),
                      scene8=None):
    """One primary-visibility pass over curves, returning ``(aovs,
    hits)``: ``tangent`` the unit world-space derivative B'(u) of the
    hit's curve at its parameter u (``ops.curve.curve_tangent``, the
    input of Kajiya-Kay shading), ``rgb`` 0.5 tangent + 0.5, ``position``
    o + t d, ``depth`` t, ``texcoord`` the record's (u, v) (the curve
    parameter, the distance to the curve's axis), ``prim_id`` and
    ``hit``; every AOV 0 on a miss but ``prim_id``. Pass ``scene8`` to
    trace through K1; without it the stack engine walks ``bvh``
    (``ops.curve.build_curve_bvh``)."""
    if scene8 is None and bvh is None:
        raise ValueError("render_curve_aovs needs scene8 or bvh")
    hits = traverse_curves(bvh, curves, rays, options, max_leaf=None,
                           scene8=scene8)
    with trace.span("curve.post"):
        tan = curve_tangent(curves, hits)
        hit = hits.hit
        h3 = hit[..., None]
        zero = torch.zeros((), dtype=tan.dtype, device=tan.device)
        p = rays.org + hits.t[..., None] * rays.dir
        aovs = {
            "rgb": torch.where(h3, 0.5 * tan + 0.5, zero),
            "tangent": torch.where(h3, tan, zero),
            "position": torch.where(h3, p, zero),
            "depth": torch.where(hit, hits.t, zero),
            "texcoord": torch.stack([hits.u, hits.v], dim=-1),
            "prim_id": hits.prim_id,
            "hit": hit,
        }
    return aovs, hits
