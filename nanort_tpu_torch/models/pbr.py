"""PBR metallic-roughness shading on raycast hits (port of
``nanort_tpu.models.pbr``).

The reference's pbr_surface example ports the Khronos glTF-WebGL-PBR
reference shader to CPU ray hits (examples/pbr_surface/). Same model
here as batched tensor math: Lambert diffuse + Cook-Torrance specular
with Trowbridge-Reitz (GGX) distribution, Smith-Schlick geometric term
and Schlick fresnel, a single directional light plus an ambient term,
and an optional BVH shadow ray.

With ``scene8`` (BVH8/BVH16 tables on the rays' device) both traces run
the packet traversal kernel (K1): the primary pass through
``objrender.render_aovs`` and the shadow pass in any-hit mode with each
ray skipping the primitive its pixel hit, through the ray sort: two
launches a render on the card, the kernel's plain version on the CPU.
Without it, the stack engine traces both.

The JAX package jits ``render_pbr``; its XLA rewrites a division by a
constant into a product with the float32 reciprocal, and the port
computes those products (``_INV_PI``). Every other product is its own op
and sums over xyz run in order, so on the same records the port's image
equals the JAX package's on a CPU without FMA
(tests/test_torch_pbr.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import dot, normalize
from ..core.options import BVHTraceOptions
from ..core.ray import Rays, make_rays
from ..ops.triangle import TriangleMesh
from ..traverse.stack import traverse_triangles
from .cameras import _ipow
from .objrender import MeshAttributes, render_aovs

_INV_PI = float(np.float32(1.0) / np.float32(np.pi))
_PI = float(np.float32(np.pi))


class PBRMaterial(NamedTuple):
    base_color: torch.Tensor  # (3,) or per-face (F, 3)
    metallic: torch.Tensor  # scalar or (F,)
    roughness: torch.Tensor  # scalar or (F,)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def shade_pbr(n, v, l, base_color, metallic, roughness, light_color=1.0):
    """Khronos-style metallic-roughness BRDF * NdotL. All (..., 3)/(...)."""
    h = normalize(v + l)
    ndl = _clip(dot(n, l), 1e-4, 1.0)
    ndv = _clip(dot(n, v).abs(), 1e-4, 1.0)
    ndh = _clip(dot(n, h), 0.0, 1.0)
    vdh = _clip(dot(v, h), 0.0, 1.0)

    alpha = torch.maximum(roughness * roughness,
                          torch.full_like(roughness, 1e-3))
    metallic = metallic[..., None]
    f0 = 0.04 * (1.0 - metallic) + base_color * metallic
    # Schlick fresnel
    F = f0 + (1.0 - f0) * _ipow(1.0 - vdh[..., None], 5)
    # GGX / Trowbridge-Reitz NDF
    a2s = (alpha * alpha).expand(ndh.shape)
    dd = ndh * ndh * (a2s - 1.0) + 1.0
    D = a2s / torch.maximum(_PI * dd * dd, torch.full_like(dd, 1e-8))
    # Smith-Schlick geometric attenuation
    k = alpha.expand(ndh.shape) * 0.5
    G = (ndl / (ndl * (1 - k) + k)) * (ndv / (ndv * (1 - k) + k))

    q = 4.0 * ndl * ndv
    spec = F * (D * G / torch.maximum(q, torch.full_like(q, 1e-8)))[..., None]
    kd = (1.0 - F) * (1.0 - metallic)
    diffuse = kd * base_color * _INV_PI
    return (diffuse + spec) * ndl[..., None] * light_color


def render_pbr(
    bvh,
    mesh: TriangleMesh,
    rays: Rays,
    material: PBRMaterial,
    light_dir=(-0.5, 0.8, 0.6),
    light_color=(3.0, 3.0, 3.0),
    ambient=(0.06, 0.06, 0.08),
    attrs: MeshAttributes | None = None,
    options: BVHTraceOptions = BVHTraceOptions(),
    max_leaf: int = 4,
    shadows: bool = True,
    scene8=None,
):
    """Primary visibility + one directional light with PBR shading, on
    the rays' device. ``scene8`` routes both traces through the packet
    traversal kernel. Returns ``(aovs with "rgb", hits)``."""
    dev = rays.org.device
    aovs, hits = render_aovs(bvh, mesh, rays, attrs, options, max_leaf, scene8)
    hit = hits.hit
    n = aovs["normal"]
    n = torch.where((dot(n, rays.dir) > 0)[..., None], -n, n)
    p = aovs["position"]
    v = normalize(-rays.dir)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    l = normalize(f32(light_dir).expand(n.shape))
    base = f32(material.base_color)
    if base.ndim == 2:  # per-face
        fid = torch.where(hit, hits.prim_id, 0)
        base = base[fid]
        metal = f32(material.metallic)[fid]
        rough = f32(material.roughness)[fid]
    else:
        base = base.expand(n.shape)
        metal = f32(material.metallic).expand(hit.shape)
        rough = f32(material.roughness).expand(hit.shape)

    color = shade_pbr(n, v, l, base, metal, rough, f32(light_color))
    if shadows:
        sh_rays = make_rays(
            p + 1e-4 * n, l,
            min_t=torch.zeros(hit.shape, device=dev),
            max_t=torch.where(hit, 1e30, 0.0).float(),
        )
        if scene8 is not None:
            from ..traverse.ray_sort import traverse_bvh8_sorted

            occ = traverse_bvh8_sorted(
                scene8, sh_rays, options, skip_prim_id=hits.prim_id,
                occlusion=True,
            )
        else:
            occ = traverse_triangles(
                bvh, mesh, sh_rays, options,
                skip_prim_id=hits.prim_id, max_leaf=max_leaf,
            )
        color = torch.where(occ.hit[..., None], 0.0, color)

    color = color + f32(ambient) * base
    rgb = torch.where(hit[..., None], color, 0.0)
    return {**aovs, "rgb": rgb}, hits
