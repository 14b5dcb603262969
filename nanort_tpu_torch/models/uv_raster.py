"""UV-atlas rasterization by ray casting (port of
``nanort_tpu.models.uv_raster``; reference examples/uv_raster/).

The reference builds a second "UV mesh" whose vertex positions are the
facevarying texture coordinates (z = 0) and ray-casts one orthographic
ray per texel through it (uv_raster/main.cc:129-136; texel range from
the ``uv_region`` config, main.cc:215-224); the hit's prim id +
barycentrics then bake world-space AOVs (position, normal) into the
atlas. Same design here, with the whole atlas cast as one batch through
the stack engine on ``device`` (the card unless the caller asks for
another device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build_triangle_bvh
from ..core.options import BVHBuildOptions, INVALID_PRIM_ID
from ..core.ray import make_rays
from ..ops.triangle import TriangleMesh
from ..traverse.stack import traverse_triangles


def make_uv_mesh(facevarying_uvs: np.ndarray) -> TriangleMesh:
    """UV-space proxy mesh: (F, 3, 2) uvs -> flat triangles at z=0 with
    one unique vertex per corner (uv_raster/main.cc:129-136), as NumPy
    arrays."""
    uvs = np.asarray(facevarying_uvs, np.float32)
    n = uvs.shape[0]
    verts = np.concatenate(
        [uvs.reshape(-1, 2), np.zeros((3 * n, 1), np.float32)], axis=1
    )
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return TriangleMesh(vertices=verts, faces=faces)


def rasterize_uv_atlas(
    mesh: TriangleMesh,
    facevarying_uvs,
    atlas_size: int = 256,
    uv_region=((0.0, 0.0), (1.0, 1.0)),
    attributes: dict | None = None,
    device="cuda",
):
    """Bake per-texel coverage + AOVs.

    Returns dict with 'prim_id' (int64, 0xFFFFFFFF = empty texel),
    'position' (world-space interpolated vertices), plus one entry per
    ``attributes`` item mapping name -> (F, 3, C) facevarying data.
    """
    uv_mesh = make_uv_mesh(facevarying_uvs)
    bvh, _ = build_triangle_bvh(
        uv_mesh, BVHBuildOptions(min_leaf_primitives=4)
    )
    (u0, v0), (u1, v1) = uv_region
    ts = (torch.arange(atlas_size, dtype=torch.float32, device=device)
          + 0.5) / torch.full((), float(atlas_size), device=device)
    us = u0 + (u1 - u0) * ts
    vs = v0 + (v1 - v0) * ts
    gu, gv = torch.meshgrid(us, vs, indexing="xy")
    org = torch.stack([gu, gv, torch.ones_like(gu)], -1)
    d = torch.zeros_like(org)
    d[..., 2] = -1.0
    rays = make_rays(org.reshape(-1, 3), d.reshape(-1, 3))
    hits = traverse_triangles(bvh, uv_mesh, rays)

    fid = torch.where(hits.hit, hits.prim_id, 0)
    w = (1.0 - hits.u - hits.v)[:, None]
    bary = (w, hits.u[:, None], hits.v[:, None])

    def interp(fv):
        fv = torch.as_tensor(fv, device=device)
        tri = fv[fid]  # (T, 3, C)
        val = bary[0] * tri[:, 0] + bary[1] * tri[:, 1] + bary[2] * tri[:, 2]
        return torch.where(hits.hit[:, None], val, 0.0).reshape(
            atlas_size, atlas_size, -1)

    # facevarying world positions of the original mesh, (F, 3, 3)
    verts = torch.as_tensor(mesh.vertices, device=device)
    faces = torch.as_tensor(mesh.faces, device=device).long()
    out = {
        "prim_id": torch.where(hits.hit, hits.prim_id, INVALID_PRIM_ID
                               ).reshape(atlas_size, atlas_size),
        "position": interp(verts[faces]),
    }
    for name, fv in (attributes or {}).items():
        out[name] = interp(fv)
    return out
