"""O(n) brute-force intersection — the test oracle (port of
``nanort_tpu.traverse.brute``).

Tests every ray against every triangle in chunks of ``chunk_size``
triangles, so memory stays bounded at (rays x chunk). Semantics replicate
a sequential scan of prims 0..F-1 through the reference's ``Intersect``
contract (``tt > t`` rejects, so among equal-t hits the highest prim index
wins; nanort.h:1131-1139). Plain torch; runs on any device.
"""

from __future__ import annotations

import torch

from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from ..ops import triangle as tri
from ..ops.protocol import apply_trace_filters


def _select_best(valid, tt, u, v, ids, t0, u0, v0, id0):
    """Fold a (R, L) candidate chunk into the running best per ray: min t
    wins, equal t resolves to the highest position, and the chunk wins
    ties against the carry (later prims replace)."""
    big = torch.finfo(tt.dtype).max
    t_m = torch.where(valid, tt, big)
    t_best = t_m.amin(dim=-1)
    is_best = valid & (t_m == t_best[:, None])
    pos = torch.arange(tt.shape[-1], device=tt.device)
    best_pos = torch.where(is_best, pos, -1).amax(dim=-1)
    take = best_pos.clamp(min=0)[:, None]
    upd = (best_pos >= 0) & (t_best <= t0)
    return (
        torch.where(upd, t_best, t0),
        torch.where(upd, u.gather(1, take)[:, 0], u0),
        torch.where(upd, v.gather(1, take)[:, 0], v0),
        torch.where(upd, ids[take[:, 0]], id0),
    )


def brute_force_traverse(mesh: tri.TriangleMesh, rays: Rays,
                         options: BVHTraceOptions = BVHTraceOptions(),
                         skip_prim_id=None, chunk_size: int = 512) -> Hits:
    """Intersect rays against all triangles (no BVH). Oracle for tests.

    ``mesh`` fields are moved to the rays' device. ``skip_prim_id``: an
    optional per-ray tensor overriding the static option.
    """
    dev = rays.org.device
    dt = rays.dtype
    bs = rays.batch_shape
    org = rays.org.reshape(-1, 3)
    min_t = rays.min_t.reshape(-1)
    max_t = rays.max_t.reshape(-1)
    verts = torch.as_tensor(mesh.vertices, device=dev).to(dt)
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    n_faces = faces.shape[0]
    coeffs = tri.ray_coeffs(rays.dir.reshape(-1, 3))
    coeffs_l = tri.RayCoeffs(*(c[:, None] for c in coeffs))
    if skip_prim_id is None:
        skip = options.skip_prim_id
    else:
        skip = torch.as_tensor(skip_prim_id, device=dev).reshape(-1).long()

    t = max_t.clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    pid = torch.full(t.shape, INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE, device=dev)
    for start in range(0, n_faces, chunk_size):
        ids = torch.arange(start, min(start + chunk_size, n_faces), device=dev)
        p0, p1, p2 = tri.gather_triangle_vertices(verts, faces[ids])
        valid, tt, uu, vv = tri.intersect_triangles(
            coeffs_l, org[:, None, :], min_t[:, None], t[:, None], p0, p1, p2,
            cull_back_face=options.cull_back_face,
            exact_edge_fallback=options.exact_edge_fallback,
        )
        valid = apply_trace_filters(valid, ids, options.prim_ids_range, skip)
        t, u, v, pid = _select_best(valid, tt, uu, vv, ids, t, u, v, pid)
    hit = t < max_t
    return Hits(
        t=t.reshape(bs),
        u=torch.where(hit, u, 0.0).reshape(bs),
        v=torch.where(hit, v, 0.0).reshape(bs),
        prim_id=torch.where(hit, pid, INVALID_PRIM_ID).reshape(bs),
    )
