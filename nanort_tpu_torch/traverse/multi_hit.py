"""K-nearest multi-hit traversal (port of ``nanort_tpu.traverse.multi_hit``;
plain XLA there, plain torch here).

The reference declares ``MultiHitTraverse`` (nanort.h:761-770) with a
priority-queue K-nearest implementation but ships it disabled behind
``#if 0`` (nanort.h:2409-2485, 2694-2797). This is the working
equivalent: per-ray sorted K-lists, merged with sorts.

Semantics (the JAX package's):
* returns the K nearest hits per ray with t in [min_t, max_t], sorted
  ascending by (t, prim_id); empty slots carry t = the dtype's max and
  prim_id = 0xFFFFFFFF (int64 here, as every prim id of the port);
* traversal prunes with the ray's current K-th-best distance, so the
  node/leaf culling sharpens as the single-hit engine's shrinking hit t
  does (nanort.h:2545);
* trace-option filters (prim_ids_range, skip_prim_id, cull_back_face)
  apply per candidate, as in TestLeafNode (nanort.h:2372-2407).

The merge is the JAX package's lexsort by (t, prim_id) as two stable
sorts (prim id, then t), so ties resolve as there and the lists do not
depend on the order in which candidates were found.

Two engines, as for single hits:
* ``multi_hit_traverse``: the stack machine of ``traverse/stack.py``
  (any BVH, float32/float64); only the rays still walking take part in
  a step, which changes no list (a finished ray's list is final);
* ``multi_hit_wavefront``: the stackless skip-link walk of
  ``traverse/wavefront.py`` over a ``PackedScene`` (multi-mesh tables
  and per-ray roots), each step moving a ray one node and testing the
  leaf it lands on; ``tile`` is accepted for the JAX signature and
  changes nothing.
Both are held to ``brute_force_multi_hit``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.aabb import intersect_ray_aabb
from ..core.math import safe_inverse
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Rays
from ..ops import triangle as tri
from ..ops.protocol import apply_trace_filters
from .packet import _flat_rays
from .stack import _auto_max_stack, _take
from .wavefront import SYNC_EVERY, _slab, _table


class MultiHits(NamedTuple):
    """Per-ray K-nearest hit lists, ascending by t. Slot j is valid iff
    j < count (equivalently prim_id != 0xFFFFFFFF)."""

    t: torch.Tensor  # (..., K)
    u: torch.Tensor  # (..., K)
    v: torch.Tensor  # (..., K)
    prim_id: torch.Tensor  # (..., K) int64
    count: torch.Tensor  # (...,) int32

    @property
    def hit(self) -> torch.Tensor:
        return self.count > 0


def _merge_klists(t_l, u_l, v_l, id_l, valid_c, t_c, u_c, v_c, id_c):
    """Merge (R, K) sorted lists with (R, L) candidates -> (R, K) sorted
    by (t, prim_id), ties of both by position (stable)."""
    big = torch.finfo(t_l.dtype).max
    K = t_l.shape[-1]
    t_all = torch.cat([t_l, torch.where(valid_c, t_c, big)], dim=-1)
    u_all = torch.cat([u_l, u_c], dim=-1)
    v_all = torch.cat([v_l, v_c], dim=-1)
    id_all = torch.cat([id_l, torch.where(valid_c, id_c, INVALID_PRIM_ID)],
                       dim=-1)
    o1 = torch.argsort(id_all, dim=-1, stable=True)
    o2 = torch.argsort(t_all.gather(-1, o1), dim=-1, stable=True)
    order = o1.gather(-1, o2)[..., :K]
    return tuple(x.gather(-1, order) for x in (t_all, u_all, v_all, id_all))


def _empty_lists(R: int, K: int, dt, dev):
    big = torch.finfo(dt).max
    z = torch.zeros((R, K), dtype=dt, device=dev)
    return (torch.full((R, K), big, dtype=dt, device=dev), z, z.clone(),
            torch.full((R, K), INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE,
                       device=dev))


def _finish(t_l, u_l, v_l, id_l, bs) -> MultiHits:
    valid = id_l != INVALID_PRIM_ID
    big = torch.finfo(t_l.dtype).max
    out = MultiHits(
        t=torch.where(valid, t_l, big),
        u=torch.where(valid, u_l, 0.0),
        v=torch.where(valid, v_l, 0.0),
        prim_id=id_l,
        count=valid.sum(-1, dtype=torch.int32),
    )
    return MultiHits(*(x.reshape(bs + x.shape[1:]) for x in out))


# ---------------------------------------------------------------------------
# stack engine
# ---------------------------------------------------------------------------


def multi_hit_traverse(
    bvh,
    mesh: tri.TriangleMesh,
    rays: Rays,
    max_intersections: int = 8,
    options: BVHTraceOptions = BVHTraceOptions(),
    skip_prim_id=None,
    max_leaf: int = 4,
    max_stack: int | None = None,
) -> MultiHits:
    """K-nearest triangle hits by the stack engine (the reference's
    MultiHitTraverse contract, nanort.h:2694-2797, repaired), on the
    rays' device. ``skip_prim_id``: an optional per-ray tensor overriding
    ``options.skip_prim_id``."""
    if max_stack is None:
        max_stack = _auto_max_stack(bvh)
    K = int(max_intersections)
    bs = rays.batch_shape
    flat = _flat_rays(rays)
    dt = flat.dtype
    dev = flat.org.device
    R = flat.org.shape[0]
    mesh = tri.TriangleMesh(torch.as_tensor(mesh.vertices, device=dev),
                            torch.as_tensor(mesh.faces, device=dev).long())
    skip = options.skip_prim_id if skip_prim_id is None else torch.as_tensor(
        skip_prim_id, device=dev).reshape(-1).long()
    per_ray_skip = isinstance(skip, torch.Tensor)

    def tab(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype)

    bmin, bmax = tab(np.asarray(bvh.bmin), dt), tab(np.asarray(bvh.bmax), dt)
    flag = tab(np.asarray(bvh.flag), torch.long)
    axis = tab(np.asarray(bvh.axis), torch.long)
    data = tab(np.asarray(bvh.data).astype(np.int64), torch.long)
    indices = tab(np.asarray(bvh.indices).astype(np.int64), torch.long)

    ctx = tri.triangle_prepare(mesh, flat)
    intersect_fn = tri.make_triangle_intersect(
        cull_back_face=options.cull_back_face,
        exact_edge_fallback=options.exact_edge_fallback)
    dir_neg = flat.dir < 0
    inv_dir = safe_inverse(flat.dir)

    stack = torch.zeros((R, max_stack), dtype=torch.long, device=dev)
    sp = torch.zeros(R, dtype=torch.long, device=dev)
    t_l, u_l, v_l, id_l = _empty_lists(R, K, dt, dev)
    lpos = torch.arange(max_leaf, device=dev)

    while True:
        i = (sp >= 0).nonzero().squeeze(1)
        if i.numel() == 0:
            break
        spi = sp[i]
        idx = stack[i, spi]
        spi = spi - 1
        nd = data[idx]
        # prune with the K-th best, never beyond the ray's max_t window
        t_cap = torch.minimum(t_l[i, K - 1], flat.max_t[i])
        box_hit, _, _ = intersect_ray_aabb(
            bmin[idx], bmax[idx], flat.org[i], inv_dir[i], dir_neg[i],
            flat.min_t[i], t_cap)
        is_leaf = flag[idx] == 1

        near_sel = dir_neg[i].gather(1, axis[idx][:, None])[:, 0]
        near = torch.where(near_sel, nd[:, 1], nd[:, 0])
        far = torch.where(near_sel, nd[:, 0], nd[:, 1])
        push = box_hit & ~is_leaf & (spi + 2 <= max_stack - 1)
        pi, ps = i[push], spi[push]
        stack[pi, ps + 1] = far[push]
        stack[pi, ps + 2] = near[push]
        sp[i] = torch.where(push, spi + 2, spi)

        leaf = box_hit & is_leaf
        li = i[leaf]
        count, offset = nd[leaf, 0], nd[leaf, 1]
        lval = lpos < count[:, None]
        pids = indices[torch.where(lval, offset[:, None] + lpos, 0)]
        valid, tt, uu, vv = intersect_fn(mesh, _take(ctx, li), pids,
                                         t_cap[leaf])
        valid = apply_trace_filters(valid & lval, pids,
                                    options.prim_ids_range,
                                    skip[li] if per_ray_skip else skip)
        t_l[li], u_l[li], v_l[li], id_l[li] = _merge_klists(
            t_l[li], u_l[li], v_l[li], id_l[li], valid, tt, uu, vv, pids)
    return _finish(t_l, u_l, v_l, id_l, bs)


# ---------------------------------------------------------------------------
# wavefront engine
# ---------------------------------------------------------------------------


def _walk_multi(nodes, soup, n, org, dir, min_t, max_t, root, options,
                max_leaf, K):
    """Skip-link walk of flat rays keeping K-lists."""
    dev = org.device
    R = org.shape[0]
    inv_all = safe_inverse(dir)
    neg_all = dir < 0
    co_all = tri.ray_coeffs(dir)
    lpos = torch.arange(max_leaf, device=dev)
    last_row = soup.shape[0] - 1

    lists = list(_empty_lists(R, K, torch.float32, dev))
    start = torch.zeros(R, dtype=torch.long, device=dev) if root is None \
        else root
    # an empty interval starts done, as the JAX package's padding lanes
    cur = torch.where(max_t < min_t, n, start)
    idx = torch.arange(R, device=dev)
    mine = [x.clone() for x in lists]
    step = 0
    while True:
        if step % SYNC_EVERY == 0:
            for full, part in zip(lists, mine):
                full[idx] = part
            keep = (cur < n).nonzero().squeeze(1)
            if keep.numel() == 0:
                break
            idx, cur = idx[keep], cur[keep]
            mine = [x[idx] for x in lists]
            o, inv, neg = org[idx], inv_all[idx], neg_all[idx]
            mn, mx = min_t[idx], max_t[idx]
            co = tri.RayCoeffs(*(c[idx][:, None] for c in co_all))
        step += 1
        active = cur < n
        t_cap = torch.minimum(mine[0][:, K - 1], mx)
        row = nodes[cur.clamp(max=n - 1)]
        hit = _slab(row, o, inv, neg, mn, t_cap) & active
        ints = row[:, 6:9].view(torch.int32).long()
        cnt, off, skp = ints[:, 0], ints[:, 1], ints[:, 2]
        leaf = hit & (cnt > 0)
        li = leaf.nonzero().squeeze(1)
        if li.numel():
            srow = soup[(off[li, None] + lpos).clamp(0, last_row)]
            valid, tt, uu, vv = tri.intersect_triangles(
                tri.RayCoeffs(*(c[li] for c in co)), o[li, None, :],
                mn[li, None], t_cap[li, None], srow[..., 0:3],
                srow[..., 3:6], srow[..., 6:9],
                cull_back_face=options.cull_back_face,
                exact_edge_fallback=options.exact_edge_fallback)
            pids = srow[..., 9].contiguous().view(torch.int32).long()
            valid = apply_trace_filters(
                valid & (lpos < cnt[li, None]), pids,
                options.prim_ids_range, options.skip_prim_id)
            merged = _merge_klists(*(x[li] for x in mine), valid, tt, uu,
                                   vv, pids)
            for x, y in zip(mine, merged):
                x[li] = y
        # a tested leaf resumes at its own escape index, never cur + 1
        cur = torch.where(hit & ~leaf, cur + 1,
                          torch.where(active, skp, cur))
    return lists


def multi_hit_wavefront(
    scene,
    rays: Rays,
    max_intersections: int = 8,
    options: BVHTraceOptions = BVHTraceOptions(),
    max_leaf: int = 4,
    tile: int = 8192,
    root=None,
) -> MultiHits:
    """K-nearest hits by the stackless skip-link engine over a
    ``PackedScene`` (multi-mesh tables with a per-ray ``root``); float32
    rays, tables on the rays' device or host arrays."""
    if rays.org.dtype != torch.float32:
        raise ValueError("multi_hit_wavefront traces float32 rays")
    known = getattr(scene, "max_leaf", None)
    if known is not None and known > max_leaf:
        raise ValueError(
            f"packed scene has leaves holding {known} primitives but "
            f"max_leaf={max_leaf}; pass max_leaf>={known}")
    bs = rays.batch_shape
    flat = _flat_rays(rays)
    dev = flat.org.device
    root_f = None if root is None else torch.as_tensor(
        root, device=dev).reshape(-1).long()
    lists = _walk_multi(
        _table(scene.nodes, dev), _table(scene.soup, dev),
        int(scene.num_nodes), flat.org, flat.dir, flat.min_t, flat.max_t,
        root_f, options, int(max_leaf), int(max_intersections))
    return _finish(*lists, bs)


# ---------------------------------------------------------------------------
# oracle
# ---------------------------------------------------------------------------


def brute_force_multi_hit(
    mesh: tri.TriangleMesh,
    rays: Rays,
    max_intersections: int = 8,
    options: BVHTraceOptions = BVHTraceOptions(),
    chunk_size: int = 512,
) -> MultiHits:
    """O(n) K-nearest oracle for multi-hit tests: every triangle, a chunk
    of ``chunk_size`` at a time, pruned by the running K-th best."""
    K = int(max_intersections)
    bs = rays.batch_shape
    flat = _flat_rays(rays)
    dev = flat.org.device
    verts = torch.as_tensor(mesh.vertices, device=dev)
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    n_faces = faces.shape[0]
    R = flat.org.shape[0]
    ctx = tri.triangle_prepare(tri.TriangleMesh(verts, faces), flat)
    coeffs = tri.RayCoeffs(*(c[:, None] for c in ctx.coeffs))
    t_l, u_l, v_l, id_l = _empty_lists(R, K, flat.dtype, dev)
    chunk = min(chunk_size, max(n_faces, 1))
    for a in range(0, n_faces, chunk):
        ids = torch.arange(a, min(a + chunk, n_faces), device=dev)
        p0, p1, p2 = tri.gather_triangle_vertices(verts, faces[ids])
        t_cap = torch.minimum(t_l[:, K - 1], flat.max_t)
        valid, tt, uu, vv = tri.intersect_triangles(
            coeffs, ctx.org[:, None, :], ctx.min_t[:, None],
            t_cap[:, None], p0, p1, p2,
            cull_back_face=options.cull_back_face,
            exact_edge_fallback=options.exact_edge_fallback)
        valid = apply_trace_filters(valid, ids, options.prim_ids_range,
                                    options.skip_prim_id)
        t_l, u_l, v_l, id_l = _merge_klists(
            t_l, u_l, v_l, id_l, valid, tt, uu, vv, ids.expand(valid.shape))
    return _finish(t_l, u_l, v_l, id_l, bs)
