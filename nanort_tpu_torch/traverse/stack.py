"""Per-ray stack traversal of the binary BVH (port of
``nanort_tpu.traverse.stack``; plain XLA there, plain torch here).

The reference traces one ray at a time with an iterative depth-first loop
over a node stack, visiting the near child first by the direction sign
along the split axis (``BVHAccel::Traverse``, nanort.h:2487-2556). The
JAX package runs that loop as one ``lax.while_loop`` over per-ray state
in lockstep; here every step pops one stack entry for every live ray of
the batch, with the JAX package's rules:

* a hit branch pushes its far child, then its near one (near popped
  first), by ``dir < 0`` on the node's axis, and refuses a push that
  does not fit the stack (the subtree is dropped, never a hang);
* a leaf tests a fixed ``max_leaf`` window of its primitives, and the
  last of the window's hits at the least t wins, replacing the record
  when that t is ``<=`` the current one (last-equal-wins,
  nanort.h:1131-1139);
* a ray hits when its final ``t < max_t`` (nanort.h:2552).

So the records, ties included, are the JAX package's bit for bit, in
float32 and float64 alike. Which rays are still live is read on the host
every step, and only those take part in it: a finished ray's record no
longer changes, so dropping it changes no record.

This is the reference-exact engine: any float dtype, any primitive kind
(``traverse`` takes the protocol's ``prepare_fn``/``intersect_fn``). It
has no kernel; the fast paths are ``traverse.packet`` and
``traverse.fused_trace``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.aabb import intersect_ray_aabb
from ..core.bvh import required_max_stack
from ..core.math import safe_inverse
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from ..ops import triangle as tri
from ..ops.protocol import apply_trace_filters


def _take(tree, idx):
    """Rows ``idx`` of every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    return type(tree)(*(_take(x, idx) for x in tree))


def _traverse_batch(bvh, prims, rays: Rays, ctx, skip, options,
                    intersect_fn: Callable, max_leaf: int,
                    max_stack: int) -> Hits:
    """Lockstep traversal of a flat ray batch (fields ``(R, ...)``)."""
    dt = rays.dtype
    dev = rays.org.device
    R = rays.org.shape[0]

    def tab(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    bmin, bmax = tab(bvh.bmin, dt), tab(bvh.bmax, dt)
    flag = tab(bvh.flag, torch.int64)
    axis = tab(bvh.axis, torch.int64)
    data = tab(np.asarray(bvh.data).astype(np.int64), torch.int64)
    indices = tab(np.asarray(bvh.indices).astype(np.int64), torch.int64)

    dir_neg = rays.dir < 0  # (nanort.h:2506-2509)
    inv_dir = safe_inverse(rays.dir)
    per_ray_skip = isinstance(skip, torch.Tensor)

    stack = torch.zeros((R, max_stack), dtype=torch.int64, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)  # root at slot 0
    t = rays.max_t.clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    pid = torch.full((R,), INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE, device=dev)
    lpos = torch.arange(max_leaf, device=dev)
    big = torch.finfo(dt).max

    while True:
        i = (sp >= 0).nonzero().squeeze(1)
        if i.numel() == 0:
            break
        spi = sp[i]
        idx = stack[i, spi]
        spi = spi - 1
        nd = data[idx]  # (m, 2)
        ti = t[i]
        box_hit, _, _ = intersect_ray_aabb(
            bmin[idx], bmax[idx], rays.org[i], inv_dir[i], dir_neg[i],
            rays.min_t[i], ti)
        is_leaf = flag[idx] == 1

        # ---- branch: push far then near (near popped first)
        near_sel = dir_neg[i].gather(1, axis[idx][:, None])[:, 0]
        near = torch.where(near_sel, nd[:, 1], nd[:, 0])
        far = torch.where(near_sel, nd[:, 0], nd[:, 1])
        push = box_hit & ~is_leaf & (spi + 2 <= max_stack - 1)
        pi, ps = i[push], spi[push]
        stack[pi, ps + 1] = far[push]
        stack[pi, ps + 2] = near[push]
        sp[i] = torch.where(push, spi + 2, spi)

        # ---- leaf: masked fixed-window primitive test
        leaf = box_hit & is_leaf
        li = i[leaf]
        t_l = ti[leaf]
        count, offset = nd[leaf, 0], nd[leaf, 1]
        lval = lpos < count[:, None]
        lidx = torch.where(lval, offset[:, None] + lpos, 0)
        pids = indices[lidx]
        valid, tt, uu, vv = intersect_fn(prims, _take(ctx, li), pids, t_l)
        valid = valid & lval
        valid = apply_trace_filters(valid, pids, options.prim_ids_range,
                                    skip[li] if per_ray_skip else skip)
        # replace-on-<= with last-equal-wins inside the leaf window
        t_m = torch.where(valid, tt, big)
        t_best = t_m.amin(-1)
        best = torch.where(valid & (t_m == t_best[:, None]), lpos,
                           -1).amax(-1)
        sel = best.clamp(min=0)[:, None]
        upd = (best >= 0) & (t_best <= t_l)
        t[li] = torch.where(upd, t_best, t_l)
        u[li] = torch.where(upd, uu.gather(1, sel)[:, 0], u[li])
        v[li] = torch.where(upd, vv.gather(1, sel)[:, 0], v[li])
        pid[li] = torch.where(upd, pids.gather(1, sel)[:, 0], pid[li])

    hit = t < rays.max_t  # nanort.h:2552
    zero = torch.zeros((), dtype=dt, device=dev)
    return Hits(t, torch.where(hit, u, zero), torch.where(hit, v, zero),
                torch.where(hit, pid, INVALID_PRIM_ID))


def _auto_max_stack(bvh) -> int:
    """Stack slots sized from the tree's depth (never overflows). The
    JAX package memoises this and falls back to 512 for arrays traced
    inside ``jit``; the port's trees are host arrays, read every call."""
    return required_max_stack(bvh)


def _actual_max_leaf(bvh) -> int:
    """Largest primitive count in any leaf of this tree."""
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data)
    leaf = flag == 1
    return int(data[leaf, 0].max()) if leaf.any() else 0


def traverse(bvh, prims, rays: Rays,
             options: BVHTraceOptions = BVHTraceOptions(), *,
             prepare_fn: Callable, intersect_fn: Callable, max_leaf: int,
             skip_prim_id=None, max_stack: int | None = None) -> Hits:
    """Generic BVH traversal for any primitive kind (see ``ops.protocol``
    and ``ops.triangle.make_triangle_intersect``).

    ``max_stack=None`` (default) sizes the per-ray stack from the tree's
    depth. ``max_leaf`` may be None to size the leaf window from the
    tree; an explicit value smaller than the tree's largest leaf raises
    (primitives past the window would be skipped silently).
    ``skip_prim_id``: an optional per-ray tensor overriding
    ``options.skip_prim_id``. Rays keep their batch shape."""
    if max_stack is None:
        max_stack = _auto_max_stack(bvh)
    actual = _actual_max_leaf(bvh)
    if max_leaf is None:
        max_leaf = max(actual, 1)
    elif actual > max_leaf:
        raise ValueError(
            f"BVH has leaves holding {actual} primitives but max_leaf="
            f"{max_leaf}; primitives past the unroll bound would be "
            f"silently skipped — pass max_leaf>={actual} (or None)")
    bs = rays.batch_shape
    flat = Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                rays.min_t.reshape(-1), rays.max_t.reshape(-1))
    if skip_prim_id is None:
        skip = options.skip_prim_id
    else:
        skip = torch.as_tensor(skip_prim_id, device=flat.org.device)
        skip = skip.reshape(-1).long()
    ctx = prepare_fn(prims, flat)
    hits = _traverse_batch(bvh, prims, flat, ctx, skip, options,
                           intersect_fn, int(max_leaf), int(max_stack))
    return Hits(*(x.reshape(bs) for x in hits))


def traverse_triangles(bvh, mesh: tri.TriangleMesh, rays: Rays,
                       options: BVHTraceOptions = BVHTraceOptions(),
                       skip_prim_id=None, max_leaf: int = 4,
                       max_stack: int | None = None) -> Hits:
    """Triangle-mesh traversal (reference ``BVHAccel<float>::Traverse`` +
    ``TriangleIntersector``). ``mesh`` fields may be NumPy arrays or
    tensors; they are moved to the rays' device."""
    dev = rays.org.device
    mesh = tri.TriangleMesh(
        torch.as_tensor(mesh.vertices, device=dev),
        torch.as_tensor(mesh.faces, device=dev).long())
    intersect_fn = tri.make_triangle_intersect(
        cull_back_face=options.cull_back_face,
        exact_edge_fallback=options.exact_edge_fallback)
    return traverse(bvh, mesh, rays, options,
                    prepare_fn=tri.triangle_prepare,
                    intersect_fn=intersect_fn, max_leaf=max_leaf,
                    skip_prim_id=skip_prim_id, max_stack=max_stack)
