"""Wavefront skip-link traversal over the packed tables (port of
``nanort_tpu.traverse.wavefront``; plain XLA there, plain torch here).

Every ray walks the binary BVH of ``traverse/packed.py`` in DFS preorder
with one cursor and no stack: a hit branch advances to ``cur + 1`` (its
left child), a miss or a tested leaf jumps to the node's escape index
``skip[cur]``. The order is fixed, not near-first, so the shrinking hit
distance is the only pruning; records equal the reference's except
which of several exactly-equal-t prims wins.

The JAX package splits each tile's walk into a node phase and a leaf
phase (while-while) and maps over tiles; each ray's sequence of node
tests and leaf tests is its own, so the records depend on neither. Here
every step moves each live ray one node and tests the leaf it lands on
in the same step, over the whole batch at once (chunks of
``CHUNK_RAYS`` bound the memory; ``tile`` is accepted for the JAX
signature and changes nothing). Learning whether a ray is still live
needs a host sync, so the live set is compacted only every
``SYNC_EVERY`` steps; finished rays ride along masked in between.
"""

from __future__ import annotations

import torch

from ..core.math import safe_inverse
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from ..ops import triangle as tri
from ..ops.protocol import apply_trace_filters
from .packed import PackedScene

SYNC_EVERY = 8  # walk steps between live-set compactions (host syncs)
CHUNK_RAYS = 1 << 22  # rays walked at once (bounds the leaf-test temporaries)
MAX_MULT = 1.00000024  # 4-ulp exit-plane multiplier (core/aabb.max_mult)


def _slab(row, o, inv, neg, min_t, t_best):
    """Robust slab test of gathered (m, 12) node rows (reference
    IntersectRayAABB, nanort.h:2284-2325): planes by the ray's sign,
    4-ulp inflated exits, NaN-skipping where-folds."""
    lo = torch.where(neg, row[:, 3:6], row[:, 0:3])
    hi = torch.where(neg, row[:, 0:3], row[:, 3:6])
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv * MAX_MULT
    tmin, tmax = min_t, t_best
    for a in range(3):
        tmin = torch.where(t0[:, a] > tmin, t0[:, a], tmin)
        tmax = torch.where(t1[:, a] < tmax, t1[:, a], tmax)
    return tmin <= tmax


def _table(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"packed tables are on {x.device}, rays on "
                             f"{device}: move them to the rays' device")
        return x
    return torch.as_tensor(x).to(device)


def _walk(nodes, soup, n, org, dir, min_t, max_t, skip, root, options,
          max_leaf):
    """Skip-link walk of flat rays; returns (t, u, v, prim_id)."""
    dev = org.device
    R = org.shape[0]
    inv_all = safe_inverse(dir)
    neg_all = dir < 0
    co_all = tri.ray_coeffs(dir)
    lpos = torch.arange(max_leaf, device=dev)
    last_row = soup.shape[0] - 1
    big = torch.finfo(torch.float32).max

    t_out = max_t.clone()
    u_out = torch.zeros_like(t_out)
    v_out = torch.zeros_like(t_out)
    pid_out = torch.full((R,), INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE,
                         device=dev)
    start = torch.zeros(R, dtype=torch.int64, device=dev) if root is None \
        else root
    # an empty interval starts done, as the JAX package's padding lanes
    cur = torch.where(max_t < min_t, n, start)
    idx = torch.arange(R, device=dev)
    t, u, v, pid = (x.clone() for x in (t_out, u_out, v_out, pid_out))
    step = 0
    while True:
        if step % SYNC_EVERY == 0:
            t_out[idx], u_out[idx], v_out[idx], pid_out[idx] = t, u, v, pid
            keep = (cur < n).nonzero().squeeze(1)
            if keep.numel() == 0:
                break
            idx, cur = idx[keep], cur[keep]
            t, u, v, pid = t_out[idx], u_out[idx], v_out[idx], pid_out[idx]
            o, inv, neg = org[idx], inv_all[idx], neg_all[idx]
            mn = min_t[idx]
            co = tri.RayCoeffs(*(c[idx][:, None] for c in co_all))
            sk = None if skip is None else skip[idx]
        step += 1
        active = cur < n
        row = nodes[cur.clamp(max=n - 1)]
        hit = _slab(row, o, inv, neg, mn, t) & active
        ints = row[:, 6:9].view(torch.int32).long()
        cnt, off, skp = ints[:, 0], ints[:, 1], ints[:, 2]
        leaf = hit & (cnt > 0)
        # leaf phase, masked to the rays whose step reached a leaf
        srow = soup[(off[:, None] + lpos).clamp(0, last_row)]
        valid, tt, uu, vv = tri.intersect_triangles(
            co, o[:, None, :], mn[:, None], t[:, None], srow[..., 0:3],
            srow[..., 3:6], srow[..., 6:9],
            cull_back_face=options.cull_back_face,
            exact_edge_fallback=options.exact_edge_fallback)
        pids = srow[..., 9].contiguous().view(torch.int32).long()
        valid &= (lpos < cnt[:, None]) & leaf[:, None]
        valid = apply_trace_filters(
            valid, pids, options.prim_ids_range,
            sk if sk is not None else options.skip_prim_id)
        t_m = torch.where(valid, tt, big)
        t_leaf = t_m.amin(1)
        best = torch.where(valid & (t_m == t_leaf[:, None]), lpos, -1).amax(1)
        sel = best.clamp(min=0)[:, None]
        upd = (best >= 0) & (t_leaf <= t)
        t = torch.where(upd, t_leaf, t)
        u = torch.where(upd, uu.gather(1, sel)[:, 0], u)
        v = torch.where(upd, vv.gather(1, sel)[:, 0], v)
        pid = torch.where(upd, pids.gather(1, sel)[:, 0], pid)
        # a tested leaf resumes at its own escape index, never cur + 1:
        # pack_scene_multi points a sub-tree's last skip at the sentinel
        cur = torch.where(hit & ~leaf, cur + 1,
                          torch.where(active, skp, cur))
    hit = t_out < max_t
    zero = torch.zeros((), device=dev)
    return (t_out, torch.where(hit, u_out, zero),
            torch.where(hit, v_out, zero),
            torch.where(hit, pid_out, INVALID_PRIM_ID))


def traverse_wavefront(scene: PackedScene, rays: Rays,
                       options: BVHTraceOptions = BVHTraceOptions(),
                       skip_prim_id=None, max_leaf: int | None = 4,
                       tile: int = 16384, root=None) -> Hits:
    """Trace a float32 ray batch against a packed scene. ``root``
    optionally gives each ray its start node (multi-mesh tables,
    ``pack_scene_multi``). ``max_leaf`` may be None to use the scene's
    recorded largest leaf; an explicit value smaller than it raises
    (primitives past it would be silently skipped). ``skip_prim_id``: an
    optional per-ray tensor overriding ``options.skip_prim_id``.
    ``tile`` changes nothing (see the module note)."""
    known = getattr(scene, "max_leaf", None)
    if max_leaf is None:
        if known is None:
            raise ValueError(
                "max_leaf=None needs a PackedScene built by pack_scene "
                "(this one carries no leaf-size record)")
        max_leaf = max(known, 1)
    elif known is not None and known > max_leaf:
        raise ValueError(
            f"packed scene has leaves holding {known} primitives but "
            f"max_leaf={max_leaf}; pass max_leaf>={known} (or None)")
    bs = rays.batch_shape
    dev = rays.org.device
    if rays.org.dtype != torch.float32:
        raise ValueError("traverse_wavefront traces float32 rays")
    nodes = _table(scene.nodes, dev)
    soup = _table(scene.soup, dev)
    n = int(scene.num_nodes)
    org = rays.org.reshape(-1, 3)
    dir = rays.dir.reshape(-1, 3)
    min_t = rays.min_t.reshape(-1)
    max_t = rays.max_t.reshape(-1)
    R = org.shape[0]
    skip = None if skip_prim_id is None else torch.as_tensor(
        skip_prim_id, device=dev).reshape(-1).long()
    root_f = None if root is None else torch.as_tensor(
        root, device=dev).reshape(-1).long()
    parts = []
    for a in range(0, R, CHUNK_RAYS):
        b = min(a + CHUNK_RAYS, R)
        parts.append(_walk(
            nodes, soup, n, org[a:b], dir[a:b], min_t[a:b], max_t[a:b],
            None if skip is None else skip[a:b],
            None if root_f is None else root_f[a:b], options, max_leaf))
    if not parts:
        empty = torch.zeros(0, device=dev)
        parts = [(empty, empty, empty,
                  torch.zeros(0, dtype=PRIM_ID_DTYPE, device=dev))]
    return Hits(*(torch.cat(x).reshape(bs) for x in zip(*parts)))
