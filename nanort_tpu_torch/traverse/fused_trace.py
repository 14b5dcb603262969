"""BVH16 trace for the fused path tracer (port of
``nanort_tpu.traverse.fused_trace``).

The TPU package's ``make_tracer`` (K2) is a trace primitive that its
megakernels call in-kernel; here it is the CUDA device function
``csrc/bvh16_trace.cuh::bvh16::trace``, which ``csrc/pt_fused.cu`` (K4)
calls the same way. ``trace_bvh16`` launches it on its own
(``csrc/bvh16_trace.cu``), so it can be held against its plain torch
version, ``trace_bvh16_reference``: a batched per-ray stack walk with the
same child order and the same arithmetic, which agrees with the kernel
bit for bit. On CPU tensors ``trace_bvh16`` runs the plain version.

Semantics are make_tracer's, with its two intersectors (see the note at
the top of ``bvh16_trace.cuh``): ``"mt"`` (Moller-Trumbore, the path
tracer's) and ``"watertight"`` (with the Dekker exact-edge recompute, the
fused AO pass's), and its per-ray ``skip`` of one prim id. They differ
from ``traverse_bvh8`` (K1) in ways that are part of the contract: slab
folds propagate NaN (a child whose slab gives ``0 * inf`` is not
visited), a closest hit at exactly ``tt == tmax`` is a miss (occlusion
counts it), and the watertight ``t`` is
``((U (shz Az) + V (shz Bz)) + W (shz Cz)) / det`` with no ``det != 0``
test. Equal-t ties: the child order comes from each ray's own octant, so
``prim_id`` may differ from the JAX package's only between hits at
exactly equal t.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import safe_inverse
from ..core.ray import Rays
from ..ops.triangle import _exact_prod_diff, ray_coeffs
from ..utils import trace
from . import _ext
from .packet import _table, stack_slots

LANES = 128
STACK_CAP = 512  # bvh16::kStackCap in csrc/bvh16_trace.cuh
BIG = 3.0e38  # degenerate-ray threshold
MAX_MULT = 1.00000024  # 4-ulp exit-plane multiplier

# Launches that run K2, by leaf test, counted in utils.trace:
# trace_bvh16's own kernel, every launch of the BVH path-tracing
# megakernel (models/pt_fused.render_fused_bvh, "mt") and of the fused AO
# pass (models/ao_fused.render_ao_fused, "watertight"), which run K2
# inside. The plain versions never count.
LAUNCH_KEYS = ("bvh16_trace", "bvh16_trace_watertight")
trace.declare_launches(*LAUNCH_KEYS)
INTERSECTORS = ("mt", "watertight")


def required_stack_slots(depth: int, width: int = 16) -> int:
    """The TPU kernel's shared SMEM stack bound for one in-flight DFS
    line (pop_n=1). The port's per-ray stack needs only
    ``traverse.packet.stack_slots``."""
    return max(64, width * depth + 64)


@trace.span("build.aux")
def build_aux_rows(leafs: np.ndarray, material_ids, faces, vertices,
                   max_leaf: int, gn_unit=None) -> np.ndarray:
    """Per-leaf-row aux table, parallel to the watertight leaf rows
    (host NumPy, a copy of the JAX package's).

    Layout per (1, 128) f32 row (t = slot 0..max_leaf-1):
      lanes [3t, 3t+3)   unit geometric normal of triangle t
                         (normalize(cross(e1, e2)) in f32 — the same
                         value models/path_tracer.make_pt_scene bakes
                         into face_table column 0)
      lane  32 + t       material id (exact float integer)
      lane  48 + t       prim id (exact float integer, mirrors leaf
                         lane 90+t so woop leaf tables can share it)
    """
    leafs = np.asarray(leafs)
    n_rows = leafs.shape[0]
    aux = np.zeros((n_rows, LANES), np.float32)
    mids = np.asarray(material_ids, np.int64)
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    pid = leafs[:, 90:90 + max_leaf].astype(np.int64)
    # empty slots carry pid 0-padding in some builders; clamp and rely on
    # the kernel's (ti < cnt) mask like every other consumer
    pid_c = np.clip(pid, 0, f.shape[0] - 1)
    if gn_unit is not None:
        # caller-supplied unit normals (face_table column 0), so the BVH
        # route reads bit-identical normals to the brute route
        gn = np.asarray(gn_unit, np.float32)[pid_c]
    else:
        p0 = v[f[pid_c, 0]]
        p1 = v[f[pid_c, 1]]
        p2 = v[f[pid_c, 2]]
        gn = np.cross(p1 - p0, p2 - p0)
        norm = np.maximum(
            np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
        gn = (gn / norm).astype(np.float32)
    for t in range(max_leaf):
        aux[:, 3 * t:3 * t + 3] = gn[:, t]
        aux[:, 32 + t] = mids[pid_c[:, t]].astype(np.float32)
        aux[:, 48 + t] = pid[:, t].astype(np.float32)
    return aux


class TraceRecord(NamedTuple):
    """Closest-hit record of ``trace_bvh16``: ``t`` (tmax on a miss),
    ``u``/``v``, ``prim_id`` int32 (-1 on a miss), ``hit`` bool, and with
    ``want_aux`` the aux row's ``material_id`` int32 (0 on a miss) and
    unit geometric ``normal`` (R, 3) (zero on a miss)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_id: torch.Tensor
    hit: torch.Tensor
    material_id: torch.Tensor | None = None
    normal: torch.Tensor | None = None


def _check_tables(scene, aux, dev):
    if scene.width != 16:
        raise ValueError(f"the fused trace walks BVH16 tables: width "
                         f"{scene.width}")
    slots = stack_slots(scene)
    if slots > STACK_CAP:
        raise ValueError(f"scene depth {scene.depth} needs {slots} stack "
                         f"slots, the kernel holds {STACK_CAP}")
    tabs = [_table(scene.nodes, dev), _table(scene.leafs, dev)]
    if aux is not None:
        tabs.append(_table(aux, dev))
    for tab in tabs:
        if (tab.dtype != torch.float32 or tab.ndim != 2
                or tab.shape[1] != LANES or not tab.is_contiguous()):
            raise ValueError(f"BVH16 tables must be contiguous float32 "
                             f"(rows, {LANES})")
        if dev.type == "cuda" and tab.data_ptr() % 16:
            raise ValueError("BVH16 tables must be 16-byte aligned")
    if aux is not None and tabs[2].shape[0] != tabs[1].shape[0]:
        raise ValueError("aux rows must parallel the leaf rows")
    return tabs[0], tabs[1], (tabs[2] if aux is not None else None), slots


def trace_bvh16(scene, rays: Rays, aux=None, occlusion: bool = False,
                want_aux: bool = False, intersector: str = "mt",
                skip=None):
    """Trace flat ``rays`` (``(R, 3)`` org/dir, ``(R,)`` min_t/max_t,
    contiguous float32) through a BVH16 scene (``collapse_bvh8(...,
    width=16)``, tables on the rays' device).

    ``occlusion=True`` returns a bool tensor: some hit in
    ``[min_t, max_t]``. Otherwise returns a ``TraceRecord``; ``want_aux``
    also reads the material id and geometric normal from ``aux``
    (``build_aux_rows``). ``intersector``: ``"mt"`` or ``"watertight"``.
    ``skip``: an optional per-ray int tensor, the prim id each ray does
    not hit (-1: none). On CUDA tensors this launches the K2 kernel; on
    CPU tensors it runs ``trace_bvh16_reference``."""
    if want_aux and (aux is None or occlusion):
        raise ValueError("want_aux needs aux rows and closest-hit mode")
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")
    dev = rays.org.device
    for name in ("org", "dir", "min_t", "max_t"):
        x = getattr(rays, name)
        if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"rays.{name} must be contiguous float32 on {dev}")
    org, dir = rays.org.view(-1, 3), rays.dir.view(-1, 3)
    tmin, tmax = rays.min_t.view(-1), rays.max_t.view(-1)
    n = org.shape[0]
    if tmin.shape[0] != n or tmax.shape[0] != n:
        raise ValueError("one min_t and one max_t per ray")
    if skip is not None:
        skip = torch.as_tensor(skip, device=dev).reshape(-1).to(torch.int32)
        if skip.shape[0] != n:
            raise ValueError("skip must hold one prim id per ray")
    nodes, leafs, aux_t, slots = _check_tables(
        scene, aux if want_aux else None, dev)
    if dev.type == "cpu":
        return trace_bvh16_reference(nodes, leafs, aux_t, org, dir, tmin,
                                     tmax, occlusion, slots,
                                     intersector=intersector, skip=skip)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    hit = torch.empty(n, **i32)
    err = torch.zeros(1, **i32)
    if occlusion:
        t = u = v = pid = mid = gn = None
    else:
        t, u, v = (torch.empty(n, **f32) for _ in range(3))
        pid = torch.empty(n, **i32)
        mid = torch.empty(n, **i32) if want_aux else None
        gn = torch.empty((n, 3), **f32) if want_aux else None
    _ext.launch(
        "bvh16_trace", "nrt_bvh16_trace", nodes, leafs, aux_t, org, dir, tmin,
        tmax, skip, t, u, v, pid, hit, mid, gn, err, n, slots, int(occlusion),
        int(want_aux), int(intersector == "watertight"), device=dev,
        count=("bvh16_trace_watertight" if intersector == "watertight"
               else "bvh16_trace"))
    check_overflow(err, slots)
    if occlusion:
        return hit.bool()
    return TraceRecord(t, u, v, pid, hit.bool(), mid, gn)


def check_overflow(err: torch.Tensor, slots: int):
    """Fail the stream, without a host sync, if a kernel's per-ray stack
    overflowed (only possible when ``scene.depth`` does not describe the
    tables, which ``BVH8Scene.to`` rules out)."""
    torch._assert_async(err == 0, f"BVH16 trace stack overflow ({slots} "
                        "slots): scene.depth does not describe the tables")


def _mt_test(tri, o, d, s_min, t_cur):
    """Moller-Trumbore on (m, 10) leaf slots of (p0, p1, p2) rows against
    m rays (nanort_tpu/traverse/fused_trace.py:264-291): ``(ok, tt, u,
    v)``."""
    one = torch.ones((), device=tri.device)
    p0x, p0y, p0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3] - p0x, tri[..., 4] - p0y, tri[..., 5] - p0z
    e2x, e2y, e2z = tri[..., 6] - p0x, tri[..., 7] - p0y, tri[..., 8] - p0z
    dx, dy, dz = (d[:, k, None] for k in range(3))
    ox, oy, oz = (o[:, k, None] for k in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    invd = one / torch.where(det == 0.0, one, det)
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    uu = (tx * pvx + ty * pvy + tz * pvz) * invd
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * invd
    tt = (e2x * qx + e2y * qy + e2z * qz) * invd
    ok = ((det != 0.0) & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt >= s_min[:, None]) & (tt <= t_cur[:, None]))
    return ok, tt, uu, vv


def _watertight_test(tri, o, co, s_min, t_cur):
    """make_tracer's watertight test on (m, 10) leaf slots against m rays
    with shear coefficients ``co`` (nanort_tpu/traverse/fused_trace.py:
    329-370): shear-space edge functions, their Dekker recompute when any
    is exactly zero, ``t = (U (shz Az) + V (shz Bz) + W (shz Cz)) / det``
    with no det test (a zero det gives a NaN t that fails the range
    tests). Returns ``(ok, tt, u, v)``."""

    def comp(x, y, z, k):
        return torch.where(k == 0, x, torch.where(k == 1, y, z))

    a = [tri[..., c] - o[:, c, None] for c in range(3)]
    b = [tri[..., 3 + c] - o[:, c, None] for c in range(3)]
    c3 = [tri[..., 6 + c] - o[:, c, None] for c in range(3)]
    kx, ky, kz, shx, shy, shz = (x[:, None] for x in co)
    Az, Bz, Cz = comp(*a, kz), comp(*b, kz), comp(*c3, kz)
    Ax = comp(*a, kx) - shx * Az
    Ay = comp(*a, ky) - shy * Az
    Bx = comp(*b, kx) - shx * Bz
    By = comp(*b, ky) - shy * Bz
    Cx = comp(*c3, kx) - shx * Cz
    Cy = comp(*c3, ky) - shy * Cz
    U = Cx * By - Cy * Bx
    V = Ax * Cy - Ay * Cx
    W = Bx * Ay - By * Ax
    zm = (U == 0.0) | (V == 0.0) | (W == 0.0)
    U = torch.where(zm, _exact_prod_diff(Cx, By, Cy, Bx), U)
    V = torch.where(zm, _exact_prod_diff(Ax, Cy, Ay, Cx), V)
    W = torch.where(zm, _exact_prod_diff(Bx, Ay, By, Ax), W)
    # NaN-propagating min/max, as jnp.minimum / jnp.maximum
    edge_ok = ((torch.minimum(torch.minimum(U, V), W) >= 0.0)
               | (torch.maximum(torch.maximum(U, V), W) <= 0.0))
    det = U + V + W
    rcp = torch.ones_like(det) / det
    tt = (U * (shz * Az) + V * (shz * Bz) + W * (shz * Cz)) * rcp
    ok = edge_ok & (tt >= s_min[:, None]) & (tt <= t_cur[:, None])
    return ok, tt, V * rcp, W * rcp


def trace_bvh16_reference(nodes, leafs, aux, org, dir, tmin, tmax,
                          occlusion: bool, slots: int, stats=None,
                          intersector: str = "mt", skip=None):
    """Plain torch version of K2 on flat rays: a batched per-ray stack
    walk in the kernel's child order with the kernel's arithmetic (every
    product its own op, true divisions, NaN-propagating folds). Every
    loop step pops one entry for every live ray: node entries slab-test
    16 children and push the hits far-first; leaf entries run the
    ``intersector``'s test on their triangles, less those of the ray's
    ``skip`` prim id (an int tensor, -1 for none, or None). Returns what
    ``trace_bvh16`` returns. ``stats``, a dict, gains the work this batch
    needed: ``"nodes"`` popped and triangles tested (``"tris"``)."""
    dev = org.device
    n = org.shape[0]
    inf = float("inf")
    okr = ((org.abs() < BIG).all(1) & (dir.abs() < BIG).all(1)
           & (dir.abs().sum(1) > 0))
    o = torch.where(okr[:, None], org, 0.0)
    d = torch.where(okr[:, None], dir,
                    torch.tensor([1.0, 0.0, 0.0], device=dev))
    s_min = torch.where(okr, tmin, inf)
    s_max = torch.where(okr, tmax, inf)
    inv = safe_inverse(d)
    neg = d < 0
    # the watertight shear, per ray (nanort_tpu/traverse/fused_trace.py:
    # 183-195)
    co = ray_coeffs(d) if intersector == "watertight" else None

    t_b = s_max.clone()
    u_b = torch.zeros(n, device=dev)
    v_b = torch.zeros(n, device=dev)
    p_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    m_b = torch.zeros(n, dtype=torch.int32, device=dev)
    g_b = torch.zeros((n, 3), device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    # column ``slots`` is a write sink for children that are not pushed
    stack = torch.zeros((n, slots + 1), dtype=torch.int64, device=dev)
    # the root sits in slot 0; a ray with an empty [s_min, s_max] passes
    # no slab and no triangle, so it does not walk at all
    sp = (s_min <= s_max).long()
    ar_w = torch.arange(16, device=dev)
    ar_l = torch.arange(10, device=dev)

    while True:
        live = sp > 0
        if occlusion:
            live &= ~found
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]

        # ---- node entries: slab-test 16 children, push hits far-first
        ni = idx[e >= 0]
        if stats is not None:
            stats["nodes"] = stats.get("nodes", 0) + int(ni.numel())
            stats["tris"] = stats.get("tris", 0) + int(
                ((-1 - e[e < 0]) & 15).sum())
        if ni.numel():
            rows = nodes.index_select(0, e[e >= 0])
            m = ni.shape[0]
            box = rows[:, :96].view(m, 16, 6)
            v112 = rows[:, 112]
            axis = torch.where(v112 >= 32, 2, torch.where(v112 >= 16, 1, 0))
            nn = neg[ni][:, None, :]
            lo = torch.where(nn, box[..., 3:6], box[..., 0:3])
            hi = torch.where(nn, box[..., 0:3], box[..., 3:6])
            on = o[ni][:, None, :]
            iv = inv[ni][:, None, :]
            t0 = (lo - on) * iv
            t1 = (hi - on) * iv * MAX_MULT
            # NaN-propagating folds in make_tracer's grouping
            t0 = torch.maximum(torch.maximum(t0[..., 0], t0[..., 1]),
                               torch.maximum(t0[..., 2], s_min[ni][:, None]))
            t1 = torch.minimum(torch.minimum(t1[..., 0], t1[..., 1]),
                               torch.minimum(t1[..., 2], t_b[ni][:, None]))
            hit = t0 <= t1
            neg_axis = neg[ni].gather(1, axis[:, None])[:, 0]
            order = torch.where(neg_axis[:, None], ar_w, 15 - ar_w)
            push = hit.gather(1, order)
            meta = rows[:, 96:112].gather(1, order).long()
            cnt = rows[:, 112:128].gather(1, order).long() & 15
            entry = torch.where(meta >= 0, meta, -1 - (((-meta - 1) << 4) | cnt))
            sp_n = sp[ni]
            pos = sp_n[:, None] + push.long().cumsum(1) - 1
            new_sp = sp_n + push.sum(1)
            if bool((new_sp > slots).any()):
                raise RuntimeError(
                    f"BVH16 trace stack overflow ({slots} slots): "
                    "scene.depth does not describe the tables")
            pos = torch.where(push, pos, slots)
            stack[ni[:, None].expand(m, 16), pos] = entry
            sp[ni] = new_sp

        # ---- leaf entries: the leaf test on the row's triangles
        li = idx[e < 0]
        if li.numel():
            packed = -1 - e[e < 0]
            row_i = packed >> 4
            rows = leafs.index_select(0, row_i)
            cnt = packed & 15
            m = li.shape[0]
            tri = rows[:, :90].view(m, 10, 9)
            tc = t_b[li]
            if co is None:
                ok, tt, uu, vv = _mt_test(tri, o[li], d[li], s_min[li], tc)
            else:
                ok, tt, uu, vv = _watertight_test(
                    tri, o[li], [x[li] for x in co], s_min[li], tc)
            ok &= ar_l < cnt[:, None]
            if skip is not None:
                ok &= rows[:, 90:100].int() != skip[li][:, None]
            any_ok = ok.any(1)
            if occlusion:
                # the first accepted slot ends the ray: t := -(tt + 1)
                sel = torch.where(ok, ar_l, 10).amin(1).clamp(max=9)[:, None]
                t_b[li] = torch.where(any_ok, -tt.gather(1, sel)[:, 0] - 1.0, tc)
                found[li] |= any_ok
                continue
            # sequential replace-on-<= keeps the LAST slot holding the
            # minimum accepted t
            t_min = torch.where(ok, tt, inf).amin(1)
            sel = torch.where(ok & (tt == t_min[:, None]), ar_l, -1).amax(1)
            sel = sel.clamp(min=0)[:, None]
            t_b[li] = torch.where(any_ok, tt.gather(1, sel)[:, 0], tc)
            u_b[li] = torch.where(any_ok, uu.gather(1, sel)[:, 0], u_b[li])
            v_b[li] = torch.where(any_ok, vv.gather(1, sel)[:, 0], v_b[li])
            pid = rows[:, 90:100].gather(1, sel)[:, 0].int()
            p_b[li] = torch.where(any_ok, pid, p_b[li])
            if aux is not None:
                arow = aux.index_select(0, row_i)
                mid = arow[:, 32:42].gather(1, sel)[:, 0].int()
                m_b[li] = torch.where(any_ok, mid, m_b[li])
                gn = arow[:, :30].view(m, 10, 3).gather(
                    1, sel[:, :, None].expand(m, 1, 3))[:, 0]
                g_b[li] = torch.where(any_ok[:, None], gn, g_b[li])

    if occlusion:
        return t_b < 0.0
    hit = (t_b < s_max) & okr & (s_max > s_min)
    zero = torch.zeros((), device=dev)
    rec = TraceRecord(
        torch.where(hit, t_b, tmax), torch.where(hit, u_b, zero),
        torch.where(hit, v_b, zero), torch.where(hit, p_b, -1), hit)
    if aux is None:
        return rec
    return rec._replace(material_id=torch.where(hit, m_b, 0),
                        normal=torch.where(hit[:, None], g_b, zero))
