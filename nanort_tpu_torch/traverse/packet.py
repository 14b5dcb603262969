"""Wide-BVH traversal of coherent ray batches (port of the public surface
of ``nanort_tpu.traverse.pallas_packet``).

``traverse_bvh8`` traces rays through the BVH8/BVH16 tables of
``build.bvh8.collapse_bvh8``: closest-hit or any-hit (``occlusion``),
the watertight intersector with the Dekker exact-edge fallback or the
Woop unit-triangle test (``intersector="woop"``, over ``leafs_woop``),
and the skip / prim-range / back-face filters. On CUDA tensors it
launches the hand-written kernel ``csrc/packet_traverse.cu`` (one thread
per ray, a private stack); on CPU tensors it runs ``_traverse_reference``,
the plain torch version of the same per-ray traversal — the same child
order and the same arithmetic, so the two agree bit for bit.

Equal-t ties: the last equal-t hit in this per-ray near-first order
wins. The TPU kernel's order is packet-granular, so ``prim_id`` may
legally differ from the JAX package's at exactly equal t.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..build.bvh8 import BVH8Scene
from ..core.math import safe_inverse
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID, PRIM_RANGE_MAX
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from ..ops.triangle import (RayCoeffs, TriangleMesh, intersect_triangles,
                            ray_coeffs)
from . import _ext

LANES = 128
DEF_SUB = 32  # rays per packet / LANES in the TPU kernel (specialization)
STACK_CAP = 512  # kStackCap in csrc/packet_traverse.cu
BIG = 3.0e38  # degenerate-ray threshold
MAX_MULT = 1.00000024  # 4-ulp exit-plane multiplier (core/aabb.max_mult)

# Kernel launches made by traverse_bvh8 (never by the plain version),
# by leaf test: "packet_traverse" (watertight), "packet_traverse_woop".
LAUNCHES = {"packet_traverse": 0, "packet_traverse_woop": 0}
INTERSECTORS = ("watertight", "woop")
WOOP_MAX_LEAF = 9  # 12 lanes a triangle + the prim-id block at lane 108


def stack_slots(scene: BVH8Scene) -> int:
    """Per-ray stack entries that can never overflow for ``scene``.

    The TPU kernel sizes its shared packet stack from ``scene.depth`` and
    ``width`` (pallas_packet.py:2239-2245); a private near-first stack
    needs less: popping a node pushes at most ``width`` children and one
    of them is popped next, so each of the ``depth`` node levels leaves
    at most ``width - 1`` entries behind, plus one for the deepest
    level's last child."""
    return scene.depth * (scene.width - 1) + 1


def _well_formed(org: torch.Tensor, dir: torch.Tensor) -> torch.Tensor:
    """Rays the kernel traces; the rest (NaN/inf or |x| >= 3e38 origin or
    direction, zero direction) are degenerate and must miss
    (pallas_packet.py:138-162)."""
    return ((org.abs() < BIG).all(1) & (dir.abs() < BIG).all(1)
            & (dir.abs().sum(1) > 0))


def _check_specialize(specialize):
    """Validate ``specialize`` as the JAX package does
    (pallas_packet.py:2007-2018). Its rewrites are bit-exact, so this
    port accepts them and runs the general kernel."""
    if specialize is None:
        return
    kz_static = (tuple(specialize) + (False,))[0]
    if kz_static not in (None, 0, 1, 2):
        raise ValueError(f"kz_static must be None/0/1/2: {kz_static}")


def _table(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"scene tables are on {x.device}, rays on {device}: move "
                "the scene with scene.to(device)")
        return x
    if device.type != "cpu":
        raise ValueError("scene tables are host arrays: move them with "
                         "scene.to(device)")
    return torch.as_tensor(x)


def _flat(x: torch.Tensor, trailing: tuple, name: str) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"rays.{name} must be contiguous")
    return x.view((-1,) + trailing)


def traverse_bvh8(scene: BVH8Scene, rays: Rays,
                  options: BVHTraceOptions = BVHTraceOptions(),
                  skip_prim_id=None, occlusion: bool = False,
                  specialize: tuple | None = None,
                  intersector: str = "watertight") -> Hits:
    """Trace ``rays`` against a BVH8/BVH16 scene (float32).

    ``occlusion=True`` is the any-hit mode: each ray stops at its first
    accepted hit and reports that hit (t is its distance, not
    necessarily the closest). ``skip_prim_id`` is an optional per-ray
    tensor overriding ``options.skip_prim_id``. ``specialize`` is
    accepted for API parity (``detect_specialization``) and validated.

    ``intersector="woop"`` tests the triangles of ``scene.leafs_woop``
    (``collapse_bvh8(..., woop=True)``, at most 9 a row) with the Woop
    unit-triangle test (pallas_packet.py:283-332) in place of the
    watertight one; it has no edge functions, so ``exact_edge_fallback``
    does not apply. Its records may differ from the watertight ones
    within an ulp of an edge (a hit against a miss, or the neighbouring
    prim), the JAX package's own contract for it.

    Rays keep their batch shape. Misses report ``t = max_t`` (``+inf``
    for degenerate rays in closest-hit mode), ``u = v = 0`` and
    ``prim_id = 0xFFFFFFFF``. Rays with an empty interval
    (``max_t < min_t``) or a NaN bound cannot hit and retire before
    their first node.
    """
    _check_specialize(specialize)
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")
    woop = intersector == "woop"
    exact_edge = options.exact_edge_fallback and not woop
    if woop:
        if scene.leafs_woop is None:
            raise ValueError(
                "intersector='woop' needs the Woop leaf table: build the "
                "scene with collapse_bvh8(..., woop=True)")
        if scene.max_leaf > WOOP_MAX_LEAF:
            raise ValueError("woop rows hold <= 9 triangles; rebuild "
                             "with max_leaf_primitives<=9")
    if scene.width not in (8, 16):
        raise ValueError(f"width must be 8 or 16: {scene.width}")
    slots = stack_slots(scene)
    if slots > STACK_CAP:
        raise ValueError(f"scene depth {scene.depth} needs {slots} stack "
                         f"slots, the kernel holds {STACK_CAP}")
    bs = rays.batch_shape
    dev = rays.org.device
    for name in ("org", "dir", "min_t", "max_t"):
        x = getattr(rays, name)
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"rays.{name} must be float32 on {dev}")
    org = _flat(rays.org, (3,), "org")
    dir = _flat(rays.dir, (3,), "dir")
    min_t = _flat(rays.min_t, (), "min_t")
    max_t = _flat(rays.max_t, (), "max_t")
    n = org.shape[0]
    nodes = _table(scene.nodes, dev)
    # woop rows pair one to one with the watertight leaf rows
    leafs = _table(scene.leafs_woop if woop else scene.leafs, dev)
    for name, tab in (("nodes", nodes), ("leafs", leafs)):
        if (tab.dtype != torch.float32 or tab.ndim != 2
                or tab.shape[1] != LANES or not tab.is_contiguous()):
            raise ValueError(f"scene.{name} must be contiguous float32 "
                             f"(rows, {LANES})")
    skip = options.skip_prim_id if skip_prim_id is None else skip_prim_id
    if isinstance(skip, int):
        skip = None if skip == INVALID_PRIM_ID else torch.full(
            (n,), skip, dtype=torch.int64, device=dev)
    else:
        skip = torch.as_tensor(skip, device=dev).reshape(-1).long()
        if skip.shape[0] != n:
            raise ValueError("skip_prim_id must hold one id per ray")
    lo, hi = options.prim_ids_range
    prim_range = None if (lo, hi) == (0, PRIM_RANGE_MAX) else (int(lo), int(hi))

    if dev.type == "cpu":
        t, u, v, pid = _traverse_reference(
            nodes, leafs, scene.width, org, dir, min_t, max_t, skip,
            prim_range, options.cull_back_face, exact_edge, occlusion,
            slots, woop)
    elif dev.type == "cuda":
        for name, tab in (("nodes", nodes), ("leafs", leafs)):
            if tab.data_ptr() % 16:
                raise ValueError(f"scene.{name} must be 16-byte aligned")
        # the kernel compares int32 ids; 0xFFFFFFFF wraps to -1 = no skip
        skip32 = None if skip is None else skip.to(torch.int32)
        t = torch.empty(n, dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        pid = torch.empty(n, dtype=PRIM_ID_DTYPE, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        lib = _ext.load("packet_traverse")
        ptr = lambda x: ctypes.c_void_p(x.data_ptr()) if x is not None else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.nrt_packet_traverse(
                ptr(nodes), ptr(leafs), ptr(org), ptr(dir), ptr(min_t),
                ptr(max_t), ptr(skip32), ptr(t), ptr(u), ptr(v), ptr(pid),
                ptr(err), n, scene.width, slots, int(occlusion),
                int(options.cull_back_face), int(exact_edge),
                int(prim_range is not None),
                prim_range[0] if prim_range else 0,
                prim_range[1] if prim_range else 0, int(woop),
                ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"traversal kernel launch failed: CUDA error {rc}")
        LAUNCHES["packet_traverse_woop" if woop else "packet_traverse"] += 1
        # checked on the stream, without a host sync: an overflow can only
        # come from a scene.depth that BVH8Scene.to did not check, and it
        # fails the next synchronising call (a device assert)
        torch._assert_async(
            err == 0, f"traversal stack overflow ({slots} slots): "
            "scene.depth does not describe the tables")
    else:
        raise ValueError(f"unsupported device {dev}")
    return Hits(t.view(bs), u.view(bs), v.view(bs), pid.view(bs))


def _woop_test(rows, o, d, min_t, t_cur, cull_back_face):
    """Woop unit-triangle test of (m, 9) triangles of ``leafs_woop``
    rows against m rays, the operations of pallas_packet.py:287-330 in
    their order (``M (o - p0)``, then ``t = -o'z / d'z``). Hits farther
    than ``t_cur`` reject, an equal distance is accepted. Returns
    ``(valid, tt, u, v, prim_ids)``."""
    m = rows.shape[0]
    tri = rows[:, :108].view(m, 9, 12)
    ox, oy, oz = (o[:, a, None] for a in range(3))
    dx, dy, dz = (d[:, a, None] for a in range(3))
    rx = ox - tri[..., 9]
    ry = oy - tri[..., 10]
    rz = oz - tri[..., 11]

    def row_dot(k, x, y, z):
        return (tri[..., 3 * k] * x + tri[..., 3 * k + 1] * y
                + tri[..., 3 * k + 2] * z)

    opz = row_dot(2, rx, ry, rz)
    dpz = row_dot(2, dx, dy, dz)
    # a true division: +-inf for a ray parallel to the plane, and the
    # inf or NaN tt that follows fails every test below
    rcp = torch.ones_like(dpz) / dpz
    tt = -opz * rcp
    uu = row_dot(0, rx, ry, rz) + tt * row_dot(0, dx, dy, dz)
    vv = row_dot(1, rx, ry, rz) + tt * row_dot(1, dx, dy, dz)
    valid = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt <= t_cur[:, None]) & (tt >= min_t[:, None]))
    if cull_back_face:
        valid &= dpz < 0.0
    return valid, tt, uu, vv, rows[:, 108:117].long()


def _traverse_reference(nodes, leafs, width, org, dir, min_t, max_t, skip,
                        prim_range, cull_back_face, exact_edge_fallback,
                        occlusion, slots, woop=False, stats=None):
    """Plain torch version of the kernel: a batched per-ray stack
    traversal over the same tables, in the same child order, with the
    same arithmetic (``ops/triangle.py``, or ``_woop_test`` when
    ``woop``). Every loop step pops one entry for every live ray: node
    entries run ``width`` slab tests and push their hit children
    far-first; leaf entries test their <= 10 (woop: <= 9) triangles.
    Returns flat ``(t, u, v, prim_id)``. ``stats``, a dict, gains the
    work this batch needed: ``"nodes"`` popped and triangles tested
    (``"tris"``)."""
    dev = org.device
    n = org.shape[0]
    inf = float("inf")
    ok = _well_formed(org, dir)
    o = torch.where(ok[:, None], org, 0.0)
    d = torch.where(ok[:, None], dir,
                    torch.tensor([1.0, 0.0, 0.0], device=dev))
    mint = torch.where(ok, min_t, inf)
    t_best = torch.where(ok, max_t, inf)
    inv = safe_inverse(d)
    neg = d < 0
    coeffs = ray_coeffs(d)

    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    pid_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    # column ``slots`` is a write sink for children that are not pushed
    stack = torch.zeros((n, slots + 1), dtype=torch.int64, device=dev)
    # root row 0 at slot 0; a ray whose interval is empty or NaN
    # (!(min_t <= max_t)) fails every slab test and retires at once
    sp = (mint <= t_best).long()
    ar_w = torch.arange(width, device=dev)
    n_slots = 9 if woop else 10
    ar_l = torch.arange(n_slots, device=dev)
    if width == 16:
        meta_lane, count_lane = 96, 112
    else:
        meta_lane, count_lane = 64, 72

    while True:
        live = sp > 0
        if occlusion:
            live &= ~found
        idx = live.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]

        # ---- node entries: slab-test every child, push hits far-first
        ni = idx[e >= 0]
        if stats is not None:
            stats["nodes"] = stats.get("nodes", 0) + int(ni.numel())
            stats["tris"] = stats.get("tris", 0) + int(
                ((-1 - e[e < 0]) & 15).sum())
        if ni.numel():
            rows = nodes.index_select(0, e[e >= 0])
            m = ni.shape[0]
            if width == 16:
                box = rows[:, :96].view(m, 16, 6)
                v112 = rows[:, 112]
                axis = torch.where(v112 >= 32, 2, torch.where(v112 >= 16, 1, 0))
            else:
                box = rows[:, :64].view(m, 8, 8)[:, :, :6]
                a80 = rows[:, 80]
                axis = torch.where(a80 == 0, 0, torch.where(a80 == 1, 1, 2))
            nn = neg[ni][:, None, :]
            lo = torch.where(nn, box[..., 3:6], box[..., 0:3])
            hi = torch.where(nn, box[..., 0:3], box[..., 3:6])
            on = o[ni][:, None, :]
            iv = inv[ni][:, None, :]
            t0 = (lo - on) * iv
            t1 = (hi - on) * iv * MAX_MULT
            tmin = mint[ni][:, None].expand(m, width)
            tmax = t_best[ni][:, None].expand(m, width)
            for a in range(3):  # NaN-skipping where-folds, x then y then z
                tmin = torch.where(t0[..., a] > tmin, t0[..., a], tmin)
                tmax = torch.where(t1[..., a] < tmax, t1[..., a], tmax)
            hit = tmin <= tmax
            neg_axis = neg[ni].gather(1, axis[:, None])[:, 0]
            order = torch.where(neg_axis[:, None], ar_w, width - 1 - ar_w)
            push = hit.gather(1, order)
            meta = rows[:, meta_lane:meta_lane + width].gather(1, order).long()
            cnt = rows[:, count_lane:count_lane + width].gather(1, order).long() & 15
            entry = torch.where(meta >= 0, meta, -1 - (((-meta - 1) << 4) | cnt))
            sp_n = sp[ni]
            pos = sp_n[:, None] + push.long().cumsum(1) - 1
            new_sp = sp_n + push.sum(1)
            if bool((new_sp > slots).any()):
                raise RuntimeError(
                    f"traversal stack overflow ({slots} slots): scene.depth "
                    "does not describe the tables")
            pos = torch.where(push, pos, slots)
            stack[ni[:, None].expand(m, width), pos] = entry
            sp[ni] = new_sp

        # ---- leaf entries: test the row's triangles in slot order
        li = idx[e < 0]
        if li.numel():
            packed = -1 - e[e < 0]
            rows = leafs.index_select(0, packed >> 4)
            cnt = packed & 15
            m = li.shape[0]
            tc = t_best[li]
            if woop:
                valid, tt, uu, vv, pids = _woop_test(
                    rows, o[li], d[li], mint[li], tc, cull_back_face)
            else:
                tri = rows[:, :90].view(m, 10, 9)
                pids = rows[:, 90:100].long()
                co = RayCoeffs(*(c[li][:, None] for c in coeffs))
                valid, tt, uu, vv = intersect_triangles(
                    co, o[li][:, None, :], mint[li][:, None], tc[:, None],
                    tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
                    cull_back_face=cull_back_face,
                    exact_edge_fallback=exact_edge_fallback)
            valid &= ar_l < cnt[:, None]
            if skip is not None:
                valid &= pids != skip[li][:, None]
            if prim_range is not None:
                valid &= (pids >= prim_range[0]) & (pids < prim_range[1])
            # sequential tt <= t replacement == the LAST slot holding the
            # minimum t; any-hit stops at the FIRST accepted slot
            t_m = torch.where(valid, tt, inf)
            t_min = t_m.amin(1)
            if occlusion:
                sel = torch.where(valid, ar_l, n_slots).amin(1)
            else:
                sel = torch.where(valid & (t_m == t_min[:, None]), ar_l,
                                  -1).amax(1)
            any_v = valid.any(1)
            take = sel.clamp(0, n_slots - 1)[:, None]
            t_best[li] = torch.where(any_v, tt.gather(1, take)[:, 0], tc)
            u_best[li] = torch.where(any_v, uu.gather(1, take)[:, 0], u_best[li])
            v_best[li] = torch.where(any_v, vv.gather(1, take)[:, 0], v_best[li])
            pid_best[li] = torch.where(any_v, pids.gather(1, take)[:, 0],
                                       pid_best[li])
            found[li] |= any_v

    hit = found if occlusion else t_best < max_t
    t = torch.where(hit, t_best, max_t) if occlusion else t_best
    zero = torch.zeros((), device=dev)
    return (
        t,
        torch.where(hit, u_best, zero),
        torch.where(hit, v_best, zero),
        torch.where(hit, pid_best, INVALID_PRIM_ID),
    )


def traverse_bvh8_exact(scene: BVH8Scene, rays: Rays,
                        options: BVHTraceOptions = BVHTraceOptions(),
                        skip_prim_id=None) -> Hits:
    """Exact-edge traversal under its JAX name. The TPU package runs it
    as a fast pass plus a retrace of flagged packets; this port's kernel
    does the exact-edge recompute inline in one pass, so this is
    ``traverse_bvh8`` with ``exact_edge_fallback=True``."""
    opts = dataclasses.replace(options, exact_edge_fallback=True)
    return traverse_bvh8(scene, rays, opts, skip_prim_id)


def traverse_bvh8_exact_fused(scene: BVH8Scene, rays: Rays,
                              options: BVHTraceOptions = BVHTraceOptions(),
                              skip_prim_id=None, specialize=None):
    """Exact-edge traversal under its JAX name, returning ``(hits,
    overflow)``. The TPU package runs a flag-only pass and retraces the
    flagged rows within a fixed capacity, and ``overflow`` says whether
    that capacity was exceeded; this port's kernel does the exact-edge
    recompute inline, so ``overflow`` is always a device ``False``."""
    if not options.exact_edge_fallback:
        raise ValueError("exact_fused requires exact_edge_fallback=True")
    hits = traverse_bvh8(scene, rays, options, skip_prim_id,
                         specialize=specialize)
    return hits, torch.zeros((), dtype=torch.bool, device=rays.org.device)


def refit_hits_watertight(mesh: TriangleMesh, rays: Rays, hits: Hits,
                          options: BVHTraceOptions = BVHTraceOptions()
                          ) -> Hits:
    """Recompute each hit's (t, u, v) with the reference watertight test
    (nanort.h:993-1229) against the already-selected triangle: one
    triangle per ray, plain torch (an XLA pass in the JAX package,
    pallas_packet.py:2548).

    Pairs with ``intersector="woop"``: the Woop kernel picks the prim,
    this pass restores watertight records for it. Where the watertight
    re-test rejects the hit (only within an ulp of an edge), or the ray
    missed, the record is kept as it is. ``mesh`` fields may be NumPy
    arrays or tensors."""
    bs = rays.batch_shape
    dev = rays.org.device
    org = rays.org.reshape(-1, 3)
    dir = rays.dir.reshape(-1, 3)
    pid = hits.prim_id.reshape(-1)
    hit = pid != INVALID_PRIM_ID
    verts = torch.as_tensor(mesh.vertices, device=dev)
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    tri9 = verts[faces].reshape(-1, 9).to(torch.float32)
    g = tri9[torch.where(hit, pid, 0)]
    valid, tt, uu, vv = intersect_triangles(
        ray_coeffs(dir), org, rays.min_t.reshape(-1),
        rays.max_t.reshape(-1), g[:, 0:3], g[:, 3:6], g[:, 6:9],
        cull_back_face=options.cull_back_face,
        exact_edge_fallback=options.exact_edge_fallback)
    valid &= hit

    def keep(new, old):
        return torch.where(valid, new, old.reshape(-1)).reshape(bs)

    return Hits(keep(tt, hits.t), keep(uu, hits.u), keep(vv, hits.v),
                hits.prim_id)


def detect_specialization(rays: Rays, sub: int | None = None) -> tuple | None:
    """Which bit-exact batch specializations a ray batch qualifies for,
    with the JAX package's semantics (pallas_packet.py:2310-2379):
    ``(kz | None, shared_origin[, uniform_sign])`` or None. ``kz`` is the
    shear axis every live ray shares, ``shared_origin`` whether every
    live ray has one origin, and ``uniform_sign`` (only when ``sub`` is
    given) whether each ``sub * 128``-ray packet shares one octant."""
    org = rays.org.reshape(-1, 3).float()
    d = rays.dir.reshape(-1, 3).float()
    ok = _well_formed(org, d)
    if not bool(ok.any()):
        return None
    first = int(ok.long().argmax())
    shared = bool(torch.where(ok[:, None], org == org[first][None, :],
                              True).all())
    ad = d.abs()
    kz = torch.where(ad[:, 1] > ad[:, 0], 1, 0)
    amax = torch.where(ad[:, 1] > ad[:, 0], ad[:, 1], ad[:, 0])
    kz = torch.where(ad[:, 2] > amax, 2, kz)
    kz_uniform = bool(torch.where(ok, kz == kz[first], True).all())
    kz_val = int(kz[first]) if kz_uniform else None
    if sub is None:
        if kz_val is None and not shared:
            return None
        return (kz_val, shared)
    packet = sub * LANES
    n = d.shape[0]
    n_pk = -(-n // packet)
    pad = n_pk * packet - n
    live = ok & (rays.max_t.reshape(-1) > rays.min_t.reshape(-1))
    live_p = torch.nn.functional.pad(live, (0, pad)).view(n_pk, packet)
    usign = True
    for a in range(3):
        negp = torch.nn.functional.pad(d[:, a] < 0, (0, pad)).view(n_pk, packet)
        any_n = (negp & live_p).any(1)
        all_n = ~(~negp & live_p).any(1)
        usign = usign and bool((any_n == all_n).all())
    if kz_val is None and not shared and not usign:
        return None
    return (kz_val, shared, usign)


def tile_image_rays(rays: Rays, tile_h: int = 32, tile_w: int = 32):
    """Reorder (H, W) image rays into ``tile_h x tile_w`` pixel tiles so
    each group of neighbouring rays covers a compact frustum (a warp's 32
    rays are neighbouring pixels). Returns ``(flat_rays, untile)`` where
    ``untile`` restores the image shape of any NamedTuple of (H*W, ...)
    tensors, e.g. ``Hits``."""
    H, W = rays.org.shape[:2]
    if H % tile_h or W % tile_w:
        raise ValueError(f"image {H}x{W} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")

    def fwd(x):
        x = x.reshape(H // tile_h, tile_h, W // tile_w, tile_w, *x.shape[2:])
        return x.transpose(1, 2).reshape(H * W, *x.shape[4:])

    def untile(tree):
        def inv(x):
            x = x.reshape(H // tile_h, W // tile_w, tile_h, tile_w, *x.shape[1:])
            return x.transpose(1, 2).reshape(H, W, *x.shape[4:])

        return type(tree)(*(inv(x) for x in tree))

    return Rays(*(fwd(x) for x in rays)), untile
