"""Treelet-binned traversal, the incoherent-ray engine (port of
``nanort_tpu.traverse.treelet``).

Pipeline (``traverse_bvh8_binned``):
  1. ``make_treelets``: expand the BVH8 root into <= ``target`` frontier
     nodes (greedy largest surface area, host NumPy, a copy of the JAX
     package's), appending synthetic rows for leaf treelets (and, with
     ``flat=True``, shallow replacement trees).
  2. Morton pre-sort of the rays (``ray_sort.ray_sort_keys``), then per
     ray its K nearest entered treelets (t_entry, tid) by a dense
     (rays x treelets) slab test and K rounds of min-extraction, plus its
     exact entered count.
  3. Two pair sweeps: round 1 bins every ray to its nearest entered
     treelet, round 2 the remaining (ray, treelet) pairs that can still
     beat the ray's best hit. Each sweep groups pairs by treelet into
     packet-aligned slots (one treelet a packet of ``sub * 128`` slots),
     launches K1 once with one root a packet (``packet_roots``) and
     min-merges the slots' records back per ray.
  4. A completion sweep over the rays that entered more than K treelets,
     so the records equal the global traversal's at any (T, K).

Everything but ``make_treelets`` is plain torch on the rays' device (the
JAX package's is plain XLA); the traversal is K1. Deviations from the
JAX package, none of which changes a record:
- ``core/rowpack.py`` is not ported: permuting and unpermuting rows is
  plain indexing (torch keeps NaN payloads);
- no ``_bin_pass``: the JAX module's K-pass binning, which its
  ``traverse_bvh8_binned`` does not call (it runs the pair sweeps);
- no ``_next_bucket`` / ``_next_pow2``: they round sizes to powers of two
  to bound XLA's compiled shapes, which eager torch does not need, so a
  sweep launches exactly ``n_padded + packet`` slots and the completion
  sweep takes exactly the overflowing rays and their entered count;
- ``_pair_fill`` writes the current best t into column 7 of ``comps``
  in place (the JAX package returns a copy), and returns the slot rows
  as one ``(n_slots, 8)`` matrix.

The TPU speed figures in the JAX module (Mrays/s, drains a packet) are
v5e figures, not this port's; the port's are in PERF.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..build.bvh8 import EMPTY_BIG, BVH8Scene, table_depth
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Hits, Rays
from . import packet
from .ray_sort import ray_sort_keys

LANES = 128
BIG = 3.0e38  # the K-lists' empty key
MAX_MULT = 1.00000024  # conservative far-plane multiplier (nanort.h)


@dataclasses.dataclass
class Treelets:
    """Frontier of BVH8 nodes covering the whole tree: host arrays."""

    roots: np.ndarray  # (T,) int32 node row ids
    bmin: np.ndarray  # (T, 3) f32
    bmax: np.ndarray  # (T, 3) f32
    count: int


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _node_children(row):
    """Yield (meta, bmin, bmax, is_leaf) for real children of a node row."""
    for c in range(8):
        if row[8 * c] >= EMPTY_BIG:  # empty slot
            continue
        meta = float(row[64 + c])
        yield (
            int(meta),
            row[8 * c: 8 * c + 3].copy(),
            row[8 * c + 3: 8 * c + 6].copy(),
            meta < 0,
        )


def make_treelets(scene: BVH8Scene, target: int = 64, flat: bool = False):
    """Greedy frontier expansion: repeatedly split the largest-area
    frontier node until ``target`` treelets. Internal children join the
    frontier directly; leaf children become treelets rooted at synthetic
    single-child node rows appended to the table (inserted before the
    dummy park row so existing ids are untouched).

    ``flat=True`` replaces every treelet's BVH8 subtree with a synthetic
    shallow tree over its leaf rows (fan-8 levels of consecutive-row
    groups). Same records: leaf children keep their (row, cnt) and exact
    child AABBs, boxes only cull.

    Width-8 scenes only. The tables may be NumPy arrays or tensors (read
    to the host); the returned scene's node table is of the same kind, on
    the same device. Raises ValueError when a root's subtree is deeper
    than ``scene.depth``, which sizes the traversal's stack.

    Returns (Treelets, scene_with_synthetic_rows)."""
    if scene.width != 8:
        raise ValueError(f"treelets need a width-8 scene, not {scene.width}")
    nodes = _host(scene.nodes).astype(np.float32, copy=False)
    n_real = scene.num_nodes  # excludes the trailing dummy park row

    def node_box(nid):
        los, his = [], []
        for _, lo, hi, _ in _node_children(nodes[nid]):
            los.append(lo)
            his.append(hi)
        return np.min(los, axis=0), np.max(his, axis=0)

    def area(box):
        d = np.maximum(box[1] - box[0], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    # frontier items: (root_id_or_None, box, leaf_spec_or_None)
    frontier = [(0, node_box(0), None)]
    while len(frontier) < target:
        best, best_a = -1, -1.0
        for i, (nid, box, leaf) in enumerate(frontier):
            if leaf is not None:
                continue  # leaf treelets don't expand
            kids = list(_node_children(nodes[nid]))
            if len(frontier) - 1 + len(kids) > target or len(kids) < 2:
                continue
            a = area(box)
            if a > best_a:
                best, best_a = i, a
        if best < 0:
            break
        nid, _, _ = frontier.pop(best)
        row = nodes[nid]
        for c in range(8):
            if row[8 * c] >= EMPTY_BIG:
                continue
            meta = int(row[64 + c])
            box = (row[8 * c: 8 * c + 3].copy(),
                   row[8 * c + 3: 8 * c + 6].copy())
            if meta >= 0:
                frontier.append((meta, box, None))
            else:
                cnt = int(row[72 + c])
                frontier.append((None, box, (-meta - 1, cnt)))

    # synthesize rows for leaf treelets (and, with flat=True, shallow
    # replacement trees for every internal-rooted treelet)
    synth = []
    roots = []

    def _empty_row():
        r = np.zeros(128, np.float32)
        for k in range(3):
            r[k:64:8] = EMPTY_BIG
            r[3 + k:64:8] = -EMPTY_BIG
        return r

    def _emit_row(grp):
        """One synthetic BVH8 row over <= 8 children
        (lo, hi, meta, cnt, is_leaf); returns its node id."""
        r = _empty_row()
        ctr = np.stack([(lo + hi) * 0.5 for lo, hi, _, _, _ in grp])
        axis = int(np.argmax(np.ptp(ctr, axis=0))) if len(grp) > 1 else 0
        for c, (lo, hi, meta, cnt, is_leaf) in enumerate(grp):
            r[8 * c: 8 * c + 3] = lo
            r[8 * c + 3: 8 * c + 6] = hi
            r[64 + c] = meta
            r[72 + c] = float(cnt)
        # order axis rides the child-0 count lane (cnt + 16 * axis),
        # matching the collapse emitters; a width-8 traversal reads lane
        # 80 (0 here), so these rows are walked in x order
        r[72] = float(int(r[72]) + 16 * axis)
        rid = n_real + len(synth)
        synth.append(r)
        return rid

    def _flat_subtree(nid):
        """Replace nid's subtree with fan-8 levels over its leaf rows."""
        kids = []
        stack = [nid]
        while stack:
            i = stack.pop()
            row = nodes[i]
            for c in range(8):
                if row[8 * c] >= EMPTY_BIG:
                    continue
                meta = row[64 + c]
                if meta >= 0:
                    stack.append(int(meta))
                else:
                    cl = int(row[72 + c])
                    cnt = (cl & 15) if c == 0 else cl
                    kids.append((row[8 * c: 8 * c + 3].copy(),
                                 row[8 * c + 3: 8 * c + 6].copy(),
                                 float(meta), cnt, True))
        kids.sort(key=lambda k: -k[2])  # ascending leaf row id
        level = kids
        while len(level) > 8:
            nxt = []
            for i in range(0, len(level), 8):
                grp = level[i:i + 8]
                rid = _emit_row(grp)
                lo = np.min([g[0] for g in grp], axis=0)
                hi = np.max([g[1] for g in grp], axis=0)
                nxt.append((lo, hi, float(rid), 0, False))
            level = nxt
        return _emit_row(level)

    for nid, box, leaf in frontier:
        if leaf is None:
            roots.append(_flat_subtree(nid) if flat else nid)
            continue
        leaf_row, cnt = leaf
        r = np.zeros(128, np.float32)
        r[0:64:8] = EMPTY_BIG
        r[1:64:8] = EMPTY_BIG
        r[2:64:8] = EMPTY_BIG
        r[3:64:8] = -EMPTY_BIG
        r[4:64:8] = -EMPTY_BIG
        r[5:64:8] = -EMPTY_BIG
        r[0:3] = box[0]
        r[3:6] = box[1]
        r[64] = np.float32(-(leaf_row + 1))
        r[72] = np.float32(cnt)
        roots.append(n_real + len(synth))
        synth.append(r)
    nodes_aug = nodes
    if synth:
        nodes_aug = np.concatenate(
            [nodes[:n_real], np.stack(synth), nodes[n_real:]])
    roots = np.asarray(roots, np.int32)
    # the traversal sizes its stack from scene.depth (BVH8Scene.to checks
    # it from row 0 only, and the synthetic rows hang below no row)
    levels = table_depth(nodes_aug, 8, roots)
    if levels > scene.depth:
        raise ValueError(f"a treelet root's subtree has {levels} node "
                         f"levels, more than scene.depth {scene.depth}")
    if synth:
        if isinstance(scene.nodes, torch.Tensor):
            nodes_aug = torch.as_tensor(nodes_aug).to(
                scene.nodes.device).contiguous()
        scene = scene._replace(nodes=nodes_aug)
        # existing child ids all point below n_real; only the dummy park
        # row moved
    tl = Treelets(
        roots=roots,
        bmin=np.stack([b[0] for _, b, _ in frontier]).astype(np.float32),
        bmax=np.stack([b[1] for _, b, _ in frontier]).astype(np.float32),
        count=len(frontier),
    )
    return tl, scene


def _treelet_klists(org, dirs, min_t, max_t, bmin, bmax, K, chunk=None):
    """Dense ray x treelet AABB test -> K nearest (t_entry, tid) slots and
    each ray's entered count. tid == T marks an empty slot. Chunked over
    rays so the (chunk, T) intermediates stay small (default: chunk * T
    ~ 2^24). Returns (t_entry (R, K) f32, tid (R, K) int32, n_ent (R,)
    int32)."""
    T = int(bmin.shape[0])
    if chunk is None:
        chunk = max(2048, (1 << 24) // max(T, 1))
    dev = org.device
    bmin = torch.as_tensor(bmin, dtype=torch.float32, device=dev)
    bmax = torch.as_tensor(bmax, dtype=torch.float32, device=dev)
    R = org.shape[0]
    if R == 0:
        return (torch.empty((0, K), device=dev),
                torch.empty((0, K), dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    parts = [_treelet_klists_chunk(org[a:a + chunk], dirs[a:a + chunk],
                                   min_t[a:a + chunk], max_t[a:a + chunk],
                                   bmin, bmax, K)
             for a in range(0, R, chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _treelet_klists_chunk(org, dirs, min_t, max_t, bmin, bmax, K):
    # componentwise (chunk, T) slab tests, sign-free: per axis, near = min
    # of the two plane products (NaN folds to -inf: 0 * inf on a
    # degenerate axis means unconstrained), far = max (NaN folds to +inf)
    # times the conservative 1.00000024
    inf = float("inf")
    n, T = org.shape[0], bmin.shape[0]
    eps = torch.finfo(torch.float32).eps
    tmin = min_t[:, None].expand(n, T)
    tmax = max_t[:, None].expand(n, T)
    for a in range(3):
        d = dirs[:, a]
        tiny = d.abs() < eps
        # a true division: torch's 1.0 / x is reciprocal(x) * 1.0
        inv = torch.where(tiny, torch.copysign(torch.full_like(d, inf), d),
                          torch.ones_like(d) / torch.where(tiny, 1.0, d))[:, None]
        o = org[:, a][:, None]
        pa = (bmin[None, :, a] - o) * inv
        pb = (bmax[None, :, a] - o) * inv
        na, nb = pa.isnan(), pb.isnan()
        near = torch.minimum(torch.where(na, -inf, pa),
                             torch.where(nb, -inf, pb))
        far = torch.maximum(torch.where(na, inf, pa),
                            torch.where(nb, inf, pb)) * MAX_MULT
        tmin = torch.maximum(tmin, near)
        tmax = torch.minimum(tmax, far)
    hit = tmin <= tmax  # (n, T)
    key = torch.where(hit, tmin, BIG)
    k_eff = min(K, T)
    # K rounds of min-extraction; ties go to the lowest tid (argmin
    # returns the first minimum, as jnp.argmin does)
    iot = torch.arange(T, device=org.device)
    te_l, ti_l = [], []
    for _ in range(k_eff):
        te_l.append(key.amin(1))
        am = key.argmin(1)
        ti_l.append(am)
        key = torch.where(iot == am[:, None], BIG, key)
    t_entry = torch.stack(te_l, 1)
    tid = torch.where(t_entry < BIG, torch.stack(ti_l, 1), T).to(torch.int32)
    if k_eff < K:
        pad = K - k_eff
        t_entry = torch.nn.functional.pad(t_entry, (0, pad), value=BIG)
        tid = torch.nn.functional.pad(tid, (0, pad), value=T)
    # exact entered count per ray: the K-list truncates rays entering more
    # than K boxes; the caller routes those through a completion sweep
    n_ent = hit.sum(1).to(torch.int32)
    return t_entry, tid, n_ent


def _exclusive_cumsum(x):
    return torch.cumsum(x, 0) - x


def _pair_order(td, te, best_t, T, packet):
    """Group the (R, C) candidate pair grid by treelet id.

    Returns (order over the flattened grid with active pairs first,
    grouped by tid; grouped keys; per-treelet active counts; the active
    count; the exact packet-aligned slot need), the counts on the
    device."""
    act = (td < T) & (te <= best_t[:, None])
    key = torch.where(act, td.long(), T).reshape(-1)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    counts = torch.bincount(key_s, minlength=T + 1)[:T]
    n_padded = (-(-counts // packet) * packet).sum()
    return order, key_s, counts, counts.sum(), n_padded


def _pair_fill(order_j, key_j, counts, comps, best_t, T, C, packet, n_slots):
    """Packet-aligned ray slots for the grouped pairs ``order_j`` (keys
    ``key_j``): one index scatter and one row gather of the (R+1, 8)
    ray matrix ``comps`` [ox oy oz dx dy dz min_t max_t], whose last row
    is an inert pad ray. Column 7 of ``comps`` is set to ``best_t`` in
    place first (the slot's far bound is the ray's current best).

    Returns (slot rows (n_slots, 8), per-packet treelet ids (-1: no
    live slot), per-slot source ray index [R = pad])."""
    dev = comps.device
    R = comps.shape[0] - 1
    j = torch.arange(order_j.shape[0], device=dev)
    g = key_j.clamp(max=T - 1)
    live = key_j < T
    padded = -(-counts // packet) * packet
    pad_off = _exclusive_cumsum(padded)
    start = _exclusive_cumsum(counts)
    rank = j - start[g]
    dest = torch.where(live, pad_off[g] + rank, n_slots - 1)
    ray_idx = order_j // C  # the pair grid is (R, C)
    slot_src = torch.full((n_slots,), R, dtype=torch.int64, device=dev)
    slot_src[dest] = torch.where(live, ray_idx, R)
    comps[:R, 7] = best_t
    rows = comps[slot_src]
    slot_tid = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    slot_tid.scatter_reduce_(0, dest, torch.where(live, g, -1), "amax")
    pkt_tid = slot_tid.view(-1, packet).amax(1)
    return rows, pkt_tid, slot_src


def _pair_merge(best: Hits, slot_t, slot_u, slot_v, slot_pid, slot_src):
    """Fold slot hit records back per ray: scatter-min t, then pick one
    winning slot per ray (the largest slot index among equal-t winners)
    and gather its whole record so (t, u, v, prim_id) stay consistent."""
    dev = slot_t.device
    R = best.t.shape[0]
    inf = float("inf")
    valid = (slot_pid != INVALID_PRIM_ID) & (slot_src < R)
    tval = torch.where(valid, slot_t, inf)
    src = torch.where(valid, slot_src, R)
    cand = torch.full((R + 1,), inf, dtype=slot_t.dtype, device=dev)
    cand.scatter_reduce_(0, src, tval, "amin")
    win = valid & (tval <= cand[src])
    slots = torch.arange(slot_t.shape[0], device=dev)
    wslot = torch.full((R + 1,), -1, dtype=torch.int64, device=dev)
    wslot.scatter_reduce_(0, src, torch.where(win, slots, -1), "amax")
    wslot = wslot[:R]
    got = (wslot >= 0) & (cand[:R] <= best.t)
    ws = wslot.clamp(min=0)
    return Hits(*(torch.where(got, s[ws], b) for s, b in zip(
        (slot_t, slot_u, slot_v, slot_pid), best)))


def _make_comps(fl: Rays) -> torch.Tensor:
    """(R+1, 8) ray matrix [ox oy oz dx dy dz min_t max_t-slot]; the last
    row is an inert pad ray (max_t -1 < min_t 1)."""
    n = fl.org.shape[0]
    dev = fl.org.device
    m = torch.cat([fl.org, fl.dir, fl.min_t[:, None],
                   torch.full((n, 1), -1.0, device=dev)], 1)
    pad = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, -1.0]],
                       device=dev)
    return torch.cat([m, pad])


def _morton_presort(flat: Rays, bmin, bmax, octant_major: bool):
    """Rays sorted by their Morton (and octant) key over the treelets'
    box, so each bin stays spatially sorted; returns (sorted rays,
    order)."""
    lo = bmin.amin(0)
    hi = bmax.amax(0)
    keys = ray_sort_keys(flat, lo, hi, octant_major=octant_major)
    order = torch.argsort(keys, stable=True)
    return Rays(*(x[order] for x in flat)), order


def _on_device(scene: BVH8Scene, dev) -> BVH8Scene:
    tabs = (scene.nodes, scene.leafs) + (
        () if scene.leafs_woop is None else (scene.leafs_woop,))
    if all(isinstance(x, torch.Tensor) and x.device == dev for x in tabs):
        return scene
    return scene.to(dev)


def traverse_bvh8_binned(scene: BVH8Scene, rays: Rays,
                         options: BVHTraceOptions = BVHTraceOptions(),
                         treelets: Treelets | None = None,
                         n_treelets: int = 512, K: int = 8, sub: int = 8,
                         octant_major: bool = False, _complete: bool = True,
                         **kw) -> Hits:
    """Incoherent-ray entry point: treelet-binned traversal on K1.

    ``scene`` is a width-8 scene; pass ``treelets`` with the scene that
    ``make_treelets`` returned, or leave it None to build ``n_treelets``
    here. The scene is moved to the rays' device when its tables are
    elsewhere. ``K`` caps the treelets a ray's K-list holds (a speed
    knob: the records equal the global traversal's at any K), ``sub``
    sets the packet (``sub * 128`` slots a treelet bin is padded to),
    ``octant_major`` the Morton key's order, and ``kw`` goes to
    ``traverse_bvh8`` (``intersector``, ``occlusion``, ...).

    Records: t equal to the global ``traverse_bvh8``'s bit for bit;
    ``prim_id`` may differ only between hits at equal t (a second
    triangle at exactly the t of the first hit is found in another
    sweep). Degenerate rays (NaN or infinite origin or direction, zero
    direction) miss with ``t = max_t``, as in the JAX package, where
    ``traverse_bvh8`` reports ``+inf``. Two host syncs a sweep (the pair
    count and slot need), one for the completion sweep."""
    if treelets is None:
        treelets, scene = make_treelets(scene, n_treelets)
    dev = rays.org.device
    scene = _on_device(scene, dev)
    T = treelets.count
    pkt = sub * LANES
    bs = rays.batch_shape
    flat = Rays(*(x.reshape((-1,) + x.shape[len(bs):]) for x in rays))
    R = flat.org.shape[0]
    bmin = torch.as_tensor(treelets.bmin, device=dev)
    bmax = torch.as_tensor(treelets.bmax, device=dev)
    flat, sorder = _morton_presort(flat, bmin, bmax, octant_major)
    t_entry, tid, n_ent = _treelet_klists(flat.org, flat.dir, flat.min_t,
                                          flat.max_t, bmin, bmax, K)
    comps = _make_comps(flat)
    best = Hits(flat.max_t.clone(), torch.zeros_like(flat.max_t),
                torch.zeros_like(flat.max_t),
                torch.full((R,), INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE,
                           device=dev))
    roots_dev = torch.as_tensor(treelets.roots, device=dev).long()

    def sweep(td, te, cps, bst):
        """One packet-aligned pair sweep over candidate (ray, treelet)
        columns; returns the min-merged best records (bst unchanged when
        no pair survives the bst.t pruning)."""
        C = td.shape[1]
        if C == 0:
            return bst
        order, key_s, counts, n_act, n_padded = _pair_order(
            td, te, bst.t, T, pkt)
        n_act = int(n_act)
        if n_act == 0:
            return bst
        # the active pairs lead the order; one dead packet at the end
        n_slots = int(n_padded) + pkt
        rows, pkt_tid, slot_src = _pair_fill(
            order[:n_act], key_s[:n_act], counts, cps, bst.t, T, C, pkt,
            n_slots)
        pkt_root = torch.where(pkt_tid >= 0, roots_dev[pkt_tid.clamp(min=0)],
                               0)
        brays = Rays(rows[:, 0:3].contiguous(), rows[:, 3:6].contiguous(),
                     rows[:, 6].contiguous(), rows[:, 7].contiguous())
        h = packet.traverse_bvh8(scene, brays, options, sub=sub,
                                 packet_roots=pkt_root, **kw)
        return _pair_merge(bst, h.t, h.u, h.v, h.prim_id, slot_src)

    for cols in (slice(0, 1), slice(1, K)):
        best = sweep(tid[:, cols], t_entry[:, cols], comps, best)
    if R and _complete:
        best = _completion_sweep(flat, best, n_ent, bmin, bmax, K, T, sweep)
    out = []
    for x in best:
        y = torch.empty_like(x)
        y[sorder] = x
        out.append(y.view(bs))
    return Hits(*out)


def _completion_sweep(flat: Rays, best: Hits, n_ent, bmin, bmax, K, T,
                      sweep) -> Hits:
    """Rays that entered more than K treelet boxes had their K-list
    truncated, and a hit beyond the K-th entry could be missed: re-list
    exactly those rays with all their entries and sweep the columns past
    K, pruned by the best hits so far (unconditional exactness)."""
    max_ent = int(n_ent.max())
    if max_ent <= K:
        return best
    ov = (n_ent > K).nonzero().squeeze(1)
    sub_flat = Rays(*(x[ov] for x in flat))
    te2, td2, _ = _treelet_klists(sub_flat.org, sub_flat.dir, sub_flat.min_t,
                                  sub_flat.max_t, bmin, bmax, min(max_ent, T))
    sub_best = sweep(td2[:, K:], te2[:, K:], _make_comps(sub_flat),
                     Hits(*(x[ov] for x in best)))
    out = []
    for full, part in zip(best, sub_best):
        full = full.clone()
        full[ov] = part
        out.append(full)
    return Hits(*out)
