"""Device-side scene build: LBVH topology -> BVH8/16 packet tables with
no host pass over the primitives (port of
``nanort_tpu.build.device_collapse``; jitted XLA there, plain torch on
the device of the inputs here).

The reference builds on the CPU (nanort.h:1997-2073, a thread pool over
subtrees). This pipeline keeps the build on the device: Morton codes and
the Karras'12 topology (``build/lbvh.py``), then a data-parallel wide
collapse that emits the table format of ``build/bvh8.py``, so
``traverse_bvh8`` takes the result as it is, tensors on the device. The
host never holds the tree: it reads three scalars (the node count, the
leaf-row count and the depth) in one sync between the phases, to size
the tables.

Wide collapse, data-parallel: wide nodes are the kept binary nodes at
depth % K == 0 (K = log2(width)); each wide node's children are the
K-level frontier of its binary subtree, at most 2^K = width of them.
Every kept binary node finds its owning wide node with at most K-1
pointer jumps, every collapsed binary leaf attaches to its ancestor's
wide node, and slot order within a node is a (parent, centroid along the
axis) stable sort, which keeps the kernel's near-first ordered walk.

The tables equal the JAX package's bit for bit:

* every sort is stable (``jnp.argsort`` is), and the record sort is two
  stable sorts, a lexsort by (parent, centroid key);
* every scatter writes unique indices (each node has one parent, each
  record one slot), so no write order can matter; JAX's ``mode="drop"``
  writes become masked writes;
* range boxes are exact min/max queries over the sorted prims, and the
  prefix and suffix mins are log-step folds
  of ``core.math.minimum``, which orders -0.0 below +0.0 and
  propagates NaN as XLA does (torch.minimum returns either zero);
* the tables keep the JAX package's power-of-two padding and its
  trailing park row, which are part of the table format.

Integer lanes of the node and leaf rows (counts, metas, prim ids) are
exact float32 integers up to 2^24, which is checked. The JAX package's
TPU debug scaffold (``NANORT_DEVBUILD_DEBUG``) is not ported.

Tree quality is LBVH-grade; use the native SAH builder and the host
collapse when build time is amortized, and this path when it is not
(huge scenes, geometry generated on the device, interactive rebuilds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import amax, amin, maximum, minimum
from ..ops.triangle import _exact_prod_diff
from .bvh8 import BVH8Scene, EMPTY_BIG, MAX_LEAF_TRIS, _woop_transforms_from
from .lbvh import (MAX_DEPTH, _clz32, _karras_topology, _topology_from_deltas,
                   morton_codes)
from .sah_top import _scan_min, sah_hybrid_deltas, sah_top_partition

_I32MAX = 2**31 - 1

# Prim count up to which the auto (None) extras of collapse_lbvh_device
# (leaf merge, preorder) are on. The threshold was set for a TPU: the JAX
# package measured the extras green at 1M prims and RESOURCE_EXHAUSTED at
# 10M on a 16 GB v5e. The port keeps it, so both packages emit the same
# tables for the same call. On an 80 GB H100 (chip_smoke.py phase 19) the
# extras fit at 9,991,920 prims (13.2 GiB peak against 9.1 with them off)
# but the 8192^2 frame on their tables ran 3.7% slower and the build took
# 1.8x as long, so nothing argues for another default there.
_EXTRAS_MAX_N = 4_000_000
# rows of one range-box query batch (bounds the query temporaries)
QUERY_CHUNK = 1 << 22
# leaf rows filled at once (bounds the leaf-gather temporaries)
LEAF_CHUNK = 1 << 18


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    return 31 - _clz32(x.clamp(min=1))


def _make_range_minmax(sorted_lo, sorted_hi, n: int):
    """Exact (lo, hi) bbox over any index range of the Morton-sorted prim
    boxes, as O(1) gathers from two-tier sparse min-tables (min/max are
    associative, so the values are those of the sequential reduction).

    Tier 1 (ranges of length <= B): a sparse table on the full array,
    levels 0..LOG_SMALL. Tier 2 (longer ranges): per-block suffix/prefix
    mins + a sparse table over block mins. hi rides the same tables
    negated (range max == -range-min of -x).
    """
    dev = sorted_lo.device
    BIG = EMPTY_BIG
    m = torch.cat([sorted_lo, -sorted_hi], dim=1)  # (n, 6)
    LOG_SMALL = 3
    LOG_B = 4
    B = 1 << LOG_B
    n_small_lv = min(LOG_SMALL, max((n - 1).bit_length(), 0)) + 1

    def shift_min(t, s, size):
        out = torch.full_like(t, BIG)
        if s < size:
            out[: size - s] = t[s:]
        return minimum(t, out)

    levels = [m]
    for k in range(1, n_small_lv):
        levels.append(shift_min(levels[-1], 1 << (k - 1), n))

    nb = -(-n // B)
    pad = nb * B - n
    mp = torch.cat([m, torch.full((pad, 6), BIG, dtype=m.dtype, device=dev)]
                   ).reshape(nb, B, 6)
    pre = _scan_min(mp).reshape(nb * B, 6)
    suf = _scan_min(mp, reverse=True).reshape(nb * B, 6)

    bm = amin(mp, 1)  # (nb, 6) block mins
    n_block_lv = max((nb - 1).bit_length(), 0) + 1
    blevels = [bm]
    for k in range(1, n_block_lv):
        blevels.append(shift_min(blevels[-1], 1 << (k - 1), nb))
    tb = torch.cat(blevels, dim=0)  # (n_block_lv * nb, 6)

    def query(a, b):
        """Range (lo, hi) over sorted prims [a, b] inclusive; a <= b."""
        size = b - a + 1
        k = _ilog2(size).clamp(max=n_small_lv - 1)
        small = None
        for j in range(n_small_lv):
            bj = (b - (1 << j) + 1).clamp(min=0)
            cand = minimum(levels[j][a], levels[j][bj])
            small = cand if small is None else torch.where(
                (k == j)[:, None], cand, small)
        if n <= B:
            res = small
        else:
            # big tier: block(a) suffix + interior blocks + block(b) prefix
            ba, bb = a >> LOG_B, b >> LOG_B
            edge = minimum(suf[a], pre[b])
            u, w = ba + 1, bb - 1
            ilen = (w - u + 1).clamp(min=0)
            kb = _ilog2(ilen).clamp(max=n_block_lv - 1)
            offb = kb * nb
            uc = u.clamp(0, nb - 1)
            wc = (w - (torch.ones_like(kb) << kb) + 1).clamp(0, nb - 1)
            interior = minimum(tb[offb + uc], tb[offb + wc])
            big = minimum(edge, torch.where(
                (ilen > 0)[:, None], interior, torch.full_like(interior, BIG)))
            res = torch.where((size <= B)[:, None], small, big)
        return res[:, :3], -res[:, 3:]

    def chunked(a, b):
        parts = [query(a[i:i + QUERY_CHUNK], b[i:i + QUERY_CHUNK])
                 for i in range(0, a.shape[0], QUERY_CHUNK)]
        return tuple(torch.cat(x) for x in zip(*parts))

    return chunked


def _phase_a_topo(vertices, faces, n: int, sah_levels: int = 0,
                  sah_bins: int = 16, sah_stop: int = 64):
    """Phase A, stage 1: Morton sort, Karras topology, and every node /
    collapsed-leaf bbox from the range-min tables (freed on return, before
    the record banks are made).

    ``sah_levels > 0`` inserts the reordering binned-SAH top phase
    (``build/sah_top.py``): the top ``sah_levels`` of the tree follow the
    reference's SAH criterion with real centroid partitioning, Morton
    topology below."""
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    prim_lo = minimum(minimum(v0, v1), v2)
    prim_hi = maximum(maximum(v0, v1), v2)
    del v0, v1, v2
    centers = 0.5 * (prim_lo + prim_hi)
    scene_lo = amin(prim_lo, 0)
    scene_hi = amax(prim_hi, 0)

    codes = morton_codes(centers, scene_lo, scene_hi)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    if sah_levels > 0:
        perm, rcodes = sah_top_partition(
            centers[order], prim_lo[order], prim_hi[order], n,
            levels=sah_levels, bins=sah_bins, stop_cap=sah_stop)
        order = order[perm]
        codes = codes[perm]
        D = sah_hybrid_deltas(codes, rcodes, n, sah_levels)
        first, last, split = _topology_from_deltas(D, n)
    else:
        first, last, split = _karras_topology(codes, n)
    del codes, centers

    # every node (internal or collapsed leaf) covers the contiguous
    # sorted-prim range [first, last]: all boxes are range queries
    range_query = _make_range_minmax(prim_lo[order], prim_hi[order], n)
    lf_lo, lf_hi = range_query(first, split)
    rf_lo, rf_hi = range_query(split + 1, last)
    node_lo, node_hi = range_query(first, last)
    axis_i = torch.argmax(node_hi - node_lo, dim=1)
    return (order, first, last, split, scene_lo,
            lf_lo, lf_hi, rf_lo, rf_hi, node_lo, node_hi, axis_i)


def _center_key(lo, hi, pax, scene_lo):
    """Slot-order key: centroid along the parent's axis, shifted
    non-negative so its float32 bits order as int32."""
    c = 0.5 * (lo + hi)
    ck = c.gather(1, pax[:, None])[:, 0]
    x = maximum(ck - scene_lo[pax], torch.zeros_like(ck))
    return x.view(torch.int32).long()


def _phase_a_records(order, first, last, split, scene_lo, lf_lo, lf_hi,
                     rf_lo, rf_hi, node_lo, node_hi, axis_i, n: int,
                     max_leaf: int, K: int, merge_leaves: bool = False):
    """Phase A, stage 2: child records, sorted by (wide parent, slot
    order): per-record columns (invalid records sort to the end) plus
    the three scalars the host reads to size phase B's tables."""
    dev = first.device
    ni = n - 1
    iar = torch.arange(ni, device=dev)

    size = last - first + 1
    l_size = split - first + 1
    r_size = last - split
    l_leaf = l_size <= max_leaf
    r_leaf = r_size <= max_leaf
    keep = size > max_leaf
    l_child, r_child = split, split + 1
    okl = keep & ~l_leaf  # left child is a kept internal node
    okr = keep & ~r_leaf

    # ---- parent pointers + depth over the KEPT tree ----
    par = torch.zeros(ni, dtype=torch.long, device=dev)  # root: itself
    par[l_child[okl]] = iar[okl]
    par[r_child[okr]] = iar[okr]
    # depth by pointer doubling over parent links; par[0] == 0 ends every
    # chain; non-kept entries read garbage that nothing downstream uses
    depth = torch.where(iar == 0, 0, 1)
    jmp = par
    for _ in range(MAX_DEPTH.bit_length()):
        depth, jmp = depth + depth[jmp], jmp[jmp]

    # ---- wide roots: kept nodes at depth % K == 0 ----
    wroot = keep & (depth % K == 0)
    rem = depth % K
    anc = iar  # wide ancestor: jump up (depth % K) parents
    for j in range(K - 1):
        anc = torch.where(j < rem, par[anc], anc)
    # wide parent of a wide root = its parent's wide ancestor
    anc_up = anc[par]

    # BFS-ordered wide ids: (level, first) is unique per wide root
    wkey = torch.where(wroot, (depth // K) * n + first, _I32MAX)
    worder = torch.argsort(wkey, stable=True)
    wrank = torch.empty_like(worder)
    wrank[worder] = iar
    nw = wroot.sum()

    zeros = torch.zeros(ni, dtype=torch.long, device=dev)
    # internal bank: every wide root except the binary root
    val_i = wroot & (iar != 0)
    bank_i = dict(
        par=torch.where(val_i, wrank[anc_up], _I32MAX),
        key=_center_key(node_lo, node_hi, axis_i[anc_up], scene_lo),
        meta=wrank, cnt=zeros, a=zeros, leaf=zeros, lo=node_lo, hi=node_hi)
    # left / right collapsed-leaf banks
    pax_l = axis_i[anc]
    val_l = keep & l_leaf
    bank_l = dict(
        par=torch.where(val_l, wrank[anc], _I32MAX),
        key=_center_key(lf_lo, lf_hi, pax_l, scene_lo),
        meta=zeros, cnt=l_size, a=first, leaf=val_l.long(), lo=lf_lo,
        hi=lf_hi)
    val_r = keep & r_leaf
    bank_r = dict(
        par=torch.where(val_r, wrank[anc], _I32MAX),
        key=_center_key(rf_lo, rf_hi, pax_l, scene_lo),
        meta=zeros, cnt=r_size, a=r_child, leaf=val_r.long(), lo=rf_lo,
        hi=rf_hi)
    banks = [bank_i, bank_l, bank_r]

    if merge_leaves:
        # collapsed leaves tile the morton-sorted prim range, so sorted by
        # prim start they are range-adjacent; merging neighbours of the
        # SAME wide parent up to max_leaf removes rows without touching
        # the tree above the leaves. Two odd-even (run-parity) rounds.
        cols = ("par", "cnt", "a", "leaf", "lo", "hi")
        lv = {c: torch.cat([bank_l[c], bank_r[c]]) for c in cols}
        iar2 = torch.arange(2 * ni, device=dev)

        def sort_leaves(key):
            o = torch.argsort(key, stable=True)
            for c in cols:
                lv[c] = lv[c][o]

        sort_leaves(torch.where(lv["leaf"] == 1, lv["a"], _I32MAX))
        for _ in range(2):
            nxt = {c: torch.roll(lv[c], -1, 0) for c in cols}
            ok = ((lv["leaf"] == 1) & (nxt["leaf"] == 1)
                  & (lv["par"] == nxt["par"])
                  & (lv["cnt"] + nxt["cnt"] <= max_leaf))
            ok[-1] = False
            # run parity: merge i with i+1 only at even offsets within
            # each maximal ok-run (run first via cumulative max)
            start = torch.cat([ok.new_ones(1), ~ok[:-1]])
            run_first = torch.cummax(torch.where(start, iar2, -1), 0).values
            do = ok & ((iar2 - run_first) % 2 == 0)
            absorbed = torch.cat([ok.new_zeros(1), do[:-1]])
            lv["cnt"] = torch.where(do, lv["cnt"] + nxt["cnt"], lv["cnt"])
            lv["lo"] = torch.where(do[:, None],
                                   minimum(lv["lo"], nxt["lo"]), lv["lo"])
            lv["hi"] = torch.where(do[:, None],
                                   maximum(lv["hi"], nxt["hi"]), lv["hi"])
            lv["leaf"] = torch.where(absorbed, 0, lv["leaf"])
            # compact survivors back to adjacency for the next round
            sort_leaves(torch.where(lv["leaf"] == 1, iar2, _I32MAX))
        # slot keys of the merged boxes (axis of the wide parent, by rank)
        pax_m = axis_i[worder][lv["par"].clamp(0, ni - 1)]
        lv["key"] = _center_key(lv["lo"], lv["hi"], pax_m, scene_lo)
        lv["par"] = torch.where(lv["leaf"] != 1, _I32MAX, lv["par"])
        lv["meta"] = torch.zeros(2 * ni, dtype=torch.long, device=dev)
        banks = [bank_i, lv]

    def cat(f):
        return torch.cat([b[f] for b in banks])

    rp, rk = cat("par"), cat("key")
    # lexsort by (parent, center key) as two stable argsorts
    idx1 = torch.argsort(rk, stable=True)
    perm = idx1[torch.argsort(rp[idx1], stable=True)]
    sp = rp[perm]
    s_meta, s_cnt, s_a, s_leaf = (cat(f)[perm] for f in
                                  ("meta", "cnt", "a", "leaf"))
    slo, shi = cat("lo")[perm], cat("hi")[perm]
    leaf_rank = torch.cumsum(s_leaf, 0) - s_leaf
    n_rows = s_leaf.sum()
    s_meta = torch.where(s_leaf == 1, -(leaf_rank + 1), s_meta)

    wide_depth = torch.where(wroot, depth, 0).max() // K + 1
    node_axis = axis_i[worder]  # by output node id
    return (order, sp, s_meta, s_cnt, s_a, s_leaf, leaf_rank, slo, shi,
            node_axis, nw, n_rows, wide_depth)


def _woop_rows(tris, pids, max_leaf: int, nrows: int):
    """Woop unit-triangle transform rows from per-slot gathered
    triangles: the layout of ``collapse_bvh8(woop=True)`` (12 f32 per tri
    — [M row-major | anchor p0] at lanes 12t, prim ids at lane 108+t).

    The host builder computes M in f64 (``bvh8._woop_transforms_from``);
    here the cross products run as Dekker two-product differences in f32
    (exact to one rounding each), so entries agree with the
    f64-then-round path to ~1-2 ulp, as in the JAX package."""

    def cross_exact(x, y):
        return (
            _exact_prod_diff(x[1], y[2], x[2], y[1]),
            _exact_prod_diff(x[2], y[0], x[0], y[2]),
            _exact_prod_diff(x[0], y[1], x[1], y[0]),
        )

    dev = pids[0].device
    parts = []
    for t in range(max_leaf):
        g = tris[t]  # (nrows, 9) = p0 p1 p2
        p0 = tuple(g[:, k] for k in range(3))
        e1 = tuple(g[:, 3 + k] - g[:, k] for k in range(3))
        e2 = tuple(g[:, 6 + k] - g[:, k] for k in range(3))
        nrm = cross_exact(e1, e2)
        det = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2]
        ok = det > 0.0
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        r0 = cross_exact(e2, nrm)
        r1 = cross_exact(nrm, e1)
        cols = ([r0[k] * inv for k in range(3)]
                + [r1[k] * inv for k in range(3)]
                + [nrm[k] * inv for k in range(3)] + list(p0))
        parts.append(torch.stack(cols, dim=1))

    def z(w):
        return torch.zeros((nrows, w), dtype=torch.float32, device=dev)

    return torch.cat(parts + [z(108 - 12 * max_leaf),
                              torch.stack(pids, dim=1),
                              z(128 - 108 - max_leaf)], dim=1)


def _phase_b(vertices, faces, order, sp, s_meta, s_cnt, s_a, s_leaf,
             leaf_rank, slo, shi, node_axis, n: int, width: int,
             max_leaf: int, nw_pad: int, nrows_pad: int, woop: bool = False):
    """Table fill: gather child records into node rows, gather
    morton-ordered triangles into leaf rows (the sort in phase A already
    grouped records by destination node)."""
    dev = vertices.device
    f32 = torch.float32
    nrec = sp.shape[0]
    W = width
    seg = torch.searchsorted(sp, torch.arange(nw_pad + 1, device=dev))
    axis_f = torch.zeros(nw_pad, dtype=f32, device=dev)
    k_ax = min(nw_pad, node_axis.shape[0])
    axis_f[:k_ax] = node_axis[:k_ax].to(f32)
    comps = [slo[:, k] for k in range(3)] + [shi[:, k] for k in range(3)]
    s_meta_f, s_cnt_f = s_meta.to(f32), s_cnt.to(f32)

    # per slot: its record (if any) in each node's segment
    boxes, metas, cnts = [], [], []
    for s in range(W):
        idx = seg[:-1] + s
        valid = idx < seg[1:]
        idxc = idx.clamp(0, nrec - 1)
        boxes.append([torch.where(valid, comps[k][idxc],
                                  EMPTY_BIG if k < 3 else -EMPTY_BIG)
                      for k in range(6)])
        metas.append(torch.where(valid, s_meta_f[idxc], 0.0))
        cnt = torch.where(valid, s_cnt_f[idxc], 0.0)
        if W == 16 and s == 0:
            # order axis rides the child-0 count lane (cnt + 16*axis)
            cnt = cnt + 16.0 * axis_f
        cnts.append(cnt)
    if W == 16:
        # box lanes 6s..6s+5, meta 96+s, count 112+s
        nodes = torch.cat(
            [torch.stack(b, dim=1) for b in boxes]
            + [torch.stack(metas, dim=1), torch.stack(cnts, dim=1)], dim=1)
    else:
        # box lanes 8c..8c+5 (6, 7 stay 0), meta 64+c, count 72+c, axis 80
        nodes = torch.zeros((nw_pad, 128), dtype=f32, device=dev)
        for s in range(W):
            for k in range(6):
                nodes[:, 8 * s + k] = boxes[s][k]
            nodes[:, 64 + s] = metas[s]
            nodes[:, 72 + s] = cnts[s]
        nodes[:, 80] = axis_f
    del boxes, metas, cnts

    # ---- leaf rows: row r holds the prims of leaf record rank r; the
    # slots past a leaf's count hold the next prims (never tested)
    is_leaf = s_leaf == 1
    A = torch.zeros(nrows_pad, dtype=torch.long, device=dev)
    A[leaf_rank[is_leaf]] = s_a[is_leaf]
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    soup = torch.cat([v0, v1, v2, torch.arange(n, device=dev).to(f32)[:, None]],
                     dim=1)[order]  # morton order; col 9 = prim
    del v0, v1, v2
    leafs = torch.empty((nrows_pad, 128), dtype=f32, device=dev)
    lw = torch.empty_like(leafs) if woop else None
    for a in range(0, nrows_pad, LEAF_CHUNK):
        Ac = A[a:a + LEAF_CHUNK]
        m = Ac.shape[0]
        vparts, pids = [], []
        for t in range(max_leaf):
            g = soup[(Ac + t).clamp(0, n - 1)]
            vparts.append(g[:, :9])
            pids.append(g[:, 9])
        leafs[a:a + m] = torch.cat(
            vparts + [torch.zeros((m, 90 - 9 * max_leaf), dtype=f32,
                                  device=dev), torch.stack(pids, dim=1),
                      torch.zeros((m, 128 - 90 - max_leaf), dtype=f32,
                                  device=dev)], dim=1)
        if woop:
            lw[a:a + m] = _woop_rows(vparts, pids, max_leaf, m)
    return nodes, leafs, lw


def _preorder_tables(nodes, leafs, leafs_woop, depth: int):
    """DFS-preorder renumbering of finished width-16 tables.

    Pure relabeling: traversal visits the same nodes in the same order
    and the records are bit-identical, but a pop's child fetch address is
    usually adjacent, like the host collapse's emission order. Pad rows
    (empty boxes, the kernel's park row among them) keep their order
    after the reachable ones; the root stays row 0."""
    dev = nodes.device
    NW = nodes.shape[0]
    NL = leafs.shape[0]
    valid = nodes[:, 0:96:6] <= nodes[:, 3:96:6]  # (NW, 16) slot live
    meta = nodes[:, 96:112].to(torch.int32).long()
    is_int = valid & (meta >= 0)
    is_leaf = valid & (meta < 0)
    child = torch.where(is_int, meta, 0)
    rows16 = torch.arange(NW, device=dev)[:, None].expand(NW, 16)
    zero = torch.zeros((), dtype=torch.long, device=dev)

    # reachability (real nodes; pads have no parents and no slots)
    reach = torch.zeros(NW, dtype=torch.long, device=dev)
    reach[child[is_int]] = 1
    reach[0] = 1

    # subtree node counts, bottom-up fixpoint (depth iterations)
    size = torch.ones(NW, dtype=torch.long, device=dev)
    for _ in range(depth):
        size = 1 + torch.where(is_int, size[child], zero).sum(1)

    # preorder ids, top-down fixpoint: child = parent + 1 + sizes of
    # preceding INTERNAL siblings (leaf slots consume no node ids)
    csz = torch.where(is_int, size[child], zero)
    excl = torch.cumsum(csz, dim=1) - csz
    pre = torch.zeros(NW, dtype=torch.long, device=dev)
    for _ in range(depth + 1):
        new = pre.clone()
        new[child[is_int]] = (pre[:, None] + 1 + excl)[is_int]
        pre = new
    pad_rank = torch.cumsum(1 - reach, 0) - (1 - reach)
    new_node = torch.where(reach == 1, pre, reach.sum() + pad_rank)

    # leaf rows in first-touch (preorder, slot-order) order
    lrow = torch.where(is_leaf, -meta - 1, 0)
    lkey = torch.where(is_leaf, new_node[rows16] * 16
                       + torch.arange(16, device=dev)[None, :],
                       _I32MAX).reshape(-1)
    lorder = torch.argsort(lkey, stable=True)  # leaf slots first
    touched = torch.zeros(NL, dtype=torch.long, device=dev)
    touched[lrow[is_leaf]] = 1
    srow = lrow.reshape(-1)[lorder]
    skey = lkey[lorder]
    sel = skey != _I32MAX
    new_leaf = torch.zeros(NL, dtype=torch.long, device=dev)
    new_leaf[srow[sel]] = torch.arange(lkey.shape[0], device=dev)[sel]
    # untouched pad rows append after the touched ones, order kept
    new_leaf = torch.where(touched == 1, new_leaf, touched.sum()
                           + torch.cumsum(1 - touched, 0) - (1 - touched))

    new_meta = torch.where(is_int, new_node[child], meta)
    new_meta = torch.where(is_leaf, -(new_leaf[lrow] + 1), new_meta)
    nodes = nodes.clone()
    nodes[:, 96:112] = new_meta.to(nodes.dtype)

    def permute(x, to):
        out = torch.zeros_like(x)
        out[to] = x  # `to` is a permutation
        return out

    return (permute(nodes, new_node), permute(leafs, new_leaf),
            None if leafs_woop is None else permute(leafs_woop, new_leaf))


def preorder_device(scene: BVH8Scene, donate: bool = False) -> BVH8Scene:
    """Renumber a width-16 scene's tables into DFS preorder on their
    device (see ``_preorder_tables``). No-op relabeling for traversal
    semantics. ``donate`` is taken for the JAX signature and changes
    nothing: torch frees the input tables when the caller drops them."""
    del donate
    if getattr(scene, "width", 8) != 16:
        raise ValueError("preorder_device supports width-16 tables")
    nodes, leafs, woop = _preorder_tables(
        torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs),
        None if scene.leafs_woop is None
        else torch.as_tensor(scene.leafs_woop), int(scene.depth))
    return scene._replace(nodes=nodes, leafs=leafs, leafs_woop=woop)


def _tiny_scene(v, f, n, width, woop, dev) -> BVH8Scene:
    """One node, one leaf row (host-assembled, as the JAX package does)."""
    lo = v[f].min(axis=(0, 1))
    hi = v[f].max(axis=(0, 1))
    nodes = np.zeros((2, 128), np.float32)
    if width == 16:
        for ax in range(3):
            nodes[:, ax:96:6] = EMPTY_BIG
            nodes[:, 3 + ax:96:6] = -EMPTY_BIG
        nodes[0, 0:3], nodes[0, 3:6] = lo, hi
        nodes[0, 96] = -1.0
        nodes[0, 112] = float(n)
    else:
        for k in range(3):
            nodes[:, k:64:8] = EMPTY_BIG
            nodes[:, 3 + k:64:8] = -EMPTY_BIG
        nodes[0, 0:3], nodes[0, 3:6] = lo, hi
        nodes[0, 64] = -1.0
        nodes[0, 72] = float(n)
    leafs = np.zeros((1, 128), np.float32)
    for t in range(n):
        leafs[0, 9 * t: 9 * t + 9] = v[f[t]].reshape(-1)
        leafs[0, 90 + t] = float(t)
    lw = None
    if woop:
        wflat = _woop_transforms_from(v, f, np.arange(n))
        lw = np.zeros((1, 128), np.float32)
        for t in range(n):
            lw[0, 12 * t: 12 * t + 12] = wflat[t]
            lw[0, 108 + t] = float(t)
        lw = torch.from_numpy(lw).to(dev)
    return BVH8Scene(
        nodes=torch.from_numpy(nodes).to(dev),
        leafs=torch.from_numpy(leafs).to(dev), num_nodes=1,
        num_leaf_rows=1, depth=1, max_leaf=n, width=width, leafs_woop=lw)


def collapse_lbvh_device(
    vertices,
    faces,
    width: int = 16,
    max_leaf: int = 9,
    woop: bool = False,
    sah_levels: int = 0,
    sah_bins: int = 16,
    sah_stop: int = 64,
    merge_leaves: bool | None = None,
    preorder: bool | None = None,
    device=None,
) -> BVH8Scene:
    """One-call device scene build: triangles in, packet-kernel BVH
    tables out, as contiguous float32 tensors on ``device`` (default: the
    device of ``vertices`` when it is a tensor, else the card), ready for
    ``traverse_bvh8`` with no ``to()``. Tables are padded to powers of
    two; the trailing pad node doubles as the kernel's park row (empty
    boxes never hit).

    ``woop=True`` also bakes the Woop unit-triangle table on the device
    (``leafs_woop``, ``intersector="woop"``).

    ``merge_leaves``: greedily merge range-adjacent collapsed leaves of
    the same wide parent up to ``max_leaf`` (two run-parity rounds; the
    tree above the leaves is unchanged). ``preorder``: renumber the
    finished tables into DFS preorder (pure relabeling, records
    bit-identical). Both apply to width 16 and default to AUTO (``None``):
    on up to ``_EXTRAS_MAX_N`` prims, off above, a threshold the JAX
    package set for a TPU's memory and the port keeps so that both emit
    the same tables. Pass ``True`` to force."""
    if width not in (8, 16):
        raise ValueError(f"width must be 8 or 16: {width}")
    if not 1 <= max_leaf <= min(MAX_LEAF_TRIS, 15):
        raise ValueError(f"max_leaf must be in [1, 15]: {max_leaf}")
    if woop and max_leaf > 9:
        raise ValueError("woop rows hold <= 9 tris; use max_leaf <= 9")
    if device is None:
        device = vertices.device if isinstance(vertices, torch.Tensor) \
            else "cuda"
    dev = torch.device(device)
    vertices = torch.as_tensor(vertices, device=dev).to(torch.float32)
    faces = torch.as_tensor(faces, device=dev).long()
    n = int(faces.shape[0])
    if merge_leaves is None:
        merge_leaves = n <= _EXTRAS_MAX_N
    if preorder is None:
        preorder = n <= _EXTRAS_MAX_N
    if n > (1 << 24):
        raise ValueError("BVH8 float-int lanes are exact to 2^24 prims")
    K = 4 if width == 16 else 3

    if n == 0:
        raise ValueError("no primitives")
    if n <= max_leaf:
        return _tiny_scene(vertices.cpu().numpy(), faces.cpu().numpy(), n,
                           width, woop, dev)

    topo = _phase_a_topo(vertices, faces, n=n, sah_levels=sah_levels,
                         sah_bins=sah_bins, sah_stop=sah_stop)
    (order, sp, s_meta, s_cnt, s_a, s_leaf, leaf_rank, slo, shi,
     node_axis, nw, n_rows, wide_depth) = _phase_a_records(
        *topo, n=n, max_leaf=max_leaf, K=K,
        merge_leaves=bool(merge_leaves) and width == 16)
    del topo
    # the one host read between the phases: the tables' sizes
    nw_i, nrows_i, depth_i = torch.stack([nw, n_rows, wide_depth]).tolist()
    nw_pad = _next_pow2(nw_i + 1)  # +1: trailing pad node = park row
    nrows_pad = _next_pow2(max(nrows_i, 1))
    nodes, leafs, leafs_woop = _phase_b(
        vertices, faces, order, sp, s_meta, s_cnt, s_a, s_leaf, leaf_rank,
        slo, shi, node_axis, n=n, width=width, max_leaf=max_leaf,
        nw_pad=nw_pad, nrows_pad=nrows_pad, woop=woop)
    del sp, s_meta, s_cnt, s_a, s_leaf, leaf_rank, slo, shi
    scene = BVH8Scene(
        nodes=nodes, leafs=leafs, num_nodes=nw_i, num_leaf_rows=nrows_i,
        depth=depth_i, max_leaf=max_leaf, width=width,
        leafs_woop=leafs_woop)
    if preorder and width == 16:
        scene = preorder_device(scene)
    return scene
