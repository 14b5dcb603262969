"""Device LBVH builder: Morton sort and Karras'12 topology (port of
``nanort_tpu.build.lbvh``; jitted XLA there, plain torch here, on the
device of its inputs).

The reference's parallel build is a CPU thread pool over subtrees
(nanort.h:1997-2073). The data-parallel construction:

  1. 30-bit Morton codes of primitive centroids (bit-interleave by magic
     masks),
  2. a stable sort of the codes,
  3. Karras (HPG 2012) internal-node ranges and splits from the adjacent
     common-prefix deltas (duplicate codes broken by index, through a
     count of leading zeros built from integer ops: torch has no
     population count),
  4. subtree collapse into leaves of <= max_leaf primitives (leaves are
     keyed by (parent, side): ranges, not single Karras leaves),
  5. bottom-up bbox refit by ``MAX_DEPTH`` fixed-point passes,
  6. DFS-preorder numbering from subtree sizes (a top-down fixed point),
     emitting the reference's linear ``BVHNode`` layout (left == parent +
     1, contiguous leaf ranges), so every traversal engine and ``dump``
     take the tree unchanged.

Morton codes are uint32 in the JAX package; here they are int64 tensors
holding the same values (as prim ids are, ``core/ray.py``), so no shift
or product wraps. Every sort is stable, as ``jnp.argsort`` is, and every
scatter writes unique indices (each node has one parent), so the arrays
equal the JAX package's bit for bit. The fixed-point passes keep the JAX
package's count: each is a few launches, and stopping early would need a
host sync a pass.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bvh import BVH, stats_from_bvh
from ..core.math import amax, amin, maximum, minimum
from ..core.options import BVHBuildStatistics

MAX_DEPTH = 64  # fixed-point iteration bound

# int8 sentinels for the sparse-table descent. Real deltas live in
# [D_FLOOR+3, 64]: Morton deltas are >= 0; agglomerative boundary
# overrides (hybrid_deltas) go down to -(I_SA + log2 rounds + 2).
_D_PAD = -128   # out-of-range table pad: fails every `> dmin`
_D_EDGE = -125  # virtual delta outside [0, n): below all real
D_FLOOR = -120  # overrides must stay above this
_I32MAX = 2**31 - 1


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (the standard Morton magic;
    int64 holding uint32 values, so no product wraps)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centers, bmin, bmax) -> torch.Tensor:
    """30-bit Morton codes (int64) of normalized float32 centroids."""
    ext = torch.clamp(bmax - bmin, min=1e-30)
    q = ((centers - bmin) / ext * 1024.0).clamp(0.0, 1023.0)
    # a NaN centroid quantizes to 0, as XLA's float -> uint32 does
    q = torch.nan_to_num(q, nan=0.0).long()
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (SWAR: pair, nibble and
    byte sums, then the byte sum from one product)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (32 for 0): smear the
    top bit down, then count the set bits, as the JAX package does."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - _popcount32(x)


def _morton_deltas(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Adjacent-pair deltas D[k] = delta(k, k+1) over sorted codes
    (common-prefix length; duplicate codes tie-broken by index exactly
    as Karras's pairwise delta, values in [0, 64])."""
    i = torch.arange(n - 1, device=codes.device)
    x = codes[:-1] ^ codes[1:]
    return torch.where(x == 0, 32 + _clz32(i ^ (i + 1)), _clz32(x))


def _karras_topology(codes: torch.Tensor, n: int):
    """(first, last, split) per internal node over sorted codes: the
    Cartesian tree of the deltas (see _topology_from_deltas), identical
    to Karras'12."""
    return _topology_from_deltas(_morton_deltas(codes, n), n)


def _topology_from_deltas(D: torch.Tensor, n: int):
    """(first, last, split) per internal node of the binary tree over
    contiguous ranges of the sorted array defined by the adjacent-delta
    array ``D`` (n-1,): every node splits at the LEFTMOST minimum delta
    of its range (the Cartesian tree of D), Karras'12's contract for
    ARBITRARY deltas in [D_FLOOR+3, 64].

    delta(a, b) == min D[a..b-1], so the range end is a greedy aligned
    sparse-table descent (one table gather per bit of range length), and
    the split a second descent from ``first`` extending while the window
    min stays above the node delta.

    Node indexing: internal node i has i as one of its range endpoints;
    children of the node splitting at s are internal nodes s (left,
    range [first, s]) and s+1 (right, [s+1, last]): the endpoint
    bijection ``device_collapse`` and ``build_lbvh`` rely on.
    """
    m = n - 1
    dev = D.device
    i = torch.arange(m, device=dev)
    D = D.long()

    # per-level sparse min-tables over D, int8 (real deltas fit), padded
    # with _D_PAD so out-of-range windows FAIL the `> dmin` test
    n_lv = max(int(m).bit_length(), 1)
    levels = [D.to(torch.int8)]
    for k in range(1, n_lv):
        s = 1 << (k - 1)
        t = levels[-1]
        ext = torch.full_like(t, _D_PAD)
        if s < m:
            ext[: m - s] = t[s:]
        levels.append(torch.minimum(t, ext))

    dp1 = D  # delta(i, i+1)
    dm1 = torch.where(i > 0, torch.cat([D[:1], D[:-1]]),
                      torch.full_like(D, _D_EDGE))
    d = torch.where(dp1 >= dm1, 1, -1)  # ties go right (Karras)
    dmin = torch.where(d > 0, dm1, dp1)

    # greedy descent: extend the run [i, i+l*d] while every adjacent
    # delta inside stays > dmin; windows align to the current length, so
    # the taken windows tile the final span and their running min IS
    # delta(i, j) (= dnode)
    l = torch.zeros_like(i)
    dnode = torch.full_like(i, _I32MAX)
    for k in range(n_lv - 1, -1, -1):
        w = 1 << k
        # window of D indices: d=+1 -> [i+l, i+l+w-1]; d=-1 -> [i-l-w, i-l-1]
        p = torch.where(d > 0, i + l, i - l - w)
        # windows STARTING out of range fail explicitly (the clamp would
        # alias them onto valid rows); windows EXTENDING past m-1 fail
        # through the pad
        ok = (p >= 0) & (p <= m - 1)
        v = levels[k][p.clamp(0, m - 1)].long()
        take = ok & (v > dmin)
        l = torch.where(take, l + w, l)
        dnode = torch.where(take, torch.minimum(dnode, v), dnode)

    j = i + l * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # split = leftmost position p of D == dnode in [first, last-1]: a
    # second descent extends from `first` while min D stays > dnode
    sl = torch.zeros_like(i)
    for k in range(n_lv - 1, -1, -1):
        w = 1 << k
        v = levels[k][(first + sl).clamp(0, m - 1)].long()
        sl = torch.where(v > dnode, sl + w, sl)
    return first, last, first + sl


def _sa_min_form(mrow: torch.Tensor) -> torch.Tensor:
    """Half surface area of min-form rows [lo | -hi]."""
    d = torch.clamp(-mrow[:, 3:6] - mrow[:, 0:3], min=0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def hybrid_deltas(codes, sorted_lo, sorted_hi, n: int, C: int = 32,
                  i_sa: int = 88) -> torch.Tensor:
    """Adjacent-delta array whose Cartesian tree is a HYBRID topology:
    a surface-area-greedy agglomerative tree over Morton-ordered
    clusters of ``C`` prims at the TOP, Karras/Morton topology within
    clusters. Feed to _topology_from_deltas.

    The JAX package records it as a measured negative result (about 20%
    worse true SAH cost than plain Karras on its scenes); it is kept as
    tested machinery for arbitrary-delta topologies.

    The agglomeration runs over nc = ceil(n/C) cluster slots as a
    doubly-linked list: each round, every adjacent pair (i, next(i))
    whose merged surface area is a strict lexicographic local minimum
    (ties by index) merges; the boundary consumed at global step t gets
    delta -(t+2). ``i_sa`` SA-guided rounds are followed by
    ceil(log2(nc))+1 forced parity-merge rounds, so every boundary is
    consumed inside the int8 delta floor."""
    D = _morton_deltas(codes, n)
    nc = -(-n // C)
    if nc <= 1:
        return D
    dev = D.device
    BIG = 3.0e38
    tail = max(int(nc - 1).bit_length(), 1) + 1
    if i_sa + tail + 2 > -D_FLOOR - 3:
        raise ValueError("i_sa too large for the int8 delta floor")

    mrow = torch.cat([sorted_lo, -sorted_hi], dim=1)  # (n, 6) min-form
    pad = nc * C - n
    mp = torch.cat([mrow, torch.full((pad, 6), BIG, dtype=mrow.dtype,
                                     device=dev)]).reshape(nc, C, 6)
    box = amin(mp, 1)  # (nc, 6)

    idx = torch.arange(nc, device=dev)
    nxt = idx + 1       # nc == none
    prv = idx - 1       # -1 == none
    last = idx.clone()  # cluster-unit end of slot's range
    alive = torch.ones(nc, dtype=torch.bool, device=dev)
    t_of = torch.zeros(max(nc - 1, 1), dtype=torch.long, device=dev)
    inf = torch.tensor(float("inf"), dtype=mrow.dtype, device=dev)

    def less(ca, ia, cb, ib):
        return (ca < cb) | ((ca == cb) & (ia < ib))

    for t in range(i_sa + tail):
        j = nxt.clamp(max=nc - 1)
        has_next = alive & (nxt < nc)
        ub = minimum(box, box[j])
        cost = torch.where(has_next, _sa_min_form(ub), inf)
        if t >= i_sa:  # forced parity rounds
            rank = torch.cumsum(alive.long(), 0) - 1
            merge = has_next & (rank % 2 == 0)
        else:
            pm = prv.clamp(min=0)
            pc = torch.where(prv >= 0, cost[pm], inf)
            merge = (has_next & less(cost, idx, pc, pm)
                     & less(cost, idx, cost[j], j))
        # consume boundary last[i] at step t; the merging slots' boundaries
        # and right partners are distinct (no two adjacent pairs merge)
        t_of[last[merge]] = t
        box = torch.where(merge[:, None], ub, box)
        last = torch.where(merge, last[j], last)
        new_next = torch.where(merge, nxt[j], nxt)
        dead = torch.zeros(nc, dtype=torch.bool, device=dev)
        dead[j[merge]] = True
        alive = alive & ~dead
        nxt = new_next
        prv[new_next.clamp(max=nc - 1)[merge]] = idx[merge]

    bidx = (torch.arange(nc - 1, device=dev) + 1) * C - 1
    D = D.clone()
    D[bidx] = -(t_of[: nc - 1] + 2)
    return D


def _build_lbvh_arrays(prim_bmin, prim_bmax, prim_centers, n: int,
                       max_leaf: int):
    """The device arrays of ``build_lbvh`` (the JAX package's
    ``_build_lbvh_jit``)."""
    dev = prim_bmin.device
    scene_lo = amin(prim_bmin, 0)
    scene_hi = amax(prim_bmax, 0)
    codes = morton_codes(prim_centers, scene_lo, scene_hi)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]

    first, last, split = _karras_topology(codes, n)
    ni = n - 1
    size = last - first + 1
    l_first, l_last = first, split
    r_first, r_last = split + 1, last
    l_size = l_last - l_first + 1
    r_size = r_last - r_first + 1
    l_leaf = l_size <= max_leaf  # collapsed-leaf children
    r_leaf = r_size <= max_leaf
    l_child = split  # internal id when not a leaf (Karras child rule)
    r_child = split + 1
    keep = size > max_leaf  # surviving internal nodes

    # ---- bboxes ----
    sorted_lo = prim_bmin[order]
    sorted_hi = prim_bmax[order]

    def range_bbox(a, count):
        lo = sorted_lo[a]
        hi = sorted_hi[a]
        for k in range(1, max_leaf):
            valid = (k < count)[:, None]
            g = (a + k).clamp(max=n - 1)
            lo = torch.where(valid, minimum(lo, sorted_lo[g]), lo)
            hi = torch.where(valid, maximum(hi, sorted_hi[g]), hi)
        return lo, hi

    lf_lo, lf_hi = range_bbox(l_first, l_size)  # left-leaf bbox per parent
    rf_lo, rf_hi = range_bbox(r_first, r_size)

    lo = torch.full((ni, 3), 3e38, dtype=torch.float32, device=dev)
    hi = torch.full((ni, 3), -3e38, dtype=torch.float32, device=dev)
    rc = r_child.clamp(max=ni - 1)  # a leaf's id may be ni; never read
    for _ in range(MAX_DEPTH):
        llo = torch.where(l_leaf[:, None], lf_lo, lo[l_child])
        lhi = torch.where(l_leaf[:, None], lf_hi, hi[l_child])
        rlo = torch.where(r_leaf[:, None], rf_lo, lo[rc])
        rhi = torch.where(r_leaf[:, None], rf_hi, hi[rc])
        lo, hi = minimum(llo, rlo), maximum(lhi, rhi)
    node_lo, node_hi = lo, hi
    axis_i = torch.argmax(node_hi - node_lo, dim=1)

    # ---- emitted subtree sizes ----
    sizes = torch.ones(ni, dtype=torch.long, device=dev)
    for _ in range(MAX_DEPTH):
        sl = torch.where(l_leaf, 1, sizes[l_child])
        sr = torch.where(r_leaf, 1, sizes[rc])
        sizes = 1 + sl + sr

    # ---- DFS preorder (top-down fixed point) ----
    # pre_i[k]: preorder slot of internal k; each kept internal child has
    # one parent, so the writes below never collide
    sl_ = torch.where(l_leaf, 1, sizes[l_child])
    okl = keep & ~l_leaf
    okr = keep & ~r_leaf
    pre_i = torch.zeros(ni, dtype=torch.long, device=dev)
    for _ in range(MAX_DEPTH):
        new = pre_i.clone()
        new[r_child[okr]] = (pre_i + 1 + sl_)[okr]
        new[l_child[okl]] = (pre_i + 1)[okl]
        pre_i = new
    pre_l = pre_i + 1  # left child slot (leaf or internal)
    pre_r = pre_i + 1 + sl_
    return (order, first, last, split, l_leaf, r_leaf, keep, pre_i,
            pre_l, pre_r, node_lo, node_hi, lf_lo, lf_hi, rf_lo, rf_hi,
            axis_i, l_size, r_size)


def build_lbvh(prim_bmin, prim_bmax, prim_centers=None, max_leaf: int = 4,
               device=None) -> tuple[BVH, BVHBuildStatistics]:
    """Build a reference-layout linear BVH on the device; the host
    assembly is a handful of vectorized scatters. Inputs may be NumPy
    arrays or tensors; the build runs on ``device`` (default: the
    device of ``prim_bmin`` when it is a tensor, else the card)."""
    t0 = time.perf_counter()
    if device is None:
        device = prim_bmin.device if isinstance(prim_bmin, torch.Tensor) \
            else "cuda"
    dev = torch.device(device)

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    prim_bmin = f32(prim_bmin)
    prim_bmax = f32(prim_bmax)
    if prim_centers is None:
        prim_centers = 0.5 * (prim_bmin + prim_bmax)
    prim_centers = f32(prim_centers)
    n = int(prim_bmin.shape[0])
    if n == 0:
        raise ValueError("no primitives")
    if n <= max_leaf:
        bvh = BVH(
            bmin=amin(prim_bmin, 0).cpu().numpy()[None],
            bmax=amax(prim_bmax, 0).cpu().numpy()[None],
            flag=np.ones(1, np.int32),
            axis=np.zeros(1, np.int32),
            data=np.asarray([[n, 0]], np.uint32),
            indices=np.arange(n, dtype=np.uint32),
        )
        return bvh, BVHBuildStatistics(0, 1, 0, time.perf_counter() - t0)

    out = _build_lbvh_arrays(prim_bmin, prim_bmax, prim_centers, n, max_leaf)
    (order, first, last, split, l_leaf, r_leaf, keep, pre_i, pre_l, pre_r,
     node_lo, node_hi, lf_lo, lf_hi, rf_lo, rf_hi, axis_i, l_size, r_size
     ) = [x.cpu().numpy() for x in out]

    ki = np.nonzero(keep)[0]
    n_int = ki.shape[0]
    n_leaf = int((l_leaf & keep).sum() + (r_leaf & keep).sum())
    total = n_int + n_leaf

    bmin_o = np.zeros((total, 3), np.float32)
    bmax_o = np.zeros((total, 3), np.float32)
    flag_o = np.zeros(total, np.int32)
    axis_o = np.zeros(total, np.int32)
    data_o = np.zeros((total, 2), np.uint32)

    pi = pre_i[ki]
    bmin_o[pi] = node_lo[ki]
    bmax_o[pi] = node_hi[ki]
    axis_o[pi] = axis_i[ki]
    # child slots: left at pre_l, right at pre_r regardless of kind
    data_o[pi, 0] = pre_l[ki]
    data_o[pi, 1] = pre_r[ki]
    lm = np.nonzero(keep & l_leaf)[0]  # left leaf children
    pl = pre_l[lm]
    bmin_o[pl] = lf_lo[lm]
    bmax_o[pl] = lf_hi[lm]
    flag_o[pl] = 1
    data_o[pl, 0] = l_size[lm]
    data_o[pl, 1] = first[lm]
    rm = np.nonzero(keep & r_leaf)[0]  # right leaf children
    pr = pre_r[rm]
    bmin_o[pr] = rf_lo[rm]
    bmax_o[pr] = rf_hi[rm]
    flag_o[pr] = 1
    data_o[pr, 0] = r_size[rm]
    data_o[pr, 1] = split[rm] + 1

    bvh = BVH(bmin=bmin_o, bmax=bmax_o, flag=flag_o, axis=axis_o,
              data=data_o, indices=np.asarray(order, np.uint32))
    st = BVHBuildStatistics(
        num_leaf_nodes=n_leaf,
        num_branch_nodes=n_int,
        build_secs=time.perf_counter() - t0,
    )
    st.max_tree_depth = stats_from_bvh(bvh).max_tree_depth
    return bvh, st
