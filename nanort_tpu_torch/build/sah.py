"""Host-side binned-SAH BVH builder (NumPy, vectorized per node).

Re-derivation of the reference's recursive builder (``BVHAccel::BuildTree``,
nanort.h:1759-1890) with its binned SAH machinery (nanort.h:1245-1430):

* 64 centroid-quantized bins per axis (``BVHBuildOptions.bin_size``),
* two-sweep cost accumulation per axis (right-to-left suffix cost, then
  left-to-right scan picking the min-cost boundary),
* partition by centroid-vs-cut predicate with the reference's 3-axis retry
  and object-median fallback when a cut degenerates (nanort.h:1827-1857),
* leaves when ``n <= min_leaf_primitives`` or ``depth >= max_tree_depth``.

Deliberate departures from the reference:

* The reference's ``ContributeBinBuffer`` has a bounds-check bug that only
  ever fills the x-axis bins (``bin_idx < bin_size`` with
  ``bin_idx = axis*bin_size + idx``, nanort.h:1352-1360), effectively
  degrading SAH axis selection. We bin all 3 axes properly — parity is on
  hit records, not tree topology, and the resulting tree traces faster.
* Recursion is replaced by an explicit stack (same DFS preorder node
  emission, so ``left == parent + 1`` holds, matching the reference
  layout byte-for-byte through ``dump``).
* An additional ``max_leaf_primitives`` cap guarantees statically-bounded
  leaf sizes for the TPU traversal kernels (oversized ranges median-split).

The builder is geometry-agnostic: it consumes per-primitive AABBs and
centers, the protocol the reference expresses as the Geometry/Pred template
duo (nanort.h:862-991).
"""

from __future__ import annotations

import time

import numpy as np

from ..core.bvh import BVH
from ..core.options import BVHBuildOptions, BVHBuildStatistics


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = bmax - bmin
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _find_sah_cut(cb: np.ndarray, pbmin: np.ndarray, pbmax: np.ndarray,
                  node_bmin: np.ndarray, node_bmax: np.ndarray, bin_size: int):
    """Binned SAH over all 3 axes at once.

    cb: (n,3) centroids; pbmin/pbmax: (n,3) prim bounds.
    Returns (cut_pos[3], best_axis). Reference: ContributeBinBuffer +
    FindCutFromBinBuffer (nanort.h:1314-1430), minimizing
    count_left*SA(left) + count_right*SA(right) over bin boundaries.
    """
    n = cb.shape[0]
    ext = node_bmax - node_bmin
    inv = np.where(ext > 0.0, bin_size / np.where(ext > 0.0, ext, 1.0), 0.0)
    q = ((cb - node_bmin) * inv).astype(np.int64)
    np.clip(q, 0, bin_size - 1, out=q)

    cut_pos = np.empty(3, cb.dtype)
    min_cost = np.full(3, np.inf)
    min_bin = np.ones(3, np.int64)
    big = np.finfo(cb.dtype).max
    for ax in range(3):
        counts = np.bincount(q[:, ax], minlength=bin_size)
        bb_lo = np.full((bin_size, 3), big, cb.dtype)
        bb_hi = np.full((bin_size, 3), -big, cb.dtype)
        np.minimum.at(bb_lo, q[:, ax], pbmin)
        np.maximum.at(bb_hi, q[:, ax], pbmax)

        # prefix (left-to-right) and suffix (right-to-left) accumulations
        pre_lo = np.minimum.accumulate(bb_lo, axis=0)
        pre_hi = np.maximum.accumulate(bb_hi, axis=0)
        suf_lo = np.minimum.accumulate(bb_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(bb_hi[::-1], axis=0)[::-1]
        pre_cnt = np.cumsum(counts)
        suf_cnt = n - pre_cnt

        # boundary b in [1, bin_size): left bins [0,b), right [b, bin_size)
        cl = pre_cnt[:-1]
        cr = suf_cnt[:-1]
        # empty-side bboxes are sentinel garbage; zero their area before
        # multiplying so 0 * inf never produces NaN
        with np.errstate(over="ignore", invalid="ignore"):
            sa_l = np.where(cl > 0, _surface_area(pre_lo[:-1], pre_hi[:-1]), 0.0)
            sa_r = np.where(cr > 0, _surface_area(suf_lo[1:], suf_hi[1:]), 0.0)
        cost = cl * sa_l + cr * sa_r
        # ignore degenerate cuts (all prims one side)
        cost = np.where((cl == 0) | (cr == 0), np.inf, cost)
        b = int(np.argmin(cost))
        min_cost[ax] = cost[b]
        min_bin[ax] = b + 1
        cut_pos[ax] = node_bmin[ax] + min_bin[ax] * (ext[ax] / bin_size)

    best_axis = int(np.argmin(min_cost))
    if not np.isfinite(min_cost[best_axis]):
        # every axis degenerate (e.g. all centroids identical): the caller's
        # median fallback handles it
        best_axis = int(np.argmax(ext))
    return cut_pos, best_axis


def build_sah(
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
    prim_centers: np.ndarray | None = None,
    options: BVHBuildOptions = BVHBuildOptions(),
) -> tuple[BVH, BVHBuildStatistics]:
    """Build a linear BVH from per-primitive AABBs.

    Returns (bvh, stats). Node layout and DFS preorder match the reference
    builder so serialized output loads into nanort unchanged.
    """
    t0 = time.perf_counter()
    prim_bmin = np.ascontiguousarray(prim_bmin)
    prim_bmax = np.ascontiguousarray(prim_bmax)
    dtype = prim_bmin.dtype
    n_prims = prim_bmin.shape[0]
    if n_prims == 0:
        raise ValueError("no primitives (reference Build returns false, nanort.h:1907)")
    if prim_centers is None:
        prim_centers = 0.5 * (prim_bmin + prim_bmax)

    indices = np.arange(n_prims, dtype=np.uint32)

    # preallocate generous node storage: <= 2*ceil(n/1) - 1 nodes
    cap = max(2 * n_prims, 16)
    nb_lo = np.empty((cap, 3), dtype)
    nb_hi = np.empty((cap, 3), dtype)
    nflag = np.empty(cap, np.int32)
    naxis = np.zeros(cap, np.int32)
    ndata = np.zeros((cap, 2), np.uint32)
    n_nodes = 0

    stats = BVHBuildStatistics()

    # task: (left, right, depth, parent_slot, child_pos); preorder via LIFO
    stack = [(0, n_prims, 0, -1, 0)]
    while stack:
        left, right, depth, parent, child_pos = stack.pop()
        slot = n_nodes
        n_nodes += 1
        if parent >= 0:
            ndata[parent, child_pos] = slot
        if depth > stats.max_tree_depth:
            stats.max_tree_depth = depth

        ids = indices[left:right]
        bmin = prim_bmin[ids].min(axis=0)
        bmax = prim_bmax[ids].max(axis=0)
        nb_lo[slot] = bmin
        nb_hi[slot] = bmax

        n = right - left
        make_leaf = n <= options.min_leaf_primitives or (
            depth >= options.max_tree_depth and n <= options.max_leaf_primitives
        )
        if make_leaf:
            nflag[slot] = 1
            ndata[slot, 0] = n
            ndata[slot, 1] = left
            stats.num_leaf_nodes += 1
            continue

        cb = prim_centers[ids]
        cut_pos, min_cut_axis = _find_sah_cut(
            cb, prim_bmin[ids], prim_bmax[ids], bmin, bmax, options.bin_size
        )

        # 3-axis retry with median fallback (nanort.h:1827-1857)
        mid = left
        cut_axis = min_cut_axis
        for axis_try in range(3):
            cut_axis = (min_cut_axis + axis_try) % 3
            mask = cb[:, cut_axis] < cut_pos[cut_axis]
            k = int(mask.sum())
            if 0 < k < n:
                indices[left:right] = np.concatenate([ids[mask], ids[~mask]])
                mid = left + k
                break
            mid = left + (n >> 1)
        else:
            # median split on the last-tried axis: order by centroid
            order = np.argsort(cb[:, cut_axis], kind="stable")
            indices[left:right] = ids[order]
            mid = left + (n >> 1)

        nflag[slot] = 0
        naxis[slot] = cut_axis
        stats.num_branch_nodes += 1
        # push right first so left pops first (DFS preorder, left == slot+1)
        stack.append((mid, right, depth + 1, slot, 1))
        stack.append((left, mid, depth + 1, slot, 0))

    bvh = BVH(
        bmin=nb_lo[:n_nodes].copy(),
        bmax=nb_hi[:n_nodes].copy(),
        flag=nflag[:n_nodes].copy(),
        axis=naxis[:n_nodes].copy(),
        data=ndata[:n_nodes].copy(),
        indices=indices,
    )
    stats.build_secs = time.perf_counter() - t0
    return bvh, stats
