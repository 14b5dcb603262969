"""Device-side top-down binned-SAH partitioning for the LBVH pipeline
(port of ``nanort_tpu.build.sah_top``; jitted XLA there, plain torch
here).

A top tree constrained to contiguous Morton-order ranges traces worse
than plain Karras (``lbvh.hybrid_deltas``): the LBVH quality gap lives in
the primitive ORDER. So this phase REORDERS: true binned SAH (the
reference's criterion, nanort.h:1245-1430, over every node of a level at
once) with real centroid-side partitioning for the top ``levels`` of the
tree, then Karras/Morton topology inside the resulting ranges.

* One level = segment reductions for per-node centroid bounds and binned
  counts/boxes (``bincount`` and ``scatter_reduce``, empty segments
  holding JAX's fills: 0 counts, +inf minima, -inf maxima), a prefix and
  a suffix min over the bins (log-step folds of ``core.math.minimum``,
  XLA's min) for the SAH sweep, and a
  STABLE segmented two-way partition (cumsums and one scatter to a
  permutation): each node's prims stay in Morton order, so in-range
  deltas are plain Morton deltas.
* The finished partition is handed to ``_topology_from_deltas`` as a
  delta array: range-boundary deltas encode the SAH split hierarchy as
  negative levels (more negative = higher split), Morton deltas
  elsewhere.

The output plugs into ``device_collapse.collapse_lbvh_device``
(``sah_levels > 0``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import minimum
from .lbvh import D_FLOOR, _clz32, _morton_deltas


def _scan_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) min along dim 1, in log2 steps of
    ``core.math.minimum``, as ``jax.lax.associative_scan(jnp.minimum)``
    gives it: that scan interleaves its halves by adding zero-padded
    arrays, so each output is the exact min plus 0.0 (-0.0 comes out
    +0.0), and so is each output here."""
    if reverse:
        x = x.flip(1)
    n = x.shape[1]
    s = 1
    while s < n:
        x = torch.cat([x[:, :s], minimum(x[:, s:], x[:, :-s])], dim=1)
        s *= 2
    x = x + 0.0
    return x.flip(1) if reverse else x


def _segment_min(src: torch.Tensor, seg: torch.Tensor, nseg: int,
                 fill: float) -> torch.Tensor:
    """Per-segment min of the rows of ``src`` (n, C); ``fill`` (the
    reduction's identity) where a segment is empty."""
    out = torch.full((nseg, src.shape[1]), fill, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce_(0, seg[:, None].expand_as(src), src, "amin")


def _sa(lo, hi):
    d = torch.clamp(hi - lo, min=0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
        + d[..., 2] * d[..., 0]


def sah_top_partition(centers, prim_lo, prim_hi, n: int, levels: int = 10,
                      bins: int = 16, stop_cap: int = 64):
    """Top-down binned-SAH partition of ``n`` Morton-ordered prims.

    Inputs are in Morton-sorted order. Returns ``(perm, codes)``:
    ``perm`` (n,) gathers morton-order indices into the final order;
    ``codes`` (n,) left-aligned ``levels``-bit range codes in final order
    (prims sharing a code form one contiguous range whose internal
    structure is left to the Morton topology); both int64.

    Per level, every active node is split by the reference's binned-SAH
    criterion (minimum nL*SA(L) + nR*SA(R) over ``bins`` centroid bins
    on each axis, nanort.h:1245-1430); nodes with <= ``stop_cap`` prims
    or no valid split (all centroids in one bin every axis) stop and
    pass through with side 0, which left-aligns their code for free.
    """
    NB = bins
    dev = centers.device
    f32 = torch.float32
    inf = float("inf")
    idx0 = torch.arange(n, device=dev)
    c = centers.to(f32)
    lo = prim_lo.to(f32)
    hi = prim_hi.to(f32)
    src = idx0
    code = torch.zeros(n, dtype=torch.long, device=dev)

    for lvl in range(levels):
        nseg = 1 << lvl
        cnt = torch.bincount(code, minlength=nseg)
        cmin = _segment_min(c, code, nseg, inf)
        cmax = -_segment_min(-c, code, nseg, inf)
        ext = torch.clamp((cmax - cmin)[code], min=1e-30)
        rel = ((c - cmin[code]) / ext * NB).clamp(0.0, NB - 1.0)
        rel = torch.nan_to_num(rel, nan=0.0).long()  # (n, 3) per-axis bin

        # per (node, axis, bin) counts + bboxes: one segment pass per
        # axis over keys code*NB + bin (min-form rows [lo | -hi])
        mrow = torch.cat([lo, -hi], dim=1)
        best_cost = torch.full((nseg,), inf, dtype=f32, device=dev)
        best_axis = torch.zeros(nseg, dtype=torch.long, device=dev)
        best_cut = torch.zeros(nseg, dtype=torch.long, device=dev)
        for ax in range(3):
            key = code * NB + rel[:, ax]
            bc = torch.bincount(key, minlength=nseg * NB).reshape(nseg, NB)
            bb = _segment_min(mrow, key, nseg * NB, inf).reshape(
                nseg, NB, 6)
            lbox = _scan_min(bb)
            rbox = _scan_min(bb, reverse=True)
            ncl = torch.cumsum(bc, dim=1)
            # split after bin b (b = 0..NB-2): left bins [0, b]
            nl = ncl[:, :-1].to(f32)
            nr = (cnt[:, None] - ncl[:, :-1]).to(f32)
            sal = _sa(lbox[:, :-1, 0:3], -lbox[:, :-1, 3:6])
            sar = _sa(rbox[:, 1:, 0:3], -rbox[:, 1:, 3:6])
            cost = torch.where((nl > 0) & (nr > 0), nl * sal + nr * sar,
                               inf)
            ccut = torch.argmin(cost, dim=1)  # first minimum, as jnp's
            ccost = cost.gather(1, ccut[:, None])[:, 0]
            upd = ccost < best_cost
            best_cost = torch.where(upd, ccost, best_cost)
            best_axis = torch.where(upd, ax, best_axis)
            best_cut = torch.where(upd, ccut, best_cut)

        # node start offsets + in-node rank (prims are contiguous/stable)
        starts = torch.cumsum(cnt, 0) - cnt
        st = starts[code]
        rank = idx0 - st

        done = cnt <= stop_cap
        no_split = torch.isinf(best_cost)
        side_sah = rel.gather(1, best_axis[code][:, None])[:, 0] \
            > best_cut[code]
        # degenerate node (equal centroids every axis): median split
        side_med = rank >= cnt[code] // 2
        side = torch.where(done[code], False,
                           torch.where(no_split[code], side_med, side_sah))

        # stable segmented partition: dest = start + rankL (side 0) or
        # start + cntL + rankR (side 1); ranks from global cumsums of the
        # side indicators minus their value at the node start
        s1 = side.long()
        s0 = 1 - s1
        g0 = torch.cumsum(s0, 0)
        g1 = torch.cumsum(s1, 0)
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        rank_l = g0 - torch.cat([zero, g0])[st] - s0
        rank_r = g1 - torch.cat([zero, g1])[st] - s1
        cnt_l = torch.bincount(code[~side], minlength=nseg)
        dest = st + torch.where(side, cnt_l[code] + rank_r, rank_l)
        new_code = code * 2 + s1

        def scat(x):
            out = torch.empty_like(x)
            out[dest] = x  # dest is a permutation
            return out

        c, lo, hi, src, code = (scat(x) for x in (c, lo, hi, src, new_code))

    return src, code


def sah_hybrid_deltas(morton_final, codes_final, n: int, levels: int):
    """Delta array whose Cartesian tree is the SAH top hierarchy over
    range codes + Morton topology inside ranges. ``morton_final`` /
    ``codes_final`` are the 30-bit Morton codes and ``levels``-bit range
    codes in FINAL order."""
    base = D_FLOOR + 3
    dm = _morton_deltas(morton_final, n)
    ca, cb = codes_final[:-1], codes_final[1:]
    # boundary split level = levels - bit_length(xor)
    lca_lv = levels - (32 - _clz32(ca ^ cb))
    return torch.where(ca != cb, base + lca_lv, dm)


def sah_cost_estimate(node_lo, node_hi, leaf_mask, leaf_cnt):
    """Diagnostic true-SAH cost (internal SA + leaf SA * count, over
    root SA) for quality comparisons; host-side numpy."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    lo = host(node_lo)
    hi = host(node_hi)
    d = np.maximum(hi - lo, 0.0)
    sa = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    leaf = host(leaf_mask).astype(bool)
    root = max(float(sa[0]), 1e-30)
    return float(
        (sa[~leaf].sum() + (sa[leaf] * host(leaf_cnt)[leaf]).sum())
        / root
    )
