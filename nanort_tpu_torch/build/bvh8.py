"""BVH8/BVH16: wide collapse of the binary BVH for the packet traversal.

Host NumPy, a copy of ``nanort_tpu.build.bvh8`` without its JAX pytree
registration: both packages emit bit-identical tables, and the CUDA
kernel (``traverse/packet.py``) reads the same rows the TPU kernel reads.
``BVH8Scene.to(device)`` moves the tables into torch tensors.

One BVH8 node occupies exactly one 128-float row (a TPU VMEM fetch unit
in the reference; on the GPU a 512-byte row is 4 L2 sectors), so a
traversal step pays a single row read per node:

  lanes [8c, 8c+6):   child c AABB (bmin.xyz, bmax.xyz), c in 0..7
  lane  64 + c:       child c meta, stored as an exact float integer
                      (scalar extraction of a float lane is a cheap SMEM
                      load; a bitcast int lane would force a vector
                      register -> scalar sync per extract):
                        >= 0  -> internal: BVH8 row index of the child
                        <  0  -> leaf: -(leaf_row + 1) into the leaf table
  lane  72 + c:       child c leaf triangle count (0 for internal/empty)
  lane  80:           traversal-order axis (0/1/2): children are stored
                      sorted near-to-far along this axis so the kernel can
                      pick a near-first pop order from the packet's ray
                      direction sign (the reference's per-node axis order,
                      nanort.h:2507-2515, packet-granular here)
  float-int encoding is exact to 2^24: scenes are capped at 16.7M
  primitives per BVH8 (the binary BVH keeps the reference's 2G cap)
  empty slots carry an inverted box (never hit) and count 0.

Leaf table rows pack up to 10 triangles (one binary-BVH leaf each):

  lanes [9t, 9t+9):   triangle t vertices (p0, p1, p2 xyz)
  lane  90 + t:       triangle t original prim id (exact float integer)

The optional Woop table (``woop=True``, the turbo intersector's input)
has one row for each leaf row, holding the same triangles in the same
slots as per-triangle unit-triangle transforms
(``_woop_transforms_from``):

  lanes [12t, 12t+9):    triangle t transform M, row-major
  lanes [12t+9, 12t+12): triangle t anchor vertex p0
  lane  108 + t:         triangle t original prim id (exact float integer)

A sphere scene (``spheres=``, the particle primitive of
``ops/sphere.py``; ``leaf_kind == "sphere"``) has sphere leaf rows in
place of the triangle ones, the same slots of the same binary leaves:

  lanes [4s, 4s+4):      sphere s centre xyz and radius (one 16-byte load)
  lane  108 + s:         sphere s original prim id (exact float integer)

A curve scene (``curves=``, the cubic Bezier curves of ``ops/curve.py``;
``leaf_kind == "curve"``) has curve leaf rows, at most 6 curves a row:

  lanes [16c, 16c+16):   curve c control points p0, p1, p2, p3, each xyz
                         and a w lane: r0 (p0), 0 (p1, p2), r1 (p3), so
                         four 16-byte loads a curve
  lane  108 + c:         curve c original prim id (exact float integer)

The collapse walks the binary tree (build.sah output, reference layout
nanort.h:1759-1890) and repeatedly expands the largest-surface-area member
of the cut until 8 slots fill — the standard greedy BVH2->BVH8 conversion.
Requires the binary build to use ``max_leaf_primitives <= 10``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bvh import BVH
from ..utils import trace

MAX_LEAF_TRIS = 10
MAX_LEAF_CURVES = 6  # 16 lanes a curve below the prim-id block at lane 108
EMPTY_BIG = 3.0e38


@dataclasses.dataclass
class BVH8Scene:
    """Wide-BVH tables plus their sizes. ``nodes``/``leafs`` are NumPy
    arrays as built; ``to(device)`` returns a copy holding torch tensors.

    ``width`` is the node fan-out: 8 (one f32 row per node, 86/128
    lanes live) or 16 (one dense f32 row per node, ``collapse_bvh16``)
    — the traversal fetches one 128-float row per node pop."""

    nodes: np.ndarray  # (N+1 rows [*2 if unpacked16], 128) f32 (+ dummy)
    leafs: np.ndarray  # (M, 128) f32
    num_nodes: int
    num_leaf_rows: int
    depth: int  # BVH8 tree depth (stack sizing)
    max_leaf: int  # max triangles in any leaf row (kernel unroll bound)
    width: int = 8
    # optional Woop unit-triangle leaf table (collapse_bvh8(woop=True)),
    # row for row beside ``leafs``: the input of the turbo intersector
    # (traverse_bvh8(..., intersector="woop"))
    leafs_woop: np.ndarray | None = None
    # what the leaf rows hold: "triangle", "sphere" or "curve"
    # (collapse_bvh8's ``spheres=``, ``curves=``); traverse_bvh8 launches
    # the leaf test of the kind
    leaf_kind: str = "triangle"

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @trace.span("build.upload")
    def to(self, device) -> "BVH8Scene":
        """Copy of the scene whose tables are contiguous float32 torch
        tensors on ``device``.

        Raises ValueError when ``depth`` is not the node levels of the
        tables: the traversal sizes its per-ray stack from ``depth``, so
        the bound holds for every scene that went through here."""
        import torch

        nodes = self.nodes
        if isinstance(nodes, torch.Tensor):
            nodes = nodes.detach().cpu().numpy()
        levels = table_depth(nodes, self.width)
        if levels != self.depth:
            raise ValueError(f"scene.depth is {self.depth}, the tables "
                             f"hold {levels} node levels")

        def move(x):
            return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()

        return dataclasses.replace(
            self, nodes=move(self.nodes), leafs=move(self.leafs),
            leafs_woop=None if self.leafs_woop is None
            else move(self.leafs_woop))


def table_depth(nodes: np.ndarray, width: int, roots=(0,)) -> int:
    """Node levels of a BVH8/BVH16 table set, walked from root row 0
    (``collapse_bvh8``'s ``depth``), or the most levels below any of
    ``roots`` (the rows are walked together, level by level). A child
    slot is internal when its box is not the inverted empty box and its
    meta lane is >= 0."""
    if width == 16:
        box_lanes = 6 * np.arange(16)
        meta_lanes = 96 + np.arange(16)
    else:
        box_lanes = 8 * np.arange(8)
        meta_lanes = 64 + np.arange(8)
    frontier = np.asarray(roots, np.int64).reshape(-1)
    for depth in range(1, nodes.shape[0] + 1):
        rows = nodes[frontier]
        meta = rows[:, meta_lanes]
        internal = (rows[:, box_lanes] < EMPTY_BIG) & (meta >= 0)
        frontier = meta[internal].astype(np.int64)
        if frontier.size == 0:
            return depth
    raise ValueError("node tables hold a cycle")


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _fill_leaf_segments(rows, seg_row, seg_slot, seg_len, seg_src, vals,
                        stride, lane0, pid_lane, pid_vals):
    """Scatter destination segments (row, slot0, len, src-tri-offset)
    into packed leaf rows. Grouped by segment length (<= 10 groups);
    flat gathers/scatters only — no index-product materialization over
    the whole stream (that alone cost ~8 s at 2M tris on one host core).
    ``seg_src`` indexes the leaf-ordered triangle stream directly (the
    reference's index-array offsets, nanort.h data[1]), so no stream
    contiguity is assumed."""
    flat = vals.reshape(-1)
    rflat = rows.reshape(-1)
    for c in np.unique(seg_len) if seg_len.size else []:
        c = int(c)
        if c == 0:
            continue
        sel = np.nonzero(seg_len == c)[0]
        src0 = seg_src[sel]
        base = seg_row[sel] * 128 + lane0 + stride * seg_slot[sel]
        span = np.arange(stride * c, dtype=np.int64)
        src = flat[(src0[:, None] * stride + span).reshape(-1)]
        rflat[(base[:, None] + span).reshape(-1)] = src
        spanc = np.arange(c, dtype=np.int64)
        pbase = seg_row[sel] * 128 + pid_lane + seg_slot[sel]
        rflat[(pbase[:, None] + spanc).reshape(-1)] = pid_vals[
            (src0[:, None] + spanc).reshape(-1)
        ]


def _woop_transforms_from(vertices, faces, indices) -> np.ndarray:
    """Per-triangle Woop unit-triangle transforms for the leaf-ordered
    stream ``indices``: (L, 12) f32 rows of [M row-major | anchor p0].

    Each triangle is baked as the affine transform into its own "unit
    triangle" space (Woop et al. 2004): columns of E = [e1, e2, n] with
    e1 = p1-p0, e2 = p2-p0, n = e1 x e2, stored as M = E^-1 plus the
    anchor vertex p0, so the traversal's o' = M (o - p0) and d' = M d
    give t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y with the plain
    unit-triangle test u >= 0, v >= 0, u+v <= 1. Storing p0
    (translate-then-rotate) rather than the fused offset b = -M p0 keeps
    the origin-relative coordinates well-conditioned far from the world
    origin. Degenerate (zero-area) triangles get a zero matrix: d'z = 0
    for every ray, so they never report a hit.

    This intersector trades the watertight guarantees (nanort.h:993-1229)
    for fewer leaf operations: edge-crossing rays may pick the
    neighbouring triangle (equal t) or, rarely, slip through a shared
    edge.

    Chunked with manual cross products: whole-array np.cross/np.stack
    allocate ~350 MB of f64 temporaries and first-touch page faults on
    one host core cost ~25 s / 2M tris."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces)
    L = indices.shape[0]
    flat = np.empty((L, 12), np.float32)
    CHUNK = 1 << 18
    for a in range(0, L, CHUNK):
        b = min(a + CHUNK, L)
        tri = vertices[faces[indices[a:b]]]  # (c, 3, 3) f64
        p0 = tri[:, 0]
        e1 = tri[:, 1] - p0
        e2 = tri[:, 2] - p0

        def cross(x, y):
            return (
                x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1],
                x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2],
                x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0],
            )

        nx, ny, nz = cross(e1, e2)
        det = nx * nx + ny * ny + nz * nz
        ok = det > 0.0
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        n3 = np.stack([nx, ny, nz], axis=1)
        r0 = cross(e2, n3)
        r1 = cross(n3, e1)
        for k in range(3):
            flat[a:b, k] = r0[k] * inv
            flat[a:b, 3 + k] = r1[k] * inv
            flat[a:b, 6 + k] = n3[:, k] * inv
            flat[a:b, 9 + k] = p0[:, k]
    return flat


@trace.span("build.collapse")
def collapse_bvh8(
    bvh: BVH,
    vertices=None,
    faces=None,
    width: int = 8,
    woop: bool = False,
    spheres=None,
    curves=None,
) -> BVH8Scene:
    """Collapse the binary BVH into width-wide packet-kernel tables.

    Adjacent small sibling leaves inside each
    node's cut are bin-packed into shared leaf rows (respecting the
    near-first child order). Binary SAH splitting leaves rows ~70% full
    on average (a range of 10 splits 5+5, not 9+1), so merging cuts both
    leaf-row count (~drain steps) and node count (~VMEM footprint: the
    10M-tri scene's nodes shrink from 260 MB — forced all-HBM mode — to
    under the VMEM budget) at the cost of nothing but equal-t tie order,
    which is unordered across engines anyway (the equal-t tie contract).

    ``woop=True`` also bakes the Woop unit-triangle table with the SAME
    row layout (12 lanes a triangle and the prim ids at lane 108, so
    rows hold at most 9 triangles).

    ``spheres`` (an ``ops.sphere.Spheres`` or ``(centers, radii)``, with
    no ``vertices`` or ``faces``) collapses ``build_sphere_bvh``'s tree
    into sphere leaf rows (``leaf_kind="sphere"``); ``curves`` (an
    ``ops.curve.Curves`` or ``(points (N, 4, 3), radii (N, 4))``)
    collapses ``build_curve_bvh``'s tree, whose leaves hold at most 6
    curves, into curve leaf rows (``leaf_kind="curve"``).
    """
    if width not in (8, 16):
        raise ValueError(f"width must be 8 or 16: {width}")
    kinds = (vertices is not None and faces is not None, spheres is not None,
             curves is not None)
    if sum(kinds) != 1 or (not kinds[0] and (vertices is not None
                                             or faces is not None)):
        raise ValueError("collapse_bvh8 takes vertices and faces, or "
                         "spheres, or curves")
    if woop and not kinds[0]:
        raise ValueError("woop rows hold triangles, not spheres or curves")
    # 16-wide nodes use the DENSE single-row layout: 16 children in ONE
    # fully-occupied (1, 128) f32 row — child w's exact slab bounds
    # (lo.xyz, hi.xyz) at lanes [6w, 6w+6), metas at 96+w, leaf counts
    # at 112+w, and the near-first order axis folded into the child-0
    # count lane as cnt + 16*axis (every count consumer masks & 15).
    # One node pop = one dynamic row fetch = 16 slab tests per
    # vector->scalar sync at HALF the VMEM bytes per child of the 8-wide
    # layout (which occupies only 86 of 128 lanes).
    packed16 = width == 16
    W = width
    NR = 1 if packed16 else W // 8  # rows per node
    if kinds[0]:
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces)
    bmin = np.asarray(bvh.bmin, np.float32)
    bmax = np.asarray(bvh.bmax, np.float32)
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data).astype(np.int64)
    indices = np.asarray(bvh.indices).astype(np.int64)

    if indices.shape[0] > (1 << 24):
        raise ValueError("BVH8 float-int lanes are exact to 2^24 prims")
    leaf_ids = np.nonzero(flag == 1)[0]
    counts = data[leaf_ids, 0]
    if counts.max(initial=0) > MAX_LEAF_TRIS:
        raise ValueError(
            f"binary leaves must hold <= {MAX_LEAF_TRIS} tris for BVH8 "
            f"packing (got {counts.max()}); build with "
            f"max_leaf_primitives<={MAX_LEAF_TRIS}"
        )
    cap = int(counts.max(initial=1))
    if curves is not None and cap > MAX_LEAF_CURVES:
        raise ValueError(f"curve rows hold <= {MAX_LEAF_CURVES} curves; "
                         f"build with max_leaf_primitives <= "
                         f"{MAX_LEAF_CURVES}")
    if woop and cap > 9:
        raise ValueError("woop rows hold <= 9 tris; build with "
                         "max_leaf_primitives <= 9")

    # ---- node collapse (vectorized, level-synchronous BFS) ----
    # The serial preorder emitter cost ~300 s of host Python at 10M tris;
    # this version expands the greedy 8-wide cuts of a whole BFS level at
    # once with (N, 8) numpy ops. Row order is BFS (root stays row 0);
    # nothing downstream relies on preorder — children are addressed by
    # explicit meta lanes.
    def cut8_batch(roots):
        """Greedy cuts of up to W binary descendants for every root at
        once: repeatedly split the largest-surface-area internal cut
        member (same pick order as the reference-style serial cut; ties
        resolve to the lowest slot, matching first-strict-max)."""
        n = roots.shape[0]
        ids = np.full((n, W), 0, np.int64)
        ids[:, 0] = data[roots, 0]
        ids[:, 1] = data[roots, 1]
        cnt = np.full(n, 2, np.int64)
        rng_n = np.arange(n)
        slot = np.arange(W)[None, :]
        for _ in range(W - 2):  # 2 -> W members, +1 per expansion
            valid = slot < cnt[:, None]
            isint = valid & (flag[ids] == 0)
            d = np.maximum(bmax[ids] - bmin[ids], 0.0)
            sa = 2.0 * (
                d[..., 0] * d[..., 1]
                + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0]
            )
            sa = np.where(isint, sa, -1.0)
            j = np.argmax(sa, axis=1)
            can = (sa[rng_n, j] >= 0.0) & (cnt < W)
            c = ids[rng_n, j]
            ids[can, j[can]] = data[c[can], 0]
            ids[can, cnt[can]] = data[c[can], 1]
            cnt[can] += 1
        return ids, cnt

    def empty_rows(shape):
        r = np.zeros(shape, np.float32)
        if packed16:
            for ax in range(3):  # inverted box: lo > hi, never hits
                r[..., ax:96:6] = EMPTY_BIG
                r[..., 3 + ax:96:6] = -EMPTY_BIG
        else:
            r[..., 0:64:8] = EMPTY_BIG
            r[..., 1:64:8] = EMPTY_BIG
            r[..., 2:64:8] = EMPTY_BIG
            r[..., 3:64:8] = -EMPTY_BIG
            r[..., 4:64:8] = -EMPTY_BIG
            r[..., 5:64:8] = -EMPTY_BIG
        return r

    if flag[0] == 1:
        # degenerate single-leaf tree: one node with one leaf child
        nodes3 = empty_rows((2, NR, 128))
        if packed16:
            nodes3[0, 0, 0:3] = bmin[0]
            nodes3[0, 0, 3:6] = bmax[0]
            nodes3[0, 0, 96] = np.float32(-1.0)  # leaf row 0
            nodes3[0, 0, 112] = np.float32(data[0, 0])  # axis 0
        else:
            nodes3[0, 0, 0:3] = bmin[0]
            nodes3[0, 0, 3:6] = bmax[0]
            nodes3[0, 0, 64] = np.float32(-1.0)  # leaf row 0
            nodes3[0, 0, 72] = np.float32(data[0, 0])
        nodes = nodes3.reshape(-1, 128)
        seg_rows_l = [np.zeros(1, np.int64)]
        seg_slot_l = [np.zeros(1, np.int64)]
        seg_len_l = [np.asarray([data[0, 0]], np.int64)]
        seg_src_l = [np.asarray([data[0, 1]], np.int64)]
        seg_leaf_l = [np.zeros(1, np.int64)]
        m_rows = 1
        total = 1
        max_depth = 0
        max_leaf_out = int(data[0, 0])
    else:
        level_rows: list[np.ndarray] = []
        level_meta: list[np.ndarray] = []  # (n, W) int64 node-id metas
        level_isint: list[np.ndarray] = []
        # per-binary-leaf destination segments (a leaf's triangles may
        # split across two packed rows): row, slot0, len, src offset
        seg_rows_l, seg_slot_l, seg_len_l, seg_src_l, seg_leaf_l = (
            [], [], [], [], []
        )
        frontier = np.zeros(1, np.int64)  # binary roots of this level
        node_base = 0
        leaf_row_base = 0
        max_depth = 0
        max_leaf_out = 1
        rngW = np.arange(W)[None, :]
        while frontier.size:
            n = frontier.shape[0]
            ids, cnt = cut8_batch(frontier)
            valid = rngW < cnt[:, None]
            child_leaf = valid & (flag[ids] == 1)
            child_int = valid & ~child_leaf

            # near-first child order along the widest-centroid axis
            cent = 0.5 * (bmin[ids] + bmax[ids])  # (n, W, 3)
            c_lo = np.where(valid[..., None], cent, np.inf).min(axis=1)
            c_hi = np.where(valid[..., None], cent, -np.inf).max(axis=1)
            axis = np.argmax(c_hi - c_lo, axis=1)  # (n,)
            key = np.where(
                valid, cent[np.arange(n)[:, None], rngW, axis[:, None]],
                np.inf,
            )
            order = np.argsort(key, axis=1, kind="stable")
            take = np.arange(n)[:, None]
            ids = ids[take, order]
            valid = valid[take, order]
            child_leaf = child_leaf[take, order]
            child_int = child_int[take, order]

            # ---- leaf repacking: pool ADJACENT (near-first order) leaf
            # children into rows filled to ``cap`` triangles, splitting
            # a leaf's triangles across two rows when needed. Binary SAH
            # leaves average ~0.7*cap, so row-per-leaf wastes ~30% of
            # every drain step; triangle-level packing recovers it. ----
            lcnt = np.where(child_leaf, data[ids.clip(0), 0], 0)
            grp_start = np.zeros((n, W), bool)
            part_prev = np.zeros((n, W), np.int64)  # tris joining the
            part_rem = np.zeros((n, W), np.int64)   # open row / new row
            prev_run = np.zeros((n, W), np.int64)   # slot0 of the join
            run = np.zeros(n, np.int64)
            for w in range(W):
                isl = child_leaf[:, w]
                c = lcnt[:, w]
                space = cap - run
                join = isl & (run > 0) & (space > 0)
                pp = np.where(join, np.minimum(c, space), 0)
                rem = np.where(isl, c - pp, 0)
                part_prev[:, w] = pp
                prev_run[:, w] = run
                part_rem[:, w] = rem
                grp_start[:, w] = isl & (rem > 0)
                run = np.where(
                    isl, np.where(rem > 0, rem, run + pp), 0
                )
            # global row ids for this level's groups (row-major order)
            gflat = grp_start.reshape(-1)
            gid = np.cumsum(gflat).reshape(n, W) - 1 + leaf_row_base
            n_groups = int(gflat.sum())
            # resolve each member's open-row id (the last start <= w)
            segA_row = np.zeros((n, W), np.int64)
            segB_row = np.zeros((n, W), np.int64)
            cur_gid = np.zeros(n, np.int64)
            for w in range(W):
                segA_row[:, w] = cur_gid
                cur_gid = np.where(grp_start[:, w], gid[:, w], cur_gid)
                segB_row[:, w] = cur_gid
            # row totals + conservative row boxes from contributing
            # member leaf boxes, via reduceat over the (slot, A/B)
            # segment stream whose gid is non-decreasing
            mA = part_prev > 0
            mB = part_rem > 0
            seg_gid = np.concatenate(
                [segA_row[mA] - leaf_row_base, segB_row[mB] - leaf_row_base]
            )
            seg_cnt = np.concatenate([part_prev[mA], part_rem[mB]])
            seg_leaf = np.concatenate([ids[mA], ids[mB]])
            if n_groups:
                gtot_flat = np.bincount(
                    seg_gid, weights=seg_cnt, minlength=n_groups
                ).astype(np.int64)
                glo = np.full((n_groups, 3), np.inf, np.float32)
                ghi = np.full((n_groups, 3), -np.inf, np.float32)
                for ax in range(3):
                    np.minimum.at(glo[:, ax], seg_gid, bmin[seg_leaf, ax])
                    np.maximum.at(ghi[:, ax], seg_gid, bmax[seg_leaf, ax])
            else:
                gtot_flat = np.zeros(0, np.int64)
                glo = np.zeros((0, 3), np.float32)
                ghi = np.zeros((0, 3), np.float32)
            # record per-binary-leaf destination segments (<= 2 each)
            if mA.any():
                lids = ids[mA]
                seg_rows_l.append(segA_row[mA])
                seg_slot_l.append(prev_run[mA])
                seg_len_l.append(part_prev[mA])
                seg_src_l.append(data[lids, 1])
                seg_leaf_l.append(lids)
            if mB.any():
                lids = ids[mB]
                seg_rows_l.append(segB_row[mB])
                seg_slot_l.append(np.zeros(int(mB.sum()), np.int64))
                seg_len_l.append(part_rem[mB])
                seg_src_l.append(data[lids, 1] + part_prev[mB])
                seg_leaf_l.append(lids)
            leaf_row_base += n_groups
            if n_groups:
                max_leaf_out = max(max_leaf_out, int(gtot_flat.max()))
            gtot = np.zeros((n, W), np.int64)
            gmin = np.zeros((n, W, 3), np.float32)
            gmax = np.zeros((n, W, 3), np.float32)
            gs = grp_start
            gtot[gs] = gtot_flat[gid[gs] - leaf_row_base + n_groups]
            gmin[gs] = glo[gid[gs] - leaf_row_base + n_groups]
            gmax[gs] = ghi[gid[gs] - leaf_row_base + n_groups]
            grow = gid
            take = np.arange(n)[:, None]

            # ---- compact to the post-merge child set ----
            keep = (child_int | grp_start) & valid
            order2 = np.argsort(~keep, axis=1, kind="stable")
            ids = ids[take, order2]
            child_int = (child_int & keep)[take, order2]
            is_gleaf = grp_start[take, order2] & keep[take, order2]
            validk = keep[take, order2]
            blo = np.where(
                is_gleaf[..., None], gmin[take, order2],
                bmin[ids.clip(0)],
            )
            bhi = np.where(
                is_gleaf[..., None], gmax[take, order2],
                bmax[ids.clip(0)],
            )
            gcnt2 = gtot[take, order2]
            grow2 = grow[take, order2]

            rows = empty_rows((n, NR, 128))
            for w in range(W):
                if packed16:
                    r, b0 = 0, 6 * w
                else:
                    r, c = divmod(w, 8)
                    b0 = 8 * c
                v = validk[:, w]
                rows[v, r, b0 : b0 + 3] = blo[v, w]
                rows[v, r, b0 + 3 : b0 + 6] = bhi[v, w]
            meta = np.where(is_gleaf, -(grow2 + 1), 0)
            # internal children: next level's BFS NODE ids in row-major
            # order over this level's (node, slot) grid
            next_base = node_base + n
            int_rank = (np.cumsum(child_int.reshape(-1)) - 1).reshape(n, W)
            meta = np.where(child_int, next_base + int_rank, meta)
            for w in range(W):
                if packed16:
                    r, mlane, clane = 0, 96 + w, 112 + w
                else:
                    r, c = divmod(w, 8)
                    mlane, clane = 64 + c, 72 + c
                rows[:, r, mlane] = np.where(
                    validk[:, w], meta[:, w], 0.0
                ).astype(np.float32)
                rows[:, r, clane] = np.where(
                    is_gleaf[:, w], gcnt2[:, w], 0.0
                ).astype(np.float32)
            if packed16:
                # order axis rides the child-0 count lane (cnt + 16*axis;
                # every count consumer masks & 15)
                rows[:, 0, 112] += 16.0 * axis.astype(np.float32)
            else:
                rows[:, 0, 80] = axis.astype(np.float32)
            level_rows.append(rows)
            level_meta.append(meta.astype(np.int64))
            level_isint.append(child_int)
            frontier = ids[child_int]
            node_base = next_base
            if frontier.size:
                max_depth += 1
        m_rows = leaf_row_base
        bfs = np.concatenate(level_rows)  # (total, NR, 128)
        total = bfs.shape[0]
        # ---- reorder BFS nodes into DFS preorder (vectorized) ----
        # Preorder puts near-first pops on adjacent rows (skipping it
        # cost the JAX package ~5% on its TPU 1M-tri bench; not
        # measured on the GPU). Children are always at later
        # BFS levels, so subtree sizes accumulate bottom-up per level
        # and preorder offsets distribute top-down per level.
        starts = np.cumsum([0] + [r.shape[0] for r in level_rows])
        metas = np.concatenate(level_meta)  # (total, W)
        is_int = np.concatenate(level_isint)
        child = np.where(is_int, metas, 0)
        sizes = np.ones(total, np.int64)
        for li in range(len(level_rows) - 1, -1, -1):
            a, b = starts[li], starts[li + 1]
            sizes[a:b] += np.where(
                is_int[a:b], sizes[child[a:b]], 0
            ).sum(axis=1)
        perm = np.zeros(total, np.int64)  # BFS node id -> preorder id
        for li in range(len(level_rows) - 1):
            a, b = starts[li], starts[li + 1]
            csz = np.where(is_int[a:b], sizes[child[a:b]], 0)
            prefix = np.cumsum(csz, axis=1) - csz  # exclusive, slot order
            off = perm[a:b, None] + 1 + prefix
            perm[child[a:b][is_int[a:b]]] = off[is_int[a:b]]
        nodes3 = np.zeros((total + 1, NR, 128), np.float32)
        nodes3[perm] = bfs
        # remap internal metas through the permutation; empty slots are
        # recognized by their inverted (never-hit) box, not the meta lane
        for w in range(W):
            if packed16:
                r, mlane = 0, 96 + w
                occupied = nodes3[:, 0, 6 * w] < EMPTY_BIG
            else:
                r, c = divmod(w, 8)
                mlane = 64 + c
                occupied = nodes3[:, r, 8 * c] < EMPTY_BIG
            lane = nodes3[:, r, mlane].astype(np.int64)
            vi = occupied & (lane >= 0)
            nodes3[vi, r, mlane] = perm[lane[vi]].astype(np.float32)
        # dummy park node at id num_nodes: the packet kernel's
        # software-pipelined loop parks on it (empty boxes never hit)
        nodes3[-1] = empty_rows((NR, 128))
        nodes = nodes3.reshape(-1, 128)

    # ---- leaf table: fill packed rows from destination segments ----
    seg_row = np.concatenate(seg_rows_l) if seg_rows_l else np.zeros(0, np.int64)
    seg_slot = np.concatenate(seg_slot_l) if seg_slot_l else np.zeros(0, np.int64)
    seg_len = np.concatenate(seg_len_l) if seg_len_l else np.zeros(0, np.int64)
    seg_src = np.concatenate(seg_src_l) if seg_src_l else np.zeros(0, np.int64)
    leafs = np.zeros((max(m_rows, 1), 128), np.float32)
    pid_all = indices.astype(np.int32).astype(np.float32)
    if spheres is not None:
        _fill_leaf_segments(
            leafs, seg_row, seg_slot, seg_len, seg_src,
            _sphere_rows_from(spheres, indices), 4, 0, 108, pid_all,
        )
    elif curves is not None:
        _fill_leaf_segments(
            leafs, seg_row, seg_slot, seg_len, seg_src,
            _curve_rows_from(curves, indices), 16, 0, 108, pid_all,
        )
    else:
        tri_all = vertices[faces[indices]].reshape(-1, 9)  # leaf-ordered
        _fill_leaf_segments(
            leafs, seg_row, seg_slot, seg_len, seg_src, tri_all, 9, 0, 90,
            pid_all,
        )
    leafs_woop = None
    if woop:
        leafs_woop = np.zeros((max(m_rows, 1), 128), np.float32)
        _fill_leaf_segments(
            leafs_woop, seg_row, seg_slot, seg_len, seg_src,
            _woop_transforms_from(vertices, faces, indices), 12, 0, 108,
            pid_all,
        )
    return BVH8Scene(
        nodes=nodes,
        leafs=leafs,
        num_nodes=total,  # logical nodes, excludes the dummy
        num_leaf_rows=m_rows,
        depth=max_depth + 1,
        max_leaf=max_leaf_out,
        width=W,
        leafs_woop=leafs_woop,
        leaf_kind=("triangle", "sphere", "curve")[kinds.index(True)],
    )


def _host(*xs):
    return [x.detach().cpu().numpy() if hasattr(x, "detach") else x
            for x in xs]


def _sphere_rows_from(spheres, indices) -> np.ndarray:
    """(L, 4) float32 [centre xyz | radius] of the leaf-ordered sphere
    stream ``indices``."""
    centers, radii = _host(*spheres)
    c = np.asarray(centers, np.float32)
    r = np.asarray(radii, np.float32).reshape(-1)
    out = np.empty((indices.shape[0], 4), np.float32)
    out[:, :3] = c[indices]
    out[:, 3] = r[indices]
    return out


def _curve_rows_from(curves, indices) -> np.ndarray:
    """(L, 16) float32 [p0 r0 | p1 0 | p2 0 | p3 r1] of the leaf-ordered
    curve stream ``indices``."""
    points, radii = _host(*curves)
    p = np.asarray(points, np.float32)[indices]  # (L, 4, 3)
    r = np.asarray(radii, np.float32)[indices]  # (L, 4)
    out = np.zeros((indices.shape[0], 4, 4), np.float32)
    out[..., :3] = p
    out[:, 0, 3] = r[:, 0]
    out[:, 3, 3] = r[:, 3]
    return out.reshape(-1, 16)


def collapse_bvh16(bvh: BVH, vertices, faces) -> BVH8Scene:
    """16-wide collapse in the DENSE single-row node layout: 16 children
    in ONE fully-occupied (1, 128) f32 row — child w's exact slab
    bounds at lanes [6w, 6w+6), metas at 96+w, leaf counts at 112+w,
    near-first order axis folded into the child-0 count lane as
    cnt + 16*axis (count consumers mask & 15)."""
    return collapse_bvh8(bvh, vertices, faces, width=16)
