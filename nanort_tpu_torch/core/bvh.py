"""Linear BVH container, serialization, and invariant checks.

The reference keeps its BVH as a pointer-free linear ``std::vector<BVHNode>``
plus a permuted primitive-index array (nanort.h:854-855) — already the ideal
TPU-resident layout. ``BVH`` holds the same data as a pytree of dense arrays:

* ``bmin``/``bmax``: (N, 3) float — node bounds
* ``flag``: (N,) int32 — 1 = leaf, 0 = branch (nanort.h:536)
* ``axis``: (N,) int32 — split axis for near-child ordering
* ``data``: (N, 2) uint32 — leaf: (count, index offset); branch: (left, right)
* ``indices``: (M,) uint32 — permuted primitive ids; leaf ranges contiguous

Nodes are emitted in DFS preorder (left child == parent + 1), exactly like
the reference's recursive builder (nanort.h:1759-1890), which is what the
skip-link packet traversal relies on.

``dump``/``load`` are byte-compatible with the reference's
``BVHAccel::Dump``/``Load`` (nanort.h:2164-2276): ``uint64 num_nodes |
nodes | uint64 num_indices | uint32 indices`` with 40-byte (f32) / 64-byte
(f64) node records.
"""

from __future__ import annotations

import io as _io
from typing import NamedTuple

import numpy as np

from .options import BVHBuildStatistics


class BVH(NamedTuple):
    bmin: "np.ndarray"
    bmax: "np.ndarray"
    flag: "np.ndarray"
    axis: "np.ndarray"
    data: "np.ndarray"
    indices: "np.ndarray"

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]

    @property
    def root_bounds(self):
        return self.bmin[0], self.bmax[0]


def node_record_dtype(real_dtype=np.float32) -> np.dtype:
    """NumPy structured dtype matching ``BVHNode<T>`` memory layout
    (nanort.h:498-550): T bmin[3]; T bmax[3]; int flag; int axis;
    unsigned data[2]. No padding for T in {float32, float64}."""
    return np.dtype(
        [
            ("bmin", real_dtype, (3,)),
            ("bmax", real_dtype, (3,)),
            ("flag", np.int32),
            ("axis", np.int32),
            ("data", np.uint32, (2,)),
        ]
    )


def dump(bvh: BVH, file) -> None:
    """Serialize in the reference's Dump format (nanort.h:2164-2218)."""
    close = False
    if isinstance(file, (str, bytes)):
        file = open(file, "wb")
        close = True
    try:
        n = bvh.num_nodes
        rec = np.empty(n, node_record_dtype(np.asarray(bvh.bmin).dtype))
        rec["bmin"] = np.asarray(bvh.bmin)
        rec["bmax"] = np.asarray(bvh.bmax)
        rec["flag"] = np.asarray(bvh.flag)
        rec["axis"] = np.asarray(bvh.axis)
        rec["data"] = np.asarray(bvh.data)
        file.write(np.uint64(n).tobytes())
        file.write(rec.tobytes())
        idx = np.asarray(bvh.indices, np.uint32)
        file.write(np.uint64(idx.shape[0]).tobytes())
        file.write(idx.tobytes())
    finally:
        if close:
            file.close()


def load(file, real_dtype=np.float32) -> BVH:
    """Deserialize the reference's Dump format (nanort.h:2220-2276)."""
    close = False
    if isinstance(file, (str, bytes)):
        file = open(file, "rb")
        close = True
    try:
        buf = file.read()
    finally:
        if close:
            file.close()
    rd = _io.BytesIO(buf)
    (num_nodes,) = np.frombuffer(rd.read(8), np.uint64)
    dt = node_record_dtype(real_dtype)
    rec = np.frombuffer(rd.read(int(num_nodes) * dt.itemsize), dt)
    (num_indices,) = np.frombuffer(rd.read(8), np.uint64)
    indices = np.frombuffer(rd.read(int(num_indices) * 4), np.uint32)
    return BVH(
        bmin=rec["bmin"].copy(),
        bmax=rec["bmax"].copy(),
        flag=rec["flag"].copy(),
        axis=rec["axis"].copy(),
        data=rec["data"].copy(),
        indices=indices.copy(),
    )


def validate(bvh: BVH, prim_bmin=None, prim_bmax=None, num_prims=None):
    """Structural invariant check (test utility, runs on host).

    Checks the properties the reference guarantees by construction:
    every primitive appears exactly once across leaves; child bounds are
    contained in parent bounds; child indices are in range; leaf ranges
    are disjoint and cover ``indices``; DFS preorder (left == parent+1).
    Raises AssertionError on violation.
    """
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data)
    idx = np.asarray(bvh.indices)
    n = bmin.shape[0]
    assert n >= 1
    seen = np.zeros(idx.shape[0], bool)
    for i in range(n):
        assert np.all(bmin[i] <= bmax[i] + 1e-30), f"node {i} inverted bounds"
        if flag[i] == 1:
            cnt, off = int(data[i, 0]), int(data[i, 1])
            assert cnt >= 1 and off + cnt <= idx.shape[0]
            assert not seen[off : off + cnt].any(), f"leaf {i} overlaps"
            seen[off : off + cnt] = True
        else:
            l, r = int(data[i, 0]), int(data[i, 1])
            assert 0 < l < n and 0 < r < n
            assert l == i + 1, f"node {i}: left child {l} not DFS preorder"
            eps = 1e-6 * (1.0 + np.abs(bmin[i]) + np.abs(bmax[i]))
            for c in (l, r):
                assert np.all(bmin[c] >= bmin[i] - eps) and np.all(
                    bmax[c] <= bmax[i] + eps
                ), f"child {c} escapes parent {i}"
    assert seen.all(), "some indices not covered by any leaf"
    if num_prims is not None:
        assert idx.shape[0] == num_prims
        assert np.array_equal(np.sort(idx), np.arange(num_prims))
    if prim_bmin is not None:
        # every leaf bbox must contain its primitives' bboxes
        for i in range(n):
            if flag[i] == 1:
                cnt, off = int(data[i, 0]), int(data[i, 1])
                ids = idx[off : off + cnt]
                eps = 1e-5 * (1.0 + np.abs(bmax[i]).max())
                assert np.all(prim_bmin[ids] >= bmin[i] - eps)
                assert np.all(prim_bmax[ids] <= bmax[i] + eps)


def compute_skip_links(bvh: BVH) -> "np.ndarray":
    """Escape indices for stackless DFS-order traversal.

    ``skip[i]`` = the node to jump to when the subtree rooted at ``i`` is
    culled (the next node in preorder that is not a descendant of ``i``).
    Root's skip is ``num_nodes`` (terminate). Enables the packet/stream
    traversal kernel where a whole ray tile walks the preorder array.
    """
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data)
    n = flag.shape[0]
    skip = np.empty(n, np.int32)

    stack = [(0, n)]
    while stack:
        i, esc = stack.pop()
        skip[i] = esc
        if flag[i] == 0:
            l, r = int(data[i, 0]), int(data[i, 1])
            stack.append((l, r))
            stack.append((r, esc))
    return skip


def max_tree_depth(bvh: BVH) -> int:
    """Max tree depth (root = 0), vectorized.

    In DFS preorder a node ``j`` is an ancestor of ``i`` iff
    ``j < i < skip[j]``, so depth[i] = number of branch intervals
    covering i — computed as a prefix sum over interval start/end
    increments (O(N) numpy, no Python recursion)."""
    flag = np.asarray(bvh.flag)
    n = flag.shape[0]
    if n <= 1:
        return 0
    skip = compute_skip_links(bvh)
    br = np.nonzero(flag == 0)[0]
    inc = np.zeros(n + 1, np.int64)
    np.add.at(inc, br + 1, 1)
    np.add.at(inc, skip[br], -1)
    return int(np.cumsum(inc[:n]).max())


def required_max_stack(bvh: BVH) -> int:
    """Traversal stack slots guaranteed to never overflow for this tree.

    Near-first DFS holds at most one deferred far child per ancestor
    level plus the two entries of the current push, so depth + 4 covers
    it (reference sizes 512 slots for max depth 256, nanort.h:63,2497)."""
    return max(8, max_tree_depth(bvh) + 4)


def stats_from_bvh(bvh: BVH) -> BVHBuildStatistics:
    flag = np.asarray(bvh.flag)
    st = BVHBuildStatistics()
    st.num_leaf_nodes = int((flag == 1).sum())
    st.num_branch_nodes = int((flag == 0).sum())
    st.max_tree_depth = max_tree_depth(bvh)
    return st


def debug_dump(bvh: BVH, max_nodes: int = 16) -> str:
    """Readable node dump (reference BVHAccel::Debug, nanort.h:2151-2162)."""
    lines = []
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data)
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    for i in range(min(bvh.num_nodes, max_nodes)):
        kind = "leaf" if flag[i] == 1 else "branch"
        lines.append(
            f"node[{i}] {kind} data=({data[i,0]},{data[i,1]}) "
            f"bmin={bmin[i].tolist()} bmax={bmax[i].tolist()}"
        )
    if bvh.num_nodes > max_nodes:
        lines.append(f"... ({bvh.num_nodes - max_nodes} more)")
    return "\n".join(lines)
