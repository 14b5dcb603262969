"""Packed, gather-friendly BVH + triangle tables (host NumPy; a copy of
``nanort_tpu.traverse.packed`` without its JAX pytree registration, so
both packages emit bit-identical tables). The wavefront engine
(``traverse/wavefront.py``) and ``multi_hit_wavefront`` walk them; the
path tracer keeps them on ``PTScene.packed``, and the scene graph
(``scene/graph.py``) concatenates its meshes' tables with
``pack_scene_multi`` and walks them from per-instance roots.

The reference's traversal chases 32-byte nodes and then dereferences
``indices_[i+offset] -> faces -> vertices`` per primitive (nanort.h:
2393-2403) — three dependent gathers. On TPU we pre-flatten everything at
build time into two dense row tables so the traversal needs exactly one
row-gather per node step and one per leaf primitive:

* node table (N, 12) float32 rows:
    [bmin.x bmin.y bmin.z bmax.x bmax.y bmax.z
     count offset skip pad pad pad]
  where ``count``/``offset``/``skip`` are int32 bit-cast into float lanes;
  count > 0 marks a leaf (count primitives at soup rows offset..offset+n),
  count == 0 a branch. ``skip`` is the DFS-preorder escape index
  (see core.bvh.compute_skip_links); the preorder successor of a hit
  branch is simply ``i + 1``.

* triangle soup (M, 12) float32 rows, permuted into leaf order
  (soup row j = triangle ``indices[j]``):
    [p0.x p0.y p0.z p1.x p1.y p1.z p2.x p2.y p2.z prim_id pad pad]

Row width 12 keeps rows 48-byte aligned; measured TPU row-gather
throughput on these tables is HBM-bandwidth-bound (~350 GB/s), which sets
the traversal speed-of-light this layout is designed to hit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bvh import BVH, compute_skip_links


@dataclasses.dataclass
class PackedScene:
    """The two gather tables plus their sizes."""

    nodes: np.ndarray  # (N, 12) f32, int lanes bitcast
    soup: np.ndarray  # (M, 12) f32, prim_id lane bitcast
    num_nodes: int
    num_prims: int
    # largest leaf primitive count (None when unknown, e.g. hand-built
    # tables): lets a traversal validate/derive its leaf unroll
    max_leaf: int | None = None


def pack_scene(bvh: BVH, vertices, faces) -> PackedScene:
    """Flatten a built BVH + mesh into the gather tables."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces)
    bmin = np.asarray(bvh.bmin, np.float32)
    bmax = np.asarray(bvh.bmax, np.float32)
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data).astype(np.int64)
    idx = np.asarray(bvh.indices).astype(np.int64)
    n = bmin.shape[0]
    m = idx.shape[0]

    skip = compute_skip_links(bvh).astype(np.int32)

    nodes = np.zeros((n, 12), np.float32)
    nodes[:, 0:3] = bmin
    nodes[:, 3:6] = bmax
    is_leaf = flag == 1
    count = np.where(is_leaf, data[:, 0], 0).astype(np.int32)
    offset = np.where(is_leaf, data[:, 1], 0).astype(np.int32)
    nodes[:, 6] = count.view(np.float32)
    nodes[:, 7] = offset.view(np.float32)
    nodes[:, 8] = skip.view(np.float32)

    tri = vertices[faces[idx]]  # (M, 3, 3) leaf-ordered
    soup = np.zeros((m, 12), np.float32)
    soup[:, 0:9] = tri.reshape(m, 9)
    soup[:, 9] = idx.astype(np.int32).view(np.float32)
    return PackedScene(
        nodes=nodes, soup=soup, num_nodes=n, num_prims=m,
        max_leaf=int(count.max(initial=1)),
    )


def pack_scene_multi(items) -> tuple:
    """Concatenate several (bvh, vertices, faces) packed tables into one
    PackedScene for per-ray-rooted traversal (the two-level scene graph's
    bottom level; see scene.graph).

    Returns (scene, roots) where roots[k] is the node-row index of mesh
    k's BVH root. Each sub-tree's terminal skip is remapped to the global
    sentinel (total node count) so a ray rooted in tree k terminates when
    it escapes tree k instead of walking into tree k+1.
    """
    packs = [pack_scene(b, v, f) for (b, v, f) in items]
    n_total = sum(p.num_nodes for p in packs)
    roots = []
    node_parts, soup_parts = [], []
    node_off = 0
    soup_off = 0
    for p in packs:
        nodes = p.nodes.copy()
        offs = nodes[:, 7].view(np.int32)
        skips = nodes[:, 8].view(np.int32)
        offs += soup_off
        skips[:] = np.where(
            skips == p.num_nodes, n_total, skips + node_off
        ).astype(np.int32)
        roots.append(node_off)
        node_parts.append(nodes)
        soup_parts.append(p.soup)
        node_off += p.num_nodes
        soup_off += p.num_prims
    scene = PackedScene(
        nodes=np.concatenate(node_parts),
        soup=np.concatenate(soup_parts),
        num_nodes=n_total,
        num_prims=soup_off,
        max_leaf=max(p.max_leaf or 1 for p in packs),
    )
    return scene, np.asarray(roots, np.int32)
