"""Sharded-scene traversal: scenes larger than one device's memory (port
of ``nanort_tpu.parallel.sharded_scene``).

The reference's only capacity escape hatch is the 2G-prim cap plus manual
chunking through NanoSG (nanort.h:5-8; SURVEY.md §2.7 "Distributed
backend"). The design, as in the JAX package:

* the triangle set is split into spatially-compact chunks (Morton-ordered
  centroid ranges), one BVH + packed wavefront table per chunk, padded to
  a common shape (``build_scene_chunks``: host NumPy, the JAX package's
  tables bit for bit, padding included);
* one chunk a rank: rays are sharded over the same ranks, and traversal
  runs ``n`` rounds of (trace the local chunk -> merge the best hit ->
  pass the ray block and its carried hits to rank ``(r + 1) % n``). The
  JAX package's ``ppermute`` is a ``batch_isend_irecv`` here; after a
  full circle every ray has visited every chunk and is back home;
* hit records carry *global* prim ids (per-chunk permutation tables map
  local leaf order back), so results compare directly with a single-BVH
  traversal of the unsplit scene.

``engine="packet"`` traces each chunk with K1 (``traverse_bvh8_sorted``)
on per-chunk BVH8 tables whose leaf pid lanes already hold global ids;
``sequential_chunk_traverse`` runs the same tables and merge rule on one
device, chunk after chunk.

Each chunk's K1 scene takes that chunk's own depth (``ShardedScene.
depths8``, the node levels of its table, which ``BVH8Scene.to`` checks)
where the JAX package gives every chunk the largest: K1 sizes its per-ray
stack from ``depth``, and the padding rows are unreachable from row 0.
``num_nodes`` stays ``R_max - 1`` (the TPU kernel parks on the last
row); K1 reads no row its tree does not reference and needs neither.

The wavefront ring tests each leaf's triangles in a window as wide as
the chunk's largest leaf. The JAX package's ring walks with the
wavefront engine's default window of 4 triangles whatever the tables
hold, so with ``max_leaf_primitives > 4`` it skips the triangles of a
leaf past its fourth; with leaves of at most 4 (the default build) the
two rings agree.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..build.bvh8 import BVH8Scene, table_depth
from ..core.options import BVHBuildOptions, BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import Hits, Rays
from ..ops.triangle import TriangleMesh, _to_numpy

# leaf pid lanes hold global prim ids as float32, exact below 2^24
MAX_PACKET_PRIMS = 2**24


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(0)
    ext = np.maximum(centroids.max(0) - lo, 1e-30)
    q = np.clip((centroids - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)

    def expand(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (expand(q[:, 0]) << np.uint64(2)) | (
        expand(q[:, 1]) << np.uint64(1)
    ) | expand(q[:, 2])
    return np.argsort(code, kind="stable")


class ShardedScene:
    """Per-chunk packed tables stacked on a leading chunk axis, NumPy
    arrays as built (``to(device)`` returns a copy holding tensors).

    nodes:  (C, N_max, 12) f32   padded wavefront node tables
    soups:  (C, M_max, 12) f32   padded leaf-ordered triangle rows
    perms:  (C, M_max)     i32   chunk-local prim id -> GLOBAL prim id

    With ``packet=True`` at build time, per-chunk BVH8 tables for K1 ride
    along (leaf pid lanes already remapped to GLOBAL ids):

    nodes8: (C, R_max, 128) f32  padded BVH8 node rows (pad rows are
                                 inert empty-box rows)
    leafs8: (C, L_max, 128) f32  padded leaf rows
    depth8: the most node levels of any chunk (the JAX package's stack
            sizing); ``depths8``: each chunk's own levels, read from its
            table.
    """

    def __init__(self, nodes, soups, perms, num_nodes, num_chunks,
                 nodes8=None, leafs8=None, depth8=0, max_leaf8=0):
        self.nodes = nodes
        self.soups = soups
        self.perms = perms
        self.num_nodes = num_nodes  # padded N_max
        self.num_chunks = num_chunks
        self.nodes8 = nodes8
        self.leafs8 = leafs8
        self.depth8 = depth8
        self.max_leaf8 = max_leaf8
        self.depths8 = None
        if nodes8 is not None:
            host = _to_numpy(nodes8)
            self.depths8 = tuple(table_depth(host[c], 8)
                                 for c in range(num_chunks))

    def to(self, device) -> "ShardedScene":
        """Copy whose tables are contiguous torch tensors on ``device``."""
        out = copy.copy(self)
        for name in ("nodes", "soups", "perms", "nodes8", "leafs8"):
            x = getattr(self, name)
            if x is not None:
                setattr(out, name, torch.as_tensor(x).to(device).contiguous())
        return out


def build_scene_chunks(
    mesh: TriangleMesh,
    n_chunks: int,
    build_options: BVHBuildOptions = BVHBuildOptions(),
    packet: bool = False,
) -> ShardedScene:
    """Split a mesh into spatially-compact chunks, one packed BVH each
    (host NumPy; mesh fields may be arrays or tensors).

    ``packet=True`` additionally builds per-chunk BVH8 tables for K1; the
    leaf pid lanes are rewritten to GLOBAL prim ids at build time so the
    kernel's records need no per-chunk remap. They hold the ids as
    float32, so a packet scene takes at most 2^24 triangles (ValueError
    above, where the JAX package would round ids)."""
    from .. import build_triangle_bvh
    from ..build.bvh8 import EMPTY_BIG, MAX_LEAF_TRIS, collapse_bvh8
    from ..traverse.packed import pack_scene

    v = np.asarray(_to_numpy(mesh.vertices), np.float32)
    f = _to_numpy(mesh.faces).astype(np.int64)
    n_faces = f.shape[0]
    if n_chunks > n_faces:
        raise ValueError(f"more chunks ({n_chunks}) than faces ({n_faces})")
    if packet and n_faces > MAX_PACKET_PRIMS:
        raise ValueError(f"packet chunks carry global prim ids as float32, "
                         f"exact to 2^24: {n_faces} faces")
    if packet and build_options.max_leaf_primitives > MAX_LEAF_TRIS:
        raise ValueError("packet chunks need max_leaf_primitives <= 10")
    cent = v[f].mean(axis=1)
    order = _morton_order(cent)
    bounds = np.linspace(0, n_faces, n_chunks + 1).astype(np.int64)

    packs, perms, s8s = [], [], []
    for c in range(n_chunks):
        sel = order[bounds[c]: bounds[c + 1]]  # global prim ids, compact
        sub_f = f[sel]
        bvh, _ = build_triangle_bvh(TriangleMesh(v, sub_f), build_options)
        packs.append(pack_scene(bvh, v, sub_f))
        # soup row j holds chunk-local prim id indices[j]; map -> global
        perms.append(sel.astype(np.int32))
        if packet:
            s8 = collapse_bvh8(bvh, v, sub_f)
            # rewrite pid lanes chunk-local -> global (slots beyond a
            # row's count are never read, remap them unconditionally)
            leafs = s8.leafs.copy()
            local = leafs[:, 90:100].astype(np.int64)
            leafs[:, 90:100] = sel[np.minimum(local, len(sel) - 1)].astype(
                np.float32)
            s8s.append(s8._replace(leafs=leafs))

    n_max = max(p.num_nodes for p in packs)
    m_max = max(p.num_prims for p in packs)
    nodes = np.zeros((n_chunks, n_max, 12), np.float32)
    soups = np.zeros((n_chunks, m_max, 12), np.float32)
    perm_t = np.zeros((n_chunks, m_max), np.int32)
    for c, p in enumerate(packs):
        n, m = p.num_nodes, p.num_prims
        nodes[c, :n] = p.nodes
        # padding rows: inert branches (count 0 and skip = N_max end the
        # walk); rows n..N_max are reachable only through a real
        # sub-tree's terminal skip (== n)
        if n < n_max:
            nodes[c, n:, 8] = np.full(n_max - n, n_max, np.int32).view(
                np.float32)
        soups[c, :m] = p.soup
        perm_t[c, :m] = perms[c]
    nodes8 = leafs8 = None
    depth8 = max_leaf8 = 0
    if packet:
        r_max = max(s.nodes.shape[0] for s in s8s)
        l_max = max(s.leafs.shape[0] for s in s8s)
        nodes8 = np.zeros((n_chunks, r_max, 128), np.float32)
        # pad rows are inert EMPTY rows: all-zero boxes (lo == hi == 0)
        # are hittable by rays through the origin
        nodes8[:, :, 0:64:8] = EMPTY_BIG
        nodes8[:, :, 1:64:8] = EMPTY_BIG
        nodes8[:, :, 2:64:8] = EMPTY_BIG
        nodes8[:, :, 3:64:8] = -EMPTY_BIG
        nodes8[:, :, 4:64:8] = -EMPTY_BIG
        nodes8[:, :, 5:64:8] = -EMPTY_BIG
        leafs8 = np.zeros((n_chunks, l_max, 128), np.float32)
        for c, s in enumerate(s8s):
            nodes8[c, : s.nodes.shape[0]] = s.nodes
            leafs8[c, : s.leafs.shape[0]] = s.leafs
        depth8 = max(s.depth for s in s8s)
        max_leaf8 = max(s.max_leaf for s in s8s)
    return ShardedScene(
        nodes=nodes,
        soups=soups,
        perms=perm_t,
        num_nodes=n_max,
        num_chunks=n_chunks,
        nodes8=nodes8,
        leafs8=leafs8,
        depth8=depth8,
        max_leaf8=max_leaf8,
    )


def _chunk_scene8(scene: ShardedScene, c: int) -> BVH8Scene:
    """Chunk ``c``'s K1 scene: its rows of the padded tables (tensors
    stay where they are), its own depth."""
    return BVH8Scene(
        nodes=scene.nodes8[c],
        leafs=scene.leafs8[c],
        num_nodes=int(scene.nodes8.shape[1]) - 1,
        num_leaf_rows=int(scene.leafs8.shape[1]),
        depth=scene.depths8[c],
        max_leaf=scene.max_leaf8,
        width=8,
    )


def _no_hits_like(max_t: torch.Tensor) -> Hits:
    return Hits(
        t=max_t + 0.0,
        u=torch.zeros_like(max_t),
        v=torch.zeros_like(max_t),
        prim_id=torch.full_like(max_t, INVALID_PRIM_ID, dtype=torch.int64),
    )


def _merge_round(best_c: Hits, h: Hits) -> Hits:
    """The ring's merge rule: a chunk's hit replaces the carried one when
    its t is ``<=`` the carried t (a later chunk wins an equal-t tie)."""
    got = h.prim_id != INVALID_PRIM_ID
    upd = got & (h.t <= best_c.t)
    return Hits(
        t=torch.where(upd, h.t, best_c.t),
        u=torch.where(upd, h.u, best_c.u),
        v=torch.where(upd, h.v, best_c.v),
        prim_id=torch.where(upd, h.prim_id, best_c.prim_id),
    )


def _finish(best: Hits) -> Hits:
    hit = best.prim_id != INVALID_PRIM_ID
    zero = torch.zeros((), device=best.t.device)
    return Hits(t=best.t, u=torch.where(hit, best.u, zero),
                v=torch.where(hit, best.v, zero), prim_id=best.prim_id)


def _flat(rays: Rays) -> Rays:
    bs = rays.batch_shape
    return Rays(*(torch.as_tensor(x).reshape(
        (-1,) + tuple(x.shape[len(bs):])).contiguous() for x in rays))


def _window(rays: Rays, best: Hits) -> Rays:
    """Each ray's window tightened by its carried best hit."""
    return rays._replace(max_t=torch.minimum(rays.max_t, best.t))


def sequential_chunk_traverse(
    scene: ShardedScene,
    rays: Rays,
    options: BVHTraceOptions = BVHTraceOptions(),
    sub: int = 8,
) -> Hits:
    """Single-device proof of the packet-chunk layout: trace every chunk
    in turn with K1 (``traverse_bvh8_sorted``, one launch a chunk) on the
    rays' device, merging best hits between chunks — the per-chunk tables
    and merge rule the ring uses, without ``n_chunks`` devices. The
    scene's tables must be on the rays' device (``scene.to``), or host
    arrays for CPU rays."""
    if scene.nodes8 is None:
        raise ValueError("build_scene_chunks(..., packet=True) required")
    from ..traverse.ray_sort import traverse_bvh8_sorted

    bs = rays.batch_shape
    flat = _flat(rays)
    best = _no_hits_like(flat.max_t)
    for c in range(scene.num_chunks):
        h = traverse_bvh8_sorted(_chunk_scene8(scene, c),
                                 _window(flat, best), options, sub=sub)
        best = _merge_round(best, h)
    out = _finish(best)
    return Hits(*(x.reshape(bs) for x in out))


def _ring_shift(blocks: list, mesh) -> list:
    """Send ``blocks`` (tensors) to the mesh's next rank and receive the
    previous rank's, in one ``batch_isend_irecv`` (``ppermute`` to
    ``(r + 1) % n``; the identity on one rank)."""
    if mesh.size == 1:
        return blocks
    dist = torch.distributed
    nxt = mesh.ranks[(mesh.rank + 1) % mesh.size]
    prv = mesh.ranks[(mesh.rank - 1) % mesh.size]
    blocks = [x.contiguous() for x in blocks]
    out = [torch.empty_like(x) for x in blocks]
    ops = [dist.P2POp(dist.isend, x, nxt, mesh.group) for x in blocks]
    ops += [dist.P2POp(dist.irecv, y, prv, mesh.group) for y in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def sharded_scene_traverse(
    scene: ShardedScene,
    rays: Rays,
    device_mesh,
    options: BVHTraceOptions = BVHTraceOptions(),
    tile: int = 4096,
    engine: str = "auto",
    sub: int = 8,
) -> Hits:
    """Traverse rays against a chunk-sharded scene (see module docstring),
    chunk r on rank r. Every rank passes the whole scene and the whole
    batch; every rank gets the whole batch's hits back.

    ``device_mesh`` (``parallel.mesh.ray_mesh``) must have exactly
    ``scene.num_chunks`` ranks; the flat leading ray axis must divide
    evenly by it.

    ``engine``: "packet" traces each chunk with K1 (needs
    ``build_scene_chunks(..., packet=True)``), "wavefront" with the
    plain skip-link walk; "auto" picks packet on a CUDA mesh when the
    tables exist, as the JAX package picks it off the CPU."""
    from .mesh import _member, all_gather

    mesh = device_mesh
    _member(mesh)
    n = mesh.size
    if n != scene.num_chunks:
        raise ValueError(
            f"scene has {scene.num_chunks} chunks but mesh has {n} devices")
    bs = rays.batch_shape
    flat = _flat(rays)
    if flat.org.shape[0] % n:
        raise ValueError("ray count not divisible by mesh size")
    if engine == "auto":
        engine = ("packet" if scene.nodes8 is not None
                  and mesh.device.type == "cuda" else "wavefront")
    if engine not in ("packet", "wavefront"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "packet" and scene.nodes8 is None:
        raise ValueError(
            "engine='packet' needs build_scene_chunks(packet=True)")
    dev = mesh.device
    c = mesh.rank
    m = flat.org.shape[0] // n
    rays_c = Rays(*(x[c * m:(c + 1) * m].to(dev).contiguous() for x in flat))

    def table(x):
        return torch.as_tensor(x[c]).to(dev).contiguous()

    if engine == "packet":
        from ..traverse.ray_sort import traverse_bvh8_sorted

        s8 = _chunk_scene8(scene, c)
        s8 = s8._replace(nodes=table(scene.nodes8), leafs=table(scene.leafs8))

        def trace(r):
            return traverse_bvh8_sorted(s8, r, options, sub=sub)
    else:
        from ..traverse.packed import PackedScene
        from ..traverse.wavefront import traverse_wavefront

        nodes, soup = table(scene.nodes), table(scene.soups)
        perm = table(scene.perms).long()
        # the chunk's largest leaf sets the walk's leaf window
        max_leaf = max(int(nodes[:, 6].view(torch.int32).max()), 1)
        pk = PackedScene(nodes, soup, scene.num_nodes, soup.shape[0],
                         max_leaf)

        def trace(r):
            h = traverse_wavefront(pk, r, options, max_leaf=None, tile=tile)
            got = h.prim_id != INVALID_PRIM_ID
            gpid = perm[torch.where(got, h.prim_id, 0)]
            return h._replace(prim_id=torch.where(got, gpid, h.prim_id))

    best = _no_hits_like(rays_c.max_t)
    for _ in range(n):
        best = _merge_round(best, trace(_window(rays_c, best)))
        blocks = _ring_shift([*rays_c, *best], mesh)
        rays_c, best = Rays(*blocks[:4]), Hits(*blocks[4:])
    out = _finish(best)
    return Hits(*(all_gather(x, mesh).reshape(bs) for x in out))
