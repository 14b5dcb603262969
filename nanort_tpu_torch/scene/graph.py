"""NanoSG-equivalent two-level scene graph (port of
``nanort_tpu.scene.graph``; reference examples/nanosg/).

Host side: a ``Node`` hierarchy with non-owning mesh references, local
transforms and names (reference nanosg::Node, nanosg.h:322-506).
``Scene.commit()`` (reference Scene::Commit, nanosg.h:706-756):
  * composes world transforms down the tree,
  * builds one BVH per *unique* mesh (instances share builds), and keeps
    the build across re-commits: a transform-only edit rebuilds nothing,
  * packs all mesh BVHs into one concatenated wavefront table
    (``pack_scene_multi``) with per-instance roots, once for a list of
    unique meshes,
  * flattens per-instance transform/inverse/normal matrices and world
    bounds into tensors on the scene's device (``Scene(device=)``, the
    card unless the caller asks for another device).

``Scene.traverse()`` reproduces Scene::Traverse semantics (nanosg.h:
779-874): candidate instances whose world AABB the ray hits are visited
nearest-first (a *stable* sort of the slab entry distances, so instances
whose world boxes tie keep their instance order, as ``jnp.argsort``
does), each pass traces the candidates in local space through the
shared bottom-level table with per-ray roots (the wavefront engine,
``traverse_wavefront(..., root=)``), and hits convert back through the
instance transform keeping the nearest *world-space* distance.
Early-out: a candidate whose entry distance exceeds the current nearest
world hit is skipped (nanosg.h:805).

The JAX package runs the K passes as a ``fori_loop`` over every ray;
here they are a Python loop, and each pass traces only the rays for
which that candidate is live (the others' records are discarded there
anyway). The keys rise along a ray's candidate list and its nearest hit
only falls, so a candidate that is not live stays so for every later
pass, and the loop ends at the first pass with no live ray. The
arithmetic of a live ray is the JAX package's op for op: every product
its own op, sums over xyz in order, the world distance's square root
correctly rounded (``core.math.sqrt``).

Deviations of the reference kept from the JAX package: world-space ray
min_t/max_t are honored (the reference resets them to [0, inf) in local
space, a TODO in nanosg.h:816); world normals are normalized after the
inverse-transpose transform. Ids are int64 holding the JAX package's
uint32 values (0xFFFFFFFF for a miss).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.aabb import intersect_ray_aabb
from ..core.math import cross, length, normalize, safe_inverse
from ..core.options import BVHBuildOptions, BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Rays
from ..ops.triangle import TriangleMesh, _to_numpy
from ..traverse.packed import PackedScene, pack_scene_multi
from ..traverse.wavefront import traverse_wavefront
from . import matrix as mat


class Node:
    """Scene node: optional mesh + local transform + children
    (reference nanosg::Node<T, M>)."""

    def __init__(self, name: str, mesh: TriangleMesh | None = None,
                 local_xform=None):
        self.name = name
        self.mesh = mesh
        self.local_xform = (
            mat.identity() if local_xform is None else np.asarray(local_xform)
        )
        self.children: list[Node] = []

    def add_child(self, node: "Node"):
        self.children.append(node)
        return node

    def set_local_xform(self, xform):
        """Replace this node's local transform (the reference's gizmo
        edit path, nanosg.h:409-443). Call ``Scene.commit()`` afterwards:
        with the per-mesh BVH cache a transform-only re-commit skips
        every rebuild."""
        self.local_xform = np.asarray(xform, np.float64)

    def translate(self, dx=0.0, dy=0.0, dz=0.0):
        """Compose a translation onto the local transform (gizmo move)."""
        self.local_xform = mat.translate((dx, dy, dz)) @ self.local_xform


class SceneHits(NamedTuple):
    """Two-level hit record (reference nanosg::Intersection, nanosg.h:
    302-314): world t, barycentrics, mesh-local prim id, instance
    (node) id, world position and normals. Ids are int64."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_id: torch.Tensor
    node_id: torch.Tensor
    position: torch.Tensor  # (..., 3) world
    normal_g: torch.Tensor  # (..., 3) world geometric
    normal_s: torch.Tensor  # (..., 3) world shading

    @property
    def hit(self):
        return self.prim_id != INVALID_PRIM_ID


class CommittedScene(NamedTuple):
    """Flattened scene; every tensor lies on the scene's device."""

    packed: PackedScene  # tables as tensors on the device
    roots: torch.Tensor  # (I,) per-instance bottom-level root row
    xform: torch.Tensor  # (I, 4, 4)
    inv_xform: torch.Tensor  # (I, 4, 4)
    inv_xform33: torch.Tensor  # (I, 3, 3) direction transform
    inv_transpose33: torch.Tensor  # (I, 3, 3) normal transform
    world_bmin: torch.Tensor  # (I, 3)
    world_bmax: torch.Tensor  # (I, 3)
    # concatenated per-mesh geometry for shading lookups
    vertices: torch.Tensor  # (V, 3)
    faces: torch.Tensor  # (F, 3) with vertex offsets applied
    face_offset: torch.Tensor  # (I,) instance -> face-table offset
    normals: torch.Tensor | None  # (F, 3, 3) facevarying shading normals


class Scene:
    """Reference nanosg::Scene<T, M> (nanosg.h:664-905). ``device``: where
    ``commit`` puts the flattened tables, and where ``traverse`` expects
    its rays."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.root = Node("<root>")
        self._committed: CommittedScene | None = None
        self._flat_nodes: list[tuple[Node, np.ndarray]] = []
        # per-mesh build cache (reference semantics: a node's BVH is
        # built lazily ONCE, nanosg.h:409-411; transform edits only
        # recompose matrices). Keyed by mesh identity + build options;
        # holds the mesh ref so a recycled id() can never alias.
        self._build_cache: dict = {}
        self._pack_cache: tuple | None = None

    def add_node(self, node: Node):
        self.root.add_child(node)
        return node

    def find_node(self, name: str) -> Node | None:
        """Recursive name lookup (reference FindNode, nanosg.h:764-777)."""

        def rec(n):
            if n.name == name:
                return n
            for c in n.children:
                r = rec(c)
                if r is not None:
                    return r
            return None

        return rec(self.root)

    def commit(
        self,
        build_options: BVHBuildOptions = BVHBuildOptions(),
        mesh_normals: dict | None = None,
    ) -> CommittedScene:
        """Flatten + build. ``mesh_normals`` optionally maps id(mesh) ->
        (F, 3, 3) facevarying normals."""
        from .. import build_triangle_bvh

        dev = self.device
        # walk hierarchy composing transforms; collect mesh instances
        instances: list[tuple[Node, np.ndarray]] = []

        def walk(node, parent_xform):
            xf = parent_xform @ node.local_xform
            if node.mesh is not None:
                instances.append((node, xf))
            for c in node.children:
                walk(c, xf)

        walk(self.root, mat.identity())
        if not instances:
            raise ValueError("empty scene (reference Commit returns false)")
        self._flat_nodes = instances

        # unique meshes -> one BVH each
        mesh_key = {}
        unique = []
        for node, _ in instances:
            k = id(node.mesh)
            if k not in mesh_key:
                mesh_key[k] = len(unique)
                unique.append(node.mesh)
        built = []
        v_off, f_off = 0, 0
        mesh_face_off, cat_v, cat_f, cat_n = [], [], [], []
        for m in unique:
            v = np.asarray(_to_numpy(m.vertices), np.float32)
            f = np.asarray(_to_numpy(m.faces), np.int64)
            # build-once cache: a transform-only re-commit (interactive
            # gizmo edits) must not rebuild unchanged meshes
            hit = self._build_cache.get(id(m))
            if hit is not None and hit[0] is m and hit[1] == build_options:
                bvh = hit[2]
            else:
                bvh, _ = build_triangle_bvh(TriangleMesh(v, f), build_options)
                self._build_cache[id(m)] = (m, build_options, bvh)
            built.append((bvh, v, f))
            mesh_face_off.append(f_off)
            cat_v.append(v)
            cat_f.append(f + v_off)
            if mesh_normals and id(m) in mesh_normals:
                cat_n.append(np.asarray(_to_numpy(mesh_normals[id(m)]),
                                        np.float32))
            else:
                cat_n.append(None)
            v_off += v.shape[0]
            f_off += f.shape[0]

        # pack-once cache: the concatenated device tables depend only on
        # the unique-mesh list (+normals), not on instance transforms
        pack_key = tuple(id(m) for m in unique)
        if mesh_normals:
            pack_key = None  # caller-supplied normals: don't cache
        pc = self._pack_cache
        if pack_key is not None and pc is not None and pc[0] == pack_key:
            packed, mesh_roots, vertices_d, faces_d, normals = pc[1]
        else:
            packed, mesh_roots = pack_scene_multi(built)
            packed = PackedScene(
                nodes=torch.from_numpy(packed.nodes).to(dev),
                soup=torch.from_numpy(packed.soup).to(dev),
                num_nodes=packed.num_nodes, num_prims=packed.num_prims,
                max_leaf=packed.max_leaf)
            if any(n is not None for n in cat_n):
                cat_nf = [
                    n if n is not None
                    else np.zeros((fc.shape[0], 3, 3), np.float32)
                    for n, fc in zip(cat_n, cat_f)
                ]
                normals = torch.from_numpy(np.concatenate(cat_nf)).to(dev)
            else:
                normals = None
            vertices_d = torch.from_numpy(np.concatenate(cat_v)).to(dev)
            faces_d = torch.from_numpy(np.concatenate(cat_f)).to(dev)
            if pack_key is not None:
                self._pack_cache = (
                    pack_key,
                    (packed, mesh_roots, vertices_d, faces_d, normals),
                )

        xf, ixf, it33, wlo, whi, roots, foffs = [], [], [], [], [], [], []
        for node, x in instances:
            mid = mesh_key[id(node.mesh)]
            xf.append(x)
            ixf.append(mat.inverse(x))
            it33.append(mat.inv_transpose33(x))
            bvh = built[mid][0]
            lo, hi = mat.xform_bbox(x, bvh.bmin[0], bvh.bmax[0])
            wlo.append(lo)
            whi.append(hi)
            roots.append(mesh_roots[mid])
            foffs.append(mesh_face_off[mid])

        def f32(rows):
            return torch.from_numpy(np.stack(rows).astype(np.float32)).to(dev)

        inv_xform = f32(ixf)
        self._committed = CommittedScene(
            packed=packed,
            roots=torch.as_tensor(np.asarray(roots, np.int64), device=dev),
            xform=f32(xf),
            inv_xform=inv_xform,
            inv_xform33=inv_xform[:, :3, :3].contiguous(),
            inv_transpose33=f32(it33),
            world_bmin=f32(wlo),
            world_bmax=f32(whi),
            vertices=vertices_d,
            faces=faces_d,
            face_offset=torch.as_tensor(np.asarray(foffs, np.int64),
                                        device=dev),
            normals=normals,
        )
        return self._committed

    @property
    def committed(self) -> CommittedScene:
        if self._committed is None:
            raise RuntimeError("call commit() first (nanosg.h:706)")
        return self._committed

    def bounding_box(self):
        """World bounds of the whole scene (reference GetBoundingBox,
        nanosg.h:882-905), as NumPy arrays."""
        cs = self.committed
        return (
            cs.world_bmin.cpu().numpy().min(axis=0),
            cs.world_bmax.cpu().numpy().max(axis=0),
        )

    def traverse(self, rays: Rays, options: BVHTraceOptions = BVHTraceOptions(),
                 max_intersections: int = 64, tile: int = 8192) -> SceneHits:
        return scene_traverse(
            self.committed, rays, options, max_intersections, tile
        )


def _candidates(cs: CommittedScene, org, dir, min_t, max_t, K: int):
    """Each ray's instances whose world box it enters, nearest entry
    first: ``(key, order)``, the (R, I) entry distances (float32 max
    where the box is missed) and the (R, K) instance ids by a stable
    sort of them."""
    inv_dir = safe_inverse(dir)
    box_hit, tmin, _ = intersect_ray_aabb(
        cs.world_bmin[None, :, :], cs.world_bmax[None, :, :],
        org[:, None, :], inv_dir[:, None, :], (dir < 0)[:, None, :],
        min_t[:, None], max_t[:, None])
    big = torch.finfo(torch.float32).max
    key = torch.where(box_hit, tmin, big)
    order = torch.argsort(key, dim=1, stable=True)[:, :K]  # nanosg.h:792
    return key, order


def scene_traverse(
    cs: CommittedScene,
    rays: Rays,
    options: BVHTraceOptions = BVHTraceOptions(),
    max_intersections: int = 64,
    tile: int = 8192,
) -> SceneHits:
    """Nearest world-space hit of each ray over the committed instances.
    ``tile`` is the JAX signature's and changes nothing."""
    dev = cs.roots.device
    if rays.org.device != dev:
        raise ValueError(f"the scene is on {dev}, the rays on "
                         f"{rays.org.device}: move them to the scene's device")
    bs = rays.batch_shape
    org = rays.org.reshape(-1, 3)
    dir = rays.dir.reshape(-1, 3)
    min_t = rays.min_t.reshape(-1)
    max_t = rays.max_t.reshape(-1)
    R = org.shape[0]
    K = min(max_intersections, cs.roots.shape[0])
    big = torch.finfo(torch.float32).max
    key, order = _candidates(cs, org, dir, min_t, max_t, K)

    t_best = max_t.clone()
    u_b = torch.zeros(R, device=dev)
    v_b = torch.zeros(R, device=dev)
    pid_b = torch.full((R,), INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE, device=dev)
    nid_b = pid_b.clone()
    p_b = torch.zeros((R, 3), device=dev)
    ng_b = torch.zeros((R, 3), device=dev)
    ns_b = torch.zeros((R, 3), device=dev)

    for k in range(K):
        nid_all = order[:, k]
        tmin_k = key.gather(1, nid_all[:, None])[:, 0]
        # early cull (nanosg.h:805): skip when nearest < candidate entry
        active = (tmin_k < big) & ~(t_best < tmin_k)
        idx = active.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        nid = nid_all[idx]
        o = org[idx]
        d = dir[idx]
        l_org = mat.transform_points(cs.inv_xform[nid], o)
        l_dir = mat.transform_dirs(cs.inv_xform33[nid], d)
        n = idx.shape[0]
        l_rays = Rays(l_org, l_dir, torch.zeros(n, device=dev),
                      torch.full((n,), big, device=dev))
        hits = traverse_wavefront(cs.packed, l_rays, options, tile=tile,
                                  root=cs.roots[nid])
        got = hits.hit

        l_p = l_org + hits.t[:, None] * l_dir
        w_p = mat.transform_points(cs.xform[nid], l_p)
        t_world = length(w_p - o)
        # honor world-space t window (deviation: reference ignores it)
        upd = got & (t_world < t_best[idx]) & (t_world >= min_t[idx])

        fid = torch.where(got, cs.face_offset[nid] + hits.prim_id, 0)
        tri = cs.vertices[cs.faces[fid]]
        ng_l = cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        if cs.normals is not None:
            n3 = cs.normals[fid]
            w0 = (1.0 - hits.u - hits.v)[:, None]
            ns_l = (w0 * n3[:, 0] + hits.u[:, None] * n3[:, 1]
                    + hits.v[:, None] * n3[:, 2])
        else:
            ns_l = ng_l
        it33 = cs.inv_transpose33[nid]
        ng_w = normalize(mat.transform_dirs(it33, ng_l))
        ns_w = normalize(mat.transform_dirs(it33, ns_l))

        w = idx[upd]
        t_best[w] = t_world[upd]
        u_b[w] = hits.u[upd]
        v_b[w] = hits.v[upd]
        pid_b[w] = hits.prim_id[upd]
        nid_b[w] = nid[upd]
        p_b[w] = w_p[upd]
        ng_b[w] = ng_w[upd]
        ns_b[w] = ns_w[upd]

    hit = t_best < max_t
    h3 = hit[:, None]
    zero = torch.zeros((), device=dev)
    out = SceneHits(
        t=t_best,
        u=torch.where(hit, u_b, zero),
        v=torch.where(hit, v_b, zero),
        prim_id=torch.where(hit, pid_b, INVALID_PRIM_ID),
        node_id=torch.where(hit, nid_b, INVALID_PRIM_ID),
        position=torch.where(h3, p_b, zero),
        normal_g=torch.where(h3, ng_b, zero),
        normal_s=torch.where(h3, ns_b, zero),
    )
    return SceneHits(*(x.reshape(bs + x.shape[1:]) for x in out))
