"""Carry the JAX package's objects into the port, through NumPy.

The tests feed both packages one identical binary BVH, one identical
BVH8/BVH16 table set, one identical ray batch, one identical
path-tracer scene, chunk-sharded scene, per-face texture set or particle
set: take the JAX objects' fields with ``np.asarray`` and rebuild the
port's objects here. Nothing in this module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .build.bvh8 import BVH8Scene
from .core.bvh import BVH
from .core.ray import Rays


def bvh_from_numpy(bmin, bmax, flag, axis, data, indices) -> BVH:
    """A port ``BVH`` from the six fields of a binary BVH (either
    package's ``BVH`` unpacks into them in this order)."""
    return BVH(
        bmin=np.array(bmin), bmax=np.array(bmax),
        flag=np.array(flag, np.int32), axis=np.array(axis, np.int32),
        data=np.array(data, np.uint32), indices=np.array(indices, np.uint32),
    )


def scene_from_numpy(nodes, leafs, num_nodes, num_leaf_rows, depth,
                     max_leaf, width, leafs_woop=None) -> BVH8Scene:
    """A port ``BVH8Scene`` (host tables) from a BVH8/BVH16 table set,
    with its Woop table when it has one."""
    return BVH8Scene(
        nodes=np.ascontiguousarray(nodes, np.float32),
        leafs=np.ascontiguousarray(leafs, np.float32),
        num_nodes=int(num_nodes), num_leaf_rows=int(num_leaf_rows),
        depth=int(depth), max_leaf=int(max_leaf), width=int(width),
        leafs_woop=None if leafs_woop is None
        else np.ascontiguousarray(leafs_woop, np.float32),
    )


def pt_scene_from_numpy(vertices, faces, material_ids, materials,
                        light_faces, packed, face_table=None,
                        light_table=None, facevarying_normals=None,
                        scene8=None, fused_aux=None, device="cuda"):
    """A port ``PTScene`` on ``device`` (the card unless the caller asks
    for another device) from a JAX ``PTScene``'s fields as NumPy arrays,
    so both packages render from the same tables.

    ``materials``: the six material arrays in ``Materials`` field order
    (diffuse, emission, specular, transmittance, ior, dissolve);
    ``packed``: (nodes, soup, num_nodes, num_prims, max_leaf);
    ``scene8``: a port ``BVH8Scene`` (``scene_from_numpy``, with its
    ``leafs_woop`` for a turbo scene) or None."""
    from .models.path_tracer import Materials, PTScene
    from .ops.triangle import TriangleMesh
    from .traverse.packed import PackedScene

    def t(x, dtype=np.float32):
        if x is None:
            return None
        return torch.from_numpy(np.array(x, dtype, order="C"))

    nodes, soup, num_nodes, num_prims, max_leaf = packed
    scene = PTScene(
        mesh=TriangleMesh(t(vertices), t(faces, np.int32)),
        packed=PackedScene(t(nodes), t(soup), int(num_nodes),
                           int(num_prims),
                           None if max_leaf is None else int(max_leaf)),
        materials=Materials(*(t(m) for m in materials)),
        material_ids=t(material_ids, np.int32),
        facevarying_normals=t(facevarying_normals),
        light_faces=t(light_faces, np.int32),
        scene8=scene8,
        face_table=t(face_table),
        light_table=t(light_table),
        fused_aux=t(fused_aux),
    )
    return scene.to(device)


def rays_from_numpy(org, dir, min_t, max_t, device="cuda") -> Rays:
    """Contiguous float32 ``Rays`` on ``device`` (the card unless the
    caller asks for another device) from four arrays."""

    def t(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=device)

    return Rays(t(org), t(dir), t(min_t), t(max_t))


def _prim_tensor(x, device):
    a = np.array(x, order="C")
    if a.dtype.kind != "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def spheres_from_numpy(centers, radii, device="cuda"):
    """Port ``Spheres`` on ``device`` (the card unless the caller asks
    for another device); float arrays keep their dtype."""
    from .ops.sphere import Spheres

    return Spheres(_prim_tensor(centers, device), _prim_tensor(radii, device))


def cylinders_from_numpy(p0, p1, r0, r1, device="cuda"):
    """Port ``Cylinders`` on ``device``; float arrays keep their dtype."""
    from .ops.cylinder import Cylinders

    return Cylinders(*(_prim_tensor(x, device) for x in (p0, p1, r0, r1)))


def curves_from_numpy(points, radii, device="cuda"):
    """Port ``Curves`` on ``device``; float arrays keep their dtype."""
    from .ops.curve import Curves

    return Curves(_prim_tensor(points, device), _prim_tensor(radii, device))


def sharded_scene_from_numpy(nodes, soups, perms, num_nodes, num_chunks,
                             nodes8=None, leafs8=None, depth8=0,
                             max_leaf8=0):
    """A port ``ShardedScene`` (host tables) from a JAX ``ShardedScene``'s
    fields; each chunk's own depth is read from its BVH8 table."""
    from .parallel.sharded_scene import ShardedScene

    def a(x, dtype):
        return None if x is None else np.ascontiguousarray(x, dtype)

    return ShardedScene(
        a(nodes, np.float32), a(soups, np.float32), a(perms, np.int32),
        int(num_nodes), int(num_chunks), nodes8=a(nodes8, np.float32),
        leafs8=a(leafs8, np.float32), depth8=int(depth8),
        max_leaf8=int(max_leaf8))


def face_textures_from_numpy(texels, ures, vres, device="cuda"):
    """A port ``FaceTextures`` on ``device`` (the card unless the caller
    asks for another device) from a JAX ``FaceTextures``' three arrays.
    (A JAX ``Spheres``, as ``to_spheres`` makes it, comes over through
    ``spheres_from_numpy``.)"""
    from .io.ptex import _on

    return _on(texels, ures, vres, device)
