"""Minimal glTF 2.0 loader (port of ``nanort_tpu.io.gltf``: ``load_gltf``
is NumPy and copied as it is; ``to_scene_graph`` builds the port's
scene graph). The reference vendors tiny_gltf for its gltfrender
example (examples/gltfrender/).

Covers the subset that example consumes: .gltf (JSON + external/embedded
.bin) and .glb containers; triangle primitives with POSITION / NORMAL /
TEXCOORD_0 and u16/u32 indices; the node hierarchy with matrix or TRS
transforms (mapped onto scene.graph Nodes for instancing); material
baseColorFactor / emissiveFactor.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import NamedTuple

import numpy as np

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfMesh(NamedTuple):
    vertices: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3)
    normals: np.ndarray | None  # (V, 3) per-vertex
    uvs: np.ndarray | None  # (V, 2)
    material_id: int


class GltfScene(NamedTuple):
    meshes: list  # [GltfMesh]
    instances: list  # [(mesh_index, (4,4) world xform, node name)]
    materials: dict  # path-tracer style arrays


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(doc, bufs, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = bufs[view["buffer"]]
    dtype = _COMP_DTYPE[acc["componentType"]]
    n = _TYPE_N[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * n
    if stride and stride != itemsize:
        raw = np.frombuffer(
            buf, np.uint8, count * stride, offset
        ).reshape(count, stride)[:, :itemsize].tobytes()
        arr = np.frombuffer(raw, dtype).reshape(count, n)
    else:
        arr = np.frombuffer(buf, dtype, count * n, offset).reshape(count, n)
    return arr.copy()


def _node_xform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:  # quaternion xyzw
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] @ np.diag(node["scale"])
    return m


def load_gltf(path: str) -> GltfScene:
    base_dir = os.path.dirname(path)
    glb_bin = None
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            magic, version, _ = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67, "not a glb file"
            doc = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<II", hdr)
                data = f.read(clen)
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(data)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = data
    else:
        with open(path) as f:
            doc = json.load(f)
    bufs = _load_buffers(doc, base_dir, glb_bin)

    # materials
    mats = doc.get("materials", [])
    diffuse, emission = [], []
    for m in mats:
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])[:3]
        diffuse.append(base)
        emission.append(m.get("emissiveFactor", [0, 0, 0]))
    if not mats:
        diffuse, emission = [[0.7, 0.7, 0.7]], [[0, 0, 0]]
    nmat = len(diffuse)
    materials = dict(
        diffuse=np.asarray(diffuse, np.float32),
        emission=np.asarray(emission, np.float32),
        specular=np.zeros((nmat, 3), np.float32),
        transmittance=np.zeros((nmat, 3), np.float32),
        ior=np.ones(nmat, np.float32),
        dissolve=np.zeros(nmat, np.float32),
    )

    # meshes: one GltfMesh per primitive
    meshes: list[GltfMesh] = []
    mesh_prims: list[list[int]] = []
    for mesh in doc.get("meshes", []):
        prim_ids = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _accessor(doc, bufs, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor(doc, bufs, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            faces = idx.astype(np.int32).reshape(-1, 3)
            nrm = (
                _accessor(doc, bufs, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs else None
            )
            uv = (
                _accessor(doc, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs else None
            )
            prim_ids.append(len(meshes))
            meshes.append(GltfMesh(
                vertices=pos, faces=faces, normals=nrm, uvs=uv,
                material_id=prim.get("material", 0),
            ))
        mesh_prims.append(prim_ids)

    # node hierarchy -> flat instances
    instances = []
    nodes = doc.get("nodes", [])

    def walk(ni, parent):
        node = nodes[ni]
        xf = parent @ _node_xform(node)
        if "mesh" in node:
            for pid in mesh_prims[node["mesh"]]:
                instances.append((pid, xf, node.get("name", f"node{ni}")))
        for c in node.get("children", []):
            walk(c, xf)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{}])
    for root in scenes[scene_idx].get("nodes", range(len(nodes))):
        walk(root, np.eye(4))
    if not instances:  # no scene graph: instance every mesh at identity
        for prim_ids in mesh_prims:
            for pid in prim_ids:
                instances.append((pid, np.eye(4), f"mesh{pid}"))
    return GltfScene(meshes=meshes, instances=instances, materials=materials)


def to_scene_graph(g: GltfScene, device="cuda"):
    """Build a ``scene.graph.Scene`` on ``device`` (the card unless the
    caller asks for another device) with shared-mesh instancing: every
    instance of a glTF mesh points at one ``TriangleMesh``, so ``commit``
    builds it once."""
    from ..ops.triangle import TriangleMesh
    from ..scene.graph import Node, Scene

    sc = Scene(device=device)
    tri_meshes = [TriangleMesh(vertices=m.vertices, faces=m.faces)
                  for m in g.meshes]
    for i, (mid, xf, name) in enumerate(g.instances):
        sc.add_node(Node(f"{name}#{i}", tri_meshes[mid], xf))
    return sc
