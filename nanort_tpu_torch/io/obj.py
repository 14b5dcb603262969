"""Minimal Wavefront OBJ loader (host side; a copy of
``nanort_tpu.io.obj``, NumPy only).

The reference vendors tinyobjloader (examples/common/tiny_obj_loader.h)
and converts shapes into a facevarying Mesh (examples/common/obj-loader.cc,
path_tracer/main.cc:457-640). This is a dependency-free loader covering
the subset those examples consume: v / vn / vt / f (with polygon fan
triangulation and negative indices), usemtl / mtllib with newmtl, Kd, Ke,
Ks, Tf/Kt, Ni, d (dissolve).

Returns SoA numpy arrays ready for TriangleMesh / MeshAttributes /
path-tracer Materials.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class ObjMesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) i32
    facevarying_normals: np.ndarray | None  # (F, 3, 3)
    facevarying_uvs: np.ndarray | None  # (F, 3, 2)
    material_ids: np.ndarray  # (F,) i32 (-1 = none)
    materials: dict  # path-tracer material arrays
    # per-face `o`/`g` group index + the group names in file order
    # (empty/-1 when the file declares no objects) — lets callers remap
    # materials by object name for assets whose .mtl is degenerate
    object_ids: np.ndarray | None = None  # (F,) i32
    object_names: tuple = ()


def _default_material():
    return dict(
        diffuse=[0.7, 0.7, 0.7],
        emission=[0.0, 0.0, 0.0],
        specular=[0.0, 0.0, 0.0],
        transmittance=[0.0, 0.0, 0.0],
        ior=1.0,
        dissolve=0.0,
    )


def load_mtl(path: str) -> dict:
    """Parse a .mtl file into {name: material fields}."""
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0]
            if k == "newmtl":
                cur = _default_material()
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif k == "Kd":
                cur["diffuse"] = [float(x) for x in tok[1:4]]
            elif k == "Ke":
                cur["emission"] = [float(x) for x in tok[1:4]]
            elif k == "Ks":
                cur["specular"] = [float(x) for x in tok[1:4]]
            elif k in ("Tf", "Kt"):
                cur["transmittance"] = [float(x) for x in tok[1:4]]
            elif k == "Ni":
                cur["ior"] = float(tok[1])
            elif k == "d":
                cur["dissolve"] = 1.0 - float(tok[1])  # d=1 opaque
            elif k == "Tr":
                cur["dissolve"] = float(tok[1])
    return mats


def load_obj(path: str) -> ObjMesh:
    vs, vns, vts = [], [], []
    faces, fn_idx, ft_idx, fmat, fobj = [], [], [], [], []
    mtl_map: dict = {}
    mtl_names: list[str] = []
    obj_names: list[str] = []
    cur_mat = -1
    cur_obj = -1

    def mat_index(name):
        if name not in mtl_names:
            mtl_names.append(name)
        return mtl_names.index(name)

    def parse_vert(tok):
        # v, v/t, v//n, v/t/n with 1-based or negative indices
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        fix = lambda i, n: (i - 1) if i > 0 else (n + i if i < 0 else -1)
        return fix(vi, len(vs)), fix(ti, len(vts)), fix(ni, len(vns))

    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            k = tok[0]
            if k == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif k == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif k == "vt":
                vts.append([float(x) for x in tok[1:3]])
            elif k == "mtllib":
                mtl_map.update(
                    load_mtl(os.path.join(os.path.dirname(path), tok[1]))
                )
            elif k == "usemtl":
                cur_mat = mat_index(tok[1])
            elif k in ("o", "g") and len(tok) > 1:
                obj_names.append(tok[1])
                cur_obj = len(obj_names) - 1
            elif k == "f":
                idx = [parse_vert(t) for t in tok[1:]]
                for i in range(1, len(idx) - 1):  # fan triangulation
                    tri = (idx[0], idx[i], idx[i + 1])
                    faces.append([t[0] for t in tri])
                    ft_idx.append([t[1] for t in tri])
                    fn_idx.append([t[2] for t in tri])
                    fmat.append(cur_mat)
                    fobj.append(cur_obj)

    vertices = np.asarray(vs, np.float32)
    faces_a = np.asarray(faces, np.int32)
    nrm = None
    if vns and all(all(i >= 0 for i in f3) for f3 in fn_idx):
        vn = np.asarray(vns, np.float32)
        nrm = vn[np.asarray(fn_idx, np.int64)]
    uv = None
    if vts and all(all(i >= 0 for i in f3) for f3 in ft_idx):
        vt = np.asarray(vts, np.float32)
        uv = vt[np.asarray(ft_idx, np.int64)]

    # material table in file order; unknown names get defaults
    mats = [mtl_map.get(n, _default_material()) for n in mtl_names]
    if not mats:
        mats = [_default_material()]
    materials = dict(
        diffuse=np.asarray([m["diffuse"] for m in mats], np.float32),
        emission=np.asarray([m["emission"] for m in mats], np.float32),
        specular=np.asarray([m["specular"] for m in mats], np.float32),
        transmittance=np.asarray(
            [m["transmittance"] for m in mats], np.float32
        ),
        ior=np.asarray([m["ior"] for m in mats], np.float32),
        dissolve=np.asarray([m["dissolve"] for m in mats], np.float32),
    )
    material_ids = np.asarray(fmat, np.int32)
    material_ids[material_ids < 0] = 0
    return ObjMesh(
        vertices=vertices,
        faces=faces_a,
        facevarying_normals=nrm,
        facevarying_uvs=uv,
        material_ids=material_ids,
        materials=materials,
        object_ids=np.asarray(fobj, np.int32),
        object_names=tuple(obj_names),
    )


def remap_materials_by_object(mesh: ObjMesh, mapping: dict) -> ObjMesh:
    """Assign materials by object-group name prefix.

    ``mapping`` is {name_prefix: material fields} (fields as in
    ``_default_material``; missing keys take defaults). An object whose
    name starts with a mapping key (case-insensitive, longest prefix
    wins) gets that material; unmatched objects get ``mapping.get("*")``
    or the file's defaults. Used to light assets whose shipped .mtl is
    degenerate — e.g. the reference's cornellbox_suzanne.obj declares
    ONE no-emission material (examples/common/cornellbox_suzanne.mtl),
    so the de-facto config-B scene is lit by mapping its object groups
    (lightobj/left/right/...) to the sibling cornellbox_suzanne_lucy.mtl
    material values.
    """
    names = [k for k in mapping if k != "*"]
    mats = []
    obj_to_mat = []
    for oname in mesh.object_names:
        low = oname.lower()
        best = None
        for k in sorted(names, key=len, reverse=True):
            if low.startswith(k.lower()):
                best = k
                break
        if best is None and "*" in mapping:
            best = "*"
        m = _default_material()
        if best is not None:
            m.update(mapping[best])
        obj_to_mat.append(len(mats))
        mats.append(m)
    if not mats:
        mats = [_default_material()]
        obj_to_mat = [0]
    oid = (np.zeros(len(mesh.faces), np.int32)
           if mesh.object_ids is None else mesh.object_ids)
    material_ids = np.asarray(obj_to_mat, np.int32)[np.maximum(oid, 0)]
    materials = dict(
        diffuse=np.asarray([m["diffuse"] for m in mats], np.float32),
        emission=np.asarray([m["emission"] for m in mats], np.float32),
        specular=np.asarray([m["specular"] for m in mats], np.float32),
        transmittance=np.asarray(
            [m["transmittance"] for m in mats], np.float32),
        ior=np.asarray([m["ior"] for m in mats], np.float32),
        dissolve=np.asarray([m["dissolve"] for m in mats], np.float32),
    )
    return mesh._replace(material_ids=material_ids, materials=materials)


# cornellbox_suzanne.obj group -> cornellbox_suzanne_lucy.mtl values
# (Light/Wall_Red/Wall_Green/Wall_White/Monkey), the de-facto config-B
# protocol-scene lighting (see remap_materials_by_object docstring)
CORNELL_GROUP_MATERIALS = {
    "lightobj": dict(diffuse=[0.0, 0.0, 0.0],
                     emission=[15.0, 15.0, 15.0]),
    "left": dict(diffuse=[0.4096, 0.050353, 0.037544]),
    "right": dict(diffuse=[0.023333, 0.4096, 0.047991]),
    "suzanne": dict(diffuse=[0.0, 0.0, 0.0],
                    specular=[1.0, 1.0, 1.0]),
    "*": dict(diffuse=[0.8, 0.8, 0.8]),
}


def save_obj(path: str, vertices, faces) -> None:
    """Write a plain v/f OBJ (test round-trips, scene export)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(faces):
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
