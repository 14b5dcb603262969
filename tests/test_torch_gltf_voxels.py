"""PyTorch port, the glTF loader (``io/gltf.py``) and the voxel mesher
(``io/voxels.py``) against the JAX package, on inputs built in memory (no
asset is read).

- ``voxels_to_mesh`` / ``grid2d_to_boxes`` (NumPy copies): identical
  arrays on seeded grids.
- ``load_gltf`` (a NumPy copy): identical meshes, instances and materials
  for a ``.gltf`` with a data URI, a ``.glb``, and a ``.gltf`` with an
  external ``.bin`` — u16 and u32 indices, a strided vertex view,
  normals and texture coordinates, a skipped line primitive, TRS,
  quaternion and matrix nodes in a hierarchy, and a document without
  nodes.
- ``to_scene_graph`` -> ``commit`` -> ``traverse``: every record field
  bit-identical to the JAX package's jitted walk (run in the no-FMA
  child, ``testing.run_without_fma``), one BVH build per glTF mesh
  however many nodes instance it, and the scene on the device asked for
  (the card by default).
"""

import base64
import json
import os
import struct
import sys
import tempfile

import numpy as np
import pytest
import torch

from nanort_tpu_torch import make_rays
from nanort_tpu_torch.io import gltf, voxels
from nanort_tpu_torch.io.procedural import make_uv_sphere
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)


def _doc():
    """Two meshes: a u16-indexed sphere with normals and uvs behind a
    strided view, and a u32-indexed quad (plus a line primitive that the
    loader skips); instanced by a TRS node, a quaternion node under a
    matrix parent, and a scaled node."""
    sv, sf = make_uv_sphere(6, 12, 0.5)
    sn = sv / np.linalg.norm(sv, axis=1, keepdims=True)
    suv = np.stack([np.arange(len(sv)) / len(sv),
                    np.linspace(1, 0, len(sv))], 1).astype(np.float32)
    inter = np.concatenate([sv, sn], 1).astype(np.float32)  # stride 24
    qv = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                  np.float32)
    qf = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    parts = [inter.tobytes(), suv.tobytes(), sf.astype(np.uint16).tobytes(),
             qv.tobytes(), qf.tobytes()]
    pad = [(-len(p)) % 4 for p in parts]
    offs = np.cumsum([0] + [len(p) + q for p, q in zip(parts, pad)])
    buf = b"".join(p + b"\0" * q for p, q in zip(parts, pad))
    views = [
        {"buffer": 0, "byteOffset": int(offs[0]), "byteLength": len(parts[0]),
         "byteStride": 24},
        {"buffer": 0, "byteOffset": int(offs[1]), "byteLength": len(parts[1])},
        {"buffer": 0, "byteOffset": int(offs[2]), "byteLength": len(parts[2])},
        {"buffer": 0, "byteOffset": int(offs[3]), "byteLength": len(parts[3])},
        {"buffer": 0, "byteOffset": int(offs[4]), "byteLength": len(parts[4])},
    ]
    acc = [
        {"bufferView": 0, "componentType": 5126, "count": len(sv),
         "type": "VEC3"},
        {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
         "count": len(sv), "type": "VEC3"},
        {"bufferView": 1, "componentType": 5126, "count": len(sv),
         "type": "VEC2"},
        {"bufferView": 2, "componentType": 5123, "count": sf.size,
         "type": "SCALAR"},
        {"bufferView": 3, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 4, "componentType": 5125, "count": 6,
         "type": "SCALAR"},
    ]
    m = np.eye(4)
    m[:3, 3] = [0.0, 1.5, -1.0]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(buf)}],
        "bufferViews": views,
        "accessors": acc,
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                            "TEXCOORD_0": 2},
                             "indices": 3, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": 4}, "indices": 5},
                            {"attributes": {"POSITION": 4}, "mode": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 1]}},
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 0, 0, 1]},
             "emissiveFactor": [0, 0, 2]},
        ],
        "nodes": [
            {"mesh": 0, "name": "ball", "translation": [-1.2, 0, 0]},
            {"name": "group", "matrix": m.T.reshape(-1).tolist(),
             "children": [2]},
            {"mesh": 0, "name": "tilted",
             "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
             "scale": [1.0, 2.0, 1.0]},
            {"mesh": 1, "name": "wall", "translation": [0, 0, -3],
             "scale": [4, 4, 1]},
        ],
        "scenes": [{"nodes": [0, 1, 3]}],
        "scene": 0,
    }
    return doc, buf


def _write(directory):
    """The document as a .gltf with a data URI, a .glb, a .gltf with an
    external .bin, and a .gltf without nodes; returns their paths."""
    doc, buf = _doc()
    paths = {}
    d = json.loads(json.dumps(doc))
    d["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                              + base64.b64encode(buf).decode())
    paths["data_uri"] = os.path.join(directory, "a.gltf")
    with open(paths["data_uri"], "w") as fh:
        json.dump(d, fh)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    glb = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(buf))
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(buf), 0x004E4942) + buf
    paths["glb"] = os.path.join(directory, "b.glb")
    with open(paths["glb"], "wb") as fh:
        fh.write(glb)
    d = json.loads(json.dumps(doc))
    d["buffers"][0]["uri"] = "c.bin"
    with open(os.path.join(directory, "c.bin"), "wb") as fh:
        fh.write(buf)
    paths["external_bin"] = os.path.join(directory, "c.gltf")
    with open(paths["external_bin"], "w") as fh:
        json.dump(d, fh)
    d = json.loads(json.dumps(doc))
    del d["nodes"], d["scenes"], d["scene"]
    d["buffers"][0]["uri"] = "c.bin"
    paths["no_nodes"] = os.path.join(directory, "d.gltf")
    with open(paths["no_nodes"], "w") as fh:
        json.dump(d, fh)
    return paths


def _rays(n=400, seed=9):
    rng = np.random.default_rng(seed)
    org = np.zeros((n, 3), np.float32)
    org[:, 2] = 5.0
    org[:, :2] = rng.uniform(-0.3, 0.3, (n, 2))
    tgt = rng.uniform(-2.5, 2.5, (n, 3)) * [1, 1, 0]
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


FIELDS = ("t", "u", "v", "prim_id", "node_id", "position", "normal_g",
          "normal_s")


@pytest.fixture(scope="module")
def jax_side():
    org, d = _rays()
    return run_without_fma(__file__, {"org": org, "dir": d})


@pytest.fixture(scope="module")
def files():
    with tempfile.TemporaryDirectory() as d:
        yield _write(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxels_match_jax(seed):
    from nanort_tpu.io import voxels as jvox

    rng = np.random.default_rng(seed)
    occ = rng.random((5, 4, 6)) < 0.45
    for a, b in zip(voxels.voxels_to_mesh(occ, 0.5, (1, 2, 3)),
                    jvox.voxels_to_mesh(occ, 0.5, (1, 2, 3))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    g2 = rng.random((7, 9)) < 0.5
    for a, b in zip(voxels.grid2d_to_boxes(g2, 0.3, 2.0),
                    jvox.grid2d_to_boxes(g2, 0.3, 2.0)):
        np.testing.assert_array_equal(a, b)
    v, f = voxels.voxels_to_mesh(np.zeros((2, 2, 2), bool))
    assert v.shape == (0, 3) and f.shape == (0, 3)


@pytest.mark.parametrize("kind", ["data_uri", "glb", "external_bin",
                                  "no_nodes"])
def test_load_gltf_matches_jax(files, kind):
    from nanort_tpu.io import gltf as jgltf

    a, b = gltf.load_gltf(files[kind]), jgltf.load_gltf(files[kind])
    assert len(a.meshes) == len(b.meshes) == 2
    for ma, mb in zip(a.meshes, b.meshes):
        for x, y in zip(ma, mb):
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    assert len(a.instances) == len(b.instances) == (
        2 if kind == "no_nodes" else 3)
    for (ia, xa, na), (ib, xb, nb) in zip(a.instances, b.instances):
        assert ia == ib and na == nb
        np.testing.assert_array_equal(xa, xb)
    for k in b.materials:
        np.testing.assert_array_equal(a.materials[k], b.materials[k])
    assert a.meshes[0].normals is not None and a.meshes[1].uvs is None


def test_to_scene_graph_traverse_matches_jax(files, jax_side, monkeypatch):
    import nanort_tpu_torch

    calls = []
    real = nanort_tpu_torch.build_triangle_bvh
    monkeypatch.setattr(nanort_tpu_torch, "build_triangle_bvh",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sc = gltf.to_scene_graph(gltf.load_gltf(files["glb"]), device="cpu")
    sc.commit()
    assert len(calls) == 2  # two glTF meshes, three instances
    org, d = _rays()
    h = sc.traverse(make_rays(torch.from_numpy(org), torch.from_numpy(d)))
    assert set(h.node_id[h.hit].tolist()) == {0, 1, 2}
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(h, k).numpy(),
                                      jax_side[k], err_msg=k)


def test_to_scene_graph_device():
    import inspect

    assert inspect.signature(gltf.to_scene_graph).parameters[
        "device"].default == "cuda"


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu.core.ray import make_rays as jmake_rays
    from nanort_tpu.io import gltf as jgltf

    z = dict(np.load(inp))
    with tempfile.TemporaryDirectory() as d:
        sc = jgltf.to_scene_graph(jgltf.load_gltf(_write(d)["glb"]))
    sc.commit()
    h = sc.traverse(jmake_rays(jnp.asarray(z["org"]), jnp.asarray(z["dir"])))
    res = {k: np.asarray(getattr(h, k)) for k in FIELDS}
    for k in ("prim_id", "node_id"):
        res[k] = res[k].astype(np.int64)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
