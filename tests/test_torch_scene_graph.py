"""PyTorch port, the two-level scene graph (``scene/matrix.py``,
``scene/graph.py``) against the JAX package on the same seeded inputs.

The JAX side builds each scene and runs its jitted ``scene_traverse``
(and ``transform_points``/``transform_dirs``) in a child process held to
AVX (``testing.run_without_fma``: no FMA contraction; jitted in-process,
XLA contracts the transforms' ``a * b + c`` and ``jnp.cross``). The port
builds the same scenes from the same NumPy arrays on the CPU.
Tolerances:
- host matrix helpers (``translate``, ``rotate``, ``compose``,
  ``inverse``, ``inv_transpose33``, ``xform_bbox``): identical arrays;
- ``transform_points`` / ``transform_dirs``: bit-identical;
- ``commit``: the packed tables, roots, face offsets and every
  per-instance matrix and world bound bit-identical;
- ``traverse`` (instanced, rotated, non-uniformly scaled and nested
  instances; facevarying normals; world t windows; 40 instances with
  equal world boxes): the same hit mask, node ids and prim ids, and t,
  u, v, positions and both normals bit for bit;
- the caches: a transform-only re-commit builds and packs nothing, a new
  mesh builds once, and moving a node back gives the first records bit
  for bit.
"""

import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch import BVHTraceOptions, make_rays
from nanort_tpu_torch.io.procedural import make_cornell_box, make_uv_sphere
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.scene import graph, matrix as mat
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)


def _meshes():
    """Mesh arrays shared by the scenes (index -> (v, f))."""
    return [make_uv_sphere(10, 20, 0.5), make_cornell_box(2.0),
            make_uv_sphere(6, 12, 0.4, (0.2, 0.1, 0.0))]


def _normals(f_count, seed=3):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(f_count, 3, 3)).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


# scene -> node specs (parent spec index or -1, name, mesh index or -1,
# local transform), in insertion order
SCENES = {
    "instances": [
        (-1, "left", 0, mat.translate([-1.5, 0, 0])),
        (-1, "right", 0, mat.compose(mat.translate([1.5, 0.3, -0.5]),
                                     mat.rotate([0.3, 1, 0.2], 0.7),
                                     mat.scale([2.0, 0.5, 1.0]))),
        (-1, "group", -1, mat.translate([0, 1.2, 0])),
        (2, "inner", 2, mat.compose(mat.rotate([0, 0, 1], np.pi / 3),
                                    mat.scale(1.5))),
        (-1, "box", 1, mat.scale([2.5, 2.5, 2.5])),
    ],
    "normals": [
        (-1, "ball", 0, mat.translate([0.3, -0.2, 0])),
        (-1, "box", 1, mat.identity()),
    ],
    # 40 instances of one mesh at one transform: every world box ties,
    # and the candidate order must keep the instance order
    "ties": [(-1, f"s{i}", 0, mat.translate([0.1, 0.0, 0.2]))
             for i in range(40)],
}
NORMAL_MESH = {"normals": 0}  # scene -> mesh index given facevarying normals


def _rays(n, seed):
    """Seeded rays from a shell around the scene toward its middle, some
    with a t window."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    org = (-4.0 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3))
    dirs = tgt - org
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    min_t = np.zeros(n, np.float32)
    max_t = np.full(n, np.finfo(np.float32).max, np.float32)
    min_t[1::5] = 3.0
    max_t[2::7] = 4.0
    return org, dirs, min_t, max_t


def _build(pkg_graph, mesh_cls, meshes, specs, to_mesh, device=None):
    sc = pkg_graph.Scene() if device is None else pkg_graph.Scene(device)
    tm = [mesh_cls(*to_mesh(v, f)) for v, f in meshes]
    nodes = []
    for parent, name, mi, xf in specs:
        node = pkg_graph.Node(name, tm[mi] if mi >= 0 else None, xf)
        (sc.add_node(node) if parent < 0 else nodes[parent].add_child(node))
        nodes.append(node)
    return sc, tm


TABLES = ("roots", "xform", "inv_xform", "inv_xform33", "inv_transpose33",
          "world_bmin", "world_bmax", "vertices", "faces", "face_offset")


@pytest.fixture(scope="module")
def jax_side():
    inputs = {}
    for i, name in enumerate(SCENES):
        for k, x in zip(("org", "dir", "min_t", "max_t"), _rays(300, 10 + i)):
            inputs[f"{name}/{k}"] = x
    rng = np.random.default_rng(2)
    inputs["m"] = rng.normal(size=(64, 4, 4)).astype(np.float32)
    inputs["p"] = rng.normal(size=(64, 3)).astype(np.float32)
    return inputs, run_without_fma(__file__, inputs)


def _port_scene(name):
    meshes = _meshes()
    sc, tm = _build(graph, TriangleMesh, meshes, SCENES[name],
                    lambda v, f: (v, f), "cpu")
    normals = None
    if name in NORMAL_MESH:
        mi = NORMAL_MESH[name]
        normals = {id(tm[mi]): _normals(len(meshes[mi][1]))}
    return sc, normals


def test_host_matrix_helpers_match():
    from nanort_tpu.scene import matrix as jmat

    xf = mat.compose(mat.rotate([1, 2, 3], 0.4), mat.scale([1, 2, 0.5]),
                     mat.translate([3, -1, 2]))
    jxf = jmat.compose(jmat.rotate([1, 2, 3], 0.4), jmat.scale([1, 2, 0.5]),
                       jmat.translate([3, -1, 2]))
    np.testing.assert_array_equal(xf, jxf)
    np.testing.assert_array_equal(mat.inverse(xf), jmat.inverse(jxf))
    np.testing.assert_array_equal(mat.inv_transpose33(xf),
                                  jmat.inv_transpose33(jxf))
    for a, b in zip(mat.xform_bbox(xf, [-1, -2, -3], [1, 2, 3]),
                    jmat.xform_bbox(jxf, [-1, -2, -3], [1, 2, 3])):
        np.testing.assert_array_equal(a, b)


def test_transforms_match_jax(jax_side):
    inputs, out = jax_side
    m, p = torch.from_numpy(inputs["m"]), torch.from_numpy(inputs["p"])
    np.testing.assert_array_equal(mat.transform_points(m, p).numpy(),
                                  out["points"])
    np.testing.assert_array_equal(
        mat.transform_dirs(m[:, :3, :3], p).numpy(), out["dirs"])


@pytest.mark.parametrize("name", list(SCENES))
def test_commit_tables_match_jax(jax_side, name):
    _, out = jax_side
    sc, normals = _port_scene(name)
    cs = sc.commit(mesh_normals=normals)
    np.testing.assert_array_equal(cs.packed.nodes.numpy(),
                                  out[f"{name}/packed_nodes"])
    np.testing.assert_array_equal(cs.packed.soup.numpy(),
                                  out[f"{name}/packed_soup"])
    for k in TABLES:
        np.testing.assert_array_equal(getattr(cs, k).numpy(),
                                      out[f"{name}/{k}"], err_msg=k)
    if normals is not None:
        np.testing.assert_array_equal(cs.normals.numpy(),
                                      out[f"{name}/normals"])
    lo, hi = sc.bounding_box()
    np.testing.assert_array_equal(lo, out[f"{name}/bbox_lo"])
    np.testing.assert_array_equal(hi, out[f"{name}/bbox_hi"])


@pytest.mark.parametrize("name", list(SCENES))
def test_traverse_matches_jax(jax_side, name):
    inputs, out = jax_side
    sc, normals = _port_scene(name)
    sc.commit(mesh_normals=normals)
    rays = make_rays(*(torch.from_numpy(inputs[f"{name}/{k}"])
                       for k in ("org", "dir", "min_t", "max_t")))
    got = sc.traverse(rays)
    hit = got.hit.numpy()
    assert hit.any() and (~hit).any()
    for k in graph.SceneHits._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      out[f"{name}/{k}"], err_msg=k)
    if name == "ties":
        assert (got.node_id.numpy()[hit] == 0).all()


def test_traverse_batch_shape_and_options():
    sc, _ = _port_scene("instances")
    sc.commit()
    org, d, lo, hi = _rays(24, 5)
    flat = sc.traverse(make_rays(*(torch.from_numpy(x) for x in (org, d, lo,
                                                                 hi))))
    grid = sc.traverse(make_rays(*(torch.from_numpy(x).reshape(
        (4, 6) + x.shape[1:]) for x in (org, d, lo, hi))))
    for a, b in zip(grid, flat):
        assert torch.equal(a.reshape(b.shape), b)
    assert grid.position.shape == (4, 6, 3)
    # back-face culling reaches the bottom-level walk
    culled = sc.traverse(make_rays(torch.from_numpy(org), torch.from_numpy(d)),
                         BVHTraceOptions(cull_back_face=True))
    assert culled.hit.sum() <= flat.hit.sum()
    with pytest.raises(RuntimeError):
        graph.Scene(device="cpu").committed
    with pytest.raises(ValueError):
        graph.Scene(device="cpu").commit()


def test_commit_caches(monkeypatch):
    """A transform-only re-commit builds nothing and packs nothing (the
    reference's build-once semantics, nanosg.h:409-443); moving a node
    and back gives the first records bit for bit."""
    import nanort_tpu_torch

    sc, _ = _port_scene("instances")
    calls = {"build": 0, "pack": 0}
    real_build = nanort_tpu_torch.build_triangle_bvh
    real_pack = graph.pack_scene_multi

    def build(*a, **k):
        calls["build"] += 1
        return real_build(*a, **k)

    def pack(*a, **k):
        calls["pack"] += 1
        return real_pack(*a, **k)

    monkeypatch.setattr(nanort_tpu_torch, "build_triangle_bvh", build)
    monkeypatch.setattr(graph, "pack_scene_multi", pack)
    sc.commit()
    assert calls == {"build": 3, "pack": 1}  # three unique meshes
    org, d, _, _ = _rays(200, 6)
    rays = make_rays(torch.from_numpy(org), torch.from_numpy(d))
    h0 = sc.traverse(rays)
    node = sc.find_node("left")
    node.translate(dx=7.0)
    sc.commit()
    assert calls == {"build": 3, "pack": 1}
    h1 = sc.traverse(rays)
    assert not (h1.node_id == 0).any() and (h0.node_id == 0).any()
    node.translate(dx=-7.0)
    sc.commit()
    h2 = sc.traverse(rays)
    for a, b in zip(h2, h0):
        assert torch.equal(a, b)
    # a new mesh builds once, the others stay cached
    sc.add_node(graph.Node("extra", TriangleMesh(*make_uv_sphere(4, 8))))
    sc.commit()
    assert calls == {"build": 4, "pack": 2}


def test_tables_on_the_scene_device_and_rays_checked():
    sc, _ = _port_scene("normals")
    cs = sc.commit()
    for k in TABLES:
        assert getattr(cs, k).device.type == "cpu"
    assert cs.packed.nodes.device.type == "cpu"
    import inspect

    assert inspect.signature(graph.Scene).parameters["device"].default \
        == "cuda"


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu.core.ray import Rays as JRays
    from nanort_tpu.ops.triangle import TriangleMesh as JMesh
    from nanort_tpu.scene import graph as jgraph
    from nanort_tpu.scene import matrix as jmat

    z = dict(np.load(inp))
    res = {}
    m, p = jnp.asarray(z["m"]), jnp.asarray(z["p"])
    res["points"] = np.asarray(jax.jit(jmat.transform_points)(m, p))
    res["dirs"] = np.asarray(jax.jit(jmat.transform_dirs)(m[:, :3, :3], p))
    meshes = _meshes()
    for name, specs in SCENES.items():
        sc, tm = _build(jgraph, JMesh, meshes, specs,
                        lambda v, f: (jnp.asarray(v), jnp.asarray(f)))
        normals = None
        if name in NORMAL_MESH:
            mi = NORMAL_MESH[name]
            normals = {id(tm[mi]): _normals(len(meshes[mi][1]))}
        cs = sc.commit(mesh_normals=normals)
        res[f"{name}/packed_nodes"] = np.asarray(cs.packed.nodes)
        res[f"{name}/packed_soup"] = np.asarray(cs.packed.soup)
        for k in TABLES:
            res[f"{name}/{k}"] = np.asarray(getattr(cs, k))
        if normals is not None:
            res[f"{name}/normals"] = np.asarray(cs.normals)
        res[f"{name}/bbox_lo"], res[f"{name}/bbox_hi"] = sc.bounding_box()
        rays = JRays(*(jnp.asarray(z[f"{name}/{k}"])
                       for k in ("org", "dir", "min_t", "max_t")))
        h = sc.traverse(rays)
        for k in jgraph.SceneHits._fields:
            res[f"{name}/{k}"] = np.asarray(getattr(h, k))
    # ids as the port holds them
    for k in list(res):
        if k.endswith(("prim_id", "node_id")) or k.endswith(("roots",
                                                             "face_offset",
                                                             "faces")):
            res[k] = res[k].astype(np.int64)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
