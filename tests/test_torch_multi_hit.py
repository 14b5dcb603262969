"""PyTorch port, K-nearest multi-hit traversal (``traverse/multi_hit.py``):
the stack engine, the wavefront engine (multi-mesh tables and per-ray
roots) and the brute-force oracle against the JAX package's, on the same
binary BVH, packed tables and seeded rays (CPU tensors).

Tolerance: equal counts and prim ids in every slot (the lists sort by
(t, prim_id), so ties resolve alike), t within 4 ulp, u/v within 1e-6
absolute. Cases: a UV sphere and a triangle soup at K = 8 on both
engines, K truncation (1, 4 and 16) and K = 1 against the single-hit
engine, trace filters (``prim_ids_range`` with ``cull_back_face``, a
per-ray ``skip_prim_id``), and three meshes in one packed table with a
root per ray. The JAX side runs jitted in a child process whose XLA CPU
backend emits no FMA (``testing.run_without_fma``).
"""

import sys

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.io.procedural import (make_random_triangles,
                                            make_uv_sphere)
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import run_without_fma, ulp_distance
from nanort_tpu_torch.traverse import multi_hit as mh
from nanort_tpu_torch.traverse.packed import pack_scene, pack_scene_multi

torch.set_num_threads(1)

FIELDS = ("t", "u", "v", "prim_id", "count")
BVH_FIELDS = ("bmin", "bmax", "flag", "axis", "data", "indices")
FILTER = dict(prim_ids_range=(50, 400), cull_back_face=True)


def _mesh(kind):
    if kind == "sphere":
        return make_uv_sphere(12, 24)
    return make_random_triangles(600, seed=7)


def _rays(n=333, seed=21):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-2.5, 2.5, (n, 3))
    d = rng.uniform(-0.5, 0.5, (n, 3)) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _roots_case():
    """Three one-triangle meshes at z = -5, -2, -3.5, rays down -z from
    the origin, each rooted at its own mesh."""
    items = []
    for z in (-5.0, -2.0, -3.5):
        v = np.array([[-2, -2, z], [2, -2, z], [0, 2, z]], np.float32)
        f = np.array([[0, 1, 2]], np.int64)
        bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
        items.append((bvh, v, f))
    scene, roots = pack_scene_multi(items)
    org = np.zeros((3, 3), np.float32)
    d = np.tile([0, 0, -1.0], (3, 1)).astype(np.float32)
    return scene, roots, org, d


def _jax_side(inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import nanort_tpu as jnt
    from nanort_tpu.core.bvh import BVH as JBVH
    from nanort_tpu.traverse import multi_hit as jmh
    from nanort_tpu.traverse.packed import PackedScene

    z = dict(np.load(inp))
    res = {}

    def put(name, h):
        for k in FIELDS:
            res[f"{name}/{k}"] = np.asarray(getattr(h, k))

    rays = jnt.make_rays(*(jnp.asarray(x) for x in _rays()))
    for kind in ("sphere", "soup"):
        v, f = _mesh(kind)
        mesh = jnt.TriangleMesh(jnp.asarray(v), jnp.asarray(f))
        bvh = JBVH(*(z[f"{kind}/{k}"] for k in BVH_FIELDS))
        put(f"{kind}/brute", jmh.brute_force_multi_hit(mesh, rays, 8))
        put(f"{kind}/stack", jmh.multi_hit_traverse(bvh, mesh, rays, 8))
        packed = PackedScene(*(z[f"{kind}/packed/{k}"]
                               for k in ("nodes", "soup")),
                             int(z[f"{kind}/packed/n"][0]),
                             int(z[f"{kind}/packed/n"][1]))
        put(f"{kind}/wavefront", jmh.multi_hit_wavefront(packed, rays, 8,
                                                          tile=128))
        if kind == "sphere":
            for K in (1, 4, 16):
                put(f"sphere/stack{K}", jmh.multi_hit_traverse(
                    bvh, mesh, rays, K))
        else:
            opt = jnt.BVHTraceOptions(**FILTER)
            put("soup/brute_filtered", jmh.brute_force_multi_hit(
                mesh, rays, 6, opt))
            put("soup/stack_filtered", jmh.multi_hit_traverse(
                bvh, mesh, rays, 6, opt))
            put("soup/stack_skip", jmh.multi_hit_traverse(
                bvh, mesh, rays, 6, skip_prim_id=jnp.asarray(z["soup/skip"])))
    packed = PackedScene(z["roots/nodes"], z["roots/soup"],
                         int(z["roots/n"][0]), int(z["roots/n"][1]))
    put("roots", jmh.multi_hit_wavefront(
        packed, jnt.make_rays(jnp.asarray(z["roots/org"]),
                              jnp.asarray(z["roots/dir"])), 4,
        root=jnp.asarray(z["roots/root"]), tile=8))
    np.savez(out, **res)


def _port_rays():
    org, d = _rays()
    return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))


@pytest.fixture(scope="module")
def case():
    """Per mesh: the port's BVH, mesh and packed tables; the JAX
    package's lists for every case."""
    inputs, port = {}, {}
    for kind in ("sphere", "soup"):
        v, f = _mesh(kind)
        bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
        packed = pack_scene(bvh, v, f)
        port[kind] = (bvh, TriangleMesh(torch.from_numpy(v),
                                        torch.from_numpy(f)), packed)
        for k, x in zip(BVH_FIELDS, bvh):
            inputs[f"{kind}/{k}"] = np.asarray(x)
        inputs[f"{kind}/packed/nodes"] = packed.nodes
        inputs[f"{kind}/packed/soup"] = packed.soup
        inputs[f"{kind}/packed/n"] = np.asarray([packed.num_nodes,
                                                 packed.num_prims])
    # every other ray skips the nearest prim of its unfiltered list
    first = mh.multi_hit_traverse(port["soup"][0], port["soup"][1],
                                  _port_rays(), 1).prim_id[:, 0].clone()
    first[1::2] = nt.INVALID_PRIM_ID
    port["skip"] = first
    inputs["soup/skip"] = first.numpy().astype(np.uint32)
    scene, roots, org, d = _roots_case()
    port["roots"] = (scene, roots, org, d)
    inputs.update({"roots/nodes": scene.nodes, "roots/soup": scene.soup,
                   "roots/n": np.asarray([scene.num_nodes, scene.num_prims]),
                   "roots/root": roots, "roots/org": org, "roots/dir": d})
    return port, run_without_fma(__file__, inputs)


def _assert_match(got, ref, name):
    want = {k: ref[f"{name}/{k}"] for k in FIELDS}
    np.testing.assert_array_equal(got.count.numpy(), want["count"])
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  want["prim_id"].astype(np.int64))
    valid = got.prim_id.numpy() != nt.INVALID_PRIM_ID
    assert int(ulp_distance(got.t.numpy()[valid], want["t"][valid]).max(
        initial=0)) <= 4
    np.testing.assert_array_equal(got.t.numpy()[~valid], want["t"][~valid])
    for k in ("u", "v"):
        assert np.abs(getattr(got, k).numpy() - want[k]).max() <= 1e-6


@pytest.mark.parametrize("kind", ["sphere", "soup"])
@pytest.mark.parametrize("engine", ["brute", "stack", "wavefront"])
def test_multi_hit_matches_jax(case, kind, engine):
    port, ref = case
    bvh, mesh, packed = port[kind]
    rays = _port_rays()
    if engine == "brute":
        got = mh.brute_force_multi_hit(mesh, rays, 8)
    elif engine == "stack":
        got = mh.multi_hit_traverse(bvh, mesh, rays, 8)
    else:
        got = mh.multi_hit_wavefront(packed, rays, 8, tile=128)
    _assert_match(got, ref, f"{kind}/{engine}")
    assert int(got.count.max()) >= 2 and got.t.shape == (333, 8)
    # every engine gives the oracle's lists
    _assert_match(mh.brute_force_multi_hit(mesh, rays, 8), ref,
                  f"{kind}/{engine}")


@pytest.mark.parametrize("K", [1, 4, 16])
def test_multi_hit_k_truncates(case, K):
    port, ref = case
    bvh, mesh, _ = port["sphere"]
    rays = _port_rays()
    got = mh.multi_hit_traverse(bvh, mesh, rays, K)
    _assert_match(got, ref, f"sphere/stack{K}")
    eight = mh.multi_hit_traverse(bvh, mesh, rays, 8)
    k = min(K, 8)
    assert torch.equal(got.prim_id[:, :k], eight.prim_id[:, :k])
    assert torch.equal(got.count, eight.count.clamp(max=K))
    t = got.t
    assert bool((t.diff(dim=1) >= 0).all())  # ascending, empties last
    if K == 1:
        single = nt.traverse_triangles(bvh, mesh, rays)
        assert torch.equal(got.t[:, 0][single.hit], single.t[single.hit])
        assert torch.equal(got.hit, single.hit)


@pytest.mark.parametrize("what", ["brute_filtered", "stack_filtered",
                                  "stack_skip"])
def test_multi_hit_filters(case, what):
    port, ref = case
    bvh, mesh, _ = port["soup"]
    rays = _port_rays()
    if what == "stack_skip":
        got = mh.multi_hit_traverse(bvh, mesh, rays, 6,
                                    skip_prim_id=port["skip"])
        skip = port["skip"][0::2]
        had = skip != nt.INVALID_PRIM_ID  # the rays that hit something
        assert int(had.sum()) > 20
        assert not bool((got.prim_id[0::2][had] == skip[had, None]).any())
    else:
        opt = nt.BVHTraceOptions(**FILTER)
        fn = mh.brute_force_multi_hit if what.startswith("brute") else \
            (lambda m, r, k, o: mh.multi_hit_traverse(bvh, m, r, k, o))
        got = fn(mesh, rays, 6, opt)
        pid = got.prim_id[got.prim_id != nt.INVALID_PRIM_ID]
        assert bool(((pid >= 50) & (pid < 400)).all())
    _assert_match(got, ref, f"soup/{what}")


def test_multi_hit_wavefront_multi_mesh_roots(case):
    port, ref = case
    scene, roots, org, d = port["roots"]
    got = mh.multi_hit_wavefront(
        scene, nt.make_rays(torch.from_numpy(org), torch.from_numpy(d)), 4,
        root=torch.from_numpy(roots), tile=8)
    _assert_match(got, ref, "roots")
    assert got.count.tolist() == [1, 1, 1]  # each ray sees its own mesh
    np.testing.assert_allclose(got.t[:, 0].numpy(), [5.0, 2.0, 3.5])


def test_multi_hit_keeps_batch_shape_and_float64(case):
    port, _ = case
    bvh, mesh, _ = port["sphere"]
    org, d = _rays(12)
    rays = nt.make_rays(torch.from_numpy(org).reshape(3, 4, 3),
                        torch.from_numpy(d).reshape(3, 4, 3))
    got = mh.multi_hit_traverse(bvh, mesh, rays, 5)
    assert got.t.shape == (3, 4, 5) and got.count.shape == (3, 4)
    flat = mh.multi_hit_traverse(bvh, mesh, nt.make_rays(
        torch.from_numpy(org), torch.from_numpy(d)), 5)
    assert torch.equal(got.prim_id.reshape(12, 5), flat.prim_id)
    m64 = TriangleMesh(mesh.vertices.double(), mesh.faces)
    r64 = nt.make_rays(torch.from_numpy(org).double(),
                       torch.from_numpy(d).double())
    h64 = mh.multi_hit_traverse(bvh, m64, r64, 5)
    assert h64.t.dtype == torch.float64
    assert torch.equal(h64.count, flat.count)


def test_root_exports():
    assert nt.multi_hit_traverse is mh.multi_hit_traverse
    assert nt.MultiHits is mh.MultiHits


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
