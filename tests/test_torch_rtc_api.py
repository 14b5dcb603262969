"""PyTorch port, the Embree-style API (``api/rtc.py``, ``api/embree3.py``)
against the JAX package on the same seeded inputs.

The JAX side runs in a child process held to AVX
(``testing.run_without_fma``). Its fast route runs with
``pallas_packet.traverse_bvh8`` replaced by
``test_treelet._fake_traverse_bvh8`` (a float64 Moller-Trumbore walk of
the BVH8 tables), as ``test_rtc_api.py`` does; the port's fast route
runs K1's plain version on the CPU (``commit(fast=True)``). The scene: a
ring of six transformed spheres of one mesh and a two-triangle wall,
under the free-listed geometry ids 0, 1, 3, 4, 5 and 6. Tolerances:
- the fast route's tables: the BVH8 nodes and leaf rows, the world-space
  mesh and the remap offsets and geometry ids bit-identical;
- fast route, port against JAX: the JAX fake tests triangles in float64
  Moller-Trumbore, the port in float32 watertight, so they may part at
  an edge: at least 99% of hit masks equal, geometry and local prim ids
  equal on at least 99% of the rays both hit, t within a relative 1e-5
  there (measured on these 512 rays, 195 hits: all masks and ids
  equal; relative t error 2.1e-7);
- the graph route (``commit(fast=False)``), ``rtc`` and ``embree3``:
  every record field bit-identical to the JAX package's jitted walk;
- fast route against the graph route in the port (transforms baked at
  commit against the instance walk, rtc.py's documented ulp-level
  differences): the share of rays whose hit masks differ at most 1%,
  ids equal where both hit except at most 1% of rays, relative t error
  at most 1e-5 (measured on these 512 rays: no mask differs, ids all
  equal, relative t error 3.6e-7);
- ``occluded`` equals ``intersect(...).hit`` on the fast route (any-hit
  mode), and the graph walk's hit mask on the graph route.
"""

import inspect
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch import make_rays
from nanort_tpu_torch.api import embree3, rtc
from nanort_tpu_torch.io.procedural import make_uv_sphere
from nanort_tpu_torch.scene import matrix as mat
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)

N_RAYS = 512
WALL_V = np.array([[-3, -3, -4], [3, -3, -4], [0, 3, -4], [3, 3, -4]],
                  np.float32)
WALL_F = np.array([[0, 1, 2], [1, 3, 2]], np.int32)


def _ring_xf(k):
    a = 2.0 * np.pi * k / 6
    return mat.compose(mat.translate([2.0 * np.cos(a), 0.3 * k - 0.8,
                                      2.0 * np.sin(a)]),
                       mat.rotate([0.2, 1.0, 0.1], 0.5 * k),
                       mat.scale([1.0, 1.0 + 0.1 * k, 0.8]))


def _fill(scene, buffer_type):
    """Six ring spheres and a wall, with the free list exercised: ids 2
    and 4 are deleted and 4 is reused, leaving ids 0, 1, 3, 4, 5 and 6
    (the wall)."""
    sv, sf = make_uv_sphere(10, 20, 0.6)

    def add(v, f, xf=None):
        g = scene.new_triangle_mesh(len(f), len(v))
        scene.map_buffer(g, buffer_type.VERTEX)[:] = v
        scene.map_buffer(g, buffer_type.INDEX)[:] = f
        if xf is not None:
            scene.set_transform(g, xf)
        return g

    gids = [add(sv, sf, _ring_xf(k)) for k in range(6)]
    assert add(WALL_V, WALL_F) == 6
    scene.delete_geometry(gids[2])
    scene.delete_geometry(gids[4])
    assert add(sv, sf, _ring_xf(2)) == 4  # the last freed id comes first
    return sv, sf


def _rays(seed=7):
    rng = np.random.default_rng(seed)
    org = np.zeros((N_RAYS, 3), np.float32)
    org[:, 2] = 6.0
    org[:, :2] = rng.uniform(-0.5, 0.5, (N_RAYS, 2))
    tgt = rng.uniform(-3.0, 3.0, (N_RAYS, 3)) * [1, 1, 0.5]
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


FIELDS = ("t", "u", "v", "prim_id", "node_id", "position", "normal_g",
          "normal_s")


@pytest.fixture(scope="module")
def jax_side():
    org, d = _rays()
    return run_without_fma(__file__, {"org": org, "dir": d}, timeout=900)


def _port(fast):
    dev = rtc.new_device(device="cpu")
    sc = dev.new_scene()
    _fill(sc, rtc.BufferType)
    sc.commit(fast=fast)
    org, d = _rays()
    return sc, make_rays(torch.from_numpy(org), torch.from_numpy(d))


def test_fast_tables_match_jax(jax_side):
    sc, _ = _port(True)
    assert sc._scene8 is not None
    np.testing.assert_array_equal(sc._scene8.nodes.numpy(), jax_side["nodes"])
    np.testing.assert_array_equal(sc._scene8.leafs.numpy(), jax_side["leafs"])
    for i, k in enumerate(("flat_v", "flat_f", "offs", "gids")):
        np.testing.assert_array_equal(sc._flat_pack[i].numpy(),
                                      jax_side[k], err_msg=k)


def test_fast_intersect_matches_jax(jax_side):
    sc, rays = _port(True)
    got = sc.intersect(rays)
    hit = got.hit.numpy()
    want_hit = jax_side["fast/node_id"] != 0xFFFFFFFF
    assert hit.any() and (~hit).any()
    assert (hit == want_hit).mean() >= 0.99
    both = hit & want_hit
    same_ids = ((got.node_id.numpy() == jax_side["fast/node_id"])
                & (got.prim_id.numpy() == jax_side["fast/prim_id"]))[both]
    assert same_ids.mean() >= 0.99
    t, wt = got.t.numpy()[both], jax_side["fast/t"][both]
    assert (np.abs(t - wt) <= 1e-5 * np.abs(wt)).all()
    # misses carry the JAX package's miss values
    assert (got.prim_id.numpy()[~hit] == 0xFFFFFFFF).all()
    assert (got.position.numpy()[~hit] == 0).all()


def test_fast_remap_is_local():
    """Each fast-route hit names a triangle of its geometry by local id:
    the world-space triangle it names contains the hit point."""
    sc, rays = _port(True)
    h = sc.intersect(rays)
    m = h.hit
    assert set(h.node_id[m].tolist()) == {0, 1, 3, 4, 5, 6}
    for gid, local, p in zip(h.node_id[m].tolist(), h.prim_id[m].tolist(),
                             h.position[m]):
        g = sc._geoms[gid]
        assert local < len(g.indices)
        x = g.xform
        tri = g.vertices[g.indices[local]].astype(np.float64) @ x[:3, :3].T \
            + x[:3, 3]
        lo, hi = tri.min(0) - 1e-4, tri.max(0) + 1e-4
        assert ((p.numpy() >= lo) & (p.numpy() <= hi)).all(), (gid, local)


@pytest.mark.parametrize("api", ["rtc", "embree3"])
def test_graph_route_matches_jax(jax_side, api):
    sc, rays = _port(False)
    assert sc._scene8 is None
    if api == "rtc":
        got = sc.intersect(rays)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          jax_side[f"slow/{k}"], err_msg=k)
        np.testing.assert_array_equal(sc.occluded(rays).numpy(),
                                      jax_side["slow/occluded"])
        lo, hi = sc.bounds()
        np.testing.assert_array_equal(lo, jax_side["bounds_lo"])
        np.testing.assert_array_equal(hi, jax_side["bounds_hi"])
    else:
        got = embree3.rtc_intersect1(sc, rays)
        for k in embree3.RTCRayHit._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          jax_side[f"e3/{k}"], err_msg=k)
        np.testing.assert_array_equal(embree3.rtc_occluded1(sc, rays).numpy(),
                                      jax_side["e3/occluded"])


def test_fast_route_against_graph_route():
    fast, rays = _port(True)
    slow, _ = _port(False)
    a, b = fast.intersect(rays), slow.intersect(rays)
    ha, hb = a.hit, b.hit
    assert ha.any()
    assert (ha != hb).float().mean() <= 0.01
    both = ha & hb
    ids = (a.node_id == b.node_id) & (a.prim_id == b.prim_id)
    assert (~ids[both]).float().mean() <= 0.01
    rel = ((a.t - b.t).abs() / b.t.abs())[both]
    assert float(rel.max()) <= 1e-5
    assert torch.equal(fast.occluded(rays), ha)
    assert torch.equal(slow.occluded(rays), hb)


def test_embree3_call_sequence_and_errors():
    dev = embree3.rtc_new_device(device="cpu")
    scene = embree3.rtc_new_scene(dev)
    geom = embree3.rtc_new_geometry(dev, embree3.GeometryType.TRIANGLE)
    with pytest.raises(ValueError):
        embree3.rtc_commit_geometry(geom)
    embree3.rtc_set_new_geometry_buffer(geom, embree3.BufferType3.VERTEX,
                                        4)[:] = WALL_V
    embree3.rtc_set_new_geometry_buffer(geom, embree3.BufferType3.INDEX,
                                        2)[:] = WALL_F
    with pytest.raises(ValueError):
        embree3.rtc_attach_geometry(scene, geom)
    embree3.rtc_commit_geometry(geom)
    gid = embree3.rtc_attach_geometry(scene, geom)
    embree3.rtc_release_geometry(geom)
    with pytest.raises(RuntimeError):
        embree3.rtc_intersect1(scene, make_rays(torch.zeros(1, 3),
                                                torch.tensor([[0, 0, -1.0]])))
    embree3.rtc_commit_scene(scene)
    rays = make_rays(torch.tensor([[0.0, 0, 0], [9.0, 9, 0]]),
                     torch.tensor([[0, 0, -1.0], [0, 0, -1.0]]))
    rh = embree3.rtc_intersect1(scene, rays)
    assert rh.hit.tolist() == [True, False] and int(rh.geom_id[0]) == gid
    assert float(rh.tfar[0]) == 4.0 and rh.tfar[1] == rays.max_t[1]
    occ = embree3.rtc_occluded1(scene, rays)
    assert occ[0] == float("-inf") and occ[1] == rays.max_t[1]
    with pytest.raises(ValueError):
        embree3.rtc_new_geometry(dev, "quad")


def test_rtc_errors_and_defaults():
    dev = rtc.new_device(device="cpu")
    with pytest.raises(ValueError):
        dev.new_scene().commit()
    sc = dev.new_scene()
    _fill(sc, rtc.BufferType)
    with pytest.raises(RuntimeError):
        sc.intersect(make_rays(torch.zeros(1, 3), torch.ones(1, 3)))
    sc.commit()  # fast=None: fast only on the card
    assert sc._scene8 is None
    sc.map_buffer(0, rtc.BufferType.VERTEX)
    with pytest.raises(RuntimeError):  # a mapped buffer needs a commit
        sc.occluded(make_rays(torch.zeros(1, 3), torch.ones(1, 3)))
    for fn in (rtc.new_device, embree3.rtc_new_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert rtc.FAST_MAX_TRIS == 1 << 24


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from test_treelet import _fake_traverse_bvh8

    from nanort_tpu.api import embree3 as je3
    from nanort_tpu.api import rtc as jrtc
    from nanort_tpu.core.ray import make_rays as jmake_rays
    from nanort_tpu.traverse import pallas_packet

    z = dict(np.load(inp))
    rays = jmake_rays(jnp.asarray(z["org"]), jnp.asarray(z["dir"]))
    res = {}
    for fast in (False, True):
        sc = jrtc.new_device().new_scene()
        _fill(sc, jrtc.BufferType)
        sc.commit(fast=fast)
        if fast:
            pallas_packet.traverse_bvh8 = _fake_traverse_bvh8
            h = sc.intersect(rays)
            for k in FIELDS:
                res[f"fast/{k}"] = np.asarray(getattr(h, k))
            res["nodes"] = np.asarray(sc._scene8.nodes)
            res["leafs"] = np.asarray(sc._scene8.leafs)
            for k, x in zip(("flat_v", "flat_f", "offs", "gids"),
                            sc._flat_pack):
                res[k] = np.asarray(x)
            continue
        h = sc.intersect(rays)
        for k in FIELDS:
            res[f"slow/{k}"] = np.asarray(getattr(h, k))
        res["slow/occluded"] = np.asarray(sc.occluded(rays))
        res["bounds_lo"], res["bounds_hi"] = sc.bounds()
        rh = je3.rtc_intersect1(sc, rays)
        for k in je3.RTCRayHit._fields:
            res[f"e3/{k}"] = np.asarray(getattr(rh, k))
        res["e3/occluded"] = np.asarray(je3.rtc_occluded1(sc, rays))
    for k in list(res):
        if res[k].dtype in (np.uint32, np.int32):
            res[k] = res[k].astype(np.int64)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
