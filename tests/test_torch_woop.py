"""PyTorch port, the Woop leaf test (K1-woop).

- Host tables: ``build/bvh8.py``'s ``collapse_bvh8(woop=True)`` against
  the JAX package's, at leaf sizes 4 and 9 and widths 8 and 16, and on a
  degenerate triangle: bit-identical arrays. Each prim's transform
  lanes also equal those of the JAX package's ``build_woop_leafs``
  (its one-row-per-binary-leaf layout) bit for bit.
- ``traverse_bvh8(intersector="woop")``, on the CPU its plain version,
  on the 970-triangle cornell box + UV sphere world of
  test_torch_packet.py (leaf 9), closest-hit and any-hit, held to three
  references:
  1. the JAX package's watertight ``brute_force_traverse`` (op by op).
     Woop and watertight may legally disagree within an ulp of an edge,
     so rays whose hit, in either record, lies within 1e-5 of an edge
     in barycentrics are left out (none of these 1,500 rays is; at most
     1% may be). On the rest: the same hit mask; the same prim except at
     equal t; t within a relative 1e-5 (measured 1.3e-6) and u/v within
     1e-4 (measured 5.8e-5). The skip, range and cull filters are held to
     the same reference with the same filter.
  2. a float64 NumPy evaluation of the Woop transform on the same
     table rows, as tests/test_bvh8.py does: every reported hit is the
     Woop hit of that ray and that row slot, t within a relative 1e-5
     (measured 1.8e-7) and u/v within 1e-4 (measured 4.3e-5 on the
     any-hit records, which include grazing far hits).
  3. any-hit: the same hit mask as closest-hit, and each reported hit a
     genuine Woop hit no nearer than the closest.

The CUDA kernel is held to this plain version bit for bit on the card by
test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build import bvh8 as j_bvh8
from nanort_tpu.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch import interop
from nanort_tpu_torch.build import bvh8 as t_bvh8
from nanort_tpu_torch.testing import compare_hits
from nanort_tpu_torch.traverse import packet

torch.set_num_threads(1)

EDGE = 1e-5  # barycentric distance to an edge inside which rays are left out
T_REL = 1e-5
UV_TOL = 1e-4


def _bvh(v, f, leaf):
    mesh = jrt.TriangleMesh(vertices=jax.numpy.asarray(v),
                            faces=jax.numpy.asarray(f))
    bvh, _ = jrt.build_triangle_bvh(mesh, jrt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    return bvh


def _world_mesh():
    return merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("leaf", [4, 9])
def test_woop_tables_match_jax(leaf, width):
    v, f = _world_mesh()
    jbvh = _bvh(v, f, leaf)
    want = j_bvh8.collapse_bvh8(jbvh, v, f, width=width, woop=True)
    got = t_bvh8.collapse_bvh8(
        interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh)), v, f,
        width=width, woop=True)
    for k in ("nodes", "leafs", "leafs_woop"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert (got.num_nodes, got.num_leaf_rows, got.depth, got.max_leaf) == (
        want.num_nodes, want.num_leaf_rows, want.depth, want.max_leaf)
    # rows pair one to one: the same prims in the same slots
    cnt = got.max_leaf
    assert np.array_equal(got.leafs[:, 90:90 + cnt],
                          got.leafs_woop[:, 108:108 + cnt])
    plain = t_bvh8.collapse_bvh8(
        interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh)), v, f,
        width=width)
    assert plain.leafs_woop is None
    assert plain.leafs.tobytes() == got.leafs.tobytes()


def _woop_slots(rows, cnt):
    """{prim id: its 12 transform lanes} of a Woop table (empty slots,
    zero matrix and zero anchor, left out)."""
    out = {}
    for r in range(rows.shape[0]):
        for s in range(cnt):
            lanes = rows[r, 12 * s:12 * s + 12]
            if lanes.any():
                out[int(rows[r, 108 + s])] = lanes.tobytes()
    return out


@pytest.mark.parametrize("leaf", [4, 9])
def test_woop_rows_match_jax_build_woop_leafs(leaf):
    v, f = _world_mesh()
    jbvh = _bvh(v, f, leaf)
    want = _woop_slots(np.asarray(j_bvh8.build_woop_leafs(jbvh, v, f)), 9)
    got = t_bvh8.collapse_bvh8(
        interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh)), v, f,
        width=16, woop=True)
    assert got.leafs_woop.dtype == np.float32
    assert _woop_slots(got.leafs_woop, got.max_leaf) == want
    assert len(want) == len(f)


def test_woop_rows_refuse_ten_triangles():
    v, f = _world_mesh()
    bvh = interop.bvh_from_numpy(*(np.asarray(x) for x in _bvh(v, f, 10)))
    for width in (8, 16):
        with pytest.raises(ValueError, match="9"):
            t_bvh8.collapse_bvh8(bvh, v, f, width=width, woop=True)


def test_woop_degenerate_triangle_never_hits():
    v = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0],  # collinear: zero area
                  [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    f = np.array([[0, 1, 2], [3, 4, 5]], np.int64)
    jbvh = _bvh(v, f, 2)
    bvh = interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh))
    host = t_bvh8.collapse_bvh8(bvh, v, f, width=16, woop=True)
    want = j_bvh8.collapse_bvh8(jbvh, v, f, width=16, woop=True)
    rows = host.leafs_woop
    assert rows.tobytes() == np.asarray(want.leafs_woop).tobytes()
    # the degenerate triangle gets the zero matrix (d'z == 0 for every
    # ray), its anchor p0 is still written
    slot = int(np.nonzero(rows[0, 108:108 + host.max_leaf] == 0)[0][0])
    np.testing.assert_array_equal(rows[0, 12 * slot:12 * slot + 9], 0.0)
    np.testing.assert_array_equal(rows[0, 12 * slot + 9:12 * slot + 12],
                                  v[0])
    # rays through the segment from every side: the degenerate triangle
    # (prim 0) is never hit; rays at the other triangle still hit it
    scene = host.to("cpu")
    rng = np.random.default_rng(1)
    n = 256
    tgt = np.zeros((n, 3), np.float32)
    tgt[:, 0] = rng.uniform(0.0, 2.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = tgt - 2.0 * d
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    for occ in (False, True):
        got = packet.traverse_bvh8(scene, rays, occlusion=occ,
                                   intersector="woop")
        assert not (got.prim_id == 0).any()
    org2 = np.array([[0.2, 0.2, 3.0]], np.float32)
    d2 = np.array([[0.0, 0.0, -1.0]], np.float32)
    hit = packet.traverse_bvh8(
        scene, nt.make_rays(torch.from_numpy(org2), torch.from_numpy(d2)),
        intersector="woop")
    assert hit.prim_id.tolist() == [1] and abs(float(hit.t[0]) - 2.0) < 1e-6


@pytest.fixture(scope="module")
def world():
    v, f = _world_mesh()
    jmesh = jrt.TriangleMesh(vertices=jax.numpy.asarray(v),
                             faces=jax.numpy.asarray(f))
    jbvh = _bvh(v, f, 9)
    bvh = interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh))
    scenes = {w: t_bvh8.collapse_bvh8(bvh, v, f, width=w, woop=True).to("cpu")
              for w in (8, 16)}
    rng = np.random.default_rng(5)
    n = 1500
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jrays = jrt.make_rays(org, d)
    trays = interop.rays_from_numpy(*(np.asarray(x) for x in jrays),
                                    device="cpu")
    return dict(v=v, f=f, jmesh=jmesh, scenes=scenes, jrays=jrays,
                trays=trays, org=org, d=d)


def _jax_brute(world, jopts, skip=None):
    with jax.disable_jit():
        h = jrt.brute_force_traverse(
            world["jmesh"], world["jrays"], jopts,
            skip_prim_id=None if skip is None else jax.numpy.asarray(skip))
    return jrt.Hits(*(np.asarray(x) for x in h))


def _near_edge(h):
    u, v = np.asarray(h.u), np.asarray(h.v)
    hit = np.asarray(h.prim_id) != jrt.INVALID_PRIM_ID
    return hit & (np.minimum(np.minimum(u, v), 1.0 - u - v) < EDGE)


FILTERS = {
    "closest": dict(),
    "skip": dict(skip=True),
    "range": dict(prim_ids_range=(100, 900)),
    "cull": dict(cull_back_face=True),
}


@pytest.mark.parametrize("mode", list(FILTERS))
@pytest.mark.parametrize("width", [8, 16])
def test_woop_matches_watertight_away_from_edges(world, width, mode):
    kw = dict(FILTERS[mode])
    skip = None
    if kw.pop("skip", False):
        first = _jax_brute(world, jrt.BVHTraceOptions())
        skip = first.prim_id
    want = _jax_brute(world, jrt.BVHTraceOptions(**kw), skip)
    got = packet.traverse_bvh8(
        world["scenes"][width], world["trays"], nt.BVHTraceOptions(**kw),
        skip_prim_id=None if skip is None else torch.from_numpy(
            skip.astype(np.int64)), intersector="woop")
    keep = ~(_near_edge(got) | _near_edge(want))
    assert keep.mean() > 0.99, keep.mean()
    sub = lambda h: jrt.Hits(*(np.asarray(x)[keep] for x in h))
    c = compare_hits(sub(got), sub(want), t_ulps=2**31, uv_atol=1.0)
    assert c["hit_mismatch"] == 0 and c["prim_mismatch"] == 0, c
    assert c["uv_max_err"] <= UV_TOL, c
    assert c["hits"] > 400, c
    g, w = sub(got), sub(want)
    both = (g.prim_id != jrt.INVALID_PRIM_ID) & (w.prim_id != jrt.INVALID_PRIM_ID)
    rel = np.abs(g.t[both] - w.t[both]) / w.t[both]
    assert rel.max() <= T_REL, rel.max()
    p = got.prim_id.numpy()[got.hit.numpy()]
    if mode == "skip":
        assert (p != skip[got.hit.numpy()]).all()
    if mode == "range":
        assert ((p >= 100) & (p < 900)).all()


def _woop64(scene, pid, org, d):
    """(t, u, v) of each ray against prim ``pid``'s Woop row slot, in
    float64."""
    lw = scene.leafs_woop.numpy()
    cnt = scene.max_leaf
    slot_of = {}
    for r in range(scene.num_leaf_rows):
        for s in range(cnt):
            p = int(lw[r, 108 + s])
            if np.any(lw[r, 12 * s:12 * s + 9]):
                slot_of[p] = (r, s)
    out = np.zeros((pid.shape[0], 3))
    for i, p in enumerate(pid):
        r, s = slot_of[int(p)]
        m = lw[r, 12 * s:12 * s + 9].astype(np.float64).reshape(3, 3)
        p0 = lw[r, 12 * s + 9:12 * s + 12].astype(np.float64)
        op = m @ (org[i].astype(np.float64) - p0)
        dp = m @ d[i].astype(np.float64)
        t = -op[2] / dp[2]
        out[i] = (t, op[0] + t * dp[0], op[1] + t * dp[1])
    return out


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_woop_hits_are_float64_woop_hits(world, width, occlusion):
    scene = world["scenes"][width]
    got = packet.traverse_bvh8(scene, world["trays"], occlusion=occlusion,
                               intersector="woop")
    h = got.hit.numpy()
    ref = _woop64(scene, got.prim_id.numpy()[h], world["org"][h],
                  world["d"][h])
    t, u, v = (x.numpy()[h] for x in (got.t, got.u, got.v))
    assert (np.abs(t - ref[:, 0]) <= T_REL * np.abs(ref[:, 0])).all()
    assert np.abs(u - ref[:, 1]).max() <= UV_TOL
    assert np.abs(v - ref[:, 2]).max() <= UV_TOL
    assert (ref[:, 1] >= -1e-6).all() and (ref[:, 2] >= -1e-6).all()
    assert (ref[:, 1] + ref[:, 2] <= 1 + 1e-6).all()
    closest = packet.traverse_bvh8(scene, world["trays"], intersector="woop")
    assert np.array_equal(h, closest.hit.numpy())
    if occlusion:
        assert (t >= closest.t.numpy()[h]).all()
        miss = ~h
        assert (got.t.numpy()[miss] == world["trays"].max_t.numpy()[miss]).all()
    else:
        assert h.sum() > 1000


def test_woop_options_and_validation(world):
    s = world["scenes"][16]
    r = world["trays"]
    a = packet.traverse_bvh8(s, r, intersector="woop")
    # no edge functions: the exact-edge option changes nothing
    b = packet.traverse_bvh8(s, r, nt.BVHTraceOptions(exact_edge_fallback=False),
                             intersector="woop")
    c = packet.traverse_bvh8(s, r, specialize=(1, True), intersector="woop")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    with pytest.raises(ValueError, match="intersector"):
        packet.traverse_bvh8(s, r, intersector="mt")
    with pytest.raises(ValueError, match="Woop leaf table"):
        packet.traverse_bvh8(s._replace(leafs_woop=None), r,
                             intersector="woop")
    with pytest.raises(ValueError, match="9 triangles"):
        packet.traverse_bvh8(s._replace(max_leaf=10), r, intersector="woop")
    # the watertight records ignore the Woop table
    w = packet.traverse_bvh8(s, r)
    w2 = packet.traverse_bvh8(s._replace(leafs_woop=None), r)
    for x, y in zip(w, w2):
        assert torch.equal(x, y)


def test_dead_rays_retire_and_miss(world):
    s = world["scenes"][16]
    r = world["trays"]
    dead = nt.Rays(r.org, r.dir, torch.full_like(r.min_t, 2.0),
                   torch.where(torch.arange(r.max_t.shape[0]) % 2 == 0,
                               1.0, float("nan")))
    for inter in packet.INTERSECTORS:
        for occ in (False, True):
            h = packet.traverse_bvh8(s, dead, occlusion=occ,
                                     intersector=inter)
            assert not h.hit.any()
            assert torch.equal(h.t.isnan(), dead.max_t.isnan())
