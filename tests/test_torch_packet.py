"""PyTorch port, traverse/packet.py: ``traverse_bvh8`` (on the CPU, its
plain torch version) against the JAX package on a cornell box + UV
sphere (970 tris), widths 8 and 16, over one identical BVH16/BVH8 table
set and one identical ray batch.

The JAX side is what tools/verify_pallas.py uses: ``brute_force_traverse``
and ``traverse_triangles`` over the same binary BVH (the Pallas kernel
itself is impractically slow in interpret mode). They run op by op
(``jax.disable_jit``): jitted, XLA's CPU backend fuses the edge
functions and contracts ``a*b - c*d`` into FMAs, which moves t by up to
8 ulp and u/v by up to 4e-6 on these rays; the port never contracts
(nor does its kernel, built with ``--fmad=false``). Tolerance
(``nanort_tpu_torch.testing.compare_hits``): the same hit mask; the same
prim id except at bit-equal t; t within 4 ulp; u/v within 2e-6.

The CUDA kernel is held to this plain version on the card by
test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build.bvh8 import collapse_bvh8 as j_collapse
from nanort_tpu.models import cameras as j_cams
from nanort_tpu.ops.triangle import intersect_triangles as j_intersect
from nanort_tpu.ops.triangle import ray_coeffs as j_coeffs
from nanort_tpu.traverse import pallas_packet as jp
from nanort_tpu.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch import interop
from nanort_tpu_torch.testing import compare_hits, ulp_distance
from nanort_tpu_torch.traverse import packet

torch.set_num_threads(1)

LEAF = 9


def _np_hits(h):
    return jrt.Hits(*(np.asarray(x) for x in h))


def _jax_brute(*args, **kw):
    with jax.disable_jit():
        return _np_hits(jrt.brute_force_traverse(*args, **kw))


@pytest.fixture(scope="module")
def world():
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    jmesh = jrt.TriangleMesh(vertices=jax.numpy.asarray(v),
                             faces=jax.numpy.asarray(f))
    opts = jrt.BVHBuildOptions(min_leaf_primitives=LEAF,
                               max_leaf_primitives=LEAF)
    jbvh, _ = jrt.build_triangle_bvh(jmesh, opts)
    scenes = {}
    for w in (8, 16):
        s = j_collapse(jbvh, v, f, width=w)
        scenes[w] = interop.scene_from_numpy(
            np.asarray(s.nodes), np.asarray(s.leafs), s.num_nodes,
            s.num_leaf_rows, s.depth, s.max_leaf, s.width)
    rng = np.random.default_rng(5)
    n = 1500
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jrays = jrt.make_rays(org, d)
    trays = interop.rays_from_numpy(*(np.asarray(x) for x in jrays))
    want = _jax_brute(jmesh, jrays)
    return dict(v=v, f=f, jmesh=jmesh, jbvh=jbvh, scenes=scenes, jrays=jrays,
                trays=trays, want=want)


def _check(got, want):
    c = compare_hits(got, want)
    assert c["ok"], c
    return c


@pytest.mark.parametrize("width", [8, 16])
def test_closest_hit_matches_jax(world, width):
    got = packet.traverse_bvh8(world["scenes"][width], world["trays"])
    c = _check(got, world["want"])
    assert c["hits"] > 1000
    with jax.disable_jit():
        stack = _np_hits(jrt.traverse_triangles(
            world["jbvh"], world["jmesh"], world["jrays"], max_leaf=LEAF))
    _check(got, stack)


MODES = {
    "skip": lambda w: (jrt.BVHTraceOptions(), w["want"].prim_id),
    "cull": lambda w: (jrt.BVHTraceOptions(cull_back_face=True), None),
    "range": lambda w: (jrt.BVHTraceOptions(prim_ids_range=(100, 900)), None),
    "no_exact_edges": lambda w: (
        jrt.BVHTraceOptions(exact_edge_fallback=False), None),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("width", [8, 16])
def test_filters_match_jax(world, width, mode):
    jopts, skip = MODES[mode](world)
    topts = nt.BVHTraceOptions(**{
        k: getattr(jopts, k) for k in ("prim_ids_range", "skip_prim_id",
                                       "cull_back_face", "exact_edge_fallback")})
    tskip = None if skip is None else torch.from_numpy(skip.astype(np.int64))
    got = packet.traverse_bvh8(world["scenes"][width], world["trays"], topts,
                               skip_prim_id=tskip)
    want = _jax_brute(world["jmesh"], world["jrays"], jopts,
                      skip_prim_id=None if skip is None else jax.numpy.asarray(skip))
    _check(got, want)
    if mode == "skip":
        h = got.hit.numpy()
        assert (got.prim_id.numpy()[h] != skip[h]).all()
    if mode == "range":
        p = got.prim_id.numpy()[got.hit.numpy()]
        assert ((p >= 100) & (p < 900)).all()


@pytest.mark.parametrize("width", [8, 16])
def test_any_hit_reports_a_genuine_hit(world, width):
    got = packet.traverse_bvh8(world["scenes"][width], world["trays"],
                               occlusion=True)
    want = world["want"]
    h = got.hit.numpy()
    assert np.array_equal(h, want.prim_id != jrt.INVALID_PRIM_ID)
    # the reported (t, prim) is that ray's real intersection with that
    # triangle, per the JAX intersector, and never nearer than the closest
    org = np.asarray(world["jrays"].org)[h]
    d = np.asarray(world["jrays"].dir)[h]
    tri = world["v"][world["f"][got.prim_id.numpy()[h]]]
    co = j_coeffs(jax.numpy.asarray(d))
    ok, tt, _, _ = j_intersect(co, jax.numpy.asarray(org),
                               jax.numpy.zeros(org.shape[0], jax.numpy.float32),
                               jax.numpy.full(org.shape[0], 1e30, jax.numpy.float32),
                               *(jax.numpy.asarray(tri[:, k]) for k in range(3)))
    assert np.asarray(ok).all()
    assert ulp_distance(np.asarray(tt), got.t.numpy()[h]).max() <= 4
    assert (got.t.numpy()[h] >= want.t[h]).all()
    miss = ~h
    assert (got.t.numpy()[miss] == world["trays"].max_t.numpy()[miss]).all()


def _degenerate(world):
    org = world["trays"].org.numpy().copy()
    d = world["trays"].dir.numpy().copy()
    org[0::10, 0] = np.nan
    d[2::10] = 0.0
    d[4::10, 1] = np.inf
    d[6::10, 2] = -3.1e38
    org[8::10, 2] = 3.2e38
    bad = np.zeros(org.shape[0], bool)
    for k in (0, 2, 4, 6, 8):
        bad[k::10] = True
    return org, d, bad


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_degenerate_rays_miss(world, width, occlusion):
    org, d, bad = _degenerate(world)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    got = packet.traverse_bvh8(world["scenes"][width], rays,
                               occlusion=occlusion)
    assert not got.hit.numpy()[bad].any()
    t_bad = got.t.numpy()[bad]
    if occlusion:  # misses report max_t, as the JAX decode does
        assert (t_bad == rays.max_t.numpy()[bad]).all()
    else:  # sanitized in-kernel: t = +inf
        assert np.isposinf(t_bad).all()
    good = ~bad
    want = world["want"]
    sub = nt.Hits(*(x[torch.from_numpy(good)] for x in got))
    if occlusion:
        assert np.array_equal(sub.hit.numpy(),
                              want.prim_id[good] != jrt.INVALID_PRIM_ID)
    else:
        _check(sub, jrt.Hits(*(x[good] for x in want)))


@pytest.mark.parametrize("n", [1, 127, 1237])
def test_odd_ray_counts(world, n):
    rays = nt.Rays(*(x[:n] for x in world["trays"]))
    got = packet.traverse_bvh8(world["scenes"][16], rays)
    assert got.t.shape == (n,)
    _check(got, jrt.Hits(*(x[:n] for x in world["want"])))


def test_batch_shape_is_kept(world):
    rays = nt.Rays(*(x[:1200].reshape((40, 30) + x.shape[1:]).contiguous()
                     for x in world["trays"]))
    got = packet.traverse_bvh8(world["scenes"][16], rays)
    assert got.t.shape == (40, 30) and got.prim_id.dtype == torch.int64
    flat = packet.traverse_bvh8(world["scenes"][16],
                                nt.Rays(*(x[:1200] for x in world["trays"])))
    for a, b in zip(got, flat):
        assert torch.equal(a.reshape(-1), b)


@pytest.mark.parametrize("width", [8, 16])
def test_exact_alias_equals_traverse(world, width):
    s = world["scenes"][width]
    a = packet.traverse_bvh8_exact(s, world["trays"])
    b = packet.traverse_bvh8(s, world["trays"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _camera_rays(res=64):
    cam = j_cams.look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=res,
                         height=res, fov=60.0)
    jr = j_cams.pinhole_rays(cam)
    return jr, interop.rays_from_numpy(*(np.asarray(x) for x in jr))


def test_tile_untile_match_jax():
    jr, tr = _camera_rays()
    jt, juntile = jp.tile_image_rays(jr, 32, 16)
    tt, tuntile = packet.tile_image_rays(tr, 32, 16)
    for a, b in zip(tt, jt):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = tuntile(tt)
    for a, b in zip(back, tr):
        assert torch.equal(a, b)
    h = nt.Hits(tt.org[:, 0], tt.org[:, 1], tt.dir[:, 2],
                torch.arange(tt.org.shape[0]))
    jh = juntile(jrt.Hits(*(jax.numpy.asarray(x.numpy()) for x in h)))
    for a, b in zip(tuntile(h), jh):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        packet.tile_image_rays(tr, 48, 16)


def _spec_batches():
    jr, _ = _camera_rays()
    flat = jrt.Rays(*(np.asarray(x).reshape((-1,) + x.shape[2:]) for x in
                      jp.tile_image_rays(jr, 32, 16)[0]))
    rng = np.random.default_rng(3)
    rnd = jrt.Rays(rng.normal(size=(700, 3)).astype(np.float32),
                   rng.normal(size=(700, 3)).astype(np.float32),
                   np.zeros(700, np.float32), np.full(700, 9.0, np.float32))
    broken = jrt.Rays(flat.org.copy(), flat.dir.copy(), flat.min_t, flat.max_t)
    broken.org[5] = np.nan
    broken.dir[9] = 0.0
    dead = jrt.Rays(flat.org, -flat.dir, flat.min_t, flat.min_t)
    allbad = jrt.Rays(flat.org, np.zeros_like(flat.dir), flat.min_t, flat.max_t)
    return {"camera": flat, "random": rnd, "broken": broken, "dead": dead,
            "all_degenerate": allbad}


@pytest.mark.parametrize("sub", [None, 1, 8])
@pytest.mark.parametrize("batch", ["camera", "random", "broken", "dead",
                                   "all_degenerate"])
def test_detect_specialization_matches_jax(batch, sub):
    r = _spec_batches()[batch]
    want = jp.detect_specialization(jrt.Rays(*(jax.numpy.asarray(x) for x in r)),
                                    sub=sub)
    got = packet.detect_specialization(
        interop.rays_from_numpy(*r), sub=sub)
    assert got == want


def test_specialize_is_validated_and_bit_exact(world):
    s = world["scenes"][16]
    with pytest.raises(ValueError):
        packet.traverse_bvh8(s, world["trays"], specialize=(5, False))
    a = packet.traverse_bvh8(s, world["trays"], specialize=(None, True, True))
    b = packet.traverse_bvh8(s, world["trays"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rejects_what_the_kernel_does_not_take(world):
    s = world["scenes"][16]
    r = world["trays"]
    with pytest.raises(ValueError, match="width"):
        packet.traverse_bvh8(s._replace(width=4), r)
    with pytest.raises(ValueError, match="float32"):
        packet.traverse_bvh8(s, nt.Rays(*(x.double() for x in r)))
    with pytest.raises(ValueError, match="contiguous"):
        packet.traverse_bvh8(s, r._replace(org=r.org.t().contiguous().t()))
    with pytest.raises(ValueError, match="stack"):
        packet.traverse_bvh8(s._replace(depth=40), r)
    with pytest.raises(ValueError, match="one id per ray"):
        packet.traverse_bvh8(s, r, skip_prim_id=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="overflow"):
        packet.traverse_bvh8(s._replace(depth=0), r)  # a 1-slot stack
