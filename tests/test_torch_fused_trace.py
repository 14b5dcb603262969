"""PyTorch port, K2 (the in-kernel BVH16 trace of the fused path tracer):
the port's plain version ``traverse/fused_trace.py::trace_bvh16`` on CPU
tensors against the JAX package's ``make_tracer`` run in a small
``pallas_call`` in interpret mode, as tests/test_fused_trace.py runs it,
over the same BVH16, leaf and aux tables and the same seeded rays.

The JAX side runs in a child process without FMA instructions
(``testing.run_without_fma``: jitted XLA on the CPU otherwise contracts
``a * b + c`` inside the kernel). Tolerance: bit-identical records —
t, u, v, prim id, hit, material id and normal in closest-hit mode, the
boolean in occlusion mode. Seeded incoherent rays have no equal-t ties,
so the per-ray child order cannot show. The rays include axis-parallel
ones (the slab test's ``0 * inf`` NaN case), zero directions, NaN and
huge components (sanitised into misses), short tmax, and rays whose
tmax is exactly their closest hit's t (a miss for closest-hit, a hit
for occlusion).
"""

import functools
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch.core.ray import Rays
from nanort_tpu_torch.io.procedural import (
    make_cornell_dense_pt_scene, make_subdivided_sphere_scene)
from nanort_tpu_torch.models import path_tracer
from nanort_tpu_torch.testing import run_without_fma
from nanort_tpu_torch.traverse import fused_trace

torch.set_num_threads(1)

SCENES = ("dense_cornell", "sphere_leaf4", "edge_plane")
EDGE_B = 1024  # the JAX harness traces blocks of 8 x 128 rays


def _port_scene(name):
    """(BVH16 scene, aux rows, material ids) on the host."""
    if name == "dense_cornell":
        v, f, mids, mats = make_cornell_dense_pt_scene(2000)
        s = path_tracer.make_pt_scene(v, f, mids, mats, engine="pallas",
                                      device="cpu")
        return s.scene8, s.fused_aux, mids
    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.ops.triangle import TriangleMesh

    if name == "sphere_leaf4":
        v, f = make_subdivided_sphere_scene(600)
        leaf = 4
    else:  # one triangle in the plane x = 1, its lower edge on y = 0
        v = np.array([[1, 0, -1], [1, 2, -1], [1, 0, 2]], np.float32)
        f = np.array([[0, 1, 2]], np.int32)
        leaf = 1
    mids = (np.arange(len(f)) % 3).astype(np.int32)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    s8 = collapse_bvh8(bvh, v, f, width=16)
    aux = fused_trace.build_aux_rows(s8.leafs, mids, f, v, s8.max_leaf)
    return s8.to("cpu"), torch.from_numpy(aux), mids


def _rays(name, n=3000, seed=11):
    if name == "edge_plane":
        # ray 0 runs along +x in the box's y = 0 face plane, where the
        # slab test gives (0 - 0) * inf = NaN; ray EDGE_B is the same ray
        # 1e-3 above the plane. Inert rays (an empty [tmin, tmax]) in
        # between put the two in separate blocks of the JAX harness: the
        # TPU tracer tests a leaf for every ray of a block once any ray
        # of it votes for the leaf, the port only for rays that do.
        org = np.zeros((EDGE_B + 1, 3), np.float32)
        d = np.tile(np.float32([1.0, 0.0, 0.0]), (EDGE_B + 1, 1))
        tmin = np.ones(EDGE_B + 1, np.float32)
        tmax = np.zeros(EDGE_B + 1, np.float32)
        org[[0, EDGE_B]] = [[-1.0, 0.0, 0.5], [-1.0, 1e-3, 0.5]]
        tmin[[0, EDGE_B]] = 0.0
        tmax[[0, EDGE_B]] = 10.0
        return org, d, tmin, tmax
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1:] = 0.0  # axis-parallel
    d[::7, 0] = np.where(d[::7, 0] < 0, -1.0, 1.0)
    d[1::29, 0] = 0.0  # in a coordinate plane
    d[3::13] = 0.0  # zero direction
    org[4::31, 1] = np.nan
    d[6::37, 2] = 3.1e38  # finite, above the 3e38 threshold
    tmin = np.full(n, 0.001, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[5::11] = rng.uniform(0.05, 1.0, tmax[5::11].shape)
    return org, d, tmin, tmax


def _port_trace(s8, aux, org, d, tmin, tmax, **kw):
    t = torch.from_numpy
    return fused_trace.trace_bvh16(
        s8, Rays(t(org), t(d), t(tmin), t(tmax)), aux, **kw)


@pytest.fixture(scope="module")
def traced():
    """Port records, and the JAX records for the same inputs (one child
    process for every scene)."""
    port, inputs = {}, {}
    for name in SCENES:
        s8, aux, mids = _port_scene(name)
        org, d, tmin, tmax = _rays(name)
        first = _port_trace(s8, aux, org, d, tmin, tmax)
        # rays whose tmax is exactly their closest hit's t
        edge = first.hit.numpy() & (np.arange(len(org)) % 5 == 2)
        tmax = np.where(edge, first.t.numpy(), tmax).astype(np.float32)
        rec = _port_trace(s8, aux, org, d, tmin, tmax, want_aux=True)
        occ = _port_trace(s8, None, org, d, tmin, tmax, occlusion=True)
        port[name] = (rec, occ, edge, mids)
        for k, x in (("nodes", s8.nodes), ("leafs", s8.leafs), ("aux", aux),
                     ("org", org), ("dir", d), ("tmin", tmin),
                     ("tmax", tmax)):
            inputs[f"{name}/{k}"] = np.asarray(x)
        inputs[f"{name}/shape"] = np.array([s8.max_leaf, s8.depth])
    return port, run_without_fma(__file__, inputs)


@pytest.mark.parametrize("scene", SCENES)
def test_closest_with_aux_matches_jax(traced, scene):
    port, jax_out = traced
    rec, _, edge, mids = port[scene]
    want = {k: jax_out[f"{scene}/{k}"] for k in
            ("t", "u", "v", "pid", "hit", "mid", "gn")}
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, want["hit"] != 0)
    np.testing.assert_array_equal(rec.t.numpy(), want["t"])
    for got, key in ((rec.u, "u"), (rec.v, "v"), (rec.prim_id, "pid"),
                     (rec.material_id, "mid"), (rec.normal, "gn")):
        # on a miss the JAX tracer leaves its last accepted candidate in
        # u/v/pid/aux; the port reports zeros and prim -1 there
        np.testing.assert_array_equal(got.numpy()[hit], want[key][hit])
    assert (rec.prim_id.numpy()[~hit] == -1).all()
    assert (rec.u.numpy()[~hit] == 0).all() and (rec.v.numpy()[~hit] == 0).all()
    assert (rec.material_id.numpy()[~hit] == 0).all()
    assert (rec.normal.numpy()[~hit] == 0).all()
    assert (rec.material_id.numpy()[hit]
            == mids[rec.prim_id.numpy()[hit]]).all()
    if scene == "edge_plane":
        # the NaN slab: the in-plane ray is never tested against the
        # triangle its edge touches (K1 and brute force both hit it)
        assert hit[[0, EDGE_B]].tolist() == [False, True]
        assert hit.sum() == 1
        return
    # the tt == tmax rule: those rays are misses, reporting t = tmax
    assert edge.sum() > 100 and not hit[edge].any()
    assert hit.mean() > 0.3


@pytest.mark.parametrize("scene", SCENES)
def test_occlusion_matches_jax(traced, scene):
    port, jax_out = traced
    rec, occ, edge, _ = port[scene]
    occ, want = occ.numpy(), jax_out[f"{scene}/occ"] != 0
    np.testing.assert_array_equal(occ[~edge], want[~edge])
    # A blocker at exactly tt == tmax occludes once its leaf is tested.
    # The ray's own slab test may cull that leaf when the box entry
    # rounds above tt; the TPU tracer then still tests it for the ray
    # whenever a neighbour in the block visits the leaf. Measured: 3 of
    # 420 such rays on the dense Cornell scene, 0 of 357 on the sphere.
    assert (occ[edge] <= want[edge]).all()
    assert (occ[edge] != want[edge]).sum() <= max(1, edge.sum() // 50)
    assert (occ >= rec.hit.numpy()).all()


def test_degenerate_rays_miss():
    s8, aux, _ = _port_scene("sphere_leaf4")
    org, d, tmin, tmax = _rays("sphere_leaf4")
    rec = _port_trace(s8, aux, org, d, tmin, tmax)
    bad = ~(np.isfinite(org).all(1) & (np.abs(d) < 3e38).all(1)
            & (np.abs(d).sum(1) > 0))
    assert bad.sum() > 200
    assert not rec.hit.numpy()[bad].any()
    assert (rec.t.numpy()[bad] == tmax[bad]).all()
    occ = _port_trace(s8, None, org, d, tmin, tmax, occlusion=True)
    assert not occ.numpy()[bad].any()


def test_nan_slab_differs_from_k1():
    """K1's plain version folds the slab with ``where``, which skips the
    NaN: there the in-plane ray of ``edge_plane`` hits. The two rules
    are both the JAX package's (a recorded reference fact)."""
    from nanort_tpu_torch.traverse import packet

    s8, _, _ = _port_scene("edge_plane")
    t = torch.from_numpy
    org, d, tmin, tmax = _rays("edge_plane")
    k1 = packet.traverse_bvh8(s8, Rays(t(org), t(d), t(tmin), t(tmax)))
    k2 = _port_trace(s8, None, org, d, tmin, tmax)
    ab = [0, EDGE_B]
    assert k1.t[ab].tolist() == [2.0, 2.0]
    assert k2.hit[ab].tolist() == [False, True]


def test_aux_rows_and_stack_bound_match_jax():
    from nanort_tpu.traverse import fused_trace as jft

    s8, _, mids = _port_scene("sphere_leaf4")
    v, f = make_subdivided_sphere_scene(600)
    leafs = s8.leafs.numpy()
    gn = np.random.default_rng(1).normal(size=(len(f), 3)).astype(np.float32)
    for kw in ({}, {"gn_unit": gn}):
        a = fused_trace.build_aux_rows(leafs, mids, f, v, s8.max_leaf, **kw)
        b = jft.build_aux_rows(leafs, mids, f, v, s8.max_leaf, **kw)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for depth in (1, 3, 7, 12):
        assert (fused_trace.required_stack_slots(depth)
                == jft.required_stack_slots(depth))


def test_trace_bvh16_checks_arguments():
    s8, aux, _ = _port_scene("sphere_leaf4")
    org, d, tmin, tmax = _rays("sphere_leaf4", n=8)
    with pytest.raises(ValueError, match="want_aux"):
        _port_trace(s8, None, org, d, tmin, tmax, want_aux=True)
    with pytest.raises(ValueError, match="contiguous float32"):
        _port_trace(s8, aux, org.astype(np.float64), d, tmin, tmax)
    with pytest.raises(ValueError, match="BVH16"):
        _port_trace(s8._replace(width=8), aux, org, d, tmin, tmax)
    with pytest.raises(ValueError, match="parallel the leaf rows"):
        _port_trace(s8, aux[:-1], org, d, tmin, tmax, want_aux=True)


# ------------------------------------------------------------ JAX side

def _jax_kernel(max_leaf, occlusion, nodes_ref, leafs_ref, aux_ref, rays_ref,
                *refs):
    from nanort_tpu.traverse.fused_trace import make_tracer

    *outs, stack_ref, leafq_ref = refs
    tracer = make_tracer(nodes_ref, leafs_ref, stack_ref, leafq_ref,
                         max_leaf=max_leaf, aux_ref=aux_ref,
                         intersector="mt")
    args = [rays_ref[c] for c in range(8)]
    if occlusion:
        outs[0][:] = tracer(*args, occlusion=True)
    else:
        for ref, x in zip(outs, tracer(*args, want_aux=True)):
            ref[:] = x


def _jax_trace(nodes, leafs, aux, org, d, tmin, tmax, max_leaf, depth,
               occlusion):
    """Flat rays through make_tracer in interpret mode (8 x 128 blocks)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from nanort_tpu.traverse.fused_trace import fused_scratch_shapes

    sub, lanes = 8, 128
    n = org.shape[0]
    nb = -(-n // (sub * lanes))
    pad = nb * sub * lanes - n

    def prep(x, fill):
        return jnp.pad(jnp.asarray(x, jnp.float32), (0, pad),
                       constant_values=fill).reshape(nb, sub, lanes)

    rays8 = jnp.stack([prep(org[:, 0], 0), prep(org[:, 1], 0),
                       prep(org[:, 2], 0), prep(d[:, 0], 1),
                       prep(d[:, 1], 0), prep(d[:, 2], 0),
                       prep(tmin, 1.0), prep(tmax, 0.0)])
    blk = pl.BlockSpec((None, sub, lanes), lambda i: (i, 0, 0))
    f32 = jax.ShapeDtypeStruct((nb, sub, lanes), jnp.float32)
    i32 = jax.ShapeDtypeStruct((nb, sub, lanes), jnp.int32)
    shapes = [i32] if occlusion else [f32, f32, f32, i32, i32, i32, f32,
                                      f32, f32]
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    outs = pl.pallas_call(
        functools.partial(_jax_kernel, max_leaf, occlusion),
        grid=(nb,),
        in_specs=[vmem, vmem, vmem,
                  pl.BlockSpec((8, None, sub, lanes), lambda i: (0, i, 0, 0))],
        out_specs=tuple([blk] * len(shapes)),
        out_shape=tuple(shapes),
        scratch_shapes=fused_scratch_shapes(depth),
        interpret=True,
    )(jnp.asarray(nodes), jnp.asarray(leafs), jnp.asarray(aux), rays8)
    return [np.asarray(o).reshape(-1)[:n] for o in outs]


def _jax_side(inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    z = dict(np.load(inp))
    res = {}
    for name in SCENES:
        a = {k: z[f"{name}/{k}"] for k in ("nodes", "leafs", "aux", "org",
                                            "dir", "tmin", "tmax")}
        max_leaf, depth = (int(x) for x in z[f"{name}/shape"])
        args = (a["nodes"], a["leafs"], a["aux"], a["org"], a["dir"],
                a["tmin"], a["tmax"], max_leaf, depth)
        t, u, v, pid, hit, mid, gx, gy, gz = _jax_trace(*args, False)
        (occ,) = _jax_trace(*args, True)
        for k, x in (("t", t), ("u", u), ("v", v), ("pid", pid),
                     ("hit", hit), ("mid", mid),
                     ("gn", np.stack([gx, gy, gz], 1)), ("occ", occ)):
            res[f"{name}/{k}"] = x
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
