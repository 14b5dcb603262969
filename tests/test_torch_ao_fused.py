"""PyTorch port, K5 (the fused AO pass) and K2's watertight, skip-aware
leaf test: the port's plain versions (``models/ao_fused.py``,
``traverse/fused_trace.py``, CPU tensors) against the JAX package's
``render_ao_fused`` and ``make_tracer(intersector="watertight")`` run in
interpret mode, over the same BVH16, leaf and aux tables, rays and
hemisphere draws; ``build_ao_aux`` against the JAX table; and the fused
pass against the port's ``render_ao`` under the repository's tie
contract.

The JAX kernels run in a child process without FMA instructions
(``testing.run_without_fma``): jitted XLA on the CPU contracts
``a * b + c`` inside the kernel. The child also makes the hemisphere
draws (``ao_hemisphere_draws``, as ``render_ao_fused`` does), and the
port renders from them. Tolerances:
- K2 and K5 records: bit-identical (t, u, v, prim id, hit, normal; the
  occlusion booleans; the AO image). The seeded K2 rays are incoherent
  and the K5 camera is off-axis, so no two hits tie at exactly equal t
  (the port takes the child order from each ray's own octant, the TPU
  from ray 0's of its block);
- ``build_ao_aux``: bit-identical bytes, the JAX table computed without
  FMA contraction (under ``jax.disable_jit()``: eagerly, ``jnp.cross`` is
  itself jitted and XLA contracts it);
- K5 against ``render_ao`` (the stack engine, the same draws): equal hit
  masks, the same prim except between hits at bit-equal t, t within 4
  ulp, and at least 97% identical AO pixels, the JAX package's own bar
  (tests/test_ao_fused.py).
"""

import functools
import sys
import types

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.core.ray import Rays
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_uv_sphere, merge_meshes)
from nanort_tpu_torch.models import ao_fused, objrender
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.testing import compare_hits, run_without_fma
from nanort_tpu_torch.traverse import fused_trace

torch.set_num_threads(1)

# S = 3: interpret mode compiles one tracer per sample (8 take ~45 s),
# and a non-power-of-two S exercises the mean's product with 1 / S
W_IMG, S, EYE = 24, 3, (0.31, 0.17, 5.0)


def _scene():
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.6))
    mesh = nt.TriangleMesh(v, f)
    bvh, _ = nt.build_triangle_bvh(mesh, nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s8 = collapse_bvh8(bvh, v, f, width=16).to("cpu")
    return mesh, bvh, s8, ao_fused.build_ao_aux(mesh, s8)


def _k2_rays(n=1024, seed=23):
    """Seeded incoherent rays inside the box; every 7th axis-parallel,
    every 13th with a zero direction, NaN and huge components, short
    tmax."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1:] = 0.0
    d[::7, 0] = np.where(d[::7, 0] < 0, -1.0, 1.0)
    d[3::13] = 0.0
    org[4::31, 1] = np.nan
    d[6::37, 2] = 3.1e38
    tmin = np.full(n, 0.001, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[5::11] = rng.uniform(0.05, 1.0, tmax[5::11].shape)
    return org, d, tmin, tmax


def _trace(s8, aux, org, d, tmin, tmax, **kw):
    t = torch.from_numpy
    return fused_trace.trace_bvh16(s8, Rays(t(org), t(d), t(tmin), t(tmax)),
                                   aux, intersector="watertight", **kw)


@pytest.fixture(scope="module")
def case():
    """Port results, and the JAX ones for the same inputs (one child)."""
    mesh, bvh, s8, aux = _scene()
    org, d, tmin, tmax = _k2_rays()
    first = _trace(s8, aux, org, d, tmin, tmax)
    # half the rays skip their closest prim, the rest nothing
    skip = np.where(np.arange(len(org)) % 2 == 0, first.prim_id.numpy(), -1)
    skip = skip.astype(np.int32)
    k2 = {"closest": _trace(s8, aux, org, d, tmin, tmax, want_aux=True),
          "closest_skip": _trace(s8, aux, org, d, tmin, tmax, want_aux=True,
                                 skip=torch.from_numpy(skip)),
          "occ_skip": _trace(s8, None, org, d, tmin, tmax, occlusion=True,
                             skip=torch.from_numpy(skip))}
    cam = pinhole_rays(look_at(eye=EYE, center=(0, 0, 0), width=W_IMG,
                               height=W_IMG, fov=45.0, device="cpu"))
    v, f = mesh
    inputs = {"nodes": s8.nodes.numpy(), "leafs": s8.leafs.numpy(),
              "aux": aux.numpy(), "org": org, "dir": d, "tmin": tmin,
              "tmax": tmax, "skip": skip, "v": v, "f": f,
              "cam_org": cam.org.numpy(), "cam_dir": cam.dir.numpy(),
              "shape": np.array([s8.max_leaf, s8.depth])}
    jax_out = run_without_fma(__file__, inputs)
    return types.SimpleNamespace(mesh=mesh, bvh=bvh, s8=s8, aux=aux, k2=k2,
                                 first=first, skip=skip, cam=cam, jax=jax_out)


@pytest.mark.parametrize("mode", ["closest", "closest_skip"])
def test_k2_watertight_closest_matches_jax(case, mode):
    rec, want = case.k2[mode], {k: case.jax[f"{mode}/{k}"] for k in
                                ("t", "u", "v", "pid", "hit", "gn")}
    hit = rec.hit.numpy()
    np.testing.assert_array_equal(hit, want["hit"] != 0)
    np.testing.assert_array_equal(rec.t.numpy(), want["t"])
    for got, key in ((rec.u, "u"), (rec.v, "v"), (rec.prim_id, "pid"),
                     (rec.normal, "gn")):
        np.testing.assert_array_equal(got.numpy()[hit], want[key][hit])
    assert hit.mean() > 0.3
    if mode == "closest_skip":
        # the skipped rays never report their skipped prim
        skipped = case.skip >= 0
        assert (rec.prim_id.numpy()[skipped] != case.skip[skipped]).all()
        assert (hit & skipped).sum() > 50


def test_k2_watertight_occlusion_with_skip_matches_jax(case):
    occ = case.k2["occ_skip"].numpy()
    np.testing.assert_array_equal(occ, case.jax["occ_skip/occ"] != 0)
    assert occ.sum() > 100


def test_k2_watertight_agrees_with_k1_test(case):
    """The watertight test K2 runs is the reference's: K1's plain version
    on the same rays finds the same hits and prims, t within 4 ulp."""
    from nanort_tpu_torch.traverse import packet

    org, d, tmin, tmax = _k2_rays()
    t = torch.from_numpy
    ok = ~np.isnan(org).any(1) & (np.abs(d) < 3e38).all(1)
    ok &= np.abs(d).sum(1) > 0
    ok &= ~(np.abs(d) == 1).any(1)  # axis-parallel: K2's NaN slab rule
    k1 = packet.traverse_bvh8(case.s8, Rays(t(org), t(d), t(tmin), t(tmax)))
    rec = case.k2["closest"]
    k2 = nt.Hits(rec.t, rec.u, rec.v, torch.where(
        rec.hit, rec.prim_id.long(), nt.INVALID_PRIM_ID))
    # K2's hit at exactly tt == tmax is a miss: compare away from tmax
    ok &= ~(k1.t.numpy() == tmax)
    sel = torch.from_numpy(ok)
    c = compare_hits(nt.Hits(*(x[sel] for x in k2)),
                     nt.Hits(*(x[sel] for x in k1)))
    assert c["ok"], c
    assert c["hits"] > 500


def test_build_ao_aux_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from nanort_tpu.models.ao_fused import build_ao_aux as jax_aux
    from nanort_tpu.ops.triangle import TriangleMesh as JaxMesh

    v, f = case.mesh
    s8 = types.SimpleNamespace(leafs=case.s8.leafs.numpy(),
                               max_leaf=case.s8.max_leaf)
    with jax.disable_jit():
        want = np.asarray(jax_aux(JaxMesh(jnp.asarray(v), jnp.asarray(f)),
                                  s8))
    got = case.aux.numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the interpret-mode K5 in the no-FMA child built the same table
    assert got.tobytes() == case.jax["k5/aux"].tobytes()


def _k5_port(case, **kw):
    draws = torch.from_numpy(case.jax["k5/draws"])
    return ao_fused.render_ao_fused(case.mesh, case.cam, None, case.s8,
                                    case.aux, n_samples=S, draws=draws, **kw)


def test_k5_plain_matches_jax(case):
    aovs, hits = _k5_port(case)
    want = {k: case.jax[f"k5/{k}"] for k in ("ao", "t", "u", "v", "pid",
                                             "hit")}
    np.testing.assert_array_equal(aovs["hit"].numpy(), want["hit"])
    np.testing.assert_array_equal(aovs["ao"].numpy(), want["ao"])
    np.testing.assert_array_equal(hits.t.numpy(), want["t"])
    np.testing.assert_array_equal(hits.u.numpy(), want["u"])
    np.testing.assert_array_equal(hits.v.numpy(), want["v"])
    np.testing.assert_array_equal(hits.prim_id.numpy(), want["pid"])
    assert aovs["ao"].shape == (W_IMG, W_IMG) and aovs["hit"].float().mean() > 0.3
    assert 0.0 < float(aovs["ao"].mean()) < 1.0
    # the shared AOV assembly
    ref = objrender.aovs_from_hits(case.mesh, None, case.cam, hits)
    for k, x in ref.items():
        if k != "rgb":
            assert torch.equal(aovs[k], x), k


def test_k5_matches_render_ao_under_tie_contract(case):
    aovs, hits = _k5_port(case)
    draws = torch.from_numpy(case.jax["k5/draws"])
    ref_aovs, ref_hits = objrender.render_ao(
        case.bvh, case.mesh, case.cam, n_samples=S, max_leaf=8, draws=draws)
    assert torch.equal(aovs["hit"], ref_aovs["hit"])
    c = compare_hits(hits, ref_hits)
    assert c["hit_mismatch"] == 0 and c["prim_mismatch"] == 0, c
    assert c["t_max_ulp"] <= 4, c
    same = float((aovs["ao"] == ref_aovs["ao"]).float().mean())
    assert same >= 0.97, same


def test_k5_radius_and_shapes(case):
    cam = pinhole_rays(look_at(eye=EYE, center=(0, 0, 0), width=16,
                               height=16, fov=45.0, device="cpu"))
    near, _ = ao_fused.render_ao_fused(case.mesh, cam, 3, case.s8, case.aux,
                                       n_samples=4, ao_radius=0.05)
    far, _ = ao_fused.render_ao_fused(case.mesh, cam, 3, case.s8, case.aux,
                                      n_samples=4, ao_radius=1e30)
    assert near["ao"].shape == (16, 16) and near["rgb"].shape == (16, 16, 3)
    # shrinking the radius can only open up occlusion
    assert bool((near["ao"] >= far["ao"]).all())
    assert float(near["ao"].mean()) > float(far["ao"].mean())


def test_render_ao_fused_checks_arguments(case):
    with pytest.raises(ValueError, match="seed or draws"):
        ao_fused.render_ao_fused(case.mesh, case.cam, None, case.s8, case.aux)
    with pytest.raises(ValueError, match="draws must be"):
        ao_fused.render_ao_fused(case.mesh, case.cam, None, case.s8, case.aux,
                                 n_samples=2, draws=torch.zeros(3, 4, 3))
    with pytest.raises(ValueError, match="n_samples"):
        ao_fused.render_ao_fused(case.mesh, case.cam, 1, case.s8, case.aux,
                                 n_samples=0)
    flat = nt.Rays(*(x.reshape(-1, *x.shape[2:]).contiguous()
                     for x in case.cam))
    with pytest.raises(ValueError, match="intersector"):
        fused_trace.trace_bvh16(case.s8, flat, intersector="woop")
    with pytest.raises(ValueError, match="one prim id per ray"):
        fused_trace.trace_bvh16(case.s8, flat, skip=torch.zeros(3))


# ------------------------------------------------------------ JAX side

def _jax_k2_kernel(max_leaf, occlusion, nodes_ref, leafs_ref, aux_ref,
                   rays_ref, skip_ref, *refs):
    from nanort_tpu.traverse.fused_trace import make_tracer

    *outs, stack_ref, leafq_ref = refs
    tracer = make_tracer(nodes_ref, leafs_ref, stack_ref, leafq_ref,
                         max_leaf=max_leaf, aux_ref=aux_ref,
                         intersector="watertight")
    args = [rays_ref[c] for c in range(8)]
    skip = skip_ref[...]
    if occlusion:
        outs[0][:] = tracer(*args, occlusion=True, skip=skip)
    else:
        for ref, x in zip(outs, tracer(*args, want_aux=True, skip=skip)):
            ref[:] = x


def _jax_k2(z, skip, occlusion):
    """Flat rays through make_tracer in interpret mode (8 x 128 blocks)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from nanort_tpu.traverse.fused_trace import fused_scratch_shapes

    max_leaf, depth = (int(x) for x in z["shape"])
    sub, lanes = 8, 128
    n = z["org"].shape[0]
    nb = -(-n // (sub * lanes))
    pad = nb * sub * lanes - n

    def prep(x, fill, dt=jnp.float32):
        return jnp.pad(jnp.asarray(x, dt), (0, pad),
                       constant_values=fill).reshape(nb, sub, lanes)

    org, d = z["org"], z["dir"]
    rays8 = jnp.stack([prep(org[:, 0], 0), prep(org[:, 1], 0),
                       prep(org[:, 2], 0), prep(d[:, 0], 1),
                       prep(d[:, 1], 0), prep(d[:, 2], 0),
                       prep(z["tmin"], 1.0), prep(z["tmax"], 0.0)])
    blk = pl.BlockSpec((None, sub, lanes), lambda i: (i, 0, 0))
    f32 = jax.ShapeDtypeStruct((nb, sub, lanes), jnp.float32)
    i32 = jax.ShapeDtypeStruct((nb, sub, lanes), jnp.int32)
    shapes = [i32] if occlusion else [f32, f32, f32, i32, i32, i32, f32,
                                      f32, f32]
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    outs = pl.pallas_call(
        functools.partial(_jax_k2_kernel, max_leaf, occlusion),
        grid=(nb,),
        in_specs=[vmem, vmem, vmem,
                  pl.BlockSpec((8, None, sub, lanes), lambda i: (0, i, 0, 0)),
                  blk],
        out_specs=tuple([blk] * len(shapes)),
        out_shape=tuple(shapes),
        scratch_shapes=fused_scratch_shapes(depth),
        interpret=True,
    )(jnp.asarray(z["nodes"]), jnp.asarray(z["leafs"]), jnp.asarray(z["aux"]),
      rays8, prep(skip, -1, jnp.int32))
    return [np.asarray(o).reshape(-1)[:n] for o in outs]


def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nanort_tpu.core.ray import Rays as JaxRays
    from nanort_tpu.models.ao_fused import build_ao_aux, render_ao_fused
    from nanort_tpu.models.objrender import ao_hemisphere_draws
    from nanort_tpu.ops.triangle import TriangleMesh as JaxMesh

    z = dict(np.load(inp))
    res = {}
    n = z["org"].shape[0]
    # one launch traces every ray twice: without a skip, then with it
    twice = {k: np.concatenate([z[k], z[k]]) for k in
             ("org", "dir", "tmin", "tmax")}
    skip2 = np.concatenate([np.full(n, -1, np.int32), z["skip"]])
    outs = _jax_k2({**z, **twice}, skip2, False)
    t, u, v, pid, hit, _mid, gx, gy, gz = outs
    for mode, part in (("closest", slice(0, n)),
                       ("closest_skip", slice(n, 2 * n))):
        for k, x in (("t", t), ("u", u), ("v", v), ("pid", pid),
                     ("hit", hit), ("gn", np.stack([gx, gy, gz], 1))):
            res[f"{mode}/{k}"] = x[part]
    (res["occ_skip/occ"],) = _jax_k2(z, z["skip"], True)

    mesh = JaxMesh(jnp.asarray(z["v"]), jnp.asarray(z["f"]))
    max_leaf, depth = (int(x) for x in z["shape"])
    s8 = types.SimpleNamespace(nodes=z["nodes"], leafs=z["leafs"],
                               max_leaf=max_leaf, depth=depth)
    aux = build_ao_aux(mesh, s8)
    bs = z["cam_org"].shape[:-1]
    rays = JaxRays(jnp.asarray(z["cam_org"]), jnp.asarray(z["cam_dir"]),
                   jnp.zeros(bs, jnp.float32),
                   jnp.full(bs, np.finfo(np.float32).max, jnp.float32))
    key = jax.random.PRNGKey(7)
    aovs, hits = render_ao_fused(mesh, rays, key, s8, aux, n_samples=S)
    res["k5/draws"] = np.asarray(
        ao_hemisphere_draws(key, S, bs, jnp.float32, True))
    res["k5/aux"] = np.asarray(aux)
    for k, x in (("ao", aovs["ao"]), ("hit", aovs["hit"]), ("t", hits.t),
                 ("u", hits.u), ("v", hits.v),
                 ("pid", np.asarray(hits.prim_id).astype(np.int64))):
        res[f"k5/{k}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
