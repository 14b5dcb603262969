"""PyTorch port, the reference-exact stack engine
(``traverse/stack.py``): ``traverse_triangles`` on CPU tensors against
the JAX package's ``traverse_triangles`` over the same binary BVH, mesh
and rays, in float32 and float64.

The JAX side runs under ``jax.disable_jit()``: jitted on the CPU, XLA
contracts ``a * b - c * d`` into FMAs. Op by op the two engines run the
same arithmetic in the same per-ray order (near child first, last equal
t of a leaf window wins), so the tolerance is bit-identical records —
t, u, v and prim id, ties included. The rays are seeded incoherent rays
plus an on-axis camera grid whose diagonal pixels cross the Cornell
box's quad diagonals exactly (zero edge functions: the exact-edge
fallback decides them, and two prims tie at equal t).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nanort_tpu as jnt
from nanort_tpu.traverse import stack as jstack

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_uv_sphere, merge_meshes)
from nanort_tpu_torch.traverse import stack

torch.set_num_threads(1)

# run -> (dtype, options, max_stack). Each run traces the rays twice in
# one batch: as they are, then with every other ray skipping the prim it
# hit the first time (a per-ray skip_prim_id).
RUNS = {
    "f32": (np.float32, {}, None),
    "range_f32": (np.float32, {"prim_ids_range": (20, 150)}, None),
    "cull_f32": (np.float32, {"cull_back_face": True}, None),
    "no_exact_edges_f32": (np.float32, {"exact_edge_fallback": False}, None),
    "small_stack_f32": (np.float32, {}, 6),
    "f64": (np.float64, {}, None),
}


def _scene(dt):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    return v.astype(dt), f


def _rays(dt):
    rng = np.random.default_rng(31)
    n = 300
    org = rng.uniform(-0.9, 0.9, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # an on-axis 12 x 12 camera grid from z = 5 (diagonal pixels cross
    # the quad diagonals of the back wall exactly)
    s = (np.arange(12) + 0.5 - 6) / 6 * 0.2
    gx, gy = np.meshgrid(s, s)
    cd = np.stack([gx.ravel(), gy.ravel(), -np.ones(144)], 1)
    org = np.concatenate([org, np.tile([0.0, 0.0, 5.0], (144, 1))])
    d = np.concatenate([d, cd])
    return org.astype(dt), d.astype(dt)


@pytest.fixture(scope="module")
def traced():
    """Run -> (port hits, JAX hits, number of rays of one pass)."""
    out = {}
    builds = {}
    for name, (dt, opt, max_stack) in RUNS.items():
        if dt not in builds:
            v, f = _scene(dt)
            jm = jnt.TriangleMesh(jnp.asarray(v), jnp.asarray(f))
            bvh, _ = jnt.build_triangle_bvh(jm, jnt.BVHBuildOptions(
                min_leaf_primitives=4, max_leaf_primitives=4))
            builds[dt] = (v, f, jm, bvh, interop.bvh_from_numpy(
                *(np.asarray(x) for x in bvh)))
        v, f, jm, jbvh, pbvh = builds[dt]
        org, d = _rays(dt)
        n = len(org)
        options = nt.BVHTraceOptions(**opt)

        def port(org, d, skip=None):
            return stack.traverse_triangles(
                pbvh, nt.TriangleMesh(v, f),
                nt.make_rays(torch.from_numpy(org), torch.from_numpy(d)),
                options, skip_prim_id=skip, max_leaf=4, max_stack=max_stack)

        first = port(org, d).prim_id.numpy()
        skip = np.concatenate([
            np.full(n, nt.INVALID_PRIM_ID),
            np.where(np.arange(n) % 2 == 0, first, nt.INVALID_PRIM_ID)])
        org, d = np.concatenate([org, org]), np.concatenate([d, d])
        got = port(org, d, torch.from_numpy(skip))
        with jax.disable_jit():
            want = jstack.traverse_triangles(
                jbvh, jm, jnt.make_rays(jnp.asarray(org), jnp.asarray(d)),
                jnt.BVHTraceOptions(**opt),
                skip_prim_id=jnp.asarray(skip.astype(np.uint32)),
                max_leaf=4, max_stack=max_stack)
        out[name] = (got, want, n)
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_traverse_triangles_matches_jax(traced, run):
    got, want, n = traced[run]
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        g = g.numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got.t.numpy().dtype == RUNS[run][0]
    hit = got.hit.numpy()
    assert hit[:n].any() and not hit[:n].all()


def test_runs_exercise_their_options(traced):
    got, _, n = traced["f32"]
    base, skip = got.prim_id[:n].numpy(), got.prim_id[n:].numpy()
    even = np.arange(n) % 2 == 0
    hit = base != nt.INVALID_PRIM_ID
    # a skipping ray never reports the prim it skips; the others are
    # unchanged
    assert (skip[even & hit] != base[even & hit]).all()
    assert (skip[~even] == base[~even]).all()
    rng = traced["range_f32"][0].prim_id.numpy()
    h = rng != nt.INVALID_PRIM_ID
    assert h.any() and ((rng[h] >= 20) & (rng[h] < 150)).all()
    assert traced["cull_f32"][0].hit[:n].sum() < got.hit[:n].sum()
    # a stack too small to hold the walk drops subtrees, never hangs
    assert traced["small_stack_f32"][0].hit[:n].sum() < got.hit[:n].sum()
    # the on-axis grid's diagonal pixels hit two prims at equal t
    t = got.t[:n].numpy()
    assert len(np.unique(t[hit])) < hit.sum()


def test_too_small_max_leaf_raises():
    v, f = _scene(np.float32)
    bvh, _ = nt.build_triangle_bvh(nt.TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=4, max_leaf_primitives=4))
    assert stack._actual_max_leaf(bvh) == 4
    org, d = _rays(np.float32)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    with pytest.raises(ValueError, match="max_leaf=2"):
        stack.traverse_triangles(bvh, nt.TriangleMesh(v, f), rays,
                                 max_leaf=2)
    # max_leaf=None sizes the window from the tree
    a = stack.traverse_triangles(bvh, nt.TriangleMesh(v, f), rays,
                                 max_leaf=None)
    b = stack.traverse_triangles(bvh, nt.TriangleMesh(v, f), rays,
                                 max_leaf=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert stack._auto_max_stack(bvh) == jstack._auto_max_stack(
        jnt.BVH(*(jnp.asarray(x) for x in bvh)))


def test_stack_agrees_with_brute_force():
    v, f = _scene(np.float32)
    mesh = nt.TriangleMesh(torch.from_numpy(v), torch.from_numpy(f))
    bvh, _ = nt.build_triangle_bvh(mesh, nt.BVHBuildOptions(
        min_leaf_primitives=4, max_leaf_primitives=4))
    org, d = _rays(np.float32)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    from nanort_tpu_torch.testing import compare_hits

    c = compare_hits(nt.traverse_triangles(bvh, mesh, rays),
                     nt.brute_force_traverse(mesh, rays))
    assert c["ok"], c
