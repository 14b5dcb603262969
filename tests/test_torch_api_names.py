"""PyTorch port, public names the JAX package exports from its root and
core modules: the ray-type bitmask, ``no_hits``, ``surface_area``,
``PrimitiveKind``, ``list_node_intersections`` and the root re-exports —
each against the JAX package on the same seeded NumPy inputs.
Tolerance: equal values and dtypes (prim and node ids are int64 in the
port, holding the JAX package's uint32 values); ``list_node_intersections``
runs the JAX side under ``jax.disable_jit()`` and must give the same ids
and the same t bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.core import math as j_math
from nanort_tpu.ops import protocol as j_protocol
from nanort_tpu.traverse import stack as j_stack
from nanort_tpu_torch.core import math as t_math
from nanort_tpu_torch.io.procedural import make_random_triangles
from nanort_tpu_torch.ops import protocol as t_protocol
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.traverse import stack as t_stack

torch.set_num_threads(1)

RAY_TYPES = ["RAY_TYPE_NONE", "RAY_TYPE_PRIMARY", "RAY_TYPE_SECONDARY",
             "RAY_TYPE_DIFFUSE", "RAY_TYPE_REFLECTION", "RAY_TYPE_REFRACTION"]


@pytest.mark.parametrize("name", RAY_TYPES)
def test_ray_type_constants_match(name):
    assert getattr(nt, name) == getattr(jrt, name)
    assert type(getattr(nt, name)) is int


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("init", [False, True])
def test_no_hits_matches(dtype, init):
    shape = (3, 5)
    init_t = (np.random.default_rng(1).uniform(0, 9, shape).astype(dtype)
              if init else None)
    want = jrt.no_hits(shape, jnp.dtype(dtype), init_t)
    got = nt.no_hits(shape, getattr(torch, dtype),
                     None if init_t is None else torch.from_numpy(init_t))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got[:3], want[:3]):
        assert a.numpy().dtype == np.asarray(b).dtype
    assert got.prim_id.dtype == nt.PRIM_ID_DTYPE
    assert not bool(got.hit.any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_surface_area_matches(dtype):
    rng = np.random.default_rng(4)
    lo = rng.normal(size=(257, 3)).astype(dtype)
    hi = lo + rng.uniform(0, 3, (257, 3)).astype(dtype)
    hi[0] = lo[0]  # a flat box
    want = np.asarray(j_math.surface_area(jnp.asarray(lo), jnp.asarray(hi)))
    got = t_math.surface_area(torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_primitive_kind_fields_match():
    def fields(cls):
        return [(f.name, f.type) for f in dataclasses.fields(cls)]

    assert [n for n, _ in fields(t_protocol.PrimitiveKind)] == \
        [n for n, _ in fields(j_protocol.PrimitiveKind)]
    kind = t_protocol.PrimitiveKind("tri", len, None, None, None)
    assert kind == t_protocol.PrimitiveKind("tri", len, None, None, None)
    assert hash(kind) == hash(t_protocol.PrimitiveKind("tri", len, None,
                                                      None, None))
    with pytest.raises(dataclasses.FrozenInstanceError):
        kind.name = "other"


def _bvh_and_rays(n_rays, seed):
    """A multi-leaf binary BVH over seeded random triangles (one leaf per
    2 prims) and seeded rays through the scene, some with a zero
    direction component and some with a short max_t."""
    v, f = make_random_triangles(60, seed=seed)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2), use_native=False)
    rng = np.random.default_rng(seed + 1)
    org = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[::5, 1] = 0.0
    max_t = np.full(n_rays, np.finfo(np.float32).max, np.float32)
    max_t[3::7] = 0.5
    min_t = np.zeros(n_rays, np.float32)
    return bvh, (org, d, min_t, max_t)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_list_node_intersections_matches_jax(k):
    bvh, arrays = _bvh_and_rays(301, 3)
    assert int((np.asarray(bvh.flag) == 1).sum()) > 8
    with jax.disable_jit():
        want = j_stack.list_node_intersections(
            bvh, jrt.Rays(*(jnp.asarray(x) for x in arrays)), k)
    got = t_stack.list_node_intersections(
        bvh, nt.Rays(*(torch.from_numpy(x) for x in arrays)), k)
    assert nt.list_node_intersections is t_stack.list_node_intersections
    t0, t1, ids = (np.asarray(x) for x in want)
    assert got[0].shape == t0.shape and got[2].dtype == nt.PRIM_ID_DTYPE
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  t0.view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  t1.view(np.uint32))
    np.testing.assert_array_equal(got[2].numpy(), ids.astype(np.int64))
    assert (ids != 0xFFFFFFFF).any() and (ids == 0xFFFFFFFF).any() or k == 1


def test_list_node_intersections_batch_shape():
    bvh, arrays = _bvh_and_rays(12, 5)
    rays = nt.Rays(*(torch.from_numpy(x).reshape((3, 4) + x.shape[1:])
                     for x in arrays))
    t0, t1, ids = nt.list_node_intersections(bvh, rays, 5)
    assert t0.shape == t1.shape == ids.shape == (3, 4, 5)
    flat = nt.list_node_intersections(
        bvh, nt.Rays(*(torch.from_numpy(x) for x in arrays)), 5)
    assert torch.equal(ids.reshape(12, 5), flat[2])


REEXPORTS = ["intersect_ray_aabb", "max_mult", "intersect_triangles",
             "ray_coeffs", "no_hits", "list_node_intersections",
             "surface_area"]


@pytest.mark.parametrize("name", REEXPORTS)
def test_root_reexports_like_jax(name):
    from nanort_tpu_torch.core import aabb, ray
    from nanort_tpu_torch.ops import triangle

    home = {"intersect_ray_aabb": aabb, "max_mult": aabb,
            "intersect_triangles": triangle, "ray_coeffs": triangle,
            "no_hits": ray, "list_node_intersections": t_stack,
            "surface_area": t_math}[name]
    if name == "surface_area":
        # the JAX package keeps it in core.math, not at its root
        assert not hasattr(jrt, name) and hasattr(j_math, name)
        assert callable(home.surface_area)
        return
    assert hasattr(jrt, name)
    assert getattr(nt, name) is getattr(home, name)
