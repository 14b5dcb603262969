"""PyTorch port, core modules: options, BVH container/serialization, math,
rays and the slab test — each against the JAX package on the same
seeded NumPy inputs. Tolerance: bit-identical (these are the same IEEE
operations in the same order)."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.core import aabb as j_aabb
from nanort_tpu.core import bvh as j_bvh
from nanort_tpu.core import math as j_math
from nanort_tpu.core import options as j_opts
from nanort_tpu_torch.core import aabb as t_aabb
from nanort_tpu_torch.core import bvh as t_bvh
from nanort_tpu_torch.core import options as t_opts
from nanort_tpu_torch.io.procedural import make_random_triangles
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import same_bits as _bits_equal

torch.set_num_threads(1)


@pytest.mark.parametrize("cls", ["BVHBuildOptions", "BVHTraceOptions",
                                 "BVHBuildStatistics"])
def test_options_defaults_match(cls):
    assert dataclasses.asdict(getattr(t_opts, cls)()) == dataclasses.asdict(
        getattr(j_opts, cls)())


def test_option_constants_match():
    for name in ("MAX_STACK_DEPTH", "MIN_PRIMITIVES_FOR_PARALLEL_BUILD",
                 "SHALLOW_DEPTH", "INVALID_PRIM_ID", "PRIM_RANGE_MAX"):
        assert getattr(t_opts, name) == getattr(j_opts, name)
    # the min/max leaf clamp in __post_init__
    assert (t_opts.BVHBuildOptions(min_leaf_primitives=9).max_leaf_primitives
            == j_opts.BVHBuildOptions(min_leaf_primitives=9).max_leaf_primitives)


@pytest.fixture(scope="module")
def small_bvh():
    v, f = make_random_triangles(300, seed=3)
    bvh, _ = nt.build_sah(*nt.triangle_prim_bounds(TriangleMesh(v, f)))
    return bvh, f.shape[0]


def test_bvh_dump_load_round_trip_and_bytes(small_bvh):
    bvh, n_prims = small_bvh
    t_bvh.validate(bvh, num_prims=n_prims)
    buf_t, buf_j = io.BytesIO(), io.BytesIO()
    t_bvh.dump(bvh, buf_t)
    j_bvh.dump(j_bvh.BVH(*bvh), buf_j)
    assert buf_t.getvalue() == buf_j.getvalue()
    back = t_bvh.load(io.BytesIO(buf_t.getvalue()))
    for a, b in zip(back, bvh):
        assert _bits_equal(a, b)


def test_bvh_skip_links_and_depth_match(small_bvh):
    bvh, _ = small_bvh
    jb = j_bvh.BVH(*bvh)
    assert np.array_equal(t_bvh.compute_skip_links(bvh),
                          j_bvh.compute_skip_links(jb))
    assert t_bvh.max_tree_depth(bvh) == j_bvh.max_tree_depth(jb)
    assert t_bvh.required_max_stack(bvh) == j_bvh.required_max_stack(jb)
    assert dataclasses.asdict(t_bvh.stats_from_bvh(bvh)) == dataclasses.asdict(
        j_bvh.stats_from_bvh(jb))


def test_safe_inverse_matches_jax():
    # XLA on the CPU flushes subnormal results to zero and torch keeps
    # them, so no input here has a subnormal reciprocal
    v = np.array([0.0, -0.0, 1e-8, -1e-8, 1e-45, -1e-45, np.inf, -np.inf,
                  1.0, -2.0, 3e37, -3e37, 1.1920929e-07, -1.1920929e-07,
                  1.2e-07, 0.3, np.nan], np.float32)
    got = nt.safe_inverse(torch.from_numpy(v)).numpy()
    want = np.asarray(j_math.safe_inverse(jnp.asarray(v)))
    assert _bits_equal(got, want)
    assert np.signbit(got[1]) and np.isneginf(got[1])


def test_normalize_matches_jax():
    from nanort_tpu_torch.core.math import normalize

    a = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    a[:3] = 0.0
    got = normalize(torch.from_numpy(a)).numpy()
    want = np.asarray(j_math.normalize(jnp.asarray(a)))
    assert np.abs(got - want).max() <= 2 * np.finfo(np.float32).eps


def test_make_rays_defaults_match():
    rng = np.random.default_rng(1)
    org = rng.normal(size=(7, 5, 3)).astype(np.float32)
    d = rng.normal(size=(7, 5, 3)).astype(np.float32)
    for kw in ({}, {"min_t": 0.5, "max_t": 9.0}):
        t = nt.make_rays(org, d, **kw)
        j = jrt.make_rays(org, d, **kw)
        assert t.batch_shape == (7, 5)
        for a, b in zip(t, j):
            assert a.is_contiguous()
            assert _bits_equal(a.numpy(), b)
    miss = nt.Hits(*(torch.zeros(2),) * 3,
                   torch.tensor([nt.INVALID_PRIM_ID, 7], dtype=nt.PRIM_ID_DTYPE))
    assert miss.hit.tolist() == [False, True]
    # int64 ids compare equal to the JAX package's uint32 ids
    assert (miss.prim_id.numpy() == np.asarray(jrt.no_hits((2,)).prim_id)).tolist() == [True, False]


def test_slab_test_matches_jax():
    rng = np.random.default_rng(2)
    n = 4000
    lo = rng.uniform(-2, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1.5, (n, 3)).astype(np.float32)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 0] = 0.0   # in-plane rays: 0 * inf slab NaNs
    d[::11, 1] = -0.0
    org[::7, 0] = lo[::7, 0]
    min_t = np.zeros(n, np.float32)
    max_t = rng.uniform(0.5, 10, n).astype(np.float32)
    inv = np.asarray(j_math.safe_inverse(jnp.asarray(d)))
    neg = d < 0
    want = j_aabb.intersect_ray_aabb(*map(jnp.asarray, (lo, hi, org, inv, neg)),
                                     jnp.asarray(min_t), jnp.asarray(max_t))
    got = t_aabb.intersect_ray_aabb(*map(torch.as_tensor,
                                         (lo, hi, org, inv.copy(), neg, min_t,
                                          max_t)))
    assert 0 < int(got[0].sum()) < n
    for a, b in zip(got, want):
        assert _bits_equal(a.numpy(), b)
    assert t_aabb.max_mult(torch.float32) == j_aabb.max_mult(jnp.float32)
    assert t_aabb.max_mult(torch.float64) == j_aabb.max_mult(jnp.float64)
