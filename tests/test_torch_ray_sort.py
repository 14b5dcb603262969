"""PyTorch port, traverse/ray_sort.py against the JAX package's.

- ``ray_sort_keys``: the port carries the JAX package's uint32 keys in
  int64; they must be equal value for value, with and without
  ``octant_major``, on a batch that holds dead rays (``max_t <= min_t``),
  origins outside the scene box, a NaN origin and signed-zero
  directions.
- ``sort_rays``: the same order as the JAX package's stable
  ``jnp.argsort``, and ``unsort`` restores the batch.
- ``traverse_bvh8_sorted``: the same records as the unsorted
  ``traverse_bvh8`` call (both are the plain version here, and a ray's
  records do not depend on its neighbours), for both intersectors, in
  closest-hit and any-hit mode, with a per-ray ``skip_prim_id``.
Tolerance: bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
from nanort_tpu.traverse import ray_sort as j_rs
import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.traverse import packet, ray_sort

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=9, max_leaf_primitives=9))
    scene = collapse_bvh8(bvh, v, f, width=16, woop=True).to("cpu")
    rng = np.random.default_rng(11)
    n = 2000
    org = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::17, 1] = -0.0
    d[5::17, 2] = 0.0
    min_t = np.full(n, 1e-3, np.float32)
    max_t = np.full(n, 1e30, np.float32)
    max_t[::5] = 0.0  # dead: the megabatch's terminated paths
    max_t[3::11] = 1e-3  # max_t == min_t is dead too
    org[7] = np.nan
    return scene, org, d, min_t, max_t


def _rays(org, d, min_t, max_t):
    return nt.Rays(*(torch.from_numpy(np.ascontiguousarray(x))
                     for x in (org, d, min_t, max_t)))


@pytest.mark.parametrize("octant_major", [False, True])
def test_keys_and_order_match_jax(world, octant_major):
    scene, org, d, min_t, max_t = world
    lo, hi = scene.nodes[0, 0:3], scene.nodes[0, 3:6]
    jr = jrt.Rays(*(jnp.asarray(x) for x in (org, d, min_t, max_t)))
    want = np.asarray(j_rs.ray_sort_keys(jr, np.asarray(lo), np.asarray(hi),
                                         octant_major)).astype(np.int64)
    got = ray_sort.ray_sort_keys(_rays(org, d, min_t, max_t), lo, hi,
                                 octant_major)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert (want[max_t <= min_t] >= 1 << 31).all()
    srt, order, unsort = ray_sort.sort_rays(_rays(org, d, min_t, max_t), lo,
                                            hi, octant_major)
    _, jorder, _ = j_rs.sort_rays(jr, np.asarray(lo), np.asarray(hi),
                                  octant_major)
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    back = unsort(srt)
    for a, b in zip(back, _rays(org, d, min_t, max_t)):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("intersector", ["watertight", "woop"])
def test_sorted_equals_unsorted(world, intersector, occlusion):
    scene, org, d, min_t, max_t = world
    ok = ~np.isnan(org).any(1)
    rays = _rays(org[ok], d[ok], min_t[ok], max_t[ok])
    want = packet.traverse_bvh8(scene, rays, occlusion=occlusion,
                                intersector=intersector)
    got = ray_sort.traverse_bvh8_sorted(scene, rays, occlusion=occlusion,
                                        intersector=intersector)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got.hit.sum()) > 500
    skip = torch.where(want.hit, want.prim_id, 0)
    got = ray_sort.traverse_bvh8_sorted(scene, rays, occlusion=occlusion,
                                        intersector=intersector,
                                        skip_prim_id=skip, octant_major=True)
    want = packet.traverse_bvh8(scene, rays, occlusion=occlusion,
                                intersector=intersector, skip_prim_id=skip)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
