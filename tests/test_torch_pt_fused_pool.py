"""PyTorch port, K4's pooled schedule on the CPU (no card here): the
plain versions of what ``csrc/pt_fused.cu::pt_bvh_pool_kernel`` relies
on.

- Running the (lane, sample) paths in a shuffled order of chunks, each
  writing its radiance into the (spp_iters, RL, 3) per-sample buffer,
  then summing that buffer in sample order (``pt_fused.sample_sums``,
  what the wrapper does after the kernel), whole or in the consecutive
  slices of sample iterations that the wrapper launches one by one
  (``pt_fused.pool_slices``), gives ``_render_fused_bvh_reference``'s
  lane sums bit for bit: every random number depends on (lane, sample,
  bounce) alone.
- ``lane_ids=`` runs any subset of lanes under their true ray ids.
- The in-kernel sort key's plain counterpart (``pool_sort_keys``) equals
  ``ray_sort.ray_sort_keys`` on the same rays.

Tolerance: bit-identical. Small sizes: 12 x 10 rays, at most 8 spp and
5 bounces, on the 2,000-triangle dense Cornell scene.
"""

import numpy as np
import pytest
import torch

from nanort_tpu_torch.core.ray import Rays
from nanort_tpu_torch.io.procedural import make_cornell_dense_pt_scene
from nanort_tpu_torch.models import path_tracer, pt_fused
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.traverse import fused_trace, ray_sort

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dense():
    v, f, m, mats = make_cornell_dense_pt_scene(2000)
    return path_tracer.make_pt_scene(v, f, m, mats, engine="pallas",
                                     device="cpu")


def _inputs(scene, spp_lanes):
    r = pinhole_rays(look_at(eye=(0.0123, 0.0371, 2.6), center=(0, 0, 0),
                             width=12, height=10, fov=45.0, device="cpu"))
    org = r.org.reshape(-1, 3).repeat_interleave(spp_lanes, 0).contiguous()
    d = r.dir.reshape(-1, 3).repeat_interleave(spp_lanes, 0).contiguous()
    mat, _, _, _, _ = pt_fused.build_fused_bvh_tables(scene)
    nodes, leafs, aux, slots = fused_trace._check_tables(
        scene.scene8, scene.fused_aux, torch.device("cpu"))
    return mat, pt_fused._lights(scene, "cpu"), nodes, leafs, aux, slots, \
        org, d


@pytest.mark.parametrize("spp_lanes,strata", [(1, 1), (1, 2), (4, 1),
                                              (4, 2)])
def test_shuffled_paths_sum_to_the_lane_sums(dense, spp_lanes, strata):
    spp_iters, mb, seed = 2, 4, 9
    mat, lights, nodes, leafs, aux, slots, org, d = _inputs(dense,
                                                            spp_lanes)
    want = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org, d, seed, spp_iters, mb,
        3, "poly", strata, spp_lanes)
    RL = org.shape[0]
    # the pooled kernel's items: j = s * RL + lane, claimed in chunks that
    # finish in any order
    items = torch.arange(spp_iters * RL)
    chunks = list(items.split(37))
    order = np.random.default_rng(5).permutation(len(chunks))
    closest, shadow = pt_fused._bvh_tracers(mat, nodes, leafs, aux, slots)
    buf = torch.full((spp_iters, RL, 3), float("nan"))
    for c in order:
        j = chunks[c][torch.randperm(len(chunks[c]),
                                     generator=torch.Generator().manual_seed(
                                         int(c)))]
        lane, s = j % RL, j // RL
        buf[s, lane] = pt_fused._trace_paths_reference(
            org[lane], d[lane], lane, s, seed, mb, 3, "poly", strata,
            spp_lanes, lights, closest, shadow)
    got = pt_fused.sample_sums(buf)
    assert bool(torch.isfinite(got).all()) and float(got.sum()) > 0
    assert torch.equal(got, want)
    # one sample iteration a launch, each added to the sums before it
    acc = None
    for s0, k in pt_fused.pool_slices(RL, spp_iters, 12 * RL):
        acc = pt_fused.sample_sums(buf[s0:s0 + k], acc)
    assert torch.equal(acc, want)


@pytest.mark.parametrize("spp_lanes", [1, 4])
def test_lane_ids_run_a_subset_under_true_ids(dense, spp_lanes):
    mat, lights, nodes, leafs, aux, slots, org, d = _inputs(dense,
                                                            spp_lanes)
    kw = (5, 2, 5, 3, "poly", 2, spp_lanes)
    want = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org, d, *kw)
    pick = torch.from_numpy(np.random.default_rng(1).choice(
        org.shape[0], 29, replace=False))
    got = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org[pick], d[pick], *kw,
        lane_ids=pick)
    assert torch.equal(got, want[pick])
    # the default is arange(n)
    same = pt_fused._render_fused_bvh_reference(
        mat, lights, nodes, leafs, aux, slots, org[:7], d[:7], *kw,
        lane_ids=torch.arange(7))
    assert torch.equal(same, want[:7])


def test_sample_sums_add_in_sample_order():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(5, 33, 3)).astype(np.float32))
    x[2, 0] = float("inf")
    want = torch.zeros(33, 3)
    for r in x:
        want = want + r
    assert torch.equal(pt_fused.sample_sums(x), want)
    assert torch.equal(pt_fused.sample_sums(x[:0]), torch.zeros(33, 3))


@pytest.mark.parametrize("cap", [1, 12 * 33, 12 * 33 * 2 + 11, 1 << 20])
def test_sample_sums_over_slices_equal_the_whole(cap):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(7, 33, 3)).astype(np.float32))
    parts = pt_fused.pool_slices(33, 7, cap)
    # consecutive, covering every iteration once, each within the cap
    # unless one iteration alone passes it
    assert [s0 for s0, _ in parts] == list(
        np.cumsum([0] + [k for _, k in parts[:-1]]))
    assert sum(k for _, k in parts) == 7
    assert all(k * 33 * 12 <= cap or k == 1 for _, k in parts)
    assert len(parts) == -(-7 // max(1, cap // (33 * 12)))
    acc = None
    for s0, k in parts:
        acc = pt_fused.sample_sums(x[s0:s0 + k], acc)
    assert torch.equal(acc, pt_fused.sample_sums(x))
    assert pt_fused.pool_slices(33, 0, cap) == []


def _key_rays(n, seed):
    """Rays through and around the box: NaN and inf origins, -0.0 and
    NaN directions, and dead rays (max_t <= min_t)."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    org[::17, 0] = np.nan
    org[5::19, 2] = np.inf
    org[7::23, 1] = -np.inf
    d[::13, 1] = -0.0
    d[3::29, 2] = np.nan
    min_t = np.full(n, 0.001, np.float32)
    max_t = np.where(rng.random(n) < 0.3, 0.0, 1e30).astype(np.float32)
    return Rays(*(torch.from_numpy(x) for x in (org, d, min_t, max_t)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_sort_key_equals_ray_sort_keys(dense, seed):
    rays = _key_rays(4099, seed)
    lo, ext = pt_fused.pool_box(dense.scene8.nodes)
    hi = lo + ext
    # the box is the root row's: it holds every vertex
    v = dense.mesh.vertices
    assert bool((v >= lo).all() and (v <= hi + 1e-6).all())
    live = rays.max_t > rays.min_t
    got = pt_fused.pool_sort_keys(rays.org, rays.dir, live, lo, ext)
    # ray_sort_keys takes the box's hi and forms max(hi - lo, 1e-30)
    # itself; feed it a hi whose difference reproduces ext exactly
    assert torch.equal(torch.maximum(hi - lo, torch.full_like(lo, 1e-30)),
                       ext)
    want = ray_sort.ray_sort_keys(rays, lo, hi)
    assert torch.equal(got, want)
    assert int((got >> 31).sum()) == int((~live).sum())
