"""PyTorch port, the host side of K1's schedule (traverse/packet.py):
the launch plan of the persistent kernel (grid, claim size), the stack
each thread holds and the plain version's peak stack depth.

The kernel's grid is the blocks that stay resident (the occupancy API's
count times the SMs), or fewer when a batch has fewer 32-ray claims than
the grid has warps. Each thread's stack is one local array of
``STACK_CAP`` entries, which must cover ``stack_slots(scene)``, and takes
no shared memory: a shared-memory top of 8 to 32 entries measured no
faster on an H100 (PERF.md), so the stack has one part. The plain
version's peak stack (``stats["max_sp"]``) on seeded camera-like and
incoherent rays over small BVH16 and BVH8 scenes stays within
``stack_slots``; a stack smaller than a walk needs raises, as the kernel
sets its error word. K1b's plan claims K packets of 32 rays a warp
(one packet on an any-hit launch, as K1 claims), each
walk on the same ``STACK_CAP``-entry stack as K1's, so its records do
not depend on the depth a scene states. The
plain version's records equal the JAX package's brute force under
``testing.compare_hits`` (``jax.disable_jit``). The kernel itself is
held to the plain version on the card by test_torch_gpu.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import compare_hits, overlap_soup
from nanort_tpu_torch.traverse import packet

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("n_rays", [1, 31, 32, 33, 4096, 131_072,
                                    6_553_600, 67_108_864])
@pytest.mark.parametrize("blocks_per_sm", [1, 7, 16])
def test_launch_plan_grid_and_claims(n_rays, blocks_per_sm):
    plan = packet.launch_plan(n_rays, blocks_per_sm, SMS)
    warps_a_block = plan.threads // 32
    claims = -(-n_rays // plan.claim)
    assert plan.threads == packet.K1_THREADS == 128
    assert plan.claim == packet.K1_CLAIM == 32
    assert 1 <= plan.grid <= blocks_per_sm * SMS
    # persistent: the resident grid, unless the claims fill fewer warps
    assert plan.grid == min(blocks_per_sm * SMS, -(-claims // warps_a_block))
    assert plan.grid * warps_a_block >= min(claims, blocks_per_sm * SMS
                                            * warps_a_block)
    # no block without a claim for each of its warps' first round but the
    # last one
    assert (plan.grid - 1) * warps_a_block < claims


@pytest.mark.parametrize("n_rays", [1, 31, 64, 65, 128, 129, 131_072,
                                    4_194_305, 67_108_864])
@pytest.mark.parametrize("blocks_per_sm", [1, 5, 12])
@pytest.mark.parametrize("K", [2, 4])
def test_k1b_launch_plan_grid_and_claims(K, blocks_per_sm, n_rays):
    # K1b: a warp claims K packets of 32 rays at a time, four claims
    # tiling 128 K rays; an any-hit launch claims one packet, as K1 does
    warps_a_block = packet.K1_THREADS // 32
    resident = blocks_per_sm * SMS
    for occlusion, packets in ((False, K), (True, 1)):
        plan = packet.launch_plan(n_rays, blocks_per_sm, SMS, K, occlusion)
        claims = packet.k1b_claims(n_rays, packets)
        assert claims == -(-n_rays // (128 * packets)) * 4
        assert claims * 32 * packets >= n_rays > (claims - 4) * 32 * packets
        assert plan.threads == packet.K1_THREADS
        assert plan.claim == packet.K1_CLAIM * packets
        assert plan.grid == max(1, min(resident, -(-claims // warps_a_block)))
        assert (plan.grid - 1) * warps_a_block < claims
    # the any-hit plan is K1's
    assert packet.launch_plan(n_rays, blocks_per_sm, SMS, K, True) == \
        packet.launch_plan(n_rays, blocks_per_sm, SMS)


@pytest.mark.parametrize("width,depth", [(16, 7), (16, 8), (16, 9), (8, 18),
                                         (8, 19), (8, 73)])
def test_k1b_records_of_scene_depths(width, depth):
    # every K1b walk holds K1's STACK_CAP-entry stack, whatever stack_slots
    # the scene's depth gives (the 8192^2 frame's BVH16, depth 7, needs 106)
    _, _, scene = _scene(width, "box")
    deep = dataclasses.replace(scene, depth=depth)
    assert packet.stack_slots(deep) <= packet.STACK_CAP
    rays = nt.make_rays(*(torch.from_numpy(x) for x in _ray_batch(
        "incoherent", 64, 4)))
    want = packet.traverse_bvh8(scene, rays)
    for K in (2, 4):
        got = packet.traverse_bvh8(deep, rays, interleave=K)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k1b_refuses_more_rays_than_its_indices_hold():
    # K1b indexes rays with 32-bit ints; K1 takes any count
    _, _, scene = _scene(16, "box")
    n = packet.IL_MAX_RAYS + 1
    big = nt.Rays(torch.zeros(1, 3).expand(n, 3),
                  torch.ones(1, 3).expand(n, 3), torch.zeros(1).expand(n),
                  torch.ones(1).expand(n))
    with pytest.raises(ValueError, match="at most"):
        packet.traverse_bvh8(scene, big, interleave=2)


def test_launch_plan_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        packet.launch_plan(1024, 0, SMS)


@pytest.mark.parametrize("width,depth", [(16, 1), (16, 7), (16, 34), (16, 35),
                                         (8, 9), (8, 73), (8, 74), (8, 90)])
def test_traverse_takes_the_stacks_the_kernel_holds(width, depth):
    # the kernel's stack is one local array of STACK_CAP entries: a scene
    # whose stack_slots exceed it is refused before any launch
    _, _, scene = _scene(width, "box")
    deep = dataclasses.replace(scene, depth=depth)
    slots = packet.stack_slots(deep)
    assert slots == depth * (width - 1) + 1
    rays = nt.make_rays(*(torch.from_numpy(x) for x in _ray_batch(
        "incoherent", 64, 3)))
    if slots <= packet.STACK_CAP:
        got = packet.traverse_bvh8(deep, rays)
        assert all(torch.equal(a, b) for a, b in zip(
            got, packet.traverse_bvh8(scene, rays)))
    else:
        with pytest.raises(ValueError, match="stack slots"):
            packet.traverse_bvh8(deep, rays)


@pytest.mark.parametrize("width,kind", [(8, "box"), (16, "box"),
                                        (8, "soup"), (16, "soup")])
def test_stack_slots_of_a_scene_fit_the_kernel(width, kind):
    _, _, scene = _scene(width, kind)
    assert (packet.stack_slots(scene) == scene.depth * (width - 1) + 1
            <= packet.STACK_CAP)


def _scene(width, kind):
    if kind == "soup":
        v, f, _, _ = overlap_soup(600, 1)
        leaf = 1
    else:
        v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
        leaf = 8
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    return v, f, collapse_bvh8(bvh, v, f, width=width)


def _ray_batch(kind, n, seed):
    """Seeded NumPy rays: a camera-like fan from one eye, or incoherent
    origins and directions."""
    rng = np.random.default_rng(seed)
    if kind == "frame":
        side = int(np.sqrt(n))
        u, w = np.meshgrid(np.linspace(-0.5, 0.5, side),
                           np.linspace(-0.5, 0.5, side))
        d = np.stack([u.ravel(), w.ravel(), -np.ones(side * side)], 1)
        org = np.tile([0.0, 0.0, 3.0], (side * side, 1))
    else:
        org = rng.uniform(-1.5, 1.5, (n, 3))
        d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scene_kind", ["box", "soup"])
@pytest.mark.parametrize("rays_kind", ["frame", "incoherent"])
@pytest.mark.parametrize("width", [8, 16])
def test_plain_peak_stack_within_slots(width, rays_kind, scene_kind):
    v, f, scene = _scene(width, scene_kind)
    org, d = _ray_batch(rays_kind, 400, 31)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    slots = packet.stack_slots(scene)
    stats = {}
    got = packet._traverse_reference(
        torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs), width,
        rays.org, rays.dir, rays.min_t, rays.max_t, None, None, False, True,
        False, slots, stats=stats)
    assert 1 <= stats["max_sp"] <= slots <= packet.STACK_CAP
    # the records are those of the JAX package's brute force
    jmesh = jrt.TriangleMesh(vertices=jax.numpy.asarray(v),
                             faces=jax.numpy.asarray(f))
    with jax.disable_jit():
        want = jrt.brute_force_traverse(jmesh, jrt.make_rays(org, d))
    c = compare_hits(nt.Hits(*got), jrt.Hits(*(np.asarray(x) for x in want)))
    assert c["ok"], c


def test_plain_peak_stack_is_the_largest_over_calls():
    _, _, scene = _scene(16, "soup")
    slots = packet.stack_slots(scene)
    tabs = torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs)
    peaks = []
    stats = {}
    for seed in (1, 2, 3):
        org, d = _ray_batch("incoherent", 64, seed)
        r = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
        one = {}
        for st in (one, stats):
            packet._traverse_reference(
                *tabs, 16, r.org, r.dir, r.min_t, r.max_t, None, None,
                False, True, False, slots, stats=st)
        peaks.append(one["max_sp"])
    assert stats["max_sp"] == max(peaks)


def test_plain_peak_stack_of_dead_rays_is_zero():
    _, _, scene = _scene(8, "box")
    org, d = _ray_batch("incoherent", 32, 5)
    r = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d),
                     max_t=torch.full((32,), -1.0))
    stats = {}
    packet._traverse_reference(
        torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs), 8, r.org,
        r.dir, r.min_t, r.max_t, None, None, False, True, False,
        packet.stack_slots(scene), stats=stats)
    assert stats["max_sp"] == 0 and stats.get("nodes", 0) == 0


@pytest.mark.parametrize("width", [8, 16])
def test_plain_raises_on_a_stack_below_the_peak(width):
    # the kernel checks sp + hit children against stack_size once a node
    # and sets its error word; the plain version raises at the same point
    _, _, scene = _scene(width, "soup")
    org, d = _ray_batch("incoherent", 200, 8)
    r = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    tabs = torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs)
    stats = {}
    packet._traverse_reference(*tabs, width, r.org, r.dir, r.min_t, r.max_t,
                               None, None, False, True, False,
                               packet.stack_slots(scene), stats=stats)
    peak = stats["max_sp"]
    packet._traverse_reference(*tabs, width, r.org, r.dir, r.min_t, r.max_t,
                               None, None, False, True, False, peak)
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet._traverse_reference(*tabs, width, r.org, r.dir, r.min_t,
                                   r.max_t, None, None, False, True, False,
                                   peak - 1)
