"""PyTorch port, traverse/treelet.py: the treelet-binned incoherent-ray
engine against the JAX package on one BVH8 table set (cornell box + UV
sphere, leaf 8, width 8: ``_scene8`` of tests/test_treelet.py) and one
seeded ray batch made with NumPy.

Tolerances: the host tables (``make_treelets``' roots, boxes and
augmented node table) and the K-lists (t_entry, tid, n_ent) are
bit-identical, the K-lists with the JAX side op by op
(``jax.disable_jit``); the pair sweep's grouping, slot fill and merge
give identical arrays. The engine's records (on the CPU,
K1's plain version with per-packet roots) have t bit-equal to the port's
global ``traverse_bvh8`` and prim ids equal except between hits at
equal t, and match JAX ``brute_force_traverse`` under
``testing.compare_hits``. The CUDA kernel is held to the same plain
version on the card by test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build.bvh8 import EMPTY_BIG, collapse_bvh8 as j_collapse
from nanort_tpu.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu.traverse import treelet as jtl
from nanort_tpu_torch import interop
from nanort_tpu_torch.build.bvh8 import table_depth
from nanort_tpu_torch.testing import compare_hits, same_bits
from nanort_tpu_torch.traverse import packet, treelet
from nanort_tpu_torch.utils import trace

torch.set_num_threads(1)


def _port_scene(s):
    return interop.scene_from_numpy(
        np.asarray(s.nodes), np.asarray(s.leafs), s.num_nodes,
        s.num_leaf_rows, s.depth, s.max_leaf, s.width)


def _build(v, f, leaf):
    mesh = jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f))
    bvh, _ = jrt.build_triangle_bvh(mesh, jrt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    return mesh, j_collapse(bvh, v, f)


@pytest.fixture(scope="module")
def world():
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(24, 48, 0.6))
    jmesh, js8 = _build(v, f, 8)
    return dict(v=v, f=f, jmesh=jmesh, js8=js8, s8=_port_scene(js8))


def _rays(n, seed, scale=1.5):
    """Seeded incoherent rays inside and around the scene; every 9th
    axis-parallel, every 7th with a short max_t, every 23rd dead."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::9] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, d[::9].shape[0])]
    min_t = np.zeros(n, np.float32)
    max_t = np.full(n, 3.0e38, np.float32)
    max_t[3::7] = rng.uniform(0.2, 1.5, max_t[3::7].shape)
    max_t[5::23] = -1.0
    return org, d, min_t, max_t


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("target", [8, 32, 64])
def test_make_treelets_matches_jax(world, target, flat):
    jt, jaug = jtl.make_treelets(world["js8"], target, flat=flat)
    tl, aug = treelet.make_treelets(world["s8"], target, flat=flat)
    assert tl.count == jt.count
    assert same_bits(tl.roots, np.asarray(jt.roots))
    assert same_bits(tl.bmin, np.asarray(jt.bmin))
    assert same_bits(tl.bmax, np.asarray(jt.bmax))
    assert same_bits(aug.nodes, np.asarray(jaug.nodes))
    assert aug.depth == jaug.depth and aug.num_nodes == jaug.num_nodes


def test_make_treelets_reads_tensor_tables(world):
    tl, aug = treelet.make_treelets(world["s8"], 32)
    tl_t, aug_t = treelet.make_treelets(world["s8"].to("cpu"), 32)
    assert isinstance(aug_t.nodes, torch.Tensor)
    assert torch.equal(aug_t.nodes, torch.from_numpy(aug.nodes))
    assert same_bits(tl_t.roots, tl.roots)
    with pytest.raises(ValueError, match="width-8"):
        treelet.make_treelets(world["s8"]._replace(width=16), 8)


def _leaf_children(nodes, root):
    """The leaf children reachable from node row ``root``."""
    n, stack = 0, [root]
    while stack:
        row = nodes[stack.pop()]
        for c in range(8):
            if row[8 * c] >= EMPTY_BIG:
                continue
            if row[64 + c] >= 0:
                stack.append(int(row[64 + c]))
            else:
                n += 1
    return n


@pytest.mark.parametrize("flat", [False, True])
def test_treelet_subtrees_fit_the_stack(world, flat):
    s8 = world["s8"]
    for target in (8, 32, 64):
        tl, aug = treelet.make_treelets(s8, target, flat=flat)
        nodes = np.asarray(aug.nodes)
        levels = [table_depth(nodes, 8, [r]) for r in tl.roots]
        assert max(levels) <= s8.depth
        assert table_depth(nodes, 8, tl.roots) == max(levels)
        if flat:
            # fan-8 levels over the leaf rows: ceil(log8(leaves)) levels
            for r, lv in zip(tl.roots, levels):
                leaves = _leaf_children(nodes, int(r))
                assert lv == max(1, math.ceil(math.log(leaves, 8) - 1e-9))
    # a scene whose depth undercounts its levels is refused
    with pytest.raises(ValueError, match="scene.depth"):
        treelet.make_treelets(s8._replace(depth=1), 8)


@pytest.mark.parametrize("target,K", [(24, 4), (8, 12)])
def test_klists_match_jax(world, target, K):
    jt, _ = jtl.make_treelets(world["js8"], target)
    org, d, min_t, max_t = _rays(700, 3, scale=3.0)
    with jax.disable_jit():
        want = jtl._treelet_klists(
            jnp.asarray(org), jnp.asarray(d), jnp.asarray(min_t),
            jnp.asarray(max_t), jnp.asarray(jt.bmin), jnp.asarray(jt.bmax),
            K, chunk=256)
    got = treelet._treelet_klists(
        torch.from_numpy(org), torch.from_numpy(d), torch.from_numpy(min_t),
        torch.from_numpy(max_t), jt.bmin, jt.bmax, K, chunk=300)
    assert same_bits(got[0], np.asarray(want[0]))
    assert same_bits(got[1], np.asarray(want[1]))
    # n_ent: the JAX sum widens to int64 with x64 on; the counts agree
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].max()) > min(K, jt.count) or K > jt.count


def test_pair_sweep_machinery_matches_jax():
    rng = np.random.default_rng(9)
    R, C, T, packet_n = 2048, 3, 24, 256
    td = rng.integers(0, T + 1, (R, C)).astype(np.int32)
    te = rng.uniform(0, 2, (R, C)).astype(np.float32)
    best_t = rng.uniform(0.5, 3.0, R).astype(np.float32)
    want = jtl._pair_order(jnp.asarray(td), jnp.asarray(te),
                           jnp.asarray(best_t), T, C, packet_n)
    got = treelet._pair_order(torch.from_numpy(td), torch.from_numpy(te),
                              torch.from_numpy(best_t), T, packet_n)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))

    org = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    comps = np.concatenate(
        [org, d, rng.uniform(0, 0.1, (R, 1)).astype(np.float32),
         np.full((R, 1), -1.0, np.float32)], axis=1)
    comps = np.concatenate([comps, np.asarray(
        [[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, -1.0]], np.float32)])
    n_slots = jtl._next_bucket(int(want[4]) + packet_n, packet_n)
    j_cap = min(R * C, n_slots)
    order, key_s, counts = (np.array(x) for x in want[:3])
    w_rows, w_tid, w_src = jtl._pair_fill(
        jnp.asarray(order[:j_cap]), jnp.asarray(key_s[:j_cap]),
        jnp.asarray(counts), jnp.asarray(comps), jnp.asarray(best_t),
        T, C, packet_n, n_slots)
    rows, tid, src = treelet._pair_fill(
        torch.from_numpy(order[:j_cap]).long(),
        torch.from_numpy(key_s[:j_cap]).long(),
        torch.from_numpy(counts).long(), torch.from_numpy(comps.copy()),
        torch.from_numpy(best_t), T, C, packet_n, n_slots)
    for k in range(8):
        assert same_bits(rows[:, k], np.asarray(w_rows[k]))
    assert np.array_equal(tid.numpy(), np.asarray(w_tid))
    assert np.array_equal(src.numpy(), np.asarray(w_src))
    # the engine passes only the active pairs: the same slots
    n_act = int(want[3])
    rows2, tid2, src2 = treelet._pair_fill(
        torch.from_numpy(order[:n_act]).long(),
        torch.from_numpy(key_s[:n_act]).long(),
        torch.from_numpy(counts).long(), torch.from_numpy(comps.copy()),
        torch.from_numpy(best_t), T, C, packet_n, n_slots)
    assert torch.equal(rows2, rows) and torch.equal(tid2, tid)
    assert torch.equal(src2, src)

    S = n_slots
    slot_t = rng.uniform(0, 4, S).astype(np.float32)
    slot_t[::5] = slot_t[1::5][: slot_t[::5].shape[0]]  # equal-t ties
    slot_u = rng.uniform(0, 1, S).astype(np.float32)
    slot_v = rng.uniform(0, 1, S).astype(np.float32)
    slot_pid = rng.integers(0, 100, S).astype(np.uint32)
    slot_pid[rng.uniform(size=S) < 0.3] = jrt.INVALID_PRIM_ID
    j_best = jrt.Hits(t=jnp.asarray(best_t), u=jnp.zeros(R, jnp.float32),
                      v=jnp.zeros(R, jnp.float32),
                      prim_id=jnp.full((R,), jrt.INVALID_PRIM_ID, jnp.uint32))
    want_m = jtl._pair_merge(j_best, jnp.asarray(slot_t), jnp.asarray(slot_u),
                             jnp.asarray(slot_v), jnp.asarray(slot_pid),
                             w_src)
    t_best = nt.Hits(torch.from_numpy(best_t), torch.zeros(R), torch.zeros(R),
                     torch.full((R,), nt.INVALID_PRIM_ID))
    got_m = treelet._pair_merge(
        t_best, torch.from_numpy(slot_t), torch.from_numpy(slot_u),
        torch.from_numpy(slot_v), torch.from_numpy(slot_pid.astype(np.int64)),
        src)
    for g, w in zip(got_m, want_m):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert int(got_m.hit.sum()) > 0


@pytest.mark.parametrize("flat,K,octant_major", [
    (False, 8, True), (True, 2, False), (False, 1, False)])
def test_binned_matches_global_and_brute(world, flat, K, octant_major):
    tl, aug = treelet.make_treelets(world["s8"], 32, flat=flat)
    org, d, min_t, max_t = _rays(2000, 11)
    rays = interop.rays_from_numpy(org, d, min_t, max_t, device="cpu")
    before = trace.counts()
    got = treelet.traverse_bvh8_binned(aug, rays, treelets=tl, K=K, sub=1,
                                       octant_major=octant_major)
    assert trace.since(before) == {}  # the CPU runs the plain version
    glob = packet.traverse_bvh8(world["s8"], rays)
    c = compare_hits(got, glob, t_ulps=0)
    assert c["ok"] and c["hits"] > 500, c
    assert torch.equal(got.t, glob.t)
    with jax.disable_jit():
        want = jrt.brute_force_traverse(world["jmesh"], jrt.Rays(
            *(jnp.asarray(x) for x in (org, d, min_t, max_t))))
    c = compare_hits(got, jrt.Hits(*(np.asarray(x) for x in want)))
    assert c["ok"], c


def test_binned_keeps_batch_shape_and_options(world):
    tl, aug = treelet.make_treelets(world["s8"], 16)
    org, d, min_t, max_t = _rays(600, 13)
    rays = interop.rays_from_numpy(org, d, min_t, max_t, device="cpu")
    shaped = nt.Rays(*(x.reshape((20, 30) + x.shape[1:]) for x in rays))
    got = treelet.traverse_bvh8_binned(aug, shaped, treelets=tl, K=3, sub=1)
    assert got.t.shape == (20, 30)
    opts = nt.BVHTraceOptions(cull_back_face=True)
    got = treelet.traverse_bvh8_binned(aug, rays, opts, treelets=tl, K=3,
                                       sub=1)
    c = compare_hits(got, packet.traverse_bvh8(world["s8"], rays, opts),
                     t_ulps=0)
    assert c["ok"], c
    # without treelets, the engine builds them
    got = treelet.traverse_bvh8_binned(world["s8"], rays, n_treelets=8, K=2,
                                       sub=1)
    assert compare_hits(got, packet.traverse_bvh8(world["s8"], rays),
                        t_ulps=0)["ok"]


def _make_corridor(n=12):
    """n clusters along z; all but the last hold only corner triangles
    (their AABBs span the corridor at x=y=0 but the geometry misses an
    axial ray), the last holds a big triangle covering the axis
    (tests/test_treelet.py)."""
    vs, fs = [], []
    for i in range(n):
        z = float(i)
        if i < n - 1:
            for sx, sy in ((0.9, 0.9), (-0.95, -0.95)):
                a = len(vs)
                vs += [[sx, sy, z], [sx + 0.05, sy, z], [sx, sy + 0.05, z]]
                fs.append([a, a + 1, a + 2])
        else:
            a = len(vs)
            vs += [[-1.0, -1.0, z], [1.0, -1.0, z], [0.0, 1.0, z]]
            fs.append([a, a + 1, a + 2])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def test_completion_sweep_exactness():
    v, f = _make_corridor(12)
    _, js8 = _build(v, f, 2)
    s8 = _port_scene(js8)
    tl, aug = treelet.make_treelets(s8, 16)
    rng = np.random.default_rng(3)
    org = np.concatenate(
        [[[0.0, 0.0, -1.0]],
         rng.uniform(-1, 1, (15, 3)) * [1, 1, 0] + [0, 0, -1]]
    ).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (16, 1))
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    # the dense phase sees the overflow, as the JAX package's does
    _, _, n_ent = treelet._treelet_klists(
        rays.org, rays.dir, rays.min_t, rays.max_t, tl.bmin, tl.bmax, 2)
    _, _, j_ent = jtl._treelet_klists(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(rays.min_t.numpy()),
        jnp.asarray(rays.max_t.numpy()), jnp.asarray(tl.bmin),
        jnp.asarray(tl.bmax), 2)
    assert np.array_equal(n_ent.numpy(), np.asarray(j_ent))
    assert int(n_ent[0]) > 2
    # without the sweep the axial ray's hit, in the farthest cluster, is
    # missed at K=2
    trunc = treelet.traverse_bvh8_binned(aug, rays, treelets=tl, K=2, sub=1,
                                         _complete=False)
    assert int(trunc.prim_id[0]) == nt.INVALID_PRIM_ID
    got = treelet.traverse_bvh8_binned(aug, rays, treelets=tl, K=2, sub=1)
    glob = packet.traverse_bvh8(s8, rays)
    assert int(got.prim_id[0]) == len(f) - 1
    assert all(torch.equal(a, b) for a, b in zip(got, glob))
