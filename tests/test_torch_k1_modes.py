"""PyTorch port, the modes of K1 (traverse/packet.py::traverse_bvh8) on
the CPU, where the wrapper runs its plain version: per-packet roots
(``packet_roots``), the visit counters (``debug_counts``), the zero-edge
flags (``_flag_zero_edges``) with the two-pass exact traversals
``traverse_bvh8_exact`` / ``traverse_bvh8_exact_fused``, and the K-way
interleave (K1b).

References: JAX ``brute_force_traverse`` op by op (``jax.disable_jit``)
over the same seeded NumPy rays, under ``testing.compare_hits`` (the
same hit mask, prim ids equal except at bit-equal t, t within 4 ulp,
u/v within 2e-6). Rays rooted at a node see exactly that subtree's
triangles; the counters sum to what the plain version's ``stats``
counted; the flags are sound (every ray whose record changes with the
exact-edge recompute is flagged); the two-pass exact traversals equal
single-pass exact bit for bit (each ray walks alone, so regrouping
changes no order). The kernels are held to these plain versions on the
card by test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build.bvh8 import collapse_bvh8 as j_collapse
from nanort_tpu.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch import interop
from nanort_tpu_torch.build.bvh8 import EMPTY_BIG
from nanort_tpu_torch.testing import compare_hits, zero_edge_rays
from nanort_tpu_torch.traverse import packet, treelet

torch.set_num_threads(1)


def _jax_brute(v, f, org, d, min_t, max_t, **kw):
    mesh = jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f))
    with jax.disable_jit():
        h = jrt.brute_force_traverse(mesh, jrt.Rays(
            *(jnp.asarray(x) for x in (org, d, min_t, max_t))), **kw)
    return jrt.Hits(*(np.asarray(x) for x in h))


@pytest.fixture(scope="module")
def world():
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.6))
    mesh = jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f))
    bvh, _ = jrt.build_triangle_bvh(mesh, jrt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    scenes = {}
    for w in (8, 16):
        s = j_collapse(bvh, v, f, width=w)
        scenes[w] = interop.scene_from_numpy(
            np.asarray(s.nodes), np.asarray(s.leafs), s.num_nodes,
            s.num_leaf_rows, s.depth, s.max_leaf, s.width)
    rng = np.random.default_rng(21)
    n = 1536
    org = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    min_t = np.zeros(n, np.float32)
    max_t = np.full(n, 3.0e38, np.float32)
    max_t[4::11] = -1.0  # dead rays
    rays = interop.rays_from_numpy(org, d, min_t, max_t, device="cpu")
    return dict(v=v, f=f, scenes=scenes, np_rays=(org, d, min_t, max_t),
                rays=rays)


def _subtree(scene, root):
    """(leaf row, count) of every leaf below node row ``root``."""
    nodes = np.asarray(scene.nodes)
    w = scene.width
    box, meta, count = ((6, 96, 112) if w == 16 else (8, 64, 72))
    out, stack = [], [int(root)]
    while stack:
        row = nodes[stack.pop()]
        for c in range(w):
            if row[box * c] >= EMPTY_BIG:
                continue
            m = int(row[meta + c])
            if m >= 0:
                stack.append(m)
            else:
                out.append((-m - 1, int(row[count + c]) & 15))
    return out


def _subtree_prims(scene, root):
    leafs = np.asarray(scene.leafs)
    return np.asarray(sorted(int(leafs[r, 90 + k]) for r, cnt in
                             _subtree(scene, root) for k in range(cnt)))


def _rooted_cases(world, width):
    """Start rows of a few subtrees: treelet roots (synthetic rows
    included) at width 8, the root's internal children at width 16."""
    s = world["scenes"][width]
    if width == 8:
        tl, s = treelet.make_treelets(s, 12)
        return s, [int(r) for r in tl.roots[:4]]
    row = np.asarray(s.nodes)[0]
    kids = [int(row[96 + c]) for c in range(16)
            if row[6 * c] < EMPTY_BIG and row[96 + c] >= 0]
    return s, kids[:4]


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_rooted_rays_see_their_subtree(world, width, occlusion):
    scene, roots = _rooted_cases(world, width)
    assert len(roots) >= 3
    org, d, min_t, max_t = world["np_rays"]
    n = 128 * len(roots)  # sub=1: one root a 128-ray packet
    rays = nt.Rays(*(x[:n] for x in world["rays"]))
    got = packet.traverse_bvh8(scene, rays, sub=1, occlusion=occlusion,
                               packet_roots=torch.tensor(roots))
    for p, root in enumerate(roots):
        sl = slice(128 * p, 128 * (p + 1))
        prims = _subtree_prims(scene, root)
        assert prims.size > 0
        want = _jax_brute(world["v"], world["f"][prims], org[sl], d[sl],
                          min_t[sl], max_t[sl])
        pid = np.where(want.prim_id == jrt.INVALID_PRIM_ID,
                       jrt.INVALID_PRIM_ID,
                       prims[np.minimum(want.prim_id, prims.size - 1)])
        want = jrt.Hits(want.t, want.u, want.v, pid)
        part = nt.Hits(*(x[sl] for x in got))
        if occlusion:
            assert np.array_equal(part.hit.numpy(), want.prim_id != jrt.INVALID_PRIM_ID)
            assert np.isin(part.prim_id.numpy()[part.hit.numpy()], prims).all()
        else:
            c = compare_hits(part, want)
            assert c["ok"], (root, c)
    # the global root as a packet root is the plain traversal
    zero = packet.traverse_bvh8(scene, rays, sub=1, packet_roots=torch.zeros(
        len(roots), dtype=torch.int32))
    plain = packet.traverse_bvh8(scene, rays)
    assert all(torch.equal(a, b) for a, b in zip(zero, plain))


def test_packet_roots_are_validated(world):
    s = world["scenes"][8]
    rays = world["rays"]  # 1,536 rays: 12 packets of 128, 3 of 512
    with pytest.raises(ValueError, match="need 12"):
        packet.traverse_bvh8(s, rays, sub=1,
                             packet_roots=torch.zeros(11, dtype=torch.int32))
    with pytest.raises(ValueError, match="integer"):
        packet.traverse_bvh8(s, rays, sub=4,
                             packet_roots=torch.zeros(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="outside"):
        packet.traverse_bvh8(s, rays, sub=4, packet_roots=torch.tensor(
            [0, 1, s.nodes.shape[0]]))
    with pytest.raises(ValueError, match="sub"):
        packet.traverse_bvh8(s, rays, sub=0,
                             packet_roots=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_counters_sum_to_the_plain_work(world, width, occlusion):
    s = world["scenes"][width]
    rays = world["rays"]
    got = packet.traverse_bvh8(s, rays, occlusion=occlusion,
                               debug_counts=True)
    hits = packet.traverse_bvh8(s, rays, occlusion=occlusion)
    assert torch.equal(got.t, hits.t) and torch.equal(got.prim_id,
                                                      hits.prim_id)
    stats = {}
    packet._traverse_reference(
        torch.as_tensor(s.nodes), torch.as_tensor(s.leafs), width, rays.org,
        rays.dir, rays.min_t, rays.max_t, None, None, False, True, occlusion,
        packet.stack_slots(s), stats=stats)
    assert int(got.u.sum()) == stats["nodes"]
    assert int(got.v.sum()) == stats["leaves"]
    # counters are whole numbers; dead rays pop nothing; a live ray
    # inside the box pops the root; a ray that hit drained a leaf
    assert torch.equal(got.u, got.u.round()) and got.u.dtype == torch.float32
    dead = rays.max_t < rays.min_t
    assert (got.u[dead] == 0).all() and (got.v[dead] == 0).all()
    assert (got.u[~dead] >= 1).all()
    assert (got.v[hits.hit] >= 1).all()
    if occlusion:  # any-hit stops early
        closest = packet.traverse_bvh8(s, rays, debug_counts=True)
        assert float(got.u.sum()) < float(closest.u.sum())


@pytest.mark.parametrize("width", [8, 16])
def test_plain_version_counts_the_rows_it_reads(world, width):
    s = world["scenes"][width]
    rays = world["rays"]

    def work(sl):
        stats = {}
        packet._traverse_reference(
            torch.as_tensor(s.nodes), torch.as_tensor(s.leafs), width,
            rays.org[sl], rays.dir[sl], rays.min_t[sl], rays.max_t[sl], None,
            None, False, True, False, packet.stack_slots(s), stats=stats)
        return stats

    # one ray pops a row at most once: its distinct rows are its pops
    singles = [work(slice(i, i + 1)) for i in (0, 1, 2, 3, 5)]
    for st in singles:
        assert st["node_rows"] == st["nodes"] >= 1
        assert st["leaf_rows"] == st["leaves"]
    # a batch reads each row once, however many rays pop it
    st = work(slice(None))
    assert max(x["node_rows"] for x in singles) <= st["node_rows"] < st["nodes"]
    assert st["leaf_rows"] < st["leaves"]
    assert st["node_rows"] <= s.num_nodes and st["leaf_rows"] <= s.num_leaf_rows


def _axis_aligned_case():
    """``testing.zero_edge_rays``: 512 axis-parallel rays onto the
    Cornell box's back-wall diagonal, edge functions rounding to 0;
    then 1,280 random rays behind them."""
    v, f, org, d = zero_edge_rays(512)
    rng = np.random.default_rng(4)
    r = rng.normal(size=(1280, 3)).astype(np.float32)
    org = np.concatenate([org, rng.uniform(-0.9, 0.9, (1280, 3)).astype(
        np.float32)])
    d = np.concatenate([d, r / np.linalg.norm(r, axis=1, keepdims=True)])
    n = org.shape[0]
    return v, f, org, d, np.zeros(n, np.float32), np.full(n, 3.0e38, np.float32)


@pytest.fixture(scope="module")
def boxed():
    v, f, org, d, min_t, max_t = _axis_aligned_case()
    mesh = jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f))
    bvh, _ = jrt.build_triangle_bvh(mesh, jrt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2))
    s = j_collapse(bvh, v, f, width=8)
    scene = interop.scene_from_numpy(
        np.asarray(s.nodes), np.asarray(s.leafs), s.num_nodes,
        s.num_leaf_rows, s.depth, s.max_leaf, s.width)
    return dict(v=v, f=f, scene=scene, np_rays=(org, d, min_t, max_t),
                rays=interop.rays_from_numpy(org, d, min_t, max_t,
                                             device="cpu"))


@pytest.mark.parametrize("occlusion", [False, True])
def test_zero_edge_flags_are_sound(boxed, occlusion):
    s, rays = boxed["scene"], boxed["rays"]
    fast = nt.BVHTraceOptions(exact_edge_fallback=False)
    hits, flags = packet.traverse_bvh8(s, rays, fast, occlusion=occlusion,
                                       _flag_zero_edges=True)
    assert flags.dtype == torch.int32 and flags.shape == rays.min_t.shape
    plain = packet.traverse_bvh8(s, rays, fast, occlusion=occlusion)
    assert all(torch.equal(a, b) for a, b in zip(hits, plain))
    exact = packet.traverse_bvh8(s, rays, occlusion=occlusion)
    differ = torch.zeros_like(flags, dtype=torch.bool)
    for a, b in zip(plain, exact):
        differ |= a != b
    assert int(flags[:512].sum()) > 200  # the edge rays flag
    assert int(flags[512:].sum()) < 20  # random rays rarely do
    assert not bool((differ & (flags == 0)).any())  # sound
    if not occlusion:
        assert bool(differ.any())  # the recompute changes some records
        c = compare_hits(exact, _jax_brute(boxed["v"], boxed["f"],
                                           *boxed["np_rays"]))
        assert c["ok"], c


def test_two_pass_exact_equals_single_pass(boxed, world):
    s = boxed["scene"]
    rays = boxed["rays"]
    single = packet.traverse_bvh8(s, rays)
    # the edge rays fill the first 4 of 14 packets of 128: more than
    # n_packets // 8, so the whole batch is retraced exact
    a = packet.traverse_bvh8_exact(s, rays, sub=1)
    assert all(torch.equal(x, y) for x, y in zip(a, single))
    # one flagged packet among many: only it is retraced
    mix = nt.Rays(*(torch.cat([r[:128], w]) for r, w in
                    zip(rays, nt.Rays(*(x[512:] for x in rays)))))
    flags = packet.traverse_bvh8(
        s, mix, nt.BVHTraceOptions(exact_edge_fallback=False),
        _flag_zero_edges=True)[1]
    assert int(flags[:128].sum()) > 0
    single = packet.traverse_bvh8(s, mix)
    for sub in (1, 4):
        got = packet.traverse_bvh8_exact(s, mix, sub=sub)
        assert all(torch.equal(x, y) for x, y in zip(got, single))
    got, overflow = packet.traverse_bvh8_exact_fused(s, mix)
    assert not bool(overflow)
    assert all(torch.equal(x, y) for x, y in zip(got, single))
    # the fused form's capacity: more flagged rows than fix_rows overflow
    got, overflow = packet.traverse_bvh8_exact_fused(s, rays, fix_rows=1)
    assert bool(overflow)
    got, overflow = packet.traverse_bvh8_exact_fused(s, rays, fix_rows=4)
    assert not bool(overflow)
    assert all(torch.equal(x, y) for x, y in zip(got, packet.traverse_bvh8(
        s, rays)))
    # a scene without zero edges takes pass 1 alone; skips pass through
    w = world["scenes"][16]
    skip = packet.traverse_bvh8(w, world["rays"]).prim_id
    want = packet.traverse_bvh8(w, world["rays"], skip_prim_id=skip)
    got = packet.traverse_bvh8_exact(w, world["rays"], skip_prim_id=skip)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got, _ = packet.traverse_bvh8_exact_fused(w, world["rays"],
                                              skip_prim_id=skip)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("K", [1, 2, 4])
def test_interleave_is_accepted(world, K):
    s = world["scenes"][16]
    want = packet.traverse_bvh8(s, world["rays"], occlusion=True)
    got = packet.traverse_bvh8(s, world["rays"], occlusion=True, interleave=K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw,match", [
    (dict(interleave=3), "interleave"),
    (dict(interleave=2, debug_counts=True), "interleaved"),
    (dict(interleave=4, _flag_zero_edges=True), "interleaved"),
    (dict(debug_counts=True, _flag_zero_edges=True), "separate"),
    (dict(_flag_zero_edges=True, intersector="woop"), "watertight"),
])
def test_unsupported_mode_combinations_raise(world, kw, match):
    with pytest.raises(ValueError, match=match):
        packet.traverse_bvh8(world["scenes"][8], world["rays"], **kw)
