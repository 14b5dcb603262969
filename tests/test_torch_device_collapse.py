"""PyTorch port, the device build (``build/device_collapse.py``): the
same seeded meshes through the JAX package's ``collapse_lbvh_device``
and the port's, on CPU tensors.

Tolerance: bit-identical tables (``nodes``, ``leafs``, ``leafs_woop``)
and equal ``num_nodes``, ``num_leaf_rows`` and ``depth``, for widths 8
and 16, Woop on and off, leaf merge and preorder on and off, SAH top
levels 0 and 4, a scene of at most ``max_leaf`` triangles and one of
``max_leaf + 1``. The JAX builds run jitted in two child processes side
by side whose XLA CPU backend emits no FMA (``testing.run_without_fma``;
the Woop rows' products would otherwise contract). The port's tables
also pass the structural checks of ``testing.wide_table_report`` (every
prim once, parents enclose children, pad rows empty, depth equal to the
walked levels), ``preorder_device`` equals the JAX package's and is a
pure relabeling, and K1's plain version on the device-built tables
(``traverse_bvh8`` on CPU tensors) gives the JAX package's brute-force
closest-hit records under the tie contract (t within 4 ulp, u/v within
2e-6, equal hit masks, prim ids equal except at equal t).
"""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch.build import device_collapse as tdc
from nanort_tpu_torch.build.bvh8 import table_depth
from nanort_tpu_torch.core.ray import Hits, Rays
from nanort_tpu_torch.io.procedural import (make_cornell_box,
                                            make_random_triangles,
                                            make_uv_sphere, merge_meshes)
from nanort_tpu_torch.testing import (compare_hits, run_without_fma,
                                      same_bits, wide_table_report)
from nanort_tpu_torch.traverse.packet import traverse_bvh8

torch.set_num_threads(1)

SAH = dict(sah_levels=4, sah_stop=16)
# name -> (scene, child, keyword arguments); each child builds its cases
# in this order, so cases that share a compiled phase share a child
CASES = {
    "w16": ("box", 0, dict(width=16)),  # merge and preorder on (auto)
    "w16_woop_sah": ("box", 0, dict(width=16, woop=True, merge_leaves=False,
                                    preorder=False, **SAH)),
    "w16_merge_sah": ("box", 0, dict(width=16, merge_leaves=True,
                                     preorder=False, **SAH)),
    "w8_woop": ("box", 1, dict(width=8, woop=True)),
    "tiny5_w16_woop": ("tiny5", 1, dict(width=16, woop=True)),
    "tiny9_w8_woop": ("tiny9", 1, dict(width=8, woop=True)),
    "n10_w16_woop": ("n10", 1, dict(width=16, woop=True)),
}
TABLES = ("nodes", "leafs", "leafs_woop")
SIZES = ("num_nodes", "num_leaf_rows", "depth")


def _scene(name):
    if name == "box":
        return merge_meshes(make_cornell_box(2.0),
                            make_uv_sphere(16, 32, 0.5))
    n = {"tiny5": 5, "tiny9": 9, "n10": 10}[name]
    return make_random_triangles(n, seed=2)


def _rays(n=300):
    rng = np.random.default_rng(3)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return org, d


def _jax_side(inp, out):
    """A child: the JAX tables of its cases, jitted, without FMA."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import nanort_tpu as jnt
    from nanort_tpu.build import device_collapse as jdc

    child = int(np.load(inp)["child"])
    res = {}
    for name, (scene, c, kw) in CASES.items():
        if c != child:
            continue
        s = jdc.collapse_lbvh_device(*_scene(scene), max_leaf=9, **kw)
        for k in TABLES + SIZES:
            x = getattr(s, k)
            if x is not None:
                res[f"{name}/{k}"] = np.asarray(x)
        if name == "w16_woop_sah":
            p = jdc.preorder_device(s)
            for k in TABLES:
                res[f"{name}/pre/{k}"] = np.asarray(getattr(p, k))
    if child == 0:
        v, f = _scene("box")
        h = jnt.brute_force_traverse(
            jnt.TriangleMesh(jnp.asarray(v), jnp.asarray(f)),
            jnt.make_rays(*(jnp.asarray(x) for x in _rays())))
        for k in ("t", "u", "v", "prim_id"):
            res[f"brute/{k}"] = np.asarray(getattr(h, k))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        parts = list(pool.map(
            lambda c: run_without_fma(__file__, {"child": np.asarray(c)}),
            range(2)))
    return {k: v for p in parts for k, v in p.items()}


@pytest.fixture(scope="module")
def built():
    return {name: tdc.collapse_lbvh_device(*_scene(scene), max_leaf=9,
                                           device="cpu", **kw)
            for name, (scene, _, kw) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_tables_match_jax(ref, built, name):
    s = built[name]
    for k in TABLES:
        x = getattr(s, k)
        if x is None:
            assert f"{name}/{k}" not in ref
            continue
        assert x.device.type == "cpu" and x.is_contiguous()
        assert same_bits(x, ref[f"{name}/{k}"]), k
    for k in SIZES:
        assert getattr(s, k) == int(ref[f"{name}/{k}"]), k


@pytest.mark.parametrize("name", list(CASES))
def test_tables_are_well_formed(built, name):
    s = built[name]
    n = _scene(CASES[name][0])[1].shape[0]
    r = wide_table_report(s, n)
    assert r["ok"], r
    assert table_depth(s.nodes.numpy(), s.width) == s.depth
    # power-of-two padding with a trailing park row
    rows = s.nodes.shape[0]
    assert rows & (rows - 1) == 0 and rows > s.num_nodes
    assert s.leafs.shape[0] & (s.leafs.shape[0] - 1) == 0


def test_preorder_matches_jax_and_relabels(ref, built):
    s = built["w16_woop_sah"]
    p = tdc.preorder_device(s)
    for k in TABLES:
        assert same_bits(getattr(p, k), ref[f"w16_woop_sah/pre/{k}"]), k
    assert (p.num_nodes, p.num_leaf_rows, p.depth) == \
        (s.num_nodes, s.num_leaf_rows, s.depth)

    def walk(scene):
        """DFS (slot 0 first): visit order, leaf first-touch order, and
        each visit's (box, kind, count, leaf row bytes)."""
        nodes, leafs = scene.nodes.numpy(), scene.leafs.numpy()
        lw = scene.leafs_woop.numpy()
        valid = nodes[:, 0:96:6] <= nodes[:, 3:96:6]
        metas = nodes[:, 96:112].astype(np.int64)
        order, first, sig, stack = [], [], [], [0]
        while stack:
            i = stack.pop()
            order.append(i)
            kids = []
            for sl in range(16):
                if not valid[i, sl]:
                    continue
                m = int(metas[i, sl])
                box = nodes[i, 6 * sl:6 * sl + 6].tobytes()
                if m >= 0:
                    kids.append(m)
                    sig.append(("int", box, float(nodes[i, 112 + sl])))
                else:
                    sig.append(("leaf", box, float(nodes[i, 112 + sl]),
                                leafs[-m - 1].tobytes(), lw[-m - 1].tobytes()))
                    if -m - 1 not in first:
                        first.append(-m - 1)
            stack.extend(reversed(kids))
        return order, first, sig

    o1, f1, sig1 = walk(s)
    o2, f2, sig2 = walk(p)
    assert sig1 == sig2  # same visits, same payloads: a relabeling
    assert o2 == list(range(len(o2))) and f2 == list(range(len(f2)))
    assert o1 != o2  # the input was not in preorder already


@pytest.mark.parametrize("name", ["w16", "w16_woop_sah", "w8_woop"])
def test_k1_plain_on_device_tables_matches_brute_force(ref, built, name):
    org, d = _rays()
    n = org.shape[0]
    rays = Rays(torch.from_numpy(org), torch.from_numpy(d),
                torch.zeros(n), torch.full((n,), np.finfo(np.float32).max))
    got = traverse_bvh8(built[name], rays)
    want = Hits(*(ref[f"brute/{k}"] for k in ("t", "u", "v", "prim_id")))
    c = compare_hits(got, want)
    assert c["ok"] and c["hits"] > n // 4, c
    if "woop" in name:
        got = traverse_bvh8(built[name], rays, intersector="woop")
        c = compare_hits(got, want, t_ulps=2**31, uv_atol=1.0)
        assert c["hit_mismatch"] <= 2, c


@pytest.mark.parametrize("sah_levels", [0, 4])
def test_scatter_indices_are_unique(sah_levels):
    """Every scatter of the build writes each index once (so the winner
    of a collision, unspecified in both frameworks, never matters): the
    kept children of the Karras tree (parent pointers, ``build_lbvh``'s
    preorder), the leaf records' row ranks (the leaf-row fill), and the
    finished tables' child rows and leaf rows (``preorder_device``)."""
    v, f = _scene("box")
    n = f.shape[0]
    vt, ft = torch.from_numpy(v), torch.from_numpy(f).long()
    topo = tdc._phase_a_topo(vt, ft, n, sah_levels=sah_levels,
                             **({"sah_stop": 16} if sah_levels else {}))
    first, last, split = topo[1:4]
    keep = last - first + 1 > 9
    okl = keep & (split - first + 1 > 9)
    okr = keep & (last - split > 9)
    kids = torch.cat([split[okl], (split + 1)[okr]])
    assert kids.unique().numel() == kids.numel() > 10
    assert not bool((kids == 0).any())  # the root is nobody's child
    rec = tdc._phase_a_records(*topo, n=n, max_leaf=9, K=4,
                               merge_leaves=True)
    s_leaf, leaf_rank, n_rows = rec[5], rec[6], int(rec[11])
    assert torch.equal(leaf_rank[s_leaf == 1], torch.arange(n_rows))
    s = tdc.collapse_lbvh_device(v, f, width=16, preorder=False,
                                 device="cpu", sah_levels=sah_levels,
                                 sah_stop=16)
    nodes = s.nodes
    live = nodes[:, 0:96:6] <= nodes[:, 3:96:6]
    meta = nodes[:, 96:112].long()
    child, lrow = meta[live & (meta >= 0)], -meta[live & (meta < 0)] - 1
    assert child.unique().numel() == child.numel() == s.num_nodes - 1
    assert lrow.unique().numel() == lrow.numel() == s.num_leaf_rows


def test_device_collapse_refuses_bad_arguments():
    v, f = _scene("box")
    with pytest.raises(ValueError, match="width"):
        tdc.collapse_lbvh_device(v, f, width=4, device="cpu")
    with pytest.raises(ValueError, match="woop"):
        tdc.collapse_lbvh_device(v, f, max_leaf=10, woop=True, device="cpu")
    with pytest.raises(ValueError, match="no primitives"):
        tdc.collapse_lbvh_device(v, f[:0], device="cpu")


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
