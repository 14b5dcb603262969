"""PyTorch port, the device LBVH builder (``build/lbvh.py``), refit
(``build/refit.py``) and the SAH top levels (``build/sah_top.py``): the
same seeded NumPy inputs through the JAX package and the port, on CPU
tensors.

Tolerance: bit-identical arrays (Morton codes, deltas, topology, every
BVH field, refit bounds, the SAH partition and its deltas). The JAX
functions that do float arithmetic run jitted, all at once, in a child
process whose XLA CPU backend emits no FMA (``testing.run_without_fma``:
on an FMA machine jitted XLA contracts ``a * b + c``; op by op under
``jax.disable_jit()`` they would compile one op at a time, about a
minute here). The integer ones run in this process. The reference's own
1.02x quality bound for the SAH top levels (``test_sah_top.py``), which
the reference fails, is not a gate here.
"""

import concurrent.futures
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanort_tpu.build import lbvh as jl
from nanort_tpu.build import sah_top as jst

import nanort_tpu_torch as nt
from nanort_tpu_torch.build import lbvh as tl
from nanort_tpu_torch.build import refit as tr
from nanort_tpu_torch.build import sah_top as tst
from nanort_tpu_torch.io.procedural import (make_random_triangles,
                                            make_uv_sphere)
from nanort_tpu_torch.ops.triangle import TriangleMesh, triangle_prim_bounds
from nanort_tpu_torch.testing import run_without_fma, same_bits

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bounds(kind):
    if kind == "sphere":
        v, f = make_uv_sphere(14, 28)
    elif kind == "tiny":
        v, f = make_random_triangles(3, seed=1)
    elif kind == "duplicate":
        v, f = make_random_triangles(128, seed=0, extent=0.0, tri_size=0.05)
    else:
        v, f = make_random_triangles(2000, seed=7)
    bmin, bmax, ctr = triangle_prim_bounds(TriangleMesh(v, f))
    if kind == "duplicate":
        ctr = np.zeros_like(ctr)  # identical codes: the index tiebreak
    return (bmin.astype(np.float32), bmax.astype(np.float32),
            ctr.astype(np.float32))


def _morton_inputs():
    rng = np.random.default_rng(5)
    c = rng.uniform(-1.5, 2.5, (3000, 3)).astype(np.float32)
    lo = np.asarray([-1.0, -1.0, 0.0], np.float32)
    hi = np.asarray([2.0, 2.0, 0.0], np.float32)  # a flat axis: ext 1e-30
    c[:4] = [lo, hi, lo - 1, hi + 1]  # the corners and past them
    c[4:8] = c[8:12]  # duplicates
    return c, lo, hi


def _hybrid_inputs():
    """Morton-sorted codes and boxes of the 2,000-triangle soup."""
    bmin, bmax, ctr = _bounds("soup")
    codes = tl.morton_codes(_t(ctr), _t(bmin.min(0)), _t(bmax.max(0)))
    order = torch.argsort(codes, stable=True).numpy()
    return codes.numpy()[order].astype(np.uint32), bmin[order], bmax[order]


def _sorted_soup(kind):
    """Morton-sorted centroids, boxes and codes of a scene."""
    if kind == "sphere":
        v, f = make_uv_sphere(20, 40, 1.0)
    else:
        v, f = make_random_triangles(3000, seed=11)
    tri = v[f]
    lo, hi = tri.min(1), tri.max(1)
    c = 0.5 * (lo + hi)
    codes = tl.morton_codes(_t(c), _t(lo.min(0)), _t(hi.max(0)))
    order = torch.argsort(codes, stable=True).numpy()
    return c[order], lo[order], hi[order], codes.numpy()[order]


LBVH_CASES = [("sphere", 4), ("soup", 4), ("duplicate", 1), ("tiny", 4)]
REFITS = ["deformed", "translated"]
SAH_CASES = [("soup", 4), ("soup", 9)]
BVH_FIELDS = ("bmin", "bmax", "flag", "axis", "data", "indices")


def _refit_case(how):
    """A native SAH tree of a UV sphere and the moved sphere's bounds."""
    v, f = make_uv_sphere(12, 24)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
    v2 = (v * np.asarray([1.0, 0.4, 1.3], np.float32) if how == "deformed"
          else v + np.asarray([5, 0, 0], np.float32))
    bmin2, bmax2, _ = triangle_prim_bounds(TriangleMesh(v2, f))
    return bvh, bmin2, bmax2, len(f)


def _jax_side(inp, out):
    """A child: the float-side JAX references of one part (0: Morton
    codes, hybrid deltas, SAH top levels; 1: build_lbvh, refit), jitted,
    without FMA."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    z = dict(np.load(inp))
    res = {}
    if int(z["part"]) == 1:
        _jax_builds(z, res)
        np.savez(out, **res)
        return
    res["morton"] = np.asarray(jl.morton_codes(
        *(jnp.asarray(x) for x in _morton_inputs())))
    codes, lo, hi = _hybrid_inputs()
    D = jl.hybrid_deltas(jnp.asarray(codes), jnp.asarray(lo),
                         jnp.asarray(hi), len(codes), C=32)
    res["hybrid"] = np.asarray(D)
    for i, x in enumerate(jl._topology_from_deltas(D, len(codes))):
        res[f"hybrid/topo{i}"] = np.asarray(x)
    for kind, levels in SAH_CASES:
        c, lo, hi, codes = _sorted_soup(kind)
        n = c.shape[0]
        perm, rcodes = jst.sah_top_partition(
            jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi), n,
            levels=levels, bins=8, stop_cap=16)
        D = jst.sah_hybrid_deltas(
            jnp.asarray(codes.astype(np.uint32)[np.asarray(perm)]), rcodes,
            n, levels)
        for k, x in (("perm", perm), ("codes", rcodes), ("D", D)):
            res[f"sah/{kind}{levels}/{k}"] = np.asarray(x)
    np.savez(out, **res)


def _jax_builds(z, res):
    from nanort_tpu.build import refit as jr
    from nanort_tpu.core.bvh import BVH as JBVH

    for kind, ml in LBVH_CASES:
        bvh, st = jl.build_lbvh(*_bounds(kind), max_leaf=ml)
        for k, x in zip(BVH_FIELDS, bvh):
            res[f"lbvh/{kind}{ml}/{k}"] = np.asarray(x)
        res[f"lbvh/{kind}{ml}/stats"] = np.asarray(
            [st.num_leaf_nodes, st.num_branch_nodes, st.max_tree_depth])
    for how in REFITS:
        bvh = JBVH(*(z[f"refit/{how}/{k}"] for k in BVH_FIELDS))
        got = jr.refit_bvh(bvh, z[f"refit/{how}/bmin2"],
                           z[f"refit/{how}/bmax2"])
        for k, x in zip(BVH_FIELDS, got):
            res[f"refit/{how}/{k}"] = np.asarray(x)


@pytest.fixture(scope="module")
def ref():
    """The two children's references, run side by side."""
    builds = {"part": np.asarray(1)}
    for how in REFITS:
        bvh, bmin2, bmax2, _ = _refit_case(how)
        for k, x in zip(BVH_FIELDS, bvh):
            builds[f"refit/{how}/{k}"] = np.asarray(x)
        builds[f"refit/{how}/bmin2"] = bmin2
        builds[f"refit/{how}/bmax2"] = bmax2
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        parts = list(pool.map(lambda x: run_without_fma(__file__, x),
                              [{"part": np.asarray(0)}, builds]))
    return {**parts[0], **parts[1]}


EDGE_U32 = [0, 1, 2, 3, 0x7FFF, 0x10000, 2**31 - 1, 2**31, 2**31 + 1,
            2**32 - 2, 2**32 - 1]


def test_clz32_matches_on_edge_and_random_values():
    x = np.concatenate([np.asarray(EDGE_U32, np.uint64),
                        np.random.default_rng(2).integers(
                            0, 2**32, 4000, dtype=np.uint64)]).astype(np.uint32)
    want = np.asarray(jl._clz32(jnp.asarray(x)))
    got = tl._clz32(_t(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got[0] == 32 and got[len(EDGE_U32) - 1] == 0  # 0 and 2**32-1


def test_morton_codes_match(ref):
    got = tl.morton_codes(*(_t(x) for x in _morton_inputs()))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref["morton"].astype(np.int64))
    assert ref["morton"].max() > 2**29  # the top Morton bits are exercised


def test_morton_deltas_match():
    rng = np.random.default_rng(6)
    codes = np.sort(rng.integers(0, 2**30, 2000).astype(np.uint32))
    codes[100:140] = codes[100]  # runs of duplicates
    want = np.asarray(jl._morton_deltas(jnp.asarray(codes), len(codes)))
    got = tl._morton_deltas(_t(codes.astype(np.int64)), len(codes))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [2, 3, 17, 1000])
def test_topology_from_arbitrary_deltas(n):
    rng = np.random.default_rng(n)
    D = rng.integers(jl.D_FLOOR + 3, 65, n - 1).astype(np.int32)
    for i in range(1, n - 1):  # neighbours differ, as in Morton deltas
        if D[i] == D[i - 1]:
            D[i] += 1 if D[i] < 64 else -1
    want = jl._topology_from_deltas(jnp.asarray(D), n)
    got = tl._topology_from_deltas(_t(D.astype(np.int64)), n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    first, last, split = (x.numpy() for x in got)
    assert first[0] == 0 and last[0] == n - 1
    assert ((first <= split) & (split < last)).all()


def test_hybrid_deltas_and_topology_match(ref):
    codes, lo, hi = _hybrid_inputs()
    n = codes.shape[0]
    got = tl.hybrid_deltas(_t(codes.astype(np.int64)), _t(lo), _t(hi), n,
                           C=32)
    want = ref["hybrid"]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    bidx = (np.arange(-(-n // 32) - 1) + 1) * 32 - 1
    assert (want[bidx] < 0).all() and want.min() >= jl.D_FLOOR
    for i, a in enumerate(tl._topology_from_deltas(got, n)):
        np.testing.assert_array_equal(a.numpy(), ref[f"hybrid/topo{i}"])


@pytest.mark.parametrize("kind,max_leaf", LBVH_CASES)
def test_build_lbvh_matches(ref, kind, max_leaf):
    bmin, bmax, ctr = _bounds(kind)
    got, st = tl.build_lbvh(bmin, bmax, ctr, max_leaf=max_leaf,
                            device="cpu")
    for k, a in zip(BVH_FIELDS, got):
        assert same_bits(a, ref[f"lbvh/{kind}{max_leaf}/{k}"]), k
    assert [st.num_leaf_nodes, st.num_branch_nodes, st.max_tree_depth] \
        == ref[f"lbvh/{kind}{max_leaf}/stats"].tolist()
    nt.validate(got, None if kind == "duplicate" else bmin,
                None if kind == "duplicate" else bmax,
                num_prims=bmin.shape[0])
    assert got.data[got.flag == 1, 0].max() <= max_leaf


def test_build_lbvh_centers_default_and_tensors():
    bmin, bmax, _ = _bounds("soup")
    want, _ = tl.build_lbvh(bmin, bmax, 0.5 * (bmin + bmax), device="cpu")
    got, _ = tl.build_lbvh(_t(bmin), _t(bmax))  # device of the tensors
    for a, b in zip(got, want):
        assert same_bits(a, b)


@pytest.mark.parametrize("how", REFITS)
def test_refit_matches(ref, how):
    bvh, bmin2, bmax2, n = _refit_case(how)
    got = tr.refit_bvh(bvh, bmin2, bmax2, device="cpu")
    for k, a in zip(BVH_FIELDS, got):
        assert same_bits(a, ref[f"refit/{how}/{k}"]), k
    nt.validate(got, bmin2, bmax2, num_prims=n)
    assert same_bits(got.data, bvh.data) and same_bits(got.flag, bvh.flag)
    if how == "translated":
        np.testing.assert_allclose(got.bmin[0], [4, -1, -1], atol=1e-5)


@pytest.mark.parametrize("kind,levels", SAH_CASES)
def test_sah_top_partition_matches(ref, kind, levels):
    c, lo, hi, codes = _sorted_soup(kind)
    n = c.shape[0]
    perm, rcodes = tst.sah_top_partition(_t(c), _t(lo), _t(hi), n,
                                         levels=levels, bins=8, stop_cap=16)
    want = {k: ref[f"sah/{kind}{levels}/{k}"] for k in ("perm", "codes", "D")}
    np.testing.assert_array_equal(perm.numpy(), want["perm"])
    np.testing.assert_array_equal(rcodes.numpy(), want["codes"])
    D = tst.sah_hybrid_deltas(_t(codes)[perm], rcodes, n, levels)
    np.testing.assert_array_equal(D.numpy(), want["D"])
    assert len(np.unique(want["codes"])) > 2 ** (levels // 2)
    assert sorted(perm.tolist()) == list(range(n))


def test_sah_cost_estimate_matches():
    rng = np.random.default_rng(9)
    lo = rng.normal(size=(300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (300, 3)).astype(np.float32)
    leaf = rng.uniform(size=300) < 0.5
    cnt = rng.integers(1, 9, 300)
    want = jst.sah_cost_estimate(lo, hi, leaf, cnt)
    assert tst.sah_cost_estimate(lo, hi, leaf, cnt) == want
    assert tst.sah_cost_estimate(_t(lo), _t(hi), _t(leaf), _t(cnt)) == want


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
