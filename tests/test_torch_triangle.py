"""PyTorch port, ops/triangle.py and ops/protocol.py: the watertight
intersector (exact-edge fallback on and off, back-face culling on and
off) against ``nanort_tpu.ops.triangle`` on the same seeded inputs,
including rays aimed exactly at the shared edges and vertices of an
axis-aligned grid. Tolerance: identical accept masks, t within 4 ulp,
u/v within 2e-6 absolute (ulp distance is meaningless near a zero
barycentric)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanort_tpu.ops import protocol as j_proto
from nanort_tpu.ops import triangle as jt
from nanort_tpu_torch.ops import protocol as t_proto
from nanort_tpu_torch.ops import triangle as tt
from nanort_tpu_torch.testing import UV_ATOL, ulp_distance

torch.set_num_threads(1)


def _both(org, d, p0, p1, p2, t_cur, **kw):
    """Run both intersectors over the (rays x triangles) grid."""
    R = org.shape[0]
    jc = jt.ray_coeffs(jnp.asarray(d))
    jres = jt.intersect_triangles(
        jax.tree_util.tree_map(lambda x: x[:, None], jc),
        jnp.asarray(org)[:, None], jnp.zeros((R, 1), jnp.float32),
        jnp.asarray(t_cur)[:, None], jnp.asarray(p0), jnp.asarray(p1),
        jnp.asarray(p2), **kw)
    tc = tt.ray_coeffs(torch.from_numpy(d))
    tres = tt.intersect_triangles(
        tt.RayCoeffs(*(x[:, None] for x in tc)), torch.from_numpy(org)[:, None],
        torch.zeros(R, 1), torch.from_numpy(t_cur)[:, None],
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(p2), **kw)
    return [np.asarray(x) for x in jres], [x.numpy() for x in tres]


def _assert_close(jres, tres):
    assert np.array_equal(jres[0], tres[0])
    m = jres[0]
    assert ulp_distance(jres[1][m], tres[1][m]).max(initial=0) <= 4
    for k in (2, 3):
        assert np.abs(jres[k][m] - tres[k][m]).max(initial=0) <= UV_ATOL


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cull", [False, True])
def test_random_rays_match_jax(exact, cull):
    rng = np.random.default_rng(10)
    R, L = 600, 48
    org = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::9, 2] = 0.0  # exercise the shear-axis tie chain
    tri = rng.uniform(-1, 1, (L, 3, 3)).astype(np.float32)
    t_cur = rng.uniform(0.5, 4.0, R).astype(np.float32)
    jres, tres = _both(org, d, tri[:, 0], tri[:, 1], tri[:, 2], t_cur,
                       cull_back_face=cull, exact_edge_fallback=exact)
    assert jres[0].sum() > 50
    _assert_close(jres, tres)


def _grid(n=4):
    """Axis-aligned n x n quad grid in the z=0 plane, two tris per quad."""
    tris = []
    for i in range(n):
        for j in range(n):
            a, b = (i, j, 0.0), (i + 1, j, 0.0)
            c, e = (i + 1, j + 1, 0.0), (i, j + 1, 0.0)
            tris += [(a, b, c), (a, c, e)]
    return np.asarray(tris, np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_shared_edges_and_vertices_match_jax(exact):
    tri = _grid()
    # targets on every vertex, edge midpoint and diagonal midpoint
    s = np.arange(0.5, 8.0) / 2.0  # 0.25 .. 3.75 step 0.5 plus halves
    g = np.arange(0, 9) / 2.0
    xs, ys = np.meshgrid(g, g)
    tgt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], 1)
    tgt = tgt[(tgt[:, 0] > 0) & (tgt[:, 0] < 4) & (tgt[:, 1] > 0)
              & (tgt[:, 1] < 4)]
    dirs = [np.array([0.0, 0.0, -1.0]), np.array([0.25, -0.5, -1.0]),
            np.array([-0.5, 0.0, -2.0])]
    org, d = [], []
    for dv in dirs:
        org.append(tgt - 4.0 * dv)  # exact in f32: small dyadic values
        d.append(np.broadcast_to(dv, tgt.shape))
    org = np.concatenate(org).astype(np.float32)
    d = np.concatenate(d).astype(np.float32)
    del s
    t_cur = np.full(org.shape[0], 1e30, np.float32)
    jres, tres = _both(org, d, tri[:, 0], tri[:, 1], tri[:, 2], t_cur,
                       exact_edge_fallback=exact)
    _assert_close(jres, tres)
    if exact:
        # watertight: every ray aimed inside the grid hits something
        assert tres[0].any(axis=1).all()


def test_prim_bounds_match_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (80, 3)).astype(np.int32)
    got = tt.triangle_prim_bounds(tt.TriangleMesh(torch.from_numpy(v),
                                                  torch.from_numpy(f)))
    want = jt.triangle_prim_bounds(jt.TriangleMesh(jnp.asarray(v),
                                                   jnp.asarray(f)))
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("skip", [None, 0xFFFFFFFF, 5, "per_ray"])
@pytest.mark.parametrize("prim_range", [(0, 0x7FFFFFFF), (3, 9)])
def test_trace_filters_match_jax(skip, prim_range):
    rng = np.random.default_rng(6)
    valid = rng.random((20, 12)) < 0.7
    ids = np.arange(12, dtype=np.uint32)
    if skip == "per_ray":
        j_skip = rng.integers(0, 12, 20).astype(np.uint32)
        t_skip = torch.from_numpy(j_skip.astype(np.int64))
    else:
        j_skip = t_skip = skip
    want = j_proto.apply_trace_filters(
        jnp.asarray(valid), jnp.asarray(ids), prim_range,
        jnp.asarray(j_skip) if skip == "per_ray" else j_skip)
    got = t_proto.apply_trace_filters(
        torch.from_numpy(valid), torch.from_numpy(ids.astype(np.int64)),
        prim_range, t_skip)
    assert np.array_equal(got.numpy(), np.asarray(want))
