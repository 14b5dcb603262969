"""PyTorch port, the custom primitive kinds (``ops/sphere.py``,
``ops/cylinder.py``, ``ops/curve.py``) on the stack engine: the same
seeded spheres, cylinders, curves and rays through the JAX package and
the port (CPU tensors). The port's ``build_*_bvh`` takes the native
builder and the JAX package's the NumPy one, so the two trace different
trees of the same prims.

Tolerance: equal hit masks and prim ids (except between hits at exactly
equal t), t within 4 ulp of its dtype, u/v within 1e-6 absolute (the
sphere's atan2 and acos differ from XLA's in the last ulp). Each kind
runs plain and with trace filters (a per-ray ``skip_prim_id`` of the
prim the first pass hit, every other ray, and ``prim_ids_range``); the
sphere also in float64. The JAX traversals run jitted in two child
processes side by side whose XLA CPU backend emits no FMA
(``testing.run_without_fma``: jitted, XLA contracts ``b*b - 4*a*c`` and
the curve's projection; op by op, each traversal would take seconds).
The analytic cases of the JAX package's ``test_custom_prims.py`` and
``test_curves.py`` run on the port alone.
"""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.ops import curve, cylinder, sphere
from nanort_tpu_torch.testing import compare_hits, run_without_fma

torch.set_num_threads(1)

UV_ATOL = 1e-6
# name -> (kind, dtype, filtered, num_subdivisions, child)
CASES = {
    "sphere": ("sphere", np.float32, False, 0, 0),
    "sphere_filtered": ("sphere", np.float32, True, 0, 0),
    "sphere_f64": ("sphere", np.float64, False, 0, 0),
    "cylinder": ("cylinder", np.float32, False, 0, 1),
    "cylinder_filtered": ("cylinder", np.float32, True, 0, 1),
    "curve": ("curve", np.float32, False, 4, 1),
    "curve_s8_filtered": ("curve", np.float32, True, 8, 1),
}
RANGE = (20, 170)


def _prims(kind, dt):
    """Seeded NumPy fields of 200 prims scattered in [-2, 2]^3."""
    rng = np.random.default_rng({"sphere": 4, "cylinder": 3, "curve": 5}[kind])
    if kind == "sphere":
        return (rng.uniform(-2, 2, (200, 3)).astype(dt),
                rng.uniform(0.05, 0.3, 200).astype(dt))
    if kind == "cylinder":
        p0 = rng.uniform(-2, 2, (200, 3))
        p1 = p0 + rng.normal(0, 0.5, (200, 3))
        return (p0.astype(dt), p1.astype(dt),
                rng.uniform(0.02, 0.1, 200).astype(dt),
                rng.uniform(0.02, 0.1, 200).astype(dt))
    c = rng.uniform(-2, 2, (200, 1, 3))
    pts = c + np.cumsum(rng.normal(0, 0.25, (200, 4, 3)), axis=1)
    return pts.astype(dt), rng.uniform(0.03, 0.12, (200, 4)).astype(dt)


def _rays(dt, n=256, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-4, 4, (n, 3))
    d = -org + rng.uniform(-1, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org.astype(dt), d.astype(dt)


def _bvh(kind, prims):
    return {"sphere": sphere.build_sphere_bvh,
            "cylinder": cylinder.build_cylinder_bvh,
            "curve": curve.build_curve_bvh}[kind](prims)[0]


def _jax_side(inp, out):
    """A child: the JAX package's traversals of its cases, jitted."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import nanort_tpu as jnt
    from nanort_tpu.ops import curve as jc
    from nanort_tpu.ops import cylinder as jcy
    from nanort_tpu.ops import sphere as js
    from nanort_tpu.traverse.stack import traverse

    z = dict(np.load(inp))
    child = int(z["child"])
    res = {}
    for name, (kind, dt, filtered, S, c) in CASES.items():
        if c != child:
            continue
        fields = [jnp.asarray(x) for x in _prims(kind, dt)]
        prims, prep, isect, build = {
            "sphere": (js.Spheres, js.sphere_prepare, js.sphere_intersect,
                       js.build_sphere_bvh),
            "cylinder": (jcy.Cylinders, jcy.cylinder_prepare,
                         jcy.cylinder_intersect, jcy.build_cylinder_bvh),
            "curve": (jc.Curves, jc.curve_prepare,
                      jc.make_curve_intersect(S), jc.build_curve_bvh),
        }[kind]
        prims = prims(*fields)
        bvh, _ = build(prims)
        rays = jnt.make_rays(*(jnp.asarray(x) for x in _rays(dt)))
        opts = jnt.BVHTraceOptions(prim_ids_range=RANGE) if filtered \
            else jnt.BVHTraceOptions()
        skip = jnp.asarray(z[f"{name}/skip"]) if filtered else None
        h = traverse(bvh, prims, rays, opts, prepare_fn=prep,
                     intersect_fn=isect, max_leaf=4, skip_prim_id=skip)
        if kind == "sphere":
            h = js.sphere_post(prims, rays, h)
        for k in ("t", "u", "v", "prim_id"):
            res[f"{name}/{k}"] = np.asarray(getattr(h, k))
    np.savez(out, **res)


def _port(name, skip=None):
    kind, dt, filtered, S, _ = CASES[name]
    fields = _prims(kind, dt)
    prims = {"sphere": interop.spheres_from_numpy,
             "cylinder": interop.cylinders_from_numpy,
             "curve": interop.curves_from_numpy}[kind](*fields, device="cpu")
    bvh = _bvh(kind, prims)
    org, d = _rays(dt)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    opts = nt.BVHTraceOptions(prim_ids_range=RANGE) if filtered \
        else nt.BVHTraceOptions()
    kw = dict(options=opts, skip_prim_id=skip)
    if kind == "sphere":
        return bvh, sphere.traverse_spheres(bvh, prims, rays, **kw)
    if kind == "cylinder":
        return bvh, cylinder.traverse_cylinders(bvh, prims, rays, **kw)
    return bvh, curve.traverse_curves(bvh, prims, rays, num_subdivisions=S,
                                      **kw)


@pytest.fixture(scope="module")
def traced():
    """name -> (port BVH, port hits, the JAX package's records)."""
    port, inputs = {}, [{"child": np.asarray(c)} for c in range(2)]
    for name, (kind, dt, filtered, S, c) in CASES.items():
        skip = None
        if filtered:
            # every other ray skips the prim its unfiltered pass hit
            first = _port(name)[1].prim_id.clone()
            first[1::2] = nt.INVALID_PRIM_ID
            skip = first
            inputs[c][f"{name}/skip"] = skip.numpy().astype(np.uint32)
        port[name] = _port(name, skip)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        parts = list(pool.map(lambda x: run_without_fma(__file__, x), inputs))
    ref = {k: v for p in parts for k, v in p.items()}
    return {name: port[name] + ({k[len(name) + 1:]: v for k, v in ref.items()
                                 if k.startswith(name + "/")},)
            for name in CASES}


def _f64_ulps(a, b):
    ia = np.asarray(a, np.float64).view(np.int64)
    ib = np.asarray(b, np.float64).view(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(traced, name):
    _, got, want = traced[name]
    wh = nt.Hits(*(want[k] for k in ("t", "u", "v", "prim_id")))
    if CASES[name][1] == np.float64:
        # compare_hits counts float32 ulps: the same rules, in float64
        assert got.t.dtype == torch.float64
        gp, wp = got.prim_id.numpy(), wh.prim_id.astype(np.int64)
        gt = got.t.numpy()
        hit = wp != nt.INVALID_PRIM_ID
        np.testing.assert_array_equal(gp != nt.INVALID_PRIM_ID, hit)
        assert ((gp == wp) | (gt == wh.t))[hit].all()
        assert _f64_ulps(gt[hit], wh.t[hit]) <= 4
        same = hit & (gp == wp)
        for a, b in ((got.u, wh.u), (got.v, wh.v)):
            assert np.abs(a.numpy()[same] - b[same]).max() <= UV_ATOL
        return
    c = compare_hits(got, wh, uv_atol=UV_ATOL)
    assert c["ok"], c
    assert 20 < c["hits"] < c["n"], c  # hits and misses both exercised
    if CASES[name][2]:
        pid = got.prim_id[got.hit]
        assert bool(((pid >= RANGE[0]) & (pid < RANGE[1])).all())


def test_sphere_analytic():
    s = sphere.Spheres(torch.zeros(1, 3), torch.ones(1))
    bvh, _ = sphere.build_sphere_bvh(s)
    rays = nt.make_rays(torch.tensor([[0, 0, 5], [0, 2, 5], [0, 0, 0.5]]),
                        torch.tensor([[0, 0, -1.0]] * 3))
    h = sphere.traverse_spheres(bvh, s, rays)
    assert h.hit.tolist() == [True, False, True]
    assert h.t[0] == 4.0 and h.t[2] == 1.5  # inside: the far shell
    assert abs(float(h.u[0]) - 0.5) <= 1e-6 and abs(float(h.v[0]) - 0.5) \
        <= 1e-6  # the +z equator
    rays = nt.make_rays(torch.tensor([[0, 5.0, 0]]),
                        torch.tensor([[0, -1.0, 0]]))
    assert float(sphere.traverse_spheres(bvh, s, rays).v[0]) <= 1e-3
    rays = nt.make_rays(torch.tensor([[0, 0, 5.0]]),
                        torch.tensor([[0, 0, -1.0]]), min_t=4.5)
    assert float(sphere.traverse_spheres(bvh, s, rays).t[0]) == 6.0


def test_cylinder_analytic():
    c = cylinder.Cylinders(torch.tensor([[0.0, -1.0, 0.0]]),
                           torch.tensor([[0.0, 1.0, 0.0]]),
                           torch.tensor([0.5]), torch.tensor([0.5]))
    bvh, _ = cylinder.build_cylinder_bvh(c)
    rays = nt.make_rays(torch.tensor([[0, 0, 5], [0, 2, 5], [0.6, 0, 5]]),
                        torch.tensor([[0, 0, -1.0]] * 3))
    h = cylinder.traverse_cylinders(bvh, c, rays)
    assert h.hit.tolist() == [True, False, False]
    assert abs(float(h.t[0]) - 4.5) <= 1e-5 and abs(float(h.v[0]) - 0.5) \
        <= 1e-5  # the body, halfway up
    rays = nt.make_rays(torch.tensor([[0.2, 5, 0]]),
                        torch.tensor([[0, -1.0, 0]]))
    h = cylinder.traverse_cylinders(bvh, c, rays)  # the top cap
    assert abs(float(h.t[0]) - 4.0) <= 1e-5
    assert abs(float(h.u[0]) - 0.2) <= 1e-5 and float(h.v[0]) == 1.0


def test_curve_analytic():
    pts = torch.tensor([[[-1, 0, 0], [-0.33, 0, 0], [0.33, 0, 0],
                         [1, 0, 0]]])
    c = curve.Curves(pts, torch.full((1, 4), 0.2))
    bvh, _ = curve.build_curve_bvh(c)
    xs = torch.linspace(-0.9, 0.9, 7)
    org = torch.stack([xs, torch.zeros(7), torch.full((7,), 5.0)], -1)
    h = curve.traverse_curves(bvh, c, nt.make_rays(
        org, torch.tensor([[0, 0, -1.0]] * 7)))
    assert bool(h.hit.all()) and bool((h.u.diff() > 0).all())
    assert float((h.u - (xs + 1) / 2).abs().max()) <= 0.15
    assert float((h.t - 5.0).abs().max()) <= 0.15
    bent = curve.Curves(torch.tensor([[[-1, 0, 0], [-0.5, 0.8, 0],
                                       [0.5, 0.8, 0], [1, 0, 0]]]),
                        torch.full((1, 4), 0.1))
    bvh, _ = curve.build_curve_bvh(bent)
    h = curve.traverse_curves(bvh, bent, nt.make_rays(
        torch.tensor([[0, 0.6, 5], [0, 0.0, 5]]),
        torch.tensor([[0, 0, -1.0]] * 2)), num_subdivisions=8)
    assert h.hit.tolist() == [True, False]  # the apex, not the chord


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
