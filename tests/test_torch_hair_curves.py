"""PyTorch port, hair as cubic Bezier curves on K1, on seeded random curves
at small size on the CPU: the curve leaf rows of ``build/bvh8.py``, K1's
plain version (``traverse/packet.py::_traverse_reference`` with its curve
leaf, which ``traverse_bvh8`` runs on CPU tensors), the kernel's own curve
leaf (``csrc/packet_traverse.cu`` built with g++ against the CUDA mock,
``testing.build_with_cuda_mock``, each ray walked by its
``begin``/``step``/``finish``), the stack engine (``ops/curve.py::
traverse_curves``, held to the JAX package by
``tests/test_torch_custom_prims.py``), the benchmark's float64 reference
(``rtbench/ref/curves.py``) and ``models/hair.py::render_curve_aovs``.

Tolerances: the kernel and its plain version share the tables, the child
order and ``ops.curve.curve_hit``'s arithmetic (g++ with
-ffp-contract=off as nvcc with --fmad=false), so their records are equal
bit for bit. The stack engine walks another tree with the same test, and
tests a leaf's curves against the t it entered the leaf with where K1
tests them in turn against the running best: equal hit masks, t, u and v
bit for bit, the same curve but between hits at exactly equal t (K1
keeps the first of a leaf's, the stack engine the last). Against the
float64 reference, ``ref.curves.records_off``'s tolerances, the
benchmark's own.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.models.hair import render_curve_aovs
from nanort_tpu_torch.ops import curve, sphere
from nanort_tpu_torch.testing import (build_with_cuda_mock, compare_hits,
                                      wide_table_report)
from nanort_tpu_torch.traverse import packet
from nanort_tpu_torch.utils import trace
from rtbench.ref.curves import RefCurves, records_off

torch.set_num_threads(1)

N_CURVES = 500
N_DUP = 20  # copies of earlier curves at new ids: hits at exactly equal t
RANGE = (100, 400)


def _curves(seed=7):
    """Wavy random curves (random walks of their control points in
    [-1, 1]^3, radii 0.02-0.08), the last ``N_DUP`` copies of the first
    ones."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1.0, 1.0, (N_CURVES, 1, 3))
    pts = p0 + np.cumsum(rng.normal(scale=0.2, size=(N_CURVES, 4, 3)), 1)
    rad = rng.uniform(0.02, 0.08, (N_CURVES, 4))
    pts[-N_DUP:], rad[-N_DUP:] = pts[:N_DUP], rad[:N_DUP]
    return curve.Curves(torch.from_numpy(pts.astype(np.float32)),
                        torch.from_numpy(rad.astype(np.float32)))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _bez(p, u):
    s = 1.0 - u
    return (s ** 3 * p[:, 0] + 3 * s * s * u * p[:, 1]
            + 3 * s * u * u * p[:, 2] + u ** 3 * p[:, 3])


def _on_spans(p, rng):
    """A random point on each curve's 4 spans (the polyline between its
    points at s / 4, which the test traces)."""
    n = len(p)
    s = rng.integers(0, 4, (n, 1))
    a = rng.uniform(0, 1, (n, 1))
    return (1 - a) * _bez(p, s / 4) + a * _bez(p, (s + 1) / 4)


def _rays(c, seed=8):
    """Random rays, rays aimed at points of curves (the duplicated ones
    among them), vertical rays, and rays whose min_t lies a little past
    an aimed-at curve: ``(rays, kinds)``, ``kinds`` a name a ray."""
    rng = np.random.default_rng(seed)
    p = c.points.numpy().astype(np.float64)
    orgs, dirs, mins, kinds = [], [], [], []

    def add(o, d, kind, min_t=None):
        orgs.append(o)
        dirs.append(_unit(d))
        mins.append(np.zeros(len(o)) if min_t is None else min_t)
        kinds.extend([kind] * len(o))

    o = rng.uniform(-3.0, 3.0, (300, 3))
    add(o, rng.uniform(-1, 1, (300, 3)) - o, "random")
    k = rng.integers(0, N_CURVES, 500)
    tgt = _on_spans(p[k], rng)
    o = tgt + 3.0 * _unit(rng.normal(size=(500, 3)))
    add(o, tgt - o, "aimed")
    k = np.arange(N_DUP)
    tgt = _on_spans(p[k], rng)
    o = tgt + 3.0 * _unit(rng.normal(size=(N_DUP, 3)))
    add(o, tgt - o, "tie")
    k = rng.integers(0, N_CURVES, 100)
    up = rng.choice([-1.0, 1.0], (100, 1))
    add(_on_spans(p[k], rng) + 4.0 * up * [0.0, 1.0, 0.0],
        -up * [0.0, 1.0, 0.0], "vertical")
    k = rng.integers(0, N_CURVES, 150)
    tgt = _on_spans(p[k], rng)
    o = tgt + 3.0 * _unit(rng.normal(size=(150, 3)))
    add(o, tgt - o, "min_t", np.full(150, 3.0))
    rays = nt.make_rays(
        torch.from_numpy(np.concatenate(orgs).astype(np.float32)),
        torch.from_numpy(np.concatenate(dirs).astype(np.float32)),
        min_t=torch.from_numpy(np.concatenate(mins).astype(np.float32)))
    return rays, np.asarray(kinds)


@pytest.fixture(scope="module")
def hair():
    c = _curves()
    bvh = {n: curve.build_curve_bvh(c, nt.BVHBuildOptions(
        min_leaf_primitives=n, max_leaf_primitives=n))[0] for n in (6, 1)}
    tabs = {(w, n): collapse_bvh8(bvh[n], width=w, curves=c).to("cpu")
            for w in (8, 16) for n in (6, 1)}
    rays, kinds = _rays(c)
    return c, bvh, tabs, rays, kinds


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("leaf", [6, 1])
@pytest.mark.parametrize("width", [8, 16])
def test_curve_rows_hold_every_curve_once(hair, width, leaf):
    c, _, tabs, _, _ = hair
    scene = tabs[width, leaf]
    assert scene.leaf_kind == "curve" and scene.max_leaf <= leaf
    report = wide_table_report(scene, N_CURVES)
    assert report["ok"], report
    nodes = torch.as_tensor(scene.nodes)
    meta_l, cnt_l = (96, 112) if width == 16 else (64, 72)
    meta = nodes[:, meta_l:meta_l + width].long()
    cnt = nodes[:, cnt_l:cnt_l + width].long() & 15
    leaf_slot = meta < 0
    leafs = torch.as_tensor(scene.leafs)
    ids, rows = [], []
    for row, n in zip((-meta[leaf_slot] - 1).tolist(),
                      cnt[leaf_slot].tolist()):
        ids.append(leafs[row, 108:108 + n].long())
        rows.append(leafs[row, :16 * n].view(n, 4, 4))
    ids, rows = torch.cat(ids), torch.cat(rows)
    assert torch.equal(ids.sort().values, torch.arange(N_CURVES))
    # four float4s a curve: p0 r0, p1 0, p2 0, p3 r1
    assert torch.equal(rows[..., :3], c.points[ids])
    assert torch.equal(rows[:, 0, 3], c.radii[ids, 0])
    assert torch.equal(rows[:, 3, 3], c.radii[ids, 3])
    assert not bool(rows[:, 1:3, 3].any())


def test_leaf_kind_travels_and_routes(hair):
    c, bvh, tabs, rays, _ = hair
    assert collapse_bvh8(bvh[6], width=8, curves=c).to("cpu").leaf_kind \
        == "curve"
    with pytest.raises(ValueError, match="woop"):
        collapse_bvh8(bvh[6], width=8, woop=True, curves=c)
    s = sphere.Spheres(c.points[:, 0], c.radii[:, 0])
    with pytest.raises(ValueError, match="or curves"):
        collapse_bvh8(bvh[6], width=8, spheres=s, curves=c)
    # a row holds at most 6 curves (16 lanes each below the ids at 108)
    big, _ = curve.build_curve_bvh(c, nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    with pytest.raises(ValueError, match="<= 6 curves"):
        collapse_bvh8(big, width=8, curves=c)
    for kw in (dict(intersector="woop"), dict(interleave=2),
               dict(_flag_zero_edges=True)):
        with pytest.raises(ValueError, match="curve scene"):
            packet.traverse_bvh8(tabs[8, 6], rays, **kw)
    # the K1 route takes curve tables and its own 4 spans only
    with pytest.raises(ValueError, match="4 spans"):
        curve.traverse_curves(None, c, rays, num_subdivisions=8,
                              scene8=tabs[8, 6])
    sb, _ = sphere.build_sphere_bvh(s)
    with pytest.raises(ValueError, match="no curves"):
        curve.traverse_curves(None, c, rays, scene8=collapse_bvh8(
            sb, width=8, spheres=s))


# ------------------------------------- K1's plain version, stack engine

FILTERS = {
    "plain": {},
    "range": dict(options=nt.BVHTraceOptions(prim_ids_range=RANGE)),
}


@pytest.mark.parametrize("filt", list(FILTERS) + ["skip"])
@pytest.mark.parametrize("leaf", [6, 1])
@pytest.mark.parametrize("width", [8, 16])
def test_plain_k1_matches_stack_engine(hair, width, leaf, filt):
    c, bvh, tabs, rays, kinds = hair
    kw = dict(FILTERS.get(filt, {}))
    if filt == "skip":
        first = packet.traverse_bvh8(tabs[width, leaf], rays).prim_id.clone()
        first[1::2] = nt.INVALID_PRIM_ID
        kw["skip_prim_id"] = first
    got = curve.traverse_curves(None, c, rays, scene8=tabs[width, leaf],
                                **kw)
    want = curve.traverse_curves(bvh[leaf], c, rays, max_leaf=None, **kw)
    cmp = compare_hits(got, want, t_ulps=0, uv_atol=0.0)
    assert cmp["ok"], cmp
    assert torch.equal(got.t, want.t)
    for kind in ("random", "aimed", "tie", "min_t"):
        sel = torch.from_numpy(kinds == kind)
        assert bool(got.hit[sel].any()), kind
    # the degenerate frame looks away from the ray (below)
    assert not bool(got.hit[torch.from_numpy(kinds == "vertical")].any())
    if filt == "range":
        pid = got.prim_id[got.hit]
        assert bool(((pid >= RANGE[0]) & (pid < RANGE[1])).all())
    if filt == "plain":
        # the ties are real: a curve and its copy give "tie" rays their t
        tie = torch.from_numpy(kinds == "tie") & got.hit
        pid = got.prim_id[tie]
        assert int(((pid < N_DUP) | (pid >= N_CURVES - N_DUP)).sum()) > 5


def _one_leaf(points, radii):
    """A scene of the given curves in one leaf row."""
    c = curve.Curves(torch.tensor(points, dtype=torch.float32),
                     torch.tensor(radii, dtype=torch.float32))
    n = c.num_prims
    bvh, _ = curve.build_curve_bvh(c, nt.BVHBuildOptions(
        min_leaf_primitives=n, max_leaf_primitives=n))
    return c, bvh, collapse_bvh8(bvh, width=8, curves=c)


def _all_engines(lib, c, bvh, s8, rays, **kw):
    """The records of K1's plain version, the emulated kernel and the
    stack engine, after checking the first two equal bit for bit."""
    plain = packet.traverse_bvh8(s8, rays, **kw)
    for a, b in zip(_emulate(lib, s8, rays, **kw), plain):
        assert torch.equal(a, b)
    if kw.get("occlusion"):  # the stack engine has no any-hit mode
        return plain, None
    return plain, curve.traverse_curves(bvh, c, rays, max_leaf=None, **kw)


def test_min_t_cuts_a_curve(lib):
    # an S-curve in the x-z plane crossing the z axis at three z; a ray
    # along +z on the axis hits its first crossing, and with min_t past
    # that crossing misses the curve, though later spans cross after it
    pts = [[[-1.0, 0.0, 0.0], [3.0, 0.0, 1.0], [-3.0, 0.0, 2.0],
            [1.0, 0.0, 3.0]]]
    c, bvh, s8 = _one_leaf(pts, [[0.1, 0.1, 0.1, 0.1]])
    org = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    rays = nt.make_rays(org, d, min_t=torch.tensor([0.0, 1.6, 4.5]))
    plain, stack = _all_engines(lib, c, bvh, s8, rays)
    assert compare_hits(plain, stack, t_ulps=0, uv_atol=0.0)["ok"]
    assert plain.hit.tolist() == [True, False, False]
    assert 1.0 < float(plain.t[0]) < 1.6
    # its spans do cross the axis after 1.6: a curve of the later spans
    # alone is hit there
    later = curve.Curves(c.points, c.radii)
    ctx = curve.curve_prepare(later, rays)
    valid, t, _, _ = curve.make_curve_intersect(4)(
        later, ctx, torch.zeros((3, 1), dtype=torch.long),
        torch.full((3,), 1e30))
    assert not bool(valid[1, 0]) and float(t[1, 0]) < 1.6


def test_vertical_ray_takes_the_degenerate_frame(lib):
    # a ray whose x and z are 0 takes _z_align's dxz == 0 branch (upstream
    # GetZAlign's, as the JAX package ports it), whose z axis points
    # against the ray: every curve lies behind it, and it misses; K1 keeps
    # that. Tilted by 1e-3, the same ray takes the general frame and hits.
    pts = [[[-1.0, 0.5, 0.0], [-0.3, 0.5, 0.2], [0.3, 0.5, -0.2],
            [1.0, 0.5, 0.0]]]
    c, bvh, s8 = _one_leaf(pts, [[0.05] * 4])
    org = torch.tensor([[0.0, -1.0, 0.0], [0.0, 3.0, 0.0]] * 2)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                      [1e-3, 1.0, 0.0], [1e-3, -1.0, 0.0]])
    rays = nt.make_rays(org, d / d.norm(dim=1, keepdim=True))
    rot, _ = curve._z_align(rays.org, rays.dir)
    assert torch.equal(rot[0], torch.tensor([[1.0, 0, 0], [0, 0, -1],
                                             [0, 1, 0]]))
    assert torch.equal(rot[1], torch.tensor([[1.0, 0, 0], [0, 0, 1],
                                             [0, -1, 0]]))
    plain, stack = _all_engines(lib, c, bvh, s8, rays)
    assert compare_hits(plain, stack, t_ulps=0, uv_atol=0.0)["ok"]
    assert plain.hit.tolist() == [False, False, True, True]
    assert torch.allclose(plain.t[2:], torch.tensor([1.5, 2.5]), atol=1e-5)
    # the float64 reference takes the same frames
    ref = RefCurves(c.points.numpy(), c.radii.numpy(), "cpu")
    _, _, _, rp = ref.closest(rays.org, rays.dir, torch.zeros(4,
                              dtype=torch.float64),
                              torch.full((4,), 1e30, dtype=torch.float64))
    assert rp.tolist() == [-1, -1, 0, 0]


def test_near_reject(lib):
    # a curve whose every projected z lies below 2 max(r0, r1) of the
    # origin is rejected (main.cc:676-680), though the ray passes through
    # it; from farther back the same ray hits it
    pts = [[[-0.05, 0.0, 0.05], [-0.02, 0.0, 0.1], [0.02, 0.0, 0.1],
            [0.05, 0.0, 0.12]]]
    c, bvh, s8 = _one_leaf(pts, [[0.1, 0.1, 0.1, 0.1]])
    rays = nt.make_rays(torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0]]),
                        torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]))
    plain, stack = _all_engines(lib, c, bvh, s8, rays)
    assert compare_hits(plain, stack, t_ulps=0, uv_atol=0.0)["ok"]
    assert plain.hit.tolist() == [False, True]


def test_sequential_leaf_on_overlapping_curves(lib):
    # six curves in one leaf row, crossing each other and a bundle of
    # rays, two of them exact copies (hits at equal t): K1 tests them in
    # turn against the running best, the stack engine each against the
    # leaf's entry t, and the records agree
    rng = np.random.default_rng(12)
    base = np.array([[-1.0, 0.0, 0.0], [-0.3, 0.4, 0.1], [0.3, -0.4, -0.1],
                     [1.0, 0.0, 0.0]])
    pts = [base + rng.normal(scale=0.05, size=(4, 3)) for _ in range(4)]
    pts += [pts[1], pts[2]]
    rad = rng.uniform(0.05, 0.1, (6, 4))
    rad[4], rad[5] = rad[1], rad[2]
    c, bvh, s8 = _one_leaf(np.stack(pts), rad)
    assert s8.num_leaf_rows == 1 and s8.max_leaf == 6
    k = rng.integers(0, 4, 400)
    tgt = _on_spans(np.stack(pts)[k], rng)
    o = tgt + [0.0, 0.0, -3.0] + rng.normal(scale=0.1, size=(400, 3))
    d = _unit(tgt - o)
    rays = nt.make_rays(torch.from_numpy(o.astype(np.float32)),
                        torch.from_numpy(d.astype(np.float32)))
    for kw in ({}, dict(occlusion=True)):
        plain, stack = _all_engines(lib, c, bvh, s8, rays, **kw)
        assert bool(plain.hit.float().mean() > 0.3)
        if not kw:
            cmp = compare_hits(plain, stack, t_ulps=0, uv_atol=0.0)
            assert cmp["ok"], cmp
            # the copies tie: K1 keeps the first of the leaf, the stack
            # engine the last
            assert cmp["ties"] > 0
    # in turn: the curve K1 keeps is the least t of the curves tested
    # alone against the ray's max_t, the first of equal ones
    ctx = curve.curve_prepare(c, rays)
    ids = torch.arange(6).expand(400, 6)
    valid, t, _, _ = curve.make_curve_intersect(4)(c, ctx, ids,
                                                   rays.max_t)
    tm = torch.where(valid, t, math.inf)
    best = tm.amin(1)
    plain = packet.traverse_bvh8(s8, rays)
    hit = plain.hit
    assert torch.equal(plain.t[hit], best[hit])
    first = torch.where(tm == best[:, None], torch.arange(6), 6).amin(1)
    leaf_order = torch.as_tensor(s8.leafs)[0, 108:114].long()
    assert torch.equal(plain.prim_id[hit],
                       leaf_order[torch.where(
                           tm[:, leaf_order] == best[:, None],
                           torch.arange(6), 6).amin(1)][hit])
    assert bool((first[hit] < 6).all())


# ------------------------------------------- the kernel's own curve leaf

HARNESS = r"""
uint3 threadIdx, blockIdx;
namespace {
template <int W, bool kCounts, bool kRoots>
void walk_curves(const Params& p) {
  int stack[kStackCap];
  for (long long i = 0; i < p.n_rays; ++i) {
    Walk w;
    begin<kRoots, kCurve>(p, i, w);
    while (w.e != kNone) step<W, kCurve, kCounts, false>(p, w, stack);
    finish<kCounts, false>(p, i, w);
  }
}
template <int W>
void pick(const Params& p, int counts) {
  if (counts) return walk_curves<W, true, true>(p);
  if (p.roots) return walk_curves<W, false, true>(p);
  walk_curves<W, false, false>(p);
}
}  // namespace

extern "C" void emulate_curves(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, const int* roots,
    float* t_out, float* u_out, float* v_out, long long* pid_out,
    unsigned long long* scratch, long long n_rays, long long packet,
    int width, int stack_size, int occlusion, int use_range, int range_lo,
    int range_hi, int counts) {
  const Params p{nodes, leafs, org, dir, min_t, max_t, skip, roots, t_out,
                 u_out, v_out, pid_out, nullptr, scratch, scratch + 1,
                 n_rays, packet, stack_size, occlusion, 0, 0, use_range,
                 range_lo, range_hi, 1};
  if (width == 16) pick<16>(p, counts); else pick<8>(p, counts);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("packet_traverse.cu", HARNESS,
                               tmp_path_factory.mktemp("k1_curves"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.emulate_curves.argtypes = [P] * 13 + [L, L] + [I] * 7
    lib.emulate_curves.restype = None
    return lib


def _emulate(lib, scene, rays, options=nt.BVHTraceOptions(),
             skip_prim_id=None, occlusion=False, sub=32, packet_roots=None,
             debug_counts=False):
    n = rays.org.shape[0]
    lo, hi = options.prim_ids_range
    skip = None if skip_prim_id is None else skip_prim_id.to(torch.int32)
    roots = (None if packet_roots is None
             else packet_roots.to(torch.int32).contiguous())
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    pid = torch.empty(n, dtype=torch.int64)
    scratch = torch.zeros(2, dtype=torch.int64)

    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    lib.emulate_curves(
        ptr(torch.as_tensor(scene.nodes)), ptr(torch.as_tensor(scene.leafs)),
        ptr(rays.org), ptr(rays.dir), ptr(rays.min_t), ptr(rays.max_t),
        ptr(skip), ptr(roots), ptr(t), ptr(u), ptr(v), ptr(pid),
        ptr(scratch), n, sub * packet.LANES, scene.width,
        packet.stack_slots(scene), int(occlusion),
        int((lo, hi) != (0, packet.PRIM_RANGE_MAX)), int(lo), int(hi),
        int(debug_counts))
    assert int(scratch[1]) == 0
    return [t, u, v, pid]


def _with_dead(rays):
    """``rays`` with degenerate rays among them (NaN origin, zero, inf
    and huge directions), which every engine must miss."""
    org, d = rays.org.clone(), rays.dir.clone()
    org[0::10, 0] = float("nan")
    d[2::10] = 0.0
    d[4::10, 1] = float("inf")
    d[6::10, 2] = -3.1e38
    return nt.make_rays(org, d, min_t=rays.min_t)


MODES = {
    "closest": {}, "any_hit": dict(occlusion=True), "range": FILTERS["range"],
    "counts": dict(debug_counts=True),
    "counts_any_hit": dict(debug_counts=True, occlusion=True),
}


@pytest.mark.parametrize("mode", list(MODES) + ["skip", "roots"])
@pytest.mark.parametrize("width", [8, 16])
def test_emulated_curve_kernel_matches_plain(lib, hair, width, mode):
    _, _, tabs, rays, _ = hair
    scene = tabs[width, 6]
    rays = _with_dead(rays)
    kw = dict(MODES.get(mode, {}))
    if mode == "skip":
        first = packet.traverse_bvh8(scene, rays).prim_id.clone()
        first[1::2] = nt.INVALID_PRIM_ID
        kw["skip_prim_id"] = first
    if mode == "roots":
        n_pk = -(-rays.org.shape[0] // (2 * packet.LANES))
        kw.update(sub=2, packet_roots=torch.zeros(n_pk, dtype=torch.int64))
    got = _emulate(lib, scene, rays, **kw)
    want = packet.traverse_bvh8(scene, rays, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(want.prim_id.ne(nt.INVALID_PRIM_ID).any())


# ------------------------------------------------ render_curve_aovs

def _frame(h, w, eye=(0.3, 0.8, 3.6)):
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    cam = look_at(eye, (0.0, 0.0, 0.0), width=w, height=h, fov=45.0,
                  device="cpu")
    return pinhole_rays(cam)


def test_render_curve_aovs_match_the_reference(hair):
    c, bvh, tabs, _, _ = hair
    rays = _frame(24, 40)
    aovs, hits = render_curve_aovs(c, rays, scene8=tabs[8, 1])
    stack, shits = render_curve_aovs(c, rays, bvh=bvh[1])
    assert compare_hits(hits, shits, t_ulps=0, uv_atol=0.0)["ok"]
    same = hits.prim_id == shits.prim_id
    for k in aovs:
        assert torch.equal(aovs[k][same], stack[k][same]), k
    hit = hits.hit
    assert 0.1 < float(hit.float().mean()) < 0.95
    org, d = rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3)
    n = org.shape[0]
    ref = RefCurves(c.points.numpy(), c.radii.numpy(), "cpu", leaf=16)
    prim = torch.where(hits.hit, hits.prim_id, -1).reshape(-1)
    tmin = torch.zeros(n, dtype=torch.float64)
    tmax = torch.full((n,), 3.0e38, dtype=torch.float64)
    off = records_off(ref, org, d, tmin, tmax, hits.t.reshape(-1),
                      hits.u.reshape(-1), hits.v.reshape(-1), prim,
                      aovs["tangent"].reshape(-1, 3),
                      position=aovs["position"].reshape(-1, 3),
                      depth=aovs["depth"].reshape(-1),
                      rgb=aovs["rgb"].reshape(-1, 3))
    assert not bool(off.any())
    # the reference's own closest hits: the same curves at the same t
    rt, ru, rv, rp = ref.closest(org, d, tmin, tmax)
    h = hit.reshape(-1)
    assert torch.equal(rp >= 0, h)
    assert float((rt[h] - hits.t.reshape(-1)[h].double()).abs().max()) \
        < 1e-5
    assert float((rv[h] - hits.v.reshape(-1)[h].double()).abs().max()) \
        < 1e-5
    tan = aovs["tangent"].reshape(-1, 3)[h].double()
    assert float((tan.norm(dim=1) - 1.0).abs().max()) < 1e-6
    assert torch.equal(aovs["rgb"], torch.where(hit[..., None],
                                                0.5 * aovs["tangent"] + 0.5,
                                                0.0))
    for k in ("rgb", "tangent", "position", "depth", "texcoord"):
        assert not bool(aovs[k][~hit].any()), k
    # the control: the reference in bfloat16 in the program's place
    low = RefCurves(c.points.numpy(), c.radii.numpy(), "cpu",
                    torch.bfloat16, leaf=16)
    lt, lu, lv, lp = low.closest(org, d, tmin, tmax)
    ltan = low.tangent(lp, lu)
    bad = records_off(ref, org, d, tmin, tmax, lt, lu, lv, lp, ltan)
    assert float(bad.float().mean()) > 0.05


# --------------------------------------------------- launch key, spans

def _profiled(fn):
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    names = [(r.name, r.parent) for r in trace.records()]
    trace.reset()
    return out, names


def test_curve_launch_key_and_spans(hair, monkeypatch):
    c, _, tabs, _, _ = hair
    assert packet._launch_key(False, False, False, False, 1, False, True) \
        == "packet_traverse[curve]"
    assert packet._launch_key(False, True, False, False, 1, False, True) \
        == "packet_traverse[roots]"
    assert "packet_traverse[curve]" in packet.LAUNCH_KEYS
    assert "packet_traverse[curve]" in trace.launches()
    assert "curve.post" in trace.STREAMED
    rays = _frame(12, 20)
    calls, inner = [], packet.traverse_bvh8

    def spy(scene, r, *a, **kw):
        calls.append(tuple(r.batch_shape))
        return inner(scene, r, *a, **kw)

    monkeypatch.setattr(packet, "traverse_bvh8", spy)
    _, names = _profiled(lambda: render_curve_aovs(c, rays,
                                                   scene8=tabs[8, 1]))
    # one K1 call over the (12, 20) rays as they lie
    assert calls == [(12, 20)]
    assert names == [("k1", "render_curve_aovs"),
                     ("curve.post", "render_curve_aovs"),
                     ("render_curve_aovs", None)]
    # the curve build and its row collapse are set-up spans
    trace.reset()
    bvh, _ = curve.build_curve_bvh(c)
    collapse_bvh8(bvh, width=8, curves=c)
    totals = trace.totals()
    assert totals["build.sah"] > 0 and totals["build.collapse"] > 0
    trace.reset()
