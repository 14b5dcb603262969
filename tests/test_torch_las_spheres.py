"""PyTorch port, the LAS viewer's spheres on K1, on seeded random clouds at
small size on the CPU: the sphere leaf rows of ``build/bvh8.py``, K1's
plain version (``traverse/packet.py::_traverse_reference`` with its
sphere leaf, which ``traverse_bvh8`` runs on CPU tensors), the kernel's
own sphere leaf (``csrc/packet_traverse.cu`` built with g++ against the
CUDA mock, ``testing.build_with_cuda_mock``, each ray walked by its
``begin``/``step``/``finish``), the stack engine (``ops/sphere.py::
traverse_spheres(..., precise=True)``), the benchmark's float64 reference (``rtbench/ref/
spheres.py``), ``models/pointcloud.py::render_sphere_aovs`` and the padded
pixel tiling of ``traverse/packet.py::tile_image_rays``.

Tolerances: the kernel and its plain version share the tables, the child
order and ``ops.sphere.sphere_hit``'s arithmetic (g++ with
-ffp-contract=off as nvcc with --fmad=false), so their records are equal
bit for bit. The stack engine walks another tree with the same test:
equal hit masks, t bit for bit, the same sphere but between hits at
exactly equal t, and PostTraversal's u and v within 1e-6 (equal where the
sphere is). Against the float64 reference, ``ref.spheres.records_off``'s
tolerances, the benchmark's own (in world units, T_TOL x (t + 1) over
the cosine of the hit).
"""

import ctypes

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import make_cornell_box, make_uv_sphere
from nanort_tpu_torch.models import objrender
from nanort_tpu_torch.models.pointcloud import render_sphere_aovs
from nanort_tpu_torch.ops import sphere
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import build_with_cuda_mock, compare_hits
from nanort_tpu_torch.traverse import packet
from nanort_tpu_torch.traverse.ray_sort import traverse_bvh8_sorted
from nanort_tpu_torch.utils import trace
from rtbench.ref.spheres import RefSpheres, records_off

torch.set_num_threads(1)

N_SPHERES = 600
N_ZERO = 20  # spheres of radius 0
N_DUP = 20  # copies of earlier spheres at new ids: hits at exactly equal t
RANGE = (100, 500)


def _cloud(seed=7):
    """Heavily overlapping spheres (radius 0.25 in [-1, 1]^3), some of
    radius 0, the last ``N_DUP`` copies of the first ones."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (N_SPHERES, 3)).astype(np.float32)
    r = rng.uniform(0.15, 0.35, N_SPHERES).astype(np.float32)
    r[rng.choice(N_SPHERES - N_DUP, N_ZERO, replace=False)] = 0.0
    c[-N_DUP:] = c[:N_DUP]
    r[-N_DUP:] = r[:N_DUP]
    return sphere.Spheres(torch.from_numpy(c), torch.from_numpy(r))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(s, seed=8):
    """Random rays, rays from inside spheres, grazing and tangent rays
    (offsets of 0, +-1e-7 and +-1e-4 radii from the silhouette), rays
    whose min_t lies between a sphere's roots, and rays at the duplicated
    spheres' centres: ``(rays, kinds)``, ``kinds`` a name a ray."""
    rng = np.random.default_rng(seed)
    c = s.centers.numpy().astype(np.float64)
    r = s.radii.numpy().astype(np.float64)
    orgs, dirs, mins, kinds = [], [], [], []

    def add(o, d, kind, min_t=None):
        orgs.append(o)
        dirs.append(_unit(d))
        mins.append(np.zeros(len(o)) if min_t is None else min_t)
        kinds.extend([kind] * len(o))

    o = rng.uniform(-2.5, 2.5, (400, 3))
    add(o, rng.uniform(-1, 1, (400, 3)) - o, "random")
    k = rng.integers(0, N_SPHERES - N_DUP, 200)
    k = k[r[k] > 0]
    add(c[k] + 0.3 * r[k, None] * _unit(rng.normal(size=(len(k), 3))),
        rng.normal(size=(len(k), 3)), "inside")
    k = rng.integers(0, N_SPHERES - N_DUP, 300)
    k = k[r[k] > 0]
    d = _unit(rng.normal(size=(len(k), 3)))
    e = _unit(np.cross(d, rng.normal(size=(len(k), 3))))
    off = rng.choice([0.0, 1e-7, -1e-7, 1e-4, -1e-4], len(k))
    add(c[k] + (r[k] * (1.0 + off))[:, None] * e - 3.0 * d, d, "tangent")
    k = rng.integers(0, N_SPHERES - N_DUP, 150)
    k = k[r[k] > 0]
    d = _unit(rng.normal(size=(len(k), 3)))
    add(c[k] - 3.0 * d, d, "min_t", np.full(len(k), 3.0))
    k = np.arange(N_DUP)
    d = _unit(rng.normal(size=(N_DUP, 3)))
    add(c[k] - 4.0 * d, d, "tie")
    rays = nt.make_rays(
        torch.from_numpy(np.concatenate(orgs).astype(np.float32)),
        torch.from_numpy(np.concatenate(dirs).astype(np.float32)),
        min_t=torch.from_numpy(np.concatenate(mins).astype(np.float32)))
    return rays, np.asarray(kinds)


@pytest.fixture(scope="module")
def cloud():
    s = _cloud()
    bvh, _ = sphere.build_sphere_bvh(s, nt.BVHBuildOptions(
        min_leaf_primitives=10, max_leaf_primitives=10))
    small, _ = sphere.build_sphere_bvh(s, nt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2))
    tabs = {(w, leaf): collapse_bvh8(b, width=w, spheres=s).to("cpu")
            for w in (8, 16) for leaf, b in ((10, bvh), (2, small))}
    rays, kinds = _rays(s)
    return s, bvh, tabs, rays, kinds


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("width", [8, 16])
def test_sphere_rows_hold_every_sphere_once(cloud, width):
    s, _, tabs, _, _ = cloud
    scene = tabs[width, 10]
    assert scene.leaf_kind == "sphere" and scene.max_leaf <= 10
    nodes = torch.as_tensor(scene.nodes)
    meta_l, cnt_l = (96, 112) if width == 16 else (64, 72)
    meta = nodes[:, meta_l:meta_l + width].long()
    cnt = nodes[:, cnt_l:cnt_l + width].long() & 15
    leaf = meta < 0
    rows, counts = -meta[leaf] - 1, cnt[leaf]
    leafs = torch.as_tensor(scene.leafs)
    ids, spheres = [], []
    for row, n in zip(rows.tolist(), counts.tolist()):
        ids.append(leafs[row, 108:108 + n].long())
        spheres.append(leafs[row, :4 * n].view(n, 4))
    ids, spheres = torch.cat(ids), torch.cat(spheres)
    assert torch.equal(ids.sort().values, torch.arange(len(s.radii)))
    assert torch.equal(spheres[:, :3], s.centers[ids])
    assert torch.equal(spheres[:, 3], s.radii[ids])


def test_leaf_kind_travels_and_routes(cloud):
    s, bvh, tabs, rays, _ = cloud
    scene = collapse_bvh8(bvh, width=16, spheres=s)
    assert scene.leaf_kind == "sphere"
    assert scene.to("cpu").leaf_kind == "sphere"
    v, f = make_cornell_box(2.0)
    tb, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
    assert collapse_bvh8(tb, v, f, width=8).to("cpu").leaf_kind == "triangle"
    with pytest.raises(ValueError, match="woop"):
        collapse_bvh8(bvh, width=8, woop=True, spheres=s)
    with pytest.raises(ValueError, match="vertices and faces, or spheres"):
        collapse_bvh8(bvh, v, f, width=8, spheres=s)
    for kw in (dict(intersector="woop"), dict(interleave=2),
               dict(_flag_zero_edges=True)):
        with pytest.raises(ValueError, match="sphere scene"):
            packet.traverse_bvh8(tabs[8, 10], rays, **kw)
    # prim ids ride float lanes, exact to 2^24: 10M points fit, more
    # than 2^24 do not
    over = bvh._replace(indices=np.zeros((1 << 24) + 1, np.int32))
    with pytest.raises(ValueError, match="2\\^24"):
        collapse_bvh8(over, width=8, spheres=s)


# ------------------------------------- K1's plain version, stack engine

FILTERS = {
    "plain": {},
    "range": dict(options=nt.BVHTraceOptions(prim_ids_range=RANGE)),
}


@pytest.mark.parametrize("filt", list(FILTERS) + ["skip"])
@pytest.mark.parametrize("leaf", [10, 2])
@pytest.mark.parametrize("width", [8, 16])
def test_plain_k1_matches_stack_engine(cloud, width, leaf, filt):
    s, bvh, tabs, rays, kinds = cloud
    kw = dict(FILTERS.get(filt, {}))
    if filt == "skip":
        first = packet.traverse_bvh8(tabs[width, leaf], rays).prim_id.clone()
        first[1::2] = nt.INVALID_PRIM_ID
        kw["skip_prim_id"] = first
    got = packet.traverse_bvh8(tabs[width, leaf], rays, **kw)
    want = sphere.traverse_spheres(bvh, s, rays, max_leaf=None,
                                   precise=True, post=False, **kw)
    c = compare_hits(got, want, t_ulps=0)
    assert c["ok"], c
    assert torch.equal(got.t, want.t)
    for kind in ("random", "inside", "tangent", "min_t", "tie"):
        sel = torch.from_numpy(kinds == kind)
        assert bool(got.hit[sel].any()), kind
    if filt == "range":
        pid = got.prim_id[got.hit]
        assert bool(((pid >= RANGE[0]) & (pid < RANGE[1])).all())
    if filt == "plain":
        # the ties are real: two spheres give each "tie" ray its t
        tie = torch.from_numpy(kinds == "tie") & got.hit
        assert int(tie.sum()) > 5
        # min_t between the roots: the far root, behind the centre
        mt = torch.from_numpy(kinds == "min_t") & got.hit
        assert bool((got.t[mt] >= 3.0).all())
        # rays from inside a sphere hit its far shell, not at t = 0
        ins = torch.from_numpy(kinds == "inside") & got.hit
        assert bool((got.t[ins] > 0).all())


def test_post_traversal_uv_matches_stack_engine(cloud):
    s, bvh, tabs, rays, _ = cloud
    got = sphere.traverse_spheres(None, s, rays, scene8=tabs[16, 10])
    want = sphere.traverse_spheres(bvh, s, rays, max_leaf=None,
                                   precise=True)
    c = compare_hits(got, want, t_ulps=0, uv_atol=1e-6)
    assert c["ok"] and c["uv_max_err"] == 0.0, c


def test_plain_k1_matches_the_float64_reference(cloud):
    s, _, tabs, rays, kinds = cloud
    got = sphere.traverse_spheres(None, s, rays, scene8=tabs[16, 10])
    ref = RefSpheres(s.centers.numpy(), s.radii.numpy(), "cpu", leaf=16)
    p, n = sphere.sphere_surface(s, rays, got)
    uv = torch.stack([got.u, got.v], 1)
    prim = torch.where(got.hit, got.prim_id, -1)
    off = records_off(ref, rays.org, rays.dir, rays.min_t.double(),
                      torch.full((len(kinds),), 3.0e38, dtype=torch.float64),
                      got.t, prim, n, uv)
    # a ray within 1e-7 radii of a silhouette may go either way
    exact_tangent = torch.from_numpy(kinds == "tangent")
    assert not bool(off[~exact_tangent].any())
    assert int(off.sum()) <= 3
    # the benchmark's control: bfloat16 in the program's place is off
    low = RefSpheres(s.centers.numpy(), s.radii.numpy(), "cpu",
                     torch.bfloat16, leaf=16)
    far = torch.full((len(kinds),), 3.0e38, dtype=torch.float64)
    lt, lp = low.closest(rays.org, rays.dir, rays.min_t.double(), far)
    _, ln, luv = low.surface(rays.org, rays.dir, lt, lp)
    bad = records_off(ref, rays.org, rays.dir, rays.min_t.double(), far,
                      lt, lp, ln, luv)
    assert float(bad.float().mean()) > 0.2


def test_precise_test_keeps_far_spheres():
    # a 0.33-m sphere 740 m off: b^2 - 4ac (the JAX package's) rounds the
    # sphere away on a share of the rays that cross it; the precise
    # discriminant keeps them, its t within 1e-5 of the distance
    rng = np.random.default_rng(3)
    n = 4000
    o = np.array([0.0, 250.0, 700.0])
    dc = _unit(rng.normal(size=(n, 3)) * [1, 0.2, 1] - [0, 1.0, 0])
    c = o + 740.0 * dc
    e = _unit(np.cross(dc, rng.normal(size=(n, 3))))
    d = _unit(c + 0.33 * rng.uniform(0, 0.9, (n, 1)) * e - o)
    s = sphere.Spheres(torch.from_numpy(c.astype(np.float32)),
                       torch.full((n,), 0.33))
    ctx = sphere.SphereRayCtx(
        torch.from_numpy(np.tile(o, (n, 1)).astype(np.float32)),
        torch.from_numpy(d.astype(np.float32)), torch.zeros(n))
    ids = torch.arange(n)[:, None]
    far = torch.full((n,), 3e38)
    v0, t0, _, _ = sphere.sphere_intersect(s, ctx, ids, far)
    v1, t1, _, _ = sphere.sphere_intersect_precise(s, ctx, ids, far)
    assert bool(v1.all())
    assert float((~v0).float().mean()) > 0.005
    want = RefSpheres(c, np.full(n, 0.33), "cpu").closest(
        ctx.org.double(), ctx.dir.double(), torch.zeros(n, dtype=torch.float64),
        far.double())[0]
    assert float((t1[:, 0].double() - want).abs().max()) < 1e-5 * 740.0


def test_stack_engine_keeps_the_jax_test_by_default():
    # why ``traverse_spheres`` keeps ``sphere_intersect`` beside the precise
    # test: on a scene like the JAX comparison's (spheres of 0.05-0.3 in
    # [-2, 2]^3, rays from [-4, 4]^3) the two agree on every hit and prim
    # but not within the comparison's 4 ulps of t
    rng = np.random.default_rng(4)
    s = sphere.Spheres(
        torch.from_numpy(rng.uniform(-2, 2, (200, 3)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.05, 0.3, 200).astype(np.float32)))
    bvh, _ = sphere.build_sphere_bvh(s)
    org = rng.uniform(-4, 4, (256, 3))
    d = _unit(-org + rng.uniform(-1, 1, (256, 3)))
    rays = nt.make_rays(torch.from_numpy(org.astype(np.float32)),
                        torch.from_numpy(d.astype(np.float32)))
    jax_form = sphere.traverse_spheres(bvh, s, rays, post=False)
    precise = sphere.traverse_spheres(bvh, s, rays, post=False, precise=True)
    c = compare_hits(jax_form, precise, t_ulps=2**31)
    assert c["ok"] and c["hits"] > 20, c
    assert compare_hits(jax_form, precise)["t_max_ulp"] > 4


# ------------------------------------------- the kernel's own sphere leaf

HARNESS = r"""
uint3 threadIdx, blockIdx;
namespace {
template <int W, bool kCounts, bool kRoots>
void walk_spheres(const Params& p) {
  int stack[kStackCap];
  for (long long i = 0; i < p.n_rays; ++i) {
    Walk w;
    begin<kRoots>(p, i, w);
    while (w.e != kNone) step<W, kSphere, kCounts, false>(p, w, stack);
    finish<kCounts, false>(p, i, w);
  }
}
template <int W>
void pick(const Params& p, int counts) {
  if (counts) return walk_spheres<W, true, true>(p);
  if (p.roots) return walk_spheres<W, false, true>(p);
  walk_spheres<W, false, false>(p);
}
}  // namespace

extern "C" void emulate_spheres(
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
                               tmp_path_factory.mktemp("k1_spheres"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.emulate_spheres.argtypes = [P] * 13 + [L, L] + [I] * 7
    lib.emulate_spheres.restype = None
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

    lib.emulate_spheres(
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
def test_emulated_sphere_kernel_matches_plain(lib, cloud, width, mode):
    s, _, tabs, rays, _ = cloud
    scene = tabs[width, 2]
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


# ------------------------------------------------ render_sphere_aovs

def _frame(h, w, eye=(0.0, 0.4, 3.2)):
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    cam = look_at(eye, (0.0, 0.0, 0.0), width=w, height=h, fov=45.0,
                  device="cpu")
    return pinhole_rays(cam)


def test_render_sphere_aovs_match_the_reference(cloud):
    s, bvh, tabs, _, _ = cloud
    rays = _frame(24, 40)
    aovs, hits = render_sphere_aovs(s, rays, scene8=tabs[16, 10])
    stack, shits = render_sphere_aovs(s, rays, bvh=bvh)
    assert compare_hits(hits, shits, t_ulps=0)["ok"]
    same = hits.prim_id == shits.prim_id
    for k in aovs:
        a, b = aovs[k], stack[k]
        assert torch.equal(a[same], b[same]), k
    hit = hits.hit
    assert 0.1 < float(hit.float().mean()) < 0.95
    org, d = rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3)
    ref = RefSpheres(s.centers.numpy(), s.radii.numpy(), "cpu", leaf=16)
    n = org.shape[0]
    prim = torch.where(hits.hit, hits.prim_id, -1).reshape(-1)
    off = records_off(ref, org, d, torch.zeros(n, dtype=torch.float64),
                      torch.full((n,), 3.0e38, dtype=torch.float64),
                      hits.t.reshape(-1), prim, aovs["normal"].reshape(-1, 3),
                      aovs["texcoord"].reshape(-1, 2))
    assert not bool(off.any())
    rt, rp = ref.closest(org, d, torch.zeros(n, dtype=torch.float64),
                         torch.full((n,), 3.0e38, dtype=torch.float64))
    p, nrm, uv = ref.surface(org, d, rt, rp)
    h = hit.reshape(-1)
    assert float((aovs["position"].reshape(-1, 3)[h] - p[h]).abs().max()) \
        < 1e-5
    assert float((aovs["normal"].reshape(-1, 3)[h] - nrm[h]).abs().max()) \
        < 1e-4
    assert torch.equal(aovs["depth"].reshape(-1)[h], hits.t.reshape(-1)[h])
    assert torch.equal(aovs["rgb"], torch.where(hit[..., None],
                                                0.5 * aovs["normal"] + 0.5,
                                                0.0))
    du = (aovs["texcoord"].reshape(-1, 2)[h] - uv[h]).abs()
    # u wraps at the seam (atan2 at +-pi): 0 and 1 are one meridian
    du[:, 0] = torch.minimum(du[:, 0], 1.0 - du[:, 0])
    assert float(du.max()) < 1e-4
    for k in ("rgb", "normal", "position", "depth", "texcoord"):
        assert not bool(aovs[k][~hit].any()), k


# ----------------------------------------------- the padded pixel tiling

@pytest.mark.parametrize("shape,tile", [((2160, 3840), (128, 64)),
                                        ((70, 100), (70, 64))])
def test_padded_tiles_untile_to_the_input_order(shape, tile):
    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    org = torch.stack([yy, xx, torch.zeros_like(xx)], -1)
    # every pixel's own max_t (its row-major index: exact in float32)
    rays = nt.Rays(org, org, torch.zeros_like(xx), yy * w + xx)
    flat, untile = packet.tile_image_rays(rays, *tile, pad=True)
    hp, wp = -(-h // tile[0]) * tile[0], -(-w // tile[1]) * tile[1]
    assert flat.org.shape == (hp * wp, 3)
    pad = flat.max_t < flat.min_t
    assert int(pad.sum()) == hp * wp - h * w
    assert bool((flat.dir[pad] == 1.0).all())
    # a tile's rays are the tile's pixels, row by row
    assert torch.equal(flat.org[:tile[1], 1], torch.arange(
        tile[1], dtype=torch.float32))
    back = untile(flat)
    for a, b in zip(back, rays):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not a multiple"):
        packet.tile_image_rays(rays, 128, 64 if w % 64 else 48)


def _profiled(fn):
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    names = [r.name for r in trace.records()]
    trace.reset()
    return out, names


def test_frame_takes_the_padded_tiles_not_the_sort(cloud, monkeypatch):
    s, _, tabs, _, _ = cloud
    rays = _frame(70, 100)
    calls, inner = [], packet.traverse_bvh8

    def spy(scene, r, *a, **kw):
        calls.append(tuple(r.batch_shape))
        return inner(scene, r, *a, **kw)

    monkeypatch.setattr(packet, "traverse_bvh8", spy)
    (aovs, hits), names = _profiled(
        lambda: render_sphere_aovs(s, rays, scene8=tabs[16, 10]))
    # one K1 call over the (70, 100) rays as they lie, with no tile and
    # untile copies
    assert calls == [(70, 100)]
    assert "k1" in names and "tile" not in names and "untile" not in names
    assert "sphere.post" in names and "render_sphere_aovs" in names
    assert not [n for n in names if n.startswith("ray_sort")]
    flat = nt.Rays(*(x.reshape(7000, *x.shape[2:]) for x in rays))
    want = packet.traverse_bvh8(tabs[16, 10], flat)
    assert torch.equal(hits.t.reshape(-1), want.t)
    assert torch.equal(hits.prim_id.reshape(-1), want.prim_id)


# ------------------------------------------------------ triangle scenes

def test_triangle_launch_keys_are_unchanged():
    key = packet._launch_key
    assert key(False, False, False, False, 1) == "packet_traverse"
    assert key(True, False, False, False, 1) == "packet_traverse_woop"
    assert key(False, True, False, False, 1) == "packet_traverse[roots]"
    assert key(True, False, True, False, 1) == "packet_traverse[counts]"
    assert key(False, False, False, True, 1) == "packet_traverse[flags]"
    assert key(True, False, False, False, 4) == \
        "packet_traverse[interleave=4]"
    assert key(False, False, False, False, 1, True) == \
        "packet_traverse[sphere]"
    assert set(packet.LAUNCH_KEYS) >= {
        "packet_traverse", "packet_traverse_woop", "packet_traverse[roots]",
        "packet_traverse[counts]", "packet_traverse[flags]",
        "packet_traverse[interleave=2]", "packet_traverse[interleave=4]",
        "packet_traverse[sphere]"}
    assert "packet_traverse[sphere]" in trace.launches()


@pytest.mark.parametrize("shape", [(64, 128), (70, 100)])
def test_triangle_frames_keep_their_records(shape):
    # an image of whole tiles keeps its route; one that is not, once
    # sorted, now takes padded tiles: each ray walks alone in K1, so the
    # records are the sorted route's bit for bit
    v, f = make_uv_sphere(12, 24, 0.8)
    mesh = TriangleMesh(v, f)
    bvh, _ = nt.build_triangle_bvh(mesh, nt.BVHBuildOptions(
        min_leaf_primitives=9, max_leaf_primitives=9))
    s8 = collapse_bvh8(bvh, v, f, width=16).to("cpu")
    rays = _frame(*shape)
    aovs, hits = objrender.render_aovs(bvh, mesh, rays, scene8=s8)
    flat = nt.Rays(*(x.reshape(-1, *x.shape[2:]).contiguous() for x in rays))
    want = traverse_bvh8_sorted(s8, flat)
    for a, b in zip(hits, want):
        assert torch.equal(a.reshape(-1), b)
    assert 0.05 < float(hits.hit.float().mean()) < 0.95
