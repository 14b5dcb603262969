"""PyTorch port on the card: each CUDA kernel against its plain torch
version on the same tables and rays — K1 and K1-woop
(csrc/packet_traverse.cu vs traverse/packet.py::_traverse_reference,
watertight and Woop leaf tests), K2 (csrc/bvh16_trace.cu vs
traverse/fused_trace.py::trace_bvh16_reference, Moller-Trumbore and
watertight, with and without a per-ray skip), K3 and K4
(csrc/pt_fused.cu vs models/pt_fused.py::_render_fused_reference and
_render_fused_bvh_reference; K3 also at edge shapes, with lanes that
claim many pixels, with more pixels than resident lanes, and with its
sweep counters against the plain version's live sweeps; K4's pooled
kernel also at edge shapes, in slices of sample iterations against one
launch, and with a stack too small for the tree), K5 (csrc/ao_fused.cu vs
models/ao_fused.py::_ao_fused_reference; also at its persistent schedule's
edge shapes, with warps that claim many tiles, and with its launch and
item counters). The AOV kernel (csrc/aovs.cu vs
models/objrender.py::_aovs_plain on the same card tensors, image and
flat batches, int32 and int64 faces, geometric and facevarying normals,
degenerate triangles, and a K1 frame; one ``aovs_fused`` launch a float32
call, none for float64; a prim id past the faces fails the launch). The
sphere AOV kernel (csrc/sphere_aovs.cu vs models/pointcloud.py::
_sphere_aovs_plain on the same card tensors, texcoord included: spheres
740 m away, grazing rays, poles, image and flat batches, a small cloud's
frame and a 1M-sphere 3840 x 2160 frame through K1; one
``sphere_aovs_fused`` launch a float32 call; float64 raises and launches
nothing; a prim id past the centres fails the launch). The
camera kernel (csrc/camera.cu vs models/cameras.py::_pinhole_plain at
8192^2, 3840 x 2160 and two widths that are not a multiple of 4; one
``pinhole_fused`` launch a float32 camera, none for float64 or an
explicit pixel grid). K1b (``interleave`` 2 and 4) also at ray counts that are
not a multiple of its claims, on grids of 1 to 3 blocks, with dead rays,
roots across claims and both of its stacks. Config A's render_ao must
launch K1 and never a plain version, and the stack engine (plain torch)
must give on the card what it gives on the CPU. Tolerance: bit-identical results (kernel
and plain version share one child order and one arithmetic; the kernels
are built with --fmad=false). The one exception is the path tracers'
``trig="native"``, whose cos/sin come from two builds of the CUDA libm;
the kernel's cosf/sinf and torch's CPU sin/cos differ in the last ulp,
which flips a later lobe pick on a few paths (an H100 run gave 93.5%
identical pixels), so it is held to 85% identical pixels and the image
mean within 2%. The megabatch route (``render_path_traced(...,
fused=False)``) must launch K1 or K1-woop for every trace and never a
plain version, and ``trace_paths`` on the card must agree with its CPU
run on the same draws on at least 99% of rays (its shading is plain
torch on both; cos/sin come from two float64 libms). The scene graph and
the Embree-style API (``scene/``, ``api/``): the fast route launches K1
once per ``intersect`` and ``occluded`` call, its captured launches equal
the plain version bit for bit, and its records, like the graph walk's
(which launches nothing), equal the CPU's in hit mask and ids with t
within 4 ulp; ``render_pbr`` launches K1 twice and gives the CPU's
records, its image within 1e-5. The chunk-sharded scene's K1 path
(``sequential_chunk_traverse``: one launch a chunk) gives the CPU's
records bit for bit; ``to_spheres`` and ``sample_tri_hits`` on the card
give the CPU's values (spheres bit for bit, their hits under
``compare_hits``); and a one-rank NCCL group runs the mesh engines and
``sharded_render_step`` with the records, counts and AO of the
group-less CPU mesh. The program's spans (``utils.trace``): K1's
kernels start inside the ``nanort.k1`` ranges that launched them, and a
``k1`` or ``k4`` span's stream ms (its CUDA events) is its kernel's
device time within 10%; launches are counted in ``utils.trace.counts()``.

Every test here is marked ``gpu`` and skips without a CUDA device. This
file imports no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_cornell_dense_pt_scene, make_cornell_pt_scene,
    make_subdivided_sphere_scene, make_uv_sphere, merge_meshes)
from nanort_tpu_torch.models import ao_fused, objrender, path_tracer, pt_fused
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import (aov_case, compare_hits, overlap_soup,
                                      sphere_aov_case, zero_edge_rays)
from nanort_tpu_torch.traverse import fused_trace, packet
from nanort_tpu_torch.utils import trace
# this slice's modules: importable where only torch is installed
from nanort_tpu_torch.api import embree3, rtc  # noqa: F401
from nanort_tpu_torch.io import gltf, voxels  # noqa: F401
from nanort_tpu_torch.models import (bdpt, pbr, progressive,  # noqa: F401
                                     uv_raster)
from nanort_tpu_torch.scene import graph, matrix  # noqa: F401
# the loaders, utils and the multi-device layer
from nanort_tpu_torch.io import las, ptex  # noqa: F401
from nanort_tpu_torch.parallel import mesh as pmesh  # noqa: F401
from nanort_tpu_torch.parallel import sharded_scene  # noqa: F401
from nanort_tpu_torch.utils import debug, trackball  # noqa: F401

pytestmark = pytest.mark.gpu


def _launched(before: dict) -> dict:
    """The kernel launches since the counters' snapshot ``before``
    (``trace.counts()``), by launch key."""
    return {k: v for k, v in trace.launches(before).items() if v}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(v, f, width, woop=False):
    bvh, _ = nt.build_triangle_bvh(
        TriangleMesh(v, f),
        nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    return collapse_bvh8(bvh, v, f, width=width, woop=woop)


def _rays(n, seed, broken=True):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if broken:  # degenerate rays among them
        org[0::10, 0] = np.nan
        d[2::10] = 0.0
        d[4::10, 1] = np.inf
        d[6::10, 2] = -3.1e38
    return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))


def _same_on_both(scene, rays, dev, **kw):
    key = ("packet_traverse_woop" if kw.get("intersector") == "woop"
           else "packet_traverse")
    _mode_on_both(scene, rays, dev, key, **kw)


OPTIONS = {
    "closest": nt.BVHTraceOptions(),
    "cull": nt.BVHTraceOptions(cull_back_face=True),
    "range": nt.BVHTraceOptions(prim_ids_range=(100, 900)),
    "no_exact_edges": nt.BVHTraceOptions(exact_edge_fallback=False),
}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_matches_plain_small_scene(dev, width, occlusion, opt):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    _same_on_both(_scene(v, f, width), _rays(3001, 5), dev,
                  options=OPTIONS[opt], occlusion=occlusion)


@pytest.mark.parametrize("width", [8, 16])
def test_kernel_matches_plain_with_skip(dev, width):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    scene = _scene(v, f, width)
    rays = _rays(3001, 6)
    first = packet.traverse_bvh8(scene, rays)
    _same_on_both(scene, rays, dev, skip_prim_id=first.prim_id)


def test_kernel_matches_plain_camera_frame(dev):
    v, f = make_subdivided_sphere_scene(100_000)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=256, height=256,
                  fov=60.0, device="cpu")
    rays_t, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    _same_on_both(_scene(v, f, 16), rays_t, dev)


@pytest.mark.parametrize("opt", ["closest", "cull", "range"])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_woop_kernel_matches_plain_small_scene(dev, width, occlusion, opt):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    _same_on_both(_scene(v, f, width, woop=True), _rays(3001, 5), dev,
                  options=OPTIONS[opt], occlusion=occlusion,
                  intersector="woop")


def test_woop_kernel_matches_plain_with_skip_and_dead_rays(dev):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    scene = _scene(v, f, 16, woop=True)
    rays = _rays(3001, 6)
    first = packet.traverse_bvh8(scene, rays, intersector="woop")
    max_t = torch.where(torch.arange(3001) % 3 == 0, 0.0, rays.max_t)
    rays = rays._replace(max_t=max_t.contiguous())
    _same_on_both(scene, rays, dev, skip_prim_id=first.prim_id,
                  intersector="woop")


def test_woop_kernel_matches_plain_camera_frame(dev):
    v, f = make_subdivided_sphere_scene(100_000)
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=256, height=256,
                  fov=60.0, device="cpu")
    rays_t, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    _same_on_both(_scene(v, f, 16, woop=True), rays_t, dev,
                  intersector="woop")


def test_kernel_rejects_host_tables(dev):
    s = interop.scene_from_numpy(np.zeros((2, 128)), np.zeros((1, 128)),
                                 1, 1, 1, 0, 16)
    r = nt.make_rays(torch.zeros(4, 3, device=dev),
                     torch.ones(4, 3, device=dev))
    with pytest.raises(ValueError, match="scene.to"):
        packet.traverse_bvh8(s, r)


# ---------------------------------------------------------------- K2-K4

@pytest.fixture(scope="module")
def dense_pt():
    sv, sf, mids, mats = make_cornell_dense_pt_scene(2000)
    return path_tracer.make_pt_scene(sv, sf, mids, mats, engine="pallas",
                                     device="cpu")


@pytest.fixture(scope="module")
def cornell_pt():
    return path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                     device="cpu")


def _incoherent(n, seed):
    """Seeded rays inside the box; every 7th axis-parallel, every 13th
    with a zero direction, every 11th with a short tmax."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1:] = 0.0
    d[::7, 0] = np.where(d[::7, 0] < 0, -1.0, 1.0)
    d[3::13] = 0.0
    tmax = np.full(n, 1e30, np.float32)
    tmax[5::11] = rng.uniform(0.1, 1.0, tmax[5::11].shape)
    return nt.Rays(torch.from_numpy(org), torch.from_numpy(d),
                   torch.full((n,), 0.001), torch.from_numpy(tmax))


def _cam(w, h, eye_z):
    cam = look_at(eye=(0, 0.0, eye_z), center=(0, 0, 0), width=w, height=h,
                  fov=45.0, device="cpu")
    r = pinhole_rays(cam)
    return r.org.reshape(-1, 3), r.dir.reshape(-1, 3)


@pytest.mark.parametrize("mode", ["closest", "closest_aux", "occlusion"])
def test_bvh16_trace_matches_plain(dev, dense_pt, mode):
    rays = _incoherent(4099, 3)
    kw = dict(occlusion=mode == "occlusion", want_aux=mode == "closest_aux")
    before = trace.counts()
    got = fused_trace.trace_bvh16(dense_pt.scene8.to(dev),
                                  nt.Rays(*(x.to(dev) for x in rays)),
                                  dense_pt.fused_aux.to(dev), **kw)
    assert _launched(before) == {"bvh16_trace": 1}
    want = fused_trace.trace_bvh16(dense_pt.scene8, rays,
                                   dense_pt.fused_aux, **kw)
    if mode == "occlusion":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        if b is not None:
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("trig", ["poly", "native"])
@pytest.mark.parametrize("lights", [True, False])
def test_pt_fused_brute_matches_plain(dev, cornell_pt, trig, lights):
    scene = cornell_pt
    if not lights:
        scene = scene._replace(light_table=scene.light_table[:0],
                               light_faces=scene.light_faces[:0])
    org, d = _cam(24, 20, 5.0)
    kw = dict(max_bounces=5, trig=trig, azimuth_strata=2)
    before = trace.counts()
    got = pt_fused.render_fused(scene.to(dev), org.to(dev), d.to(dev), 7, 4,
                                **kw)
    assert _launched(before) == {"pt_fused_brute": 1}
    want = pt_fused.render_fused(scene, org, d, 7, 4, **kw)
    _same_image(got, want, trig)


def test_pt_fused_brute_facevarying_normals(dev, cornell_pt):
    # 26 face-table columns: per-vertex normals tilted off the face normal
    f = cornell_pt.face_table
    rng = np.random.default_rng(2)
    fvn = f[:, None, 0:3] + torch.from_numpy(
        rng.normal(0, 0.2, (f.shape[0], 3, 3)).astype(np.float32))
    scene = cornell_pt._replace(
        face_table=torch.cat([f, fvn.reshape(-1, 9)], 1).contiguous())
    org, d = _cam(16, 16, 5.0)
    got = pt_fused.render_fused(scene.to(dev), org.to(dev), d.to(dev), 5, 2,
                                max_bounces=4, trig="poly")
    want = pt_fused.render_fused(scene, org, d, 5, 2, max_bounces=4,
                                 trig="poly")
    _same_image(got, want, "poly")


@pytest.fixture(scope="module")
def cornell_256():
    """The Cornell box and 224 seeded small white triangles inside it:
    256, K3's most."""
    v, f, mids, mats = make_cornell_pt_scene(2.0)
    k = pt_fused.PT_FUSED_MAX_TRIS - len(f)
    rng = np.random.default_rng(8)
    c = rng.uniform(-0.8, 0.8, (k, 1, 3))
    tv = (c + rng.uniform(-0.2, 0.2, (k, 3, 3))).reshape(-1, 3)
    tf = len(v) + np.arange(3 * k).reshape(-1, 3)
    return path_tracer.make_pt_scene(
        np.concatenate([v, tv]).astype(np.float32),
        np.concatenate([f, tf]).astype(np.int32),
        np.concatenate([mids, np.zeros(k, np.int32)]), mats, device="cpu")


def _brute_live_sweeps(monkeypatch):
    """Count the plain K3's sweeps of live rays: closest hits with tmax >
    tmin, and the shadow rays it is asked (the kernel's counters)."""
    count = {"closest": 0, "shadows": 0}
    real = pt_fused._brute_mt

    def counting(t, *c):
        tmin, tmax = c[-2], c[-1]
        if tmin.numel() and float(tmin[0]) == pt_fused._EPS_T:
            count["closest"] += int((tmax > tmin).sum())
        else:
            count["shadows"] += tmin.numel()
        return real(t, *c)

    monkeypatch.setattr(pt_fused, "_brute_mt", counting)
    return count


BRUTE_CASES = {
    # name: (camera (w, h), spp, kwargs): fewer pixels than a warp, a
    # count no warp divides, one sample and one bounce, 256 triangles, no
    # lights, roulette past max_bounces
    "n7": ((7, 1), 3, dict(max_bounces=5)),
    "n45": ((9, 5), 3, dict(max_bounces=5, azimuth_strata=4)),
    "spp1_mb1": ((24, 20), 1, dict(max_bounces=1)),
    "spp1": ((24, 20), 1, dict(max_bounces=10)),
    "mb1": ((24, 20), 6, dict(max_bounces=1, azimuth_strata=2)),
    "mb0": ((24, 20), 3, dict(max_bounces=0)),
    "f256": ((24, 20), 3, dict(max_bounces=6)),
    "dark": ((24, 20), 4, dict(max_bounces=6)),
    "rr_past_max": ((24, 20), 4, dict(max_bounces=3, rr_start=5)),
}


@pytest.mark.parametrize("case", list(BRUTE_CASES))
def test_pt_fused_brute_edge_shapes(dev, cornell_pt, cornell_256, case,
                                    monkeypatch):
    (w, h), spp, kw = BRUTE_CASES[case]
    scene = cornell_256 if case == "f256" else cornell_pt
    if case == "dark":
        scene = scene._replace(light_table=scene.light_table[:0],
                               light_faces=scene.light_faces[:0])
    org, d = _cam(w, h, 5.0)
    kw = dict(trig="poly", **kw)
    before = trace.counts()
    got = pt_fused.render_fused(scene.to(dev), org.to(dev), d.to(dev), 4,
                                spp, **kw)
    assert _launched(before) == {"pt_fused_brute": 1}
    sweeps = pt_fused.LAST_BRUTE_STATS.cpu().tolist()
    count = _brute_live_sweeps(monkeypatch)
    want = pt_fused.render_fused(scene, org, d, 4, spp, **kw)
    _same_image(got, want, "poly")
    # the kernel traced the live bounces and NEE rays, no more
    assert sweeps == [count["closest"], count["shadows"]]
    if case == "mb0":
        assert not bool(got.any())
    elif case != "dark":
        assert float(got.mean()) > 0 and sweeps[1] > 0


@pytest.mark.parametrize("grid", [1, 3])
def test_pt_fused_brute_lanes_claim_many_pixels(dev, cornell_pt, monkeypatch,
                                                grid):
    # 480 pixels on 128 or 384 lanes: every lane claims several
    monkeypatch.setattr(pt_fused, "brute_grid", lambda *a: grid)
    org, d = _cam(24, 20, 5.0)
    kw = dict(max_bounces=6, trig="poly", azimuth_strata=2)
    got = pt_fused.render_fused(cornell_pt.to(dev), org.to(dev), d.to(dev),
                                6, 5, **kw)
    want = pt_fused.render_fused(cornell_pt, org, d, 6, 5, **kw)
    _same_image(got, want, "poly")


def test_pt_fused_brute_more_pixels_than_resident_lanes(dev, cornell_pt):
    occ = pt_fused.brute_occupancy(dev)
    lanes = occ["blocks_per_sm"] * occ["sms"] * occ["threads"]
    w = 512
    h = -(-(lanes + 1000) // w)
    assert pt_fused.brute_grid(w * h, occ["blocks_per_sm"], occ["sms"]) \
        == occ["blocks_per_sm"] * occ["sms"]
    org, d = _cam(w, h, 5.0)
    kw = dict(max_bounces=2, trig="poly")
    got = pt_fused.render_fused(cornell_pt.to(dev), org.to(dev), d.to(dev),
                                3, 1, **kw)
    want = pt_fused.render_fused(cornell_pt, org, d, 3, 1, **kw)
    _same_image(got, want, "poly")


def test_pt_fused_brute_two_launches_give_one_image(dev, cornell_pt):
    # the second launch's pixel counter starts at 0 again
    scene = cornell_pt.to(dev)
    org, d = (x.to(dev) for x in _cam(40, 30, 5.0))
    kw = dict(max_bounces=5, trig="poly")
    a = pt_fused.render_fused(scene, org, d, 2, 3, **kw)
    b = pt_fused.render_fused(scene, org, d, 2, 3, **kw)
    assert torch.equal(a, b)
    _same_image(a, pt_fused.render_fused(cornell_pt, org.cpu(), d.cpu(), 2,
                                         3, **kw), "poly")


def test_pt_fused_brute_occupancy_and_grid(dev):
    occ = pt_fused.brute_occupancy(dev)
    assert occ["threads"] == pt_fused.BRUTE_THREADS
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    assert occ["sms"] == torch.cuda.get_device_properties(
        dev).multi_processor_count
    resident = occ["blocks_per_sm"] * occ["sms"]
    assert pt_fused.brute_grid(1 << 30, occ["blocks_per_sm"],
                               occ["sms"]) == resident
    assert pt_fused.brute_grid(5, occ["blocks_per_sm"], occ["sms"]) == 1


@pytest.mark.parametrize("spp_lanes,strata", [(1, 1), (4, 2)])
def test_pt_fused_bvh_matches_plain(dev, dense_pt, spp_lanes, strata):
    org, d = _cam(16, 12, 2.6)
    kw = dict(max_bounces=5, trig="poly", azimuth_strata=strata,
              spp_lanes=spp_lanes)
    before = trace.counts()
    got = pt_fused.render_fused_bvh(dense_pt.to(dev), org.to(dev), d.to(dev),
                                    9, 8, **kw)
    # K2 runs inside K4
    assert trace.since(before) == {"pt_fused_bvh": 1, "bvh16_trace": 1}
    want = pt_fused.render_fused_bvh(dense_pt, org, d, 9, 8, **kw)
    _same_image(got, want, "poly")


def test_render_path_traced_launches_kernels_only(dev, dense_pt, cornell_pt,
                                                  monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("_render_fused_reference", "_render_fused_bvh_reference"):
        monkeypatch.setattr(pt_fused, name, plain)
    monkeypatch.setattr(fused_trace, "trace_bvh16_reference", plain)
    cam = look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0), width=128, height=32,
                  fov=45.0, device=dev)
    before = trace.counts()
    for scene in (cornell_pt, dense_pt):
        img = path_tracer.render_path_traced(scene.to(dev), pinhole_rays(cam),
                                             3, spp=4, max_bounces=4)
        assert img.shape == (32, 128, 3) and img.is_cuda
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    # both routes launch their kernel once; K4 on its pooled schedule; the
    # camera kernel once a render
    assert _launched(before) == {"pt_fused_brute": 1, "pt_fused_bvh": 1,
                                 "bvh16_trace": 1, "pinhole_fused": 2}


POOL_CASES = {
    # name: (camera (w, h), spp, kwargs): fewer paths than one pool, a
    # lane count that fills no whole block, one sample iteration, no
    # bounce, one bounce, a scene without lights
    "few_lanes": ((3, 2), 2, dict(max_bounces=5)),
    "ragged": ((11, 7), 6, dict(max_bounces=4, spp_lanes=3)),
    "one_iter": ((16, 12), 4, dict(max_bounces=5, spp_lanes=4)),
    "mb0": ((16, 12), 4, dict(max_bounces=0)),
    "mb1": ((16, 12), 4, dict(max_bounces=1, azimuth_strata=2)),
    "dark": ((16, 12), 4, dict(max_bounces=4)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pt_fused_bvh_pool_edge_shapes(dev, dense_pt, case):
    (w, h), spp, kw = POOL_CASES[case]
    scene = dense_pt
    if case == "dark":
        scene = scene._replace(light_table=scene.light_table[:0],
                               light_faces=scene.light_faces[:0])
    org, d = _cam(w, h, 2.6)
    kw = dict(trig="poly", **kw)
    before = trace.counts()
    got = pt_fused.render_fused_bvh(scene.to(dev), org.to(dev), d.to(dev), 4,
                                    spp, **kw)
    assert _launched(before) == {"pt_fused_bvh": 1, "bvh16_trace": 1}
    want = pt_fused.render_fused_bvh(scene, org, d, 4, spp, **kw)
    _same_image(got, want, "poly")
    if case == "mb0":
        assert not bool(got.any())
    elif case != "dark":
        assert float(got.mean()) > 0
    # every (lane, sample) path was claimed once
    items = w * h * spp
    stats = pt_fused.LAST_POOL_STATS.cpu().tolist()
    assert stats[2] == items and stats[0] >= items and stats[5] >= 1
    assert stats[3] >= (items if kw["max_bounces"] else 0)


def test_pt_fused_bvh_small_stack_sets_error_word(dev, dense_pt,
                                                  monkeypatch):
    real = fused_trace._check_tables
    words = []
    monkeypatch.setattr(fused_trace, "_check_tables",
                        lambda *a: real(*a)[:3] + (2,))
    monkeypatch.setattr(fused_trace, "check_overflow",
                        lambda err, slots: words.append((err, slots)))
    org, d = _cam(16, 12, 2.6)
    pt_fused.render_fused_bvh(dense_pt.to(dev), org.to(dev), d.to(dev), 4, 2,
                              max_bounces=3)
    (err, slots), = words
    assert slots == 2 and err.is_cuda and int(err.item()) != 0


def test_pt_fused_bvh_small_stack_raises(dev):
    # the real check fails the stream, which poisons the process's CUDA
    # context: run it in a child
    import subprocess
    import sys

    code = """
import torch
from nanort_tpu_torch.io.procedural import make_cornell_dense_pt_scene
from nanort_tpu_torch.models import path_tracer, pt_fused
from nanort_tpu_torch.traverse import fused_trace
scene = path_tracer.make_pt_scene(*make_cornell_dense_pt_scene(2000),
                                  engine="pallas", device="cuda")
real = fused_trace._check_tables
fused_trace._check_tables = lambda *a: real(*a)[:3] + (2,)
org = torch.zeros(64, 3, device="cuda")
d = torch.nn.functional.normalize(torch.randn(64, 3, device="cuda"), dim=1)
try:
    pt_fused.render_fused_bvh(scene, org, d, 4, 2, max_bounces=3)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", "overflow" in str(e) or "assert" in str(e).lower())
"""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=300)
    assert "RAISED True" in r.stdout, (r.stdout, r.stderr[-2000:])


def test_pt_fused_bvh_schedule_keyword(dev):
    # K4's one schedule: the pooled kernel's resident blocks and pool
    occ = pt_fused.pool_occupancy(dev)
    assert occ["pool"] >= 1
    assert 0 < occ["pool_smem_bytes"] <= 227 * 1024
    assert occ["sms"] == torch.cuda.get_device_properties(
        dev).multi_processor_count


@pytest.mark.parametrize("iters_a_slice", [1, 3])
def test_pt_fused_bvh_pool_slices_match_lane(dev, dense_pt, iters_a_slice,
                                            monkeypatch):
    # a render whose per-sample buffer passes the cap runs one launch a
    # slice of sample iterations and keeps the bits of one launch
    org, d = _cam(32, 24, 2.6)
    scene = dense_pt.to(dev)
    kw = dict(max_bounces=5, trig="poly", azimuth_strata=2, spp_lanes=2)
    rl, spp_iters = 32 * 24 * 2, 8 // 2
    before = trace.counts()
    want = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 6, 8,
                                     **kw)
    assert trace.since(before) == {"pt_fused_bvh": 1, "bvh16_trace": 1}
    monkeypatch.setattr(pt_fused, "POOL_SLICE_BYTES",
                        iters_a_slice * rl * 12)
    slices = -(-spp_iters // iters_a_slice)
    before = trace.counts()
    got = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 6, 8,
                                    **kw)
    assert trace.since(before) == {"pt_fused_bvh": slices,
                                   "bvh16_trace": slices}
    assert torch.equal(got, want)
    stats = dict(zip(pt_fused.POOL_STATS, pt_fused.LAST_POOL_STATS.tolist()))
    assert stats["paths"] == rl * spp_iters
    assert stats["blocks"] >= slices


def _same_image(got, want, trig):
    assert got.is_cuda and got.shape == want.shape
    got = got.cpu()
    if trig == "poly":
        assert torch.equal(got, want)
        return
    same = (got == want).all(1).float().mean()
    assert same > 0.85, same
    assert abs(float(got.mean() - want.mean())) < 0.02 * float(want.mean())


# ------------------------------------------------------ megabatch route

@pytest.fixture(scope="module")
def dense_turbo():
    sv, sf, mids, mats = make_cornell_dense_pt_scene(2000)
    return path_tracer.make_pt_scene(sv, sf, mids, mats, engine="turbo",
                                     device="cpu")


def test_megabatch_route_launches_kernels_only(dev, dense_pt, dense_turbo,
                                               monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(packet, "_traverse_reference", plain)
    cam = look_at(eye=(0, 0.0, 2.6), center=(0, 0, 0), width=32, height=16,
                  fov=45.0, device=dev)
    for scene, key in ((dense_pt, "packet_traverse"),
                       (dense_turbo, "packet_traverse_woop")):
        before = trace.counts()
        img = path_tracer.render_path_traced(
            scene.to(dev), pinhole_rays(cam), 3, spp=4, max_bounces=5,
            fused=False, spp_batch=2)
        assert img.shape == (16, 32, 3) and img.is_cuda
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
        # 2 megabatches x 5 bounces x (closest + shadow), no fused kernel;
        # the camera kernel once
        assert _launched(before) == {key: 20, "pinhole_fused": 1}


@pytest.mark.parametrize("engine", ["turbo", "wavefront", "brute"])
def test_trace_paths_on_card_matches_cpu(dev, dense_turbo, cornell_pt,
                                         engine):
    if engine == "wavefront":
        sv, sf, mids, mats = make_cornell_dense_pt_scene(2000)
        scene = path_tracer.make_pt_scene(sv, sf, mids, mats, device="cpu")
    else:
        scene = dense_turbo if engine == "turbo" else cornell_pt
    org, d = _cam(24, 20, 2.6 if engine != "brute" else 5.0)
    draws = torch.from_numpy(np.random.default_rng(12).uniform(
        size=(6, org.shape[0], 6)).astype(np.float32))
    want = path_tracer.trace_paths(scene, org, d, max_bounces=6,
                                   has_normals=False, draws=draws)
    got = path_tracer.trace_paths(scene.to(dev), org.to(dev), d.to(dev),
                                  max_bounces=6, has_normals=False,
                                  draws=draws.to(dev))
    assert got.is_cuda
    same = (got.cpu() == want).all(1).float().mean()
    assert same >= 0.99, same
    assert abs(float(got.mean() - want.mean())) < 1e-3 * float(want.mean())


# ------------------------------------------- config A: K2 watertight, K5

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("mode", ["closest", "closest_aux", "occlusion"])
def test_bvh16_trace_watertight_matches_plain(dev, dense_pt, mode, skip):
    rays = _incoherent(4099, 4)
    kw = dict(occlusion=mode == "occlusion", want_aux=mode == "closest_aux",
              intersector="watertight")
    if skip:
        first = fused_trace.trace_bvh16(dense_pt.scene8, rays,
                                        intersector="watertight")
        kw["skip"] = torch.where(torch.arange(4099) % 2 == 0,
                                 first.prim_id, -1)
    before = trace.counts()
    got = fused_trace.trace_bvh16(
        dense_pt.scene8.to(dev), nt.Rays(*(x.to(dev) for x in rays)),
        dense_pt.fused_aux.to(dev),
        **{k: (x.to(dev) if isinstance(x, torch.Tensor) else x)
           for k, x in kw.items()})
    assert _launched(before) == {"bvh16_trace_watertight": 1}
    want = fused_trace.trace_bvh16(dense_pt.scene8, rays, dense_pt.fused_aux,
                                   **kw)
    if mode == "occlusion":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        if b is not None:
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.fixture(scope="module")
def config_a_small():
    """Config A's scene at the graft size: 234 triangles, leaf 8."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    mesh = TriangleMesh(v, f)
    bvh, _ = nt.build_triangle_bvh(mesh, nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16)
    return mesh, bvh, s16, ao_fused.build_ao_aux(mesh, s16)


@pytest.mark.parametrize("n_samples", [3, 8])
def test_ao_fused_matches_plain(dev, config_a_small, n_samples):
    mesh, _, s16, aux = config_a_small
    cam = look_at(eye=(0.31, 0.17, 5.0), center=(0, 0, 0), width=40,
                  height=24, fov=45.0, device="cpu")
    rays = pinhole_rays(cam)
    draws = objrender.ao_hemisphere_draws(torch.Generator().manual_seed(2),
                                          n_samples, (24, 40))
    before = trace.counts()
    got, got_h = ao_fused.render_ao_fused(
        mesh, nt.Rays(*(x.to(dev) for x in rays)), None, s16.to(dev),
        aux.to(dev), n_samples=n_samples, draws=draws.to(dev))
    assert _launched(before) == {"ao_fused": 1, "bvh16_trace_watertight": 1,
                                 "aovs_fused": 1}
    want, want_h = ao_fused.render_ao_fused(
        mesh, rays, None, s16.to("cpu"), aux, n_samples=n_samples,
        draws=draws)
    for k in want:
        assert got[k].is_cuda and torch.equal(got[k].cpu(), want[k]), k
    for a, b in zip(got_h, want_h):
        assert torch.equal(a.cpu(), b)


def _ao_inputs(config_a_small, eye, w, h, S, center=(0.0, 0.0, 0.0)):
    """CPU tables, flat camera rays and (S, R, 3) draws for K5."""
    _, _, s16, aux = config_a_small
    rays = pinhole_rays(look_at(eye=eye, center=center, width=w, height=h,
                                fov=45.0, device="cpu"))
    flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in rays]
    draws = objrender.ao_hemisphere_draws(
        torch.Generator().manual_seed(5), S, (h, w))
    tabs = fused_trace._check_tables(s16, aux, torch.device("cpu"))
    return tabs, flat, draws.reshape(S, w * h, 3).contiguous()


def _ao_on_both(dev, tabs, flat, draws, radius=1e30, launches=1):
    """K5 on the card (``launches`` times) == its plain version on the
    CPU, bit for bit; one launch of K5 and K2 a call; the items the
    kernel traced == the plain version's samples of hit pixels."""
    nodes, leafs, aux, slots = tabs
    stats = {}
    want = ao_fused._ao_fused_reference(nodes, leafs, aux, *flat, draws,
                                        radius, slots, stats=stats)
    on = [x.to(dev) for x in (nodes, leafs, aux, *flat, draws)]
    for _ in range(launches):
        before = trace.counts()
        got = ao_fused.ao_fused_outputs(*on, radius, slots)
        assert _launched(before) == {"ao_fused": 1,
                                     "bvh16_trace_watertight": 1}
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a.cpu(), b)
        assert int(ao_fused.LAST_ITEMS) == stats["samples"]
    return want


AO_CASES = {
    # name: (eye, (w, h), S, ao_radius): fewer pixels than a warp, a
    # count no tile divides, no hit (looking away from the box), hits
    # only (inside the box), one and 32 samples, a short radius
    "n7": ((0.31, 0.17, 5.0), (7, 1), 8, 1e30),
    "n45": ((0.31, 0.17, 5.0), (9, 5), 8, 1e30),
    "all_miss": ((0.0, 0.0, -5.0), (40, 24), 8, 1e30),
    "all_hit": ((0.0, 0.0, 0.9), (40, 24), 8, 1e30),
    "s1": ((0.31, 0.17, 5.0), (40, 24), 1, 1e30),
    "s32": ((0.31, 0.17, 5.0), (40, 24), 32, 1e30),
    "short_radius": ((0.31, 0.17, 5.0), (40, 24), 8, 0.05),
}


@pytest.mark.parametrize("case", list(AO_CASES))
def test_ao_fused_edge_shapes(dev, config_a_small, case):
    eye, (w, h), S, radius = AO_CASES[case]
    center = (0.0, 0.0, -10.0) if case == "all_miss" else (0.0, 0.0, 0.0)
    tabs, flat, draws = _ao_inputs(config_a_small, eye, w, h, S, center)
    want = _ao_on_both(dev, tabs, flat, draws, radius)
    if case == "all_miss":
        assert not bool(want[5].any()) and int(ao_fused.LAST_ITEMS) == 0
    if case == "all_hit":
        assert bool(want[5].all())


@pytest.mark.parametrize("grid", [1, 3])
def test_ao_fused_warps_claim_many_tiles(dev, config_a_small, monkeypatch,
                                         grid):
    # 960 pixels (30 tiles) on 4 or 12 warps, launched twice: the second
    # launch's tile counter starts at 0 again
    monkeypatch.setattr(ao_fused, "ao_grid", lambda *a: grid)
    tabs, flat, draws = _ao_inputs(config_a_small, (0.31, 0.17, 5.0), 40, 24,
                                   8)
    _ao_on_both(dev, tabs, flat, draws, launches=2)


def test_ao_fused_more_tiles_than_resident_warps(dev, config_a_small):
    occ = ao_fused.ao_occupancy(dev)
    warps = occ["blocks_per_sm"] * occ["sms"] * occ["threads"] // 32
    w = 512
    h = -(-(32 * warps + 1000) // w)
    assert ao_fused.ao_grid(w * h, occ["blocks_per_sm"], occ["sms"]) \
        == occ["blocks_per_sm"] * occ["sms"]
    tabs, flat, draws = _ao_inputs(config_a_small, (0.31, 0.17, 5.0), w, h,
                                   2)
    _ao_on_both(dev, tabs, flat, draws)


def test_ao_fused_occupancy_and_grid(dev):
    occ = ao_fused.ao_occupancy(dev)
    assert occ["threads"] == ao_fused.THREADS
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    assert occ["shared_bytes"] > 0
    assert occ["sms"] == torch.cuda.get_device_properties(
        dev).multi_processor_count
    resident = occ["blocks_per_sm"] * occ["sms"]
    assert ao_fused.ao_grid(1 << 30, occ["blocks_per_sm"],
                            occ["sms"]) == resident
    assert ao_fused.ao_grid(5, occ["blocks_per_sm"], occ["sms"]) == 1


def test_ao_fused_small_stack_sets_error_word(dev, config_a_small,
                                             monkeypatch):
    # one stack slot cannot hold a node's children: the kernel must say so
    # (the real check fails the stream, which would poison the process)
    words = []
    monkeypatch.setattr(fused_trace, "check_overflow",
                        lambda err, slots: words.append((err, slots)))
    tabs, flat, draws = _ao_inputs(config_a_small, (0.31, 0.17, 5.0), 40, 24,
                                   2)
    nodes, leafs, aux, _ = tabs
    on = [x.to(dev) for x in (nodes, leafs, aux, *flat, draws)]
    ao_fused.ao_fused_outputs(*on, 1e30, 1)
    (err, slots), = words
    assert slots == 1 and err.is_cuda and int(err.item()) != 0


def test_render_ao_launches_k1_only(dev, config_a_small, monkeypatch):
    mesh, bvh, s16, _ = config_a_small

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(packet, "_traverse_reference", plain)
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=64, height=64,
                  fov=45.0, device=dev)
    before = trace.counts()
    aovs, _ = objrender.render_ao(bvh, mesh, pinhole_rays(cam), seed=7,
                                  max_leaf=8, scene8=s16.to(dev))
    assert aovs["ao"].is_cuda and aovs["ao"].shape == (64, 64)
    assert 0.0 < float(aovs["ao"].mean()) < 1.0
    # the primary pass and one occlusion megabatch of 8 samples a pixel,
    # the AOVs of the primary pass, and the camera
    assert trace.since(before) == {"packet_traverse": 2,
                                   "k1.rays": 64 * 64 * 9, "aovs_fused": 1,
                                   "pinhole_fused": 1}


def test_stack_engine_on_card_matches_cpu(dev, config_a_small):
    mesh, bvh, _, _ = config_a_small
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=16, height=16,
                  fov=45.0, device="cpu")
    rays = pinhole_rays(cam)
    draws = objrender.ao_hemisphere_draws(torch.Generator().manual_seed(3),
                                          4, (16, 16))
    want, want_h = objrender.render_ao(bvh, mesh, rays, n_samples=4,
                                       max_leaf=8, draws=draws)
    got, got_h = objrender.render_ao(
        bvh, mesh, nt.Rays(*(x.to(dev) for x in rays)), n_samples=4,
        max_leaf=8, draws=draws.to(dev))
    for a, b in zip(got_h, want_h):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    assert torch.equal(got["ao"].cpu(), want["ao"])


# ---- the perspective camera (csrc/camera.cu)

CAMERA_CASES = {
    "8192sq": (8192, 8192, (0.0, 0.0, 2.2), (0.0, 0.0, 0.0), 60.0),
    "4k_lidar": (3840, 2160, (500.0, 262.0, 547.0), (0.0, 12.0, 0.0), 45.0),
    "odd": (37, 23, (0.3, 0.2, 4.0), (0.0, 0.1, 0.0), 120.0),
    "ragged_rows": (4099, 3, (-0.7, 0.4, -2.5), (0.0, 0.0, 0.0), 20.0),
}


@pytest.mark.parametrize("case", list(CAMERA_CASES))
def test_camera_kernel_equals_plain(dev, case):
    """One ``pinhole_fused`` launch a call, and every field of the batch
    the plain version's bit for bit on the same card: the 8K frame, the
    LiDAR viewer's 4K frame 740 m out, and widths that are not a multiple
    of 4."""
    from nanort_tpu_torch.models import cameras

    w, h, eye, center, fov = CAMERA_CASES[case]
    cam = look_at(eye, center, width=w, height=h, fov=fov, device=dev)
    before = trace.counts()
    got = pinhole_rays(cam)
    assert trace.since(before) == {"pinhole_fused": 1}
    want = cameras._pinhole_plain(cam)
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == torch.float32 and a.is_contiguous()
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    del got, want
    torch.cuda.empty_cache()


def test_camera_plain_routes_on_card(dev):
    """A float64 camera and an explicit pixel grid on the card take the
    plain version and launch nothing; ``look_at``'s basis on the card is
    the CPU's bit for bit."""
    from nanort_tpu_torch.models import cameras

    kw = dict(eye=(0.3, 0.2, 2.4), center=(0, 0.1, 0), width=24, height=16,
              fov=70.0)
    c64 = look_at(dtype=torch.float64, device=dev, **kw)
    c32 = look_at(device=dev, **kw)
    before = trace.counts()
    got = pinhole_rays(c64)
    x, y = cameras.pixel_grid(c32)
    grid = pinhole_rays(c32, (x + 0.25, y))
    assert trace.since(before) == {}
    assert got.dir.dtype == torch.float64 and got.dir.is_cuda
    assert torch.equal(grid.dir, cameras._pinhole_plain(c32, (x + 0.25, y)).dir)
    cpu = look_at(device="cpu", **kw)
    for a, b in zip(c32[:4], cpu[:4]):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ---- objrender's AOVs (csrc/aovs.cu)

AOV_KEYS = ("rgb", "normal", "position", "depth", "texcoord", "prim_id",
            "hit")


@pytest.mark.parametrize("bs", [(96, 160), (100_003,)],
                         ids=["image", "flat"])
@pytest.mark.parametrize("face_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("facevarying", [False, True],
                         ids=["geometric", "facevarying"])
def test_aovs_kernel_equals_plain(dev, bs, face_dtype, facevarying):
    """One launch a call, and every AOV the plain version's bit for bit
    on the same card tensors: hits and misses, degenerate triangles
    (``testing.aov_case``)."""
    case = aov_case(bs, 9, face_dtype, facevarying, device=dev)
    before = trace.counts()
    got = objrender.aovs_from_hits(*case)
    assert trace.since(before) == {"aovs_fused": 1}
    want = objrender._aovs_plain(*case)
    for k in AOV_KEYS:
        assert got[k].is_cuda and got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert got["rgb"].is_contiguous() and got["texcoord"].shape == bs + (2,)


def test_aovs_float64_on_card_take_the_plain_version(dev):
    case = aov_case((64, 48), 3, np.int32, True, "float64", device=dev)
    before = trace.counts()
    got = objrender.aovs_from_hits(*case)
    assert trace.since(before) == {}
    assert got["rgb"].is_cuda and got["rgb"].dtype == torch.float64


def test_aovs_id_past_the_faces_fails_on_card(dev):
    """A hit whose prim id names no face fails the launch, where the plain
    version's gather fails too. The trap poisons the process's CUDA
    context: run it in a child."""
    import os
    import subprocess
    import sys

    code = """
import numpy as np, torch
from nanort_tpu_torch.models import objrender
from nanort_tpu_torch.testing import aov_case
mesh, attrs, rays, hits = aov_case((4096,), 9, np.int32, device="cuda")
prim = hits.prim_id.clone()
prim[77] = len(mesh.faces)
torch.cuda.synchronize()
try:
    objrender.aovs_from_hits(mesh, None, rays, hits._replace(prim_id=prim))
    torch.cuda.synchronize()
    print("NO ERROR")
except RuntimeError as e:
    print("RAISED", "CUDA" in str(e))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=300)
    assert "RAISED True" in r.stdout, (r.stdout, r.stderr[-2000:])


def test_render_aovs_frame_on_card(dev):
    """A 256 x 192 frame through K1 (image-tiled): one K1 and one AOV
    launch, and the AOVs equal the plain version's on the same records;
    the mesh is handed over on the host, as the examples may."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(24, 48, 0.5))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    rays = pinhole_rays(look_at((0.4, 0.3, 3.2), (0, 0, 0), width=256,
                                height=192, fov=50.0, device=dev))
    mesh = TriangleMesh(v, f)
    before = trace.counts()
    got, hits = objrender.render_aovs(bvh, mesh, rays, scene8=s16)
    assert _launched(before) == {"packet_traverse": 1, "aovs_fused": 1}
    want = objrender._aovs_plain(mesh, None, rays, hits)
    for k in AOV_KEYS:
        assert got[k].is_cuda and torch.equal(got[k], want[k]), k
    assert 0.3 < float(got["hit"].float().mean()) < 1.0


# --------------------------------- K1's modes, K1b and the treelet engine

def _modes_scene(width, woop=False):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    return _scene(v, f, width, woop=woop)


def _edge_case():
    """The Cornell box (leaf 2) and ``testing.zero_edge_rays``: edge
    functions that round to 0; then random rays."""
    v, f, org, d = zero_edge_rays(512)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2))
    rng = np.random.default_rng(4)
    r = rng.normal(size=(1500, 3)).astype(np.float32)
    org = np.concatenate([org, rng.uniform(-0.9, 0.9, (1500, 3)).astype(
        np.float32)])
    d = np.concatenate([d, r / np.linalg.norm(r, axis=1, keepdims=True)])
    return (collapse_bvh8(bvh, v, f, width=8),
            nt.make_rays(torch.from_numpy(org), torch.from_numpy(d)))


def _same_records(got, want):
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a.cpu(), b)


def _mode_on_both(scene, rays, dev, key, *args, **kw):
    """The kernel on the card (one launch, counted under ``key``) and the
    plain version on the CPU give the same records bit for bit."""
    before = trace.counts()
    got = packet.traverse_bvh8(
        scene.to(dev), nt.Rays(*(x.to(dev) for x in rays)), *args,
        **{k: (x.to(dev) if isinstance(x, torch.Tensor) else x)
           for k, x in kw.items()})
    assert trace.since(before) == {key: 1,
                                   "k1.rays": rays.org.numel() // 3}
    want = packet.traverse_bvh8(scene, rays, *args, **kw)
    if isinstance(want, tuple) and not isinstance(want, nt.Hits):
        _same_records(got[0], want[0])
        got, want = got[1:], want[1:]
    _same_records(got, want)


@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_counts_kernel_matches_plain(dev, width, occlusion):
    _mode_on_both(_modes_scene(width), _rays(3001, 7), dev,
                  "packet_traverse[counts]", occlusion=occlusion,
                  debug_counts=True)


@pytest.mark.parametrize("case", ["edges", "random"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_flags_kernel_matches_plain(dev, occlusion, case):
    if case == "edges":
        scene, rays = _edge_case()
    else:
        scene, rays = _modes_scene(16), _rays(3001, 8)
    _mode_on_both(scene, rays, dev, "packet_traverse[flags]",
                  nt.BVHTraceOptions(exact_edge_fallback=False),
                  occlusion=occlusion, _flag_zero_edges=True)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("intersector", ["watertight", "woop"])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_interleave_kernel_matches_plain(dev, width, occlusion, intersector,
                                         K):
    _mode_on_both(_modes_scene(width, woop=intersector == "woop"),
                  _rays(3001, 9), dev, f"packet_traverse[interleave={K}]",
                  occlusion=occlusion, intersector=intersector, interleave=K)


@pytest.mark.parametrize("kw", [dict(), dict(occlusion=True),
                                dict(intersector="woop"),
                                dict(interleave=2), dict(debug_counts=True)])
def test_roots_kernel_matches_plain(dev, kw):
    from nanort_tpu_torch.traverse import treelet

    tl, scene = treelet.make_treelets(
        _modes_scene(8, woop=kw.get("intersector") == "woop"), 24)
    rays = _rays(3001, 10)
    roots = tl.roots[np.random.default_rng(1).integers(0, tl.count, 24)]
    key = ("packet_traverse[interleave=2]" if "interleave" in kw
           else "packet_traverse[counts]" if "debug_counts" in kw
           else "packet_traverse[roots]")
    _mode_on_both(scene, rays, dev, key, sub=1,
                  packet_roots=torch.from_numpy(roots), **kw)


def test_binned_engine_launches_kernels_only(dev, monkeypatch):
    from nanort_tpu_torch.traverse import treelet

    tl, scene = treelet.make_treelets(_modes_scene(8), 24)
    rays = _rays(4099, 11, broken=False)
    want = treelet.traverse_bvh8_binned(scene, rays, treelets=tl, K=4, sub=1)
    glob = packet.traverse_bvh8(_modes_scene(8), rays)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(packet, "_traverse_reference", plain)
    before = trace.counts()
    got = treelet.traverse_bvh8_binned(
        scene, nt.Rays(*(x.to(dev) for x in rays)), treelets=tl, K=4, sub=1)
    sweeps = _launched(before).get("packet_traverse[roots]", 0)
    assert 2 <= sweeps <= 3
    assert _launched(before) == {"packet_traverse[roots]": sweeps}
    _same_records(got, want)
    assert torch.equal(got.t.cpu(), glob.t)


def test_two_pass_exact_on_card_matches_cpu(dev):
    scene, rays = _edge_case()
    rd = nt.Rays(*(x.to(dev) for x in rays))
    sd = scene.to(dev)
    single = packet.traverse_bvh8(scene, rays)
    # sub=1: 4 of 16 packets flag, so the whole batch is retraced; sub=16:
    # its one packet flags and is retraced
    for sub in (1, 16):
        before = trace.counts()
        _same_records(packet.traverse_bvh8_exact(sd, rd, sub=sub), single)
        assert _launched(before)["packet_traverse[flags]"] == 1
    got, overflow = packet.traverse_bvh8_exact_fused(sd, rd)
    assert overflow.is_cuda and not bool(overflow)
    _same_records(got, single)


# ------------------------------ K1's schedule: persistent warps, claims

def _grid(monkeypatch, grid, **kw):
    """K1 launches on ``grid`` blocks, so that every warp claims many
    times even on a small batch (``kw`` overrides more of the plan)."""
    real = packet.launch_plan
    monkeypatch.setattr(packet, "launch_plan", lambda *a: dataclasses.replace(
        real(*a), grid=grid, **kw))


def _soup(width, n_rays=1500):
    """``testing.overlap_soup``: deep walks."""
    v, f, org, d = overlap_soup(600, n_rays)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=1, max_leaf_primitives=1))
    return (collapse_bvh8(bvh, v, f, width=width),
            nt.make_rays(torch.from_numpy(org), torch.from_numpy(d)))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
@pytest.mark.parametrize("width", [8, 16])
def test_k1_ray_counts_match_plain(dev, width, n):
    _same_on_both(_modes_scene(width), _rays(n, 12), dev)


def test_k1_claims_that_do_not_divide_the_grid(dev):
    scene = _modes_scene(16)
    occ = packet.k1_occupancy(16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = occ["blocks_per_sm"] * sms * packet.K1_THREADS // 32
    n = packet.K1_CLAIM * (warps + 3) + 5
    plan = packet.launch_plan(n, occ["blocks_per_sm"], sms)
    assert plan.grid == occ["blocks_per_sm"] * sms
    assert -(-n // packet.K1_CLAIM) % warps != 0
    _same_on_both(scene, _rays(n, 13), dev)


SCHEDULE_MODES = {
    "closest": ("packet_traverse", dict()),
    "any_hit": ("packet_traverse", dict(occlusion=True)),
    "cull": ("packet_traverse", dict(options=OPTIONS["cull"])),
    "range": ("packet_traverse", dict(options=OPTIONS["range"])),
    "no_exact": ("packet_traverse", dict(options=OPTIONS["no_exact_edges"])),
    "woop": ("packet_traverse_woop", dict(intersector="woop")),
    "woop_any_hit": ("packet_traverse_woop", dict(intersector="woop",
                                                  occlusion=True)),
    "counts": ("packet_traverse[counts]", dict(debug_counts=True)),
    "flags": ("packet_traverse[flags]", dict(
        options=OPTIONS["no_exact_edges"], _flag_zero_edges=True)),
}


@pytest.mark.parametrize("mode", list(SCHEDULE_MODES))
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("grid", [1, 3])
def test_k1_small_grid_matches_plain(dev, monkeypatch, grid, width, mode):
    # 12 warps at grid 3: 935 rays are 30 claims, 2.5 a warp
    _grid(monkeypatch, grid)
    key, kw = SCHEDULE_MODES[mode]
    _mode_on_both(_modes_scene(width, woop="intersector" in kw),
                  _rays(935, 14), dev, key, **kw)


@pytest.mark.parametrize("grid", [None, 2])
def test_k1_skip_small_grid_matches_plain(dev, monkeypatch, grid):
    if grid:
        _grid(monkeypatch, grid)
    scene = _modes_scene(16)
    rays = _rays(935, 15)
    _same_on_both(scene, rays, dev,
                  skip_prim_id=packet.traverse_bvh8(scene, rays).prim_id)


@pytest.mark.parametrize("case", ["all_dead", "dead_tail"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_k1_dead_rays_match_plain(dev, monkeypatch, case, occlusion):
    _grid(monkeypatch, 2)
    rays = _rays(3001, 16, broken=False)
    dead = torch.ones(3001, dtype=torch.bool)
    if case == "dead_tail":  # ray_sort's order: the dead ones last
        dead[:1800] = False
    rays = rays._replace(max_t=torch.where(dead, -1.0, rays.max_t))
    _same_on_both(_modes_scene(16), rays, dev, occlusion=occlusion)


@pytest.mark.parametrize("sub", [1, 3])
@pytest.mark.parametrize("grid", [None, 2])
def test_k1_roots_across_claims_match_plain(dev, monkeypatch, sub, grid):
    # packets of 128 or 384 rays span 4 or 12 claims; the last is partial
    from nanort_tpu_torch.traverse import treelet

    if grid:
        _grid(monkeypatch, grid)
    tl, scene = treelet.make_treelets(_modes_scene(8), 24)
    n = 3001
    n_pk = -(-n // (sub * packet.LANES))
    roots = tl.roots[np.random.default_rng(2).integers(0, tl.count, n_pk)]
    _mode_on_both(scene, _rays(n, 17), dev, "packet_traverse[roots]",
                  sub=sub, packet_roots=torch.from_numpy(roots))


@pytest.mark.parametrize("mode", ["closest", "any_hit", "woop", "counts",
                                  "flags"])
@pytest.mark.parametrize("width", [8, 16])
def test_k1_deep_stack_matches_plain(dev, width, mode):
    """Walks that leave entries behind on more than two levels."""
    scene, rays = _soup(width)
    if mode == "woop":
        v, f, _, _ = overlap_soup(600, 1)
        bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
            min_leaf_primitives=1, max_leaf_primitives=1))
        scene = collapse_bvh8(bvh, v, f, width=width, woop=True)
    stats = {}
    packet._traverse_reference(
        torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs), width,
        rays.org, rays.dir, rays.min_t, rays.max_t, None, None, False, True,
        False, packet.stack_slots(scene), stats=stats)
    assert stats["max_sp"] > 2 * (width - 1)
    key, kw = SCHEDULE_MODES[mode]
    _mode_on_both(scene, rays, dev, key, **kw)


@pytest.mark.parametrize("K", [2, 4])
def test_interleave_deep_stack_matches_plain(dev, K):
    scene, rays = _soup(16)
    _mode_on_both(scene, rays, dev, f"packet_traverse[interleave={K}]",
                  interleave=K)


# ------------------------------ K1b: claims of 32 K rays, idle lanes refilled

@pytest.mark.parametrize("n", [1, 31, 33, 69, 133, 1000])
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("K", [2, 4])
def test_k1b_ray_counts_match_plain(dev, K, width, n):
    # n < 32 and counts that are not a multiple of a 32 K-ray claim
    _mode_on_both(_modes_scene(width), _rays(n, 12), dev,
                  f"packet_traverse[interleave={K}]", interleave=K)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("mode", ["closest", "any_hit", "woop",
                                  "woop_any_hit", "cull", "range"])
@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("K", [2, 4])
def test_k1b_small_grid_matches_plain(dev, monkeypatch, K, grid, mode,
                                      spread):
    # every warp takes many claims (of 32 K rays, or of 32 as the plan
    # gives any-hit launches) and refills its lanes many times
    _grid(monkeypatch, grid, claim=packet.K1_CLAIM * (1 if spread else K))
    _, kw = SCHEDULE_MODES[mode]
    _mode_on_both(_modes_scene(16, woop="intersector" in kw),
                  _rays(3001, 14), dev, f"packet_traverse[interleave={K}]",
                  interleave=K, **kw)


@pytest.mark.parametrize("case", ["all_dead", "dead_tail"])
@pytest.mark.parametrize("K", [2, 4])
def test_k1b_dead_rays_match_plain(dev, monkeypatch, K, case):
    _grid(monkeypatch, 2)
    rays = _rays(3001, 16, broken=False)
    dead = torch.ones(3001, dtype=torch.bool)
    if case == "dead_tail":
        dead[:1800] = False
    rays = rays._replace(max_t=torch.where(dead, -1.0, rays.max_t))
    for occlusion in (False, True):
        _mode_on_both(_modes_scene(8), rays, dev,
                      f"packet_traverse[interleave={K}]", interleave=K,
                      occlusion=occlusion)


@pytest.mark.parametrize("sub", [1, 3])
@pytest.mark.parametrize("K", [2, 4])
def test_k1b_roots_across_claims_match_plain(dev, monkeypatch, K, sub):
    from nanort_tpu_torch.traverse import treelet

    _grid(monkeypatch, 2)
    tl, scene = treelet.make_treelets(_modes_scene(8), 24)
    n = 3001
    n_pk = -(-n // (sub * packet.LANES))
    roots = tl.roots[np.random.default_rng(2).integers(0, tl.count, n_pk)]
    _mode_on_both(scene, _rays(n, 17), dev,
                  f"packet_traverse[interleave={K}]", sub=sub,
                  packet_roots=torch.from_numpy(roots), interleave=K)


@pytest.mark.parametrize("K", [2, 4])
def test_k1b_large_stack_matches_plain(dev, monkeypatch, K):
    # deep walks with more stack slots than the frame's BVH16 needs (both
    # sides get the same 200 slots)
    scene, rays = _soup(8)
    monkeypatch.setattr(packet, "stack_slots", lambda s: 200)
    _mode_on_both(scene, rays, dev, f"packet_traverse[interleave={K}]",
                  interleave=K)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("woop", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_k1b_occupancy_and_plan(dev, width, woop, K):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = packet.k1_occupancy(width, woop, interleave=K)
    assert occ["threads"] == packet.K1_THREADS
    assert occ["claim"] == packet.K1_CLAIM * K
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    assert occ["shared_bytes"] == 0
    # K1's stack of STACK_CAP entries a thread
    assert occ["local_bytes"] >= packet.STACK_CAP * 4
    plan = packet.launch_plan(1 << 26, occ["blocks_per_sm"], sms, K)
    assert plan.grid == occ["blocks_per_sm"] * sms
    assert plan.claim == packet.K1_CLAIM * K
    # an any-hit launch claims one packet at a time
    assert packet.launch_plan(1 << 26, occ["blocks_per_sm"], sms, K,
                              True).claim == packet.K1_CLAIM


@pytest.mark.parametrize("mode", ["closest", "interleave"])
def test_k1_small_stack_sets_error_word(dev, monkeypatch, mode):
    scene, rays = _soup(16, 64)
    words = []
    monkeypatch.setattr(packet, "stack_slots", lambda s: 3)
    monkeypatch.setattr(packet, "_check_overflow",
                        lambda err, slots: words.append((err, slots)))
    packet.traverse_bvh8(scene.to(dev), nt.Rays(*(x.to(dev) for x in rays)),
                         interleave=2 if mode == "interleave" else 1)
    (err, slots), = words
    assert slots == 3 and err.is_cuda and int(err.item()) != 0


def test_k1_small_stack_raises(dev):
    # the real check fails the stream, which poisons the process's CUDA
    # context: run it in a child
    import os
    import subprocess
    import sys

    code = """
import torch
import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import overlap_soup
from nanort_tpu_torch.traverse import packet
v, f, org, d = overlap_soup(600, 64)
bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
    min_leaf_primitives=1, max_leaf_primitives=1))
scene = collapse_bvh8(bvh, v, f, width=16).to("cuda")
packet.stack_slots = lambda s: 3
rays = nt.make_rays(torch.from_numpy(org).cuda(), torch.from_numpy(d).cuda())
try:
    packet.traverse_bvh8(scene, rays)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", "overflow" in str(e) or "assert" in str(e).lower())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=300)
    assert "RAISED True" in r.stdout, (r.stdout, r.stderr[-2000:])


@pytest.mark.parametrize("mode", ["plain", "woop", "counts", "flags",
                                  "roots"])
@pytest.mark.parametrize("width", [8, 16])
def test_k1_occupancy_and_plan(dev, width, mode):
    kw = {mode: True} if mode != "plain" else {}
    if mode == "flags" or mode == "plain":
        kw.setdefault("woop", False)
    occ = packet.k1_occupancy(width, **kw)
    assert occ["threads"] == packet.K1_THREADS
    assert occ["claim"] == packet.K1_CLAIM
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = packet.launch_plan(1 << 26, occ["blocks_per_sm"], sms)
    assert plan.grid == occ["blocks_per_sm"] * sms
    # the whole stack is a local array: no shared memory, a frame of
    # STACK_CAP entries
    assert occ["shared_bytes"] == 0
    assert occ["local_bytes"] >= packet.STACK_CAP * 4


# ------------------------------ the device build and the traversal features

DEVICE_BUILDS = {
    "w16": dict(width=16),
    "w16_woop_sah": dict(width=16, woop=True, merge_leaves=False,
                         preorder=False, sah_levels=4, sah_stop=16),
    "w8": dict(width=8),
    "w8_woop": dict(width=8, woop=True),
}


@pytest.fixture(scope="module")
def lbvh_mesh():
    return merge_meshes(make_cornell_box(2.0), make_uv_sphere(24, 48, 0.5))


@pytest.mark.parametrize("case", list(DEVICE_BUILDS))
def test_device_build_on_card_equals_cpu(dev, lbvh_mesh, case):
    from nanort_tpu_torch.build.device_collapse import collapse_lbvh_device
    from nanort_tpu_torch.testing import wide_table_report

    v, f = lbvh_mesh
    cpu = collapse_lbvh_device(v, f, device="cpu", **DEVICE_BUILDS[case])
    card = collapse_lbvh_device(torch.from_numpy(v).to(dev),
                                torch.from_numpy(f).to(dev),
                                **DEVICE_BUILDS[case])
    for k in ("nodes", "leafs", "leafs_woop"):
        a, b = getattr(card, k), getattr(cpu, k)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.is_cuda and a.is_contiguous()
            assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    for k in ("num_nodes", "num_leaf_rows", "depth", "max_leaf", "width"):
        assert getattr(card, k) == getattr(cpu, k)
    assert wide_table_report(card, len(f))["ok"]


def test_lbvh_and_refit_on_card_equal_cpu(dev, lbvh_mesh):
    from nanort_tpu_torch.build.lbvh import build_lbvh
    from nanort_tpu_torch.build.refit import refit_bvh
    from nanort_tpu_torch.ops.triangle import triangle_prim_bounds
    from nanort_tpu_torch.testing import same_bits

    v, f = lbvh_mesh
    bmin, bmax, ctr = triangle_prim_bounds(TriangleMesh(v, f))
    cpu, _ = build_lbvh(bmin, bmax, ctr, device="cpu")
    card, _ = build_lbvh(torch.from_numpy(bmin).to(dev),
                         torch.from_numpy(bmax).to(dev),
                         torch.from_numpy(ctr).to(dev))
    assert all(same_bits(a, b) for a, b in zip(card, cpu))
    v2 = v * np.asarray([1.0, 0.4, 1.3], np.float32)
    b2 = triangle_prim_bounds(TriangleMesh(v2, f))
    assert all(same_bits(a, b) for a, b in zip(
        refit_bvh(cpu, *b2[:2], device=dev),
        refit_bvh(cpu, *b2[:2], device="cpu")))


@pytest.mark.parametrize("grid", ["plan", 1, "claims"])
@pytest.mark.parametrize("case", list(DEVICE_BUILDS))
def test_k1_on_device_tables_matches_plain(dev, monkeypatch, lbvh_mesh, case,
                                           grid):
    """K1 and K1-woop on device-built tables (power-of-two padding, a
    park row, LBVH topology): the launch plan's grid, one block, and
    more 32-ray claims than resident warps."""
    from nanort_tpu_torch.build.device_collapse import collapse_lbvh_device

    v, f = lbvh_mesh
    scene = collapse_lbvh_device(v, f, device="cpu", **DEVICE_BUILDS[case])
    n = 3001
    if grid == 1:
        _grid(monkeypatch, 1)
    elif grid == "claims":
        occ = packet.k1_occupancy(scene.width, woop=scene.leafs_woop
                                  is not None)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        warps = occ["blocks_per_sm"] * sms * packet.K1_THREADS // 32
        n = packet.K1_CLAIM * (warps + 3) + 5
    rays = _rays(n, 14)
    if scene.leafs_woop is not None:
        _same_on_both(scene, rays, dev, intersector="woop")
    _same_on_both(scene, rays, dev)


def test_spheres_on_card_match_cpu(dev):
    from nanort_tpu_torch.ops import sphere

    rng = np.random.default_rng(8)
    c = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.1, 4000).astype(np.float32)
    bvh, _ = sphere.build_sphere_bvh(interop.spheres_from_numpy(
        c, r, device="cpu"))
    rays = _rays(2048, 15, broken=False)
    want = sphere.traverse_spheres(
        bvh, interop.spheres_from_numpy(c, r, device="cpu"), rays)
    got = sphere.traverse_spheres(
        bvh, interop.spheres_from_numpy(c, r, device=dev),
        nt.Rays(*(x.to(dev) for x in rays)))
    from nanort_tpu_torch.testing import compare_hits

    res = compare_hits(got, want, uv_atol=1e-6)
    assert res["ok"] and res["hits"] > 100, res


@pytest.mark.parametrize("engine", ["stack", "wavefront"])
def test_multi_hit_on_card_matches_cpu(dev, lbvh_mesh, engine):
    from nanort_tpu_torch.testing import ulp_distance
    from nanort_tpu_torch.traverse import multi_hit
    from nanort_tpu_torch.traverse.packed import pack_scene

    v, f = lbvh_mesh
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
    rays = _rays(2048, 16, broken=False)
    mesh = TriangleMesh(torch.from_numpy(v), torch.from_numpy(f))
    if engine == "stack":
        want = multi_hit.multi_hit_traverse(bvh, mesh, rays, 8)
        got = multi_hit.multi_hit_traverse(
            bvh, TriangleMesh(mesh.vertices.to(dev), mesh.faces.to(dev)),
            nt.Rays(*(x.to(dev) for x in rays)), 8)
    else:
        packed = pack_scene(bvh, v, f)
        want = multi_hit.multi_hit_wavefront(packed, rays, 8)
        got = multi_hit.multi_hit_wavefront(
            packed, nt.Rays(*(x.to(dev) for x in rays)), 8)
    assert got.t.is_cuda
    assert torch.equal(got.count.cpu(), want.count)
    assert torch.equal(got.prim_id.cpu(), want.prim_id)
    assert int(ulp_distance(got.t.cpu(), want.t).max()) <= 4
    assert int(want.count.max()) >= 2


# ---- the scene graph, the Embree-style API and the renderers

def _rtc_scene(device, fast):
    """Five transformed spheres of one mesh on a ring, committed on
    ``device``."""
    from nanort_tpu_torch.api import rtc
    from nanort_tpu_torch.scene import matrix as mat

    sv, sf = make_uv_sphere(16, 32, 0.6)
    sc = rtc.new_device(device=device).new_scene()
    for k in range(5):
        a = 2.0 * np.pi * k / 5
        g = sc.new_triangle_mesh(len(sf), len(sv))
        sc.map_buffer(g, rtc.BufferType.VERTEX)[:] = sv
        sc.map_buffer(g, rtc.BufferType.INDEX)[:] = sf
        sc.set_transform(g, mat.compose(
            mat.translate([2.0 * np.cos(a), 0.2 * k, 2.0 * np.sin(a)]),
            mat.rotate([0.2, 1.0, 0.1], 0.5 * k), mat.scale([1, 1.2, 0.8])))
    sc.commit(fast=fast)
    return sc


def _ring_rays(n=4096, seed=17):
    rng = np.random.default_rng(seed)
    org = np.tile(np.asarray([[0.0, 0.4, 6.0]], np.float32), (n, 1))
    tgt = rng.uniform(-3.0, 3.0, (n, 3)) * [1, 1, 0.5]
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))


def _close_scene_hits(got, want):
    """Scene hit records on the card against the CPU's: the same hit
    mask and ids, t within 4 ulp where both hit, the other floats within
    1e-5 (plain torch on both; the traversal records are K1's or the
    wavefront walk's)."""
    from nanort_tpu_torch.testing import ulp_distance

    g = type(got)(*(x.cpu() for x in got))
    assert torch.equal(g.hit, want.hit)
    assert torch.equal(g.prim_id, want.prim_id)
    assert torch.equal(g.node_id, want.node_id)
    h = want.hit
    assert int(ulp_distance(g.t[h], want.t[h]).max(initial=0)) <= 4
    for k in ("u", "v", "position", "normal_g", "normal_s"):
        assert float((getattr(g, k) - getattr(want, k)).abs().max()) <= 1e-5


@pytest.mark.parametrize("fast", [True, False])
def test_rtc_on_card_equals_cpu(dev, fast):
    """``intersect`` and ``occluded`` on the card against the same calls
    on the CPU (``_close_scene_hits``); the fast route launches K1 once a
    call."""
    card, cpu = _rtc_scene(dev, fast), _rtc_scene("cpu", fast)
    assert (card._scene8 is not None) == fast
    rays = _ring_rays()
    crays = nt.Rays(*(x.to(dev) for x in rays))
    before = trace.counts()
    got = card.intersect(crays)
    occ = card.occluded(crays)
    n = _launched(before).get("packet_traverse", 0)
    assert n == (2 if fast else 0)
    want = cpu.intersect(rays)
    assert bool(want.hit.any())
    _close_scene_hits(got, want)
    assert torch.equal(occ.cpu(), cpu.occluded(rays))


def test_rtc_k1_equals_plain_on_sorted_rays(dev, monkeypatch):
    """The API's K1 launch, captured with its sorted rays, against the
    plain version on the same tensors."""
    sc = _rtc_scene(dev, True)
    kept = []
    real = packet.traverse_bvh8

    def keep(scene, rays, *a, **k):
        out = real(scene, rays, *a, **k)
        kept.append((scene, rays, a, k, out))
        return out

    monkeypatch.setattr(packet, "traverse_bvh8", keep)
    rays = nt.Rays(*(x.to(dev) for x in _ring_rays()))
    sc.intersect(rays)
    sc.occluded(rays)
    assert len(kept) == 2
    for scene, r, a, k, out in kept:
        cpu = dataclasses.replace(scene, nodes=scene.nodes.cpu(),
                                  leafs=scene.leafs.cpu())
        want = real(cpu, nt.Rays(*(x.cpu() for x in r)), *a,
                    **{n: (x.cpu() if isinstance(x, torch.Tensor) else x)
                       for n, x in k.items()})
        _same_records(out, want)


def test_scene_graph_walk_on_card_equals_cpu(dev):
    from nanort_tpu_torch.scene import graph
    from nanort_tpu_torch.scene import matrix as mat

    sv, sf = make_uv_sphere(12, 24, 0.5)
    bv, bf = make_cornell_box(2.0)

    def build(device):
        sc = graph.Scene(device=device)
        ball = TriangleMesh(sv, sf)
        for k in range(4):
            sc.add_node(graph.Node(f"b{k}", ball, mat.compose(
                mat.translate([0.6 * k - 0.9, 0.1 * k, 0]),
                mat.rotate([0, 1, 0], 0.3 * k))))
        sc.add_node(graph.Node("box", TriangleMesh(bv, bf), mat.scale(1.5)))
        sc.commit()
        return sc

    rays = _ring_rays(2048, 18)
    before = trace.counts()
    got = build(dev).traverse(nt.Rays(*(x.to(dev) for x in rays)))
    assert trace.since(before) == {}  # the graph walks the plain engine
    want = build("cpu").traverse(rays)
    assert bool(want.hit.any())
    _close_scene_hits(got, want)


def test_render_pbr_on_card_equals_cpu(dev):
    """``render_pbr`` with BVH16 tables: two K1 launches on the card, the
    same records as on the CPU, and the image and AOVs within 1e-5 (plain
    torch shading on both)."""
    from nanort_tpu_torch.models import pbr

    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
    s8 = _scene(v, f, 16)
    mat = pbr.PBRMaterial(torch.tensor([0.7, 0.6, 0.5]), torch.tensor(0.2),
                          torch.tensor(0.4))

    def render(device):
        rays = pinhole_rays(look_at((0.2, 0.3, 2.4), (0, 0, 0), width=128,
                                    height=128, fov=60, device=device))
        mesh = TriangleMesh(torch.from_numpy(v).to(device),
                            torch.from_numpy(f).to(device))
        return pbr.render_pbr(bvh, mesh, rays,
                              pbr.PBRMaterial(*(x.to(device) for x in mat)),
                              scene8=s8.to(device))

    before = trace.counts()
    got, gh = render(dev)
    assert _launched(before).get("packet_traverse", 0) == 2
    want, wh = render("cpu")
    assert float(want["rgb"].mean()) > 0.01
    _same_records(gh, wh)
    assert torch.equal(got["prim_id"].cpu(), want["prim_id"])
    for k in ("rgb", "normal", "position", "depth"):
        assert float((got[k].cpu() - want[k]).abs().max()) <= 1e-5, k


def test_sequential_chunks_on_card_equal_cpu(dev):
    """Four packet chunks traced in turn: one K1 launch a chunk, and the
    CPU's plain-K1 records bit for bit (the merge is plain torch)."""
    v, f = make_uv_sphere(32, 64, 1.0)
    sc = sharded_scene.build_scene_chunks(
        TriangleMesh(v, f), 4, nt.BVHBuildOptions(8, 8), packet=True)
    rays = _rays(8192, 31, broken=False)
    before = trace.counts()
    got = sharded_scene.sequential_chunk_traverse(
        sc.to(dev), nt.Rays(*(x.to(dev) for x in rays)))
    assert _launched(before).get("packet_traverse", 0) == 4
    want = sharded_scene.sequential_chunk_traverse(sc, rays)
    assert bool(want.hit.any())
    _same_records(got, want)


def test_to_spheres_on_card(dev, tmp_path):
    rng = np.random.default_rng(41)
    pts = rng.normal(size=(3000, 3)) * [2.0, 2.0, 0.3] + [100.0, 50.0, 8.0]
    path = str(tmp_path / "c.las")
    las.save_las(path, pts)
    cloud = las.load_las(path)
    card = las.to_spheres(cloud, 0.05, device=dev)
    cpu = las.to_spheres(cloud, 0.05, device="cpu")
    assert card.centers.is_cuda and card.radii.is_cuda
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    from nanort_tpu_torch.ops import sphere
    from nanort_tpu_torch.testing import compare_hits

    bvh, _ = sphere.build_sphere_bvh(cpu)
    org = np.tile([[100.0, 50.0, 20.0]], (2048, 1)).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.2, (2048, 2)),
                        -np.ones((2048, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    got = sphere.traverse_spheres(bvh, card,
                                  nt.Rays(*(x.to(dev) for x in rays)))
    want = sphere.traverse_spheres(bvh, cpu, rays)
    res = compare_hits(got, want, uv_atol=1e-6)
    assert res["ok"] and res["hits"] > 100, res


def test_sample_tri_hits_on_card_equals_cpu(dev):
    rng = np.random.default_rng(42)
    faces = [rng.random((2 ** rng.integers(0, 4), 2 ** rng.integers(0, 4),
                         3)).astype(np.float32) for _ in range(300)]
    n = 20000
    pid = rng.integers(0, 600, n).astype(np.int64)
    pid[::9] = 0xFFFFFFFF
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1 - u)).astype(np.float32)
    hits = nt.Hits(*(torch.from_numpy(x) for x in (
        rng.random(n).astype(np.float32), u, v, pid)))
    for quad in (True, False):
        got = ptex.sample_tri_hits(ptex.build_face_textures(faces, device=dev),
                                   nt.Hits(*(x.to(dev) for x in hits)), quad)
        want = ptex.sample_tri_hits(
            ptex.build_face_textures(faces, device="cpu"), hits, quad)
        assert got.is_cuda and torch.equal(got.cpu(), want)


def test_one_rank_nccl_render_step(dev, tmp_path):
    """A one-rank NCCL group through a file store: the mesh engines and
    the render step (with fixed draws) give the group-less CPU mesh's
    records, counts and AO; the collectives run through NCCL."""
    import datetime

    from nanort_tpu_torch.traverse.packed import pack_scene

    dist = torch.distributed
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f))
    geom = TriangleMesh(v, f)
    rays = _rays(4096, 43, broken=False)
    draws = np.random.default_rng(44).random((4096, 3)).astype(np.float32)
    cpu_mesh = pmesh.ray_mesh(1, device="cpu")
    want = [pmesh.sharded_traverse_triangles(bvh, geom, rays, cpu_mesh),
            pmesh.sharded_traverse_wavefront(pack_scene(bvh, v, f), rays,
                                             cpu_mesh),
            pmesh.sharded_render_step(bvh, geom, rays, cpu_mesh,
                                      draws=draws)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = pmesh.ray_mesh(1)
        assert mesh.device.type == "cuda" and mesh.group is not None
        assert dist.get_backend() == "nccl"
        crays = nt.Rays(*(x.to(dev) for x in rays))
        got = [pmesh.sharded_traverse_triangles(bvh, geom, crays, mesh),
               pmesh.sharded_traverse_wavefront(pack_scene(bvh, v, f), crays,
                                                mesh),
               pmesh.sharded_render_step(bvh, geom, crays, mesh, draws=draws)]
    finally:
        dist.destroy_process_group()
    for (gh, gn), (wh, wn) in zip(got[:2], want[:2]):
        _same_records(gh, wh)
        assert int(gn) == int(wn) > 0
    (gao, gn, gm), (wao, wn, wm) = got[2], want[2]
    assert gao.is_cuda and torch.equal(gao.cpu(), wao)
    assert int(gn) == int(wn) and float(gm) == float(wm)


# ---- the example programs and the graft entry on the card



def test_graft_entry_on_card_equals_cpu(dev):
    """``entry()`` makes its rays with the camera kernel, its forward step
    on the card launches K1 and the AOV kernel, and its rgb is the CPU
    run's (their plain versions) bit for bit."""
    from nanort_tpu_torch import graft_entry

    before = trace.counts()
    fn, args = graft_entry.entry()
    assert args[2].org.is_cuda and args[3].nodes.is_cuda
    assert _launched(before) == {"pinhole_fused": 1}
    got = fn(*args)
    assert _launched(before) == {"packet_traverse": 1, "aovs_fused": 1,
                                 "pinhole_fused": 1}
    cfn, cargs = graft_entry.entry(device="cpu")
    want = cfn(*cargs)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert float(want.mean()) > 0.1


def test_objrender_program_on_card(dev, tmp_path):
    """The OBJ path at 64^2: the camera kernel, K1 and the AOV kernel
    launch, and the records and the image equal the CPU run's bit for
    bit."""
    from nanort_tpu_torch.examples import objrender
    from nanort_tpu_torch.io.obj import save_obj

    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    save_obj(str(tmp_path / "s.obj"), v, f)
    argv = [str(tmp_path / "s.obj"), str(tmp_path / "o.png"), "64"]
    before = trace.counts()
    got = objrender.main(argv)
    assert _launched(before) == {"packet_traverse": 1, "aovs_fused": 1,
                                 "pinhole_fused": 1}
    want = objrender.main(argv[:1] + [str(tmp_path / "c.png"), "64",
                                      "--device", "cpu"])
    _same_records(got["hits"], want["hits"])
    assert torch.equal(got["rgb"].cpu(), want["rgb"])


def test_path_tracer_program_on_card(dev, tmp_path):
    """The Cornell box at 32^2 x 4 spp: one camera and one K3 launch; the
    image the CPU
    run's (K3's plain version) within 1e-5 (``trig="native"``: two
    libms' cos and sin) on 85% of pixels, finite and not black."""
    from nanort_tpu_torch.examples import path_tracer

    argv = [str(tmp_path / "p.png"), "32", "4"]
    before = trace.counts()
    got = path_tracer.main(argv)["img"]
    assert _launched(before) == {"pt_fused_brute": 1, "pinhole_fused": 1}
    want = path_tracer.main([str(tmp_path / "c.png"), "32", "4", "--device",
                             "cpu"])["img"]
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.01
    close = ((got.cpu() - want).abs().amax(-1) <= 1e-5).float().mean()
    assert float(close) >= 0.85
    assert abs(float(got.mean()) / float(want.mean()) - 1) < 0.02


def test_bidir_program_on_card(dev, tmp_path):
    """The Cornell box (32 triangles) at 16^2 x 2 spp: ``_trace`` sweeps
    it brute force (no traversal kernel), as the JAX package does, and
    the camera kernel makes the rays; the image is finite and not
    black."""
    from nanort_tpu_torch.examples import bidir_path_tracer

    before = trace.counts()
    got = bidir_path_tracer.main([str(tmp_path / "b.png"), "16", "2"])["img"]
    assert _launched(before) == {"pinhole_fused": 1}
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert float(got.mean()) > 0.01


def test_gltfrender_program_on_card(dev, tmp_path):
    """A 4-node ring ``.glb`` at 64^2: the graph walk (no kernel) on the
    camera kernel's rays gives the CPU run's hit mask and node ids."""
    from nanort_tpu_torch.examples import gltfrender
    from nanort_tpu_torch.testing import ring_glb

    v, f = make_uv_sphere(8, 16, 0.5)
    ring_glb(str(tmp_path / "r.glb"), v, f, [
        ((1.5 * np.cos(a), 0.0, 1.5 * np.sin(a)), (0.0, 1.0, 0.0), a)
        for a in np.arange(4) * np.pi / 2])
    before = trace.counts()
    got = gltfrender.main([str(tmp_path / "r.glb"), str(tmp_path / "g.png"),
                           "64"])["hits"]
    assert _launched(before) == {"pinhole_fused": 1}
    want = gltfrender.main([str(tmp_path / "r.glb"), str(tmp_path / "c.png"),
                            "64", "--device", "cpu"])["hits"]
    assert bool(want.hit.any())
    assert torch.equal(got.hit.cpu(), want.hit)
    assert torch.equal(got.node_id.cpu(), want.node_id)


@pytest.mark.parametrize("cam_type", ["perspective", "orthographic"])
def test_viewer_terminal_on_card(dev, tmp_path, monkeypatch, cam_type,
                                 capsys):
    """The terminal surface at 64^2 for 2 s launches K1 twice a pass
    (primary and any-hit occlusion with skip), the AOV kernel once and,
    for the perspective camera, the camera kernel once, and nothing else,
    and prints its status."""
    from nanort_tpu_torch.examples import viewer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(viewer, "SIZE", 64)
    before = trace.counts()
    r = viewer.run_terminal(2.0, cam_type, dev)
    moved = _launched(before)
    n = len(r.pass_times)
    assert n >= 1 and r._thread is None
    assert "pass " in capsys.readouterr().out
    cams = {"pinhole_fused": n} if cam_type == "perspective" else {}
    assert moved == {"packet_traverse": 2 * n, "aovs_fused": n, **cams}


def test_viewer_http_on_card(dev, tmp_path, monkeypatch):
    """The HTTP surface on port 0 on the card at 64^2: page, PNG, a gizmo
    nudge that re-commits, quit; its graph pass launches no kernel, its
    perspective camera one a pass."""
    import json
    import threading
    import urllib.request

    from nanort_tpu_torch.examples import viewer

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(viewer, "SIZE", 64)
    ports, res = [], {}
    ready = threading.Event()
    before = trace.counts()

    def serve():
        res["r"] = viewer.run_http(
            0, 120, dev, ready=lambda p: (ports.append(p), ready.set()))

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    assert ready.wait(60)

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[0]}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            return resp.read()

    assert b"progressive viewer" in call("/")
    assert call("/frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
    call("/node", {"name": "ball_b", "dx": 0.0, "dy": 0.25, "dz": 0.0})
    assert json.loads(call("/status"))["commits"] == 2
    call("/quit", {})
    th.join(60)
    assert not th.is_alive() and res["r"]._thread is None
    n = len(res["r"].pass_times)
    assert _launched(before) == ({"pinhole_fused": n} if n else {})


# ---- the program's spans on the card (utils.trace)

def _traced_on_card(fn):
    """``fn()`` under a profiler of CPU and CUDA activity: ``(the host
    ranges named nanort.*, the kernels, the program's span records)``,
    each range and kernel as ``(name, start ns, end ns)`` on the
    profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        item = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.name().startswith(trace.PREFIX):
                kernels.append(item)
        elif ev.name().startswith(trace.PREFIX):
            ranges.append(item)
    records = trace.records()
    trace.reset()
    return sorted(ranges, key=lambda r: r[1]), sorted(
        kernels, key=lambda k: k[1]), records


def _kernel_ms(kernels, pattern):
    return sum(e - s for n, s, e in kernels if pattern in n) / 1e6


def test_k1_kernels_start_inside_their_spans(dev, monkeypatch):
    """Every K1 kernel of a traced ``rtc.intersect`` starts after the start
    of the ``nanort.k1`` range that launched it, on the profiler's
    timeline, and each call's phases are ranges in their order."""
    monkeypatch.setattr(trace, "STREAM_SHARE", 1.0)  # time every call
    card = _rtc_scene(dev, True)
    rays = nt.Rays(*(x.to(dev) for x in _ring_rays(65536, 5)))
    card.intersect(rays)  # warm
    ranges, kernels, records = _traced_on_card(
        lambda: [card.intersect(rays) for _ in range(3)])
    k1 = [r for r in ranges if r[0] == "nanort.k1"]
    launched = [k for k in kernels if "traverse_kernel" in k[0]]
    assert len(k1) == len(launched) == 3
    for (_, rs, re_), (_, ks, _) in zip(k1, launched):
        assert rs <= ks
    assert [r.name for r in records] == 3 * [
        "ray_sort.sort", "k1", "ray_sort.unsort", "rtc.remap",
        "rtc.intersect"]
    # device time only where a reader takes it
    for r in records:
        assert (r.stream_ms is not None and r.stream_ms > 0) \
            == (r.name in trace.STREAMED), r


def _busy_then(fn):
    """``fn()`` queued behind 20 ms of device work, so that the span's
    host work runs while the device is busy and its first event waits
    for that work."""
    def run():
        torch.cuda._sleep(int(20e-3 * 2e9))
        fn()
    return run


def test_k1_stream_ms_is_its_kernel_time(dev, monkeypatch):
    """A ``k1`` span's stream ms (its CUDA events) is within 10% of its
    kernel's device time on a 4,194,304-ray incoherent batch."""
    monkeypatch.setattr(trace, "STREAMED", trace.STREAMED | {"k1"})
    monkeypatch.setattr(trace, "STREAM_SHARE", 1.0)
    sv, sf, _, _ = make_cornell_dense_pt_scene(100_000)
    scene = _scene(sv, sf, 16).to(dev)
    rays = nt.Rays(*(x.to(dev) for x in _rays(4_194_304, 23, broken=False)))
    packet.traverse_bvh8(scene, rays)  # warm
    _, kernels, records = _traced_on_card(
        _busy_then(lambda: packet.traverse_bvh8(scene, rays)))
    kernel = _kernel_ms(kernels, "traverse_kernel")
    (span,) = [r.stream_ms for r in records if r.name == "k1"]
    assert kernel > 0.5
    assert abs(span - kernel) <= 0.1 * kernel, (span, kernel)


def test_k4_stream_ms_is_its_kernel_time(dev, dense_pt, monkeypatch):
    """A ``k4`` span's stream ms is within 10% of K4's device time."""
    monkeypatch.setattr(trace, "STREAMED", trace.STREAMED | {"k4"})
    monkeypatch.setattr(trace, "STREAM_SHARE", 1.0)
    org, d = _cam(256, 256, 2.6)
    scene = dense_pt.to(dev)
    org, d = org.to(dev), d.to(dev)

    def render():
        pt_fused.render_fused_bvh(scene, org, d, 5, 16, max_bounces=5,
                                  spp_lanes=4)

    render()  # warm
    _, kernels, records = _traced_on_card(_busy_then(render))
    kernel = _kernel_ms(kernels, "pt_bvh_pool_kernel")
    (span,) = [r.stream_ms for r in records if r.name == "k4"]
    assert kernel > 0.5
    assert abs(span - kernel) <= 0.1 * kernel, (span, kernel)


# ---- K1's sphere leaf (the LAS viewer's spheres)

def _cloud(n, size, seed):
    """``n`` LiDAR-like points over a ``size`` m tile: rolling terrain,
    a fifth of them in crowns 3-20 m up, one radius by the LAS loader's
    rule (``io/las.py::to_spheres``). Returns (Spheres on the CPU, its
    binary tree, the points' mean height)."""
    from nanort_tpu_torch.ops import sphere

    rng = np.random.default_rng(seed)
    xz = rng.uniform(-size / 2, size / 2, (n, 2))
    y = 8.0 * np.sin(xz[:, 0] / 37.0) * np.cos(xz[:, 1] / 29.0)
    crown = rng.random(n) < 0.2
    y[crown] += rng.uniform(3.0, 20.0, int(crown.sum()))
    pts = np.stack([xz[:, 0], y, xz[:, 1]], 1).astype(np.float32)
    ext = pts.max(0).astype(np.float64) - pts.min(0)
    r = float(np.linalg.norm(ext)) / n ** (1 / 3) * 0.05
    s = sphere.Spheres(torch.from_numpy(pts), torch.full((n,), r))
    bvh, _ = sphere.build_sphere_bvh(s, nt.BVHBuildOptions(
        min_leaf_primitives=10, max_leaf_primitives=10))
    return s, bvh, float(pts[:, 1].mean())


@pytest.fixture(scope="module")
def small_cloud():
    return _cloud(3000, 20.0, 31)


SPHERE_MODES = {
    "closest": ("packet_traverse[sphere]", {}),
    "any_hit": ("packet_traverse[sphere]", dict(occlusion=True)),
    "range": ("packet_traverse[sphere]", dict(
        options=nt.BVHTraceOptions(prim_ids_range=(100, 2000)))),
    "counts": ("packet_traverse[counts]", dict(debug_counts=True)),
}


@pytest.mark.parametrize("mode", list(SPHERE_MODES) + ["skip"])
@pytest.mark.parametrize("width", [8, 16])
def test_sphere_kernel_matches_plain_small_cloud(dev, small_cloud, width,
                                                 mode):
    s, bvh, _ = small_cloud
    scene = collapse_bvh8(bvh, width=width, spheres=s)
    rng = np.random.default_rng(5)
    org = rng.uniform(-12, 12, (3001, 3)).astype(np.float32)
    d = rng.uniform(-8, 8, (3001, 3)) - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    org[0::10, 0] = np.nan  # degenerate rays among them
    d[2::10] = 0.0
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    key, kw = SPHERE_MODES.get(mode, ("packet_traverse[sphere]", {}))
    if mode == "skip":
        first = packet.traverse_bvh8(scene, rays).prim_id.clone()
        first[1::2] = nt.INVALID_PRIM_ID
        kw = dict(skip_prim_id=first)
    _mode_on_both(scene, rays, dev, key, **kw)


@pytest.fixture(scope="module")
def tile_4k():
    """A 1M-point tile's spheres on the card (a 316 m tile), their BVH16
    sphere tables there, the binary tree, and a 3840 x 2160 frame of
    camera rays over it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nanort_tpu_torch.ops import sphere

    s, bvh, mean_y = _cloud(1_000_000, 316.0, 32)
    s8 = collapse_bvh8(bvh, width=16, spheres=s).to("cuda")
    cam = look_at((0.0, mean_y + 80.0, 234.0), (0.0, mean_y, 0.0),
                  width=3840, height=2160, fov=45.0, device="cuda")
    spd = sphere.Spheres(s.centers.to("cuda"), s.radii.to("cuda"))
    return spd, s8, bvh, pinhole_rays(cam)


def test_sphere_kernel_matches_plain_on_a_4k_frame(dev, tile_4k):
    """The sphere kernel on a 3840 x 2160 frame of a 1M-point tile (the
    rays in raster order: one launch) equals the plain version bit for bit
    on t and prim id on every 64th ray, and the stack engine's records
    (t bit for bit, the sphere but at exactly equal t) on every 1024th."""
    from nanort_tpu_torch.ops import sphere

    spd, s8, bvh, rays = tile_4k
    before = trace.counts()
    hits = packet.traverse_image(s8, rays)
    moved = trace.since(before)
    assert moved["packet_traverse[sphere]"] == 1
    assert moved["k1.rays"] == 2160 * 3840  # the image's rays, no padding
    n = 3840 * 2160
    flat = nt.Rays(*(x.reshape(n, *x.shape[2:])[::64].contiguous()
                     for x in rays))
    want = packet._traverse_reference(
        s8.nodes, s8.leafs, 16, flat.org, flat.dir, flat.min_t, flat.max_t,
        None, None, False, False, False, packet.stack_slots(s8), sphere=True)
    got = [x.reshape(n)[::64] for x in hits]
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    hit = float(got[3].ne(nt.INVALID_PRIM_ID).float().mean())
    assert 0.3 < hit < 1.0
    sub = nt.Rays(*(x[::16].contiguous() for x in flat))
    stack = sphere.traverse_spheres(bvh, spd, sub, max_leaf=None,
                                    precise=True, post=False)
    c = compare_hits(nt.Hits(*(x[::16] for x in got)), stack, t_ulps=0)
    assert c["ok"], c


def test_render_sphere_aovs_on_card_matches_cpu(dev, small_cloud):
    from nanort_tpu_torch.models.pointcloud import render_sphere_aovs
    from nanort_tpu_torch.ops import sphere

    s, bvh, mean_y = small_cloud
    s8 = collapse_bvh8(bvh, width=16, spheres=s)
    cam = look_at((0.0, mean_y + 12.0, 26.0), (0.0, mean_y, 0.0), width=100,
                  height=70, fov=45.0, device="cpu")
    rays = pinhole_rays(cam)
    want, want_h = render_sphere_aovs(s, rays, scene8=s8)
    spd = sphere.Spheres(s.centers.to(dev), s.radii.to(dev))
    got, got_h = render_sphere_aovs(spd, nt.Rays(*(x.to(dev) for x in rays)),
                                    scene8=s8.to(dev))
    _same_records((got_h.t, got_h.prim_id), (want_h.t, want_h.prim_id))
    for k in want:
        a, b = got[k].cpu(), want[k]
        if a.dtype.is_floating_point:
            assert float((a - b).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(a, b), k


# ---- the sphere AOVs (csrc/sphere_aovs.cu)

def _same_sphere_aovs(got, want):
    """Every AOV of the two ``(aovs, hits)`` bit for bit, and the records
    (the UV with them)."""
    for k in AOV_KEYS:
        a, b = got[0][k], want[0][k]
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bs", [(96, 160), (100_003,)],
                         ids=["image", "flat"])
def test_sphere_aovs_kernel_equals_plain(dev, bs):
    """One launch a call, and every AOV the plain version's bit for bit
    on the same card tensors, texcoord included: spheres 740 m away,
    grazing rays, misses that keep their record's UV, normals at the
    poles (``testing.sphere_aov_case``)."""
    from nanort_tpu_torch.models import pointcloud

    case = sphere_aov_case(bs, 9, device=dev)
    before = trace.counts()
    got = pointcloud.sphere_aovs_from_hits(*case)
    assert trace.since(before) == {"sphere_aovs_fused": 1}
    _same_sphere_aovs(got, pointcloud._sphere_aovs_plain(*case))
    assert got[0]["rgb"].is_contiguous()
    assert got[0]["texcoord"].shape == bs + (2,)


def test_sphere_aovs_float64_on_card_raise(dev):
    """Card input the kernel cannot take raises and launches nothing: no
    plain version runs on the card."""
    from nanort_tpu_torch.models import pointcloud

    case = sphere_aov_case((64, 48), 3, device=dev, dtype="float64")
    before = trace.counts()
    with pytest.raises(TypeError, match="rays.org of dtype torch.float64"):
        pointcloud.sphere_aovs_from_hits(*case)
    s, rays, hits = sphere_aov_case((64, 48), 3, device=dev)
    with pytest.raises(TypeError, match="hits.prim_id of dtype"):
        pointcloud.sphere_aovs_from_hits(
            s, rays, hits._replace(prim_id=hits.prim_id.int()))
    assert trace.since(before) == {}


def test_sphere_aovs_id_past_the_centers_fails_on_card(dev):
    """A hit whose prim id names no sphere fails the launch at the next
    synchronise, where the plain version's gather fails too. The trap
    poisons the process's CUDA context: run it in a child."""
    import os
    import subprocess
    import sys

    code = """
import torch
from nanort_tpu_torch.models import pointcloud
from nanort_tpu_torch.testing import sphere_aov_case
s, rays, hits = sphere_aov_case((4096,), 9, device="cuda")
prim = hits.prim_id.clone()
prim[77] = s.centers.shape[0]
torch.cuda.synchronize()
try:
    pointcloud.sphere_aovs_from_hits(s, rays, hits._replace(prim_id=prim))
    torch.cuda.synchronize()
    print("NO ERROR")
except RuntimeError as e:
    print("RAISED", "CUDA" in str(e))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=300)
    assert "RAISED True" in r.stdout, (r.stdout, r.stderr[-2000:])


def _sphere_frame_on_card(spd, s8, rays):
    """``render_sphere_aovs`` over ``rays`` through K1: one K1 and one
    sphere AOV launch, and its AOVs and records the plain version's on
    the same K1 records."""
    from nanort_tpu_torch.models import pointcloud

    before = trace.counts()
    got = pointcloud.render_sphere_aovs(spd, rays, scene8=s8)
    assert _launched(before) == {"packet_traverse[sphere]": 1,
                                 "sphere_aovs_fused": 1}
    raw = packet.traverse_image(s8, rays)
    _same_sphere_aovs(got, pointcloud._sphere_aovs_plain(spd, rays, raw))
    return got[0]


def test_render_sphere_aovs_frame_on_card(dev, small_cloud):
    from nanort_tpu_torch.ops import sphere

    s, bvh, mean_y = small_cloud
    s8 = collapse_bvh8(bvh, width=8, spheres=s).to(dev)
    rays = pinhole_rays(look_at((0.0, mean_y + 12.0, 26.0),
                                (0.0, mean_y, 0.0), width=100, height=70,
                                fov=45.0, device=dev))
    spd = sphere.Spheres(s.centers.to(dev), s.radii.to(dev))
    aovs = _sphere_frame_on_card(spd, s8, rays)
    assert 0.1 < float(aovs["hit"].float().mean()) < 1.0


def test_render_sphere_aovs_on_a_4k_frame(dev, tile_4k):
    """The LiDAR-like 3840 x 2160 frame over 1M spheres: one sphere AOV
    launch, every AOV and the records' UV the plain version's bit for
    bit."""
    spd, s8, _, rays = tile_4k
    aovs = _sphere_frame_on_card(spd, s8, rays)
    assert 0.3 < float(aovs["hit"].float().mean()) < 1.0


# ---- a camera's batch through K1 (traverse_image)

def _tiled_route(scene, rays, **kw):
    """The records of a camera's batch copied into padded pixel tiles
    (``tile_image_rays``), traced by K1 over the copy and copied back."""
    h, w = rays.batch_shape
    flat, untile = packet.tile_image_rays(rays, min(128, h), min(64, w),
                                          pad=True)
    return untile(packet.traverse_bvh8(scene, flat, **kw))


@pytest.fixture(scope="module")
def image_scene():
    """100k triangles (the subdivided sphere), BVH16, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v, f = make_subdivided_sphere_scene(100_000)
    return _scene(v, f, 16).to("cuda")


@pytest.mark.parametrize("shape,occlusion", [
    ((8192, 8192), False), ((2160, 3840), False), ((70, 100), False),
    ((40, 24), False), ((70, 100), True)])
def test_image_route_equals_the_tiled_route(dev, image_scene, shape,
                                            occlusion):
    """K1 over a camera's (H, W) rays as they lie, in raster order, gives
    the tiled route's records bit for bit, at sides that are and are not
    multiples of the tile (8192^2; 2160 rows; 70 x 100; W < 32), closest
    and any-hit; ``traverse_image`` is that one launch over the image's
    rays."""
    h, w = shape
    rays = pinhole_rays(look_at((0.0, 0.3, 2.2), (0.0, 0.0, 0.0), width=w,
                                height=h, fov=60.0, device=dev))
    want = _tiled_route(image_scene, rays, occlusion=occlusion)
    if occlusion:
        got = packet.traverse_bvh8(image_scene, rays, occlusion=True)
    else:
        before = trace.counts()
        got = packet.traverse_image(image_scene, rays)
        assert trace.since(before) == {"packet_traverse": 1,
                                       "k1.rays": h * w}
    for a, b in zip(got, want):
        assert a.shape == (h, w) and torch.equal(a, b)
    assert bool(want.prim_id.ne(nt.INVALID_PRIM_ID).any())
    del got, want, rays
    torch.cuda.empty_cache()


def test_image_route_equals_the_tiled_route_on_spheres(dev):
    """The LiDAR viewer's frame: 3840 x 2160 over a 1M-point tile's BVH8
    (sphere leaves), ``traverse_image`` against the tiled route bit for
    bit."""
    s, bvh, mean_y = _cloud(1_000_000, 316.0, 32)
    s8 = collapse_bvh8(bvh, width=8, spheres=s).to(dev)
    rays = pinhole_rays(look_at((0.0, mean_y + 80.0, 234.0),
                                (0.0, mean_y, 0.0), width=3840, height=2160,
                                fov=45.0, device=dev))
    before = trace.counts()
    got = packet.traverse_image(s8, rays)
    assert trace.since(before) == {"packet_traverse[sphere]": 1,
                                   "k1.rays": 2160 * 3840}
    want = _tiled_route(s8, rays)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = float(want.prim_id.ne(nt.INVALID_PRIM_ID).float().mean())
    assert 0.3 < hit < 1.0


# ---- K1's curve leaf (hair as cubic Bezier curves)

def _hair(n_strands, leaf):
    """The benchmark's head of hair at ``n_strands`` strands of 32
    segments (``rtbench/generators/hair_head.py``): (Curves on the CPU,
    its binary tree of leaves of ``leaf`` curves)."""
    from nanort_tpu_torch.ops import curve
    from rtbench.harness import load_module

    v, _, _, m = load_module("generators", "hair_head").make(
        n_strands=n_strands)
    n = len(m["radii"])
    c = curve.Curves(torch.from_numpy(v.reshape(n, 4, 3)),
                     torch.from_numpy(m["radii"]))
    bvh, _ = curve.build_curve_bvh(c, nt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    return c, bvh


def _hair_frame(w, h, dev, a=0.7):
    """The hair cell's camera: 0.9 m from the head, 0.15 rad up."""
    eye = (0.9 * np.cos(0.15) * np.sin(a), 0.9 * np.sin(0.15),
           0.9 * np.cos(0.15) * np.cos(a))
    return pinhole_rays(look_at(eye, (0.0, 0.0, 0.0), width=w, height=h,
                                fov=30.0, device=dev))


@pytest.fixture(scope="module")
def small_hair():
    return _hair(2000, 4)


CURVE_MODES = {
    "closest": ("packet_traverse[curve]", {}),
    "any_hit": ("packet_traverse[curve]", dict(occlusion=True)),
    "range": ("packet_traverse[curve]", dict(
        options=nt.BVHTraceOptions(prim_ids_range=(1000, 40000)))),
    "counts": ("packet_traverse[counts]", dict(debug_counts=True)),
}


@pytest.mark.parametrize("mode", list(CURVE_MODES) + ["skip"])
@pytest.mark.parametrize("width", [8, 16])
def test_curve_kernel_matches_plain_small_hair(dev, small_hair, width, mode):
    c, bvh = small_hair
    scene = collapse_bvh8(bvh, width=width, curves=c)
    flat = _hair_frame(64, 48, "cpu")
    rays = nt.Rays(*(x.reshape(64 * 48, *x.shape[2:]).contiguous()
                     for x in flat))
    rays.org[0::10, 0] = float("nan")  # degenerate rays among them
    rays.dir[2::10] = 0.0
    key, kw = CURVE_MODES.get(mode, ("packet_traverse[curve]", {}))
    if mode == "skip":
        first = packet.traverse_bvh8(scene, rays).prim_id.clone()
        first[1::2] = nt.INVALID_PRIM_ID
        kw = dict(skip_prim_id=first)
    _mode_on_both(scene, rays, dev, key, **kw)


@pytest.mark.parametrize("width", [8, 16])
def test_curve_kernel_matches_plain_on_hair_frames(dev, width):
    """K1's curve leaf over 131,072 rays of a hair frame (512 x 256 at the
    hair cell's camera, 640,000 curves, leaves of 1 as the cell builds
    them): one launch, equal to the plain version on the card bit for bit,
    and to the stack engine (t, u, v bit for bit, the curve but at exactly
    equal t) on every 64th ray."""
    from nanort_tpu_torch.ops import curve

    c, bvh = _hair(20_000, 1)
    s8 = collapse_bvh8(bvh, width=width, curves=c).to(dev)
    rays = _hair_frame(512, 256, dev)
    before = trace.counts()
    hits = packet.traverse_image(s8, rays)
    assert trace.since(before) == {"packet_traverse[curve]": 1,
                                   "k1.rays": 512 * 256}
    n = 512 * 256
    flat = nt.Rays(*(x.reshape(n, *x.shape[2:]).contiguous() for x in rays))
    want = packet._traverse_reference(
        s8.nodes, s8.leafs, width, flat.org, flat.dir, flat.min_t,
        flat.max_t, None, None, False, False, False, packet.stack_slots(s8),
        curve=True)
    got = [x.reshape(n) for x in hits]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = float(got[3].ne(nt.INVALID_PRIM_ID).float().mean())
    assert 0.01 < hit < 1.0
    sub = nt.Rays(*(x[::64].contiguous() for x in flat))
    cd = curve.Curves(c.points.to(dev), c.radii.to(dev))
    stack = curve.traverse_curves(bvh, cd, sub, max_leaf=None)
    cmp = compare_hits(nt.Hits(*(x[::64] for x in got)), stack, t_ulps=0,
                       uv_atol=0.0)
    assert cmp["ok"], cmp


def test_render_curve_aovs_on_card_matches_cpu(dev, small_hair):
    """One K1 launch a frame and no stack-engine launch; the records bit
    for bit and the AOVs within 1e-6 of the CPU's."""
    from nanort_tpu_torch.models.hair import render_curve_aovs
    from nanort_tpu_torch.ops import curve

    c, bvh = small_hair
    s8 = collapse_bvh8(bvh, width=8, curves=c)
    rays = _hair_frame(100, 70, "cpu")
    want, want_h = render_curve_aovs(c, rays, scene8=s8)
    cd = curve.Curves(c.points.to(dev), c.radii.to(dev))
    card = nt.Rays(*(x.to(dev) for x in rays))
    s8d = s8.to(dev)
    before = trace.counts()
    got, got_h = render_curve_aovs(cd, card, scene8=s8d)
    assert trace.since(before) == {"packet_traverse[curve]": 1,
                                   "k1.rays": 7000}
    _same_records((got_h.t, got_h.u, got_h.v, got_h.prim_id),
                  (want_h.t, want_h.u, want_h.v, want_h.prim_id))
    assert bool(want_h.hit.any())
    for k in want:
        a, b = got[k].cpu(), want[k]
        if a.dtype.is_floating_point:
            assert float((a - b).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(a, b), k
