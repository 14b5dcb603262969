"""PyTorch port on the card: each CUDA kernel against its plain torch
version on the same tables and rays — K1 and K1-woop
(csrc/packet_traverse.cu vs traverse/packet.py::_traverse_reference,
watertight and Woop leaf tests), K2 (csrc/bvh16_trace.cu vs
traverse/fused_trace.py::trace_bvh16_reference, Moller-Trumbore and
watertight, with and without a per-ray skip), K3 and K4
(csrc/pt_fused.cu vs models/pt_fused.py::_render_fused_reference and
_render_fused_bvh_reference; K4's pooled kernel also at edge shapes,
against its lane kernel, with each schedule option, and with a stack too
small for the tree), K5 (csrc/ao_fused.cu vs
models/ao_fused.py::_ao_fused_reference). Config A's render_ao must
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
torch on both; cos/sin come from two float64 libms).

Every test here is marked ``gpu`` and skips without a CUDA device. This
file imports no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

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
from nanort_tpu_torch.testing import zero_edge_rays
from nanort_tpu_torch.traverse import fused_trace, packet

pytestmark = pytest.mark.gpu


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
    before = dict(fused_trace.LAUNCHES)
    got = fused_trace.trace_bvh16(dense_pt.scene8.to(dev),
                                  nt.Rays(*(x.to(dev) for x in rays)),
                                  dense_pt.fused_aux.to(dev), **kw)
    assert fused_trace.LAUNCHES == {**before,
                                    "bvh16_trace": before["bvh16_trace"] + 1}
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
    before = pt_fused.LAUNCHES["pt_fused_brute"]
    got = pt_fused.render_fused(scene.to(dev), org.to(dev), d.to(dev), 7, 4,
                                **kw)
    assert pt_fused.LAUNCHES["pt_fused_brute"] == before + 1
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


@pytest.mark.parametrize("spp_lanes,strata", [(1, 1), (4, 2)])
def test_pt_fused_bvh_matches_plain(dev, dense_pt, spp_lanes, strata):
    org, d = _cam(16, 12, 2.6)
    kw = dict(max_bounces=5, trig="poly", azimuth_strata=strata,
              spp_lanes=spp_lanes)
    before = (pt_fused.LAUNCHES["pt_fused_bvh"],
              fused_trace.LAUNCHES["bvh16_trace"])
    got = pt_fused.render_fused_bvh(dense_pt.to(dev), org.to(dev), d.to(dev),
                                    9, 8, **kw)
    assert (pt_fused.LAUNCHES["pt_fused_bvh"],
            fused_trace.LAUNCHES["bvh16_trace"]) == (before[0] + 1,
                                                     before[1] + 1)
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
    before = dict(pt_fused.LAUNCHES)
    for scene in (cornell_pt, dense_pt):
        img = path_tracer.render_path_traced(scene.to(dev), pinhole_rays(cam),
                                             3, spp=4, max_bounces=4)
        assert img.shape == (32, 128, 3) and img.is_cuda
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    # both routes launch their kernel once; K4 on its pooled schedule
    assert pt_fused.LAUNCHES == {
        **before, "pt_fused_brute": before["pt_fused_brute"] + 1,
        "pt_fused_bvh": before["pt_fused_bvh"] + 1}


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
    before = dict(pt_fused.LAUNCHES)
    got = pt_fused.render_fused_bvh(scene.to(dev), org.to(dev), d.to(dev), 4,
                                    spp, **kw)
    assert pt_fused.LAUNCHES == {**before,
                                 "pt_fused_bvh": before["pt_fused_bvh"] + 1}
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


@pytest.mark.parametrize("trig", ["poly", "native"])
def test_pt_fused_bvh_pool_matches_lane(dev, dense_pt, trig):
    org, d = _cam(64, 64, 2.6)
    scene = dense_pt.to(dev)
    kw = dict(max_bounces=6, trig=trig, azimuth_strata=2, spp_lanes=4)
    before = dict(pt_fused.LAUNCHES)
    pool = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 5, 8,
                                     **kw)
    lane = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 5, 8,
                                     _schedule="lane", **kw)
    assert pt_fused.LAUNCHES == {
        **before, "pt_fused_bvh": before["pt_fused_bvh"] + 1,
        "pt_fused_bvh[lane]": before["pt_fused_bvh[lane]"] + 1}
    assert torch.equal(pool, lane)
    assert bool(torch.isfinite(pool).all()) and float(pool.mean()) > 0


@pytest.mark.parametrize("schedule", ["pool", "lane"])
def test_pt_fused_bvh_small_stack_sets_error_word(dev, dense_pt, schedule,
                                                  monkeypatch):
    real = fused_trace._check_tables
    words = []
    monkeypatch.setattr(fused_trace, "_check_tables",
                        lambda *a: real(*a)[:3] + (2,))
    monkeypatch.setattr(fused_trace, "check_overflow",
                        lambda err, slots: words.append((err, slots)))
    org, d = _cam(16, 12, 2.6)
    pt_fused.render_fused_bvh(dense_pt.to(dev), org.to(dev), d.to(dev), 4, 2,
                              max_bounces=3, _schedule=schedule)
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


def test_pt_fused_bvh_schedule_keyword(dev, dense_pt):
    org, d = _cam(4, 4, 2.6)
    with pytest.raises(ValueError, match="_schedule"):
        pt_fused.render_fused_bvh(dense_pt.to(dev), org.to(dev), d.to(dev),
                                  4, 2, _schedule="warp")
    occ = pt_fused.pool_occupancy()
    assert occ["lane"] >= 1 and occ["pool"] >= 1
    assert 0 < occ["pool_smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("iters_a_slice", [1, 3])
def test_pt_fused_bvh_pool_slices_match_lane(dev, dense_pt, iters_a_slice,
                                            monkeypatch):
    # a render whose per-sample buffer passes the cap runs one launch a
    # slice of sample iterations and keeps the lane kernel's bits
    org, d = _cam(32, 24, 2.6)
    scene = dense_pt.to(dev)
    kw = dict(max_bounces=5, trig="poly", azimuth_strata=2, spp_lanes=2)
    rl, spp_iters = 32 * 24 * 2, 8 // 2
    want = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 6, 8,
                                     _schedule="lane", **kw)
    monkeypatch.setattr(pt_fused, "POOL_SLICE_BYTES",
                        iters_a_slice * rl * 12)
    slices = -(-spp_iters // iters_a_slice)
    before = dict(pt_fused.LAUNCHES)
    k2 = fused_trace.LAUNCHES["bvh16_trace"]
    got = pt_fused.render_fused_bvh(scene, org.to(dev), d.to(dev), 6, 8,
                                    **kw)
    assert pt_fused.LAUNCHES == {
        **before, "pt_fused_bvh": before["pt_fused_bvh"] + slices}
    assert fused_trace.LAUNCHES["bvh16_trace"] == k2 + slices
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
        before = dict(packet.LAUNCHES)
        fused = dict(pt_fused.LAUNCHES)
        img = path_tracer.render_path_traced(
            scene.to(dev), pinhole_rays(cam), 3, spp=4, max_bounces=5,
            fused=False, spp_batch=2)
        assert img.shape == (16, 32, 3) and img.is_cuda
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
        # 2 megabatches x 5 bounces x (closest + shadow)
        assert packet.LAUNCHES == {**before, key: before[key] + 20}
        assert pt_fused.LAUNCHES == fused


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
    before = dict(fused_trace.LAUNCHES)
    got = fused_trace.trace_bvh16(
        dense_pt.scene8.to(dev), nt.Rays(*(x.to(dev) for x in rays)),
        dense_pt.fused_aux.to(dev),
        **{k: (x.to(dev) if isinstance(x, torch.Tensor) else x)
           for k, x in kw.items()})
    key = "bvh16_trace_watertight"
    assert fused_trace.LAUNCHES == {**before, key: before[key] + 1}
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
    before = (ao_fused.LAUNCHES,
              fused_trace.LAUNCHES["bvh16_trace_watertight"])
    got, got_h = ao_fused.render_ao_fused(
        mesh, nt.Rays(*(x.to(dev) for x in rays)), None, s16.to(dev),
        aux.to(dev), n_samples=n_samples, draws=draws.to(dev))
    assert (ao_fused.LAUNCHES, fused_trace.LAUNCHES[
        "bvh16_trace_watertight"]) == (before[0] + 1, before[1] + 1)
    want, want_h = ao_fused.render_ao_fused(
        mesh, rays, None, s16.to("cpu"), aux, n_samples=n_samples,
        draws=draws)
    for k in want:
        assert got[k].is_cuda and torch.equal(got[k].cpu(), want[k]), k
    for a, b in zip(got_h, want_h):
        assert torch.equal(a.cpu(), b)


def test_render_ao_launches_k1_only(dev, config_a_small, monkeypatch):
    mesh, bvh, s16, _ = config_a_small

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(packet, "_traverse_reference", plain)
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=64, height=64,
                  fov=45.0, device=dev)
    before = dict(packet.LAUNCHES)
    aovs, _ = objrender.render_ao(bvh, mesh, pinhole_rays(cam), seed=7,
                                  max_leaf=8, scene8=s16.to(dev))
    assert aovs["ao"].is_cuda and aovs["ao"].shape == (64, 64)
    assert 0.0 < float(aovs["ao"].mean()) < 1.0
    # the primary pass and one occlusion megabatch
    assert packet.LAUNCHES == {**before, "packet_traverse":
                               before["packet_traverse"] + 2}


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
    before = dict(packet.LAUNCHES)
    got = packet.traverse_bvh8(
        scene.to(dev), nt.Rays(*(x.to(dev) for x in rays)), *args,
        **{k: (x.to(dev) if isinstance(x, torch.Tensor) else x)
           for k, x in kw.items()})
    assert packet.LAUNCHES == {**before, key: before[key] + 1}
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
    before = dict(packet.LAUNCHES)
    got = treelet.traverse_bvh8_binned(
        scene, nt.Rays(*(x.to(dev) for x in rays)), treelets=tl, K=4, sub=1)
    sweeps = packet.LAUNCHES["packet_traverse[roots]"] - before[
        "packet_traverse[roots]"]
    assert 2 <= sweeps <= 3
    assert packet.LAUNCHES == {**before, "packet_traverse[roots]":
                               before["packet_traverse[roots]"] + sweeps}
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
        before = packet.LAUNCHES["packet_traverse[flags]"]
        _same_records(packet.traverse_bvh8_exact(sd, rd, sub=sub), single)
        assert packet.LAUNCHES["packet_traverse[flags]"] == before + 1
    got, overflow = packet.traverse_bvh8_exact_fused(sd, rd)
    assert overflow.is_cuda and not bool(overflow)
    _same_records(got, single)
