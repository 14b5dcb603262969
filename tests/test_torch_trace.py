"""The port's spans and counters (``nanort_tpu_torch.utils.trace``) on
the CPU: with no profiler a span is a shared null context that opens no
profiler range and records nothing; under ``torch.profiler`` spans
appear as ``nanort.*`` ranges with their parents; the counters' deltas
are exact; set-up spans add to totals, profiler or not; and each entry
point emits exactly its named phases on small CPU scenes (the plain
versions of the kernels run there)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nanort_tpu_torch as nt
from nanort_tpu_torch.api import rtc
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (make_cornell_box,
                                            make_cornell_dense_pt_scene,
                                            make_cornell_pt_scene,
                                            make_uv_sphere, merge_meshes)
from nanort_tpu_torch.models import cameras, objrender, path_tracer
from nanort_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    """``fn()`` under a CPU profiler: ``(its result, the spans it closed
    as (name, parent), the profiler's nanort.* ranges as (name, start,
    end))``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(trace.PREFIX)]
    return out, [(r.name, r.parent) for r in trace.records()], ranges


@pytest.fixture(scope="module")
def small():
    """234 triangles (a box and a sphere), leaf 8, their BVH16 tables, and
    a 64 x 64 camera."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)
    bvh, _ = nt.build_triangle_bvh(nt.TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16).to("cpu")
    mesh = nt.TriangleMesh(torch.from_numpy(v), torch.from_numpy(f))
    cam = cameras.look_at((0.3, 0.2, 4.0), (0, 0, 0), width=64, height=64,
                          device="cpu")
    return dict(v=v, f=f, bvh=bvh, s16=s16, mesh=mesh,
                rays=cameras.pinhole_rays(cam))


@pytest.fixture(scope="module")
def api_scene(small):
    """Two copies of ``small`` through the Embree-style API, committed
    with the fast tables on the CPU."""
    dev = rtc.new_device(device="cpu")
    sc = dev.new_scene()
    for k in range(2):
        g = sc.new_triangle_mesh(len(small["f"]), len(small["v"]))
        sc.map_buffer(g, rtc.BufferType.VERTEX)[:] = small["v"]
        sc.map_buffer(g, rtc.BufferType.INDEX)[:] = small["f"]
        x = np.eye(4)
        x[0, 3] = 3.0 * k
        sc.set_transform(g, x)
    sc.commit(fast=True)
    rng = np.random.default_rng(3)
    org = np.tile([1.5, 0.0, 6.0], (256, 1)).astype(np.float32)
    d = (rng.uniform(-0.4, 0.4, (256, 3)) + [0, 0, -1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = nt.Rays(torch.from_numpy(org), torch.from_numpy(d),
                   torch.zeros(256), torch.full((256,), 1e30))
    return sc, rays


# ---- the span itself

def test_span_without_profiler_is_a_shared_null(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("no profiler range without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    s = trace.span("k1")
    assert s is trace.span("k1")
    with s as inner:
        assert inner is s

    @trace.span("camera")
    def f(x):
        """doc"""
        return x + 1

    assert f(1) == 2 and f.__name__ == "f" and f.__doc__ == "doc"
    assert trace.records() == [] and trace.totals() == {}


def test_no_program_path_opens_a_range_without_profiler(monkeypatch, small,
                                                         api_scene):
    def boom(*a, **k):
        raise AssertionError("no profiler range without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    objrender.render_ao(small["bvh"], small["mesh"], small["rays"], seed=1,
                        n_samples=2, max_leaf=8, scene8=small["s16"])
    sc, rays = api_scene
    sc.intersect(rays)
    sc.occluded(rays)
    assert trace.records() == []


def test_nested_spans_are_profiler_ranges_with_parents():
    def work():
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
            with trace.span("inner2"):
                pass

    _, spans, ranges = _profiled(work)
    assert spans == [("inner", "outer"), ("inner2", "outer"),
                     ("outer", None)]
    assert sorted(n for n, _, _ in ranges) == [
        "nanort.inner", "nanort.inner2", "nanort.outer"]
    by = {n: (s, e) for n, s, e in ranges}
    for child in ("nanort.inner", "nanort.inner2"):
        assert by["nanort.outer"][0] <= by[child][0]
        assert by[child][1] <= by["nanort.outer"][1]
    recs = trace.records()
    assert all(r.stream_ms is None and r.host_ms >= 0 for r in recs)
    assert recs[-1].start_ns <= recs[0].start_ns <= recs[0].end_ns \
        <= recs[-1].end_ns


def test_records_drop_with_reset_and_outlive_the_profiler():
    _profiled(lambda: trace.span("a").__enter__().__exit__(None, None,
                                                           None))
    assert [r.name for r in trace.records()] == ["a"]
    assert [r.name for r in trace.records()] == ["a"]  # read twice
    with trace.span("b"):
        pass  # no profiler: nothing kept
    assert [r.name for r in trace.records()] == ["a"]
    trace.reset()
    assert trace.records() == []


def test_span_closes_on_an_exception():
    def work():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("x")
        with trace.span("after"):
            pass

    _, spans, _ = _profiled(work)
    assert spans == [("inner", "outer"), ("outer", None), ("after", None)]


class _FakeEvent:
    """A CUDA timing event's surface, on a clock the test moves: an event
    completes once ``_FakeEvent.done`` passes the tick it was recorded
    at."""

    made = 0
    tick = 0
    done = -1

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self):
        type(self).tick += 1
        self.at = type(self).tick

    def query(self):
        return self.at <= type(self).done

    def synchronize(self):
        type(self).done = max(type(self).done, self.at)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return float(end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Fake CUDA events, an empty pool of them, and every outermost span
    timed."""
    ev = type("Ev", (_FakeEvent,), {})
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", ev)
    monkeypatch.setattr(trace, "_free", [])
    monkeypatch.setattr(trace, "STREAM_SHARE", 1.0)
    return ev


def _call():
    """One API call's phases: two streamed spans and one without device
    time inside an outer one."""
    with trace.span("rtc.intersect"):
        with trace.span("ray_sort.sort"):
            pass
        with trace.span("k1"):
            pass
        with trace.span("rtc.remap"):
            pass


def test_only_streamed_spans_record_events(fake_cuda):
    assert {"ray_sort.sort", "rtc.remap"} <= trace.STREAMED
    assert not {"k1", "rtc.intersect"} & trace.STREAMED
    _profiled(_call)
    assert fake_cuda.made == 4
    got = {r.name: r.stream_ms for r in trace.records()}
    assert got == {"ray_sort.sort": 1.0, "k1": None, "rtc.remap": 1.0,
                   "rtc.intersect": None}


def test_events_go_back_to_the_pool(fake_cuda):
    """``records()`` gives the events it resolved back to the pool, and
    the next spans record them again rather than make new ones."""
    def calls():
        for _ in range(50):
            _call()

    _profiled(calls)
    assert fake_cuda.made == 200
    recs = trace.records()
    assert len(recs) == 200
    assert [r.stream_ms for r in recs if r.name == "rtc.remap"] == [1.0] * 50
    trace.reset()
    _profiled(calls)
    assert fake_cuda.made == 200
    assert sum(r.stream_ms is not None for r in trace.records()) == 100


def test_a_share_of_the_calls_is_timed_whole(fake_cuda, monkeypatch):
    """With ``STREAM_SHARE`` below 1, outermost spans are timed at random,
    and a timed call times every streamed phase inside it."""
    monkeypatch.setattr(trace, "STREAM_SHARE", 1 / 8)

    def calls():
        for _ in range(800):
            _call()

    _profiled(calls)
    recs = trace.records()
    sort = [r.stream_ms is not None for r in recs if r.name == "ray_sort.sort"]
    remap = [r.stream_ms is not None for r in recs if r.name == "rtc.remap"]
    assert sort == remap
    assert 50 <= sum(sort) <= 150
    assert fake_cuda.made == 4 * sum(sort)


def test_records_wait_for_events_not_yet_complete(fake_cuda):
    with profile(activities=[ProfilerActivity.CPU]):
        _call()  # nothing completes
    assert fake_cuda.done == -1
    assert [r.name for r in trace.records()] == [
        "ray_sort.sort", "k1", "rtc.remap", "rtc.intersect"]
    assert fake_cuda.done == fake_cuda.tick


# ---- counters

def test_count_deltas_are_exact():
    before = trace.counts()
    trace.count("test.a")
    trace.count("test.a", 4)
    trace.count("test.b", 0)
    assert trace.since(before) == {"test.a": 5}
    assert trace.counts()["test.b"] == before.get("test.b", 0)
    snap = trace.counts()
    snap["test.a"] = -1  # a snapshot, not the registry
    assert trace.counts()["test.a"] == before.get("test.a", 0) + 5


def test_registry_holds_the_launch_keys():
    from nanort_tpu_torch.models import (ao_fused, pointcloud,  # noqa: F401
                                         pt_fused)
    from nanort_tpu_torch.traverse import fused_trace, packet

    launch = set(packet.LAUNCH_KEYS) | set(fused_trace.LAUNCH_KEYS) \
        | set(pt_fused.LAUNCH_KEYS) | {"ao_fused", "aovs_fused",
                                       "pinhole_fused", "sphere_aovs_fused"}
    assert set(trace.launches()) == launch
    assert launch | {"k1.rays"} <= set(trace.counts())
    for mod in (packet, fused_trace, pt_fused, ao_fused):
        assert not hasattr(mod, "LAUNCHES")


def test_launches_leave_out_the_work_counters():
    from nanort_tpu_torch.traverse import packet  # noqa: F401

    before = trace.counts()
    trace.count("packet_traverse", 2)
    trace.count("k1.rays", 100)
    got = trace.launches(before)
    assert got["packet_traverse"] == 2 and "k1.rays" not in got
    assert all(v == 0 for k, v in got.items() if k != "packet_traverse")
    trace.count("packet_traverse", -2)
    trace.count("k1.rays", -100)


def test_plain_versions_count_nothing(small, api_scene):
    before = trace.counts()
    objrender.render_ao(small["bvh"], small["mesh"], small["rays"], seed=1,
                        n_samples=2, max_leaf=8, scene8=small["s16"])
    api_scene[0].intersect(api_scene[1])
    assert trace.since(before) == {}


# ---- set-up totals

def test_setup_spans_add_host_seconds_without_profiler(small):
    collapse_bvh8(small["bvh"], small["v"], small["f"], width=16).to("cpu")
    tot = trace.totals()
    assert set(tot) == {"build.collapse", "build.upload"}
    assert all(s > 0 for s in tot.values())


def test_nested_setup_span_of_one_name_counts_once(monkeypatch):
    clock = iter([1.0, 10.0, 20.0, 40.0, 100.0, 300.0])
    monkeypatch.setattr(trace, "perf_counter", lambda: next(clock))
    with trace.span("build.x"):          # 1.0
        with trace.span("build.x"):      # nested: no clock read
            with trace.span("build.y"):  # 10.0 .. 20.0
                pass
    # build.x closes at 40.0
    assert trace.totals() == {"build.x": 39.0, "build.y": 10.0}


def test_setup_spans_add_totals_under_profiler(small):
    _, spans, _ = _profiled(lambda: collapse_bvh8(
        small["bvh"], small["v"], small["f"], width=16))
    assert spans == [("build.collapse", None)]
    assert set(trace.totals()) == {"build.collapse"}


# ---- the entry points' phases

def test_rtc_commit_spans(small):
    def commit():
        dev = rtc.new_device(device="cpu")
        sc = dev.new_scene()
        for _ in range(2):
            g = sc.new_triangle_mesh(len(small["f"]), len(small["v"]))
            sc.map_buffer(g, rtc.BufferType.VERTEX)[:] = small["v"]
            sc.map_buffer(g, rtc.BufferType.INDEX)[:] = small["f"]
        sc.commit(fast=True)

    _, spans, _ = _profiled(commit)
    # one graph build a mesh, then the fast path's build of the union
    assert spans == [
        ("build.sah", "commit.graph"), ("build.sah", "commit.graph"),
        ("commit.graph", "rtc.commit"), ("commit.flatten", "rtc.commit"),
        ("build.sah", "rtc.commit"), ("build.collapse", "rtc.commit"),
        ("build.upload", "rtc.commit"), ("build.upload", "rtc.commit"),
        ("rtc.commit", None)]
    assert {"rtc.commit", "commit.graph", "commit.flatten", "build.sah",
            "build.collapse", "build.upload"} == set(trace.totals())


def test_rtc_intersect_and_occluded_spans(api_scene):
    sc, rays = api_scene
    _, spans, _ = _profiled(lambda: sc.intersect(rays))
    assert spans == [("ray_sort.sort", "rtc.intersect"),
                     ("k1", "rtc.intersect"),
                     ("ray_sort.unsort", "rtc.intersect"),
                     ("rtc.remap", "rtc.intersect"), ("rtc.intersect", None)]
    trace.reset()
    _, spans, _ = _profiled(lambda: sc.occluded(rays))
    assert spans == [("ray_sort.sort", "rtc.occluded"),
                     ("k1", "rtc.occluded"),
                     ("ray_sort.unsort", "rtc.occluded"),
                     ("rtc.occluded", None)]


def test_camera_spans():
    def cam():
        c = cameras.look_at((0, 0, 4), (0, 0, 0), width=8, height=8,
                            device="cpu")
        return cameras.pinhole_rays(c)

    _, spans, _ = _profiled(cam)
    assert spans == [("camera", None), ("camera", None)]


def _k1_calls(monkeypatch) -> list:
    """Record the rays' batch shape of each ``traverse_bvh8`` call: the
    plain versions count nothing, so on the CPU the call tells which
    batch K1 took."""
    from nanort_tpu_torch.traverse import packet

    calls, inner = [], packet.traverse_bvh8

    def spy(scene, rays, *a, **kw):
        calls.append(tuple(rays.batch_shape))
        return inner(scene, rays, *a, **kw)

    monkeypatch.setattr(packet, "traverse_bvh8", spy)
    return calls


def test_render_aovs_spans(small, monkeypatch):
    calls = _k1_calls(monkeypatch)
    _, spans, _ = _profiled(lambda: objrender.render_aovs(
        small["bvh"], small["mesh"], small["rays"], scene8=small["s16"]))
    # K1 takes the camera's (H, W) rays as they lie, in one call: no
    # tile and untile copies
    assert spans == [("k1", "render_aovs"), ("aovs", "render_aovs"),
                     ("render_aovs", None)]
    assert calls == [(64, 64)]


@pytest.mark.parametrize("octant_major", [False, True])
def test_render_ao_spans(small, octant_major, monkeypatch):
    calls = _k1_calls(monkeypatch)
    _, spans, _ = _profiled(lambda: objrender.render_ao(
        small["bvh"], small["mesh"], small["rays"], seed=1, n_samples=2,
        max_leaf=8, scene8=small["s16"], octant_major=octant_major))
    primary = [("k1", "render_aovs"), ("aovs", "render_aovs"),
               ("render_aovs", "render_ao")]
    # the primary pass over the (H, W) rays as they lie, then the
    # occlusion pass
    assert len(calls) == 2 and calls[0] == (64, 64)
    # the sorted route permutes the rays, then the per-ray skip ids
    occ = ([("ray_sort.sort", "render_ao"), ("ray_sort.sort", "render_ao"),
            ("k1", "render_ao"), ("ray_sort.unsort", "render_ao")]
           if octant_major else [("k1", "render_ao")])
    assert spans == [("ao.draws", "render_ao"), *primary,
                     ("ao.rays", "render_ao"), *occ,
                     ("ao.reduce", "render_ao"), ("render_ao", None)]


def test_render_path_traced_spans_k4():
    """K4's route (BVH16 tables with aux rows; 32 x 128 pixel tiles)."""
    v, f, mids, mats = make_cornell_dense_pt_scene(600)
    scene = path_tracer.make_pt_scene(v, f, mids, mats, engine="pallas",
                                      device="cpu")
    cam = cameras.look_at((0, 0, 2.6), (0, 0, 0), width=128, height=32,
                          device="cpu")
    rays = cameras.pinhole_rays(cam)
    _, spans, _ = _profiled(lambda: path_tracer.render_path_traced(
        scene, rays, 3, spp=1, max_bounces=1))
    assert spans == [("pt.tiles", "render_path_traced"),
                     ("k4", "render_path_traced"),
                     ("pt.untile", "render_path_traced"),
                     ("render_path_traced", None)]


def test_render_path_traced_spans_k3():
    """K3's route (the 32-triangle box): no tiles."""
    scene = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                      device="cpu")
    cam = cameras.look_at((0, 0, 2.6), (0, 0, 0), width=16, height=8,
                          device="cpu")
    rays = cameras.pinhole_rays(cam)
    _, spans, _ = _profiled(lambda: path_tracer.render_path_traced(
        scene, rays, 3, spp=1, max_bounces=2))
    assert spans == [("k3", "render_path_traced"),
                     ("render_path_traced", None)]


def test_make_pt_scene_setup_totals():
    v, f, mids, mats = make_cornell_dense_pt_scene(600)
    path_tracer.make_pt_scene(v, f, mids, mats, engine="pallas",
                              device="cpu")
    assert set(trace.totals()) == {"build.sah", "build.aux",
                                   "build.collapse", "build.upload"}


def test_span_names_hold_no_kernel_name():
    """The benchmark's readers find kernels by substring."""
    import pathlib
    import re

    root = pathlib.Path(nt.__file__).parent
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r'span\("([^"]+)"\)', path.read_text()))
    assert {"k1", "k4", "rtc.intersect", "build.sah"} <= names
    for kernel in ("traverse_kernel", "pt_bvh_pool_kernel",
                   "pt_brute_kernel", "ao_kernel", "bvh16_kernel"):
        assert not any(kernel in n for n in names), kernel


def test_span_cost_tool_runs():
    """``tools/span_cost.py`` times a span off and on (here on the CPU,
    where a streamed span records no event)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parents[1] / "tools" / "span_cost.py"
    spec = importlib.util.spec_from_file_location("span_cost", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    res = tool.span_cost(2000)
    assert {"off_us", "on_us", "on_streamed_us", "on_timed_us",
            "on_range_us"} <= set(res)
    assert res["n"] == 2000
    assert trace.records() == []
