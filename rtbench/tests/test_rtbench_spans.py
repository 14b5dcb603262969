"""The readers of the program's spans and counters (``rtbench/spans.py``
and the span metrics): each resolves by name to its file, keeps to its
entry in ``BENCHMARK.json``, returns None on a run with no records or
with a program that has no spans, and reads its arithmetic off records,
ranges and counts made up here. A traced CPU rehearsal of the preview
reports the host-share and set-up metrics and leaves the stream, launch
and idle ones out (no CUDA events, no kernel, no device)."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest

from rtbench import harness, spans
from rtbench.trace import Trace

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
PREVIEW = ["cornell_dense_100k.ao_preview"]
API, PRIMARY = ["ring_10m.api_bounce"], ["ring_10m.primary_8k"]
DT, HC = "device_trace", "host_clock"
# metric: (cells it lists, or None for every cell; the e2e metric it
# moves; its source; its reader's file)
SPAN_METRICS = {
    "sort_ms.rays": (API, "mrays_per_s", DT, "sort_ms.rays"),
    "remap_ms.rays": (API, "mrays_per_s", DT, "remap_ms.rays"),
    "camera_ms.primary": (PRIMARY, "mrays_per_s", DT, "camera_ms.primary"),
    "aovs_ms.primary": (PRIMARY, "mrays_per_s", DT, "aovs_ms.primary"),
    "ao_host_pct.preview": (PREVIEW, "frame_ms_p95", DT,
                            "ao_host_pct.preview"),
    "k1_launch_pct.preview": (PREVIEW, "frame_ms_p95", DT,
                              "k1_launch_pct.preview"),
    "sah_s": (None, "setup_s", HC, "sah_s"),
    "collapse_s": (None, "setup_s", HC, "collapse_s"),
    "commit_graph_s": (API, "setup_s", HC, "commit_graph_s"),
    "k1_rays_a_launch.preview": (PREVIEW, "frame_ms_p95", "program_counter",
                                 "k1_rays_a_launch.preview"),
    "idle_in_spans_pct.rays": (API + PRIMARY, "mrays_per_s", DT,
                               "idle_in_spans_pct"),
    "idle_in_spans_pct.preview": (PREVIEW, "frame_ms_p95", DT,
                                  "idle_in_spans_pct"),
    "idle_in_spans_pct.pt": (["cornell_dense_100k.pt"], "msamples_per_s", DT,
                             "idle_in_spans_pct"),
}


def _run(trace=None, units=4):
    return SimpleNamespace(trace=trace, units=units, unit_s=[0.01] * units)


@pytest.fixture
def program():
    """The program's trace module, emptied before and after."""
    from nanort_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_resolves_by_name(name):
    cells, moves, source, file = SPAN_METRICS[name]
    path = harness.load_reader("metrics", name).__file__
    assert os.path.basename(path) == file + ".py"
    entry = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert entry.get("workloads") == cells and entry["moves"] == moves
    assert entry["source"] == source
    for cell in cells or [w["name"] for w in BENCH["workloads"]]:
        c = harness.Cell(BENCH, cell)
        assert name in [m["name"] for m in c.per_layer]
        assert moves in [m["name"] for m in c.end_to_end]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_is_none_without_records(name, program):
    read = harness.load_reader("metrics", name).read
    assert read(_run()) is None
    assert read(_run(Trace([], [("aten::add", 10, 20)], 0, 100))) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_is_none_for_a_program_without_spans(name, program,
                                                         monkeypatch):
    # what a checkout of the program from before its spans reads as
    import nanort_tpu_torch.utils

    monkeypatch.delattr(nanort_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "nanort_tpu_torch.utils.trace", None)
    assert spans.program_trace() is None
    tr = Trace([], [("aten::add", 10, 20)], 0, 100)
    assert harness.load_reader("metrics", name).read(_run(tr)) is None


def test_stream_readers_sum_their_spans_a_call(program, monkeypatch):
    rec = program.Record
    made = [rec("ray_sort.sort", "rtc.intersect", 0, 1, 1.5),
            rec("k1", "rtc.intersect", 1, 2, 5.0),
            rec("ray_sort.unsort", "rtc.intersect", 2, 3, 0.5),
            rec("rtc.remap", "rtc.intersect", 3, 4, 1.0),
            rec("camera", None, 0, 1, 0.25), rec("tile", "render_aovs",
                                                  1, 2, 0.75),
            rec("untile", "render_aovs", 2, 3, 1.0),
            rec("aovs", "render_aovs", 3, 4, 6.0),
            # nested in a span of its own name: counted in the outer one
            rec("aovs", "aovs", 3, 4, 6.0)]
    monkeypatch.setattr(program, "records", lambda: list(made))
    run = _run(Trace([], [], 0, 10), units=2)

    def read(n):
        return harness.load_reader("metrics", n).read(run)

    assert read("sort_ms.rays") == pytest.approx(1.0)
    assert read("remap_ms.rays") == pytest.approx(0.5)
    assert read("camera_ms.primary") == pytest.approx(1.0)
    assert read("aovs_ms.primary") == pytest.approx(3.0)
    # a second call whose spans were not timed: each name's timed mean
    # stands for both of its spans
    made += [r._replace(stream_ms=None) for r in made]
    run = _run(Trace([], [], 0, 10), units=4)
    assert read("sort_ms.rays") == pytest.approx(1.0)
    assert read("aovs_ms.primary") == pytest.approx(3.0)
    made[:] = [r._replace(stream_ms=None) for r in made]  # no CUDA events
    assert read("sort_ms.rays") is None


def test_host_share_readers(program, monkeypatch):
    rec = program.Record
    made = [rec("k1", "render_aovs", 200, 500, None),
            rec("render_aovs", "render_ao", 150, 600, None),
            rec("k1", "render_ao", 600, 700, None),
            rec("render_ao", None, 100, 1100, None),
            rec("k1", "render_ao", 1300, 1400, None),
            rec("render_ao", None, 1200, 2200, None),
            rec("k1", None, 2500, 2600, None)]  # outside every frame
    monkeypatch.setattr(program, "records", lambda: list(made))
    run = _run(Trace([], [], 0, 3000), units=2)
    run.unit_s = [1e-6, 2e-6]  # 3000 ns of calls
    ao = harness.load_reader("metrics", "ao_host_pct.preview").read(run)
    assert ao == pytest.approx(100 * (2000 - 500) / 3000)
    k1 = harness.load_reader("metrics", "k1_launch_pct.preview").read(run)
    assert k1 == pytest.approx(100 * 600 / 3000)


def test_k1_rays_a_launch_reads_the_counters(program, monkeypatch):
    monkeypatch.setattr(program, "counts", lambda: {
        "packet_traverse": 3, "packet_traverse_woop": 1,
        "bvh16_trace": 7, "k1.rays": 1000})
    read = harness.load_reader("metrics", "k1_rays_a_launch.preview").read
    assert read(_run(Trace([], [], 0, 10))) == 250.0
    monkeypatch.setattr(program, "counts", lambda: {
        "packet_traverse": 0, "k1.rays": 0})
    assert read(_run(Trace([], [], 0, 10))) is None


def test_idle_in_spans_reads_the_gaps():
    # device busy 0-100, 300-400, 900-1000; idle 100-300, 400-900
    kernels = [("k", 0, 100), ("k", 300, 400), ("k", 900, 1000)]
    host = [("nanort.rtc.intersect", 50, 250), ("nanort.k1", 60, 200),
            ("aten::add", 400, 900), ("nanort.camera", 700, 800),
            ("rtbench.call", 0, 1000)]
    run = _run(Trace(kernels, host, 0, 1000))
    read = harness.load_reader("metrics", "idle_in_spans_pct.rays").read
    # named idle: 100-250 and 700-800 of 700 ns
    assert read(run) == pytest.approx(100 * 250 / 700)


def test_setup_readers_read_the_totals(program, monkeypatch):
    monkeypatch.setattr(program, "totals", lambda: {
        "build.sah": 3.0, "build.collapse": 2.0, "commit.graph": 1.5})
    run = _run()
    for name, want in (("sah_s", 3.0), ("collapse_s", 2.0),
                       ("commit_graph_s", 1.5)):
        assert harness.load_reader("metrics", name).read(run) == want


def test_traced_cpu_rehearsal_reports_the_host_metrics(program):
    """The preview at a tiny size on the CPU, traced: the host-share and
    set-up metrics are reported; the stream ones (no CUDA events), the
    launch one (the plain version runs) and the idle one (no device) are
    not."""
    from rtbench.tests.test_rtbench_rehearsal import SEED, TINY

    cell = "cornell_dense_100k.ao_preview"
    res, _ = harness.run_cell(BENCH, cell, SEED, 0.5, True, "cpu", TINY[cell])
    m = res["metrics"]
    assert {"ao_host_pct.preview", "k1_launch_pct.preview", "sah_s",
            "collapse_s"} <= set(m)
    ao, k1 = m["ao_host_pct.preview"]["value"], \
        m["k1_launch_pct.preview"]["value"]
    assert 0 < k1 and 0 < ao and ao + k1 <= 100
    assert not {"sort_ms.rays", "aovs_ms.primary", "k1_rays_a_launch.preview",
                "idle_in_spans_pct.preview"} & set(m)
    assert m["sah_s"]["value"] > 0 and m["collapse_s"]["value"] > 0
