"""The benchmark's files resolve by name, ``BENCHMARK.json`` keeps to its
shape, and the reference imports nothing of the program or of JAX."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from rtbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# the reference's files: plain torch and NumPy on the benchmark's inputs
REFERENCE_FILES = (
    ["rtbench/ref/__init__.py", "rtbench/ref/tracer.py",
     "rtbench/ref/pathtrace.py", "rtbench/ref/checks.py",
     "rtbench/scenes.py", "rtbench/camera.py", "rtbench/roofline.py"]
    + sorted(os.path.join("rtbench", d, f)
             for d in ("generators", "placements")
             for f in os.listdir(os.path.join(ROOT, "rtbench", d))
             if f.endswith(".py")))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.Cell(BENCH, cell)
    entry = harness.load_module("entries", c.traffic["entry"])
    for fn in ("setup", "unit", "finish", "check", "work"):
        assert callable(getattr(entry, fn))
    assert "limits" in c.traffic and c.traffic["limits"]
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end:
        assert callable(harness.load_reader("e2e", m["name"]).read)
    for m in c.per_layer:
        assert callable(harness.load_reader("metrics", m["name"]).read)
        assert m["moves"] in e2e


@pytest.mark.parametrize("recipe,n_tris,materials", [
    ({"generator": "cornell_pt"}, 32, True),
    ({"generator": "subdivided_sphere", "args": {"n_tris_target": 2000}},
     1848, False),
    ({"generator": "cornell_pt",
      "placement": {"name": "ring", "args": {"copies": 3, "radius": 3.5}}},
     96, True),
])
def test_scene_generators_resolve_by_name(recipe, n_tris, materials):
    """A configuration names its generator and placement; each is found
    as a file of its own, and a placed scene keeps its materials."""
    from rtbench import scenes

    sc = scenes.make_scene(recipe)
    assert sc.n_tris == n_tris
    assert (sc.world_material_ids() is not None) == materials
    if materials:
        assert len(sc.world_material_ids()) == n_tris
    v, f = sc.world()
    assert len(f) == n_tris and int(f.max()) < len(v)
    with pytest.raises(FileNotFoundError):
        scenes.make_scene({"generator": "no_such_generator"})


def test_metric_readers_resolve_by_name():
    """A metric without a file of its own is read by the file of its
    name's part before the first dot."""
    names = [m["name"] for m in BENCH["per_layer"]]
    for n in names:
        path = harness.load_reader("metrics", n).__file__
        stem = os.path.basename(path)[:-3]
        assert stem in (n, n.split(".", 1)[0])
    assert harness.load_reader("metrics", "glue_pct.rays").KERNELS == (
        "traverse_kernel",)
    assert "pt_bvh_pool_kernel" in harness.load_reader(
        "metrics", "glue_pct.pt").KERNELS


def test_names_units_and_bounds():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for c in BENCH["configs"]:
        assert c["file"].startswith("rtbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def _imports(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", REFERENCE_FILES)
def test_reference_imports_nothing_of_the_program(path):
    bad = {"jax", "jaxlib", "flax", "nanort_tpu", "nanort_tpu_torch"}
    for mod in _imports(path):
        assert mod.split(".", 1)[0] not in bad, (path, mod)


def test_forbidden_modules_compare_whole_names():
    import sys
    import types

    sys.modules.setdefault("nanort_tpu_torch_probe", types.ModuleType("x"))
    try:
        assert "nanort_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["nanort_tpu_torch_probe"]
