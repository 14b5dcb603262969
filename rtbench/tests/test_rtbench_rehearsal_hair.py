"""The cell added with the hair configuration, rehearsed on the CPU at a
tiny size as ``test_rtbench_rehearsal.py`` rehearses the others (whose
fixed table of cells does not name it): ``hair_head_3m.orbit_4k`` on 2,000
strands of 4 segments, thickened to millimetres so that a 64 x 36 frame's
pixels hit them. The run is correct and loads no JAX; the same run with
the bfloat16 reference in the program's place (the control), with the
timed path broken underneath, or with an AOV wrong, is not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from rtbench import harness
from rtbench.tests.test_rtbench_rehearsal import _fault_primary

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
TINY = {
    "hair_head_3m.orbit_4k": {
        "config": {"args": {"n_strands": 2000, "segments": 4,
                            "radius_root": 2e-3, "radius_tip": 1e-3}},
        "traffic": {"camera": {"width": 64, "height": 36},
                    "check_pixels": 1024}},
}
SEED = 2**31 + 977


def run(cell, hook=None, control=False, seconds=0.5):
    return harness.run_cell(BENCH, cell, SEED, seconds, False, "cpu",
                            TINY[cell], entry_hook=hook, control=control)


def test_the_cells_are_in_the_benchmark():
    assert set(TINY) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_rehearsal_is_correct_and_loads_no_jax(cell):
    code = (
        "import json, sys\n"
        "from rtbench import harness\n"
        "from rtbench.tests.test_rtbench_rehearsal_hair import run\n"
        f"res, checks = run({cell!r})\n"
        "print(json.dumps({'correct': res['correct'], 'checks': checks,"
        " 'bad': harness.forbidden_modules(),"
        " 'torch': 'nanort_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["torch"] and res["bad"] == [], res
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    res, _ = run(cell, control=True)
    low = res["control"]
    assert any(c["value"] > c["limit"] for c in low.values()), low


AOV_FAULTS = ["depth_on_miss", "tangent_turned"]


def _fault_aovs(kind):
    """One AOV wrong, the records right: the depth t on a miss too (a
    miss's t is its max_t), or the tangent's components turned round."""
    def wrap(fn):
        def broken(*a, **k):
            aovs, hits = fn(*a, **k)
            aovs = dict(aovs)
            if kind == "depth_on_miss":
                aovs["depth"] = hits.t.clone()
            else:
                aovs["tangent"] = aovs["tangent"].roll(1, dims=-1)
            return aovs, hits
        return broken
    return wrap


def _hook(cell, kind):
    def hook(entry):
        real = entry.setup

        def setup(run_):
            st = real(run_)
            fault = _fault_aovs if kind in AOV_FAULTS else _fault_primary
            st.render = fault(kind)(st.render)
            return st
        entry.setup = setup
    return hook


@pytest.mark.parametrize("kind", ["stale", "half", "altered"] + AOV_FAULTS)
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_timed_path_is_not_correct(cell, kind):
    # a frame of the plain versions takes most of a second on the CPU
    res, checks = run(cell, hook=_hook(cell, kind), seconds=2.0)
    assert res["attempted"] >= 2
    assert not res["correct"], checks
