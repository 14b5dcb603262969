"""The cell added for K1's any-hit route, rehearsed on the CPU at a tiny
size as ``test_rtbench_rehearsal.py`` rehearses the others (whose fixed
table of cells does not name it): ``ring_10m.api_occluded`` on a ring of
three 1,000-triangle boxes and 4,096 shadow rays a call. The run is
correct and loads no JAX; the same run with the bfloat16 reference in the
program's place (the control), or with the timed path broken underneath,
is not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from rtbench import harness
from rtbench.tests.test_rtbench_rehearsal import _stale

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
TINY = {
    "ring_10m.api_occluded": {
        "config": {"args": {"n_tris_target": 1000},
                   "placement": {"args": {"copies": 3}}},
        "traffic": {"rays": 4096, "pool": 2, "check_rays": 1024}},
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
        "from rtbench.tests.test_rtbench_rehearsal_occluded import run\n"
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


class _Scene:
    def __init__(self, scene, wrap):
        self.occluded = wrap(scene.occluded)


def _fault_occluded(kind):
    """A call that returns its first answer again (stale), clears the
    answers of the batch's second half (half), or turns every 7th round
    (altered)."""
    def wrap(fn):
        if kind == "stale":
            return _stale(fn)

        def broken(rays):
            got = fn(rays).clone()
            if kind == "half":
                got[got.numel() // 2:] = False
            else:
                got[::7] = ~got[::7]
            return got
        return broken
    return wrap


def _hook(kind):
    def hook(entry):
        real = entry.setup

        def setup(run_):
            st = real(run_)
            st.scene = _Scene(st.scene, _fault_occluded(kind))
            return st
        entry.setup = setup
    return hook


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_timed_path_is_not_correct(cell, kind):
    res, checks = run(cell, hook=_hook(kind), seconds=1.0)
    assert res["attempted"] >= 2
    assert not res["correct"], checks
