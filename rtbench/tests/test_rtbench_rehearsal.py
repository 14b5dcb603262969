"""Each cell rehearsed on the CPU at a tiny size: the run is correct and
loads no JAX; the same run with the timed path broken underneath, or
with the reference in bfloat16 in the program's place (the control), is
not correct. The look for a chip is skipped: ``run_cell`` is driven
directly with ``device="cpu"``, where the program runs its kernels'
plain versions."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from rtbench import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
SMALL = {"args": {"n_tris_target": 1000}}
RING = {"args": {"n_tris_target": 1000}, "placement": {"args": {"copies": 3}}}
TINY = {
    "cornell_dense_100k.pt": {
        "config": SMALL,
        "traffic": {"camera": {"eye": [0, 0, 2.6], "center": [0, 0, 0],
                               "fov": 45.0, "width": 128, "height": 32},
                    "spp": 4, "max_bounces": 3, "check_renders": 2, "keep": 8,
                    "check_pixels": 1024}},
    "ring_10m.api_bounce": {
        "config": RING,
        "traffic": {"rays": 4096, "pool": 2, "check_rays": 1024}},
    "cornell_dense_100k.ao_preview": {
        "config": SMALL,
        "traffic": {"camera": {"radius": 2.6, "center": [0.0, -0.1, 0.0],
                               "fov": 45.0, "width": 64, "height": 32,
                               "azimuth_swing": 0.35,
                               "elevation_swing": 0.2},
                    "poses": 4, "keep": 8, "check_frames": 2,
                    "check_pixels": 1024}},
    "ring_10m.primary_8k": {
        "config": RING,
        "traffic": {"camera": {"radius": 10.0, "elevation": 0.5,
                               "step": 0.26, "center": [0, 0, 0],
                               "fov": 45.0, "width": 64, "height": 64},
                    "check_pixels": 2048}},
}
SEED = 2**31 + 977


def run(cell, hook=None, control=False, seconds=0.5):
    return harness.run_cell(BENCH, cell, SEED, seconds, False, "cpu",
                            TINY[cell], entry_hook=hook, control=control)


def test_every_cell_has_a_rehearsal():
    assert set(TINY) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_rehearsal_is_correct_and_loads_no_jax(cell):
    """The run in a process of its own: correct, and no module whose
    top-level name is jax, jaxlib, flax or nanort_tpu once it ends."""
    code = (
        "import json, sys\n"
        "from rtbench import harness\n"
        f"from rtbench.tests.test_rtbench_rehearsal import run\n"
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
    res, checks = run(cell, control=True)
    low = res["control"]
    assert any(c["value"] > c["limit"] for c in low.values()), low


# ------------------------------------------------------------ faults
def _stale(fn):
    """A call that returns its first answer again: the state unchanged."""
    first = []

    def call(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return call


def _altered_image(img):
    img = img.clone()
    img.view(-1, img.shape[-1])[::7] += 0.01
    return img


def _fault_pt(kind):
    def wrap(fn):
        if kind == "stale":
            return _stale(fn)
        if kind == "half":
            return lambda sc, rays, seed, spp, max_bounces: fn(
                sc, rays, seed, spp=spp // 2, max_bounces=max_bounces)
        return lambda *a, **k: _altered_image(fn(*a, **k))
    return wrap


def _miss_half(hits):
    n = hits.t.numel()
    half = torch.arange(n).reshape(hits.t.shape) >= n // 2
    return hits._replace(
        prim_id=torch.where(half, 0xFFFFFFFF, hits.prim_id),
        t=torch.where(half, torch.full_like(hits.t, 3e38), hits.t))


def _alter_prims(hits):
    p = hits.prim_id.clone()
    p.view(-1)[::7] = torch.where(p.view(-1)[::7] == 0xFFFFFFFF, 0,
                                  p.view(-1)[::7] + 1)
    return hits._replace(prim_id=p)


def _fault_ao(kind):
    def wrap(fn):
        if kind == "stale":
            return _stale(fn)
        if kind == "half":
            def half(*a, n_samples, **k):
                return fn(*a, n_samples=n_samples // 2, **k)
            return half

        def altered(*a, **k):
            aovs, hits = fn(*a, **k)
            return dict(aovs, rgb=_altered_image(aovs["rgb"])), hits
        return altered
    return wrap


def _fault_primary(kind):
    def wrap(fn):
        if kind == "stale":
            return _stale(fn)

        def broken(*a, **k):
            aovs, hits = fn(*a, **k)
            return aovs, (_miss_half(hits) if kind == "half"
                          else _alter_prims(hits))
        return broken
    return wrap


class _Scene:
    def __init__(self, scene, wrap):
        self.intersect = wrap(scene.intersect)


def _fault_api(kind):
    def wrap(fn):
        if kind == "stale":
            return _stale(fn)
        return lambda rays: (_miss_half if kind == "half"
                             else _alter_prims)(fn(rays))
    return wrap


def _hook(cell, kind):
    def hook(entry):
        real = entry.setup

        def setup(run_):
            st = real(run_)
            if cell.endswith(".api_bounce"):
                st.scene = _Scene(st.scene, _fault_api(kind))
            elif cell.endswith(".pt"):
                st.render = _fault_pt(kind)(st.render)
            elif cell.endswith(".ao_preview"):
                st.render = _fault_ao(kind)(st.render)
            else:
                st.render = _fault_primary(kind)(st.render)
            return st
        entry.setup = setup
    return hook


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_timed_path_is_not_correct(cell, kind):
    res, checks = run(cell, hook=_hook(cell, kind), seconds=1.0)
    assert res["attempted"] >= 2
    assert not res["correct"], checks
