"""The benchmark's inputs come from the seed alone, its frozen scenes are
the program's, its roofline counts come from the inputs, and its
reference agrees with brute force on a tiny case."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from rtbench import harness, roofline, scenes
from rtbench.entries import ao_preview, api_intersect, primary_aovs
from rtbench.ref.pathtrace import tile_launch_positions
from rtbench.ref.tracer import RefMesh

CONFIGS = {c["name"]: json.load(open(os.path.join(harness.ROOT, c["file"])))
           for c in json.load(open(os.path.join(harness.ROOT,
                                                 "BENCHMARK.json")))["configs"]}
RING = {"generator": "cornell_dense", "args": {"n_tris_target": 100000},
        "placement": {"name": "ring", "args": {"copies": 10, "radius": 3.5}}}


def test_frozen_scenes_count():
    assert CONFIGS["cornell_dense_100k"]["n_tris"] == 99_236
    assert CONFIGS["ring_10m"]["n_tris"] == 9_940_200
    for cfg in CONFIGS.values():
        sc = scenes.make_scene(cfg["scene"])
        assert sc.n_tris == cfg["n_tris"], cfg["name"]
    ring = scenes.make_scene(RING)
    assert ring.n_tris == 992_360
    v, f = ring.world()
    assert v.shape == (10 * len(ring.vertices), 3) and len(f) == 992_360
    assert len(ring.world_material_ids()) == 992_360


def test_frozen_scene_is_the_programs():
    from nanort_tpu_torch.io import procedural
    from nanort_tpu_torch.scene import matrix

    got = scenes.make_cornell_dense_pt_scene(100_000)
    want = procedural.make_cornell_dense_pt_scene(100_000)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for k in got[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k])
    m = harness.load_module("placements", "ring").make(10, 3.5)[7]
    a = 2.0 * np.pi * 7 / 10
    ref = matrix.compose(matrix.translate(
        (3.5 * np.cos(a), 0.25 * (7 % 3) - 0.25, 3.5 * np.sin(a))),
        matrix.rotate((0.15 * 7 - 0.6, 1.0, 0.2), 0.6 * 7 + 0.3))
    np.testing.assert_array_equal(m, ref)
    for name, fn in (("make_cornell_pt_scene", ()),
                     ("make_subdivided_sphere_scene", (5000,))):
        got = getattr(scenes, name)(*fn)
        want = getattr(procedural, name)(*fn)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)


def test_scene_ignores_the_seed():
    a, b = scenes.make_scene(RING), scenes.make_scene(RING)
    np.testing.assert_array_equal(a.world()[0], b.world()[0])


def _bounce(seed):
    sc = scenes.make_scene({"generator": "cornell_dense",
                            "args": {"n_tris_target": 500},
                            "placement": {"name": "ring",
                                          "args": {"copies": 2,
                                                   "radius": 3.5}}})
    v, f = sc.world(np.float64)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return api_intersect.bounce_rays(v, f, 256, 1e-4, gen, "cpu")


def test_generators_follow_the_seed():
    big = 2**31 + 12345
    for x, y in zip(_bounce(big), _bounce(big)):
        assert torch.equal(x, y)
    assert not torch.equal(_bounce(big)[1], _bounce(big + 1)[1])
    cam = {"radius": 2.6, "center": [0, 0, 0], "azimuth_swing": 0.35,
           "elevation_swing": 0.2}
    e1 = ao_preview.orbit(cam, 8, big)
    np.testing.assert_array_equal(e1, ao_preview.orbit(cam, 8, big))
    e2 = ao_preview.orbit(cam, 8, big + 1)
    assert not np.array_equal(e1, e2)
    # every seed visits the same positions, from another start
    key = lambda es: sorted(map(tuple, np.round(es, 12)))  # noqa: E731
    assert key(e1) == key(e2)
    assert harness.unit_seed(big, 3) == harness.unit_seed(big, 3)
    assert harness.unit_seed(big, 3) != harness.unit_seed(big + 1, 3)
    assert 0 <= harness.unit_seed(-5, 0) < 2**31
    cam8 = {"radius": 10.0, "elevation": 0.5, "step": 0.26,
            "center": [0, 0, 0]}
    assert np.array_equal(primary_aovs.eye_of(cam8, 1.0, 4),
                          primary_aovs.eye_of(cam8, 1.0, 4))


def test_roofline_counts_come_from_the_inputs():
    assert roofline.k1_work(1000, 30, 10) == (1000 * 48 + 30 * 12 + 120,
                                              1000 * 22)
    b, o = roofline.k4_work(4, 100, 3, 10, 5, 6)
    assert b == 4 * 36 + 10 * 12 + 5 * 12 + 6 * 56
    assert o == 4 * 100 * 22 + 3 * 100 * 200
    t, by = roofline.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    assert roofline.least_seconds(0, 67e12) == (1.0, "operations")


def _brute(v, f, org, d, tmin, tmax):
    """All-pairs Moller-Trumbore in float64, the lowest id at equal t."""
    out = []
    for o, dd, lo, hi in zip(org, d, tmin, tmax):
        best = (np.inf, -1)
        for k, (a, b, c) in enumerate(v[f]):
            e1, e2 = b - a, c - a
            pv = np.cross(dd, e2)
            det = e1 @ pv
            if det == 0:
                continue
            tv = o - a
            u = (tv @ pv) / det
            q = np.cross(tv, e1)
            w = (dd @ q) / det
            t = (e2 @ q) / det
            if u >= 0 and w >= 0 and u + w <= 1 and lo <= t < hi:
                best = min(best, (t, k))
        out.append(best)
    return out


def test_reference_agrees_with_brute_force():
    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, (300, 3))
    f = rng.integers(0, 300, (100, 3))
    mesh = RefMesh(v, f, "cpu", torch.float64, leaf=8)
    org = rng.uniform(-2, 2, (64, 3))
    d = rng.normal(size=(64, 3))
    tmin = np.zeros(64)
    tmax = np.full(64, 1e30)
    tmax[::5] = 0.5
    want = _brute(v, f, org, d, tmin, tmax)
    T = lambda x: torch.as_tensor(x)  # noqa: E731
    t, u, w, prim = mesh.closest(T(org), T(d), T(tmin), T(tmax))
    for (bt, bk), tt, pp, hi in zip(want, t, prim, tmax):
        assert int(pp) == bk
        assert float(tt) == pytest.approx(bt if bk >= 0 else hi, rel=1e-12)
    hit = mesh.any_hit(T(org), T(d), T(tmin), T(tmax))
    assert hit.tolist() == [k >= 0 for _, k in want]
    got = mesh.hit_t(T(org), T(d), prim, torch.full((64,), 1e-9))
    ok = prim >= 0
    assert torch.allclose(got[ok], t[ok])
    skip = torch.where(prim >= 0, prim, -1)
    t2, _, _, p2 = mesh.closest(T(org), T(d), T(tmin), T(tmax), skip=skip)
    assert not bool(((p2 == prim) & (prim >= 0)).any())


def test_tile_launch_positions():
    pos = tile_launch_positions(64, 256, "cpu")
    perm = torch.arange(64 * 256).reshape(2, 32, 2, 128).transpose(
        1, 2).reshape(-1)
    assert torch.equal(pos[perm], torch.arange(64 * 256))
