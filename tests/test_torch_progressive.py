"""PyTorch port, the progressive render loop (``models/progressive.py``):
the reference GUI's thread contract, against the JAX package's
``ProgressiveRenderer`` driven by the same pass function.

- The same pass function (its output a function of the pass index only)
  gives both packages' renderers the same passes, the same snapshots
  (bit for bit) and the same pass counts, through a restart.
- The cap, ``quit``, ``cancel`` (the in-flight pass is discarded and
  nothing more is averaged in until ``request_render``) and snapshots of
  torch tensors.
- Deviation: pass ``p`` gets a ``torch.Generator`` seeded from
  ``(seed, p)`` where the JAX package folds ``p`` into a threefry key;
  the generator is the same for the same ``(seed, p)``, another for
  another pass or seed, on the device asked for.
"""

import threading
import time

import numpy as np
import torch

from nanort_tpu.models.progressive import ProgressiveRenderer as JRenderer
from nanort_tpu_torch.models import progressive
from nanort_tpu_torch.models.progressive import ProgressiveRenderer

torch.set_num_threads(1)


def _pass(p, rng):
    del rng
    g = np.random.default_rng(p)
    return {"rgb": g.uniform(0, 1, (4, 5, 3)).astype(np.float32),
            "depth": np.full((4, 5), float(p), np.float32)}


def test_snapshots_match_jax():
    snaps = []
    for cls, kw in ((ProgressiveRenderer, {"device": "cpu"}), (JRenderer, {})):
        r = cls(_pass, max_passes=6, **kw).start()
        assert r.wait_for(6, timeout=30)
        first = r.snapshot()
        r.request_render()
        assert r.wait_for(6, timeout=30)
        time.sleep(0.02)
        assert r.passes_done == 6
        snaps.append((first, r.snapshot()))
        r.quit()
    (a0, a1), (b0, b1) = snaps
    for a, b in ((a0, b0), (a1, b1), (a0, a1)):
        assert set(a) == set(b) == {"rgb", "depth"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float64
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a0["depth"], 2.5)


def test_cancel_discards_the_pass_in_flight():
    """Pass 2 sees ``cancel()`` while it renders: it and every pass after
    it are discarded until ``request_render()`` restarts from pass 0."""
    calls = []
    gate = threading.Event()
    holder = {}

    def render(p, gen):
        calls.append(p)
        if p == 2 and not gate.is_set():
            holder["r"].cancel()
            gate.set()
        return {"x": torch.full((3,), float(10 ** p))}

    r = ProgressiveRenderer(render, max_passes=4, device="cpu")
    holder["r"] = r
    r.start()
    assert gate.wait(10)
    time.sleep(0.05)
    assert r.passes_done == 2
    np.testing.assert_array_equal(r.snapshot()["x"], [5.5] * 3)  # (1+10)/2
    r.request_render()
    assert r.wait_for(4, timeout=30)
    np.testing.assert_array_equal(r.snapshot()["x"], [1111 / 4] * 3)
    r.quit()
    assert r._thread is None and calls.count(2) >= 2


def test_max_passes_cap_and_quit():
    r = ProgressiveRenderer(lambda p, g: {"x": np.zeros(1, np.float32)},
                            max_passes=3, device="cpu").start()
    assert r.wait_for(3)
    time.sleep(0.05)
    assert r.passes_done == 3 and len(r.pass_times) == 3
    r.quit()
    assert r._thread is None
    assert ProgressiveRenderer(lambda p, g: {}, device="cpu").snapshot() == {}


def test_pass_generators():
    seen = []

    def render(p, gen):
        assert isinstance(gen, torch.Generator)
        assert gen.device.type == "cpu"
        seen.append(torch.rand(4, generator=gen))
        return {"x": np.zeros(1, np.float32)}

    r = ProgressiveRenderer(render, max_passes=3, seed=11, device="cpu")
    r.start()
    assert r.wait_for(3)
    r.quit()
    again = [torch.rand(4, generator=progressive.pass_generator(11, p, "cpu"))
             for p in range(3)]
    for a, b in zip(seen, again):
        assert torch.equal(a, b)
    assert not torch.equal(seen[0], seen[1])
    other = torch.rand(4, generator=progressive.pass_generator(12, 0, "cpu"))
    assert not torch.equal(other, seen[0])
    import inspect

    assert inspect.signature(ProgressiveRenderer).parameters[
        "device"].default == "cuda"
