"""Progressive render loop — the reference GUI's concurrency contract
(port of ``nanort_tpu.models.progressive``).

The reference viewer runs a persistent render thread that accumulates
passes into shared buffers and honors three atomics: quit, refresh
(restart accumulation after a camera/scene edit) and cancel (abort the
in-flight pass) — gui/main.cc:106-180, nanosg/render.cc:254-281. A
pass's work is queued on the device, so cancellation is checked
*between* passes (a launched kernel cannot be interrupted; passes are
sized accordingly).

``ProgressiveRenderer`` reproduces that contract host-side:
  * ``request_render()``  = RequestRender(): restart accumulation
  * ``cancel()/quit()``   = gRenderCancel / gRenderQuit
  * ``snapshot()``        = mutex-guarded copy of the accumulated AOVs
  * per-pass RNG reseed like nanosg/render.cc:267-269

Deviation: the JAX package hands pass ``p`` the key
``fold_in(PRNGKey(seed), p)``; here it gets a ``torch.Generator`` on
``device`` seeded from ``(seed, p)`` (``pass_generator``). Copying a
pass's tensors to the host (``.detach().cpu().numpy()``) is the pass's
synchronisation point with the card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch


def pass_generator(seed: int, p: int, device="cuda") -> torch.Generator:
    """The generator of pass ``p``: seeded from ``(seed, p)`` through
    NumPy's ``SeedSequence``, so passes and seeds draw independent
    streams."""
    s = int(np.random.SeedSequence([seed, p]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class ProgressiveRenderer:
    """Drives ``render_pass_fn(pass_idx, generator) -> dict[str, tensor or
    ndarray]`` on a worker thread, averaging passes into accumulation
    buffers on the host."""

    def __init__(
        self,
        render_pass_fn: Callable,
        max_passes: int = 128,  # gui/main.cc:185
        seed: int = 0,
        device="cuda",
    ):
        self._fn = render_pass_fn
        self.max_passes = max_passes
        self._seed = seed
        self._device = device
        self._lock = threading.Lock()
        self._accum: dict | None = None
        self._pass = 0
        self._quit = threading.Event()
        self._cancel = threading.Event()
        self._refresh = threading.Event()
        self._thread: threading.Thread | None = None
        self.pass_times: list[float] = []

    # -- control surface (the three atomics) --
    def request_render(self):
        """Restart accumulation (gui RequestRender: pass=0, cancel=true,
        gui/main.cc:124-132)."""
        self._cancel.set()
        self._refresh.set()

    def cancel(self):
        self._cancel.set()

    def quit(self):
        self._quit.set()
        self._cancel.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- lifecycle --
    def start(self):
        assert self._thread is None
        self._refresh.set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        # reference RenderThread loop (gui/main.cc:140-176)
        while not self._quit.is_set():
            if self._refresh.is_set():
                with self._lock:
                    self._accum = None
                    self._pass = 0
                self._refresh.clear()
                self._cancel.clear()
            if self._pass >= self.max_passes:
                time.sleep(0.001)
                continue
            p = self._pass
            gen = pass_generator(self._seed, p, self._device)
            t0 = time.perf_counter()
            out = self._fn(p, gen)
            out = {k: _host(v) for k, v in out.items()}
            self.pass_times.append(time.perf_counter() - t0)
            if self._cancel.is_set():
                # discard the canceled pass (between-step cancellation)
                continue
            with self._lock:
                if self._accum is None:
                    self._accum = {k: v.astype(np.float64) for k, v in out.items()}
                else:
                    for k, v in out.items():
                        self._accum[k] += v
                self._pass = p + 1

    # -- consumption --
    @property
    def passes_done(self) -> int:
        with self._lock:
            return self._pass

    def snapshot(self) -> dict:
        """Average of accumulated passes (safe copy)."""
        with self._lock:
            if self._accum is None or self._pass == 0:
                return {}
            return {k: (v / self._pass).copy() for k, v in self._accum.items()}

    def wait_for(self, n_passes: int, timeout: float = 60.0) -> bool:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.passes_done >= n_passes:
                return True
            time.sleep(0.002)
        return False
