"""Spans and counters of the port: where a call's host and device time
goes, by named phase, and how much work each kernel launch did.

``span(name)`` is a context manager and a decorator. With no torch
profiler recording on the calling thread it returns a shared null
context (one a name): no profiler range, no CUDA event, nothing kept.
While a profiler records, a span

* opens the profiler range ``"nanort." + name`` (Kineto stamps it on the
  clock of its CUDA activity, so spans and kernels share one timeline;
  nesting gives the parent). The range is an operator's range
  (``torch._C._profiler._RecordFunctionFast``), not a
  ``torch.profiler.record_function`` user annotation: Kineto copies a
  user annotation onto the device's timeline, where a trace reader on
  a torch without ``activity_type`` counts it as device work, and it
  costs about ten times as much;
* for the spans named in ``STREAMED``, on a CUDA process, records a CUDA
  event on the current stream at each edge, inside a sampled share
  (``STREAM_SHARE``) of the outermost spans (an event costs tens of us
  on the host under a profiler, and a call's host time is what the
  trace explains; a reader scales the timed spans' mean by the count),
  and
* keeps ``(name, parent, host start and end ns, the events)`` in memory;
  ``records()`` resolves them into ``Record``s whose ``stream_ms`` is the
  elapsed time between the events: the device time of the work the span
  enqueued, plus any time the device waited for the host inside it. Its
  events then go back to a pool that later spans record again.

Set-up spans (names starting ``build.`` or ``commit.``, and
``rtc.commit``) also always add their host seconds, on
``time.perf_counter``, to a total by name (``totals()``; a span nested
in one of the same name adds nothing), profiler or not: set-up runs a
few times a process, and no profiler window covers it.

``count(name, n)`` adds to one registry of counters; ``counts()`` is a
snapshot of it and ``since(snapshot)`` the counters that moved after it.
The kernel wrappers declare their launch counters
(``declare_launches``), one key a launch kind (``packet_traverse``,
``packet_traverse[sphere]``, ``packet_traverse[curve]``,
``bvh16_trace``, ``pt_fused_bvh``, ``ao_fused``, ...), count each launch
there, and K1's wrapper adds its rays to ``k1.rays``;
``launches(snapshot)`` gives the launch counters alone.

Span names hold no kernel's name: readers of a profiler trace find
kernels by substring.
"""

from __future__ import annotations

import functools
import random
import threading
from time import perf_counter, time_ns
from typing import NamedTuple

import torch

PREFIX = "nanort."
# names of set-up spans, which always add to totals()
SETUP = ("build.", "commit.", "rtc.commit")
# spans whose device time is kept (a CUDA event at each edge): the
# phases of the API's call and of a camera frame that a reader of
# stream ms takes (``sphere.post``: a sphere frame's UV and AOVs;
# ``curve.post``: a curve frame's AOVs); every other span costs its range
# alone
STREAMED = frozenset({"ray_sort.sort", "ray_sort.unsort", "rtc.remap",
                      "camera", "tile", "untile", "aovs", "sphere.post",
                      "curve.post"})
# the share of outermost spans, drawn at random, inside which the
# STREAMED spans record their events
STREAM_SHARE = 1 / 8

_profiling = torch._C._autograd._profiler_enabled  # per thread
# per thread: the open traced spans' names, whether the outermost one is
# timed, the open set-up spans' names
_local = threading.local()
_draw = random.Random(0).random  # the timed outermost spans' draws
_pending: list = []  # traced spans not yet resolved, in closing order
_records: list = []  # resolved Records
_free: list = []  # CUDA events ready to record again
_totals: dict = {}
_counts: dict = {}
_launch_keys: set = set()


class Record(NamedTuple):
    """One traced span: ``name`` (without the prefix), the name of the
    span it opened in (None at the outermost), its host start and end in
    ns on the profiler's clock (``time.time_ns``), and the ms between
    its two CUDA events (None for a span not in ``STREAMED``, outside
    a timed outermost span, or without CUDA)."""

    name: str
    parent: str | None
    start_ns: int
    end_ns: int
    stream_ms: float | None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Span:
    """A span's context; as a decorator it opens ``span(name)`` anew at
    every call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Setup(_Span):
    """A set-up span outside a profiler: its host seconds go to
    ``totals()`` unless a span of its name is already open."""

    __slots__ = ("t0",)

    def __enter__(self):
        self.t0 = _setup_open(self.name)
        return self

    def __exit__(self, *exc):
        _setup_close(self.name, self.t0)
        return False


class _Traced(_Span):
    __slots__ = ("rf", "parent", "t0", "ev0", "setup_t0")

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = None
            _local.timed = _draw() < STREAM_SHARE
        stack.append(self.name)
        self.setup_t0 = (_setup_open(self.name)
                         if self.name.startswith(SETUP) else None)
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time_ns()
        self.ev0 = (_event() if self.name in STREAMED and _local.timed
                    else None)
        return self

    def __exit__(self, *exc):
        ev1 = _event() if self.ev0 is not None else None
        t1 = time_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        if self.setup_t0 is not None:
            _setup_close(self.name, self.setup_t0)
        _pending.append((self.name, self.parent, self.t0, t1, self.ev0, ev1))
        return False


_NULLS: dict = {}


def span(name: str):
    """The span ``name``: a context manager, or a decorator that opens it
    around every call of the function."""
    if _profiling():
        return _Traced(name)
    null = _NULLS.get(name)
    if null is not None:
        return null
    if name.startswith(SETUP):
        return _Setup(name)
    return _NULLS.setdefault(name, _Span(name))


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    """A timing event (from the pool, or new) recorded on the current
    stream, in a process that has started CUDA; else None."""
    if not torch.cuda.is_initialized():
        return None
    ev = _free.pop() if _free else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _setup_open(name: str):
    """perf_counter at the start of set-up span ``name``, or None when a
    span of that name is already open on this thread."""
    opened = getattr(_local, "setup", None)
    if opened is None:
        opened = _local.setup = set()
    if name in opened:
        return None
    opened.add(name)
    return perf_counter()


def _setup_close(name: str, t0) -> None:
    if t0 is None:
        return
    _local.setup.discard(name)
    _totals[name] = _totals.get(name, 0.0) + perf_counter() - t0


def records() -> list:
    """Every traced span closed since the last ``reset()``, as
    ``Record``s (waiting for the events of those not yet resolved)."""
    for name, parent, t0, t1, ev0, ev1 in _pending:
        ms = None
        if ev0 is not None:
            ev0.synchronize()
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
            _free.extend((ev0, ev1))
        _records.append(Record(name, parent, t0, t1, ms))
    del _pending[:]
    return list(_records)


def totals() -> dict:
    """Host seconds of the set-up spans, by name, since the last
    ``reset()``."""
    return dict(_totals)


def reset() -> None:
    """Drop the records and the set-up totals (the counters stay: take
    differences of ``counts()``)."""
    _free.extend(ev for p in _pending for ev in p[4:] if ev is not None)
    del _pending[:]
    del _records[:]
    _totals.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (``n=0`` declares it)."""
    _counts[name] = _counts.get(name, 0) + n


def declare_launches(*keys: str) -> None:
    """Declare launch counters (each at 0 until counted), the keys that
    ``launches`` gives."""
    for k in keys:
        _launch_keys.add(k)
        _counts.setdefault(k, 0)


def launches(before: dict | None = None) -> dict:
    """Every declared launch counter's count since the snapshot ``before``
    (all of it without one), by key; the work counters are left out."""
    before = before or {}
    return {k: _counts[k] - before.get(k, 0) for k in sorted(_launch_keys)}


def counts() -> dict:
    """A snapshot of every counter."""
    return dict(_counts)


def since(before: dict) -> dict:
    """The counters that moved after the snapshot ``before``, by how
    much."""
    return {k: v - before.get(k, 0) for k, v in _counts.items()
            if v != before.get(k, 0)}
