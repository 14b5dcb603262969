"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run: set-up (the cell's scene and inputs from the seed, the build
through the program, its kernels loaded from the build directory in the
checkout, the cell's own shapes warmed up), then a closed loop of one
caller for ``--seconds`` (the next call starts when the last one has
completed), then the comparison with the plain reference, then one JSON
line on standard output. Everything a cell needs is found by name:

* ``BENCHMARK.json``: the cell, its configuration and traffic names, the
  end-to-end and per-layer metrics and the cells each reports in;
* ``rtbench/configs/<config>.json``: the scene recipe, whose generator
  and placement are ``rtbench/generators/<name>.py`` and
  ``rtbench/placements/<name>.py`` (``scenes.make_scene``);
* ``rtbench/traffic/<traffic>.json``: the entry it drives
  (``rtbench/entries/<entry>.py``), its parameters and the limits of the
  numbers its comparison reads;
* ``rtbench/e2e/<metric>.py`` and ``rtbench/metrics/<metric>.py``: one
  reader a metric, ``read(run) -> float | None``; a metric without a
  file of its own is read by the file of its name's part before the
  first dot (``glue_pct.rays`` by ``glue_pct.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "rtbench")
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "nanort_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``rtbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(kind: str, name: str):
    """The reader of metric ``name``: ``rtbench/<kind>/<name>.py``, or
    where there is none, the reader of the name's part before the first
    dot, which the metrics named ``<part>.<suffix>`` share."""
    if not os.path.exists(os.path.join(HERE, kind, name + ".py")):
        name = name.split(".", 1)[0]
    return load_module(kind, name)


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s values put in, nested dicts key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def unit_seed(seed: int, i: int) -> int:
    """A 31-bit seed for call ``i`` of a run seeded ``seed``."""
    return splitmix(splitmix(seed & 0xFFFFFFFFFFFFFFFF) ^ i) & 0x7FFFFFFF


class Cell:
    """A cell resolved by name: its entry in ``BENCHMARK.json``, its
    configuration and traffic files (with test-only overrides merged in),
    the metrics it reports."""

    def __init__(self, bench: dict, name: str, overrides: dict | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        overrides = overrides or {}
        cfg = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(os.path.join(ROOT, cfg["file"]))
        self.config["scene"] = merged(self.config["scene"],
                                      overrides.get("config", {}))
        self.traffic = merged(load_json(os.path.join(
            HERE, "traffic", self.spec["traffic"] + ".json")),
            overrides.get("traffic", {}))
        self.chips = int(self.spec["chips"])

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


class Run:
    """What the readers of a run's metrics see.

    ``scene``: the configuration's ``scenes.Scene``; ``entry``: the
    entry module, whose ``work(run)`` gives each kernel's (bytes,
    operations) a call; ``state``: the entry's state, whose ``per_unit``
    gives the work of one call (``rays``, ``samples``); ``unit_s``: host
    seconds of each call of the window, each ending when its work has
    completed; ``window_s``: the window's host seconds; ``setup_s``;
    ``check_s``: the comparison's seconds; ``spans``: named host seconds
    the entry recorded in set-up (``build``); and, in a traced run,
    ``trace`` (``trace.Trace``)."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.scene = None
        self.entry = None
        self.state = None
        self.unit_s: list[float] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.check_s = 0.0
        self.spans: dict[str, float] = {}
        self.trace = None

    @property
    def units(self) -> int:
        return len(self.unit_s)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool = False, device="cuda", overrides=None,
             t_start: float | None = None, entry_hook=None,
             control: bool = False) -> tuple:
    """Run cell ``name`` once. Returns ``(result, checks)``: the result
    line as a dict, and the compared numbers ``[(name, value, limit)]``.
    ``overrides`` (tests) replaces configuration and traffic values;
    ``entry_hook(entry)`` (tests) may change the entry module before it
    runs; ``control`` adds the numbers that the reference in the next
    lower precision reads in the program's place (``result["control"]``;
    the benchmark's own runs never ask for them)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    cell = Cell(bench, name, overrides)
    entry = load_module("entries", cell.traffic["entry"])
    if entry_hook is not None:
        entry_hook(entry)
    run = Run(cell, seed, torch.device(device))
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    from . import scenes

    run.scene = scenes.make_scene(cell.config["scene"])
    run.entry = entry
    run.state = entry.setup(run)
    sync(dev)

    prof = None
    if trace:
        from . import trace as trace_mod

        prof = trace_mod.start(dev)
    t_first = time.perf_counter()
    run.setup_s = t_first - t_start
    deadline = t_first + float(seconds)
    i = 0
    with _one_core(dev.type == "cuda"), _mark("rtbench.window", prof):
        while True:
            t0 = time.perf_counter()
            with _mark("rtbench.call", prof):
                entry.unit(run, i)
            t1 = time.perf_counter()
            run.unit_s.append(t1 - t0)
            i += 1
            if t1 >= deadline:
                break
    run.window_s = t1 - t_first
    if prof is not None:
        run.trace = trace_mod.finish(prof)

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    entry.finish(run)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = entry.check(run)
    low = entry.check(run, control=True) if control else None
    run.check_s = time.perf_counter() - t_check
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)

    if trace:
        specs = cell.per_layer
        kind = "metrics"
    else:
        specs = cell.end_to_end
        kind = "e2e"
    metrics = {}
    for m in specs:
        value = load_reader(kind, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": run.units,
        "failed": 0,
        "metrics": metrics,
        "device": _device(dev, cell.chips, memory_peak),
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    q = sorted(run.unit_s)
    result["phases"] = {
        "setup": run.setup_s, "window": run.window_s,
        "comparison": run.check_s,
        "call_ms": {f"p{p}": q[min(len(q) - 1, len(q) * p // 100)] * 1e3
                    for p in (50, 95, 99, 100)}}
    if low is not None:
        result["control"] = {n: {"value": v, "limit": lim}
                             for n, v, lim in low}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


@contextlib.contextmanager
def _one_core(on: bool):
    """Keep the calling thread on one CPU (the last it may use) while the
    window runs: the caller's loop is one thread, and a host-bound loop
    that the scheduler moves between cores spreads its frame times about
    three times as widely from process to process."""
    if not on or not hasattr(os, "sched_setaffinity"):
        yield
        return
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(allowed)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, allowed)


def _mark(name: str, prof):
    """A profiler range named ``name`` when tracing, else nothing."""
    if prof is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def _device(dev, chips: int, memory_peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(memory_peak)}


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``nanort_tpu_torch/_build/``
    there)."""
    base = os.path.join(ROOT, ".rtbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(prog="python3 -m rtbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = Cell(bench, args.workload).chips

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: needs {chips} CUDA device(s); found {found}: no "
              "result", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: forbidden modules loaded: {bad}: no result",
              file=sys.stderr)
        return 4
    print(f"rtbench phases (s): {result['phases']}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"rtbench check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
