"""What one of the program's spans costs on the host, off and on.

    python3 tools/span_cost.py [--n 200000] [--out span_cost.json]

Times ``utils.trace.span`` with no profiler running ("off"), and under a
profiler recording CPU activity (and CUDA activity on a card): a span
that keeps no device time (``k1``), one in ``trace.STREAMED`` (``aovs``)
at the sampled share ``trace.STREAM_SHARE`` and timed every time (two
CUDA events on a card, none on the CPU), and the profiler range alone. Each figure is the best of three loops of spans
with nothing inside, less the same loop without them, in us a span, on
the host it runs on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _us(fn, n: int) -> float:
    def loop(body):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return time.perf_counter() - t0

    return (min(loop(fn) for _ in range(3))
            - min(loop(lambda: None) for _ in range(3))) / n * 1e6


def span_cost(n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nanort_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU]
    res = {"device": "cpu", "n": n}
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        acts.append(ProfilerActivity.CUDA)
        res["device"] = torch.cuda.get_device_name(0)

    def span(name):
        def body():
            with trace.span(name):
                pass
        return body

    def rng():
        with torch._C._profiler._RecordFunctionFast("nanort.k1"):
            pass

    trace.reset()
    res["off_us"] = _us(span("k1"), n)
    on = max(1, n // 10)
    with profile(activities=acts):
        res["on_us"] = _us(span("k1"), on)
        res["on_streamed_us"] = _us(span("aovs"), on)
        share, trace.STREAM_SHARE = trace.STREAM_SHARE, 1.0
        try:
            res["on_timed_us"] = _us(span("aovs"), on)
        finally:
            trace.STREAM_SHARE = share
        res["on_range_us"] = _us(rng, on)
    trace.reset()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/span_cost.py")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    res = span_cost(args.n)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
