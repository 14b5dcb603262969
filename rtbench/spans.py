"""What the program's own spans say of a run, for the readers of the span
metrics.

The program (``nanort_tpu_torch.utils.trace``) opens a profiler range
``nanort.<name>`` at each of its phases while a profiler records, keeps
each span's host ns and, for the phases whose device time it measures,
two CUDA events in a sampled share of its calls (``records()``:
``stream_ms``, the device time of what the span enqueued plus any wait
for the host inside it), sums the host seconds of its set-up spans
(``totals()``) and counts its kernel launches (``counts()``). A program without that module, or a run without such
spans, gives None here, and a reader gives None with it.
"""

from __future__ import annotations

PREFIX = "nanort."


def program_trace():
    """The program's trace module, or None where the program has none."""
    try:
        from nanort_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def records(run) -> list:
    """The program's span records of the traced window (spans are kept
    only while the profiler records), or [] without them."""
    tr = program_trace()
    if run.trace is None or tr is None or not run.units:
        return []
    return tr.records()


def stream_ms_a_call(run, names) -> float | None:
    """The stream ms of the program's spans named one of ``names`` in the
    traced window, a call: for each name, the mean of its timed spans
    times the number of its spans, summed over the names, over the calls
    (a span inside another of ``names`` counts once, in the outer one)."""
    spans = [r for r in records(run)
             if r.name in names and r.parent not in names]
    total, timed = 0.0, False
    for name in names:
        of = [r for r in spans if r.name == name]
        ms = [r.stream_ms for r in of if r.stream_ms is not None]
        if ms:
            total += sum(ms) / len(ms) * len(of)
            timed = True
    return total / run.units if timed else None


def host_pct_of_calls(run, ns: int) -> float:
    """``ns`` of host time as a share (%) of the window's calls' host
    seconds."""
    return 100.0 * ns / 1e9 / sum(run.unit_s)


def union(ranges) -> list:
    """The union of ``[(start, end)]`` as sorted disjoint ``[start, end]``."""
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def setup_s(name: str) -> float | None:
    """Host seconds of the program's set-up spans ``name`` in this
    process."""
    tr = program_trace()
    if tr is None:
        return None
    return tr.totals().get(name)
