"""The share (%) of the traced frames' host time that ``render_ao``
spends outside K1's launches: the host time of the program's
``render_ao`` spans less that of the ``k1`` spans inside them, over the
host seconds of the window's calls. Under the profiler every operation
costs more on the host, so the frame and the phase are both inflated:
the share, not the ms, is the number to compare."""

import bisect

from rtbench import spans


def read(run):
    recs = spans.records(run)
    frames = sorted((r.start_ns, r.end_ns) for r in recs
                    if r.name == "render_ao")
    if not frames:
        return None
    starts = [s for s, _ in frames]
    ns = sum(e - s for s, e in frames)
    for r in recs:
        if r.name != "k1":
            continue
        i = bisect.bisect_right(starts, r.start_ns) - 1
        if i >= 0 and r.end_ns <= frames[i][1]:
            ns -= r.end_ns - r.start_ns
    return spans.host_pct_of_calls(run, ns)
