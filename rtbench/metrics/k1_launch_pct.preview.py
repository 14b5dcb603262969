"""The share (%) of the traced frames' host time spent in K1's launches:
the host time of the program's ``k1`` spans (the wrapper's checks, its
outputs, the launch plan and the launch itself) over the host seconds of
the window's calls. A share, since the profiler inflates the frame and
the launches alike."""

from rtbench import spans


def read(run):
    ns = [r.end_ns - r.start_ns for r in spans.records(run) if r.name == "k1"]
    if not ns:
        return None
    return spans.host_pct_of_calls(run, sum(ns))
