"""The share (%) of the device's idle time in the traced window that
falls inside one of the program's ``nanort.*`` host ranges: how much of
the idle the program's spans put a name to (the rest is the caller's and
the benchmark's own time between calls). It reads every
``idle_in_spans_pct.<suffix>``: the cells they list differ in the
end-to-end metric the share moves."""

from rtbench import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    named = spans.union([(s, e) for n, s, e in tr.host
                         if n.startswith(spans.PREFIX)])
    gaps = tr.gaps()
    idle = sum(e - s for s, e in gaps)
    if not named or idle <= 0:
        return None
    return 100.0 * spans.overlap([list(g) for g in gaps], named) / idle
