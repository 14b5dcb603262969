"""The 95th percentile of every frame of the window, each from its call
to its image in host memory, in ms (``statistics.quantiles``, n=20,
exclusive method)."""

import statistics


def read(run):
    if run.units < 20:
        return None
    return statistics.quantiles(run.unit_s, n=20)[18] * 1e3
