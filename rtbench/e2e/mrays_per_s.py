"""Rays whose records were returned in the window, over the window's
whole time, in millions a second."""


def read(run):
    return run.state.per_unit["rays"] * run.units / run.window_s / 1e6
