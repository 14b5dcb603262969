"""Path-traced samples (pixels x spp) of every render completed in the
window, over the window's whole time, in millions a second."""


def read(run):
    return run.state.per_unit["samples"] * run.units / run.window_s / 1e6
