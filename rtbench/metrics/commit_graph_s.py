"""Host seconds of the API's scene-graph commit in set-up: the program's
``commit.graph`` span (``rtc`` ``commit``'s ``sg.commit``, one graph
build a mesh), which the fast route does not read."""

from rtbench import spans


def read(run):
    return spans.setup_s("commit.graph")
