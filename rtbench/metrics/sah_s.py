"""Host seconds of the program's SAH builds in set-up: its ``build.sah``
spans (``build_triangle_bvh``), every build summed."""

from rtbench import spans


def read(run):
    return spans.setup_s("build.sah")
