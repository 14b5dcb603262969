"""Host seconds of the program's BVH16/BVH8 collapse in set-up: its
``build.collapse`` spans (``collapse_bvh8``)."""

from rtbench import spans


def read(run):
    return spans.setup_s("build.collapse")
