"""The ray sort's stream ms a call: the CUDA-event time of the program's
``ray_sort.sort`` and ``ray_sort.unsort`` spans (keys, argsort, the
gathers of the rays, and the scatter of the records back) in the traced
window, the timed spans' mean scaled to every span, over the calls."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("ray_sort.sort", "ray_sort.unsort"))
