"""The camera's and the tiling's stream ms a frame: the CUDA-event time
of the program's ``camera`` (``look_at``, ``pinhole_rays``), ``tile`` and
``untile`` spans in the traced window, the timed spans' mean scaled to
every span, over the frames."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("camera", "tile", "untile"))
