"""The AOVs' stream ms a frame: the CUDA-event time of the program's
``aovs`` spans (``aovs_from_hits``: normals, rgb, positions, depth,
texcoords) in the traced window, the timed spans' mean scaled to every
span, over the frames."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("aovs",))
