"""The curve post's stream ms a frame: the CUDA-event time of the
program's ``curve.post`` spans (the hair AOVs: tangent, rgb, position,
depth, texcoord) in the traced window, the timed spans' mean scaled to
every span, over the frames."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("curve.post",))
