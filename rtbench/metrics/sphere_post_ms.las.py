"""The sphere post's stream ms a frame: the CUDA-event time of the
program's ``sphere.post`` spans (PostTraversal's UV and the sphere AOVs:
normal, rgb, position, depth, texcoord) in the traced window, the timed
spans' mean scaled to every span, over the frames."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("sphere.post",))
