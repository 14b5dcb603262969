"""The API's id remap's stream ms a call: the CUDA-event time of the
program's ``rtc.remap`` spans (``searchsorted`` of the geometry, local
ids, hit positions, normals) in the traced window, the timed spans' mean
scaled to every span, over the calls."""

from rtbench import spans


def read(run):
    return spans.stream_ms_a_call(run, ("rtc.remap",))
