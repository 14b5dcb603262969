"""The 32-triangle Cornell box of the path tracer, with its two inner
boxes and six materials (``scenes.make_cornell_pt_scene``, frozen from
the program's ``io/procedural.py``)."""

from rtbench import scenes


def make(size: float = 2.0, light_scale: float = 0.4):
    return scenes.make_cornell_pt_scene(float(size), float(light_scale))
