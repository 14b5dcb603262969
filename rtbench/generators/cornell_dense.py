"""The Cornell box of the path tracer with a densely tessellated white
sphere in place of its two inner boxes, ~``n_tris_target`` triangles
(``scenes.make_cornell_dense_pt_scene``, frozen from the program's
``io/procedural.py``)."""

from rtbench import scenes


def make(n_tris_target: int = 100_000, size: float = 2.0):
    return scenes.make_cornell_dense_pt_scene(int(n_tris_target),
                                              float(size))
