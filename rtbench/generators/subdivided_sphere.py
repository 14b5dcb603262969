"""A UV sphere of ~``n_tris_target`` triangles about the origin, radius
1, without materials (``scenes.make_subdivided_sphere_scene``, frozen
from the program's ``io/procedural.py``)."""

from rtbench import scenes


def make(n_tris_target: int = 1_000_000):
    v, f = scenes.make_subdivided_sphere_scene(int(n_tris_target))
    return v, f, None, None
