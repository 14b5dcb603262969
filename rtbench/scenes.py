"""The benchmark's scenes, made from a configuration file (host NumPy).

A configuration's ``scene`` entry names a generator and, optionally, a
placement, each a file of its own that ``make_scene`` finds by name:

    {"generator": "<g>", "args": {...},
     "placement": {"name": "<p>", "args": {...}}}

``rtbench/generators/<g>.py`` has ``make(**args)``, which returns
(vertices, faces, material ids or None, materials or None) of one
copy; ``rtbench/placements/<p>.py`` has ``make(**args)``, one float64
4x4 a copy (without a placement, one copy at the identity). A new scene
is a new generator or placement file and a configuration naming it.

Frozen copies, so that a change to the program cannot move the
yardstick (the generators call them):

* ``make_quad``, ``make_uv_sphere``, ``make_subdivided_sphere_scene``,
  ``merge_meshes``, ``make_cornell_pt_scene`` and
  ``make_cornell_dense_pt_scene`` copy ``nanort_tpu_torch/io/
  procedural.py`` (lines 14-19, 40-64, 79-87, 90-97, 100-173 and
  176-197) as they stood when the benchmark was written;
* ``translate``, ``rotate`` and ``compose`` copy ``nanort_tpu_torch/
  scene/matrix.py:22-58``.

The geometry depends on the configuration alone, never on the seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def make_quad(p0, p1, p2, p3):
    verts = np.array([p0, p1, p2, p3], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces


def make_uv_sphere(n_lat: int = 16, n_lon: int = 32, radius: float = 1.0,
                   center=(0.0, 0.0, 0.0)):
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + np.asarray(
        center, np.float64)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def make_subdivided_sphere_scene(n_tris_target: int):
    n_lat = max(4, int(np.sqrt(n_tris_target / 4.0)))
    return make_uv_sphere(n_lat, 2 * n_lat)


def merge_meshes(*meshes):
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int32) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def make_cornell_pt_scene(size: float = 2.0, light_scale: float = 0.4):
    """The Cornell box of the path tracer: (vertices, faces, material ids,
    materials). Materials: 0 white, 1 red, 2 green, 3 light, 4 mirror,
    5 glass."""
    s = size / 2
    vs, fs, mids = [], [], []

    def add(quad, mat):
        v, f = quad
        off = sum(len(x) for x in vs)
        vs.append(v)
        fs.append(f + off)
        mids.extend([mat, mat])

    add(make_quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]), 0)
    add(make_quad([-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]), 0)
    add(make_quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]), 1)
    add(make_quad([s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]), 2)
    add(make_quad([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]), 0)
    l = s * light_scale
    ly = s - 0.01 * size
    add(make_quad([-l, ly, -l], [l, ly, -l], [l, ly, l], [-l, ly, l]), 3)

    def add_box(cx, cz, w, h, mat):
        x0, x1 = cx - w, cx + w
        z0, z1 = cz - w, cz + w
        y0, y1 = -s, -s + h
        add(make_quad([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),
            mat)
        add(make_quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
            mat)
        add(make_quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),
            mat)
        add(make_quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
            mat)
        add(make_quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),
            mat)

    add_box(-0.35 * s, -0.3 * s, 0.3 * s, 1.2 * s, 0)
    add_box(0.45 * s, 0.35 * s, 0.25 * s, 0.55 * s, 0)

    materials = dict(
        diffuse=np.array([[0.75, 0.75, 0.75], [0.75, 0.10, 0.10],
                          [0.10, 0.75, 0.10], [0.0, 0.0, 0.0],
                          [0.02, 0.02, 0.02], [0.0, 0.0, 0.0]], np.float32),
        emission=np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0],
                           [14.0, 13.0, 11.0], [0, 0, 0], [0, 0, 0]],
                          np.float32),
        specular=np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
                           [0.9, 0.9, 0.9], [0.1, 0.1, 0.1]], np.float32),
        transmittance=np.array([[0, 0, 0]] * 5 + [[0.95, 0.95, 0.95]],
                               np.float32),
        ior=np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.5], np.float32),
        dissolve=np.array([0, 0, 0, 0, 0, 1.0], np.float32),
    )
    return (np.concatenate(vs), np.concatenate(fs), np.asarray(mids, np.int32),
            materials)


def make_cornell_dense_pt_scene(n_tris_target: int = 100_000,
                                size: float = 2.0):
    """The Cornell box with a densely tessellated white sphere in place of
    its two inner boxes, ~``n_tris_target`` triangles."""
    verts, faces, mids, mats = make_cornell_pt_scene(size)
    n_box = 20
    faces = faces[:-n_box]
    mids = mids[:-n_box]
    sv, sf = make_subdivided_sphere_scene(
        max(n_tris_target - faces.shape[0], 64))
    s = size / 2
    sv = sv * (0.45 * s)
    sv[:, 1] -= 0.5 * s
    verts2, faces2 = merge_meshes((verts, faces), (sv, sf))
    mids2 = np.concatenate([mids, np.zeros(sf.shape[0], np.int32)])
    return verts2, faces2, np.asarray(mids2, np.int32), mats


def translate(t) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = t
    return m


def rotate(axis, angle_rad: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m


def compose(*ms) -> np.ndarray:
    out = np.eye(4)
    for m in ms:
        out = out @ np.asarray(m, np.float64)
    return out


class Scene(NamedTuple):
    """A configuration's geometry. ``vertices``/``faces``: one copy's
    local mesh (float32, int32); ``xforms``: one float64 4x4 per copy
    (a single identity for a scene that is not placed);
    ``material_ids``/``materials``: one copy's path-tracer tables (every
    copy shares them), or None."""

    vertices: np.ndarray
    faces: np.ndarray
    xforms: list
    material_ids: np.ndarray | None
    materials: dict | None

    @property
    def n_tris(self) -> int:
        return len(self.faces) * len(self.xforms)

    def world(self, dtype=np.float32):
        """(vertices, faces) of the world-space union: copy k's vertices
        transformed by its matrix in float64, then cast to ``dtype``."""
        v64 = self.vertices.astype(np.float64)
        vs, fs = [], []
        for k, m in enumerate(self.xforms):
            vs.append((v64 @ m[:3, :3].T + m[:3, 3]).astype(dtype))
            fs.append(self.faces.astype(np.int64) + k * len(self.vertices))
        return np.concatenate(vs), np.concatenate(fs)

    def world_material_ids(self):
        """The material id of each world triangle (copy k's are copy 0's),
        or None."""
        if self.material_ids is None:
            return None
        return np.tile(np.asarray(self.material_ids, np.int32),
                       len(self.xforms))


def make_scene(recipe: dict) -> Scene:
    """The scene of a configuration file's ``scene`` entry."""
    from rtbench.harness import load_module

    gen = load_module("generators", recipe["generator"])
    v, f, mids, mats = gen.make(**recipe.get("args", {}))
    place = recipe.get("placement")
    if place is None:
        xforms = [np.eye(4)]
    else:
        xforms = list(load_module("placements", place["name"]).make(
            **place.get("args", {})))
    return Scene(np.asarray(v, np.float32), np.asarray(f, np.int32), xforms,
                 mids, mats)
