"""Procedural test/benchmark geometry (host NumPy).

The reference ships OBJ assets (cornellbox_suzanne.obj etc.); we generate
equivalent-complexity scenes procedurally so tests and benchmarks are
self-contained and scale to arbitrary triangle counts (e.g. the 1M-tri
benchmark scene).
"""

from __future__ import annotations

import numpy as np


def make_quad(p0, p1, p2, p3):
    """Two triangles for a quad given CCW corners."""
    verts = np.array([p0, p1, p2, p3], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces


def make_cornell_box(size: float = 2.0):
    """An open box (5 quads = 10 tris) centered at origin, like the
    cornellbox scenes used by the reference examples."""
    s = size / 2
    vs, fs = [], []

    def add(quad):
        v, f = quad
        fs.append(f + sum(len(x) for x in vs))
        vs.append(v)

    add(make_quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]))  # floor
    add(make_quad([-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]))  # ceiling
    add(make_quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]))  # left
    add(make_quad([s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]))  # right
    add(make_quad([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]))  # back
    return np.concatenate(vs), np.concatenate(fs)


def make_uv_sphere(n_lat: int = 16, n_lon: int = 32, radius: float = 1.0,
                   center=(0.0, 0.0, 0.0)):
    """Standard UV sphere triangulation: 2*n_lon*(n_lat-1) triangles."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + np.asarray(
        center, np.float64
    )
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


def make_random_triangles(n: int, seed: int = 0, extent: float = 1.0,
                          tri_size: float = 0.05):
    """Random triangle soup in [-extent, extent]^3 — worst-case incoherent
    geometry for BVH stress tests."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-extent, extent, (n, 1, 3))
    offs = rng.normal(0.0, tri_size, (n, 2, 3))
    tri = np.concatenate([base, base + offs], axis=1).astype(np.float32)
    verts = tri.reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, faces


def make_subdivided_sphere_scene(n_tris_target: int, seed: int = 0):
    """A smooth, benchmark-grade scene with ~n_tris_target triangles:
    a finely tessellated sphere (stands in for Stanford-bunny-class
    scanned meshes). Coherent primary rays over it exercise exactly the
    1M-tri headline benchmark geometry profile."""
    # 2*n_lon*(n_lat-1) ~= n_target with n_lon = 2*n_lat
    n_lat = max(4, int(np.sqrt(n_tris_target / 4.0)))
    n_lon = 2 * n_lat
    return make_uv_sphere(n_lat, n_lon)


def merge_meshes(*meshes):
    """Concatenate (verts, faces) pairs into one mesh."""
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int32) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def make_cornell_pt_scene(size: float = 2.0, light_scale: float = 0.4):
    """Classic Cornell box for the path tracer: colored side walls, white
    floor/ceiling/back, two boxes, and an emissive ceiling quad.

    Returns (vertices, faces, material_ids, materials_dict) where
    materials_dict holds per-material arrays matching models.path_tracer.
    Materials: 0 white, 1 red, 2 green, 3 light, 4 mirror, 5 glass.
    """
    s = size / 2
    vs, fs, mids = [], [], []

    def add(quad, mat):
        v, f = quad
        off = sum(len(x) for x in vs)
        vs.append(v)
        fs.append(f + off)
        mids.extend([mat, mat])

    add(make_quad([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]), 0)  # floor
    add(make_quad([-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]), 0)  # ceiling
    add(make_quad([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]), 1)  # left red
    add(make_quad([s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]), 2)  # right green
    add(make_quad([s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]), 0)  # back
    # ceiling light (slightly below ceiling; winding chosen so the
    # geometric normal faces down into the box — the cosine EDF and NEE
    # cosAtLight use it)
    l = s * light_scale
    ly = s - 0.01 * size
    add(make_quad([-l, ly, -l], [l, ly, -l], [l, ly, l], [-l, ly, l]), 3)

    # tall box (mirror-ish) and short box (white)
    def add_box(cx, cz, w, h, mat):
        x0, x1 = cx - w, cx + w
        z0, z1 = cz - w, cz + w
        y0, y1 = -s, -s + h
        add(make_quad([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]), mat)  # top
        add(make_quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]), mat)  # front
        add(make_quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]), mat)  # back
        add(make_quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]), mat)  # left
        add(make_quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]), mat)  # right

    add_box(-0.35 * s, -0.3 * s, 0.3 * s, 1.2 * s, 0)
    add_box(0.45 * s, 0.35 * s, 0.25 * s, 0.55 * s, 0)

    verts = np.concatenate(vs)
    faces = np.concatenate(fs)
    material_ids = np.asarray(mids, np.int32)
    materials = dict(
        diffuse=np.array(
            [
                [0.75, 0.75, 0.75],
                [0.75, 0.10, 0.10],
                [0.10, 0.75, 0.10],
                [0.0, 0.0, 0.0],
                [0.02, 0.02, 0.02],
                [0.0, 0.0, 0.0],
            ],
            np.float32,
        ),
        emission=np.array(
            [[0, 0, 0], [0, 0, 0], [0, 0, 0], [14.0, 13.0, 11.0], [0, 0, 0], [0, 0, 0]],
            np.float32,
        ),
        specular=np.array(
            [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0.9, 0.9, 0.9], [0.1, 0.1, 0.1]],
            np.float32,
        ),
        transmittance=np.array(
            [[0, 0, 0]] * 5 + [[0.95, 0.95, 0.95]], np.float32
        ),
        ior=np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.5], np.float32),
        dissolve=np.array([0, 0, 0, 0, 0, 1.0], np.float32),
    )
    return verts, faces, material_ids, materials


def make_cornell_dense_pt_scene(n_tris_target: int = 100_000,
                                size: float = 2.0):
    """Mid-scale path-tracer scene: the Cornell PT box with a densely
    tessellated white sphere replacing the interior boxes
    (~n_tris_target total triangles). At the default 100K a SINGLE
    100-spp fused launch measured ~126 s and trips the ~2-min worker
    watchdog — render_path_traced chunks it into 4 x spp=25 launches
    (31.5 s each, measured green; tools/experiments/pt_fused_scale.md)
    — the old XLA cliff's territory."""
    verts, faces, mids, mats = make_cornell_pt_scene(size)
    n_box = 20  # the two interior boxes: 10 quads = 20 tris
    faces = faces[:-n_box]
    mids = mids[:-n_box]
    sv, sf = make_subdivided_sphere_scene(
        max(n_tris_target - faces.shape[0], 64))
    s = size / 2
    sv = sv * (0.45 * s)
    sv[:, 1] -= 0.5 * s  # sit low in the box
    verts2, faces2 = merge_meshes((verts, faces), (sv, sf))
    mids2 = np.concatenate(
        [mids, np.zeros(sf.shape[0], np.int32)])  # white diffuse
    return verts2, faces2, np.asarray(mids2, np.int32), mats
