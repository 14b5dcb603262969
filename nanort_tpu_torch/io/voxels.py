"""Voxel/box-grid meshing (a copy of ``nanort_tpu.io.voxels``: NumPy
only, so both packages mesh a grid identically) — the geometric core of
the reference's minecraft (region -> cube scene,
examples/minecraft/main.cc:401-430) and qrcode (QR modules -> cube
boxes, examples/qrcode/) examples.

``voxels_to_mesh`` turns a 3D occupancy grid into a cube mesh with hidden
internal faces removed; ``grid2d_to_boxes`` extrudes a 2D boolean grid
(a QR symbol, a heightless map) into boxes.
"""

from __future__ import annotations

import numpy as np

# cube face definitions: (axis, direction, 4 corner offsets CCW from outside)
_FACES = [
    (0, -1, [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)]),
    (0, +1, [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)]),
    (1, -1, [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)]),
    (1, +1, [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)]),
    (2, -1, [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)]),
    (2, +1, [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]),
]


def voxels_to_mesh(occ: np.ndarray, voxel_size: float = 1.0,
                   origin=(0.0, 0.0, 0.0)):
    """occ: (X, Y, Z) boolean occupancy. Returns (vertices, faces) with
    faces only where a filled voxel borders an empty one (or the outside).
    """
    occ = np.asarray(occ, bool)
    verts_list, faces_list = [], []
    n_v = 0
    for axis, dirn, corners in _FACES:
        # neighbor occupancy shifted along the face axis
        pad = [(0, 0)] * 3
        pad[axis] = (1, 1)
        padded = np.pad(occ, pad)
        sl = [slice(None)] * 3
        sl[axis] = slice(2, None) if dirn > 0 else slice(0, -2)
        neighbor = padded[tuple(sl)]
        exposed = occ & ~neighbor
        cells = np.argwhere(exposed)
        if len(cells) == 0:
            continue
        base = cells.astype(np.float32)
        quad = np.asarray(corners, np.float32)  # (4, 3)
        v = (base[:, None, :] + quad[None]) * voxel_size + np.asarray(
            origin, np.float32
        )
        n = len(cells)
        idx = n_v + np.arange(n * 4).reshape(n, 4)
        f = np.concatenate(
            [idx[:, [0, 1, 2]], idx[:, [0, 2, 3]]], axis=0
        )
        verts_list.append(v.reshape(-1, 3))
        faces_list.append(f)
        n_v += n * 4
    if not verts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return (
        np.concatenate(verts_list),
        np.concatenate(faces_list).astype(np.int32),
    )


def grid2d_to_boxes(grid: np.ndarray, box_height: float = 1.0,
                    cell_size: float = 1.0):
    """2D boolean grid (e.g. a QR symbol) -> extruded cube mesh."""
    g = np.asarray(grid, bool)
    occ = g[:, None, :]  # (X, 1, Z): one-voxel-tall slab
    v, f = voxels_to_mesh(occ, voxel_size=cell_size)
    v[:, 1] *= box_height / max(cell_size, 1e-30)
    return v, f
