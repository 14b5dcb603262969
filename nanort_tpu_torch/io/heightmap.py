"""Heightmap -> mesh (the reference's par_msquare example; a copy of
``nanort_tpu.io.heightmap``, NumPy only).

The reference runs marching squares over a grayscale image and raytraces
the resulting mesh (examples/par_msquare/). For ray tracing, the useful
product is the surface mesh itself; this builds the standard regular-grid
triangulation of a heightfield (two triangles per cell), plus an optional
threshold mask (cells below the threshold are dropped — the marching-
squares-style coverage cut).
"""

from __future__ import annotations

import numpy as np


def heightmap_to_mesh(height: np.ndarray, scale_xy: float = 1.0,
                      scale_z: float = 1.0, threshold: float | None = None):
    """height: (H, W) float. Returns (vertices, faces)."""
    h = np.asarray(height, np.float32)
    H, W = h.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    verts = np.stack(
        [xs * scale_xy, h * scale_z, ys * scale_xy], -1
    ).reshape(-1, 3)
    # two triangles per cell
    i0 = (ys[:-1, :-1] * W + xs[:-1, :-1]).astype(np.int32)
    a = i0.reshape(-1)
    b = a + 1
    c = a + W
    d = a + W + 1
    f1 = np.stack([a, c, b], -1)
    f2 = np.stack([b, c, d], -1)
    faces = np.concatenate([f1, f2])
    if threshold is not None:
        cell = 0.25 * (h[:-1, :-1] + h[:-1, 1:] + h[1:, :-1] + h[1:, 1:])
        keep = (cell >= threshold).reshape(-1)
        faces = faces[np.concatenate([keep, keep])]
    return verts, faces.astype(np.int32)
