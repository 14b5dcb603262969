"""Vector displacement of mesh vertices (a copy of
``nanort_tpu.io.displacement``, NumPy only; reference examples/vdisp:
geometry-util.h ApplyVectorDispacement — displace along a tangent frame
or in world/object space from a displacement map sampled by UV).

Vectorized: one gather + FMA pass over all vertices of a facevarying
mesh. The vdisp example's BVH serialization cache is core.bvh.dump/load.
"""

from __future__ import annotations

import numpy as np


def compute_tangent_frames(tri_pos: np.ndarray, tri_uv: np.ndarray):
    """Per-face tangent/bitangent/normal from positions + UVs.
    tri_pos: (F, 3, 3); tri_uv: (F, 3, 2)."""
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    du1 = tri_uv[:, 1, 0] - tri_uv[:, 0, 0]
    dv1 = tri_uv[:, 1, 1] - tri_uv[:, 0, 1]
    du2 = tri_uv[:, 2, 0] - tri_uv[:, 0, 0]
    dv2 = tri_uv[:, 2, 1] - tri_uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    inv = np.where(np.abs(det) > 1e-20, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * dv2[:, None] - e2 * dv1[:, None]) * inv[:, None]
    b = (e2 * du1[:, None] - e1 * du2[:, None]) * inv[:, None]
    n = np.cross(e1, e2)

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-20)

    return norm(t), norm(b), norm(n)


def sample_map(dispmap: np.ndarray, uv: np.ndarray):
    """Nearest-texel lookup of an (H, W, C) map at (N, 2) uvs in [0,1]."""
    h, w = dispmap.shape[:2]
    x = np.clip((uv[:, 0] * w).astype(np.int64), 0, w - 1)
    y = np.clip(((1.0 - uv[:, 1]) * h).astype(np.int64), 0, h - 1)
    return dispmap[y, x]


def apply_vector_displacement(
    tri_pos: np.ndarray,
    tri_uv: np.ndarray,
    dispmap: np.ndarray,
    scale: float = 1.0,
    space: str = "tangent",
):
    """Displace facevarying vertices by a 3-channel vector map.

    tri_pos: (F, 3, 3) facevarying positions; tri_uv: (F, 3, 2);
    dispmap: (H, W, 3). space: 'tangent' (map xyz along T/B/N) or
    'world' (map added directly). Returns displaced (F, 3, 3).
    """
    F = tri_pos.shape[0]
    uv_flat = tri_uv.reshape(-1, 2)
    d = sample_map(np.asarray(dispmap, np.float32), uv_flat).reshape(F, 3, 3)
    if space == "world":
        return tri_pos + scale * d
    t, b, n = compute_tangent_frames(tri_pos, tri_uv)
    disp = (
        d[..., 0:1] * t[:, None]
        + d[..., 1:2] * b[:, None]
        + d[..., 2:3] * n[:, None]
    )
    return tri_pos + scale * disp


def weld_vertices(tri_pos: np.ndarray, tol: float = 0.0):
    """Facevarying (F, 3, 3) -> indexed (V, 3), (F, 3) mesh by welding
    equal (or tol-close) corners."""
    flat = tri_pos.reshape(-1, 3)
    if tol > 0:
        key = np.round(flat / tol).astype(np.int64)
    else:
        key = flat
    _, idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    return flat[idx], inv.reshape(-1, 3).astype(np.int32)
