"""4x4 transform utilities (port of ``nanort_tpu.scene.matrix``;
reference nanosg::Matrix, nanosg.h:57-236).

Host-side matrices are NumPy float64 for composition precision, copied
from the JAX module as they are. The batched transforms of points and
directions are torch: each product is its own op and the sums run
x, y, z in that order, so no fused multiply-add rounds differently from
the JAX package's einsum on a CPU without FMA.
"""

from __future__ import annotations

import numpy as np
import torch


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(t) -> np.ndarray:
    m = identity()
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    m = identity()
    s = np.broadcast_to(np.asarray(s, np.float64), (3,))
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(axis, angle_rad: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1 - c
    m = identity()
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m


def compose(*ms) -> np.ndarray:
    """Left-to-right composition: compose(A, B) applies B then A."""
    out = identity()
    for m in ms:
        out = out @ np.asarray(m, np.float64)
    return out


def inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, np.float64))


def inv_transpose33(m) -> np.ndarray:
    """Normal-transform matrix (reference inv_transpose_xform33,
    nanosg.h:432-438)."""
    return np.linalg.inv(np.asarray(m, np.float64)[:3, :3]).T


def transform_dirs(m33: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Apply 3x3 (batched ... x 3 x 3) to directions (... x 3)."""
    return (m33[..., 0] * d[..., 0:1] + m33[..., 1] * d[..., 1:2]
            + m33[..., 2] * d[..., 2:3])


def transform_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 (batched ... x 4 x 4) to points (... x 3), w assumed 1."""
    return transform_dirs(m[..., :3, :3], p) + m[..., :3, 3]


def xform_bbox(m: np.ndarray, bmin, bmax):
    """Transform an AABB by its 8 corners (reference XformBoundingBox,
    nanosg.h:241-295)."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    corners = np.array(
        [[bmin[i] if (k >> i) & 1 == 0 else bmax[i] for i in range(3)]
         for k in range(8)]
    )
    w = corners @ np.asarray(m, np.float64)[:3, :3].T + np.asarray(m)[:3, 3]
    return w.min(axis=0), w.max(axis=0)
