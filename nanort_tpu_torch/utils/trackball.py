"""Quaternion arcball/trackball (port of ``nanort_tpu.utils.trackball``:
the quaternion math is a NumPy copy, ``camera_from_quat`` builds the
port's ``models.cameras.Camera`` on ``device``; reference
examples/common/trackball.cc, the GUI camera control). Projects screen
drags onto a virtual sphere and composes rotations as quaternions;
build_rotmatrix converts to a 3x3/4x4.
"""

from __future__ import annotations

import numpy as np

TRACKBALL_SIZE = 0.8  # reference TRACKBALLSIZE


def _project_to_sphere(r, x, y):
    d = np.hypot(x, y)
    if d < r * 0.70710678118654752440:
        return np.sqrt(r * r - d * d)  # inside sphere
    t = r / 1.41421356237309504880  # on hyperbola
    return t * t / max(d, 1e-30)


def trackball(p1x, p1y, p2x, p2y, size=TRACKBALL_SIZE):
    """Quaternion (x, y, z, w) for a drag from p1 to p2 in [-1, 1] coords."""
    if p1x == p2x and p1y == p2y:
        return np.array([0.0, 0.0, 0.0, 1.0])
    pa = np.array([p1x, p1y, _project_to_sphere(size, p1x, p1y)])
    pb = np.array([p2x, p2y, _project_to_sphere(size, p2x, p2y)])
    axis = np.cross(pb, pa)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis /= n
    t = np.clip(np.linalg.norm(pa - pb) / (2.0 * size), -1.0, 1.0)
    phi = 2.0 * np.arcsin(t)
    s = np.sin(phi / 2.0)
    return np.array([*(axis * s), np.cos(phi / 2.0)])


def add_quats(q1, q2):
    """Compose rotations (q1 applied after q2), normalized."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    out = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    return out / np.linalg.norm(out)


def build_rotmatrix(q):
    """4x4 rotation from quaternion (x, y, z, w) (reference
    build_rotmatrix; feeds Camera::setTransformation, gui/camera.cc:23)."""
    x, y, z, w = np.asarray(q, np.float64)
    m = np.eye(4)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (z * x + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (z * x - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


def camera_from_quat(q, look_at_pos, distance, width, height, fov=45.0,
                     device="cuda"):
    """The reference BaseCamera::setTransformation contract
    (gui/camera.cc:23-37): camera basis from the trackball quaternion,
    eye = look_at + dist * (third basis column), computed in float64 on
    the host and stored as float32 tensors on ``device`` (the card unless
    the caller asks for another device)."""
    import torch

    from ..models.cameras import Camera

    m = build_rotmatrix(q)
    u, v, w = m[:3, 0], m[:3, 1], m[:3, 2]
    eye = np.asarray(look_at_pos, np.float64) + w * abs(distance)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        eye=t(eye), u=t(u), v=t(v), w=t(w),
        width=int(width), height=int(height), fov=float(fov),
    )
