"""Pinhole camera on torch tensors (port of ``Camera``, ``look_at`` and
``pinhole_rays`` from ``nanort_tpu.models.cameras``; the reference GUI's
camera.cc:23-126).

Conventions (matching the reference): ``u`` = right, ``v`` = up, ``w`` =
*backward* (the camera looks along ``-w``); pixel coords xy in
[0, W) x [0, H) with y up, pixel centres at +0.5; ``fov`` is the
vertical field of view in degrees. The other six camera models of the
JAX package are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.math import normalize
from ..core.ray import Rays, make_rays


class Camera(NamedTuple):
    """Camera pose + image geometry; ``eye``/``u``/``v``/``w`` are (3,)
    tensors on the device the rays will be made on."""

    eye: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    width: int
    height: int
    fov: float


def look_at(eye, center, up=(0.0, 1.0, 0.0), width=512, height=512,
            fov=45.0, dtype=torch.float32, device=None) -> Camera:
    """Camera basis from eye/center/up, computed in float64 on the host
    and stored as ``dtype`` tensors on ``device``."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    w = eye - center
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Camera(eye=t(eye), u=t(u), v=t(v), w=t(w), width=int(width),
                  height=int(height), fov=float(fov))


def pixel_grid(cam: Camera):
    """(H, W) pixel-centre coordinates, y-up (row 0 = top of image)."""
    dt, dev = cam.eye.dtype, cam.eye.device
    x = torch.arange(cam.width, dtype=dt, device=dev) + 0.5
    y = (cam.height - 1 - torch.arange(cam.height, dtype=dt, device=dev)) + 0.5
    return torch.meshgrid(x, y, indexing="xy")


def _flen(cam: Camera) -> float:
    """Distance at which one pixel is one unit (camera.cc:95)."""
    return 0.5 * cam.height / math.tan(0.5 * math.radians(cam.fov))


def pinhole_rays(cam: Camera, xy=None) -> Rays:
    """Standard perspective camera (camera.cc:89-126): an (H, W) batch
    on the camera's device, all rays sharing the eye as origin."""
    x, y = pixel_grid(cam) if xy is None else xy
    flen = _flen(cam)
    corner = -cam.w * flen - 0.5 * (cam.width * cam.u + cam.height * cam.v)
    d = corner + x[..., None] * cam.u + y[..., None] * cam.v
    d = normalize(d)
    org = cam.eye.expand(d.shape).contiguous()
    return make_rays(org, d)
