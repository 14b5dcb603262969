"""The pinhole camera of upstream ``examples/gui/camera.cc:89-126``, as
the benchmark makes camera rays and as the reference checks them.

Conventions: ``w`` points backward (the camera looks along -w), pixel
centres at +0.5, y up (row 0 is the top of the image), ``fov`` the
vertical field of view in degrees. ``basis`` works in float64;
``rays`` gives the camera's rays as float32 tensors (the cells' inputs)
or in float64 (the reference of a program that makes its own).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def basis(eye, center, up=(0.0, 1.0, 0.0)):
    eye = np.asarray(eye, np.float64)
    w = eye - np.asarray(center, np.float64)
    w = w / np.linalg.norm(w)
    u = np.cross(np.asarray(up, np.float64), w)
    u = u / np.linalg.norm(u)
    return eye, u, np.cross(w, u), w


def rays(eye, center, width: int, height: int, fov: float, device,
         dtype=torch.float32, pixels=None):
    """(org, dir), each (height, width, 3), or (n, 3) for the row-major
    pixel indices ``pixels`` (n,); directions of unit length."""
    e, u, v, w = (torch.as_tensor(x, dtype=dtype, device=device)
                  for x in basis(eye, center))
    if pixels is None:
        x = torch.arange(width, dtype=dtype, device=device) + 0.5
        y = (height - 1 - torch.arange(height, dtype=dtype,
                                       device=device)) + 0.5
        x, y = torch.meshgrid(x, y, indexing="xy")
    else:
        pixels = torch.as_tensor(pixels, device=device).long()
        x = (pixels % width).to(dtype) + 0.5
        y = (height - 1 - pixels // width).to(dtype) + 0.5
    flen = 0.5 * height / math.tan(0.5 * math.radians(fov))
    corner = -w * flen - 0.5 * (width * u + height * v)
    d = corner + x[..., None] * u + y[..., None] * v
    d = d / d.norm(dim=-1, keepdim=True)
    return e.expand(d.shape).contiguous(), d.contiguous()
