"""The 7 pluggable camera models of the reference GUI renderer on torch
tensors (port of ``nanort_tpu.models.cameras``; examples/gui/camera.
{h,cc}, registry at camera.h:174-208): Pinhole ("perspective"),
Orthographic, Spherical, SphericalPanorama, Cylindrical, FishEye
(linear), FishEyeMKX22 (the iZugar MKX22 220-degree polynomial model),
and the VR omni-stereo panorama. Each model maps pixel coordinates to a
ray batch on the camera's device in one pass of tensor ops.

Conventions (matching the reference): ``u`` = right, ``v`` = up, ``w`` =
*backward* (the camera looks along ``-w``); ``eye = look_at + w *
distance`` (camera.cc:23-37); pixel coords xy in [0, W) x [0, H) with y
up, pixel centres at +0.5; ``fov`` is the vertical field of view in
degrees.

Precision against the JAX package: the arithmetic is its op for op
(every product its own op, Python constants rounded to float32 as XLA
rounds them, ``rn**k`` as XLA's repeated squaring). Sines and cosines
are taken in float64 and rounded once (correctly rounded in nearly every
case), where XLA's float32 ``sin``/``cos`` differ from that in the last
ulp on a few inputs; so the trig models (spherical, panorama,
cylindrical, both fisheyes, VR) agree with the JAX package to a few ulp
of their directions, and the others bit for bit
(tests/test_torch_cameras.py states the bounds).

The perspective camera's default pixel grid on a float32 camera on a
CUDA device takes one launch of ``csrc/camera.cu`` (counted as
``pinhole_fused``), which gives ``_pinhole_plain``'s bits.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.math import normalize, sqrt
from ..core.ray import Rays, make_rays
from ..traverse import _ext
from ..utils import trace

trace.declare_launches("pinhole_fused")


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


@trace.span("camera")
def look_at(eye, center, up=(0.0, 1.0, 0.0), width=512, height=512,
            fov=45.0, dtype=torch.float32, device="cuda") -> Camera:
    """Camera basis from eye/center/up, computed in float64 on the host,
    rounded to ``dtype`` there and handed to ``device`` (the card unless
    the caller asks for another device) in one copy that the host does
    not wait for: ``eye``, ``u``, ``v`` and ``w`` are the rows of one
    (4, 3) tensor."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    w = eye - center
    w = w / np.linalg.norm(w)
    u = _cross(up, w)
    u = u / np.linalg.norm(u)
    v = _cross(w, u)
    basis = torch.from_numpy(np.stack([eye, u, v, w])).to(dtype).to(
        device, non_blocking=True)
    return Camera(eye=basis[0], u=basis[1], v=basis[2], w=basis[3],
                  width=int(width), height=int(height), fov=float(fov))


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.cross`` of two float64 3-vectors, the same values (each
    component p - q of two products rounded on their own) in a tenth of
    its time."""
    a0, a1, a2 = a.tolist()
    b0, b1, b2 = b.tolist()
    return np.array([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])


def pixel_grid(cam: Camera, dtype=torch.float32):
    """(H, W) pixel-centre coordinates, y-up (row 0 = top of image), on
    the camera's device."""
    dev = cam.eye.device
    x = torch.arange(cam.width, dtype=dtype, device=dev) + 0.5
    y = (cam.height - 1 - torch.arange(cam.height, dtype=dtype,
                                       device=dev)) + 0.5
    return torch.meshgrid(x, y, indexing="xy")


def _flen(cam: Camera) -> float:
    """Distance at which one pixel is one unit (camera.cc:95)."""
    return 0.5 * cam.height / math.tan(0.5 * math.radians(cam.fov))


@trace.span("camera")
def pinhole_rays(cam: Camera, xy=None) -> Rays:
    """Standard perspective camera (camera.cc:89-126): an (H, W) batch
    on the camera's device, all rays sharing the eye as origin. A float32
    camera on a CUDA device with the default pixel grid (``xy`` None)
    takes one launch of ``csrc/camera.cu`` (counted as
    ``pinhole_fused``); every other camera, the CPU's, float64 and an
    explicit ``xy`` among them, takes ``_pinhole_plain``. Both give the
    same bits."""
    if xy is None and _fused_takes(cam):
        return _pinhole_fused(cam)
    return _pinhole_plain(cam, xy)


def _fused_takes(cam: Camera) -> bool:
    """Whether ``_pinhole_fused`` takes this camera."""
    dev = cam.eye.device
    return (dev.type == "cuda"
            and all(x.dtype == torch.float32 and x.device == dev
                    and tuple(x.shape) == (3,)
                    for x in (cam.eye, cam.u, cam.v, cam.w))
            and 0 < cam.width < 2**24 and 0 < cam.height < 2**24)


def _pinhole_fused(cam: Camera) -> Rays:
    """``_pinhole_plain``'s batch from one launch of ``csrc/camera.cu``."""
    dev = cam.eye.device
    H, W = cam.height, cam.width
    f32 = dict(dtype=torch.float32, device=dev)
    org, d = (torch.empty((H, W, 3), **f32) for _ in range(2))
    min_t, max_t = (torch.empty((H, W), **f32) for _ in range(2))
    basis = [x.contiguous() for x in (cam.eye, cam.u, cam.v, cam.w)]
    _ext.launch("camera", "nrt_pinhole", *basis, org, d, min_t, max_t, W, H,
                _flen(cam), float(W), float(H), device=dev,
                count="pinhole_fused")
    return Rays(org, d, min_t, max_t)


def _pinhole_plain(cam: Camera, xy=None) -> Rays:
    """The perspective camera in plain torch, the kernel's reference."""
    x, y = pixel_grid(cam) if xy is None else xy
    flen = _flen(cam)
    corner = -cam.w * flen - 0.5 * (cam.width * cam.u + cam.height * cam.v)
    d = corner + x[..., None] * cam.u + y[..., None] * cam.v
    d = normalize(d)
    org = cam.eye.expand(d.shape).contiguous()
    return make_rays(org, d)


def _sin(x: torch.Tensor) -> torch.Tensor:
    """sin of a float32 tensor, taken in float64 and rounded once."""
    return torch.sin(x.double()).to(x.dtype)


def _cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).to(x.dtype)


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an int ``n`` > 0 as XLA computes it (binary
    exponentiation, every product rounded)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _eye_rays(cam: Camera, d: torch.Tensor) -> Rays:
    return make_rays(cam.eye.expand(d.shape).contiguous(), d)


def orthographic_rays(cam: Camera, distance: float = 1.0, xy=None) -> Rays:
    """Parallel rays; pixel footprint from fov at ``distance``
    (camera.cc:128-162)."""
    x, y = pixel_grid(cam) if xy is None else xy
    px = 2.0 * distance * math.tan(0.5 * math.radians(cam.fov)) / cam.height
    corner = cam.eye - 0.5 * px * (cam.width * cam.u + cam.height * cam.v)
    org = corner + px * x[..., None] * cam.u + px * y[..., None] * cam.v
    # "+ 0.0" scrubs -0.0 components: copysign-based safe_inverse treats
    # -0.0 as negative while the dir<0 slab selector does not, which would
    # mispair the slab planes for exactly-axis-aligned parallel rays
    d = (-cam.w + 0.0).expand(org.shape).contiguous()
    return make_rays(org, d)


def _cam_dir_to_world(cam: Camera, d_cam: torch.Tensor) -> torch.Tensor:
    """Rotate a camera-space direction (x right, y up, -z forward) to world."""
    return (d_cam[..., 0:1] * cam.u + d_cam[..., 1:2] * cam.v
            + d_cam[..., 2:3] * cam.w)


def spherical_rays(cam: Camera, xy=None) -> Rays:
    """Equal-angle mapping; horizontal lines stay straight
    (camera.cc:202-241)."""
    x, y = pixel_grid(cam) if xy is None else xy
    vfov = math.radians(cam.fov)
    d_ang = vfov / cam.height
    hfov = vfov * cam.width / cam.height
    a0 = hfov / 2.0 - x * d_ang
    a1 = -vfov / 2.0 + y * d_ang
    d_cam = torch.stack([-_sin(a0), _cos(a0) * _sin(a1),
                         -_cos(a0) * _cos(a1)], dim=-1)
    return _eye_rays(cam, _cam_dir_to_world(cam, d_cam))


def spherical_panorama_rays(cam: Camera, xy=None) -> Rays:
    """Equal-angle mapping; vertical lines stay straight — the photo-stitch
    panorama projection (camera.cc:164-200)."""
    x, y = pixel_grid(cam) if xy is None else xy
    vfov = math.radians(cam.fov)
    d_ang = vfov / cam.height
    hfov = vfov * cam.width / cam.height
    a0 = hfov / 2.0 - x * d_ang
    a1 = -vfov / 2.0 + y * d_ang
    d_cam = torch.stack([-_cos(a1) * _sin(a0), _sin(a1),
                         -_cos(a0) * _cos(a1)], dim=-1)
    return _eye_rays(cam, _cam_dir_to_world(cam, d_cam))


def cylindrical_rays(cam: Camera, xy=None) -> Rays:
    """Spherical horizontally, pinhole vertically (camera.cc:243-287)."""
    x, y = pixel_grid(cam) if xy is None else xy
    vfov = math.radians(cam.fov)
    hfov = vfov * cam.width / cam.height
    d_ang = hfov / cam.width
    angle = hfov / 2.0 - x * d_ang
    px = 2.0 * math.tan(vfov / 2.0) / cam.height
    corner1 = math.tan(vfov / 2.0)
    d_cam = torch.stack([-_sin(angle), px * y - corner1, -_cos(angle)],
                        dim=-1)
    return _eye_rays(cam, normalize(_cam_dir_to_world(cam, d_cam)))


def _fisheye_common(cam: Camera, xy, angle_of_rnorm):
    x, y = pixel_grid(cam) if xy is None else xy
    cx, cy = cam.width / 2.0, cam.height / 2.0
    dx = cx - x
    dy = cy - y
    r = sqrt(dx * dx + dy * dy)
    r_factor = 1.0 / (cx if cam.height < cam.width else cy)
    r_norm = r * r_factor
    angle, in_range = angle_of_rnorm(r_norm)
    r_safe = torch.where(r > 0, r, 1.0)
    nx, ny = dx / r_safe, dy / r_safe
    s = _sin(angle)
    d_cam = torch.stack([-s * nx, -s * ny, -_cos(angle)], dim=-1)
    # out-of-range pixels get a zero direction, like the reference
    # (camera.cc:320-327) — safe_inverse turns it into an instant miss
    d_cam = torch.where(in_range[..., None], d_cam, 0.0)
    return _eye_rays(cam, _cam_dir_to_world(cam, d_cam))


def fisheye_rays(cam: Camera, xy=None) -> Rays:
    """Linear fisheye: angle proportional to radius (camera.cc:289-330)."""
    fov = math.radians(cam.fov)

    def angle_fn(rn):
        angle = rn * fov / 2.0
        return angle, angle <= math.pi / 2.0

    return _fisheye_common(cam, xy, angle_fn)


def fisheye_mkx22_rays(cam: Camera, xy=None) -> Rays:
    """iZugar MKX22 220-degree lens: quartic radius->angle polynomial
    (camera.cc:331-375; coefficients from Bourke's fisheyerectify note)."""

    def angle_fn(rn):
        angle = (1.3202 * rn + 1.4539 * _ipow(rn, 2) - 2.9949 * _ipow(rn, 3)
                 + 2.1007 * _ipow(rn, 4))
        return angle, rn <= 1.0

    return _fisheye_common(cam, xy, angle_fn)


# Registry keyed by the reference's type names (camera.h:47-208).
CAMERA_REGISTRY: dict[str, Callable] = {
    "perspective": pinhole_rays,
    "orthographic": orthographic_rays,
    "spherical": spherical_rays,
    "spherical-panorama": spherical_panorama_rays,
    "cylindrical": cylindrical_rays,
    "fish-eye": fisheye_rays,
    "fish-eye MKX22": fisheye_mkx22_rays,
}


def generate_rays(cam: Camera, camera_type: str = "perspective", **kw) -> Rays:
    """Name-based dispatch like the reference's setCameraFromStr
    (camera.cc:39-61); unknown names fall back to perspective."""
    fn = CAMERA_REGISTRY.get(camera_type, pinhole_rays)
    return fn(cam, **kw)


def vr_omnistereo_rays(width: int, height: int, ipd: float = 0.0635,
                       dtype=torch.float32, device="cuda") -> Rays:
    """Omnidirectional stereo panorama (reference examples/vrcamera/
    main.cc:552-585) on ``device`` (the card unless the caller asks for
    another device): top half = left eye, bottom half = right eye; eyes
    offset on a circle of diameter ``ipd`` (inter-pupillary distance,
    meters); equirectangular direction mapping."""
    x = torch.arange(width, dtype=dtype, device=device)
    y = torch.arange(height, dtype=dtype, device=device)
    gx, gy = torch.meshgrid(x, y, indexing="xy")
    is_left = gy < (height / 2)
    # true divisions: torch turns a division by a Python number into a
    # product with its reciprocal
    screen_y = 2.0 * (gy / torch.full_like(gy, height)) - 1.0
    theta = 2.0 * math.pi * (gx / torch.full_like(gx, width))
    theta_off = theta + torch.where(is_left, 0.0, math.pi).to(dtype)
    phi = (torch.remainder(2.0 * (0.5 * screen_y + 0.5), 1.0) - 0.5) \
        * math.pi
    org = torch.stack([0.5 * ipd * (-_cos(theta_off)),
                       torch.zeros_like(theta),
                       0.5 * ipd * _sin(theta_off)], -1)
    d = torch.stack([_cos(phi) * -_sin(theta), _sin(phi),
                     _cos(phi) * -_cos(theta)], -1)
    d = normalize(d)
    return make_rays(org.to(dtype), d.to(dtype))
