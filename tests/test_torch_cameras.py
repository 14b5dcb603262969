"""PyTorch port, the camera models (``models/cameras.py``) against the
JAX package's on the same cameras: every model of ``CAMERA_REGISTRY``,
``generate_rays``, ``pixel_grid(dtype=)`` and ``vr_omnistereo_rays``, at a
wide and a tall image.

The JAX functions run eagerly, op by op (no fusion, so no FMA). The port
computes sin and cos in float64 and rounds once; XLA's float32 sin/cos
differ from that in the last ulp on some inputs. Tolerances:
- ``perspective``, ``orthographic``, ``pixel_grid``: bit-identical rays;
- the trig models (``spherical``, ``spherical-panorama``,
  ``cylindrical``, ``fish-eye``, ``fish-eye MKX22``) and the VR
  panorama: origins bit-identical except the VR panorama's (a trig
  product), every component within 8 ulp or 2e-7 absolute of the JAX
  package's (near-zero components make ulps meaningless), and at least
  80% of rays bit-identical (measured on these cameras: 90.0% for the
  tall panorama, 90.8% tall spherical, 94.3% wide fisheye, 96.9% for the
  64 x 32 VR panorama, 100% for the others);
- out-of-range fisheye pixels: the same zero directions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanort_tpu.models import cameras as jcam
from nanort_tpu_torch.models import cameras
from nanort_tpu_torch.testing import ulp_distance

torch.set_num_threads(1)

SHAPES = {"wide": (24, 16, 70.0), "tall": (12, 20, 120.0)}
EXACT = ("perspective", "orthographic")


def _cams(shape):
    w, h, fov = SHAPES[shape]
    kw = dict(eye=(0.3, 0.2, 2.4), center=(0, 0.1, 0), width=w, height=h,
              fov=fov)
    return cameras.look_at(device="cpu", **kw), jcam.look_at(**kw)


def _check(got, want, exact, trig_org=False):
    same = np.ones(got.org.shape[:-1], bool)
    for k in ("org", "dir", "min_t", "max_t"):
        a = getattr(got, k).numpy()
        b = np.asarray(getattr(want, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        eq = a.view(np.uint32) == b.view(np.uint32)
        if exact or (k == "org" and not trig_org) or k in ("min_t", "max_t"):
            assert eq.all(), k
            continue
        close = (ulp_distance(a, b) <= 8) | (np.abs(a - b) <= 2e-7)
        assert close.all(), (k, np.abs(a - b).max())
        same &= eq.reshape(a.shape[:-1] + (-1,)).all(-1)
    return float(same.mean())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(jcam.CAMERA_REGISTRY))
def test_camera_model_matches_jax(name, shape):
    assert list(cameras.CAMERA_REGISTRY) == list(jcam.CAMERA_REGISTRY)
    cam, jc = _cams(shape)
    got = cameras.generate_rays(cam, name)
    want = jcam.generate_rays(jc, name)
    frac = _check(got, want, name in EXACT)
    assert frac >= 0.8, frac
    if name.startswith("fish-eye"):
        zero = (got.dir == 0).all(-1).numpy()
        np.testing.assert_array_equal(
            zero, (np.asarray(want.dir) == 0).all(-1))
    assert got.org.is_contiguous() and got.dir.is_contiguous()


def test_generate_rays_falls_back_and_forwards():
    cam, jc = _cams("wide")
    a = cameras.generate_rays(cam, "no-such-camera")
    b = cameras.pinhole_rays(cam)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = cameras.generate_rays(cam, "orthographic", distance=3.0)
    want = jcam.generate_rays(jc, "orthographic", distance=3.0)
    _check(c, want, True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pixel_grid_dtype(dtype):
    cam, jc = _cams("tall")
    for a, b in zip(cameras.pixel_grid(cam, getattr(torch, dtype)),
                    jcam.pixel_grid(jc, jnp.dtype(dtype))):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("size", [(64, 32), (30, 18)])
def test_vr_omnistereo_matches_jax(size):
    got = cameras.vr_omnistereo_rays(*size, device="cpu")
    want = jcam.vr_omnistereo_rays(*size)
    frac = _check(got, want, False, trig_org=True)
    assert frac >= 0.8, frac
    np.testing.assert_allclose(np.linalg.norm(got.org.numpy(), axis=-1),
                               0.0635 / 2, rtol=1e-5)


def test_camera_entry_points_default_to_the_card():
    import inspect

    for fn in (cameras.look_at, cameras.vr_omnistereo_rays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
