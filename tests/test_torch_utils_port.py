"""PyTorch port, the utils (``utils/{config,trackball,debug}.py``) against
the JAX package.

- ``RenderConfig`` (a copy): the same files, and each package loads the
  other's; ``camera(device=)`` gives the JAX camera's bits as tensors.
- The trackball's quaternion math (a copy): bit-identical arrays on
  seeded drags; ``camera_from_quat(device=)`` the JAX camera's bits.
- ``validate_rays`` / ``assert_finite_image`` take tensors and raise as
  the JAX functions raise on the same arrays.
- ``trap_nans`` raises ``FloatingPointError`` on a NaN that an op makes
  inside its scope, and not outside it or on a NaN carried in.
"""

import inspect
import json
import math

import numpy as np
import pytest
import torch

from nanort_tpu.core.ray import make_rays as jmake_rays
from nanort_tpu.utils import config as jconfig
from nanort_tpu.utils import debug as jdebug
from nanort_tpu.utils import trackball as jtb
from nanort_tpu_torch import make_rays
from nanort_tpu_torch.utils import config, debug, trackball

torch.set_num_threads(1)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_render_config_matches_jax(tmp_path):
    cfg = config.RenderConfig(width=64, height=48, camera_type="spherical",
                              eye=(1, 2, 3), fov=70.0)
    jcfg = jconfig.RenderConfig(width=64, height=48, camera_type="spherical",
                                eye=(1, 2, 3), fov=70.0)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    cfg.save(a)
    jcfg.save(b)
    assert open(a).read() == open(b).read()
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"width": 32, "unknown_key": 7, "eye": [0, 1, 4],
                             "pass_depth": 0, "scene_scale": 2}))
    for path in (a, b, str(p)):
        got = config.RenderConfig.load(path)
        want = jconfig.RenderConfig.load(path)
        assert vars(got) == vars(want)
    assert config.RenderConfig.load(str(p)).height == 512


def test_render_config_camera_matches_jax():
    cfg = config.RenderConfig(width=16, height=12, eye=(0.3, 1, 4),
                              look_at=(0, 0.2, 0), fov=50.0)
    cam = cfg.camera(device="cpu")
    jcam = jconfig.RenderConfig(width=16, height=12, eye=(0.3, 1, 4),
                                look_at=(0, 0.2, 0), fov=50.0).camera()
    for k in ("eye", "u", "v", "w"):
        assert getattr(cam, k).device.type == "cpu"
        _bits(getattr(cam, k).numpy(), getattr(jcam, k))
    assert (cam.width, cam.height, cam.fov) == (jcam.width, jcam.height,
                                                jcam.fov)
    assert inspect.signature(cfg.camera).parameters["device"].default == "cuda"


def test_trackball_math_matches_jax():
    rng = np.random.default_rng(0)
    q = np.array([0.0, 0.0, 0.0, 1.0])
    jq = q.copy()
    for p in rng.uniform(-1, 1, (40, 4)):
        d = trackball.trackball(*p), jtb.trackball(*p)
        _bits(*d)
        q, jq = trackball.add_quats(d[0], q), jtb.add_quats(d[1], jq)
        _bits(q, jq)
        _bits(trackball.build_rotmatrix(q), jtb.build_rotmatrix(jq))
    for a, b in ((0.0, 0.0), (0.9, 0.9)):  # inside / outside the sphere
        _bits(trackball._project_to_sphere(0.8, a, b),
              jtb._project_to_sphere(0.8, a, b))
    _bits(trackball.trackball(0.1, 0.1, 0.1, 0.1), [0.0, 0.0, 0.0, 1.0])


@pytest.mark.parametrize("q", [[0, 0, 0, 1], [0.1, -0.4, 0.2, 0.88]])
def test_camera_from_quat_matches_jax(q):
    q = np.asarray(q) / np.linalg.norm(q)
    cam = trackball.camera_from_quat(q, [0.5, 0, -1], -5.0, 64, 32, 40.0,
                                     device="cpu")
    jcam = jtb.camera_from_quat(q, [0.5, 0, -1], -5.0, 64, 32, 40.0)
    for k in ("eye", "u", "v", "w"):
        assert getattr(cam, k).dtype == torch.float32
        _bits(getattr(cam, k).numpy(), getattr(jcam, k))
    assert (cam.width, cam.height, cam.fov) == (64, 32, 40.0)
    assert inspect.signature(trackball.camera_from_quat).parameters[
        "device"].default == "cuda"


def _ray_cases():
    one = np.ones((4, 3), np.float32)
    zero = np.zeros((4, 3), np.float32)
    nan = zero.copy()
    nan[2, 1] = np.nan
    inf = one.copy()
    inf[3, 0] = np.inf
    zdir = one.copy()
    zdir[1] = 0.0
    return {"good": (zero, one, None), "nan_org": (nan, one, None),
            "inf_dir": (zero, inf, None), "zero_dir": (zero, zdir, None),
            "window": (zero, one, np.array([0, 2, 0, 0], np.float32))}


@pytest.mark.parametrize("case", ["good", "nan_org", "inf_dir", "zero_dir",
                                  "window"])
@pytest.mark.parametrize("allow_zero", [True, False])
def test_validate_rays_on_tensors_matches_jax(case, allow_zero):
    org, d, min_t = _ray_cases()[case]
    max_t = None if min_t is None else np.ones(4, np.float32)
    rays = make_rays(torch.from_numpy(org), torch.from_numpy(d), min_t, max_t)
    jrays = jmake_rays(org, d, min_t, max_t)
    errs = []
    for fn, r in ((debug.validate_rays, rays), (jdebug.validate_rays, jrays)):
        try:
            fn(r, allow_zero_dir=allow_zero)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (case == "good" or (
        case == "zero_dir" and allow_zero))


def test_assert_finite_image_on_tensors():
    img = torch.ones(4, 5, 3)
    debug.assert_finite_image(img)
    img[1, 2, 0] = math.inf
    img[3, 3, 1] = math.nan
    with pytest.raises(AssertionError, match="2 non-finite") as e:
        debug.assert_finite_image(img, "frame")
    with pytest.raises(AssertionError) as je:
        jdebug.assert_finite_image(img.numpy(), "frame")
    assert str(e.value) == str(je.value)


def test_trap_nans_raises_inside_its_scope_only():
    x = torch.zeros(4)
    y = torch.log(x) * 0.0  # -inf * 0 = NaN, outside the scope: no raise
    assert torch.isnan(y).all()
    with debug.trap_nans():
        assert torch.equal(torch.exp(x), torch.ones(4))  # clean ops pass
        _ = y + 1.0  # a NaN carried in is not made here
        e = torch.empty(1 << 12)  # uninitialised memory is not a result
        del e
        with pytest.raises(FloatingPointError, match="mul"):
            _ = torch.log(x) * 0.0
        z = torch.ones(3)
        with pytest.raises(FloatingPointError):
            z.sub_(math.inf).mul_(0.0)  # made in place
    assert torch.isnan(torch.log(x) * 0.0).all()  # the scope has ended
