"""PyTorch port, the perspective camera's kernel: the CUDA source
(nanort_tpu_torch/csrc/camera.cu) compiled with g++ against a small mock
of the CUDA API (``testing.build_with_cuda_mock``), its kernel function
run for every block and thread of its grid (blocks and threads in a
shuffled order), and held to the plain version (models/cameras.py::
_pinhole_plain) bit for bit: a square image, 3840 x 2160, widths that
are not a multiple of 4 (quads that run past a row's end), 1 x 1, fovs
of 20 to 120 degrees, an eye 740 m from the origin, directions under
and across normalize's 1e-17 guard; outputs 16-byte aligned (whole
warps' coalesced stores, the last warp's quads lane by lane, the last
n % 4 pixels one at a time) and outputs that are not (one pixel at a
time). g++ builds with -ffp-contract=off and no -ffast-math, as nvcc
builds with --fmad=false.

Also the route: CPU cameras, float32 and float64 alike, and an explicit
pixel grid take the plain version and launch nothing; ``look_at``'s
basis, made in one copy, is the four tensors it made before bit for bit,
and its cross product is ``np.cross``'s.
The launch itself needs the card and is held there by test_torch_gpu.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from nanort_tpu_torch.models import cameras
from nanort_tpu_torch.testing import build_with_cuda_mock
from nanort_tpu_torch.utils import trace

# appended to the kernel source: every block of the launch's grid, in a
# shuffled order, and in each every thread, in a shuffled order, as
# ``nrt_pinhole`` would start them; returns the alignment gate's choice
HARNESS = r"""
#include <vector>
uint3 threadIdx, blockIdx;
extern "C" int emulate_pinhole(
    const float* eye, const float* u, const float* v, const float* w,
    float* org, float* dir, float* min_t, float* max_t, long long width,
    long long height, float flen, float fwidth, float fheight,
    unsigned seed) {
  const Params p{eye,   u,      v,    w,      org,    dir,    min_t,
                 max_t, width, height, flen, fwidth, fheight};
  const int vec = quads_aligned(p);
  auto draw = [&](long long k) {
    seed = seed * 1664525u + 1013904223u;
    return (long long)((seed >> 8) % (unsigned)k);
  };
  std::vector<long long> blocks(grid_blocks(width * height));
  for (long long b = 0; b < (long long)blocks.size(); ++b) blocks[b] = b;
  for (long long k = (long long)blocks.size() - 1; k > 0; --k) {
    std::swap(blocks[k], blocks[draw(k + 1)]);
  }
  std::vector<int> lanes(kBlock);
  for (int k = 0; k < kBlock; ++k) lanes[k] = k;
  for (long long b : blocks) {
    for (int k = kBlock - 1; k > 0; --k) {
      std::swap(lanes[k], lanes[draw(k + 1)]);
    }
    blockIdx.x = (unsigned)b;
    for (int l : lanes) {
      threadIdx.x = (unsigned)l;
      pinhole_kernel(p, vec);
    }
  }
  return vec;
}
"""

_P, _L, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("camera.cu", HARNESS,
                               tmp_path_factory.mktemp("camera"))
    lib.emulate_pinhole.restype = ctypes.c_int
    lib.emulate_pinhole.argtypes = [_P] * 8 + [_L, _L, _F, _F, _F,
                                               ctypes.c_uint]
    return lib


def _out(shape, shift: bool) -> torch.Tensor:
    """A NaN-filled float32 output of ``shape``, 16-byte aligned, or one
    element past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.full((n + 4,), float("nan"))
    k = (-buf.data_ptr() // 4) % 4 + shift
    return buf[k:k + n].view(shape)


def _emulate(lib, cam, shift=False, seed=1):
    """The kernel's ``Rays`` from the mock build, and whether the gate
    chose the quads."""
    H, W = cam.height, cam.width
    org, d = _out((H, W, 3), shift), _out((H, W, 3), shift)
    min_t, max_t = _out((H, W), shift), _out((H, W), shift)
    basis = [x.contiguous() for x in (cam.eye, cam.u, cam.v, cam.w)]
    vec = lib.emulate_pinhole(
        *(x.data_ptr() for x in basis + [org, d, min_t, max_t]), W, H,
        cameras._flen(cam), float(W), float(H), seed)
    return cameras.Rays(org, d, min_t, max_t), vec


def _same_bits(got, want):
    for k in ("org", "dir", "min_t", "max_t"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, k
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k


def _cam(eye, center, width, height, fov, up=(0.0, 1.0, 0.0)):
    return cameras.look_at(eye, center, up, width=width, height=height,
                           fov=fov, device="cpu")


# (eye, center, up, fov): an eye 740 m off, 250 m up, as the LiDAR
# viewer's orbit; a camera looking straight down a tilted up vector
POSES = {
    "fov20": ((0.3, 0.2, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0),
    "fov45": ((2.2, -1.3, 3.1), (0.1, 0.2, -0.3), (0.0, 1.0, 0.0), 45.0),
    "fov90": ((-0.7, 0.4, -2.5), (0.0, 0.0, 0.0), (0.1, 1.0, 0.0), 90.0),
    "fov120": ((0.0, 0.0, 2.6), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 120.0),
    "lidar_740m": ((500.0, 262.0, 547.0), (0.0, 12.0, 0.0),
                   (0.0, 1.0, 0.0), 45.0),
    "down": ((0.0, 30.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 60.0),
}
SHAPES = {"square": (64, 64), "wide_odd": (37, 23), "ragged_rows": (6, 5),
          "one": (1, 1), "tall_odd": (13, 40)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pose", list(POSES))
def test_kernel_equals_plain(lib, pose, shape):
    eye, center, up, fov = POSES[pose]
    w, h = SHAPES[shape]
    cam = _cam(eye, center, w, h, fov, up)
    got, vec = _emulate(lib, cam, seed=len(pose) + w)
    assert vec == 1
    _same_bits(got, cameras._pinhole_plain(cam))


@pytest.mark.parametrize("pose", ["fov45", "lidar_740m"])
def test_kernel_equals_plain_at_4k(lib, pose):
    """The LiDAR viewer's 3840 x 2160 frame, every pixel."""
    eye, center, up, fov = POSES[pose]
    cam = _cam(eye, center, 3840, 2160, fov, up)
    got, vec = _emulate(lib, cam, seed=7)
    assert vec == 1
    _same_bits(got, cameras._pinhole_plain(cam))


@pytest.mark.parametrize("shape", ["square", "wide_odd", "one"])
def test_unaligned_outputs_take_pixels(lib, shape):
    """Outputs one element off a 16-byte boundary: the gate takes one
    pixel at a time, with the same bits."""
    w, h = SHAPES[shape]
    cam = _cam((1.1, 0.6, -3.0), (0.0, 0.1, 0.0), w, h, 70.0)
    got, vec = _emulate(lib, cam, shift=True, seed=3)
    assert vec == 0
    _same_bits(got, cameras._pinhole_plain(cam))


def test_degenerate_basis_keeps_the_guard(lib):
    """A basis whose directions fall under normalize's 1e-17 guard leaves
    them unchanged in both versions, and one whose directions' lengths
    straddle the guard takes it pixel by pixel; zero and tiny components
    keep their signs."""
    z = torch.zeros(3)
    tiny = torch.tensor([1e-30, -1e-30, 0.0])
    eye = torch.tensor([1.0, -2.0, 3.0])
    for u, v, w in ((z, z, z), (tiny, -tiny, z), (z, tiny, tiny)):
        cam = cameras.Camera(eye, u, v, w, 9, 7, 45.0)
        got, _ = _emulate(lib, cam, seed=5)
        _same_bits(got, cameras._pinhole_plain(cam))
    for scale, straddles in ((1.1e-19, False), (1.1e-18, True)):
        u, v, w = (torch.eye(3)[k] * scale for k in range(3))
        cam = cameras.Camera(eye, u, v, w, 9, 7, 45.0)
        want = cameras._pinhole_plain(cam)
        unit = torch.linalg.vector_norm(want.dir.double(), dim=-1) > 0.5
        assert bool(unit.any()) == straddles and not bool(unit.all())
        got, _ = _emulate(lib, cam, seed=6)
        _same_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_takes_the_plain_version(dtype):
    cam = cameras.look_at((0.3, 0.2, 2.4), (0, 0.1, 0), width=24, height=16,
                          fov=70.0, dtype=dtype, device="cpu")
    assert not cameras._fused_takes(cam)
    before = trace.counts()
    got = cameras.pinhole_rays(cam)
    assert trace.since(before) == {}
    want = cameras._pinhole_plain(cam)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
        assert a.is_contiguous()


def test_explicit_grid_takes_the_plain_version():
    cam = _cam((0.3, 0.2, 2.4), (0, 0.1, 0), 24, 16, 70.0)
    x, y = cameras.pixel_grid(cam)
    xy = (x + 0.25, y - 0.25)
    before = trace.counts()
    got = cameras.pinhole_rays(cam, xy)
    assert trace.since(before) == {}
    for a, b in zip(got, cameras._pinhole_plain(cam, xy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pose", list(POSES))
def test_look_at_rows_equal_the_four_tensors(pose, dtype):
    """``look_at``'s one (4, 3) copy holds what its four copies held:
    ``torch.as_tensor`` of the float64 eye, u, v and w, rounded to
    ``dtype``."""
    eye, center, up, fov = POSES[pose]
    cam = cameras.look_at(eye, center, up, width=5, height=3, fov=fov,
                          dtype=dtype, device="cpu")
    e = np.asarray(eye, np.float64)
    w = e - np.asarray(center, np.float64)
    w = w / np.linalg.norm(w)
    u = np.cross(np.asarray(up, np.float64), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    for got, want in zip((cam.eye, cam.u, cam.v, cam.w), (e, u, v, w)):
        want = torch.as_tensor(want, dtype=dtype)
        assert got.dtype == dtype and got.shape == (3,)
        assert got.is_contiguous() and torch.equal(got, want)
    assert (cam.width, cam.height, cam.fov) == (5, 3, fov)
    assert isinstance(cam.width, int) and isinstance(cam.fov, float)


def test_cross_is_numpys():
    """``look_at``'s cross product gives ``np.cross``'s float64 bits, on
    random vectors of many magnitudes and on axis-aligned ones."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(500, 3)) * 10.0 ** rng.integers(-8, 8, (500, 1))
    b = rng.normal(size=(500, 3)) * 10.0 ** rng.integers(-8, 8, (500, 1))
    a[:6], b[:6] = np.eye(3).repeat(2, 0), -np.eye(3)[[1, 2, 0, 2, 0, 1]]
    for x, y in zip(a, b):
        got, want = cameras._cross(x, y), np.cross(x, y)
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
