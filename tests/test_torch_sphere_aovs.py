"""PyTorch port, the LAS viewer's sphere AOVs: the CUDA kernel's source
(nanort_tpu_torch/csrc/sphere_aovs.cu) compiled with g++ against a small
mock of the CUDA API (``testing.build_with_cuda_mock``), its kernel
function run for every block and thread of its grid (blocks and threads
in a shuffled order), and held to the plain version
(models/pointcloud.py::_sphere_aovs_plain): image and flat batches, a
ragged last quad, hits and misses (a miss keeps its record's u and v),
hits on 0.33-m spheres 740 m away (a LiDAR tile's distances), rays that
graze overlapping spheres, normals at the poles (n.y = +-1, and lengths
that underflow to the 1e-30 guard, where the clamp of n.y applies),
16-byte aligned streams (quads) and streams that are not (one pixel at a
time), the records of a K1 frame, and prim ids past the centres (a trap).

rgb, normal, position, depth and hit are held bit for bit; texcoord
within 1e-6, the sphere tests' tolerance for u and v: the host's atan2f
and acosf are not the card's, nor torch's CPU ones, and on the CPU the
plain version divides by pi where the card multiplies by its reciprocal
(test_torch_gpu.py holds texcoord bit for bit on the card). g++ builds
with -ffp-contract=off and no -ffast-math, as nvcc builds with
--fmad=false.

Also the route: CPU tensors, float32 and float64 alike, take the plain
version and launch nothing; ``_fused_refusal`` accepts what the kernel
reads and names anything else (card input it names raises). The launch
itself needs the card and is held there by test_torch_gpu.py.
"""

import ctypes

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.models import pointcloud
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.ops import sphere
from nanort_tpu_torch.testing import (SPHERE_DIST, build_with_cuda_mock,
                                      sphere_aov_case)
from nanort_tpu_torch.utils import trace

# appended to the kernel source: every block of the launch's grid, in a
# shuffled order, and in each every thread, in a shuffled order, as
# ``nrt_sphere_aovs`` would start them; returns the alignment gate's
# choice, or -1 where a thread trapped
HARNESS = r"""
#include <vector>
uint3 threadIdx, blockIdx;
extern "C" int emulate_sphere_aovs(
    const float* t, const float* u, const float* v, const long long* prim,
    const float* org, const float* dir, const float* centers, float* rgb,
    float* nrm, float* pos, float* depth, float* uv, unsigned char* hit,
    long long n, long long spheres, unsigned seed) {
  const Params p{t,   u,   v,   prim,  org, dir, centers, rgb,
                 nrm, pos, depth, uv, hit, n,   spheres};
  const int vec = quads_aligned(p);
  auto draw = [&](long long k) {
    seed = seed * 1664525u + 1013904223u;
    return (long long)((seed >> 8) % (unsigned)k);
  };
  std::vector<long long> blocks(grid_blocks(n));
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
      try {
        sphere_aovs_kernel(p, vec);
      } catch (const cuda_mock_trap&) {
        return -1;
      }
    }
  }
  return vec;
}
"""

_P, _L = ctypes.c_void_p, ctypes.c_int64
KEYS = ("rgb", "normal", "position", "depth", "texcoord", "prim_id", "hit")
UV_ATOL = 1e-6


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("sphere_aovs.cu", HARNESS,
                               tmp_path_factory.mktemp("sphere_aovs"))
    lib.emulate_sphere_aovs.restype = ctypes.c_int
    lib.emulate_sphere_aovs.argtypes = [_P] * 13 + [_L, _L, ctypes.c_uint]
    return lib


def _shifted(x: torch.Tensor, shift: bool) -> torch.Tensor:
    """``x``, or a copy of it one element past a 16-byte boundary."""
    if not shift:
        return x.contiguous()
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _emulate(lib, spheres, rays, hits, shift=False, seed=1):
    """The kernel's AOVs (the ``_sphere_aovs_fused`` dict) from the mock
    build, and whether the gate chose the quads (-1: the launch
    trapped)."""
    bs = rays.batch_shape
    rgb, nrm, pos = (torch.zeros(bs + (3,)) for _ in range(3))
    depth, uv = torch.zeros(bs), torch.zeros(bs + (2,))
    hit = torch.zeros(bs, dtype=torch.bool)
    outs = [_shifted(x, shift) for x in (rgb, nrm, pos, depth, uv, hit)]
    ins = [_shifted(x, shift) for x in (*hits, rays.org, rays.dir)]
    centers = spheres.centers.contiguous()
    vec = lib.emulate_sphere_aovs(
        *(x.data_ptr() for x in ins), centers.data_ptr(),
        *(x.data_ptr() for x in outs), hits.t.numel(), centers.shape[0],
        seed)
    got = dict(zip(("rgb", "normal", "position", "depth", "texcoord"),
                   outs[:5]))
    got.update(prim_id=hits.prim_id, hit=outs[5])
    return got, vec


def _same(got: dict, want: dict):
    """Every AOV bit for bit but texcoord, which is held within
    ``UV_ATOL`` (the host's atan2f and acosf)."""
    for k in KEYS:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "texcoord":
            assert float((a - b).abs().max()) <= UV_ATOL, k
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("bs", [(24, 40), (2051,)], ids=["image", "flat"])
def test_kernel_equals_plain(lib, bs):
    s, rays, hits = sphere_aov_case(bs, len(bs))
    want, _ = pointcloud._sphere_aovs_plain(s, rays, hits)
    got, vec = _emulate(lib, s, rays, hits, seed=11)
    assert vec == 1
    _same(got, want)
    hit = want["hit"]
    assert 0.3 < float(hit.float().mean()) < 0.95
    # a miss keeps its record's u and v, bit for bit
    assert torch.equal(got["texcoord"][~hit],
                       torch.stack([hits.u, hits.v], -1)[~hit])
    assert float(want["depth"][hit].min()) < 1e-30  # the pole pixels
    assert float(want["depth"][hit].max()) > SPHERE_DIST - 3.0


def test_poles_take_the_clamps(lib):
    """n = (0, y, 0): n.y is +-1 where y's square is normal, and where it
    underflows the length falls to the 1e-30 guard and the clamp of n.y
    to [-1, 1] decides v; n = 0 and n = (-0, 0, -0) give the seam's u."""
    s, rays, hits = sphere_aov_case((64,), 5)
    want, _ = pointcloud._sphere_aovs_plain(s, rays, hits)
    got, _ = _emulate(lib, s, rays, hits, seed=2)
    _same(got, want)
    pole = hits.prim_id == s.centers.shape[0] - 1
    ny = want["normal"][pole][:, 1]
    assert bool((ny.abs() > 1.0).any())  # the clamp of n.y applies
    assert bool((ny == 1.0).any()) and bool((ny == -1.0).any())
    v = want["texcoord"][pole][:, 1]
    assert bool((v == 0.0).any()) and bool((v == 1.0).any())


@pytest.mark.parametrize("n", [1021, 11])
def test_unaligned_streams_take_pixels(lib, n):
    """Streams one element off a 16-byte boundary: the gate takes one
    pixel at a time, with the same bits; n = 11 is two quads and a
    ragged tail."""
    s, rays, hits = sphere_aov_case((n,), 7)
    want, _ = pointcloud._sphere_aovs_plain(s, rays, hits)
    got, vec = _emulate(lib, s, rays, hits, shift=True, seed=3)
    assert vec == 0
    _same(got, want)


@pytest.mark.parametrize("bad", ["prim_past_centers", "prim_negative"])
def test_ids_out_of_range_fail_the_launch(lib, bad):
    """A hit whose prim id names no centre traps; the plain version's
    gather raises on the id past the centres, and wraps the negative
    one, as torch's indexing does."""
    s, rays, hits = sphere_aov_case((64,), 9)
    _, vec = _emulate(lib, s, rays, hits)
    assert vec == 1  # the miss ids and every valid id pass
    prim = hits.prim_id.clone()
    i = int(torch.nonzero(prim != nt.INVALID_PRIM_ID)[0])
    prim[i] = s.centers.shape[0] if bad == "prim_past_centers" else -1
    hits = hits._replace(prim_id=prim)
    _, vec = _emulate(lib, s, rays, hits)
    assert vec == -1
    if bad == "prim_past_centers":
        with pytest.raises(IndexError):
            pointcloud._sphere_aovs_plain(s, rays, hits)


def _cloud_frame():
    """A 32 x 48 frame of 600 overlapping spheres through K1's plain
    version: ``(spheres, scene8, rays)``."""
    rng = np.random.default_rng(4)
    c = rng.uniform(-1.0, 1.0, (600, 3)).astype(np.float32)
    s = sphere.Spheres(torch.from_numpy(c), torch.full((600,), 0.12))
    bvh, _ = sphere.build_sphere_bvh(s, nt.BVHBuildOptions(
        min_leaf_primitives=4, max_leaf_primitives=4))
    s8 = collapse_bvh8(bvh, width=8, spheres=s)
    rays = pinhole_rays(look_at((0.3, 0.4, 3.2), (0, 0, 0), width=48,
                                height=32, fov=50.0, device="cpu"))
    return s, s8, rays


def test_traced_records(lib):
    """The records of a K1 frame: the kernel's AOVs are
    render_sphere_aovs's on the CPU, and the records' UV its texcoord."""
    s, s8, rays = _cloud_frame()
    want, hits = pointcloud.render_sphere_aovs(s, rays, scene8=s8)
    got, vec = _emulate(lib, s, rays, hits, seed=5)
    assert vec == 1
    _same(got, want)
    assert torch.equal(want["texcoord"], torch.stack([hits.u, hits.v], -1))
    assert 0.2 < float(want["hit"].float().mean()) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_takes_the_plain_version(dtype):
    s, rays, hits = sphere_aov_case((16, 8), 2, dtype=dtype)
    before = trace.counts()
    got, got_h = pointcloud.sphere_aovs_from_hits(s, rays, hits)
    assert trace.since(before) == {}
    want, want_h = pointcloud._sphere_aovs_plain(s, rays, hits)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    for a, b in zip(got_h, want_h):
        assert torch.equal(a, b)
    assert got["rgb"].dtype == getattr(torch, dtype)


def test_cpu_frame_launches_nothing():
    """A whole frame on the CPU, through K1's plain version and then the
    post: no launch counter moves."""
    s, s8, rays = _cloud_frame()
    before = trace.counts()
    aovs, _ = pointcloud.render_sphere_aovs(s, rays, scene8=s8)
    assert not any(trace.launches(before).values())
    assert bool(aovs["hit"].any())


def test_fused_takes_what_the_kernel_reads():
    """``_fused_refusal`` accepts what the kernel reads and names the one
    input it cannot take: on the card that input raises."""
    s, rays, hits = sphere_aov_case((6, 5), 4)
    c = s.centers
    refusal = pointcloud._fused_refusal
    assert refusal(c, rays, hits) is None
    assert refusal(c, nt.Rays(*(x.reshape(30, *x.shape[2:]) for x in rays)),
                   nt.Hits(*(x.reshape(30) for x in hits))) is None
    cases = [
        ((c.double(), rays, hits), "spheres.centers of dtype"),
        ((c[:, :2], rays, hits), "spheres.centers of shape"),
        ((c.reshape(-1), rays, hits), "spheres.centers of shape"),
        ((c, nt.Rays(*(x.double() for x in rays)), hits), "rays.org"),
        ((c, rays._replace(dir=rays.dir.double()), hits), "rays.dir"),
        ((c, rays, hits._replace(prim_id=hits.prim_id.int())),
         "hits.prim_id of dtype torch.int32"),
        ((c, rays, nt.Hits(*(x.reshape(-1) for x in hits))),
         "hits.t of shape"),
        ((c, rays, hits._replace(t=hits.t[:, :1])), "hits.t of shape"),
        ((c, rays._replace(dir=rays.dir[..., :2]), hits), "rays of shapes"),
        ((c, rays, tuple(hits)), "records of type tuple"),
    ]
    for f in ("t", "u", "v"):
        cases.append(((c, rays, hits._replace(
            **{f: getattr(hits, f).double()})), f"hits.{f} of dtype"))
    for args, said in cases:
        got = refusal(*args)
        assert got is not None and got.startswith(said), (said, got)
