"""PyTorch port, objrender's AOVs: the CUDA kernel's source
(nanort_tpu_torch/csrc/aovs.cu) compiled with g++ against a small mock of
the CUDA API (``testing.build_with_cuda_mock``), its kernel function run
for every block and thread of its grid (blocks and threads in a shuffled
order), and held to the plain version (models/objrender.py::_aovs_plain)
bit for bit: image and flat batches, a ragged last quad, hits and
misses, zero-area and tiny triangles (the normalize guard), int32 and
int64 faces, geometric and facevarying normals, 16-byte aligned streams
(quads) and streams that are not (one pixel at a time), and the records
of a trace. g++ builds with -ffp-contract=off and no -ffast-math, as
nvcc builds with --fmad=false.

Also the route: CPU tensors, float32 and float64 alike, take the plain
version and launch nothing; ``_fused_takes`` accepts what the kernel
reads and nothing else. The launch itself needs the card and is held
there by test_torch_gpu.py.
"""

import ctypes

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.models import objrender
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import aov_case, build_with_cuda_mock
from nanort_tpu_torch.utils import trace

# appended to the kernel source: every block of the launch's grid, in a
# shuffled order, and in each every thread, in a shuffled order, as
# ``launch`` would start them; returns the alignment gate's choice, or -1
# where a thread trapped
HARNESS = r"""
#include <vector>
uint3 threadIdx, blockIdx;
extern "C" int emulate_aovs(
    const float* t, const float* u, const float* v, const long long* prim,
    const float* org, const float* dir, const void* faces, int face_bytes,
    const float* verts, const float* fnrm, float* rgb, float* nrm,
    float* pos, float* depth, float* uv, unsigned char* hit, long long n,
    long long rows, long long nverts, unsigned seed) {
  const Params p{t,   u,   v,   prim,  org, dir, faces, verts, fnrm, rgb,
                 nrm, pos, depth, uv, hit, n, rows, nverts};
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
        if (face_bytes == 4) {
          aovs_kernel<int>(p, vec);
        } else {
          aovs_kernel<long long>(p, vec);
        }
      } catch (const cuda_mock_trap&) {
        return -1;
      }
    }
  }
  return vec;
}
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KEYS = ("rgb", "normal", "position", "depth", "texcoord", "prim_id", "hit")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("aovs.cu", HARNESS,
                               tmp_path_factory.mktemp("aovs"))
    lib.emulate_aovs.restype = ctypes.c_int
    lib.emulate_aovs.argtypes = ([_P] * 7 + [_I] + [_P] * 8
                                 + [_L, _L, _L, ctypes.c_uint])
    return lib


def _shifted(x: torch.Tensor, shift: bool) -> torch.Tensor:
    """``x``, or a copy of it one element past a 16-byte boundary."""
    if not shift:
        return x.contiguous()
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _emulate(lib, mesh, attrs, rays, hits, shift=False, seed=1):
    """The kernel's AOVs (the ``_aovs_fused`` dict) from the mock build,
    and whether the gate chose the quads (-1: the launch trapped)."""
    bs = rays.batch_shape
    rgb, nrm, pos = (torch.zeros(bs + (3,)) for _ in range(3))
    depth, uv = torch.zeros(bs), torch.zeros(bs + (2,))
    hit = torch.zeros(bs, dtype=torch.bool)
    outs = [_shifted(x, shift) for x in (rgb, nrm, pos, depth, uv, hit)]
    ins = [_shifted(x, shift) for x in (*hits, rays.org, rays.dir)]
    faces = torch.as_tensor(mesh.faces).contiguous()
    verts = torch.as_tensor(mesh.vertices).contiguous()
    fnrm = None if attrs is None else attrs.normals.contiguous()
    ptr = lambda x: None if x is None else x.data_ptr()
    vec = lib.emulate_aovs(
        *map(ptr, ins), ptr(faces), faces.element_size(), ptr(verts),
        ptr(fnrm), *map(ptr, outs), hits.t.numel(),
        (faces if fnrm is None else fnrm).shape[0], verts.shape[0], seed)
    got = dict(zip(("rgb", "normal", "position", "depth", "texcoord"),
                   outs[:5]))
    got.update(prim_id=hits.prim_id, hit=outs[5])
    return got, vec


def _same_bits(got: dict, want: dict):
    for k in KEYS:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("bs", [(24, 40), (2051,)], ids=["image", "flat"])
@pytest.mark.parametrize("face_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("facevarying", [False, True],
                         ids=["geometric", "facevarying"])
def test_kernel_equals_plain(lib, bs, face_dtype, facevarying):
    mesh, attrs, rays, hits = aov_case(bs, len(bs) + 3 * facevarying,
                                       face_dtype, facevarying)
    want = objrender._aovs_plain(mesh, attrs, rays, hits)
    got, vec = _emulate(lib, mesh, attrs, rays, hits, seed=11)
    assert vec == 1
    _same_bits(got, want)
    assert bool(want["hit"].any()) and not bool(want["hit"].all())


@pytest.mark.parametrize("face_dtype,facevarying", [(np.int32, False),
                                                    (np.int64, True)])
def test_unaligned_streams_take_pixels(lib, face_dtype, facevarying):
    """Streams one element off a 16-byte boundary: the gate takes one
    pixel at a time, with the same bits."""
    mesh, attrs, rays, hits = aov_case((1023,), 7, face_dtype, facevarying)
    want = objrender._aovs_plain(mesh, attrs, rays, hits)
    got, vec = _emulate(lib, mesh, attrs, rays, hits, shift=True, seed=3)
    assert vec == 0
    _same_bits(got, want)


@pytest.mark.parametrize("bad", ["prim_past_faces", "prim_negative",
                                 "prim_past_normals", "vertex_past_verts"])
def test_ids_out_of_range_fail_the_launch(lib, bad):
    """A hit whose prim id names no row of the table it indexes (the
    facevarying normals' rows where given, else the faces'), or whose face
    names no vertex, traps; the plain version's gather raises on each but
    the negative id, which torch's indexing wraps."""
    mesh, attrs, rays, hits = aov_case((64,), 9, np.int32,
                                       bad == "prim_past_normals")
    _, vec = _emulate(lib, mesh, attrs, rays, hits)
    assert vec == 1  # the miss ids and every valid id pass
    prim, faces = hits.prim_id.clone(), mesh.faces.clone()
    i = int(torch.nonzero(prim != objrender.INVALID_PRIM_ID)[0])
    if bad == "prim_past_faces":
        prim[i] = len(faces)
    elif bad == "prim_negative":
        prim[i] = -1
    elif bad == "prim_past_normals":
        attrs = attrs._replace(normals=attrs.normals[:-1])
        prim[i] = len(faces) - 1
    else:
        faces[prim[i]] = torch.tensor([0, len(mesh.vertices), 1])
    mesh = TriangleMesh(mesh.vertices, faces)
    hits = hits._replace(prim_id=prim)
    _, vec = _emulate(lib, mesh, attrs, rays, hits)
    assert vec == -1
    if bad != "prim_negative":
        with pytest.raises(IndexError):
            objrender._aovs_plain(mesh, attrs, rays, hits)


def test_traced_records(lib):
    """The records of a 32 x 48 camera frame through K1's plain version:
    the kernel's AOVs are render_aovs's on the CPU."""
    mesh, _, _, _ = aov_case((1,), 0, np.int32)
    v, f = mesh.vertices.numpy(), mesh.faces.numpy()
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s16 = collapse_bvh8(bvh, v, f, width=16)
    rays = pinhole_rays(look_at((0.3, 0.2, 4.0), (0, 0, 0), width=48,
                                height=32, fov=50.0, device="cpu"))
    want, hits = objrender.render_aovs(bvh, mesh, rays, scene8=s16)
    got, _ = _emulate(lib, mesh, None, rays, hits, seed=5)
    _same_bits(got, want)
    assert 0.2 < float(want["hit"].float().mean()) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("facevarying", [False, True],
                         ids=["geometric", "facevarying"])
def test_cpu_takes_the_plain_version(dtype, facevarying):
    case = aov_case((16, 8), 2, np.int32, facevarying, dtype)
    before = trace.counts()
    got = objrender.aovs_from_hits(*case)
    assert trace.since(before) == {}
    want = objrender._aovs_plain(*case)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert got["rgb"].dtype == getattr(torch, dtype)


def test_fused_takes_what_the_kernel_reads():
    mesh, attrs, rays, hits = aov_case((6, 5), 4, facevarying=True)
    verts, faces, fnrm = mesh.vertices, mesh.faces, attrs.normals
    takes = objrender._fused_takes
    for fd in (torch.int32, torch.int64):
        assert takes(verts, faces.to(fd), None, rays, hits)
        assert takes(verts, faces.to(fd), fnrm, rays, hits)
    assert not takes(verts.double(), faces, None, rays, hits)
    assert not takes(verts, faces.to(torch.int16), None, rays, hits)
    assert not takes(verts, faces, fnrm.double(), rays, hits)
    assert not takes(verts, faces, fnrm[:, :2], rays, hits)
    assert not takes(verts, faces, None,
                     nt.Rays(*(x.double() for x in rays)), hits)
    assert not takes(verts, faces, None, rays,
                     hits._replace(t=hits.t.double()))
    assert not takes(verts, faces, None, rays,
                     hits._replace(prim_id=hits.prim_id.int()))
    assert not takes(verts, faces, None, rays,
                     nt.Hits(*(x.reshape(-1) for x in hits)))
    assert not takes(verts, faces, None, rays, tuple(hits))
