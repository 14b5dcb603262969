"""PyTorch port on the card: the CUDA traversal kernel
(csrc/packet_traverse.cu) against its plain torch version
(traverse/packet.py::_traverse_reference) on the same tables and rays.
Tolerance: bit-identical records (the two share one child order and one
arithmetic; the kernel is built with --fmad=false).

Every test here is marked ``gpu`` and skips without a CUDA device. This
file imports no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_subdivided_sphere_scene, make_uv_sphere,
    merge_meshes)
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.traverse import packet

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(v, f, width):
    bvh, _ = nt.build_triangle_bvh(
        TriangleMesh(v, f),
        nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    return collapse_bvh8(bvh, v, f, width=width)


def _rays(n, seed, broken=True):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if broken:  # degenerate rays among them
        org[0::10, 0] = np.nan
        d[2::10] = 0.0
        d[4::10, 1] = np.inf
        d[6::10, 2] = -3.1e38
    return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))


def _same_on_both(scene, rays, dev, **kw):
    before = packet.LAUNCHES
    got = packet.traverse_bvh8(scene.to(dev),
                               nt.Rays(*(x.to(dev) for x in rays)), **kw)
    assert packet.LAUNCHES == before + 1
    want = packet.traverse_bvh8(scene, rays, **kw)
    for a, b in zip(got, want):
        assert a.is_cuda
        assert torch.equal(a.cpu(), b)


OPTIONS = {
    "closest": nt.BVHTraceOptions(),
    "cull": nt.BVHTraceOptions(cull_back_face=True),
    "range": nt.BVHTraceOptions(prim_ids_range=(100, 900)),
    "no_exact_edges": nt.BVHTraceOptions(exact_edge_fallback=False),
}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_matches_plain_small_scene(dev, width, occlusion, opt):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    _same_on_both(_scene(v, f, width), _rays(3001, 5), dev,
                  options=OPTIONS[opt], occlusion=occlusion)


@pytest.mark.parametrize("width", [8, 16])
def test_kernel_matches_plain_with_skip(dev, width):
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    scene = _scene(v, f, width)
    rays = _rays(3001, 6)
    first = packet.traverse_bvh8(scene, rays)
    _same_on_both(scene, rays, dev, skip_prim_id=first.prim_id)


def test_kernel_matches_plain_camera_frame(dev):
    v, f = make_subdivided_sphere_scene(100_000)
    from nanort_tpu_torch.models.cameras import look_at, pinhole_rays

    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=256, height=256,
                  fov=60.0)
    rays_t, _ = packet.tile_image_rays(pinhole_rays(cam), 128, 64)
    _same_on_both(_scene(v, f, 16), rays_t, dev)


def test_kernel_rejects_host_tables(dev):
    s = interop.scene_from_numpy(np.zeros((2, 128)), np.zeros((1, 128)),
                                 1, 1, 1, 0, 16)
    r = nt.make_rays(torch.zeros(4, 3, device=dev),
                     torch.ones(4, 3, device=dev))
    with pytest.raises(ValueError, match="scene.to"):
        packet.traverse_bvh8(s, r)
