"""PyTorch port, a camera's batch through K1 on the CPU
(``traverse/packet.py::traverse_image``).

``traverse_image`` hands K1 an (H, W) batch as its rays lie, in raster
order, with no tiled copy of the rays or the records. Held here against
the route it replaced (``tile_image_rays(..., pad=True)``, K1 over the
copy, ``untile``), at padded and odd shapes (W < 32, one pixel, a whole
tile, a transposed view), on triangles and spheres, widths 8 and 16:

- the records are equal bit for bit, in the rays' shape;
- the frame takes one ``traverse_bvh8`` call over the (H, W) batch, in
  the ``k1`` span, with no ``tile`` or ``untile`` span.

Each ray's walk depends on that ray alone, so the claim order cannot
change a record; the card's test (``tests/test_torch_gpu.py``) holds the
kernel itself to the same at 8192² and 3840 x 2160.
"""

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import make_cornell_box, make_uv_sphere, \
    merge_meshes
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.ops import sphere
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.traverse import packet
from nanort_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    """Config A's box and sphere (triangles) and a cloud of overlapping
    spheres, each at widths 8 and 16."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=9, max_leaf_primitives=9))
    rng = np.random.default_rng(4)
    s = sphere.Spheres(
        torch.from_numpy(rng.uniform(-1, 1, (600, 3)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.05, 0.3, 600).astype(np.float32)))
    sbvh, _ = sphere.build_sphere_bvh(s)
    out = {}
    for width in (8, 16):
        out["triangles", width] = collapse_bvh8(bvh, v, f, width=width)
        out["spheres", width] = collapse_bvh8(sbvh, width=width, spheres=s)
    return out


def _rays(h, w, transposed):
    """A pinhole camera's (h, w) rays; ``transposed``: a transposed view
    of the (w, h) camera's, which is not contiguous."""
    if transposed:
        return nt.Rays(*(x.transpose(0, 1) for x in _rays(w, h, False)))
    return pinhole_rays(look_at((0.3, 0.4, 3.2), (0.0, 0.0, 0.0), width=w,
                                height=h, fov=50.0, device="cpu"))


CASES = [((70, 100), "triangles", False), ((70, 100), "spheres", False),
         ((40, 24), "triangles", False), ((40, 24), "spheres", False),
         ((23, 37), "triangles", False), ((128, 64), "spheres", False),
         ((1, 1), "triangles", False), ((33, 70), "triangles", True)]


@pytest.mark.parametrize("shape,kind,transposed", CASES, ids=[
    f"{h}x{w}-{kind}" + ("-transposed" if tr else "")
    for (h, w), kind, tr in CASES])
def test_image_route_is_the_tiled_route(scenes, monkeypatch, shape, kind,
                                        transposed):
    h, w = shape
    rays = _rays(h, w, transposed)
    calls, inner = [], packet.traverse_bvh8

    def spy(scene, r, *a, **kw):
        calls.append(tuple(r.batch_shape))
        return inner(scene, r, *a, **kw)

    for width in (8, 16):
        scene = scenes[kind, width]
        tiled, untile = packet.tile_image_rays(
            rays, min(128, h), min(64, w), pad=True)
        want = untile(packet.traverse_bvh8(scene, tiled))
        calls.clear()
        trace.reset()
        with monkeypatch.context() as m:
            m.setattr(packet, "traverse_bvh8", spy)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]):
                got = packet.traverse_image(scene, rays)
        names = [r.name for r in trace.records()]
        trace.reset()
        assert calls == [(h, w)]
        assert names == ["k1"]
        for a, b in zip(got, want):
            assert a.shape == (h, w) and torch.equal(a, b)
        assert bool(got.prim_id.ne(nt.INVALID_PRIM_ID).any()) or h * w == 1
