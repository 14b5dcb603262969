"""PyTorch port, the whole main-path slice at a small size against the
JAX package over the same inputs: a ~20K-triangle subdivided sphere and a
64x64 pinhole, through build -> collapse -> tile -> traverse -> untile.

Each package runs its own entry points. The host stages must agree bit
for bit (tree, BVH16 tables, camera rays, tiling); the hit records are
held to the JAX brute-force oracle and stack engine, run op by op (see
test_torch_packet.py for why), with the repository's tolerance: the
same hit mask, the same prim id except at bit-equal t, t within 4 ulp,
u/v within 2e-6.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build.bvh8 import collapse_bvh8 as j_collapse
from nanort_tpu.io.procedural import make_subdivided_sphere_scene as j_scene
from nanort_tpu.models import cameras as j_cams
from nanort_tpu.traverse import pallas_packet as jp
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import make_subdivided_sphere_scene
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import compare_hits
from nanort_tpu_torch.testing import same_bits as _same
from nanort_tpu_torch.traverse.packet import (
    detect_specialization, tile_image_rays, traverse_bvh8)

torch.set_num_threads(1)

RES = 64
TILE = (32, 16)


def test_main_path_slice_matches_jax():
    # --- port: the main path through its entry points
    v, f = make_subdivided_sphere_scene(20_000)
    opts = nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), opts)
    scene = collapse_bvh8(bvh, v, f, width=16).to("cpu")
    cam = look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=RES, height=RES,
                  fov=60.0, device="cpu")
    rays = pinhole_rays(cam)
    rays_t, untile = tile_image_rays(rays, *TILE)
    spec = detect_specialization(rays_t, sub=1)
    hits = untile(traverse_bvh8(scene, rays_t, specialize=spec))

    # --- JAX: the same stages
    jv, jf = j_scene(20_000)
    assert _same(v, jv) and _same(f, jf)
    jmesh = jrt.TriangleMesh(jax.numpy.asarray(jv), jax.numpy.asarray(jf))
    jbvh, _ = jrt.build_triangle_bvh(
        jmesh, jrt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    for a, b in zip(bvh, jbvh):
        assert _same(a, b)
    js = j_collapse(jbvh, jv, jf, width=16)
    assert _same(scene.nodes.numpy(), js.nodes)
    assert _same(scene.leafs.numpy(), js.leafs)
    assert scene.depth == js.depth and scene.max_leaf == js.max_leaf
    jcam = j_cams.look_at((0.0, 0.0, 2.2), (0.0, 0.0, 0.0), width=RES,
                          height=RES, fov=60.0)
    jrays = j_cams.pinhole_rays(jcam)
    for a, b in zip(rays, jrays):
        assert _same(a.numpy(), b)
    jrays_t, _ = jp.tile_image_rays(jrays, *TILE)
    for a, b in zip(rays_t, jrays_t):
        assert _same(a.numpy(), b)
    assert spec == jp.detect_specialization(jrays_t, sub=1)

    with jax.disable_jit():
        want = jrt.brute_force_traverse(jmesh, jrays)
        want_stack = jrt.traverse_triangles(jbvh, jmesh, jrays, max_leaf=9)
    assert hits.t.shape == (RES, RES)
    for w in (want, want_stack):
        c = compare_hits(hits, jrt.Hits(*(np.asarray(x) for x in w)))
        assert c["ok"], c
    # the sphere covers its analytic share of the frame
    frac = float(hits.hit.float().mean())
    assert 0.55 < frac < 0.67


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import nanort_tpu_torch, nanort_tpu_torch.interop, "
            "nanort_tpu_torch.testing, nanort_tpu_torch.traverse.packet, "
            "nanort_tpu_torch.traverse._ext, nanort_tpu_torch.models.cameras, "
            "nanort_tpu_torch.build.native, nanort_tpu_torch.io.procedural; "
            "assert 'nanort_tpu' not in sys.modules; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
