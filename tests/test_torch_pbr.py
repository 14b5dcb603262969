"""PyTorch port, PBR shading (``models/pbr.py``) against the JAX package
on the same scene, camera and materials.

The JAX ``render_pbr`` and ``shade_pbr`` run jitted in a child process
held to AVX (``testing.run_without_fma``: no FMA contraction), on the
stack engine. The scene: the Cornell box and a UV sphere (32 + 576
triangles), a 32 x 32 camera. Tolerances:
- ``shade_pbr`` on seeded normals, views, lights and materials:
  bit-identical;
- ``render_pbr`` on the stack engine (``scene8=None``), with and without
  shadows, uniform and per-face materials: every AOV and the image
  bit-identical;
- ``render_pbr`` with ``scene8`` (BVH16 tables, K1's plain version on
  the CPU, primary and shadow traces through it) against the JAX stack
  route: equal hit masks, the same prim except between hits at
  bit-equal t, t within 4 ulp, and at least 97% of pixels bit-identical
  (room for equal-t ties and shadow rays that graze an edge, where the
  two engines may part; measured on this camera: every pixel
  identical, no prim differs);
- the K1 route makes two traversal calls a render, the shadow call in
  any-hit mode skipping each pixel's primary prim.
"""

import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch import BVHBuildOptions, build_triangle_bvh
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (make_cornell_box, make_uv_sphere,
                                            merge_meshes)
from nanort_tpu_torch.models import cameras, pbr
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import compare_hits, run_without_fma
from nanort_tpu_torch.traverse import packet

torch.set_num_threads(1)

RES = 32
AOVS = ("rgb", "normal", "position", "depth", "texcoord", "prim_id", "hit")


def _scene():
    return merge_meshes(make_cornell_box(2.0), make_uv_sphere(12, 24, 0.5))


def _materials(n_faces):
    rng = np.random.default_rng(5)
    return {
        "uniform": (np.array([0.7, 0.6, 0.5], np.float32),
                    np.float32(0.3), np.float32(0.45)),
        "per_face": (rng.uniform(0, 1, (n_faces, 3)).astype(np.float32),
                     rng.uniform(0, 1, n_faces).astype(np.float32),
                     rng.uniform(0.05, 1, n_faces).astype(np.float32)),
    }


RENDERS = {"uniform_shadows": ("uniform", True),
           "uniform_plain": ("uniform", False),
           "per_face_shadows": ("per_face", True)}


def _shade_inputs(n=300, seed=4):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    return {"n": unit(rng.normal(size=(n, 3))),
            "v": unit(rng.normal(size=(n, 3))),
            "l": unit(rng.normal(size=(n, 3))),
            "base": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "metal": rng.uniform(0, 1, n).astype(np.float32),
            "rough": rng.uniform(0, 1, n).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_side():
    return run_without_fma(__file__, {"dummy": np.zeros(1)})


@pytest.fixture(scope="module")
def port():
    v, f = _scene()
    mesh = TriangleMesh(torch.from_numpy(v), torch.from_numpy(f))
    bvh, _ = build_triangle_bvh(mesh)
    b8, _ = build_triangle_bvh(mesh, BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    s8 = collapse_bvh8(b8, v, f, width=16).to("cpu")
    rays = cameras.pinhole_rays(cameras.look_at(
        (0.2, 0.3, 2.4), (0, 0, 0), width=RES, height=RES, fov=60,
        device="cpu"))
    return bvh, mesh, s8, rays, _materials(len(f))


def _mat(m):
    return pbr.PBRMaterial(*(torch.as_tensor(x) for x in m))


def test_shade_pbr_matches_jax(jax_side):
    z = {k: torch.from_numpy(x) for k, x in _shade_inputs().items()}
    got = pbr.shade_pbr(z["n"], z["v"], z["l"], z["base"], z["metal"],
                        z["rough"], torch.tensor([3.0, 2.0, 1.0]))
    np.testing.assert_array_equal(got.numpy(), jax_side["shade"])


@pytest.mark.parametrize("render", list(RENDERS))
def test_render_pbr_stack_matches_jax(jax_side, port, render):
    bvh, mesh, _, rays, mats = port
    which, shadows = RENDERS[render]
    aovs, hits = pbr.render_pbr(bvh, mesh, rays, _mat(mats[which]),
                                shadows=shadows)
    assert float(aovs["rgb"].mean()) > 0.01
    for k in AOVS:
        np.testing.assert_array_equal(aovs[k].numpy(),
                                      jax_side[f"{render}/{k}"], err_msg=k)


@pytest.mark.parametrize("render", ["uniform_shadows", "per_face_shadows"])
def test_render_pbr_k1_route_matches_jax(jax_side, port, render):
    bvh, mesh, s8, rays, mats = port
    which, shadows = RENDERS[render]
    aovs, hits = pbr.render_pbr(bvh, mesh, rays, _mat(mats[which]),
                                shadows=shadows, scene8=s8)
    want = {k: torch.from_numpy(jax_side[f"{render}/{k}"]) for k in
            ("t", "u", "v", "prim_id")}
    c = compare_hits(hits, type(hits)(**want))
    assert c["ok"], c
    same = (aovs["rgb"].numpy() == jax_side[f"{render}/rgb"]).all(-1).mean()
    assert same >= 0.97, same


def test_k1_route_traces_twice_with_the_skip(port, monkeypatch):
    """The K1 route: one primary and one shadow call of the traversal
    kernel's wrapper, the shadow call in any-hit mode with each ray
    skipping its pixel's primary prim."""
    bvh, mesh, s8, rays, mats = port
    calls = []
    real = packet.traverse_bvh8

    def spy(scene, r, *a, **k):
        out = real(scene, r, *a, **k)
        calls.append((r, k, out))
        return out

    monkeypatch.setattr(packet, "traverse_bvh8", spy)
    aovs, hits = pbr.render_pbr(bvh, mesh, rays, _mat(mats["uniform"]),
                                scene8=s8)
    assert len(calls) == 2
    (_, k0, _), (r1, k1, _) = calls
    assert not k0.get("occlusion", False) and k0.get("skip_prim_id") is None
    assert k1["occlusion"]
    # the skip ids ride with the sorted rays: as a multiset they are the
    # primary prim ids, and every live shadow ray carries one
    skip = k1["skip_prim_id"]
    assert skip.shape[0] == RES * RES
    assert torch.equal(torch.sort(skip).values,
                       torch.sort(hits.prim_id.reshape(-1)).values)
    live = r1.max_t > 0
    assert bool((skip[live] != 0xFFFFFFFF).all())


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu import build_triangle_bvh as jbuild
    from nanort_tpu.models import cameras as jcam
    from nanort_tpu.models import pbr as jpbr
    from nanort_tpu.ops.triangle import TriangleMesh as JMesh

    res = {}
    z = {k: jnp.asarray(x) for k, x in _shade_inputs().items()}
    res["shade"] = np.asarray(jax.jit(jpbr.shade_pbr)(
        z["n"], z["v"], z["l"], z["base"], z["metal"], z["rough"],
        jnp.asarray([3.0, 2.0, 1.0], jnp.float32)))
    v, f = _scene()
    mesh = JMesh(jnp.asarray(v), jnp.asarray(f))
    bvh, _ = jbuild(mesh)
    rays = jcam.pinhole_rays(jcam.look_at((0.2, 0.3, 2.4), (0, 0, 0),
                                          width=RES, height=RES, fov=60))
    mats = _materials(len(f))
    for name, (which, shadows) in RENDERS.items():
        m = jpbr.PBRMaterial(*(jnp.asarray(x) for x in mats[which]))
        aovs, hits = jpbr.render_pbr(bvh, mesh, rays, m, shadows=shadows)
        for k in AOVS:
            res[f"{name}/{k}"] = np.asarray(aovs[k])
        for k in ("t", "u", "v", "prim_id"):
            res[f"{name}/{k}"] = np.asarray(getattr(hits, k))
    for k in list(res):
        if res[k].dtype == np.uint32:
            res[k] = res[k].astype(np.int64)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
