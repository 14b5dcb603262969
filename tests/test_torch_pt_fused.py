"""PyTorch port, the fused path-tracing megakernels K3 (brute sweep) and
K4 (BVH16 trace): their plain versions (``models/pt_fused.py``, CPU
tensors) against the JAX package's ``render_fused`` and
``render_fused_bvh`` in interpret mode, over the same tables, rays and
int seed; and the helpers they share, against the JAX helpers run op by
op.

The JAX renders run in a child process without FMA instructions
(``testing.run_without_fma``): jitted XLA on the CPU contracts
``a * b + c`` inside the kernel, which moves the last ulp of a few
percent of pixels. Tolerances:
- helpers and ``trig="poly"`` renders: bit-identical. K4 uses an
  off-axis camera, so no primary ray hits a shared edge at exactly equal
  t (the port takes the child order from each ray's own octant, the TPU
  from ray 0's: a tie may resolve to the other prim, the repository's
  tie contract);
- ``trig="native"``: torch's and XLA's CPU cos/sin differ in the last
  ulp, which flips a later lobe pick on a few paths: at least 80% of
  pixels identical (measured 94.2%) and the image means within 2%.
"""

import sys
import types

import numpy as np
import pytest
import torch

from nanort_tpu_torch.io.procedural import (
    make_cornell_dense_pt_scene, make_cornell_pt_scene)
from nanort_tpu_torch.models import path_tracer, pt_fused
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)


def _cam(w, h, eye):
    r = pinhole_rays(look_at(eye=eye, center=(0, 0, 0), width=w, height=h,
                             fov=45.0, device="cpu"))
    return r.org.reshape(-1, 3), r.dir.reshape(-1, 3)


def _tilted_normals(scene):
    """A 26-column face table: vertex normals tilted off the face
    normal by seeded noise."""
    f = scene.face_table
    rng = np.random.default_rng(2)
    fvn = f[:, None, 0:3] + torch.from_numpy(
        rng.normal(0, 0.2, (f.shape[0], 3, 3)).astype(np.float32))
    return scene._replace(
        face_table=torch.cat([f, fvn.reshape(-1, 9)], 1).contiguous())


def _no_lights(scene):
    return scene._replace(light_table=scene.light_table[:0],
                          light_faces=scene.light_faces[:0])


# job -> (scene, camera (w, h, eye), seed, spp, kwargs)
CORNELL = (12, 10, (0, 0.0, 5.0))
DENSE = (12, 10, (0.0123, 0.0371, 2.6))
JOBS = {
    "k3_17": ("cornell", CORNELL, 7, 3,
              dict(max_bounces=5, trig="poly")),
    "k3_26": ("cornell26", CORNELL, 5, 2,
              dict(max_bounces=4, trig="poly", azimuth_strata=2)),
    "k3_no_lights": ("cornell_dark", CORNELL, 5, 2,
                     dict(max_bounces=4, trig="poly")),
    "k3_native": ("cornell", CORNELL, 7, 4,
                  dict(max_bounces=4, trig="native", azimuth_strata=4)),
    "k4": ("dense", DENSE, 9, 2, dict(max_bounces=4, trig="poly")),
    "k4_lanes": ("dense", DENSE, 9, 8,
                 dict(max_bounces=3, trig="poly", azimuth_strata=2,
                      spp_lanes=4)),
}


@pytest.fixture(scope="module")
def scenes():
    cornell = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                        device="cpu")
    v, f, m, mats = make_cornell_dense_pt_scene(2000)
    return {"cornell": cornell, "cornell26": _tilted_normals(cornell),
            "cornell_dark": _no_lights(cornell),
            "dense": path_tracer.make_pt_scene(v, f, m, mats,
                                               engine="pallas",
                                               device="cpu")}


@pytest.fixture(scope="module")
def renders(scenes):
    """{job: (port image, JAX image)}; the JAX images from one child."""
    port, inputs = {}, {}
    for job, (name, cam, seed, spp, kw) in JOBS.items():
        s = scenes[name]
        org, d = _cam(*cam)
        fn = pt_fused.render_fused_bvh if job.startswith("k4") else \
            pt_fused.render_fused
        port[job] = fn(s, org, d, seed, spp, **kw).numpy()
        inputs[f"{job}/org"], inputs[f"{job}/dir"] = org.numpy(), d.numpy()
        for k in ("face_table", "light_table", "light_faces", "fused_aux"):
            x = getattr(s, k)
            if x is not None:
                inputs[f"{job}/{k}"] = x.numpy()
        inputs[f"{job}/vertices"] = s.mesh.vertices.numpy()
        inputs[f"{job}/faces"] = s.mesh.faces.numpy()
        for k in path_tracer.Materials._fields:
            inputs[f"{job}/mat_{k}"] = getattr(s.materials, k).numpy()
        if s.scene8 is not None:
            inputs[f"{job}/nodes"] = s.scene8.nodes.numpy()
            inputs[f"{job}/leafs"] = s.scene8.leafs.numpy()
            inputs[f"{job}/s8"] = np.array([s.scene8.max_leaf,
                                            s.scene8.depth])
    jax_out = run_without_fma(__file__, inputs)
    return {job: (port[job], jax_out[job]) for job in JOBS}


@pytest.mark.parametrize("job", [j for j in JOBS if j != "k3_native"])
def test_render_matches_jax_bit_for_bit(renders, job):
    got, want = renders[job]
    assert got.shape == want.shape == (120, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, want)


def test_native_trig_matches_jax_statistically(renders):
    got, want = renders["k3_native"]
    same = (got == want).all(1).mean()
    assert same > 0.8, same
    assert abs(got.mean() - want.mean()) < 0.02 * want.mean()


def test_hash32_and_uniform_match_jax():
    import jax.numpy as jnp

    from nanort_tpu.models import pt_fused as jpf

    edges = np.array([0, 1, -1, 2, 255, 65535, 65536, 2**31 - 1, -2**31,
                      -2**31 + 1, 0x7FEB352D, -2073352565, 123456789,
                      -987654321], np.int32)
    x = np.concatenate([edges, np.random.default_rng(0).integers(
        -2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)])
    want = np.asarray(jpf._hash32(jnp.asarray(x))).view(np.uint32)
    got = pt_fused._hash32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    ray_id = np.arange(x.shape[0], dtype=np.int32)
    for ctr in (0, 1, 16, 2**31 - 1, -2**31, -5, 3 + 11 * 16):
        want = np.asarray(jpf._uniform(jnp.asarray(ray_id), jnp.int32(ctr)))
        # the port carries counters as uint32 values in int64
        got = pt_fused._uniform(torch.from_numpy(ray_id).long(),
                                ctr & 0xFFFFFFFF).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (want >= 0).all() and (want < 1).all()


def test_sincos_onb_normalize_match_jax():
    import jax.numpy as jnp

    from nanort_tpu.models import pt_fused as jpf

    rng = np.random.default_rng(3)
    u = np.concatenate([
        np.float32([0.0, 0.25, 0.5, 0.75, np.nextafter(1, 0, dtype=np.float32),
                    np.nextafter(0.25, 0, dtype=np.float32)]),
        rng.random(8192, dtype=np.float32)])
    for got, want in zip(pt_fused._sincos_2pi_poly(torch.from_numpy(u)),
                         jpf._sincos_2pi_poly(jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, -0.0]]
    got = pt_fused._normalize3(*torch.from_numpy(n).unbind(1))
    want = jpf._normalize3(*jnp.asarray(n).T)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    unit = [x.numpy() for x in got[:3]]
    got = pt_fused._onb(*(torch.from_numpy(x) for x in unit))
    want = jpf._onb(*(jnp.asarray(x) for x in unit))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_seed_is_jax_key_seed():
    import jax

    from nanort_tpu.models import pt_fused as jpf

    for k in (0, 3, 7, 2**31 - 1):
        assert pt_fused._seed32(k) == jpf._seed_from_key(
            jax.random.PRNGKey(k)) == k
    for k in (2**31, 2**40 + 5, -3):
        assert pt_fused._seed32(k) == jpf._seed_from_key(k)
    with pytest.raises(TypeError):
        pt_fused._seed32(jax.random.PRNGKey(3))


def test_bvh_route_matches_brute_route(scenes):
    """K4's plain version against K3's on the Cornell box with BVH16
    tables attached (leaf 4): bit-identical except paths through an
    exactly-equal-t shared edge (prim order vs traversal order)."""
    import nanort_tpu_torch as nt
    from nanort_tpu_torch.build.bvh8 import collapse_bvh8
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse.fused_trace import build_aux_rows

    v, f, m, _ = make_cornell_pt_scene(2.0)
    s = scenes["cornell"]
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=4, max_leaf_primitives=4))
    s8 = collapse_bvh8(bvh, v, f, width=16)
    aux = build_aux_rows(s8.leafs, m, f, v, s8.max_leaf,
                         gn_unit=s.face_table[:, 0:3].numpy())
    s = s._replace(scene8=s8.to("cpu"), fused_aux=torch.from_numpy(aux))
    assert pt_fused.fused_eligible(s) and pt_fused.fused_bvh_eligible(s)
    org, d = _cam(24, 24, (0, 0.0, 5.0))
    a = pt_fused.render_fused(s, org, d, 7, 6, max_bounces=4)
    b = pt_fused.render_fused_bvh(s, org, d, 7, 6, max_bounces=4)
    same = (a == b).all(1).float().mean()
    assert same > 0.9, same
    assert abs(float(a.mean() - b.mean())) < 0.05 * float(a.mean())


def test_wrappers_check_arguments(scenes):
    org, d = _cam(4, 4, (0, 0.0, 5.0))
    dense, cornell = scenes["dense"], scenes["cornell"]
    with pytest.raises(ValueError, match="spp_lanes"):
        pt_fused.render_fused_bvh(dense, org, d, 7, 6, spp_lanes=4)
    with pytest.raises(ValueError, match="trig"):
        pt_fused.render_fused(cornell, org, d, 7, 1, trig="fast")
    with pytest.raises(ValueError, match="not eligible"):
        pt_fused.render_fused(cornell._replace(face_table=None), org, d, 7, 1)
    with pytest.raises(ValueError, match="not eligible"):
        pt_fused.render_fused_bvh(cornell, org, d, 7, 1)
    assert not pt_fused.fused_eligible(dense)
    assert pt_fused.fused_bvh_eligible(dense)
    assert not pt_fused.fused_bvh_eligible(_tilted_normals(cornell))


# ------------------------------------------------------------ JAX side

def _jax_scene(z, job):
    """A duck-typed JAX PTScene from the port's arrays (the fields the
    fused routes read)."""
    import jax.numpy as jnp

    from nanort_tpu.models.path_tracer import Materials

    get = lambda k: jnp.asarray(z[f"{job}/{k}"]) if f"{job}/{k}" in z \
        else None
    ns = types.SimpleNamespace
    scene8 = None
    if f"{job}/nodes" in z:
        max_leaf, depth = (int(x) for x in z[f"{job}/s8"])
        scene8 = ns(nodes=get("nodes"), leafs=get("leafs"), max_leaf=max_leaf,
                    depth=depth, width=16)
    faces = get("faces")
    return ns(mesh=ns(vertices=get("vertices"), faces=faces,
                      num_faces=int(faces.shape[0])),
              materials=Materials(*(get(f"mat_{k}")
                                    for k in Materials._fields)),
              face_table=get("face_table"), light_table=get("light_table"),
              light_faces=get("light_faces"), fused_aux=get("fused_aux"),
              facevarying_normals=None, scene8=scene8)


def _jax_side(inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nanort_tpu.models import pt_fused as jpf

    z = dict(np.load(inp))
    res = {}
    for job, (_, _, seed, spp, kw) in JOBS.items():
        fn = jpf.render_fused_bvh if job.startswith("k4") else \
            jpf.render_fused
        res[job] = np.asarray(fn(_jax_scene(z, job), z[f"{job}/org"],
                                 z[f"{job}/dir"], seed, spp, **kw))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
