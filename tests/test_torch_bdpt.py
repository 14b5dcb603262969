"""PyTorch port, the bidirectional path tracer (``models/bdpt.py``)
against the JAX package, on the JAX package's own random numbers.

The JAX ``trace_bdpt`` runs jitted in child processes held to AVX
(``testing.run_without_fma``: no FMA contraction), two side by side. It
also saves each uniform it draws, keyed by its fold-in path
(``bdpt.draw_paths``); the port's ``trace_bdpt`` takes them through
``draws=``. Scenes: the Cornell box with its mirror and glass (delta
lobes), the same box with tilted vertex normals, and the dense Cornell
scene of 540 triangles (the wavefront walk); 16 x 16 camera rays, 3 eye
and 2 light bounces. Tolerances: the port takes cos and sin in float64
and rounds once, where XLA's float32 ones differ in the last ulp on a
few inputs, so a few paths leave in a direction an ulp apart: at least
90% of rays bit-identical, 99% within 1e-4 absolute, the mean within a
relative 1e-4 (measured: 99.2%, 100% and 98.0% of rays bit-identical on
the three scenes, the largest difference 6e-8, the means equal); the
light sampler's CDF and total area identical.

Port only: the BVH16 route (K1's plain version through the ray sort)
against the wavefront route on the same draws (at least 98% of rays
bit-identical: equal-t ties may part; measured 100%), a generator's draws (equal seeds
give equal images), and ``render_bdpt`` against ``render_path_traced`` on
a diffuse-only box (both unbiased: means within 25%, per-pixel
correlation above 0.9, the JAX package's own bar).
"""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch.io.procedural import (make_cornell_dense_pt_scene,
                                            make_cornell_pt_scene)
from nanort_tpu_torch.models import bdpt, cameras, path_tracer
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)

EB, LB = 3, 2
# job -> (scene maker, argument, eye z, tilted vertex normals)
JOBS = {
    "box": ("make_cornell_pt_scene", 2.0, 5.0, False),
    "box_normals": ("make_cornell_pt_scene", 2.0, 5.0, True),
    "dense": ("make_cornell_dense_pt_scene", 600, 2.6, False),
}
CHILDREN = (("box", "box_normals"), ("dense",))


def _cam(eye_z, w=16, h=16):
    r = cameras.pinhole_rays(cameras.look_at(
        eye=(0.01, 0.02, eye_z), center=(0, 0, 0), width=w, height=h,
        fov=45.0, device="cpu"))
    return r.org.reshape(-1, 3), r.dir.reshape(-1, 3)


def _tilted_normals(n_faces):
    rng = np.random.default_rng(4)
    n = rng.normal(0, 0.3, (n_faces, 3, 3)) + [0.0, 1.0, 0.0]
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _arrays(job):
    make, arg, _, normals = JOBS[job]
    v, f, m, mats = {"make_cornell_pt_scene": make_cornell_pt_scene,
                     "make_cornell_dense_pt_scene":
                     make_cornell_dense_pt_scene}[make](arg)
    return v, f, m, mats, (_tilted_normals(len(f)) if normals else None)


def _port_scene(job, engine="wavefront"):
    v, f, m, mats, fvn = _arrays(job)
    return path_tracer.make_pt_scene(v, f, m, mats, facevarying_normals=fvn,
                                     engine=engine, device="cpu")


@pytest.fixture(scope="module")
def jax_side():
    inputs = {}
    for job, (_, _, eye_z, _) in JOBS.items():
        org, d = _cam(eye_z)
        inputs[f"{job}/org"], inputs[f"{job}/dir"] = org.numpy(), d.numpy()
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(CHILDREN)) as ex:
        futs = [ex.submit(run_without_fma, __file__, {
            **{k: x for k, x in inputs.items() if k.split("/")[0] in jobs},
            "jobs": np.array(jobs)}) for jobs in CHILDREN]
        for fu in futs:
            out.update(fu.result())
    return inputs, out


def _draws(out, job):
    return {p: torch.from_numpy(out[f"{job}/draw/{p}"])
            for p in bdpt.draw_paths(EB, LB)}


def _port_color(scene, inputs, job, draws):
    cdf, total = bdpt._light_sampler_arrays(scene)
    return bdpt.trace_bdpt(
        scene, torch.from_numpy(inputs[f"{job}/org"]),
        torch.from_numpy(inputs[f"{job}/dir"]), cdf, None, total,
        eye_bounces=EB, light_bounces=LB,
        has_normals=scene.facevarying_normals is not None, draws=draws)


@pytest.mark.parametrize("job", list(JOBS))
def test_light_sampler_matches_jax(jax_side, job):
    _, out = jax_side
    cdf, total = bdpt._light_sampler_arrays(_port_scene(job))
    np.testing.assert_array_equal(cdf.numpy(), out[f"{job}/cdf"])
    assert total == float(out[f"{job}/total"])


@pytest.mark.parametrize("job", list(JOBS))
def test_trace_bdpt_matches_jax(jax_side, job):
    inputs, out = jax_side
    got = _port_color(_port_scene(job), inputs, job, _draws(out, job)).numpy()
    want = out[f"{job}/col"]
    assert got.shape == want.shape == (256, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    same = (got == want).all(1).mean()
    close = (np.abs(got - want) <= 1e-4).all(1).mean()
    assert same >= 0.9, same
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


def test_bvh16_route_matches_wavefront(jax_side):
    inputs, out = jax_side
    draws = _draws(out, "dense")
    a = _port_color(_port_scene("dense", "pallas"), inputs, "dense", draws)
    b = _port_color(_port_scene("dense"), inputs, "dense", draws)
    assert (a == b).all(1).float().mean() >= 0.98
    assert float(a.mean()) > 0


def test_generator_draws_and_errors():
    scene = _port_scene("box")
    cdf, total = bdpt._light_sampler_arrays(scene)
    org, d = _cam(5.0, 6, 4)
    run = lambda s: bdpt.trace_bdpt(scene, org, d, cdf, s, total,
                                    eye_bounces=EB, light_bounces=LB)
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(run(g), a)
    with pytest.raises(ValueError, match="seed"):
        bdpt.trace_bdpt(scene, org, d, cdf, None, total)
    with pytest.raises(ValueError, match="draws lacks"):
        bdpt.trace_bdpt(scene, org, d, cdf, None, total, draws={"1/100": 0})
    assert len(bdpt.draw_paths(EB, LB)) == 5 + 3 * (EB + LB)


def test_render_bdpt_matches_forward_pt():
    v, f, m, mats = make_cornell_pt_scene()
    mats = dict(mats)
    for k in ("specular", "transmittance", "dissolve"):
        mats[k] = np.zeros_like(mats[k])
    scene = path_tracer.make_pt_scene(v, f, m, mats, device="cpu")
    rays = cameras.pinhole_rays(cameras.look_at(
        (0, 0, 2.2), (0, 0, 0), width=12, height=12, fov=55, device="cpu"))
    img_bd = bdpt.render_bdpt(scene, rays, 1, spp=16, eye_bounces=4,
                              light_bounces=3).numpy()
    img_pt = path_tracer.render_path_traced(scene, rays, 7, spp=64,
                                            max_bounces=4).numpy()
    assert img_bd.shape == (12, 12, 3)
    assert np.isfinite(img_bd).all() and (img_bd >= 0).all()
    assert abs(img_bd.mean() - img_pt.mean()) / img_pt.mean() < 0.25
    assert np.corrcoef(img_pt.reshape(-1), img_bd.reshape(-1))[0, 1] > 0.9


# ------------------------------------------------------------ JAX side

def _fold(key, path):
    import jax

    for i in path.split("/"):
        key = jax.random.fold_in(key, int(i))
    return key


def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu.io import procedural as jproc
    from nanort_tpu.models import bdpt as jbdpt
    from nanort_tpu.models import path_tracer as jpt

    z = dict(np.load(inp))
    res = {}
    key = jax.random.PRNGKey(5)
    for job in z["jobs"]:
        make, arg, _, normals = JOBS[str(job)]
        v, f, m, mats = getattr(jproc, make)(arg)
        fvn = _tilted_normals(f.shape[0]) if normals else None
        scene = jpt.make_pt_scene(v, f, m, mats, facevarying_normals=fvn)
        cdf, total = jbdpt._light_sampler_arrays(scene)
        org = jnp.asarray(z[f"{job}/org"])
        R = org.shape[0]
        for p in bdpt.draw_paths(EB, LB):
            res[f"{job}/draw/{p}"] = np.asarray(jax.random.uniform(
                _fold(key, p), (R,), jnp.float32))
        res[f"{job}/col"] = np.asarray(jbdpt.trace_bdpt(
            scene, org, jnp.asarray(z[f"{job}/dir"]), cdf, key, total,
            eye_bounces=EB, light_bounces=LB, has_normals=normals))
        res[f"{job}/cdf"] = np.asarray(cdf)
        res[f"{job}/total"] = np.float64(total)
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
