"""PyTorch port, the path tracer's per-bounce megabatch route
(``models/path_tracer.py``: ``trace_paths``, ``_trace``,
``_sample_light``, the shading helpers, ``render_megabatch`` and the
router).

- ``trace_paths`` against the JAX package's, with the JAX package's own
  random numbers passed in (``draws``: ``jax.random.uniform(fold_in(
  fold_in(key, b), 9), (R, 6))`` for bounce b). The JAX side builds its
  scenes and runs its jitted ``trace_paths`` in a child process held to
  AVX (``testing.run_without_fma``: no FMA contraction); the port
  rebuilds those scenes from their arrays. Three jobs: the brute route
  on the 32-triangle Cornell box, the same box with tilted vertex
  normals (26-column face table, ``has_normals``), and the wavefront
  route on ``make_cornell_dense_pt_scene(600)`` (540 triangles). The
  port computes cos/sin in float64 and rounds once, where XLA's CPU
  float32 cos/sin differ from that in the last ulp on ~1.3% of inputs,
  so a few paths leave in a direction one ulp apart. Measured at 16 x 16
  rays x 5 bounces: 99.2% of rays bit-identical on the brute route,
  100% with vertex normals, 98.0% on the wavefront route; max abs
  difference 1.8e-7. Tolerance: at least 90% of rays bit-identical, 99%
  within 1e-5, the mean within a relative 1e-4.
- Engines against each other, port only, the same draws on the same
  rays: ``"pallas"`` (K1's plain version through the ray sort) against
  ``"wavefront"``: rays equal except where an equal-t tie changes a
  path (at least 98% bit-identical; measured 100%); ``"turbo"`` (the
  Woop leaf test) against ``"pallas"``: means within 1% (the Woop test
  moves t and u/v by ulps: 37% of rays bit-identical, means 3e-7
  apart).
- The shading without face and light tables (scenes above
  ``FACE_TABLE_MAX_TRIS`` read per-field gathers) equals the shading
  with them, bit for bit, with and without vertex normals.
- The router and ``render_megabatch``: megabatches split spp
  (``_auto_spp_batch``), equal seeds give equal images, and the entry
  points default to the card.
"""

import inspect
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch import interop
from nanort_tpu_torch.core.ray import make_rays
from nanort_tpu_torch.io.procedural import (make_cornell_dense_pt_scene,
                                            make_cornell_pt_scene)
from nanort_tpu_torch.models import cameras, path_tracer
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)

MB = 5
# job -> (scene maker, argument, eye z, tilted vertex normals)
JOBS = {
    "brute": ("make_cornell_pt_scene", 2.0, 5.0, False),
    "brute_normals": ("make_cornell_pt_scene", 2.0, 5.0, True),
    "wavefront": ("make_cornell_dense_pt_scene", 600, 2.6, False),
}


def _cam(eye_z, w=16, h=16):
    r = cameras.pinhole_rays(cameras.look_at(
        eye=(0.01, 0.02, eye_z), center=(0, 0, 0), width=w, height=h,
        fov=45.0, device="cpu"))
    return r.org.reshape(-1, 3), r.dir.reshape(-1, 3)


def _tilted_normals(n_faces):
    rng = np.random.default_rng(4)
    return rng.normal(0, 0.3, (n_faces, 3, 3)).astype(np.float32)


def _tables(s):
    out = {"vertices": s.mesh.vertices, "faces": s.mesh.faces,
           "material_ids": s.material_ids, "light_faces": s.light_faces,
           "face_table": s.face_table, "light_table": s.light_table,
           "packed_nodes": s.packed.nodes, "packed_soup": s.packed.soup,
           "sizes": [s.packed.num_nodes, s.packed.num_prims]}
    for k in path_tracer.Materials._fields:
        out[f"mat_{k}"] = getattr(s.materials, k)
    if s.facevarying_normals is not None:
        out["fvn"] = s.facevarying_normals
    return {k: np.asarray(v) for k, v in out.items()}


def _port_scene(z):
    return interop.pt_scene_from_numpy(
        z["vertices"], z["faces"], z["material_ids"],
        [z[f"mat_{k}"] for k in path_tracer.Materials._fields],
        z["light_faces"],
        (z["packed_nodes"], z["packed_soup"], *z["sizes"], None),
        face_table=z["face_table"], light_table=z["light_table"],
        facevarying_normals=z.get("fvn"), device="cpu")


@pytest.fixture(scope="module")
def traced():
    """{job: (port radiance, JAX radiance)} from one child process."""
    inputs = {}
    for job, (_, _, eye_z, _) in JOBS.items():
        org, d = _cam(eye_z)
        inputs[f"{job}/org"], inputs[f"{job}/dir"] = org.numpy(), d.numpy()
    out = run_without_fma(__file__, inputs)
    res = {}
    for job, (_, _, _, normals) in JOBS.items():
        z = {k.split("/", 1)[1]: v for k, v in out.items()
             if k.startswith(f"{job}/")}
        scene = _port_scene(z)
        assert (scene.facevarying_normals is not None) == normals
        col = path_tracer.trace_paths(
            scene, torch.from_numpy(inputs[f"{job}/org"]),
            torch.from_numpy(inputs[f"{job}/dir"]), max_bounces=MB,
            has_normals=normals, draws=torch.from_numpy(z["draws"]))
        res[job] = (col.numpy(), z["col"])
    return res


@pytest.mark.parametrize("job", list(JOBS))
def test_trace_paths_matches_jax(traced, job):
    got, want = traced[job]
    assert got.shape == want.shape == (256, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    same = (got == want).all(1).mean()
    close = (np.abs(got - want) <= 1e-5).all(1).mean()
    assert same >= 0.9, same
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


@pytest.fixture(scope="module")
def engines():
    """{engine: radiance} of the port on the dense scene, one set of
    draws."""
    v, f, m, mats = make_cornell_dense_pt_scene(600)
    org, d = _cam(2.6)
    draws = torch.from_numpy(np.random.default_rng(8).uniform(
        size=(MB, org.shape[0], 6)).astype(np.float32))
    res = {}
    for engine in path_tracer.ENGINES:
        scene = path_tracer.make_pt_scene(v, f, m, mats, engine=engine,
                                          device="cpu")
        assert (scene.scene8 is None) == (engine == "wavefront")
        res[engine] = path_tracer.trace_paths(
            scene, org, d, max_bounces=MB, has_normals=False,
            draws=draws).numpy()
    return res


@pytest.mark.parametrize("pair", [("pallas", "wavefront"),
                                  ("turbo", "pallas")])
def test_engines_agree(engines, pair):
    a, b = engines[pair[0]], engines[pair[1]]
    assert np.isfinite(a).all() and a.mean() > 0
    if pair[0] == "pallas":
        assert (a == b).all(1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


@pytest.mark.parametrize("normals", [False, True])
def test_trace_paths_without_tables_matches_tables(normals):
    """Scenes above FACE_TABLE_MAX_TRIS carry no face or light table and
    shade from per-field gathers; the tables hold the same values, so
    the two must give the same radiance."""
    v, f, m, mats = make_cornell_pt_scene(2.0)
    fvn = _tilted_normals(f.shape[0]) if normals else None
    scene = path_tracer.make_pt_scene(v, f, m, mats, facevarying_normals=fvn,
                                      device="cpu")
    bare = scene._replace(face_table=None, light_table=None)
    org, d = _cam(5.0)
    draws = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(MB, org.shape[0], 6)).astype(np.float32))
    a, b = (path_tracer.trace_paths(s, org, d, max_bounces=MB,
                                    has_normals=normals, draws=draws)
            for s in (scene, bare))
    assert float(a.mean()) > 0
    assert torch.equal(a, b)


def test_render_megabatch_batches_and_seeds(monkeypatch):
    assert path_tracer._auto_spp_batch(100, 262_144) == 25
    assert path_tracer._auto_spp_batch(16, 262_144) == 16
    assert path_tracer._auto_spp_batch(7, 5_000_000) == 1
    scene = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                      device="cpu")
    org, d = _cam(5.0, 6, 4)
    sizes = []
    real = path_tracer.trace_paths

    def spy(sc, o, dd, gen, **kw):
        sizes.append(o.shape[0])
        return real(sc, o, dd, gen, **kw)

    monkeypatch.setattr(path_tracer, "trace_paths", spy)
    a = path_tracer.render_megabatch(scene, org, d, 7, 5, max_bounces=3,
                                     spp_batch=2)
    assert sizes == [48, 48, 24]
    b = path_tracer.render_megabatch(scene, org, d, 7, 5, max_bounces=3,
                                     spp_batch=2)
    c = path_tracer.render_megabatch(scene, org, d, 8, 5, max_bounces=3,
                                     spp_batch=2)
    assert a.shape == (24, 3) and torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator or draws"):
        real(scene, org, d)
    with pytest.raises(ValueError, match="draws"):
        real(scene, org, d, draws=torch.zeros(2, 24, 6), max_bounces=3)


def test_entry_points_default_to_the_card():
    from nanort_tpu_torch.interop import pt_scene_from_numpy, rays_from_numpy

    for fn in (path_tracer.make_pt_scene, cameras.look_at,
               pt_scene_from_numpy, rays_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # make_rays follows its inputs
    r = make_rays(torch.zeros(2, 3), torch.ones(2, 3))
    assert r.org.device.type == r.max_t.device.type == "cpu"


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from nanort_tpu.io import procedural as jproc
    from nanort_tpu.models import path_tracer as jpt

    z = dict(np.load(inp))
    res = {}
    key = jax.random.PRNGKey(5)
    for job, (make, arg, _, normals) in JOBS.items():
        v, f, m, mats = getattr(jproc, make)(arg)
        fvn = _tilted_normals(f.shape[0]) if normals else None
        scene = jpt.make_pt_scene(v, f, m, mats, facevarying_normals=fvn)
        org = jnp.asarray(z[f"{job}/org"])
        R = org.shape[0]
        res[f"{job}/draws"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, b), 9), (R, 6),
            jnp.float32)) for b in range(MB)])
        res[f"{job}/col"] = np.asarray(jpt.trace_paths(
            scene, org, jnp.asarray(z[f"{job}/dir"]), key, max_bounces=MB,
            has_normals=normals))
        for k, x in _tables(scene).items():
            res[f"{job}/{k}"] = x
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
