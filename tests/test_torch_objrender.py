"""PyTorch port, config A's renderer (``models/objrender.py``) and what
it brings along: ``refit_hits_watertight``, ``traverse_bvh8_exact_fused``
(``traverse/packet.py``) and the image writers (``utils/``).

The JAX references run under ``jax.disable_jit()``: jitted (and even
eagerly, ``jnp.cross`` being jitted inside), XLA on the CPU contracts
``a * b - c * d`` into FMAs. The two JAX renders, slow op by op, run
side by side in two child processes (``testing.run_without_fma``, whose
no-FMA setting does not matter under ``disable_jit``). Tolerances:
- ``face_normals``, ``build_onb``, ``aovs_from_hits``: bit-identical;
- ``render_ao`` on the stack engine (``scene8=None``) with the JAX
  package's hemisphere draws handed in: bit-identical AOVs and AO image,
  at 24^2 with 8 samples and 64^2 with 3 (the AO mean is a product with
  the rounded 1 / S, as XLA computes the division; for these S both
  forms agree);
- the K1 route (``scene8``, the kernel's plain version on the CPU)
  against the stack route: equal hit masks, the same prim except between
  hits at bit-equal t (the on-axis camera's diagonal pixels hit two
  triangles of a quad at equal t, and the two engines visit them in
  another order), t within 4 ulp, and AO pixels identical except at
  those ties (at least 97%, the JAX package's own bar);
- the 32 x 32 tile order of the occlusion megabatch (64^2) changes no
  AO bit against the same rays traced as a flat batch;
- ``refit_hits_watertight``: bit-identical records;
- ``encode_png``, ``save_ppm``, ``save_exr``: identical bytes.
"""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nanort_tpu as jnt
from nanort_tpu.models import objrender as jobj
from nanort_tpu.models.cameras import look_at as jlook_at
from nanort_tpu.models.cameras import pinhole_rays as jpinhole

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_uv_sphere, merge_meshes)
from nanort_tpu_torch.models import objrender
from nanort_tpu_torch.testing import compare_hits, run_without_fma
from nanort_tpu_torch.traverse import packet

torch.set_num_threads(1)

RENDERS = {"24_s8": (24, 8), "64_s3": (64, 3)}


@pytest.fixture(scope="module")
def scene():
    """The graft entry's scene (234 triangles), leaf 8, in both packages."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    jm = jnt.TriangleMesh(jnp.asarray(v), jnp.asarray(f))
    jbvh, _ = jnt.build_triangle_bvh(jm, jnt.BVHBuildOptions(
        min_leaf_primitives=8, max_leaf_primitives=8))
    bvh = interop.bvh_from_numpy(*(np.asarray(x) for x in jbvh))
    s8 = collapse_bvh8(bvh, v, f, width=16, woop=True).to("cpu")
    return nt.TriangleMesh(v, f), bvh, s8, jm, jbvh


def _cam(w):
    jr = jpinhole(jlook_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=w,
                           height=w, fov=45.0))
    return jr, interop.rays_from_numpy(*(np.asarray(x) for x in jr),
                                       device="cpu")


AOV_KEYS = ("rgb", "normal", "position", "depth", "texcoord", "prim_id",
            "hit", "ao")


@pytest.fixture(scope="module")
def renders(scene):
    """Render -> (port stack route, port K1 route, JAX (aovs, hits),
    draws, rays)."""
    mesh, bvh, s8, jm, jbvh = scene

    def jax_render(w, S):
        fields = {f"bvh{i}": np.asarray(x) for i, x in enumerate(jbvh)}
        return run_without_fma(__file__, {"v": mesh.vertices,
                                          "f": mesh.faces,
                                          "ws": np.array([w, S]), **fields})

    with concurrent.futures.ThreadPoolExecutor(len(RENDERS)) as ex:
        jobs = {k: ex.submit(jax_render, *ws) for k, ws in RENDERS.items()}
        done = {k: j.result() for k, j in jobs.items()}
    out = {}
    for name, (w, S) in RENDERS.items():
        z = done[name]
        _, rays = _cam(w)
        draws = torch.from_numpy(z["draws"])
        want = ({k: z[k] for k in AOV_KEYS},
                jnt.Hits(z["t"], z["u"], z["v"], z["pid"]))
        got = objrender.render_ao(bvh, mesh, rays, n_samples=S, max_leaf=8,
                                  draws=draws)
        k1 = objrender.render_ao(bvh, mesh, rays, n_samples=S, max_leaf=8,
                                 draws=draws, scene8=s8)
        out[name] = (got, k1, want, draws, rays)
    return out


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    return got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("render", list(RENDERS))
def test_render_ao_stack_route_matches_jax(renders, render):
    (aovs, hits), _, (want, want_hits), _, _ = renders[render]
    assert set(aovs) == set(want) == set(AOV_KEYS)
    for k in want:
        assert _same(aovs[k], want[k]), k
    for g, w in zip(hits, want_hits):
        assert _same(g, w)
    ao, hit = aovs["ao"], aovs["hit"]
    assert 0.3 < float(hit.float().mean()) < 1.0
    assert 0.0 < float(ao[hit].mean()) < 1.0 and (ao[~hit] == 0).all()


@pytest.mark.parametrize("render", list(RENDERS))
def test_render_ao_k1_route_under_tie_contract(renders, render):
    (aovs, hits), (k1, k1_hits), _, _, _ = renders[render]
    c = compare_hits(k1_hits, hits)
    assert c["ok"], c
    assert torch.equal(k1["hit"], aovs["hit"])
    ties = k1_hits.prim_id != hits.prim_id
    assert c["ties"] == int(ties.sum()) > 0
    # the AO differs only where the two engines picked tied prims
    diff = k1["ao"] != aovs["ao"]
    assert not (diff & ~ties).any()
    assert float((~diff).float().mean()) >= 0.97
    for k in ("depth", "position", "prim_id"):
        assert torch.equal(k1[k][~ties], aovs[k][~ties]), k


def test_occlusion_tile_order_is_a_permutation(scene, renders):
    """At 64^2 the K1 route orders the occlusion megabatch in 32 x 32
    tiles and scatters the AO sum back; the same rays as a flat batch
    (no tiling: the primary through traverse_bvh8_sorted) give the same
    AO bit for bit, the port's per-ray traversal being order-free."""
    mesh, bvh, s8, _, _ = scene
    _, (k1, _), _, draws, rays = renders["64_s3"]
    flat = nt.Rays(*(x.reshape(-1, *x.shape[2:]) for x in rays))
    ao, _ = objrender.render_ao(bvh, mesh, flat, n_samples=3, max_leaf=8,
                                draws=draws.reshape(3, -1, 3), scene8=s8)
    assert torch.equal(ao["ao"], k1["ao"].reshape(-1))


def test_aovs_from_hits_matches_jax(scene, renders):
    mesh, _, _, jm, _ = scene
    (_, hits), _, (_, want_hits), _, rays = renders["24_s8"]
    jr, _ = _cam(24)
    want_hits = jnt.Hits(*(jnp.asarray(x) for x in want_hits))
    with jax.disable_jit():
        want = jobj.aovs_from_hits(jm, None, jr, want_hits)
    got = objrender.aovs_from_hits(mesh, None, rays, hits)
    for k in want:
        assert _same(got[k], want[k]), k
    # render_aovs is the primary pass of render_ao
    aovs, h = objrender.render_aovs(scene[1], mesh, rays, max_leaf=8)
    assert all(torch.equal(a, b) for a, b in zip(h, hits))
    for k in aovs:
        assert torch.equal(aovs[k], got[k]), k


def test_face_normals_and_onb_match_jax(scene):
    mesh, _, _, jm, _ = scene
    F = mesh.faces.shape[0]
    fids = np.arange(F, dtype=np.uint32)
    with jax.disable_jit():
        want = jobj.face_normals(jm, jnp.asarray(fids))
    got = objrender.face_normals(
        nt.TriangleMesh(torch.from_numpy(mesh.vertices),
                        torch.from_numpy(mesh.faces)),
        torch.from_numpy(fids.astype(np.int64)))
    assert _same(got, want)
    rng = np.random.default_rng(4)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 0, 0], [0, 0, -1], [0, 0, 1], [1, 0, -0.0]]
    with jax.disable_jit():
        want_t, want_b = jobj.build_onb(jnp.asarray(n))
    got_t, got_b = objrender.build_onb(torch.from_numpy(n))
    assert _same(got_t, want_t) and _same(got_b, want_b)


def test_hemisphere_draws(scene):
    g = torch.Generator().manual_seed(5)
    d = objrender.ao_hemisphere_draws(g, 8, (16, 16))
    assert d.shape == (8, 16, 16, 3) and d.dtype == torch.float32
    assert torch.allclose(d.norm(dim=-1), torch.ones(()), atol=1e-6)
    assert bool((d[..., 2] >= 0).all())
    # stratified: sample s's azimuth lies in wedge s of 8
    phi = torch.atan2(d[..., 1], d[..., 0]) % (2 * np.pi)
    wedge = torch.floor(phi / (2 * np.pi / 8))
    s = torch.arange(8)[:, None, None].float()
    assert float((wedge == s).float().mean()) > 0.99
    # cosine-weighted: E[z] = 2/3
    assert abs(float(d[..., 2].mean()) - 2 / 3) < 0.02
    # a seed draws the same numbers as a generator seeded alike
    mesh, bvh, _, _, _ = scene
    _, rays = _cam(16)
    a, _ = objrender.render_ao(bvh, mesh, rays, seed=5, max_leaf=8)
    b, _ = objrender.render_ao(bvh, mesh, rays, max_leaf=8, draws=d)
    assert torch.equal(a["ao"], b["ao"])


def test_render_ao_checks_arguments(scene):
    mesh, bvh, s8, _, _ = scene
    _, rays = _cam(16)
    with pytest.raises(ValueError, match="sub"):
        objrender.render_ao(bvh, mesh, rays, 1, max_leaf=8, scene8=s8, sub=8)
    with pytest.raises(ValueError, match="seed or draws"):
        objrender.render_ao(bvh, mesh, rays, max_leaf=8)
    with pytest.raises(ValueError, match="draws must be"):
        objrender.render_ao(bvh, mesh, rays, max_leaf=8, n_samples=2,
                            draws=torch.zeros(8, 16, 16, 3))
    # octant_major sorts the megabatch; per-ray results do not move
    a, _ = objrender.render_ao(bvh, mesh, rays, 2, max_leaf=8, scene8=s8)
    b, _ = objrender.render_ao(bvh, mesh, rays, 2, max_leaf=8, scene8=s8,
                               octant_major=True)
    assert torch.equal(a["ao"], b["ao"])


def test_refit_hits_watertight_matches_jax(scene, renders):
    """Woop hits (K1-woop's plain version) refit to watertight records,
    against the JAX pass on the same hits."""
    from nanort_tpu.traverse.pallas_packet import refit_hits_watertight

    mesh, _, s8, jm, _ = scene
    _, _, _, _, rays = renders["64_s3"]
    flat = nt.Rays(*(x.reshape(-1, *x.shape[2:]).contiguous() for x in rays))
    woop = packet.traverse_bvh8(s8, flat, intersector="woop")
    got = packet.refit_hits_watertight(mesh, flat, woop)
    jr = jnt.Rays(*(jnp.asarray(x.numpy()) for x in flat))
    jh = jnt.Hits(*(jnp.asarray(x.numpy()) for x in woop[:3]),
                  jnp.asarray(woop.prim_id.numpy().astype(np.uint32)))
    with jax.disable_jit():
        want = refit_hits_watertight(jm, jr, jh)
    for g, w in zip(got, want):
        assert _same(g, w)
    # the refit records are the watertight test's on the same prims
    wt = packet.traverse_bvh8(s8, flat)
    same = (wt.prim_id == woop.prim_id) & wt.hit
    assert int(same.sum()) > 0.9 * int(wt.hit.sum())
    assert torch.equal(got.t[same], wt.t[same])
    assert not torch.equal(woop.t[same], wt.t[same])


def test_exact_fused_is_traverse_bvh8(scene, renders):
    _, _, s8, _, _ = scene
    _, _, _, _, rays = renders["24_s8"]
    hits, overflow = packet.traverse_bvh8_exact_fused(s8, rays)
    assert overflow.dtype == torch.bool and not bool(overflow)
    want = packet.traverse_bvh8(s8, rays)
    assert all(torch.equal(a, b) for a, b in zip(hits, want))
    with pytest.raises(ValueError, match="exact_edge_fallback"):
        packet.traverse_bvh8_exact_fused(
            s8, rays, nt.BVHTraceOptions(exact_edge_fallback=False))


def test_image_writers_match_jax(renders, tmp_path):
    from nanort_tpu.utils import exr as jexr
    from nanort_tpu.utils import image as jimage

    from nanort_tpu_torch.utils import exr, image

    (aovs, _), _, _, _, _ = renders["24_s8"]
    img = aovs["rgb"].numpy()
    assert image.encode_png(img) == jimage.encode_png(img)
    assert image.encode_png(img[..., 0]) == jimage.encode_png(img[..., 0])
    for mod, name in ((image, "a"), (jimage, "b")):
        mod.save_ppm(str(tmp_path / f"{name}.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    exr.save_exr(str(tmp_path / "a.exr"), img)
    jexr.save_exr(str(tmp_path / "b.exr"), img)
    assert (tmp_path / "a.exr").read_bytes() == (tmp_path / "b.exr").read_bytes()
    assert np.array_equal(exr.load_exr(str(tmp_path / "a.exr")), img)


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    z = dict(np.load(inp))
    w, S = (int(x) for x in z["ws"])
    jm = jnt.TriangleMesh(jnp.asarray(z["v"]), jnp.asarray(z["f"]))
    jbvh = jnt.BVH(*(np.asarray(z[f"bvh{i}"]) for i in range(6)))
    jr, _ = _cam(w)
    key = jax.random.PRNGKey(7)
    res = {"draws": np.asarray(jobj.ao_hemisphere_draws(
        key, S, (w, w), jnp.float32))}
    with jax.disable_jit():
        aovs, hits = jobj.render_ao(jbvh, jm, jr, key, n_samples=S,
                                    max_leaf=8)
    res.update({k: np.asarray(aovs[k]) for k in AOV_KEYS})
    res.update(t=np.asarray(hits.t), u=np.asarray(hits.u),
               v=np.asarray(hits.v), pid=np.asarray(hits.prim_id))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
