"""PyTorch port, the path tracer's fused route (config B) end to end:
``models/path_tracer.py`` against the JAX package's, plus the host code
it stands on (``traverse/packed.py``, ``io/obj.py``,
``interop.pt_scene_from_numpy``).

- Host tables: ``make_pt_scene`` in both packages on the 32-triangle
  Cornell box and on a ~2K-triangle dense scene, and ``pack_scene``,
  ``pack_scene_multi`` and ``load_obj``: bit-identical arrays.
- ``render_path_traced``: the JAX package builds its own ``PTScene`` and
  renders with ``fused=True`` and ``PRNGKey(3)`` in interpret mode, in a
  child process without FMA instructions (``testing.run_without_fma``).
  The port rebuilds that scene from its arrays with
  ``interop.pt_scene_from_numpy`` and renders with ``seed=3``. Both run
  ``trig="poly"`` (the routers' default ``"native"`` cos/sin differ
  between torch's and XLA's CPU libm in the last ulp): bit-identical
  images. The BVH route renders a 32 x 128 image, so the 32 x 128 tile
  permutation and the default ``spp_lanes`` (2 at spp 4 with 2 strata)
  run; its camera is off-axis, so no primary ray meets a shared edge at
  exactly equal t (the port's per-ray child order may resolve such a tie
  to the other prim, the repository's tie contract). One brute render
  keeps ``"native"``: at least 80% identical pixels (measured 96.7%)
  and image means within 2%.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from nanort_tpu_torch import interop
from nanort_tpu_torch.io import obj as port_obj
from nanort_tpu_torch.io.procedural import (
    make_cornell_dense_pt_scene, make_cornell_pt_scene, make_uv_sphere)
from nanort_tpu_torch.models import path_tracer, pt_fused
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.testing import run_without_fma

torch.set_num_threads(1)

SCENE_ARGS = {"cornell": (make_cornell_pt_scene, 2.0),
              "dense": (make_cornell_dense_pt_scene, 2000)}
# job -> (scene, (width, height, eye), spp, max_bounces, router kwargs, trig)
JOBS = {
    "brute_poly": ("cornell", (12, 10, (0, 0.0, 5.0)), 4, 5, {}, "poly"),
    "brute_native": ("cornell", (12, 10, (0, 0.0, 5.0)), 4, 4, {}, "native"),
    "bvh_tiles": ("dense", (128, 32, (0.0123, 0.0371, 2.6)), 4, 3,
                  {"azimuth_strata": 2}, "poly"),
}


def _tables(s):
    """Every host table of a PTScene (either package's) as NumPy arrays."""
    out = {"vertices": s.mesh.vertices, "faces": s.mesh.faces,
           "material_ids": s.material_ids, "light_faces": s.light_faces,
           "face_table": s.face_table, "light_table": s.light_table,
           "packed_nodes": s.packed.nodes, "packed_soup": s.packed.soup}
    for k in path_tracer.Materials._fields:
        out[f"mat_{k}"] = getattr(s.materials, k)
    if s.scene8 is not None:
        out["nodes"], out["leafs"] = s.scene8.nodes, s.scene8.leafs
        out["aux"] = s.fused_aux
        out["s8"] = [s.scene8.num_nodes, s.scene8.num_leaf_rows,
                     s.scene8.depth, s.scene8.max_leaf, s.scene8.width]
    out["sizes"] = [s.packed.num_nodes, s.packed.num_prims]
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same_tables(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", ["cornell", "dense"])
def test_make_pt_scene_tables_match_jax(name):
    from nanort_tpu.io import procedural as jproc
    from nanort_tpu.models import path_tracer as jpt

    make, arg = SCENE_ARGS[name]
    engine = "pallas" if name == "dense" else "wavefront"
    port = path_tracer.make_pt_scene(*make(arg), engine=engine, device="cpu")
    want = jpt.make_pt_scene(*getattr(jproc, make.__name__)(arg),
                             engine=engine)
    _assert_same_tables(_tables(port), _tables(want))
    assert (port.scene8 is None) == (name == "cornell")
    assert pt_fused.fused_eligible(port) == (name == "cornell")
    assert pt_fused.fused_bvh_eligible(port) == (name == "dense")


def test_pack_scene_and_multi_match_jax():
    import nanort_tpu as jnrt
    from nanort_tpu.traverse import packed as jpacked

    import nanort_tpu_torch as nt
    from nanort_tpu_torch.ops.triangle import TriangleMesh
    from nanort_tpu_torch.traverse import packed as ppacked

    items, jitems = [], []
    for k, (v, f) in enumerate([make_uv_sphere(12, 16, 1.0),
                                make_uv_sphere(6, 8, 0.5)]):
        v = v + np.float32(k)
        items.append((nt.build_triangle_bvh(TriangleMesh(v, f))[0], v, f))
        jitems.append((jnrt.build_triangle_bvh(jnrt.TriangleMesh(v, f))[0],
                       v, f))
    a, b = ppacked.pack_scene(*items[0]), jpacked.pack_scene(*jitems[0])
    assert a.nodes.tobytes() == b.nodes.tobytes()
    assert a.soup.tobytes() == b.soup.tobytes()
    assert (a.num_nodes, a.num_prims, a.max_leaf) == (
        b.num_nodes, b.num_prims, b.max_leaf)
    (a, ra), (b, rb) = (ppacked.pack_scene_multi(items),
                        jpacked.pack_scene_multi(jitems))
    assert a.nodes.tobytes() == b.nodes.tobytes()
    assert a.soup.tobytes() == b.soup.tobytes()
    assert ra.tolist() == rb.tolist() == [0, items[0][0].bmin.shape[0]]
    assert (a.num_nodes, a.num_prims, a.max_leaf) == (
        b.num_nodes, b.num_prims, b.max_leaf)


OBJ_TEXT = """\
mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 1 1
o lightobj
usemtl Light
f 1/1/1 2/2/1 3/3/1 4/3/1
g left_wall
usemtl White
f -1/1/2 -2/2/2 -3/3/2
usemtl Unknown
f 1//1 3//1 5//1
"""

MTL_TEXT = """\
newmtl Light
Kd 0 0 0
Ke 15 15 15
newmtl White
Kd 0.8 0.8 0.8
Ks 0.1 0.2 0.3
Tf 0.5 0.5 0.5
Ni 1.5
d 0.25
"""


def test_obj_round_trip_and_parse_match_jax(tmp_path):
    from nanort_tpu.io import obj as jobj

    v, f = make_uv_sphere(5, 7, 1.0)
    path = str(tmp_path / "sphere.obj")
    port_obj.save_obj(path, v, f)
    m = port_obj.load_obj(path)
    np.testing.assert_array_equal(m.vertices, v)
    np.testing.assert_array_equal(m.faces, f)
    assert m.facevarying_normals is None and m.facevarying_uvs is None
    assert (m.material_ids == 0).all()

    (tmp_path / "box.obj").write_text(OBJ_TEXT)
    (tmp_path / "box.mtl").write_text(MTL_TEXT)
    got = port_obj.load_obj(str(tmp_path / "box.obj"))
    want = jobj.load_obj(str(tmp_path / "box.obj"))
    assert got.faces.tolist() == [[0, 1, 2], [0, 2, 3], [4, 3, 2], [0, 2, 4]]
    assert got.material_ids.tolist() == [0, 0, 1, 2]
    assert got.object_names == want.object_names == ("lightobj", "left_wall")
    assert got.materials["dissolve"].tolist() == [0.0, 0.75, 0.0]
    remapped = (port_obj.remap_materials_by_object(
        got, port_obj.CORNELL_GROUP_MATERIALS),
        jobj.remap_materials_by_object(want, jobj.CORNELL_GROUP_MATERIALS))
    for a, b in ((got, want), remapped):
        for k in ("vertices", "faces", "facevarying_normals",
                  "facevarying_uvs", "material_ids", "object_ids"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        assert sorted(a.materials) == sorted(b.materials)
        for k in a.materials:
            assert a.materials[k].tobytes() == b.materials[k].tobytes(), k


def test_router_defaults_and_refusals():
    assert path_tracer.default_azimuth_strata(100) == 4
    assert path_tracer.default_azimuth_strata(9) == 3
    assert path_tracer.default_spp_lanes(100, 4) == 25
    assert path_tracer.default_spp_lanes(4, 2) == 2
    assert path_tracer.default_spp_lanes(4, 4) == 1
    scene = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                      device="cpu")
    rays = pinhole_rays(look_at(eye=(0, 0, 5.0), center=(0, 0, 0), width=4,
                                height=4, device="cpu"))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(path_tracer, "render_megabatch", _recording(
            path_tracer.render_megabatch, calls))
        # fused=False renders, on the megabatch route
        img = path_tracer.render_path_traced(scene, rays, 3, spp=1,
                                             max_bounces=3, fused=False)
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        assert len(calls) == 1
        # a scene neither fused kernel takes falls to the megabatch route
        big = path_tracer.make_pt_scene(*make_cornell_dense_pt_scene(600),
                                        device="cpu")
        assert big.mesh.faces.shape[0] > path_tracer.BRUTE_MAX_TRIS
        assert not (pt_fused.fused_eligible(big)
                    or pt_fused.fused_bvh_eligible(big))
        img = path_tracer.render_path_traced(big, rays, 3, spp=1,
                                             max_bounces=3)
        assert len(calls) == 2 and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="neither fused kernel"):
        path_tracer.render_path_traced(big, rays, 3, spp=1, fused=True)
    # engine="turbo" builds leaf-9 BVH16 tables with their Woop table
    turbo = path_tracer.make_pt_scene(*make_cornell_dense_pt_scene(600),
                                      engine="turbo", device="cpu")
    s8 = turbo.scene8
    assert s8.leafs_woop is not None and s8.max_leaf <= 9
    assert s8.leafs_woop.shape == s8.leafs.shape
    assert pt_fused.fused_bvh_eligible(turbo)
    with pytest.raises(ValueError, match="unknown engine"):
        path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                  engine="woop", device="cpu")


def _recording(fn, calls):
    def wrapped(*a, **k):
        calls.append(k)
        return fn(*a, **k)

    return wrapped


def _cam_rays(w, h, eye):
    return pinhole_rays(look_at(eye=eye, center=(0, 0, 0), width=w,
                                height=h, fov=45.0, device="cpu"))


@pytest.fixture(scope="module")
def rendered():
    """{job: (port image, JAX image)}: the JAX scenes and renders come
    from one child process, the port renders from those scenes."""
    inputs = {}
    for job, (_, cam, *_rest) in JOBS.items():
        r = _cam_rays(*cam)
        inputs[f"{job}/org"], inputs[f"{job}/dir"] = r.org.numpy(), \
            r.dir.numpy()
    out = run_without_fma(__file__, inputs)
    res = {}
    for job, (name, cam, spp, mb, kw, trig) in JOBS.items():
        z = {k.split("/", 1)[1]: v for k, v in out.items()
             if k.startswith(f"{name}/")}
        scene = _port_scene_from(z)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pt_fused, "render_fused", functools.partial(
                pt_fused.render_fused, trig=trig))
            mp.setattr(pt_fused, "render_fused_bvh", functools.partial(
                pt_fused.render_fused_bvh, trig=trig))
            img = path_tracer.render_path_traced(
                scene, _cam_rays(*cam), 3, spp=spp, max_bounces=mb, **kw)
        res[job] = (img.numpy(), out[f"{job}/img"])
    return res


def _port_scene_from(z):
    """The port's PTScene from a JAX scene's arrays (``_tables``)."""
    scene8 = None
    if "nodes" in z:
        n_nodes, n_rows, depth, max_leaf, width = (int(x) for x in z["s8"])
        scene8 = interop.scene_from_numpy(z["nodes"], z["leafs"], n_nodes,
                                          n_rows, depth, max_leaf, width)
    return interop.pt_scene_from_numpy(
        z["vertices"], z["faces"], z["material_ids"],
        [z[f"mat_{k}"] for k in path_tracer.Materials._fields],
        z["light_faces"],
        (z["packed_nodes"], z["packed_soup"], *z["sizes"], None),
        face_table=z["face_table"], light_table=z["light_table"],
        scene8=scene8, fused_aux=z.get("aux"), device="cpu")


@pytest.mark.parametrize("job", ["brute_poly", "bvh_tiles"])
def test_render_path_traced_matches_jax(rendered, job):
    got, want = rendered[job]
    w, h = JOBS[job][1][:2]
    assert got.shape == want.shape == (h, w, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, want)


def test_render_path_traced_native_trig_statistically(rendered):
    got, want = rendered["brute_native"]
    same = (got == want).all(-1).mean()
    assert same > 0.8, same
    assert abs(got.mean() - want.mean()) < 0.02 * want.mean()


def test_pt_scene_from_numpy_round_trip():
    """The carried scene holds the same tables as the port's own build
    and keeps every tensor's dtype."""
    port = path_tracer.make_pt_scene(*make_cornell_dense_pt_scene(2000),
                                     engine="pallas", device="cpu")
    z = _tables(port)
    carried = _port_scene_from(z)
    _assert_same_tables(_tables(carried), z)
    assert carried.material_ids.dtype == carried.mesh.faces.dtype \
        == torch.int32
    assert carried.packed.max_leaf is None and carried.facevarying_normals \
        is None


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nanort_tpu.core.ray import Rays
    from nanort_tpu.io import procedural as jproc
    from nanort_tpu.models import path_tracer as jpt
    from nanort_tpu.models import pt_fused as jpf

    z = dict(np.load(inp))
    res, scenes = {}, {}
    for name, (make, arg) in SCENE_ARGS.items():
        scenes[name] = jpt.make_pt_scene(
            *getattr(jproc, make.__name__)(arg),
            engine="pallas" if name == "dense" else "wavefront")
        for k, v in _tables(scenes[name]).items():
            res[f"{name}/{k}"] = v
    plain = jpf.render_fused, jpf.render_fused_bvh
    for job, (name, _, spp, mb, kw, trig) in JOBS.items():
        jpf.render_fused = functools.partial(plain[0], trig=trig)
        jpf.render_fused_bvh = functools.partial(plain[1], trig=trig)
        org = jnp.asarray(z[f"{job}/org"])
        rays = Rays(org, jnp.asarray(z[f"{job}/dir"]),
                    jnp.zeros(org.shape[:-1], jnp.float32),
                    jnp.full(org.shape[:-1], 1e30, jnp.float32))
        res[f"{job}/img"] = np.asarray(jpt.render_path_traced(
            scenes[name], rays, jax.random.PRNGKey(3), spp=spp,
            max_bounces=mb, fused=True, **kw))
    np.savez(out, **res)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
