"""PyTorch port, public names the JAX package exports from its root and
core modules: the ray-type bitmask, ``no_hits``, ``surface_area``,
``PrimitiveKind``, ``list_node_intersections`` and the root re-exports —
each against the JAX package on the same seeded NumPy inputs.
Tolerance: equal values and dtypes (prim and node ids are int64 in the
port, holding the JAX package's uint32 values); ``list_node_intersections``
runs the JAX side under ``jax.disable_jit()`` and must give the same ids
and the same t bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.core import math as j_math
from nanort_tpu.ops import protocol as j_protocol
from nanort_tpu.traverse import stack as j_stack
from nanort_tpu_torch.core import math as t_math
from nanort_tpu_torch.io.procedural import make_random_triangles
from nanort_tpu_torch.ops import protocol as t_protocol
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.traverse import stack as t_stack

torch.set_num_threads(1)

RAY_TYPES = ["RAY_TYPE_NONE", "RAY_TYPE_PRIMARY", "RAY_TYPE_SECONDARY",
             "RAY_TYPE_DIFFUSE", "RAY_TYPE_REFLECTION", "RAY_TYPE_REFRACTION"]


@pytest.mark.parametrize("name", RAY_TYPES)
def test_ray_type_constants_match(name):
    assert getattr(nt, name) == getattr(jrt, name)
    assert type(getattr(nt, name)) is int


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("init", [False, True])
def test_no_hits_matches(dtype, init):
    shape = (3, 5)
    init_t = (np.random.default_rng(1).uniform(0, 9, shape).astype(dtype)
              if init else None)
    want = jrt.no_hits(shape, jnp.dtype(dtype), init_t)
    got = nt.no_hits(shape, getattr(torch, dtype),
                     None if init_t is None else torch.from_numpy(init_t),
                     device="cpu")
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got[:3], want[:3]):
        assert a.numpy().dtype == np.asarray(b).dtype
    assert got.prim_id.dtype == nt.PRIM_ID_DTYPE
    assert not bool(got.hit.any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_surface_area_matches(dtype):
    rng = np.random.default_rng(4)
    lo = rng.normal(size=(257, 3)).astype(dtype)
    hi = lo + rng.uniform(0, 3, (257, 3)).astype(dtype)
    hi[0] = lo[0]  # a flat box
    want = np.asarray(j_math.surface_area(jnp.asarray(lo), jnp.asarray(hi)))
    got = t_math.surface_area(torch.from_numpy(lo), torch.from_numpy(hi))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_primitive_kind_fields_match():
    def fields(cls):
        return [(f.name, f.type) for f in dataclasses.fields(cls)]

    assert [n for n, _ in fields(t_protocol.PrimitiveKind)] == \
        [n for n, _ in fields(j_protocol.PrimitiveKind)]
    kind = t_protocol.PrimitiveKind("tri", len, None, None, None)
    assert kind == t_protocol.PrimitiveKind("tri", len, None, None, None)
    assert hash(kind) == hash(t_protocol.PrimitiveKind("tri", len, None,
                                                      None, None))
    with pytest.raises(dataclasses.FrozenInstanceError):
        kind.name = "other"


def _bvh_and_rays(n_rays, seed):
    """A multi-leaf binary BVH over seeded random triangles (one leaf per
    2 prims) and seeded rays through the scene, some with a zero
    direction component and some with a short max_t."""
    v, f = make_random_triangles(60, seed=seed)
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=2, max_leaf_primitives=2), use_native=False)
    rng = np.random.default_rng(seed + 1)
    org = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[::5, 1] = 0.0
    max_t = np.full(n_rays, np.finfo(np.float32).max, np.float32)
    max_t[3::7] = 0.5
    min_t = np.zeros(n_rays, np.float32)
    return bvh, (org, d, min_t, max_t)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_list_node_intersections_matches_jax(k):
    bvh, arrays = _bvh_and_rays(301, 3)
    assert int((np.asarray(bvh.flag) == 1).sum()) > 8
    with jax.disable_jit():
        want = j_stack.list_node_intersections(
            bvh, jrt.Rays(*(jnp.asarray(x) for x in arrays)), k)
    got = t_stack.list_node_intersections(
        bvh, nt.Rays(*(torch.from_numpy(x) for x in arrays)), k)
    assert nt.list_node_intersections is t_stack.list_node_intersections
    t0, t1, ids = (np.asarray(x) for x in want)
    assert got[0].shape == t0.shape and got[2].dtype == nt.PRIM_ID_DTYPE
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  t0.view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  t1.view(np.uint32))
    np.testing.assert_array_equal(got[2].numpy(), ids.astype(np.int64))
    assert (ids != 0xFFFFFFFF).any() and (ids == 0xFFFFFFFF).any() or k == 1


def test_list_node_intersections_batch_shape():
    bvh, arrays = _bvh_and_rays(12, 5)
    rays = nt.Rays(*(torch.from_numpy(x).reshape((3, 4) + x.shape[1:])
                     for x in arrays))
    t0, t1, ids = nt.list_node_intersections(bvh, rays, 5)
    assert t0.shape == t1.shape == ids.shape == (3, 4, 5)
    flat = nt.list_node_intersections(
        bvh, nt.Rays(*(torch.from_numpy(x) for x in arrays)), 5)
    assert torch.equal(ids.reshape(12, 5), flat[2])


REEXPORTS = ["intersect_ray_aabb", "max_mult", "intersect_triangles",
             "ray_coeffs", "no_hits", "list_node_intersections",
             "surface_area"]


@pytest.mark.parametrize("name", REEXPORTS)
def test_root_reexports_like_jax(name):
    from nanort_tpu_torch.core import aabb, ray
    from nanort_tpu_torch.ops import triangle

    home = {"intersect_ray_aabb": aabb, "max_mult": aabb,
            "intersect_triangles": triangle, "ray_coeffs": triangle,
            "no_hits": ray, "list_node_intersections": t_stack,
            "surface_area": t_math}[name]
    if name == "surface_area":
        # the JAX package keeps it in core.math, not at its root
        assert not hasattr(jrt, name) and hasattr(j_math, name)
        assert callable(home.surface_area)
        return
    assert hasattr(jrt, name)
    assert getattr(nt, name) is getattr(home, name)


# The device build, the custom primitives, multi-hit, the scene graph,
# the Embree-style API, the loaders, the renderers and the cameras: each
# public name of the JAX module exists in the port's module of the same
# path, and a function takes the JAX function's parameters, in its order
# (the port may add trailing keyword parameters, such as ``device``). A
# NamedTuple has the JAX fields, an enum the JAX members, a class the
# JAX public methods with their parameters, a dict the JAX keys, a number
# or a string the JAX value.
PORTED_MODULES = {
    "build.lbvh": ["build_lbvh", "morton_codes", "hybrid_deltas",
                   "MAX_DEPTH", "D_FLOOR"],
    "build.refit": ["refit_bvh"],
    "build.sah_top": ["sah_top_partition", "sah_hybrid_deltas",
                      "sah_cost_estimate"],
    "build.device_collapse": ["collapse_lbvh_device", "preorder_device"],
    "ops.sphere": ["Spheres", "SphereRayCtx", "sphere_prim_bounds",
                   "sphere_prepare", "sphere_intersect", "sphere_post",
                   "build_sphere_bvh", "traverse_spheres"],
    "ops.cylinder": ["Cylinders", "CylRayCtx", "cylinder_prim_bounds",
                     "cylinder_prepare", "cylinder_intersect",
                     "build_cylinder_bvh", "traverse_cylinders"],
    "ops.curve": ["Curves", "CurveRayCtx", "curve_prim_bounds",
                  "curve_prepare", "make_curve_intersect",
                  "build_curve_bvh", "traverse_curves"],
    "traverse.multi_hit": ["MultiHits", "multi_hit_traverse",
                           "multi_hit_wavefront", "brute_force_multi_hit"],
    "scene.matrix": ["identity", "translate", "scale", "rotate", "compose",
                     "inverse", "inv_transpose33", "transform_points",
                     "transform_dirs", "xform_bbox"],
    "scene.graph": ["Node", "SceneHits", "CommittedScene", "Scene",
                    "scene_traverse"],
    "io.voxels": ["voxels_to_mesh", "grid2d_to_boxes"],
    "io.gltf": ["GltfMesh", "GltfScene", "load_gltf", "to_scene_graph"],
    "api.rtc": ["BufferType", "RTCScene", "RTCDevice", "new_device"],
    "api.embree3": ["RTC_INVALID_GEOMETRY_ID", "GeometryType", "BufferType3",
                    "RTCRayHit", "rtc_new_device", "rtc_new_scene",
                    "rtc_new_geometry", "rtc_set_new_geometry_buffer",
                    "rtc_commit_geometry", "rtc_attach_geometry",
                    "rtc_release_geometry", "rtc_commit_scene",
                    "rtc_get_scene_bounds", "rtc_intersect1",
                    "rtc_occluded1"],
    "models.cameras": ["Camera", "look_at", "pixel_grid", "pinhole_rays",
                       "orthographic_rays", "spherical_rays",
                       "spherical_panorama_rays", "cylindrical_rays",
                       "fisheye_rays", "fisheye_mkx22_rays",
                       "CAMERA_REGISTRY", "generate_rays",
                       "vr_omnistereo_rays"],
    "models.pbr": ["PBRMaterial", "shade_pbr", "render_pbr"],
    "models.uv_raster": ["make_uv_mesh", "rasterize_uv_atlas"],
    "models.progressive": ["ProgressiveRenderer"],
    "models.bdpt": ["K_EPS", "K_INF", "trace_bdpt", "render_bdpt"],
    "io.eson": ["NULL_T", "FLOAT64_T", "INT64_T", "STRING_T", "ARRAY_T",
                "BINARY_T", "OBJECT_T", "dumps", "dump", "loads", "load",
                "save_mesh", "load_mesh"],
    "io.minecraft": ["TAG_END", "TAG_BYTE", "TAG_SHORT", "TAG_INT",
                     "TAG_LONG", "TAG_FLOAT", "TAG_DOUBLE", "TAG_BYTE_ARRAY",
                     "TAG_STRING", "TAG_LIST", "TAG_COMPOUND",
                     "TAG_INT_ARRAY", "TAG_LONG_ARRAY", "parse_nbt",
                     "read_region", "chunk_to_voxels", "region_to_voxels",
                     "load_region_mesh"],
    "io.heightmap": ["heightmap_to_mesh"],
    "io.displacement": ["compute_tangent_frames", "sample_map",
                        "apply_vector_displacement", "weld_vertices"],
    "io.qrcode": ["generate_qr", "verify_qr"],
    "io.las": ["LasCloud", "load_las", "save_las", "to_spheres"],
    "io.partio": ["ParticleCloud", "save_pda", "load_pda", "save_pdb",
                  "load_pdb", "load_particles", "to_spheres"],
    "io.ptex": ["FaceTextures", "build_face_textures", "sample",
                "sample_tri_hits", "save_ptex_npz", "load_ptex_npz"],
    "utils.config": ["RenderConfig"],
    "utils.trackball": ["TRACKBALL_SIZE", "trackball", "add_quats",
                        "build_rotmatrix", "camera_from_quat"],
    "utils.debug": ["trap_nans", "validate_rays", "assert_finite_image"],
    "parallel.mesh": ["RAY_AXIS", "ray_mesh", "shard_rays", "replicate",
                      "sharded_traverse_triangles",
                      "sharded_traverse_wavefront", "sharded_render_step"],
    "parallel.sharded_scene": ["ShardedScene", "build_scene_chunks",
                               "sequential_chunk_traverse",
                               "sharded_scene_traverse"],
}
# Parameters renamed on purpose (CHANGES.md): a JAX threefry ``key``
# becomes a ``seed`` (an int or a torch.Generator).
RENAMED = {("models.bdpt", "trace_bdpt"): {"key": "seed"},
           ("models.bdpt", "render_bdpt"): {"key": "seed"},
           ("parallel.mesh", "sharded_render_step"): {"key": "seed"}}


def _params(fn, renamed=None):
    import inspect

    names = list(inspect.signature(fn).parameters)
    return [(renamed or {}).get(n, n) for n in names]


def _same_api(j, t, where, renamed=None):
    import enum
    import inspect

    if isinstance(j, (int, float, str)):
        assert t == j, where
    elif isinstance(j, dict):
        assert list(t) == list(j), where
    elif isinstance(j, type) and issubclass(j, enum.Enum):
        assert [m.name for m in t] == [m.name for m in j], where
    elif isinstance(j, type) and hasattr(j, "_fields"):
        assert getattr(t, "_fields", None) == j._fields, where
    elif isinstance(j, type):
        jp = _params(j)
        assert _params(t)[:len(jp)] == jp, where
        for name, member in vars(j).items():
            if name.startswith("_") or not inspect.isfunction(member):
                continue
            jm = _params(member)
            assert _params(getattr(t, name))[:len(jm)] == jm, (where, name)
    else:
        jp = _params(j, renamed)
        assert _params(t)[:len(jp)] == jp, (where, jp, _params(t))


@pytest.mark.parametrize("module", sorted(PORTED_MODULES))
def test_ported_module_names_match(module):
    import importlib

    jm = importlib.import_module(f"nanort_tpu.{module}")
    tm = importlib.import_module(f"nanort_tpu_torch.{module}")
    for name in PORTED_MODULES[module]:
        _same_api(getattr(jm, name), getattr(tm, name), name,
                  RENAMED.get((module, name)))


@pytest.mark.parametrize("name", ["multi_hit_traverse", "MultiHits"])
def test_multi_hit_root_names(name):
    from nanort_tpu_torch.traverse import multi_hit

    assert getattr(nt, name) is getattr(multi_hit, name)
    if name == "multi_hit_traverse":
        assert hasattr(jrt, name)  # the JAX package exports it too


def test_ray_sort_shares_the_morton_spread():
    from nanort_tpu_torch.build import lbvh
    from nanort_tpu_torch.traverse import ray_sort

    assert ray_sort._expand_bits is lbvh._expand_bits


def test_slice_modules_import_without_jax():
    """The scene graph, API, loader, renderer, utility and multi-device
    modules import with jax blocked, and pull in nothing of the JAX
    package."""
    import os
    import subprocess
    import sys

    mods = ["scene.matrix", "scene.graph", "io.voxels", "io.gltf", "api.rtc",
            "api.embree3", "models.cameras", "models.pbr", "models.uv_raster",
            "models.progressive", "models.bdpt", "io.eson", "io.minecraft",
            "io.heightmap", "io.displacement", "io.qrcode", "io.las",
            "io.partio", "io.ptex", "utils.config", "utils.trackball",
            "utils.debug", "parallel.mesh", "parallel.sharded_scene",
            "parallel.dryrun"]
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            + "; ".join(f"importlib.import_module('nanort_tpu_torch.{m}')"
                        for m in mods)
            + "; assert 'nanort_tpu' not in sys.modules; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
