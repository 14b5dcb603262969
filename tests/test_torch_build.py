"""PyTorch port, host build modules: procedural scenes, the NumPy and
native SAH builders, the BVH8/BVH16 collapse and the interop helpers —
each against the JAX package on the same inputs. Tolerance:
bit-identical arrays (the port copies these modules; the native builder
compiles the same source with the same flags)."""

import os

import numpy as np
import pytest
import torch

import nanort_tpu as jrt
import nanort_tpu_torch as nt
from nanort_tpu.build import bvh8 as j_bvh8
from nanort_tpu.build import native as j_native
from nanort_tpu.build import sah as j_sah
from nanort_tpu.io import procedural as j_proc
from nanort_tpu_torch import interop
from nanort_tpu_torch.build import bvh8 as t_bvh8
from nanort_tpu_torch.build import native as t_native
from nanort_tpu_torch.build import sah as t_sah
from nanort_tpu_torch.core.bvh import validate
from nanort_tpu_torch.io import procedural as t_proc
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import same_bits as _same_arrays

torch.set_num_threads(1)


def _same_tree(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert _same_arrays(x, y)


GENERATORS = [
    ("make_quad", ([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0])),
    ("make_cornell_box", (2.0,)),
    ("make_uv_sphere", (8, 16, 0.5, (0.1, 0.2, 0.3))),
    ("make_random_triangles", (200, 7)),
    ("make_subdivided_sphere_scene", (20_000,)),
    ("make_cornell_pt_scene", ()),
    ("make_cornell_dense_pt_scene", (2_000,)),
]


@pytest.mark.parametrize("name,args", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_procedural_scenes_identical(name, args):
    got = getattr(t_proc, name)(*args)
    want = getattr(j_proc, name)(*args)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert _same_arrays(a[k], b[k])
        else:
            assert _same_arrays(a, b)


def test_merge_meshes_identical():
    parts = (t_proc.make_cornell_box(2.0), t_proc.make_uv_sphere(6, 12, 0.4))
    _same_tree(t_proc.merge_meshes(*parts), j_proc.merge_meshes(*parts))


@pytest.fixture(scope="module")
def scene_mesh():
    return t_proc.merge_meshes(t_proc.make_cornell_box(2.0),
                               t_proc.make_uv_sphere(16, 32, 0.5))


@pytest.mark.parametrize("leaf", [4, 9])
def test_numpy_sah_identical(scene_mesh, leaf):
    v, f = scene_mesh
    opts = nt.BVHBuildOptions(min_leaf_primitives=leaf, max_leaf_primitives=leaf)
    jopts = jrt.BVHBuildOptions(min_leaf_primitives=leaf, max_leaf_primitives=leaf)
    bounds = nt.triangle_prim_bounds(TriangleMesh(v, f))
    got, gst = t_sah.build_sah(*bounds, options=opts)
    want, wst = j_sah.build_sah(*bounds, options=jopts)
    _same_tree(got, want)
    assert gst.max_tree_depth == wst.max_tree_depth
    validate(got, num_prims=f.shape[0])


def test_native_sah_identical(scene_mesh):
    if not (t_native.native_available() and j_native.native_available()):
        pytest.skip("no g++ for the native SAH builder")
    v, f = scene_mesh
    b = t_native.triangle_bounds_native(v, f)
    _same_tree(b, j_native.triangle_bounds_native(v, f))
    opts = nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9)
    jopts = jrt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9)
    got, _ = t_native.build_sah_native(*b, options=opts)
    want, _ = j_native.build_sah_native(*b, options=jopts)
    _same_tree(got, want)
    # the entry point picks the same builder in both packages
    got2, _ = nt.build_triangle_bvh(TriangleMesh(v, f), opts)
    want2, _ = jrt.build_triangle_bvh(jrt.TriangleMesh(v, f), jopts)
    _same_tree(got2, want2)
    _same_tree(got2, got)


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("leaf", [4, 9])
def test_collapse_tables_identical(scene_mesh, width, leaf):
    v, f = scene_mesh
    bvh, _ = t_sah.build_sah(
        *nt.triangle_prim_bounds(TriangleMesh(v, f)),
        options=nt.BVHBuildOptions(min_leaf_primitives=leaf,
                                   max_leaf_primitives=leaf))
    got = t_bvh8.collapse_bvh8(bvh, v, f, width=width)
    want = j_bvh8.collapse_bvh8(j_sah.BVH(*bvh), v, f, width=width)
    for name in ("nodes", "leafs"):
        assert _same_arrays(getattr(got, name), getattr(want, name)), name
    for name in ("num_nodes", "num_leaf_rows", "depth", "max_leaf", "width"):
        assert getattr(got, name) == getattr(want, name), name
    # interop carries the JAX tables into an identical port scene
    back = interop.scene_from_numpy(
        np.asarray(want.nodes), np.asarray(want.leafs), want.num_nodes,
        want.num_leaf_rows, want.depth, want.max_leaf, want.width)
    for name in ("nodes", "leafs"):
        assert _same_arrays(getattr(back, name), getattr(got, name))
    moved = back.to("cpu")
    assert moved.nodes.dtype == torch.float32 and moved.nodes.is_contiguous()
    assert np.array_equal(moved.leafs.numpy(), got.leafs)


@pytest.mark.parametrize("width", [8, 16])
def test_scene_to_checks_depth(scene_mesh, width):
    # the traversal sizes its stack from depth, so to() holds depth to
    # the node levels of the tables, for host and for tensor tables
    v, f = scene_mesh
    bvh, _ = t_sah.build_sah(
        *nt.triangle_prim_bounds(TriangleMesh(v, f)),
        options=nt.BVHBuildOptions(min_leaf_primitives=9, max_leaf_primitives=9))
    s = t_bvh8.collapse_bvh8(bvh, v, f, width=width)
    assert t_bvh8.table_depth(s.nodes, width) == s.depth > 1
    moved = s.to("cpu")
    assert moved.to("cpu").depth == s.depth
    for bad in (s.depth - 1, s.depth + 1):
        for scene in (s, moved):
            with pytest.raises(ValueError, match="node levels"):
                scene._replace(depth=bad).to("cpu")


def test_single_leaf_scene_has_depth_one():
    v, f = t_proc.make_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0])
    bvh, _ = t_sah.build_sah(*nt.triangle_prim_bounds(TriangleMesh(v, f)))
    s = t_bvh8.collapse_bvh16(bvh, v, f)
    assert s.depth == 1 and s.to("cpu").depth == 1


def test_interop_bvh_and_rays_round_trip(scene_mesh):
    v, f = scene_mesh
    jb, _ = jrt.build_triangle_bvh(jrt.TriangleMesh(v, f), use_native=False)
    tb = interop.bvh_from_numpy(*(np.asarray(x) for x in jb))
    _same_tree(tb, jb)
    validate(tb, num_prims=f.shape[0])
    rng = np.random.default_rng(0)
    org = rng.normal(size=(33, 3)).astype(np.float32)
    d = rng.normal(size=(33, 3)).astype(np.float32)
    jr = jrt.make_rays(org, d)
    tr = interop.rays_from_numpy(*(np.asarray(x) for x in jr))
    for a, b in zip(tr, jr):
        assert a.dtype == torch.float32 and _same_arrays(a.numpy(), b)


def test_shared_library_builds_once_and_reports_errors(tmp_path, monkeypatch):
    import shutil

    from nanort_tpu_torch import _toolchain

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    monkeypatch.setattr(_toolchain, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "one.cc"
    src.write_text('extern "C" int one() { return 1; }\n')
    cmd = ["g++", "-shared", "-fPIC"]
    path = _toolchain.build_shared_library("one", [str(src)], cmd)
    stamp = os.stat(path).st_mtime_ns
    assert _toolchain.build_shared_library("one", [str(src)], cmd) == path
    assert os.stat(path).st_mtime_ns == stamp  # not rebuilt
    assert _ctypes_one(path) == 1
    # a changed source builds under a new name; a broken one raises
    src.write_text('extern "C" int one() { return 2; }\n')
    path2 = _toolchain.build_shared_library("one", [str(src)], cmd)
    assert path2 != path and _ctypes_one(path2) == 2
    src.write_text("not C++\n")
    with pytest.raises(RuntimeError, match="building one failed"):
        _toolchain.build_shared_library("one", [str(src)], cmd)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [os.path.basename(path), os.path.basename(path2)])


def _ctypes_one(path):
    import ctypes

    return ctypes.CDLL(path).one()
