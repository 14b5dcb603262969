"""PyTorch port, traverse/wavefront.py: ``traverse_wavefront`` (plain
torch, no kernel) against the JAX package's on the same packed tables.

The tables are ``pack_scene_multi`` of two meshes (a UV sphere inside a
cornell box, and a second sphere beside it), so per-ray roots and the
remapped sub-tree skip links run; the rays are seeded, from all around
the scene. Modes: whole scene, per-ray ``root``, per-ray
``skip_prim_id``, ``cull_back_face``, ``prim_ids_range``, and a short
``max_t`` with dead rays. The JAX side runs op by op
(``jax.disable_jit``): jitted on the CPU, XLA contracts the edge
functions into FMAs. Tolerance (``testing.compare_hits``): the same hit
mask; the same prim except at bit-equal t; t within 4 ulp; u/v within
2e-6. The records must also not depend on ``tile``, on the port's
chunking or on how often the live set is compacted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanort_tpu as jrt
from nanort_tpu.traverse import packed as j_packed
from nanort_tpu.traverse import wavefront as j_wf
import nanort_tpu_torch as nt
from nanort_tpu_torch.io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import compare_hits
from nanort_tpu_torch.traverse import packed as t_packed
from nanort_tpu_torch.traverse import wavefront

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    m0 = merge_meshes(make_cornell_box(2.0), make_uv_sphere(12, 24, 0.5))
    v1, f1 = make_uv_sphere(8, 16, 0.4)
    m1 = (v1 + np.float32(2.5), f1)
    items = [(nt.build_triangle_bvh(TriangleMesh(v, f))[0], v, f)
             for v, f in (m0, m1)]
    scene, roots = t_packed.pack_scene_multi(items)
    jscene, jroots = j_packed.pack_scene_multi(items)
    assert np.array_equal(roots, jroots)
    rng = np.random.default_rng(9)
    n = 700
    org = rng.uniform(-3, 4, (n, 3)).astype(np.float32)
    # ray i aims near a vertex of mesh i % 2 (the mesh its root names)
    tgt = np.where((np.arange(n) % 2 == 0)[:, None],
                   m0[0][rng.integers(0, m0[0].shape[0], n)],
                   m1[0][rng.integers(0, m1[0].shape[0], n)])
    tgt = tgt + rng.normal(0, 0.05, (n, 3))
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    max_t = np.full(n, 1e30, np.float32)
    return dict(scene=scene, jscene=jscene, roots=roots, org=org, d=d,
                max_t=max_t, n_faces=(m0[1].shape[0], f1.shape[0]))


def _run(world, mode):
    n = world["org"].shape[0]
    max_t = world["max_t"].copy()
    min_t = np.zeros(n, np.float32)
    kw, jkw = {}, {}
    opts = dict()
    if mode == "root":
        r = world["roots"][np.arange(n) % 2]
        kw["root"], jkw["root"] = torch.from_numpy(r), jnp.asarray(r)
    if mode == "skip":
        first = _run(world, "whole")[0]
        skip = np.where(first.hit.numpy(), first.prim_id.numpy(), 0)
        kw["skip_prim_id"] = torch.from_numpy(skip)
        jkw["skip_prim_id"] = jnp.asarray(skip.astype(np.uint32))
    if mode == "cull":
        opts["cull_back_face"] = True
    if mode == "range":
        opts["prim_ids_range"] = (150, 700)
    if mode == "short":
        max_t = np.random.default_rng(3).uniform(0.5, 3.0, n).astype(np.float32)
        min_t[::4] = 5.0  # dead: max_t < min_t
    rays = nt.Rays(*(torch.from_numpy(x) for x in (world["org"], world["d"],
                                                   min_t, max_t)))
    got = wavefront.traverse_wavefront(world["scene"], rays,
                                       nt.BVHTraceOptions(**opts), **kw)
    jrays = jrt.Rays(*(jnp.asarray(x) for x in (world["org"], world["d"],
                                                 min_t, max_t)))
    with jax.disable_jit():
        want = j_wf.traverse_wavefront(world["jscene"], jrays,
                                       jrt.BVHTraceOptions(**opts), **jkw)
    return got, jrt.Hits(*(np.asarray(x) for x in want)), rays, kw, opts


# the least hits each mode must see (measured: 384, 609, 345, 360, 260, 68)
MIN_HITS = {"whole": 300, "root": 500, "skip": 250, "cull": 250,
            "range": 200, "short": 50}


@pytest.mark.parametrize("mode", list(MIN_HITS))
def test_matches_jax(world, mode):
    got, want, rays, kw, opts = _run(world, mode)
    c = compare_hits(got, want)
    assert c["ok"], c
    assert c["hits"] >= MIN_HITS[mode], c
    if mode == "skip":
        h = got.hit.numpy()
        assert (got.prim_id.numpy()[h] != kw["skip_prim_id"].numpy()[h]).all()
    if mode == "short":
        assert not got.hit.numpy()[::4].any()


def test_records_do_not_depend_on_tile_chunks_or_syncs(world, monkeypatch):
    got, _, rays, kw, opts = _run(world, "root")
    monkeypatch.setattr(wavefront, "CHUNK_RAYS", 64)
    monkeypatch.setattr(wavefront, "SYNC_EVERY", 1)
    other = wavefront.traverse_wavefront(world["scene"], rays,
                                         nt.BVHTraceOptions(**opts),
                                         tile=32, **kw)
    for a, b in zip(got, other):
        assert torch.equal(a, b)


def test_max_leaf_validation_and_batch_shape(world):
    s = world["scene"]
    rays = nt.Rays(*(torch.from_numpy(x[:600]).reshape((20, 30) + x.shape[1:])
                     for x in (world["org"], world["d"],
                               np.zeros(700, np.float32), world["max_t"])))
    with pytest.raises(ValueError, match="max_leaf"):
        wavefront.traverse_wavefront(s, rays, max_leaf=s.max_leaf - 1)
    with pytest.raises(ValueError, match="max_leaf=None"):
        wavefront.traverse_wavefront(
            t_packed.PackedScene(s.nodes, s.soup, s.num_nodes, s.num_prims),
            rays, max_leaf=None)
    h = wavefront.traverse_wavefront(s, rays, max_leaf=None)
    assert h.t.shape == (20, 30) and h.prim_id.dtype == torch.int64
