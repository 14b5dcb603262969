"""PyTorch port, the multi-device layer (``parallel/{mesh,sharded_scene,
dryrun}.py``) against the JAX package, on gloo groups of 1, 2 and 4
spawned CPU ranks.

The ranks (``parallel.dryrun.spawn_ranks``) run
``testing.mesh_checks``, a function of the port: a spawned rank imports
the port and never this file, so it never imports JAX. They meet through
a ``file://`` store in a fresh temporary directory, with a timeout on
the rendezvous and a deadline on the join. Both packages get the same
state: the JAX package's BVH, chunk tables and threefry draws, carried
over as NumPy arrays. The JAX references run jitted under ``shard_map``
on ``ray_mesh(n)`` of the 8-device virtual CPU mesh, in the no-FMA child
(``testing.run_without_fma``: jitted XLA on the CPU contracts FMAs).

Tolerances:
- the mesh engines (stack, wavefront) and the render step's AO: bit for
  bit, on every rank; hit counts equal; the mean AO within 1e-6 (the
  ranks' means are summed in another order);
- the chunk rings against JAX's ring at n = 4 and the packet chunks on
  the CPU plain K1 against brute force: ``compare_hits`` (equal hit
  masks, prim ids differing only at equal-t ties, t within 4 ulp, u/v
  within 2e-6);
- ``build_scene_chunks``: every table bit for bit, padding included.

The wavefront ring sizes its leaf window from the chunk where JAX's
ring takes 4 triangles whatever the leaves hold: with leaves of 8, JAX's
ring misses hits (``test_jax_ring_skips_leaf_triangles_past_four``), and
the port's ring is held to brute force instead.
"""

import os
import sys

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch import interop
from nanort_tpu_torch.parallel import mesh as pm
from nanort_tpu_torch.parallel import sharded_scene as pss
from nanort_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from nanort_tpu_torch.testing import compare_hits, run_without_fma

torch.set_num_threads(1)

SIZES = (1, 2, 4)
CHUNKS = 4
FIELDS = ("t", "u", "v", "prim_id")
SC_FIELDS = ("nodes", "soups", "perms", "num_nodes", "num_chunks", "nodes8",
             "leafs8", "depth8", "max_leaf8")
BVH_FIELDS = ("bmin", "bmax", "flag", "axis", "data", "indices")


def _mesh():
    from nanort_tpu_torch.io.procedural import (make_cornell_box,
                                                make_uv_sphere, merge_meshes)

    return merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))


def _rays(n=256, seed=17):
    """Seeded rays from around the box toward its middle; every 16th has
    a window [0.5, 1.5) that cuts some hits off."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3.0, 3.0, (n, 3))
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    min_t = np.zeros(n, np.float32)
    max_t = np.full(n, np.finfo(np.float32).max, np.float32)
    min_t[::16], max_t[::16] = 0.5, 1.5
    return org.astype(np.float32), d.astype(np.float32), min_t, max_t


def _jax_state():
    """The JAX package's BVH and packet-chunk scene of ``_mesh()``."""
    import jax.numpy as jnp

    import nanort_tpu as jrt
    from nanort_tpu.parallel.sharded_scene import build_scene_chunks

    v, f = _mesh()
    jmesh = jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f))
    bvh, _ = jrt.build_triangle_bvh(jmesh)
    state = {"v": v, "f": f}
    state.update({f"bvh_{k}": np.asarray(getattr(bvh, k)) for k in BVH_FIELDS})
    for p, opts in (("sc", jrt.BVHBuildOptions()),
                    ("wide", jrt.BVHBuildOptions(8, 8))):
        sc = build_scene_chunks(jmesh, CHUNKS, opts, True)
        state.update({f"{p}_{k}": np.asarray(getattr(sc, k))
                      for k in SC_FIELDS})
    org, d, min_t, max_t = _rays()
    state.update(org=org, dir=d, min_t=min_t, max_t=max_t)
    return state


@pytest.fixture(scope="module")
def state():
    return _jax_state()


@pytest.fixture(scope="module")
def jax_side(state):
    return run_without_fma(__file__, state)


@pytest.fixture(scope="module")
def ranks(state, jax_side):
    """Each mesh size's per-rank results of ``testing.mesh_checks``."""
    inputs = dict(state)
    inputs.update({f"draws{n}": jax_side[f"draws{n}"] for n in SIZES})
    return {n: spawn_ranks("nanort_tpu_torch.testing:mesh_checks", n,
                           inputs, device="cpu", timeout=120.0)
            for n in SIZES}


def _hits(z, name):
    return nt.Hits(*(z[f"{name}_{k}"] for k in FIELDS))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("engine", ["stack", "wavefront"])
def test_mesh_engines_match_jax(ranks, jax_side, n, engine):
    for r, z in enumerate(ranks[n]):
        for k in FIELDS:
            np.testing.assert_array_equal(z[f"{engine}_{k}"],
                                          jax_side[f"{engine}{n}_{k}"],
                                          err_msg=f"rank {r} {k}")
        assert int(z[f"{engine}_n"]) == int(jax_side[f"{engine}{n}_n"])
    hits = _hits(ranks[n][0], engine)
    assert 0 < int(hits.hit.sum()) < len(hits.t)


@pytest.mark.parametrize("n", SIZES)
def test_render_step_matches_jax_with_its_draws(ranks, jax_side, n):
    for z in ranks[n]:
        np.testing.assert_array_equal(z["ao"], jax_side[f"ao{n}"])
        assert int(z["ao_n"]) == int(jax_side[f"ao{n}_n"])
        assert abs(float(z["ao_mean"]) - float(jax_side[f"ao{n}_mean"])) <= 1e-6
        assert 0.0 <= float(z["seeded_mean"]) <= 1.0
        assert float(z["seeded_mean"]) == float(ranks[n][0]["seeded_mean"])
    assert len(np.unique(jax_side[f"ao{n}"])) == 2  # escapes and re-hits


def test_gloo_rings_match_jax_ring(ranks, jax_side, state):
    """Chunk r on rank r, the ray blocks passed round the ring by
    ``batch_isend_irecv``: the wavefront ring against JAX's ring, and the
    packet ring (the CPU plain K1 on the per-chunk BVH8 tables) against
    the same and against one device's chunks in turn."""
    want = nt.Hits(*(jax_side[f"ring_{k}"] for k in FIELDS))
    assert want.hit.any() and not want.hit.all()
    rays = interop.rays_from_numpy(state["org"], state["dir"],
                                   state["min_t"], state["max_t"],
                                   device="cpu")
    bf = nt.brute_force_traverse(nt.TriangleMesh(
        torch.from_numpy(state["v"]), torch.from_numpy(state["f"])), rays)
    for p in ("sc", "wide"):
        sc = interop.sharded_scene_from_numpy(
            *(state[f"{p}_{k}"] for k in SC_FIELDS))
        seq = pss.sequential_chunk_traverse(sc, rays)
        for z in ranks[CHUNKS]:
            for name in ("ring", "packet"):
                got = _hits(z, f"{p}_{name}")
                for ref in ((want, seq, bf) if p == "sc" else (seq, bf)):
                    c = compare_hits(got, ref)
                    assert c["ok"], (p, name, sorted(c.items()))
    for n in (1, 2):  # a mesh of another size runs no ring
        assert "sc_ring_t" not in ranks[n][0]


def test_jax_ring_skips_leaf_triangles_past_four(jax_side, state):
    """The reference-side fault the port's ring avoids: on chunks with
    leaves of 8 triangles JAX's wavefront ring misses hits that brute
    force (and the port's ring, above) finds."""
    rays = interop.rays_from_numpy(state["org"], state["dir"],
                                   state["min_t"], state["max_t"],
                                   device="cpu")
    bf = nt.brute_force_traverse(nt.TriangleMesh(
        torch.from_numpy(state["v"]), torch.from_numpy(state["f"])), rays)
    c = compare_hits(nt.Hits(*(jax_side[f"wide_ring_{k}"] for k in FIELDS)),
                     bf)
    assert not c["ok"], c


@pytest.mark.parametrize("n", (2, 4))
def test_indivisible_batch_raises_on_every_rank(ranks, n):
    assert all(int(z.get("indivisible_raises", 0)) == 1 for z in ranks[n])


def test_one_rank_mesh_without_a_group(state, ranks):
    """``ray_mesh(1)`` with no process group: the collectives are
    identities and the records are the one-rank group's."""
    assert not torch.distributed.is_initialized()
    mesh = pm.ray_mesh(1, device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    bvh = interop.bvh_from_numpy(*(state[f"bvh_{k}"] for k in BVH_FIELDS))
    geom = nt.TriangleMesh(state["v"], state["f"])
    rays = interop.rays_from_numpy(state["org"], state["dir"],
                                   state["min_t"], state["max_t"],
                                   device="cpu")
    hits, n_hit = pm.sharded_traverse_triangles(bvh, geom, rays, mesh)
    z = ranks[1][0]
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(hits, k).numpy(),
                                      z[f"stack_{k}"])
    assert int(n_hit) == int(z["stack_n"])
    local = pm.shard_rays(rays, mesh)
    assert all(torch.equal(a, b) for a, b in zip(local, rays))


def test_mesh_validation_errors(state):
    with pytest.raises(RuntimeError, match="process group"):
        pm.ray_mesh(2, device="cpu")
    if torch.cuda.device_count() == 0:  # a CUDA mesh never takes the CPU
        with pytest.raises(ValueError, match="cards"):
            pm.ray_mesh(1)
    mesh = pm.ray_mesh(1, device="cpu")
    v, f = _mesh()
    rays = interop.rays_from_numpy(*_rays(8), device="cpu")
    two = pss.build_scene_chunks(nt.TriangleMesh(v, f), 2)
    with pytest.raises(ValueError, match="chunks"):
        pss.sharded_scene_traverse(two, rays, mesh)
    one = pss.build_scene_chunks(nt.TriangleMesh(v, f), 1)
    with pytest.raises(ValueError, match="packet"):
        pss.sharded_scene_traverse(one, rays, mesh, engine="packet")
    with pytest.raises(ValueError, match="packet=True"):
        pss.sequential_chunk_traverse(one, rays)
    with pytest.raises(ValueError, match="more chunks"):
        pss.build_scene_chunks(nt.TriangleMesh(v, f), len(f) + 1)
    with pytest.raises(ValueError, match="max_leaf"):
        pss.build_scene_chunks(nt.TriangleMesh(v, f), 2,
                               nt.BVHBuildOptions(12, 12), packet=True)
    # "auto" takes the plain walk on a CPU mesh
    got = pss.sharded_scene_traverse(one, rays, mesh)
    want = pss.sharded_scene_traverse(one, rays, mesh, engine="wavefront")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_packet_scenes_refuse_ids_past_float32(monkeypatch):
    """Leaf pid lanes carry global ids as float32, exact to 2^24: a packet
    scene of more triangles raises instead of rounding ids."""
    v, f = _mesh()
    monkeypatch.setattr(pss, "MAX_PACKET_PRIMS", len(f) - 1)
    with pytest.raises(ValueError, match="2\\^24"):
        pss.build_scene_chunks(nt.TriangleMesh(v, f), 2, packet=True)
    pss.build_scene_chunks(nt.TriangleMesh(v, f), 2)  # no packet tables


@pytest.mark.parametrize("packet,n_chunks,opts", [
    (False, 3, (4, 4)), (True, 4, (8, 8)), (True, 5, (9, 9))])
def test_build_scene_chunks_tables_bit_for_bit(packet, n_chunks, opts):
    import jax.numpy as jnp

    import nanort_tpu as jrt
    from nanort_tpu.parallel.sharded_scene import build_scene_chunks

    v, f = _mesh()
    want = build_scene_chunks(
        jrt.TriangleMesh(vertices=jnp.asarray(v), faces=jnp.asarray(f)),
        n_chunks, jrt.BVHBuildOptions(*opts), packet)
    got = pss.build_scene_chunks(nt.TriangleMesh(torch.from_numpy(v),
                                                 torch.from_numpy(f)),
                                 n_chunks, nt.BVHBuildOptions(*opts), packet)
    for k in SC_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        else:
            assert a == b, k
    np.testing.assert_array_equal(pss._morton_order(v[f].mean(1)),
                                  __import__(
                                      "nanort_tpu.parallel.sharded_scene",
                                      fromlist=["_morton_order"])
                                  ._morton_order(v[f].mean(1)))
    if packet:
        # each chunk's own depth: its table's levels, at most the JAX max
        from nanort_tpu_torch.build.bvh8 import table_depth

        assert got.depths8 == tuple(table_depth(got.nodes8[c], 8)
                                    for c in range(n_chunks))
        assert max(got.depths8) == got.depth8
        for c in range(n_chunks):
            s8 = pss._chunk_scene8(got, c)
            assert s8.to("cpu").depth == got.depths8[c]  # to() accepts it
    else:
        assert got.nodes8 is None and got.depths8 is None


def test_sequential_chunks_on_plain_k1_match_brute_force():
    """Four packet chunks traced one after another on the CPU plain K1 and
    merged: the unsplit mesh's brute-force records under the tie
    contract."""
    from nanort_tpu_torch.io.procedural import make_uv_sphere

    v, f = make_uv_sphere(16, 32, 1.0)
    mesh = nt.TriangleMesh(v, f)
    sc = pss.build_scene_chunks(mesh, 4, nt.BVHBuildOptions(8, 8), True)
    rng = np.random.default_rng(5)
    org = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    d = rng.uniform(-0.7, 0.7, (512, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    got = pss.sequential_chunk_traverse(sc, rays)
    want = nt.brute_force_traverse(
        nt.TriangleMesh(torch.from_numpy(v), torch.from_numpy(f)), rays)
    c = compare_hits(got, want)
    assert c["ok"] and c["hits"] > 100, c
    # a (16, 32) batch keeps its shape
    got2 = pss.sequential_chunk_traverse(
        sc, nt.Rays(*(x.reshape((16, 32) + x.shape[1:]) for x in rays)))
    assert got2.t.shape == (16, 32)
    assert all(torch.equal(a.reshape(-1), b) for a, b in zip(got2, got))


def test_dryrun_multichip_four_gloo_ranks(capsys):
    out = dryrun_multichip(4, device="cpu")
    assert int(out["stack"]) == int(out["wavefront"]) == int(out["ring"])
    assert "stack == wavefront == chunk-sharded ring" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (pm.ray_mesh, dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------ JAX side

def _jax_side(inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from nanort_tpu.core.bvh import BVH
    from nanort_tpu.core.ray import Rays
    from nanort_tpu.ops.triangle import TriangleMesh
    from nanort_tpu.parallel.mesh import (ray_mesh, sharded_render_step,
                                          sharded_traverse_triangles,
                                          sharded_traverse_wavefront)
    from nanort_tpu.parallel.sharded_scene import (ShardedScene,
                                                   sharded_scene_traverse)
    from nanort_tpu.traverse.packed import pack_scene

    assert len(jax.devices()) >= max(SIZES)
    z = dict(np.load(inp))
    bvh = BVH(*(jnp.asarray(z[f"bvh_{k}"]) for k in BVH_FIELDS))
    mesh = TriangleMesh(vertices=jnp.asarray(z["v"]),
                        faces=jnp.asarray(z["f"]))
    rays = Rays(*(jnp.asarray(z[k]) for k in ("org", "dir", "min_t",
                                              "max_t")))
    packed = pack_scene(bvh, z["v"], z["f"])
    key = jax.random.PRNGKey(7)
    res = {}

    def put(name, hits):
        for k in FIELDS:
            x = np.asarray(getattr(hits, k))
            res[f"{name}_{k}"] = x.astype(np.int64) if k == "prim_id" else x

    L = z["org"].shape[0]
    for n in SIZES:
        dmesh = ray_mesh(n)
        h, cnt = sharded_traverse_triangles(bvh, mesh, rays, dmesh)
        put(f"stack{n}", h)
        res[f"stack{n}_n"] = np.int64(int(cnt))
        h, cnt = sharded_traverse_wavefront(packed, rays, dmesh, tile=64)
        put(f"wavefront{n}", h)
        res[f"wavefront{n}_n"] = np.int64(int(cnt))
        ao, cnt, mean = sharded_render_step(bvh, mesh, rays, dmesh, key=key)
        res[f"ao{n}"] = np.asarray(ao)
        res[f"ao{n}_n"] = np.int64(int(cnt))
        res[f"ao{n}_mean"] = np.float32(mean)
        res[f"draws{n}"] = np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, r), (L // n, 3), jnp.float32))
            for r in range(n)])
    for p, name in (("sc", "ring"), ("wide", "wide_ring")):
        sc = ShardedScene(*(z[f"{p}_{k}"] for k in SC_FIELDS[:3]),
                          int(z[f"{p}_num_nodes"]), int(z[f"{p}_num_chunks"]))
        put(name, sharded_scene_traverse(sc, rays, ray_mesh(CHUNKS),
                                         tile=64))
    np.savez(out, **res)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_side(sys.argv[1], sys.argv[2])
