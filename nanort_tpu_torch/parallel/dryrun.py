"""Multi-device dry run on spawned ranks (the port's counterpart of the
repository's ``__graft_entry__.dryrun_multichip``), and the spawn helper
that runs a function on n ranks of a ``torch.distributed`` group.

    from nanort_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")   # 4 gloo ranks on the CPU

Each rank is a process started with the ``spawn`` method: it imports
this module and the port, never the caller's module, so a rank imports
nothing of JAX. The ranks meet through a ``file://`` store in a fresh
temporary directory (no network port), give up after ``timeout`` seconds
when a peer never arrives, and are killed when the whole run outlasts
``timeout``. gloo serves CPU ranks, NCCL CUDA ranks (rank r on
``cuda:r``: one card a rank).
"""

from __future__ import annotations

import datetime
import importlib
import os
import tempfile
import time

import numpy as np
import torch


def _rank_main(rank: int, fn: str, n: int, workdir: str, device: str,
               timeout: float) -> None:
    """One rank: join the group, run ``fn(mesh, inputs)``, save what it
    returns as ``rank<r>.npz``."""
    from .mesh import ray_mesh

    torch.set_num_threads(1)
    dist = torch.distributed
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method="file://" + os.path.join(workdir, "store"),
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = ray_mesh(n, device=device)
        with np.load(os.path.join(workdir, "in.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        module, name = fn.split(":")
        out = getattr(importlib.import_module(module), name)(mesh, inputs)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **(out or {}))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: str, n: int, inputs: dict | None = None,
                device: str = "cuda", timeout: float = 120.0) -> list[dict]:
    """Run ``fn(mesh, inputs)`` on ``n`` spawned ranks and return each
    rank's result, in rank order.

    ``fn``: ``"module:function"`` of a module that imports no JAX;
    ``mesh`` is the rank's ``ray_mesh(n, device=device)``; ``inputs``
    (name -> array) reach every rank as NumPy arrays, and ``fn`` returns
    a dict of arrays. A rank that raises fails the run with its
    traceback; a run that outlasts ``timeout`` seconds is killed and
    raises TimeoutError."""
    mp = torch.multiprocessing
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **(inputs or {}))
        ctx = mp.start_processes(_rank_main, args=(fn, n, d, device, timeout),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {fn} still running "
                                       f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = []
        for r in range(n):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out


def _tiny_scene():
    """The dry run's scene: a Cornell box and a UV sphere (234 tris)."""
    from .. import build_triangle_bvh
    from ..io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
    from ..ops.triangle import TriangleMesh

    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    mesh = TriangleMesh(v, f)
    bvh, _ = build_triangle_bvh(mesh)
    return bvh, mesh


def dryrun_rank(mesh, inputs: dict) -> dict:
    """The dry run on one rank: 16^2 camera rays, the stack and wavefront
    engines and the render step ray-parallel, and the chunk-sharded ring,
    one chunk a rank. Returns the totals (every rank's must agree)."""
    from ..core.ray import Rays
    from ..models.cameras import look_at, pinhole_rays
    from ..traverse.packed import pack_scene
    from .mesh import (sharded_render_step, sharded_traverse_triangles,
                       sharded_traverse_wavefront)
    from .sharded_scene import build_scene_chunks, sharded_scene_traverse

    del inputs
    bvh, geom = _tiny_scene()
    side = 16
    n = side * side
    rays = pinhole_rays(look_at((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), width=side,
                                height=side, fov=60.0, device=mesh.device))
    flat = Rays(*(x.reshape((n,) + tuple(x.shape[2:])) for x in rays))
    hits, n_hit = sharded_traverse_triangles(bvh, geom, flat, mesh)
    total = int(n_hit)
    packed = pack_scene(bvh, geom.vertices, geom.faces)
    _, wn_hit = sharded_traverse_wavefront(packed, flat, mesh, tile=64)
    ao, n_hit2, mean_ao = sharded_render_step(bvh, geom, flat, mesh)
    img = ao.reshape(side, side)
    chunks = build_scene_chunks(geom, mesh.size)
    shits = sharded_scene_traverse(chunks, flat, mesh, tile=64)
    return {"rays": np.int64(n), "stack": np.int64(total),
            "wavefront": np.int64(int(wn_hit)),
            "render": np.int64(int(n_hit2)),
            "ring": np.int64(int((shits.prim_id != 0xFFFFFFFF).sum())),
            "mean_ao": np.float64(float(mean_ao)),
            "image": img.cpu().numpy(),
            "hits": hits.prim_id.cpu().numpy()}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 120.0) -> dict:
    """One data-parallel render step and one chunk-sharded ring over
    ``n_devices`` spawned ranks (gloo for ``device="cpu"``, NCCL on the
    card, which needs ``n_devices`` cards), at the repository dry run's
    shapes: 256 camera rays over 234 triangles.

    Checks what that dry run checks: the stack engine, the wavefront
    engine, the render step and the ring count the same hits, and
    ``0 < hits <= rays``; the mean AO lies in [0, 1]; every rank gathered
    the 16^2 AO image; and every rank got the same totals. Prints one
    line and returns rank 0's totals; raises AssertionError when a check
    fails."""
    ranks = spawn_ranks(f"{__name__}:dryrun_rank", n_devices, device=device,
                        timeout=timeout)
    r0 = ranks[0]
    n, total = int(r0["rays"]), int(r0["stack"])
    assert 0 < total <= n, f"implausible hit count {total}"
    for k in ("wavefront", "render", "ring"):
        assert int(r0[k]) == total, f"{k} disagreement {int(r0[k])} != {total}"
    assert 0.0 <= float(r0["mean_ao"]) <= 1.0, float(r0["mean_ao"])
    assert r0["image"].shape == (16, 16)
    for r in ranks[1:]:
        for k, x in r0.items():
            assert np.array_equal(r[k], x), f"ranks disagree on {k}"
    print(f"dryrun_multichip: {n_devices} ranks ({device}), {n} rays "
          f"sharded, {total} hits (stack == wavefront == chunk-sharded "
          f"ring), mean AO {float(r0['mean_ao']):.3f}, 16x16 image "
          "gathered — OK", flush=True)
    return r0
