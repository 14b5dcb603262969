"""Ray-parallel rendering over ``torch.distributed`` (port of
``nanort_tpu.parallel.mesh``).

The JAX package shards a ray megabatch over a 1-D device mesh with
``shard_map``: the scene (BVH + geometry) is replicated on every chip,
each chip traverses its shard, and the only collectives are ``psum``'d
render statistics and the gather of the sharded output. Here the same
layout is single-program, multiple-data on ``torch.distributed``: one
process per device, every process calling the same function with the
same arguments.

* ``ray_mesh`` returns a ``RayMesh``: the process group, this process's
  rank in it, its size and this rank's device (``cuda:<rank>`` on the
  card, the CPU for a gloo group of CPU ranks). With no group
  initialised, ``ray_mesh()`` / ``ray_mesh(1)`` is a one-rank mesh whose
  collectives are identities.
* Every rank passes the whole ray batch, as a JAX caller passes one
  global array; each traces its contiguous slice (``shard_rays``) with
  the port's ``traverse/stack.py`` or ``traverse/wavefront.py``.
* ``psum`` is an ``all_reduce``; ``pmean`` an ``all_reduce`` divided by
  the size; and an ``all_gather`` returns the whole batch's hits or AO on
  every rank, standing for the host fetch of a ``P('rays')`` array.
* ``sharded_render_step``'s per-rank random stream is a
  ``torch.Generator`` seeded from ``(seed, rank)`` where the JAX package
  folds the mesh position into a threefry key; ``draws=`` takes the JAX
  draws (see the function).

JAX's ``_MeshCtx`` (a hashable mesh for ``jit``) has no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import cross, dot, sqrt
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import Hits, Rays
from ..ops.triangle import TriangleMesh
from ..traverse.stack import traverse_triangles

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of ``size`` ranks over which ray batches shard.

    ``group``: the ``torch.distributed`` process group (None for the
    one-rank mesh without one); ``rank``: this process's rank in it;
    ``ranks``: the group's global ranks in mesh order; ``device``: the
    device this rank traces on."""

    group: object
    rank: int
    size: int
    ranks: tuple
    device: torch.device


def ray_mesh(n_devices: int | None = None, devices=None,
             device="cuda") -> RayMesh:
    """The 1-D mesh of the first ``n_devices`` ranks of the default
    process group (all of them when None).

    ``devices``: one device a rank, in rank order (rank r traces on
    ``devices[r]``); by default rank r takes ``cuda:r`` when ``device``
    is ``"cuda"`` (one card a process), or the CPU when it is ``"cpu"``.
    Raises ValueError when more ranks are asked for than the group holds,
    or more CUDA ranks than there are cards, and RuntimeError for
    ``n_devices > 1`` with no process group initialised. A CUDA mesh
    never falls back to the CPU.

    With ``n_devices`` below the group's size, the first ``n_devices``
    ranks form a subgroup. Every rank of the group must call this (a new
    group is collective); a rank outside the subgroup gets a mesh with
    ``rank == -1``, on which the sharded functions raise."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"ray_mesh({n_devices}) needs a process group: call "
                "torch.distributed.init_process_group on every rank first")
        group, rank, size, ranks = None, 0, 1, (0,)
    else:
        world = dist.get_world_size()
        size = world if n_devices is None else int(n_devices)
        if not 1 <= size <= world:
            raise ValueError(f"ray_mesh({n_devices}): the process group "
                             f"holds {world} ranks")
        ranks = tuple(range(size))
        if size == world:
            group = dist.group.WORLD
        else:
            group = dist.new_group(ranks=list(ranks))
        me = dist.get_rank()
        rank = me if me < size else -1
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        dev = devices[max(rank, 0)]
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", max(rank, 0))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if size > count or (dev.index or 0) >= count:
            raise ValueError(f"a mesh of {size} CUDA ranks needs {size} "
                             f"cards; this machine has {count}")
    return RayMesh(group=group, rank=rank, size=size, ranks=ranks,
                   device=dev)


def _member(mesh: RayMesh) -> None:
    if mesh.rank < 0:
        raise ValueError("this rank is not in the mesh")


def shard_rays(rays: Rays, mesh: RayMesh) -> Rays:
    """This rank's contiguous slice of the batch's leading axis, on its
    device (rank r of n takes rows ``[r L / n, (r + 1) L / n)``)."""
    _member(mesh)
    lead = rays.org.shape[0]
    if lead % mesh.size:
        raise ValueError(f"ray batch {lead} not divisible by mesh size "
                         f"{mesh.size}")
    m = lead // mesh.size
    a = mesh.rank * m
    return Rays(*(torch.as_tensor(x)[a:a + m].to(mesh.device).contiguous()
                  for x in rays))


def replicate(tree, mesh: RayMesh):
    """``tree`` with every array and tensor in it (through NamedTuples
    and dataclasses) a tensor on this rank's device; other leaves
    unchanged."""
    dev = mesh.device
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(x, mesh) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def psum(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks (``jax.lax.psum``); an
    ``all_reduce`` on any mesh with a process group, one rank included."""
    if mesh.group is not None:
        x = x.clone()
        torch.distributed.all_reduce(x, group=mesh.group)
    return x


def pmean(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Mean of ``x`` over the mesh's ranks (``jax.lax.pmean``)."""
    return psum(x, mesh) / mesh.size


def all_gather(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis in rank
    order: the whole batch of a ``P('rays')``-sharded result (an
    ``all_gather`` on any mesh with a process group)."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def _gather_hits(h: Hits, mesh: RayMesh) -> Hits:
    return Hits(*(all_gather(x, mesh) for x in h))


def _n_hit(h: Hits, mesh: RayMesh) -> torch.Tensor:
    return psum((h.prim_id != INVALID_PRIM_ID).sum(), mesh)


def sharded_traverse_triangles(
    bvh,
    mesh_geom: TriangleMesh,
    rays: Rays,
    device_mesh: RayMesh,
    options: BVHTraceOptions = BVHTraceOptions(),
    max_leaf: int = 4,
    max_stack: int = 64,
):
    """Traverse a ray batch sharded across ``device_mesh`` on the stack
    engine (the BVH stays on the host, as that engine reads it; the
    geometry is replicated on the rank's device).

    Returns (the whole batch's hits, total hit count), the same on every
    rank. The leading ray axis must be divisible by the mesh size."""
    rays_s = shard_rays(rays, device_mesh)
    geom_r = replicate(mesh_geom, device_mesh)
    hits = traverse_triangles(bvh, geom_r, rays_s, options,
                              max_leaf=max_leaf, max_stack=max_stack)
    return _gather_hits(hits, device_mesh), _n_hit(hits, device_mesh)


def sharded_traverse_wavefront(
    packed,
    rays: Rays,
    device_mesh: RayMesh,
    options: BVHTraceOptions = BVHTraceOptions(),
    tile: int = 4096,
):
    """Wavefront (skip-link) engine over a sharded ray batch: packed
    tables replicated on every rank, rays data-parallel over the mesh.
    Returns (the whole batch's hits, total hit count)."""
    from ..traverse.wavefront import traverse_wavefront

    rays_s = shard_rays(rays, device_mesh)
    packed_r = replicate(packed, device_mesh)
    hits = traverse_wavefront(packed_r, rays_s, options, tile=tile)
    return _gather_hits(hits, device_mesh), _n_hit(hits, device_mesh)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-30)`` row-wise (``jnp.linalg.norm``: the squares
    summed x, y, z, a correctly rounded root)."""
    n = sqrt(dot(x, x))[:, None]
    return x / torch.clamp_min(n, 1e-30)


def sharded_render_step(
    bvh,
    mesh_geom: TriangleMesh,
    rays: Rays,
    device_mesh: RayMesh,
    seed=None,
    options: BVHTraceOptions = BVHTraceOptions(),
    max_leaf: int = 4,
    max_stack: int = 64,
    draws=None,
):
    """One full data-parallel render step over the mesh: primary
    visibility, one cosine-lobe occlusion bounce and the shading, each
    rank on its slice, with the hit count summed and the mean AO averaged
    over the ranks (the framework's "full step" for multi-device
    validation, ``dryrun_multichip``).

    Returns (the whole batch's AO, total hit count, mean AO).

    ``seed`` (default 0) takes the place of the JAX package's threefry
    ``key``: rank r draws its (L / n, 3) uniforms from a
    ``torch.Generator`` on its device seeded with ``(seed << 32) | r``,
    where JAX draws ``uniform(fold_in(key, r))``. ``draws``: an (L, 3)
    array of the whole batch's uniforms, rank r's in rows
    ``[r L / n, (r + 1) L / n)``, used in place of the generator (the
    tests pass the JAX draws)."""
    mesh = device_mesh
    rays_s = shard_rays(rays, mesh)
    geom = replicate(mesh_geom, mesh)
    dev = mesh.device

    def trace(r):
        return traverse_triangles(bvh, geom, r, options, max_leaf=max_leaf,
                                  max_stack=max_stack)

    hits = trace(rays_s)
    hit = hits.prim_id != INVALID_PRIM_ID
    fid = torch.where(hit, hits.prim_id, 0)
    tri_v = geom.vertices[geom.faces.long()[fid]]
    n = cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    n = _unit(n)
    n = torch.where((dot(n, rays_s.dir) > 0)[:, None], -n, n)
    p = rays_s.org + hits.t[:, None] * rays_s.dir
    m = rays_s.org.shape[0]
    if draws is not None:
        a = mesh.rank * m
        u = torch.as_tensor(np.asarray(draws, np.float32)[a:a + m],
                            device=dev)
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(((int(seed or 0) << 32) | mesh.rank) % 2**64)
        u = torch.rand((m, 3), generator=g, device=dev)
    d2 = _unit(n + 0.999 * (2.0 * u - 1.0))
    zero = torch.zeros((), device=dev)
    sec = Rays(
        org=(p + 1e-4 * n).contiguous(),
        dir=d2.contiguous(),
        min_t=torch.zeros_like(hits.t),
        max_t=torch.where(hit, torch.full((), 1e30, device=dev), zero),
    )
    occ = trace(sec)
    ao = (hit & (occ.prim_id == INVALID_PRIM_ID)).to(torch.float32)
    n_hit = psum(hit.sum(), mesh)
    mean_ao = pmean(ao.mean(), mesh)
    return all_gather(ao, mesh), n_hit, mean_ao
