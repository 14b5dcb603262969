"""objrender: the reference's minimal renderer, plus ambient occlusion
(port of ``nanort_tpu.models.objrender``; config A of the benchmarks).

Reproduces examples/objrender/main.cc:581-709 as one whole-frame batch:
camera rays -> BVH traversal -> normal-shaded RGB + the GUI's AOV set
(normal/position/depth/texcoord/prim_id, gui/render-config.h:34-41), and
the ambient-occlusion pass: cosine-hemisphere occlusion rays with a
per-ray skip of the hit primitive.

Two engines trace, as in the JAX package: with ``scene8`` (BVH8/BVH16
tables on the rays' device) the primary pass and the occlusion megabatch
go through ``traverse.packet.traverse_bvh8`` (the K1 kernel on the card,
its plain version on the CPU); without it, through the reference-exact
stack engine ``traverse.stack.traverse_triangles`` (plain torch). The
fused one-launch AO pass is ``models/ao_fused.py``. On the card the AOVs
of the records are one launch of ``csrc/aovs.cu`` (``aovs_from_hits``).

Random draws: the JAX package draws the hemisphere directions from
threefry keys; here they come from a ``torch.Generator`` on the rays'
device seeded with ``seed``. ``render_ao(..., draws=)`` takes the JAX
package's ``ao_hemisphere_draws`` output instead, so that a test renders
from the same numbers. The arithmetic after the draws is the JAX
package's op for op (every product its own op, sums over xyz as
``(x + y) + z``, the AO mean as a product with the rounded ``1 / S``, as
XLA turns the division by a constant), so with those draws the AO image
is the JAX package's bit for bit (tests/test_torch_objrender.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.math import cross, normalize
from ..core.options import BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import Hits, Rays, make_rays
from ..ops.triangle import TriangleMesh
from ..traverse import _ext
from ..traverse.stack import traverse_triangles
from ..utils import trace

AO_EPS = 1e-4  # hit-point offset along the normal (JAX objrender.py:248)

trace.declare_launches("aovs_fused")


class MeshAttributes(NamedTuple):
    """Optional facevarying shading attributes, the reference example
    Mesh layout (objrender/main.cc Mesh: facevarying normals/uvs)."""

    normals: torch.Tensor | None = None  # (F, 3, 3) facevarying
    uvs: torch.Tensor | None = None  # (F, 3, 2) facevarying


def _mesh_on(mesh: TriangleMesh, dev) -> TriangleMesh:
    return TriangleMesh(torch.as_tensor(mesh.vertices, device=dev),
                        torch.as_tensor(mesh.faces, device=dev).long())


def _face_ids(mesh: TriangleMesh, fids: torch.Tensor) -> torch.Tensor:
    """``fids`` as indices; a miss's 0xFFFFFFFF reads the last face, as
    the JAX package's ``jnp.take`` reads the int32 index -1 (the value is
    masked out of every AOV)."""
    n = mesh.faces.shape[0]
    fids = fids.long()
    return torch.where(fids == INVALID_PRIM_ID, n - 1, fids)


def face_normals(mesh: TriangleMesh, fids: torch.Tensor) -> torch.Tensor:
    """Geometric normals for a batch of face ids (mesh fields on the ids'
    device)."""
    f = mesh.faces[_face_ids(mesh, fids)]
    tri = mesh.vertices[f]
    n = cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    return normalize(n)


def shading_normals(mesh: TriangleMesh, attrs: MeshAttributes | None,
                    hits) -> torch.Tensor:
    """Interpolated vertex normals when available, else geometric
    (objrender/main.cc:662-676 equivalent)."""
    fids = hits.prim_id
    if attrs is None or attrs.normals is None:
        return face_normals(mesh, fids)
    n = torch.as_tensor(attrs.normals, device=fids.device)[
        _face_ids(mesh, fids)]  # (..., 3, 3)
    w = (1.0 - hits.u - hits.v)[..., None]
    return normalize(w * n[..., 0, :] + hits.u[..., None] * n[..., 1, :]
                     + hits.v[..., None] * n[..., 2, :])


def _traverse_primary(bvh, mesh, rays, options, max_leaf, scene8,
                      specialize=None):
    """Primary-visibility traversal. With ``scene8``, image-shaped
    batches go through the packet kernel in one launch over the rays as
    they lie (raster order, no tiled copy), other shapes through
    ``traverse_bvh8_sorted`` (``packet.traverse_image``). Without
    ``scene8``, the stack engine."""
    if scene8 is None:
        return traverse_triangles(bvh, mesh, rays, options, max_leaf=max_leaf)
    from ..traverse.packet import traverse_image

    return traverse_image(scene8, rays, options, specialize)


@trace.span("render_aovs")
def render_aovs(bvh, mesh: TriangleMesh, rays: Rays,
                attrs: MeshAttributes | None = None,
                options: BVHTraceOptions = BVHTraceOptions(),
                max_leaf: int = 4, scene8=None, specialize=None):
    """One primary-visibility pass returning ``(aovs, hits)``. Pass
    ``scene8`` (a ``build.bvh8.BVH8Scene`` on the rays' device) to trace
    through the packet kernel; ``specialize`` is forwarded to it. Without
    ``scene8`` the stack engine traces ``bvh``."""
    hits = _traverse_primary(bvh, mesh, rays, options, max_leaf, scene8,
                             specialize)
    return aovs_from_hits(mesh, attrs, rays, hits), hits


@trace.span("aovs")
def aovs_from_hits(mesh, attrs, rays, hits) -> dict:
    """AOV dict from primary-hit records (shared with the fused AO pass,
    so both emit identical AOVs for identical records). Float32 rays and
    ``Hits`` on a CUDA device, with a float32 mesh (moved there if it is
    elsewhere) of int32 or int64 faces and float32 facevarying normals if
    any, take one launch of ``csrc/aovs.cu`` (counted as ``aovs_fused``);
    every other input, the CPU's and float64 among them, takes
    ``_aovs_plain``. Both give the same bits; a hit's prim id that names
    no face (or a face's vertex id that names no vertex) fails the launch,
    as the plain version's gather fails."""
    dev = rays.org.device
    if dev.type == "cuda":
        verts = torch.as_tensor(mesh.vertices, device=dev)
        faces = torch.as_tensor(mesh.faces, device=dev)
        fnrm = None if attrs is None or attrs.normals is None else \
            torch.as_tensor(attrs.normals, device=dev)
        if _fused_takes(verts, faces, fnrm, rays, hits):
            return _aovs_fused(verts, faces, fnrm, rays, hits)
        mesh = TriangleMesh(verts, faces)
    return _aovs_plain(mesh, attrs, rays, hits)


def _fused_takes(verts, faces, fnrm, rays, hits) -> bool:
    """Whether ``_aovs_fused`` takes these inputs."""
    if not isinstance(hits, Hits):
        return False
    bs = rays.batch_shape
    f32 = [rays.org, rays.dir, hits.t, hits.u, hits.v, verts]
    if fnrm is not None:
        if fnrm.ndim != 3 or tuple(fnrm.shape[1:]) != (3, 3):
            return False
        f32.append(fnrm)
    return (all(x.dtype == torch.float32 for x in f32)
            and hits.prim_id.dtype == torch.int64
            and faces.dtype in (torch.int32, torch.int64)
            and all(x.device == rays.org.device
                    for x in f32 + [hits.prim_id])
            and tuple(rays.dir.shape) == tuple(rays.org.shape)
            and all(tuple(x.shape) == bs for x in hits)
            and verts.ndim == 2 and verts.shape[1] == 3
            and faces.ndim == 2 and faces.shape[1] == 3)


def _aovs_fused(verts, faces, fnrm, rays, hits) -> dict:
    """``_aovs_plain``'s dict from one launch of ``csrc/aovs.cu``."""
    dev = rays.org.device
    bs = rays.batch_shape
    f32 = dict(dtype=torch.float32, device=dev)
    rgb, nrm, pos = (torch.empty(bs + (3,), **f32) for _ in range(3))
    depth = torch.empty(bs, **f32)
    uv = torch.empty(bs + (2,), **f32)
    hit = torch.empty(bs, dtype=torch.bool, device=dev)
    t, u, v, pid, org, dir, faces, verts = (
        x.contiguous() for x in (*hits, rays.org, rays.dir, faces, verts))
    fnrm = None if fnrm is None else fnrm.contiguous()
    _ext.launch(
        "aovs", "nrt_aovs", t, u, v, pid, org, dir, faces,
        faces.element_size(), verts, fnrm, rgb, nrm, pos, depth, uv, hit,
        t.numel(), (faces if fnrm is None else fnrm).shape[0],
        verts.shape[0], device=dev, count="aovs_fused")
    return {"rgb": rgb, "normal": nrm, "position": pos, "depth": depth,
            "texcoord": uv, "prim_id": hits.prim_id, "hit": hit}


def _aovs_plain(mesh, attrs, rays, hits) -> dict:
    """The AOVs in plain torch, the kernel's reference."""
    dev = rays.org.device
    mesh = _mesh_on(mesh, dev)
    hit = hits.hit
    n = shading_normals(mesh, attrs, hits)
    h3 = hit[..., None]
    zero = torch.zeros((), dtype=n.dtype, device=dev)
    rgb = torch.where(h3, 0.5 * n + 0.5, zero)
    pos = rays.org + hits.t[..., None] * rays.dir
    return {
        "rgb": rgb,
        "normal": torch.where(h3, n, zero),
        "position": torch.where(h3, pos, zero),
        "depth": torch.where(hit, hits.t, zero),
        "texcoord": torch.stack([hits.u, hits.v], dim=-1),
        "prim_id": hits.prim_id,
        "hit": hit,
    }


def _cosine_hemisphere(generator, shape, dtype, device, stratum=None,
                       n_strata=1):
    """Cosine-weighted hemisphere directions around +z (the reference's
    revised-ONB sampler, path_tracer/main.cc:214-250). ``stratum`` (a
    tensor broadcasting against ``shape``) jitters the azimuth inside
    wedge [stratum, stratum+1) * 2pi/n."""
    u1 = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u2 = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    if stratum is not None:
        u2 = (stratum + u2) / n_strata
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)


def ao_hemisphere_draws(generator: torch.Generator, n_samples: int, shape,
                        dtype=torch.float32, stratified: bool = True):
    """The AO recipe's per-sample local hemisphere directions,
    ``(n_samples,) + shape + (3,)``, on ``generator``'s device. Shared by
    ``render_ao`` and the fused AO pass so that both draw alike.

    ``stratified`` (default) gives sample s the azimuth wedge
    [s, s+1) * 2pi/S: an equal-or-lower-variance estimator whose
    sample-major occlusion megabatch comes out direction-presorted."""
    S = int(n_samples)
    shape = (S,) + tuple(shape)
    dev = generator.device
    stratum = None
    if stratified:
        stratum = torch.arange(S, dtype=dtype, device=dev).reshape(
            (S,) + (1,) * (len(shape) - 1))
    return _cosine_hemisphere(generator, shape, dtype, dev, stratum, S)


def build_onb(n: torch.Tensor):
    """Branchless Frisvad-style orthonormal basis around ``n`` (..., 3)."""
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones((), dtype=n.dtype, device=n.device)
    s = torch.where(n2 >= 0.0, one, -one)
    a = -one / (s + n2)
    b = n0 * n1 * a
    t = torch.stack([1.0 + s * (n0 * n0) * a, s * b, -s * n0], dim=-1)
    bt = torch.stack([b, s + (n1 * n1) * a, -n1], dim=-1)
    return t, bt


@trace.span("ao.draws")
def resolve_draws(rays: Rays, seed, n_samples: int, stratified: bool,
                  draws=None) -> torch.Tensor:
    """The hemisphere draws of an AO pass over ``rays``: ``draws`` if
    given (checked against ``(S,) + batch + (3,)``), else fresh ones from
    a ``torch.Generator`` on the rays' device seeded with ``seed``."""
    S = int(n_samples)
    bs = rays.batch_shape
    dev, dt = rays.org.device, rays.org.dtype
    if draws is not None:
        draws = torch.as_tensor(draws, dtype=dt, device=dev)
        if tuple(draws.shape) != (S,) + bs + (3,):
            raise ValueError(f"draws must be (n_samples,) + batch + (3,) = "
                             f"{(S,) + bs + (3,)}: {tuple(draws.shape)}")
        return draws
    if seed is None:
        raise ValueError("render_ao needs a seed or draws")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return ao_hemisphere_draws(gen, S, bs, dt, stratified)


@trace.span("render_ao")
def render_ao(bvh, mesh: TriangleMesh, rays: Rays, seed: int | None = None,
              n_samples: int = 8, ao_radius: float = 1e30,
              options: BVHTraceOptions = BVHTraceOptions(),
              max_leaf: int = 4, scene8=None, specialize=None,
              stratified: bool = True, draws=None, **trace_kw):
    """Ambient occlusion: the fraction of unoccluded cosine-hemisphere
    samples from each primary hit point. Returns ``(aovs, hits)`` with
    ``aovs["ao"]`` and ``aovs["rgb"]`` the AO image. Secondary rays skip
    the hit primitive (skip_prim_id, nanort.h:611-614) and start 1e-4
    off the surface along the normal, which faces the incoming ray.

    All ``n_samples`` occlusion rays per pixel trace as ONE sample-major
    megabatch; with ``scene8`` and an image whose sides are multiples of
    32 the megabatch is ordered in 32x32 pixel tiles (and the AO sum
    scattered back), so a warp holds one azimuth wedge over one compact
    tile. Pixels whose primary ray missed launch dead occlusion rays
    (``max_t < min_t``). ``trace_kw`` takes ``octant_major=True`` (sort
    the megabatch, ``traverse_bvh8_sorted``); the JAX package's TPU
    scheduling knobs (``sub``, ``pop_n``, ...) are refused.

    ``seed`` seeds the draws (``ao_hemisphere_draws``); ``draws`` hands
    in ready ones, ``(n_samples,) + rays.batch_shape + (3,)``."""
    octant_major = bool(trace_kw.pop("octant_major", False))
    if trace_kw:
        raise ValueError(
            f"render_ao: {sorted(trace_kw)} is a TPU scheduling knob of the "
            "JAX package's packet kernel and changes nothing here; the port "
            "takes only octant_major")
    S = int(n_samples)
    d_local = resolve_draws(rays, seed, S, stratified, draws)
    aovs, hits = render_aovs(bvh, mesh, rays, None, options, max_leaf,
                             scene8, specialize)
    with trace.span("ao.rays"):
        hit = hits.hit
        dt, dev = rays.dtype, rays.org.device
        n = aovs["normal"]
        # face the normal toward the incoming ray; the sum over xyz is
        # (x + y) + z, the JAX package's reduction order
        nd = n * rays.dir
        n = torch.where(
            ((nd[..., 0] + nd[..., 1]) + nd[..., 2])[..., None] > 0, -n, n)
        p = aovs["position"]
        t, bt = build_onb(n)
        eps = torch.tensor(AO_EPS, dtype=dt, device=dev)

        d = (d_local[..., 0:1] * t[None] + d_local[..., 1:2] * bt[None]
             + d_local[..., 2:3] * n[None])
        org = (p + eps * n)[None].expand(d.shape)
        # pixels whose primary ray missed launch DEAD occlusion rays
        far = torch.where(hit, torch.tensor(ao_radius, dtype=dt, device=dev),
                          torch.tensor(-1.0, dtype=dt, device=dev))
        far = far[None].expand(d.shape[:-1])
        skip = hits.prim_id[None].expand((S,) + tuple(hit.shape))

        # 32x32 pixel tiling of the occlusion megabatch, inverted after the
        # occlusion sum
        tile_pix = None
        if (scene8 is not None and hit.ndim == 2 and hit.shape[0] % 32 == 0
                and hit.shape[1] % 32 == 0):
            H, W = hit.shape
            tp = np.arange(H * W).reshape(H // 32, 32, W // 32, 32)
            tile_pix = torch.as_tensor(np.swapaxes(tp, 1, 2).reshape(-1),
                                       device=dev)

        def occ_layout(x):
            # (S,) + image dims (+ trailing comps) -> flat megabatch order
            flat = x.reshape((S, -1) + tuple(x.shape[1 + hit.ndim:]))
            if tile_pix is not None:
                flat = flat[:, tile_pix]
            return flat.reshape((-1,) + tuple(flat.shape[2:]))

        sec = make_rays(occ_layout(org), occ_layout(d), min_t=0.0,
                        max_t=occ_layout(far))
        sec_skip = occ_layout(skip)
    if scene8 is not None:
        from ..traverse.packet import traverse_bvh8

        if octant_major:
            from ..traverse.ray_sort import traverse_bvh8_sorted

            occ = traverse_bvh8_sorted(
                scene8, sec, options, skip_prim_id=sec_skip,
                occlusion=True, octant_major=True)
        else:
            occ = traverse_bvh8(scene8, sec, options,
                                skip_prim_id=sec_skip, occlusion=True)
    else:
        occ = traverse_triangles(bvh, mesh, sec, options,
                                 skip_prim_id=sec_skip,
                                 max_leaf=max_leaf)
    with trace.span("ao.reduce"):
        unocc = (~occ.hit).reshape(S, -1).to(dt)
        # the mean over samples as XLA computes x / S: x * (1 / S)
        open_tiled = unocc.sum(0) * (torch.ones((), dtype=dt, device=dev) / S)
        if tile_pix is not None:
            back = torch.empty_like(open_tiled)
            back[tile_pix] = open_tiled
            open_tiled = back
        ao = torch.where(hit, open_tiled.reshape(hit.shape),
                         torch.zeros((), dtype=dt, device=dev))
        rgb = ao[..., None].expand(tuple(ao.shape) + (3,)).contiguous()
    return {**aovs, "ao": ao, "rgb": rgb}, hits
