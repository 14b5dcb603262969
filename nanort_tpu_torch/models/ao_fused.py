"""Fused ambient occlusion: the primary hit and every hemisphere occlusion
sample of a pixel in ONE kernel launch (port of
``nanort_tpu.models.ao_fused``, K5).

``render_ao_fused`` computes what ``models/objrender.render_ao`` computes
(config A: camera rays -> watertight closest hit -> geometric normal
facing the ray -> Frisvad basis -> ``n_samples`` occlusion traces along
the caller's cosine-hemisphere draws -> unoccluded fraction), and returns
the same ``(aovs, hits)`` contract. On CUDA tensors it launches
``csrc/ao_fused.cu``: persistent warps on ``ao_grid``'s grid claim
32-pixel tiles, each lane traces its pixel's primary, and the tile's hit
pixels' occlusion samples are shared across the 32 lanes, sample-major;
every trace goes through the in-kernel BVH16 trace K2 with the watertight
test and a per-ray skip of the hit prim. On CPU tensors it runs the plain
torch version ``_ao_fused_reference``, which agrees with the kernel bit
for bit.

Against ``render_ao`` the records follow the repository's tie contract:
K2's rules are not K1's (NaN-propagating slab folds, a closest hit at
exactly ``tt == tmax`` is a miss, its own ``t`` formula), so the hit
masks agree, the prim only differs between hits at bit-equal t, t lies
within a few ulp, and the AO images agree on almost every pixel.

Draws: from a ``torch.Generator`` seeded with ``seed``, or ``draws=``
(the JAX package's ``ao_hemisphere_draws`` output, for the tests), as in
``render_ao``. Left out: the TPU's ``sub`` block height and its
``interpret`` switch, which change no result, and its
``(8 + 3S, NB, sub, 128)`` ray-block layout: the kernel reads flat
``(R, 3)`` rays and ``(S, R, 3)`` draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.options import INVALID_PRIM_ID
from ..core.ray import PRIM_ID_DTYPE, Hits
from ..traverse import _ext, fused_trace
from ..utils import trace
from .objrender import (AO_EPS, _mesh_on, aovs_from_hits, face_normals,
                        resolve_draws)

# Kernel launches by ao_fused_outputs (never by the plain version),
# counted in utils.trace as "ao_fused"; each also runs K2 and counts as
# "bvh16_trace_watertight".
trace.declare_launches("ao_fused")
# The last launch's occlusion items, hit pixels x S (a 0-d int64 tensor on
# the card, read without a synchronisation); None before the first.
LAST_ITEMS = None
THREADS = 128  # a block of K5: four warps, each claiming 32-pixel tiles


@trace.span("build.aux")
def build_ao_aux(mesh, s8) -> torch.Tensor:
    """Aux rows (``fused_trace.build_aux_rows``) whose normals are
    ``objrender.face_normals``, the normals ``render_ao`` shades with; on
    the device of ``s8``'s tables. Bit-identical to the JAX package's
    table where its normals are computed without FMA contraction."""
    m = _mesh_on(mesh, "cpu")
    F = int(m.faces.shape[0])
    gn = face_normals(m, torch.arange(F)).to(torch.float32).numpy()
    leafs = s8.leafs
    dev = leafs.device if isinstance(leafs, torch.Tensor) else "cpu"
    if isinstance(leafs, torch.Tensor):
        leafs = leafs.cpu().numpy()
    aux = fused_trace.build_aux_rows(
        leafs, np.zeros(F, np.int32), m.faces.numpy(), m.vertices.numpy(),
        s8.max_leaf, gn_unit=gn)
    return torch.from_numpy(aux).to(dev)


def _ao_fused_reference(nodes, leafs, aux, org, dir, tmin, tmax, draws,
                        ao_radius: float, slots: int, stats=None):
    """Plain torch version of K5 on flat rays ``(R, 3)`` and draws
    ``(S, R, 3)``: the kernel's steps with its arithmetic, every trace
    through ``trace_bvh16_reference`` (watertight). Returns ``(ao, t, u,
    v, prim_id, hit)`` as the kernel writes them. ``stats``, a dict,
    gains the traces' node pops and triangle tests and ``"samples"``, the
    occlusion rays of hit pixels (each also shades one sample)."""
    S = draws.shape[0]
    dev = org.device
    trace = fused_trace.trace_bvh16_reference
    rec = trace(nodes, leafs, aux, org, dir, tmin, tmax, False, slots,
                stats=stats, intersector="watertight")
    hit = rec.hit
    zero = torch.zeros((), device=dev)
    n = torch.where(hit[:, None], rec.normal, zero)
    nx, ny, nz = n.unbind(1)
    dx, dy, dz = dir.unbind(1)
    flip = nx * dx + ny * dy + nz * dz > 0
    nx, ny, nz = (torch.where(flip, -c, c) for c in (nx, ny, nz))
    eps = torch.tensor(AO_EPS, dtype=torch.float32, device=dev)
    ox, oy, oz = org.unbind(1)
    p = torch.stack([ox + rec.t * dx + eps * nx, oy + rec.t * dy + eps * ny,
                     oz + rec.t * dz + eps * nz], 1)
    one = torch.ones((), device=dev)
    s = torch.where(nz >= 0.0, one, -one)
    a = -one / (s + nz)
    b = nx * ny * a
    tx, ty, tz = 1.0 + s * nx * nx * a, s * b, -s * nx
    bx, by, bz = b, s + ny * ny * a, -ny
    far = torch.where(hit, torch.tensor(ao_radius, dtype=torch.float32,
                                        device=dev), -one)
    t0 = torch.zeros_like(far)
    unocc = torch.zeros(org.shape[0], dtype=torch.int32, device=dev)
    for k in range(S):
        l0, l1, l2 = draws[k].unbind(1)
        w = torch.stack([l0 * tx + l1 * bx + l2 * nx,
                         l0 * ty + l1 * by + l2 * ny,
                         l0 * tz + l1 * bz + l2 * nz], 1)
        occ = trace(nodes, leafs, None, p, w, t0, far, True, slots,
                    stats=stats, intersector="watertight", skip=rec.prim_id)
        unocc += (~occ).int()
    if stats is not None:
        stats["samples"] = stats.get("samples", 0) + S * int(hit.sum())
    inv_s = torch.ones((), device=dev) / S
    ao = torch.where(hit, unocc.float() * inv_s, zero)
    return ao, rec.t, rec.u, rec.v, rec.prim_id, hit


def ao_fused_outputs(nodes, leafs, aux, org, dir, tmin, tmax, draws,
                     ao_radius: float, slots: int):
    """K5 on flat rays ``(R, 3)`` and draws ``(S, R, 3)``, all contiguous
    float32 on one device with the checked tables
    (``fused_trace._check_tables``): ``(ao, t, u, v, prim_id, hit)`` as
    the kernel writes them (prim id int32, -1 on a miss; hit bool). On
    CUDA tensors it launches ``csrc/ao_fused.cu``, on CPU tensors it runs
    ``_ao_fused_reference``."""
    global LAST_ITEMS
    dev = org.device
    if dev.type == "cpu":
        return _ao_fused_reference(nodes, leafs, aux, org, dir, tmin, tmax,
                                   draws, float(ao_radius), slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S, R = draws.shape[0], org.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    ao, t, u, v = (torch.empty(R, **f32) for _ in range(4))
    pid = torch.empty(R, dtype=torch.int32, device=dev)
    hit = torch.empty(R, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = torch.zeros(2, dtype=torch.int64, device=dev)
    occ = ao_occupancy(dev)
    grid = ao_grid(R, occ["blocks_per_sm"], occ["sms"])
    # counted as K2 too, which runs inside
    _ext.launch(
        "ao_fused", "nrt_ao_fused", nodes, leafs, aux, org, dir, tmin, tmax,
        draws, ao, t, u, v, pid, hit, err, scratch, R, S,
        float(np.float32(ao_radius)), float(np.float32(1.0) / np.float32(S)),
        slots, grid, device=dev, count=("ao_fused", "bvh16_trace_watertight"))
    LAST_ITEMS = scratch[1]
    fused_trace.check_overflow(err, slots)
    return ao, t, u, v, pid, hit != 0


def ao_grid(n: int, blocks_per_sm: int, sms: int) -> int:
    """K5's grid for ``n`` pixels (``_ext.resident_grid``: the resident
    blocks, or one tile a warp for a smaller batch)."""
    return _ext.resident_grid(n, blocks_per_sm, sms, THREADS)


def ao_occupancy(device=None) -> dict:
    """What the card's occupancy API and the compiled kernel say of K5:
    resident ``blocks_per_sm``, ``registers`` and ``local_bytes`` (stack
    and spill) a thread, ``threads`` and static ``shared_bytes`` a block,
    and the card's ``sms``. Cached per device."""
    return _ext.occupancy(
        "ao_fused", "nrt_ao_fused_occupancy",
        ("blocks_per_sm", "registers", "local_bytes", "threads",
         "shared_bytes"), device=device)


@trace.span("k5")
def render_ao_fused(mesh, rays, seed: int | None, s8, aux,
                    n_samples: int = 8, ao_radius: float = 1e30,
                    stratified: bool = True, attrs=None, draws=None):
    """One-launch AO pass; returns the same ``(aovs, hits)`` contract as
    ``objrender.render_ao``. ``s8`` is a width-16 ``BVH8Scene`` of
    ``mesh`` and ``aux`` its ``build_ao_aux`` rows, both on the rays'
    device; ``rays`` are float32 of any batch shape. ``seed`` seeds the
    hemisphere draws, or ``draws`` ``(n_samples,) + batch + (3,)`` hands
    them in."""
    S = int(n_samples)
    if S < 1:
        raise ValueError(f"n_samples must be >= 1: {S}")
    bs = rays.batch_shape
    dev = rays.org.device
    if rays.org.dtype != torch.float32:
        raise ValueError("render_ao_fused traces float32 rays")
    org = rays.org.reshape(-1, 3).contiguous()
    dir = rays.dir.reshape(-1, 3).contiguous()
    tmin = rays.min_t.reshape(-1).contiguous()
    tmax = rays.max_t.reshape(-1).contiguous()
    R = org.shape[0]
    d_local = resolve_draws(rays, seed, S, stratified, draws)
    d_local = d_local.reshape(S, R, 3).contiguous()
    nodes, leafs, aux_t, slots = fused_trace._check_tables(s8, aux, dev)
    ao, t, u, v, pid, hit = ao_fused_outputs(
        nodes, leafs, aux_t, org, dir, tmin, tmax, d_local, ao_radius, slots)
    hit = hit.reshape(bs)
    zero = torch.zeros((), device=dev)
    hits = Hits(
        t=torch.where(hit, t.reshape(bs), rays.max_t.reshape(bs)),
        u=torch.where(hit, u.reshape(bs), zero),
        v=torch.where(hit, v.reshape(bs), zero),
        prim_id=torch.where(hit, pid.reshape(bs).to(PRIM_ID_DTYPE),
                            INVALID_PRIM_ID))
    ao = ao.reshape(bs)
    aovs = aovs_from_hits(mesh, attrs, rays, hits)
    rgb = ao[..., None].expand(tuple(bs) + (3,)).contiguous()
    return {**aovs, "ao": ao, "rgb": rgb}, hits
