"""What the reference makes of the rays of a K1 cell, and how a record
is judged against it (plain torch).

A ray's record is off when
* the program and the reference disagree on hit or miss;
* or both hit and the program's t lies more than ``T_TOL`` x (t + 1)
  from the reference's;
* or the program names another triangle than the reference and the
  reference's hit point lies farther than ``POS_TOL`` x (1 + its largest
  coordinate) from that triangle where the ray meets its plane (between
  hits at equal t either may win, and float32 geometry or rays move a
  hit across a shared edge by that much);
* or, where both name one triangle and the cell compares them, the
  point that the program's u, v name on it lies farther than that from
  the point the reference's name.
The tolerances are in world units, not in barycentrics: the ring's
sphere triangles are ~1e-3 across, so a float32 rounding of a vertex or
a ray direction (~5e-7 at these coordinates) moves u or v by ~1e-4 there.
Both tolerances grow as 1 / |cos| of the angle between the ray and the
reference triangle's normal (at most 100-fold): a ray that grazes a
wall moves its hit along the wall, and its t, by its direction's
rounding over that cosine.
A pixel of an AO image is off when its primary record is off or its AO
value differs from the reference's at all (both are counts of eighths).
"""

from __future__ import annotations

import math

import torch

from .tracer import RefMesh

T_TOL = 1e-5
POS_TOL = 2e-6
AO_EPS = 1e-4  # the AO recipe's offset along the normal


def records_off(mesh: RefMesh, org, dirs, tmin, tmax, t, prim, u=None,
                v=None, ref=None):
    """Bool (n,): which of the program's records (``t``, ``prim`` with -1
    for a miss, optionally ``u``/``v``) are off. ``ref`` may hand in the
    reference's (t, u, v, prim) of these rays."""
    dev = mesh.device
    if ref is None:
        ref = mesh.closest(org, dirs, tmin, tmax)
    rt, ru, rv, rp = ref
    t = t.to(dev, torch.float64)
    prim = prim.to(dev).long()
    rt = rt.double()
    rh, ph = rp >= 0, prim >= 0
    off = rh != ph
    both = rh & ph
    e1, e2 = mesh.edges(rp.clamp(min=0))
    nrm = torch.linalg.cross(e1, e2)
    dd = dirs.to(dev, torch.float64)
    cos = ((nrm * dd).sum(1).abs()
           / (nrm.norm(dim=1) * dd.norm(dim=1)).clamp(min=1e-300))
    graze = 1.0 / cos.clamp(min=0.01)
    tol = T_TOL * (rt.abs() + 1.0) * graze
    off |= both & ~((t - rt).abs() <= tol)
    hit_p = org.to(dev, torch.float64) + rt[:, None] * dd
    slack = POS_TOL * (1.0 + hit_p.abs().amax(1)) * graze
    other = both & (prim != rp)
    if bool(other.any()):
        idx = other.nonzero().squeeze(1)
        tt = mesh.hit_t(org[idx], dirs[idx], prim[idx], slack[idx]).double()
        bad = ~((tt - rt[idx]).abs() <= tol[idx])
        off[idx[bad]] = True
    if u is not None:
        same = both & (prim == rp)
        du = u.to(dev, torch.float64) - ru.double()
        dv = v.to(dev, torch.float64) - rv.double()
        gap = (du[:, None] * e1 + dv[:, None] * e2).norm(dim=1)
        off |= same & ~(gap <= slack)
    return off


def face_normals(mesh_vertices, mesh_faces, prim, device, dtype):
    """Unit geometric normals of faces ``prim`` (n,) (zero where -1),
    from the benchmark's own arrays."""
    v = torch.as_tensor(mesh_vertices, device=device).to(dtype)
    f = torch.as_tensor(mesh_faces, device=device).long()
    tri = v[f[prim.clamp(min=0)]]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm(dim=1, keepdim=True).clamp(min=1e-30)
    return torch.where((prim >= 0)[:, None], n, torch.zeros_like(n))


def ao_local_draws(seed: int, n_samples: int, shape, device):
    """The AO recipe's hemisphere draws, (S,) + shape + (3,) float64:
    ``u1`` then ``u2``, each a ``torch.rand`` of (S,) + shape in float32
    from a ``torch.Generator`` on ``device`` seeded with ``seed``;
    sample s takes the azimuth wedge [s, s + 1) / S; the direction is
    (sqrt(u1) cos 2 pi u2, sqrt(u1) sin 2 pi u2, sqrt(1 - u1))."""
    S = int(n_samples)
    full = (S,) + tuple(shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u1 = torch.rand(full, generator=gen, dtype=torch.float32, device=device)
    u2 = torch.rand(full, generator=gen, dtype=torch.float32, device=device)
    stratum = torch.arange(S, device=device).reshape(
        (S,) + (1,) * len(shape)).float()
    u1, u2 = u1.double(), ((stratum + u2) / S).double()
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1)


def ao_reference(mesh: RefMesh, vertices, faces, org, dirs, local):
    """The reference's primary records and AO values of the rays
    ``org``/``dirs`` (n, 3) with hemisphere draws ``local`` (S, n, 3):
    ((t, u, v, prim), ao (n,)). The occlusion rays start ``AO_EPS`` off
    the hit along the normal turned toward the incoming ray, skip the hit
    triangle, and are blocked by any hit with 0 <= t <= 1e30."""
    dev, dt = mesh.device, mesh.dtype
    org, dirs = org.to(dev, dt), dirs.to(dev, dt)
    n_rays = org.shape[0]
    zeros = torch.zeros(n_rays, dtype=dt, device=dev)
    far = torch.full((n_rays,), 1e30, dtype=dt, device=dev)
    ref = mesh.closest(org, dirs, zeros, far)
    t, _, _, prim = ref
    hit = prim >= 0
    nrm = face_normals(vertices, faces, prim, dev, dt)
    flip = (nrm * dirs).sum(1) > 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    p = org + t[:, None] * dirs
    # the branchless Frisvad basis of the AO recipe
    n0, n1, n2 = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    s = torch.where(n2 >= 0.0, torch.ones_like(n2), -torch.ones_like(n2))
    a = -1.0 / (s + n2)
    b = n0 * n1 * a
    tb = torch.stack([1.0 + s * n0 * n0 * a, s * b, -s * n0], 1)
    bt = torch.stack([b, s + n1 * n1 * a, -n1], 1)
    local = local.to(dev, dt)
    S = local.shape[0]
    d = (local[..., 0:1] * tb[None] + local[..., 1:2] * bt[None]
         + local[..., 2:3] * nrm[None])
    o = (p + AO_EPS * nrm)[None].expand(d.shape)
    idx = hit.nonzero().squeeze(1)
    open_ = torch.zeros(n_rays, dtype=torch.float64, device=dev)
    if idx.numel():
        k = idx.numel()
        occ = mesh.any_hit(
            o[:, idx].reshape(-1, 3), d[:, idx].reshape(-1, 3),
            torch.zeros(S * k, dtype=dt, device=dev),
            torch.full((S * k,), 1e30, dtype=dt, device=dev),
            skip=prim[idx].repeat(S)).view(S, k)
        open_[idx] = (~occ).double().sum(0) / S
    return ref, open_
