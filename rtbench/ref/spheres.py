"""Plain torch ray-sphere queries and the sphere AOVs, the reference of the
point-cloud cells.

Brute force over the spheres that the benchmark made, with one level of
culling of its own, as ``tracer.RefMesh`` culls triangles: the spheres
are ordered by the Morton code of their centres and cut into clusters of
``leaf`` spheres, each with the box of its spheres' boxes (centre +-
radius) widened by a relative 1e-5. A ray tests the spheres of every
cluster whose box it meets within [tmin, tmax]. The culling changes which
spheres are tested, never the answer. Nothing here reads a tree, a table
or a record of the program.

The sphere test is the textbook one in the precision asked for (float64
for the records' reference, bfloat16 for the control): with oc = o - c,
a = d . d, h = d . oc and k = oc . oc - r^2, the roots are (-h -+
sqrt(h^2 - a k)) / a; a ray takes the near root if it is at least
tmin, else the far one, and hits where that root lies in [tmin, tmax)
(``ops/sphere.py``'s rules). In float64 the rounding of h^2 - a k at a
LiDAR tile's distances (|oc|^2 ~ 10^6 m^2) is ~10^-10 m^2 against r^2 ~
0.1. The closest hit wins, the lowest sphere id between hits at exactly
equal t. PostTraversal (upstream
``examples/particle_primitive/main.cc:268-283``) gives the hit's UV: with
n = (p - c) / |p - c|, u = (atan2(n.x, n.z) + pi) / (2 pi), v = acos(n.y)
/ pi.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .tracer import _morton_order

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (pair, sphere) tests a block holds at most
_BLOCK = 1 << 22


class RefSpheres:
    """Spheres laid out for the reference's queries, on ``device`` in
    ``dtype``. ``centers`` (N, 3) and ``radii`` (N,) are the benchmark's
    own arrays; prim ids are their indices."""

    def __init__(self, centers, radii, device, dtype=torch.float64,
                 leaf: int = 64):
        self.device = torch.device(device)
        dev = self.device
        c = torch.as_tensor(np.asarray(centers, np.float64), device=dev)
        r = torch.as_tensor(np.asarray(radii, np.float64).reshape(-1),
                            device=dev).expand(c.shape[0]).contiguous()
        order = _morton_order(c)
        n = c.shape[0]
        k = -(-n // leaf)
        ids = torch.full((k * leaf,), -1, dtype=torch.int64, device=dev)
        ids[:n] = order
        rows = torch.zeros((k * leaf, 4), dtype=torch.float64, device=dev)
        rows[:n, :3] = c[order]
        rows[:n, 3] = r[order]
        if n:
            rows[n:] = rows[n - 1]
        rows = rows.reshape(k, leaf, 4)
        lo = (rows[..., :3] - rows[..., 3:]).amin(1)
        hi = (rows[..., :3] + rows[..., 3:]).amax(1)
        pad = 1e-5 * (lo.abs() + hi.abs() + 1e-3)
        self.dtype = dtype
        self.leaf = leaf
        self.n = n
        self.rows = rows.to(dtype)
        self.ids = ids.reshape(k, leaf)
        # the boxes stay in float64: culling is not part of the answer
        self.lo = lo - pad
        self.hi = hi + pad
        self.centers = c.to(dtype)
        self.radii = r.to(dtype)

    def _pairs(self, org, dirs, tmin, tmax):
        """(ray, cluster) index pairs whose box the ray meets."""
        o = org.double()[:, None, :]
        d = dirs.double()
        inv = torch.where(d.abs() > 1e-300, 1.0 / d,
                          torch.where(torch.signbit(d), -math.inf, math.inf))
        inv = inv[:, None, :]
        t0 = (self.lo[None] - o) * inv
        t1 = (self.hi[None] - o) * inv
        tn = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf)
        tf = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf)
        near = tn.amax(2)
        far = tf.amin(2)
        ok = ((near <= far) & (far >= tmin.double()[:, None])
              & (near <= tmax.double()[:, None]))
        return ok.nonzero(as_tuple=True)

    def _blocks(self, org, dirs, tmin, tmax):
        n = org.shape[0]
        per = max(1, (1 << 24) // max(self.lo.shape[0], 1))
        step = max(1, _BLOCK // self.leaf)
        for r0 in range(0, n, per):
            r1 = min(n, r0 + per)
            ri, ci = self._pairs(org[r0:r1], dirs[r0:r1], tmin[r0:r1],
                                 tmax[r0:r1])
            ri = ri + r0
            for p0 in range(0, ri.numel(), step):
                yield ri[p0:p0 + step], ci[p0:p0 + step]

    def closest(self, org, dirs, tmin, tmax):
        """Closest hit with tmin <= t < tmax: (t, prim), t = tmax and prim
        -1 on a miss; between hits at exactly equal t the lowest id."""
        dev, dt = self.device, self.dtype
        org, dirs = org.to(dev, dt), dirs.to(dev, dt)
        tmin, tmax = tmin.to(dev, dt), tmax.to(dev, dt)
        n = org.shape[0]
        best = torch.full((n,), math.inf, dtype=dt, device=dev)
        parts = []
        for ri, ci in self._blocks(org, dirs, tmin, tmax):
            s = self.rows[ci]  # (pairs, leaf, 4)
            o = org[ri][:, None, :]
            d = dirs[ri][:, None, :]
            oc = o - s[..., :3]
            a = (d * d).sum(-1)
            h = (d * oc).sum(-1)
            k = (oc * oc).sum(-1) - s[..., 3] * s[..., 3]
            disc = h * h - a * k
            root = torch.sqrt(torch.clamp(disc, min=0.0))
            near = (-h - root) / a
            far = (-h + root) / a
            lo, hi = tmin[ri][:, None], tmax[ri][:, None]
            t = torch.where(near >= lo, near, far)
            ok = (disc >= 0) & (t >= lo) & (t < hi) & (self.ids[ci] >= 0)
            t = torch.where(ok, t, torch.full_like(t, math.inf))
            pt, _ = t.min(1)
            keep = torch.isfinite(pt)
            if not bool(keep.any()):
                continue
            ri, ci, pt, t = ri[keep], ci[keep], pt[keep], t[keep]
            ids = torch.where(t == pt[:, None], self.ids[ci],
                              torch.full_like(self.ids[ci], 1 << 62))
            pid = ids.amin(1)
            best.scatter_reduce_(0, ri, pt, "amin")
            parts.append((ri, pt, pid))
        t = torch.where(torch.isfinite(best), best, tmax)
        prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if parts:
            ri, pt, pid = (torch.cat(x) for x in zip(*parts))
            cand = pt == best[ri]
            low = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
            low.scatter_reduce_(0, ri[cand], pid[cand], "amin")
            prim = torch.where(low < (1 << 62), low, prim)
        return t, prim

    def surface(self, org, dirs, t, prim):
        """(p, n, uv): the hit point o + t d, the unit normal (p - c) /
        |p - c| of sphere ``prim`` and PostTraversal's (u, v), in the
        reference's precision (zeros where prim < 0)."""
        dev, dt = self.device, self.dtype
        org, dirs, t = org.to(dev, dt), dirs.to(dev, dt), t.to(dev, dt)
        hit = (prim >= 0)[:, None]
        c = self.centers[prim.clamp(min=0)]
        p = org + t[:, None] * dirs
        n = p - c
        n = n / n.norm(dim=1, keepdim=True).clamp(min=1e-30)
        u = (torch.atan2(n[:, 0], n[:, 2]) + math.pi) / (2.0 * math.pi)
        v = torch.acos(n[:, 1].clamp(-1.0, 1.0)) / math.pi
        uv = torch.stack([u, v], 1)
        z = torch.zeros((), dtype=dt, device=dev)
        return (torch.where(hit, p, z), torch.where(hit, n, z),
                torch.where(hit, uv, z))


def uv_normal(uv):
    """The unit normal that PostTraversal's (u, v) (n, 2) name: n.y =
    cos(pi v), (n.x, n.z) = sin(pi v) (sin, cos)(2 pi u - pi), float64."""
    uv = uv.double()
    th, ph = math.pi * uv[:, 1], 2.0 * math.pi * uv[:, 0] - math.pi
    return torch.stack([torch.sin(th) * torch.sin(ph), torch.cos(th),
                        torch.sin(th) * torch.cos(ph)], 1)


# a hit (t, the hit point, the normal) may lie T_TOL x (t + 1) world units
# from the reference's, times the graze factor (below)
T_TOL = 1e-5


def records_off(ref: RefSpheres, org, dirs, tmin, tmax, t, prim, normal,
                uv, want=None, position=None, depth=None, rgb=None):
    """Bool (n,): which of the program's records (``t``, ``prim`` with -1
    for a miss) and AOVs (``normal`` (n, 3), ``uv`` (n, 2), and where
    given ``position`` (n, 3), ``depth`` (n,), ``rgb`` (n, 3)) of the
    rays ``org``/``dirs`` are off against the float64 reference ``ref``
    on the same rays (a cell checks the rays themselves against its
    camera).

    A record is off when the program and the reference disagree on hit or
    miss; or, both hitting, when the program's t lies more than ``tol`` =
    ``T_TOL`` x (t + 1) x graze from the reference's, or its hit point
    lies farther than ``tol`` from the surface of the sphere it names
    (overlapping spheres: between hits within rounding of each other
    either may win), or its normal, or the normal its (u, v) name, lies
    farther than ``tol`` / r from the unit normal of its sphere at the
    reference's hit, or its depth lies more than ``tol`` from the
    reference's t, its position more than ``tol`` x |d| from the
    reference's hit point o + t d, or its colour more than ``tol`` / 2r
    from 0.5 n + 0.5 of that normal (the colour is half the normal); and,
    the program missing, when depth, position or colour is not 0. graze = 1 / |cos| of the angle between the ray and
    the reference's normal, at most 100: near a silhouette the root is a
    square root of a small discriminant, whose rounding moves t by its
    square root over the cosine. Why 1e-5: on the same float32 ray, the
    program's float32 sphere test rounds |l|^2 ~ r^2 and the root c / q
    to a few ulps, ~1e-4 m at 1 km; a CPU study of 5 x 10^4 rays a
    distance (PERF.md §6) read at most 1.9e-3 m at 740 m and 5.2e-3 m at
    1.3 km, inside 7.4e-3 and 1.3e-2; bfloat16 rounds a 1-km coordinate
    by 2-4 m. ``want`` may hand in the reference's (t, prim)."""
    dev = ref.device
    if want is None:
        want = ref.closest(org, dirs, tmin, tmax)
    rt, rp = want
    org = org.to(dev, torch.float64)
    dirs = dirs.to(dev, torch.float64)
    prim = prim.to(dev).long()
    t = t.to(dev, torch.float64)
    rt = rt.to(dev, torch.float64)
    rh, ph = rp >= 0, prim >= 0
    off = rh != ph
    both = rh & ph
    _, rn, _ = ref.surface(org, dirs, rt, rp)
    rn = rn.double()
    dd = dirs / dirs.norm(dim=1, keepdim=True)
    cos = (rn * dd).sum(1).abs()
    graze = 1.0 / cos.clamp(min=0.01)
    tol = T_TOL * (rt.abs() + 1.0) * graze
    off |= both & ~((t - rt).abs() <= tol)
    # the program's hit point on the surface of the sphere it names
    c = ref.centers.double()[prim.clamp(min=0)]
    r = ref.radii.double()[prim.clamp(min=0)]
    p = org + t[:, None] * dirs
    off |= both & ~(((p - c).norm(dim=1) - r).abs() <= tol)
    # its normal and its UV against its sphere's normal at the
    # reference's hit
    want_n = org + rt[:, None] * dirs - c
    want_n = want_n / want_n.norm(dim=1, keepdim=True).clamp(min=1e-300)
    ntol = tol / r.clamp(min=1e-30)
    off |= both & ~((normal.to(dev).double() - want_n).norm(dim=1) <= ntol)
    off |= both & ~((uv_normal(uv.to(dev)) - want_n).norm(dim=1) <= ntol)
    aovs = [(x.to(dev).double().reshape(len(off), -1), want_x, x_tol)
            for x, want_x, x_tol in (
                (depth, rt[:, None], tol),
                (position, org + rt[:, None] * dirs,
                 tol * dirs.norm(dim=1)),
                (rgb, 0.5 * want_n + 0.5, 0.5 * ntol)) if x is not None]
    for got, want_x, x_tol in aovs:
        off |= both & ~((got - want_x).norm(dim=1) <= x_tol)
        off |= ~ph & (got != 0).any(1)
    return off
