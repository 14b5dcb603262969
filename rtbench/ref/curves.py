"""Plain torch ray-curve queries and the hair AOVs, the reference of the
curve cells.

Brute force over the cubic Bezier curves that the benchmark made, with
one level of culling of its own, as ``tracer.RefMesh`` culls triangles:
the curves are ordered by the Morton code of their control points' mean
and cut into clusters of ``leaf`` curves, each with the box of its
curves' boxes (control points +- their radii) widened by a relative
1e-5; a ray tests the curves of every cluster whose box it meets within
[tmin, tmax] (``spheres.RefSpheres``' culling). The culling changes which
curves are tested, never the answer. Nothing here reads a tree, a table
or a record of the program.

The curve test is upstream's (``examples/curves_primitive/main.cc:
481-800``, Nakamaru-Ohno) with its 4 spans, in the precision asked for
(float64 for the records' reference, bfloat16 for the control): the
ray's z-align frame (GetZAlign: columns (dz, 0, -dx) / |dxz|, (-dx dy,
|dxz|^2, -dy dz) / |dxz| and d, or for a ray whose x and z are 0 the
frame of its branch), the control points projected into it, the near
reject (the largest projected z below 2 max(r0, r1)), then 4 spans
between de Casteljau points at s / 4, each a 2D segment whose half-width
is lerped from r0 / 2 to r1 / 2; a span's record is its point closest to
the z axis, clamped to the span: t its z, u = (u_s + s) / 4, v its
distance d. A span hits when d <= its half-width (+ ``grow``, a slack the
comparison gives) and t < tmax; a curve's record is its nearest hitting
span, the first at equal t, and a curve whose nearest hitting span lies
before tmin is a miss. The closest curve wins, the lowest id between
curves at exactly equal t. The tangent AOV is B'(u) / |B'(u)| of the
Bezier (the input of Kajiya-Kay shading).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .spheres import RefSpheres
from .tracer import _morton_order

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPANS = 4
# (pair, curve) tests a block holds at most
_BLOCK = 1 << 21


def z_align(d):
    """(c0, c1, c2): the columns of the z-align frame of directions ``d``
    (..., 3), each (..., 3) in ``d``'s dtype; a point x lies at ((x - o)
    . c0, (x - o) . c1, (x - o) . c2) in ray space."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dxz = torch.sqrt(dx * dx + dz * dz)
    ok = (dxz > 0)[..., None]
    s = torch.where(dxz > 0, dxz, torch.ones_like(dxz))
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    sgn = torch.where(dy > 0, one, -one)
    c0 = torch.where(ok, torch.stack([dz / s, zero, -dx / s], -1),
                     torch.stack([one, zero, zero], -1))
    c1 = torch.where(ok, torch.stack([-dx * dy / s, dxz, -dy * dz / s], -1),
                     torch.stack([zero, zero, sgn], -1))
    c2 = torch.where(ok, d, torch.stack([zero, -sgn, zero], -1))
    return c0, c1, c2


def bezier(q, t: float):
    """de Casteljau at parameter t of control points q (..., 4, 3)."""
    u = 1.0 - t
    a = u * q[..., 0, :] + t * q[..., 1, :]
    b = u * q[..., 1, :] + t * q[..., 2, :]
    c = u * q[..., 2, :] + t * q[..., 3, :]
    return u * (u * a + t * b) + t * (u * b + t * c)


def spans(org, dirs, q, r0, r1):
    """Each span's record of rays ``org``/``dirs`` (..., 3) against the
    curves ``q`` (..., 4, 3), radii ``r0``, ``r1`` (...), broadcasting:
    ``(t, u, d, w, near)``, the first four (..., 4) a span (its closest
    point's z, global u, distance to the axis, half-width there) and
    ``near`` (...) the near reject."""
    c0, c1, c2 = z_align(dirs)
    rel = q - org[..., None, :]
    p = torch.stack([(rel * c[..., None, :]).sum(-1)
                     for c in (c0, c1, c2)], -1)  # (..., 4, 3) ray space
    near = p[..., 2].amax(-1) < 2.0 * torch.maximum(r0, r1)
    w0, w1 = 0.5 * r0, 0.5 * r1
    ts, us, ds, ws = [], [], [], []
    a = bezier(p, 0.0)
    for s in range(SPANS):
        b = bezier(p, (s + 1) / SPANS)
        e = b - a
        l2 = e[..., 0] ** 2 + e[..., 1] ** 2
        k = -(a[..., 0] * e[..., 0] + a[..., 1] * e[..., 1]) / torch.where(
            l2 != 0, l2, torch.ones_like(l2))
        k = k.clamp(0.0, 1.0)
        x, y = a[..., 0] + k * e[..., 0], a[..., 1] + k * e[..., 1]
        ts.append(a[..., 2] + k * e[..., 2])
        us.append((k + s) / SPANS)
        ds.append(torch.sqrt(x * x + y * y))
        ws.append(w0 + k * (w1 - w0))
        a = b
    return (torch.stack(ts, -1), torch.stack(us, -1), torch.stack(ds, -1),
            torch.stack(ws, -1), near)


def curve_record(t, u, d, w, near, tmin, tmax, grow=0.0):
    """A curve's record from its spans (``spans``): ``(hit, t, u, v)``,
    the nearest span whose d <= w + grow and t < tmax, the first at
    equal t; a miss when there is none, when the near reject holds, or
    when that span lies before tmin."""
    ok = (d <= w + grow) & (t < tmax[..., None])
    tm = torch.where(ok, t, torch.full_like(t, math.inf))
    bt, k = tm.min(-1)
    hit = ok.any(-1) & ~near & (bt >= tmin)
    pick = k[..., None]
    return (hit, bt, u.gather(-1, pick)[..., 0], d.gather(-1, pick)[..., 0])


class RefCurves:
    """Curves laid out for the reference's queries, on ``device`` in
    ``dtype``. ``points`` (N, 4, 3) and ``radii`` (N, 4) are the
    benchmark's own arrays (the test reads r0 = radii[:, 0] and r1 =
    radii[:, 3]; the boxes all four); prim ids are their indices."""

    # the culling of the sphere reference: the clusters' boxes (lo, hi)
    _pairs = RefSpheres._pairs

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

    def __init__(self, points, radii, device, dtype=torch.float64,
                 leaf: int = 64):
        self.device = torch.device(device)
        dev = self.device
        p = torch.as_tensor(np.asarray(points, np.float64), device=dev)
        r = torch.as_tensor(np.asarray(radii, np.float64), device=dev)
        order = _morton_order(p.mean(1))
        n = p.shape[0]
        k = -(-n // leaf)
        ids = torch.full((k * leaf,), -1, dtype=torch.int64, device=dev)
        ids[:n] = order
        rows = torch.zeros((k * leaf, 4, 4), dtype=torch.float64,
                           device=dev)
        rows[:n, :, :3] = p[order]
        rows[:n, :, 3] = r[order]
        if n:
            rows[n:] = rows[n - 1]
        rows = rows.reshape(k, leaf, 4, 4)
        lo = (rows[..., :3] - rows[..., 3:]).amin((1, 2))
        hi = (rows[..., :3] + rows[..., 3:]).amax((1, 2))
        pad = 1e-5 * (lo.abs() + hi.abs() + 1e-3)
        self.dtype = dtype
        self.leaf = leaf
        self.n = n
        self.rows = rows.to(dtype)
        self.ids = ids.reshape(k, leaf)
        # the boxes stay in float64: culling is not part of the answer
        self.lo = lo - pad
        self.hi = hi + pad
        self.points = p.to(dtype)
        self.radii = r.to(dtype)

    def closest(self, org, dirs, tmin, tmax, grow: float = 0.0):
        """Closest hit with tmin <= t < tmax: ``(t, u, v, prim)``, t =
        tmax, u = v = 0 and prim -1 on a miss; between curves at exactly
        equal t the lowest id. ``grow`` widens every span by that much
        (a negative value narrows it)."""
        dev, dt = self.device, self.dtype
        org, dirs = org.to(dev, dt), dirs.to(dev, dt)
        tmin, tmax = tmin.to(dev, dt), tmax.to(dev, dt)
        n = org.shape[0]
        best = torch.full((n,), math.inf, dtype=dt, device=dev)
        parts = []
        for ri, ci in self._blocks(org, dirs, tmin, tmax):
            q = self.rows[ci]  # (pairs, leaf, 4, 4)
            sp = spans(org[ri][:, None, :], dirs[ri][:, None, :],
                       q[..., :3], q[..., 0, 3], q[..., 3, 3])
            hit, t, u, v = curve_record(
                *sp, tmin[ri][:, None].expand(-1, self.leaf),
                tmax[ri][:, None].expand(-1, self.leaf), grow)
            hit &= self.ids[ci] >= 0
            t = torch.where(hit, t, torch.full_like(t, math.inf))
            pt, _ = t.min(1)
            keep = torch.isfinite(pt)
            if not bool(keep.any()):
                continue
            ri, ci, pt = ri[keep], ci[keep], pt[keep]
            t, u, v = t[keep], u[keep], v[keep]
            ids = torch.where(t == pt[:, None], self.ids[ci],
                              torch.full_like(self.ids[ci], 1 << 62))
            pid, pk = ids.min(1)
            pu = u.gather(1, pk[:, None])[:, 0]
            pv = v.gather(1, pk[:, None])[:, 0]
            best.scatter_reduce_(0, ri, pt, "amin")
            parts.append((ri, pt, pid, pu, pv))
        t = torch.where(torch.isfinite(best), best, tmax)
        u = torch.zeros(n, dtype=dt, device=dev)
        v = torch.zeros(n, dtype=dt, device=dev)
        prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if parts:
            ri, pt, pid, pu, pv = (torch.cat(x) for x in zip(*parts))
            cand = pt == best[ri]
            low = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
            low.scatter_reduce_(0, ri[cand], pid[cand], "amin")
            sel = cand & (pid == low[ri])
            prim[ri[sel]] = pid[sel]
            u[ri[sel]] = pu[sel]
            v[ri[sel]] = pv[sel]
        return t, u, v, prim

    def spans_of(self, org, dirs, prim):
        """The spans (``spans``) of each ray against the one curve
        ``prim`` (curve 0 where prim < 0), in the reference's precision."""
        dev, dt = self.device, self.dtype
        k = prim.to(dev).clamp(min=0)
        q, r = self.points[k], self.radii[k]
        return spans(org.to(dev, dt), dirs.to(dev, dt), q, r[:, 0], r[:, 3])

    def tangent(self, prim, u):
        """The unit tangent B'(u) / |B'(u)| of curves ``prim`` at ``u``,
        in the reference's precision (curve 0 where prim < 0)."""
        dev, dt = self.device, self.dtype
        q = self.points[prim.to(dev).clamp(min=0)]
        u = u.to(dev, dt)[:, None]
        s = 1.0 - u
        b = 3.0 * (s * s * (q[:, 1] - q[:, 0]) + 2.0 * s * u * (
            q[:, 2] - q[:, 1]) + u * u * (q[:, 3] - q[:, 2]))
        return b / b.norm(dim=1, keepdim=True).clamp(min=1e-30)


# a hit's t (and its position, depth, and the point its u names on its
# span) may lie T_TOL x (t + 1) world units from the reference's, times
# the graze factor; a span's distance to the ray (v, and which spans
# hit) W_TOL x (|o| + 1); a tangent TAN_TOL
T_TOL = 1e-5
W_TOL = 1e-6
TAN_TOL = 1e-4


def records_off(ref: RefCurves, org, dirs, tmin, tmax, t, u, v, prim,
                tangent, position=None, depth=None, rgb=None):
    """Bool (n,): which of the program's records (``t``, ``u``, ``v``,
    ``prim`` with -1 for a miss) and AOVs (``tangent`` (n, 3), and where
    given ``position`` (n, 3), ``depth`` (n,), ``rgb`` (n, 3)) of the rays
    ``org``/``dirs`` are off against the float64 reference ``ref`` (a
    cell checks the rays themselves against its camera).

    A span's distance to the ray may go either way within ``w_tol`` =
    W_TOL x (|o| + 1): the program projects in float32, whose rounding of
    a ray-space coordinate is some ulps of the world coordinates (~10^-7
    m at 1 m), against a hair's half-width of 10-20 um, so a ray that
    passes within that of a hair's edge may hit or miss it. So a record
    is off when the program misses and the reference, with every span
    narrowed by w_tol, hits; or when the program hits a curve and that
    curve, in float64, has no span with d <= w + w_tol whose t lies within
    ``tol`` = T_TOL x (t + 1) x graze of the program's, whose distance
    lies within w_tol of its v, and whose point at the program's u lies
    within tol of the span's closest point (|du| x 4 x the span's
    length); or when it has a span with d <= w - w_tol nearer than t -
    tol, or the program's t lies below tmin; or when the narrowed
    reference hits a curve nearer than t - tol (a nearer hair missed).
    graze = 1 / the sine of the angle between the ray and that span, at
    most 100: along a span its closest point's t moves as the distance
    over the sine. Its tangent is off by more than TAN_TOL from the
    float64 tangent at its u (float32 differences of control points ~3 mm
    apart at ~0.3 m from the origin round at ~10^-5 relative), its
    depth by more than tol from the span's t, its position by more than
    tol x |d| from o + t d, its colour by more than TAN_TOL / 2 from 0.5
    tangent + 0.5; and, the program missing, when depth, position or
    colour is not 0. Why 1e-5 and 1e-6: a 1-m float32 coordinate rounds
    at 6e-8, a few roundings a projection; bfloat16 rounds it at 4e-3,
    a hair's length a span."""
    dev = ref.device
    f64 = torch.float64
    org, dirs = org.to(dev, f64), dirs.to(dev, f64)
    tmin, tmax = tmin.to(dev, f64), tmax.to(dev, f64)
    t, u, v = t.to(dev, f64), u.to(dev, f64), v.to(dev, f64)
    prim = prim.to(dev).long()
    ph = prim >= 0
    w_tol = W_TOL * (org.norm(dim=1) + 1.0)
    it, _, _, ip = ref.closest(org, dirs, tmin, tmax,
                               grow=-w_tol.amax().item() if len(t) else 0.0)
    st, su, sd, sw, near = ref.spans_of(org, dirs, prim)
    # each span's 3D length and its angle to the ray
    q = ref.points[prim.clamp(min=0)]
    ends = torch.stack([bezier(q, s / SPANS) for s in range(SPANS + 1)], 1)
    seg = ends[:, 1:] - ends[:, :-1]  # (n, 4, 3)
    length = seg.norm(dim=-1)
    dd = dirs / dirs.norm(dim=1, keepdim=True)
    cos = (seg * dd[:, None]).sum(-1).abs() / length.clamp(min=1e-300)
    sin = (1.0 - cos * cos).clamp(min=0.0).sqrt()
    graze = 1.0 / sin.clamp(min=0.01)
    tol = T_TOL * (t.abs()[:, None] + 1.0) * graze  # (n, 4)
    wt = w_tol[:, None]
    match = ((sd <= sw + wt) & (st < tmax[:, None])
             & ((st - t[:, None]).abs() <= tol) & ((sd - v[:, None]).abs()
                                                   <= wt)
             & ((su - u[:, None]).abs() * SPANS * length <= tol))
    nearer = (sd <= sw - wt) & (st < t[:, None] - tol)
    ok_rec = (match.any(1) & ~nearer.any(1) & (t >= tmin) & ~near)
    tol1 = T_TOL * (t.abs() + 1.0) * graze.amax(1)
    off = ~ph & (ip >= 0)
    off |= ph & ~ok_rec
    off |= ph & (ip >= 0) & (it < t - tol1)
    want_tan = ref.tangent(prim, u).double()
    off |= ph & ~((tangent.to(dev).double() - want_tan).norm(dim=1)
                  <= TAN_TOL)
    aovs = [(x.to(dev).double().reshape(len(off), -1), want_x, x_tol)
            for x, want_x, x_tol in (
                (depth, t[:, None], tol1),
                (position, org + t[:, None] * dirs, tol1 * dirs.norm(dim=1)),
                (rgb, 0.5 * want_tan + 0.5, 0.5 * TAN_TOL))
            if x is not None]
    for got, want_x, x_tol in aovs:
        off |= ph & ~((got - want_x).norm(dim=1) <= x_tol)
        off |= ~ph & (got != 0).any(1)
    return off
