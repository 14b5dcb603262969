"""Plain torch ray-triangle queries, the reference of every cell.

Brute force over the triangles that the benchmark made, with one level
of culling of its own: the triangles are ordered by the Morton code of
their centroids and cut into clusters of ``leaf`` triangles, each with a
box widened by a relative 1e-5. A ray tests the triangles of every
cluster whose box it meets within [tmin, tmax]. The culling changes
which triangles are tested, never the answer. Nothing here reads a tree,
a table or a record of the program.

The triangle test is Moller-Trumbore with every product and sum its own
operation, the sums over x, y, z in that order, and a true division:
``det = e1 . (d x e2)``, ``u = (o - p0) . (d x e2) / det``,
``v = d . ((o - p0) x e1) / det``, ``t = e2 . ((o - p0) x e1) / det``,
accepted where det != 0, u >= 0, v >= 0, u + v <= 1. The precision is
the mesh's: float64 for the records' reference, float32 where the path
tracer's arithmetic is followed, bfloat16 for the controls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (pair, triangle) tests a block holds at most
_BLOCK = 1 << 22


def _morton_order(cent: torch.Tensor) -> torch.Tensor:
    lo, hi = cent.amin(0), cent.amax(0)
    q = ((cent - lo) / (hi - lo).clamp(min=1e-30) * 1023.0).long()
    q = q.clamp(0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return torch.sort(code, stable=True).indices


class RefMesh:
    """A triangle mesh laid out for the reference's queries, on ``device``
    in ``dtype``. ``vertices`` (V, 3) and ``faces`` (F, 3) are the
    benchmark's own arrays; prim ids are face indices."""

    def __init__(self, vertices, faces, device, dtype=torch.float64,
                 leaf: int = 64):
        self.device = torch.device(device)
        dev = self.device
        v = torch.as_tensor(np.asarray(vertices, np.float64), device=dev)
        f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
        tri = v[f]  # (F, 3, 3)
        order = _morton_order(tri.mean(1))
        n = len(f)
        c = -(-n // leaf)
        ids = torch.full((c * leaf,), -1, dtype=torch.int64, device=dev)
        ids[:n] = order
        rows = torch.zeros((c * leaf, 3, 3), dtype=torch.float64, device=dev)
        rows[:n] = tri[order]
        del tri
        if n:
            rows[n:] = rows[n - 1]
        rows = rows.reshape(c, leaf, 3, 3)
        lo = rows.amin(dim=(1, 2))
        hi = rows.amax(dim=(1, 2))
        pad = 1e-5 * (lo.abs() + hi.abs() + 1e-3)
        self.dtype = dtype
        self.leaf = leaf
        self.n_faces = n
        # p0, e1 = p1 - p0, e2 = p2 - p0 in the mesh's precision
        p = rows.to(dtype)
        del rows
        self.p0 = p[:, :, 0].contiguous()
        self.e1 = (p[:, :, 1] - p[:, :, 0]).contiguous()
        self.e2 = (p[:, :, 2] - p[:, :, 0]).contiguous()
        self.ids = ids.reshape(c, leaf)
        # the boxes stay in float64: culling is not part of the answer
        self.lo = lo - pad
        self.hi = hi + pad

    # ------------------------------------------------------------ pairs
    def _pairs(self, org, dirs, tmin, tmax):
        """(ray, cluster) index pairs whose box the ray meets."""
        o = org.double()[:, None, :]
        d = dirs.double()
        inv = torch.where(d.abs() > 1e-300, 1.0 / d,
                          torch.where(torch.signbit(d), -math.inf, math.inf))
        inv = inv[:, None, :]
        t0 = (self.lo[None] - o) * inv
        t1 = (self.hi[None] - o) * inv
        # 0 * inf (a ray in a box's plane) is NaN: treat it as inside
        tn = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf)
        tf = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf)
        near = tn.amax(2)
        far = tf.amin(2)
        ok = ((near <= far) & (far >= tmin.double()[:, None])
              & (near <= tmax.double()[:, None]))
        return ok.nonzero(as_tuple=True)

    def _test(self, ri, ci, org, dirs):
        """Moller-Trumbore of each pair's ray against its cluster's
        triangles: (t, u, v, ok), each (pairs, leaf)."""
        p0, e1, e2 = self.p0[ci], self.e1[ci], self.e2[ci]
        o = org[ri][:, None, :]
        d = dirs[ri][:, None, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
        e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        invd = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
        tv = o - p0
        tx, ty, tz = tv[..., 0], tv[..., 1], tv[..., 2]
        uu = (tx * pvx + ty * pvy + tz * pvz) * invd
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dx * qx + dy * qy + dz * qz) * invd
        tt = (e2x * qx + e2y * qy + e2z * qz) * invd
        ok = ((det != 0.0) & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (self.ids[ci] >= 0))
        return tt, uu, vv, ok

    def _blocks(self, org, dirs, tmin, tmax, rays_a_block):
        n = org.shape[0]
        for r0 in range(0, n, rays_a_block):
            r1 = min(n, r0 + rays_a_block)
            ri, ci = self._pairs(org[r0:r1], dirs[r0:r1], tmin[r0:r1],
                                 tmax[r0:r1])
            ri = ri + r0
            step = max(1, _BLOCK // self.leaf)
            for p0 in range(0, ri.numel(), step):
                yield ri[p0:p0 + step], ci[p0:p0 + step]

    def _rays_a_block(self):
        return max(1, (1 << 24) // max(self.lo.shape[0], 1))

    # ---------------------------------------------------------- queries
    def closest(self, org, dirs, tmin, tmax, skip=None):
        """Closest hit with tmin <= t < tmax: (t, u, v, prim), where t is
        tmax, u = v = 0 and prim -1 on a miss. Between hits at exactly
        equal t the lowest prim id wins. ``skip`` (n,): a prim id a ray
        ignores (-1 none)."""
        dev, dt = self.device, self.dtype
        org, dirs = org.to(dev, dt), dirs.to(dev, dt)
        tmin, tmax = tmin.to(dev, dt), tmax.to(dev, dt)
        n = org.shape[0]
        best_t = torch.full((n,), math.inf, dtype=dt, device=dev)
        parts = []
        for ri, ci in self._blocks(org, dirs, tmin, tmax,
                                   self._rays_a_block()):
            tt, uu, vv, ok = self._test(ri, ci, org, dirs)
            ok = ok & (tt >= tmin[ri][:, None]) & (tt < tmax[ri][:, None])
            if skip is not None:
                ok = ok & (self.ids[ci] != skip.to(dev)[ri][:, None])
            tm = torch.where(ok, tt, torch.full_like(tt, math.inf))
            pt, pk = tm.min(1)
            keep = torch.isfinite(pt)
            if not bool(keep.any()):
                continue
            ri, ci, pk, pt = ri[keep], ci[keep], pk[keep], pt[keep]
            tm, uu, vv = tm[keep], uu[keep], vv[keep]
            # among equal t inside the pair, the lowest id
            ids = torch.where(tm == pt[:, None], self.ids[ci],
                              torch.full_like(self.ids[ci], 1 << 62))
            pid, pk = ids.min(1)
            pu = uu.gather(1, pk[:, None])[:, 0]
            pv = vv.gather(1, pk[:, None])[:, 0]
            best_t.scatter_reduce_(0, ri, pt, "amin")
            parts.append((ri, pt, pid, pu, pv))
        t = torch.where(torch.isfinite(best_t), best_t, tmax)
        u = torch.zeros(n, dtype=dt, device=dev)
        v = torch.zeros(n, dtype=dt, device=dev)
        prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if parts:
            ri, pt, pid, pu, pv = (torch.cat(x) for x in zip(*parts))
            cand = pt == best_t[ri]
            big = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
            big.scatter_reduce_(0, ri[cand], pid[cand], "amin")
            sel = cand & (pid == big[ri])
            prim[ri[sel]] = pid[sel]
            u[ri[sel]] = pu[sel]
            v[ri[sel]] = pv[sel]
        return t, u, v, prim

    def any_hit(self, org, dirs, tmin, tmax, skip=None):
        """Whether some triangle is hit with tmin <= t <= tmax (a blocker
        at exactly tmax occludes). ``skip`` as in ``closest``."""
        dev, dt = self.device, self.dtype
        org, dirs = org.to(dev, dt), dirs.to(dev, dt)
        tmin, tmax = tmin.to(dev, dt), tmax.to(dev, dt)
        n = org.shape[0]
        out = torch.zeros(n, dtype=torch.bool, device=dev)
        for ri, ci in self._blocks(org, dirs, tmin, tmax,
                                   self._rays_a_block()):
            tt, _, _, ok = self._test(ri, ci, org, dirs)
            ok = ok & (tt >= tmin[ri][:, None]) & (tt <= tmax[ri][:, None])
            if skip is not None:
                ok = ok & (self.ids[ci] != skip.to(dev)[ri][:, None])
            out[ri[ok.any(1)]] = True
        return out

    def _slots(self, prim):
        """(cluster, slot) of each prim id (prim < 0 gives slot 0 of
        cluster 0)."""
        dev = self.device
        flat = self.ids.reshape(-1)
        where = torch.full((self.n_faces + 1,), -1, dtype=torch.int64,
                           device=dev)
        good = flat >= 0
        where[flat[good]] = torch.arange(flat.numel(), device=dev)[good]
        k = where[prim.clamp(min=0, max=self.n_faces)]
        k = torch.where(prim >= 0, k, torch.zeros_like(k)).clamp(min=0)
        return k // self.leaf, k % self.leaf

    def edges(self, prim):
        """(e1, e2) (n, 3) float64 of triangles ``prim``."""
        ci, slot = self._slots(prim)
        return self.e1[ci, slot].double(), self.e2[ci, slot].double()

    def hit_t(self, org, dirs, prim, slack):
        """t of each ray against the one triangle ``prim`` (n,), with the
        triangle widened by ``slack`` (n,) world units (NaN where prim <
        0 or the ray misses it by more): does a record's triangle lie
        where it says?"""
        dev, dt = self.device, self.dtype
        org, dirs = org.to(dev, dt), dirs.to(dev, dt)
        ci, slot = self._slots(prim)
        ri = torch.arange(org.shape[0], device=dev)
        tt, uu, vv, _ = self._test(ri, ci, org, dirs)
        tt, uu, vv = (x.gather(1, slot[:, None])[:, 0] for x in (tt, uu, vv))
        e1, e2 = self.edges(prim)
        # the triangle's least altitude: slack in world units over it is
        # slack in barycentrics
        cr = torch.linalg.cross(e1, e2).norm(dim=1)
        longest = torch.stack([e1.norm(dim=1), e2.norm(dim=1),
                               (e2 - e1).norm(dim=1)], 1).amax(1)
        eps = slack.to(dev).double() * longest / cr.clamp(min=1e-300)
        uu, vv = uu.double(), vv.double()
        ok = ((prim >= 0) & (uu >= -eps) & (vv >= -eps)
              & (uu + vv <= 1 + eps))
        return torch.where(ok, tt, torch.full_like(tt, math.nan))
