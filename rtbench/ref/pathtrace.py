"""Plain torch path tracer: the reference of the path-traced cells.

It follows the semantics that ``render_path_traced`` states for a scene
on the BVH megakernel's route, which the JAX package fixes and the port
keeps bit for bit: the upstream path tracer's loop
(examples/path_tracer/main.cc:785-1009) with Moller-Trumbore, next-event
estimation on the light faces, Russian roulette after bounce
``rr_start``, and counter-based lowbias32 uniforms keyed on (lane,
sample, bounce, draw). A camera ray's pixel takes the launch position of
the 32 x 128 tile order, ``spp_lanes`` consecutive lanes and ``spp //
spp_lanes`` sample iterations; lane ``l`` of iteration ``s`` draws the
numbers of sample ``s * spp_lanes + l % spp_lanes`` with the azimuth
wedge ``(s + 3 * bounce) % strata``. The shading is a frozen copy of
``nanort_tpu_torch/models/pt_fused.py:86-377`` (``_hash32``,
``_uniform``, ``_bounce_step``, ``_trace_paths_reference``) with every
product its own operation. What it traces with is its own: closest hit
and shadow rays through ``ref.tracer.RefMesh``, the face normals and
light rows worked out here from the scene's arrays. ``dtype`` sets the
precision of every float (float32 as the configuration states, bfloat16
for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from .tracer import RefMesh

_M32 = 0xFFFFFFFF
_H1 = 0x7FEB352D
_H2 = -2073352565 & _M32
_EPS_T = 0.001
_RAY_EPS = 0.00001
_FAR = 1.0e30


def _f(x: float) -> float:
    return float(np.float32(x))


def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    x = torch.as_tensor(x).long() & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _H1)
    x = x ^ (x >> 15)
    x = _mul32(x, _H2)
    return x ^ (x >> 16)


def _uniform(ray_id, ctr, dtype):
    ctr = torch.as_tensor(ctr, device=ray_id.device)
    h = _hash32(ray_id ^ _hash32(ctr))
    return ((h >> 8).float() * _f(1.0 / (1 << 24))).to(dtype)


def _sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _div(a, b):
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _max(x, c):
    return torch.maximum(x, torch.full_like(x, c))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z, eps=1e-30):
    n = _sqrt(x * x + y * y + z * z)
    inv = _div(1.0, _max(n, _f(eps)))
    return x * inv, y * inv, z * inv, n


def _onb(nx, ny, nz):
    neg = nz < 0.0
    a = _div(1.0, torch.where(neg, 1.0 - nz, 1.0 + nz))
    b = nx * ny * a
    b1x = 1.0 - nx * nx * a
    b1y = -b
    b1z = torch.where(neg, nx, -nx)
    b2x = torch.where(neg, b, -b)
    b2y = torch.where(neg, ny * ny * a - 1.0, 1.0 - ny * ny * a)
    b2z = -ny
    return b1x, b1y, b1z, b2x, b2y, b2z


class PTRef:
    """The reference's copy of a path-traced scene in ``dtype``: its
    mesh for tracing, unit face normals, material rows a face and the
    light rows, all worked out from the scene's arrays."""

    def __init__(self, vertices, faces, material_ids, materials, device,
                 dtype=torch.float32):
        v = np.asarray(vertices, np.float64)
        f = np.asarray(faces, np.int64)
        mid = np.asarray(material_ids, np.int64)
        tri = v[f]
        cr = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = np.linalg.norm(cr, axis=1, keepdims=True)
        unit = cr / np.maximum(nrm, 1e-30)
        mats = np.concatenate([
            np.asarray(materials[k], np.float64).reshape(
                len(materials["ior"]), -1)
            for k in ("diffuse", "emission", "specular", "transmittance",
                      "ior", "dissolve")], 1)  # (M, 14)
        em = np.asarray(materials["emission"])
        lights = np.nonzero((em[mid] > 0.0).any(axis=-1))[0]
        lrows = np.concatenate([
            tri[lights].reshape(-1, 9), unit[lights],
            0.5 * nrm[lights], np.asarray(em, np.float64)[mid[lights]]], 1)
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = RefMesh(v, f, device, dtype)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device).to(dtype)

        self.normal = t(unit)
        self.face_mat = t(mats[mid])
        self.lights = t(lrows)
        self.n_lights = len(lights)

    # ------------------------------------------------------ the tracers
    def closest(self, px, py, pz, dx, dy, dz, tmin, tmax):
        org = torch.stack([px, py, pz], 1)
        d = torch.stack([dx, dy, dz], 1)
        live = tmax > tmin
        idx = live.nonzero().squeeze(1)
        n = px.shape[0]
        t = tmax.clone()
        prim = torch.full((n,), -1, dtype=torch.int64, device=px.device)
        if idx.numel():
            tt, _, _, pp = self.mesh.closest(org[idx], d[idx], tmin[idx],
                                             tmax[idx])
            t[idx] = tt.to(t.dtype)
            prim[idx] = pp
        hit = prim >= 0
        pc = prim.clamp(min=0)
        zero = torch.zeros((), dtype=self.dtype, device=px.device)
        nrm = torch.where(hit[:, None], self.normal[pc], zero)
        # a miss reads material row 0, as the kernel's does
        mat0 = self.face_mat[pc]
        return t, hit, nrm.unbind(1), mat0.unbind(1)

    def shadow(self, hx, hy, hz, dx, dy, dz, smax, active):
        idx = active.nonzero().squeeze(1)
        out = torch.zeros_like(active)
        if idx.numel():
            org = torch.stack([hx, hy, hz], 1)[idx]
            d = torch.stack([dx, dy, dz], 1)[idx]
            tmin = torch.full_like(smax[idx], _RAY_EPS)
            out[idx] = self.mesh.any_hit(org, d, tmin, smax[idx])
        return out

    # ------------------------------------------------------- the shading
    def _bounce(self, ray_id, base, st, t, hitf, alive, n0, mat, az_strata,
                wedge):
        dt = self.dtype
        px, py, pz, dx, dy, dz, cr, cg, cb, wr, wg, wb, _, do_em = st
        (kdx, kdy, kdz, kex, key_, kez, ksx, ksy, ksz,
         ktx, kty, ktz, ior, dissolve) = mat
        nx0, ny0, nz0 = n0
        hit = hitf & alive

        hx = px + dx * t
        hy = py + dy * t
        hz = pz + dz * t

        facing = _dot3(nx0, ny0, nz0, dx, dy, dz) > 0.0
        nx = torch.where(facing, -nx0, nx0)
        ny = torch.where(facing, -ny0, ny0)
        nz = torch.where(facing, -nz0, nz0)

        inside = torch.where(_dot3(dx, dy, dz, nx0, ny0, nz0) < 0.0,
                             -1.0, 1.0).to(dt)
        n1 = torch.where(inside < 0, _div(1.0, ior), ior)
        n2 = _div(1.0, n1)
        r0 = (n1 - n2) / (n1 + n2)
        r0 = r0 * r0
        cth = 1.0 - _dot3(-dx, -dy, -dz, nx, ny, nz)
        fres = r0 + (1.0 - r0) * cth * cth * cth * cth * cth

        third = _f(1.0 / 3.0)
        rho_s = (ksx + ksy + ksz) * third * fres
        rho_d = (kdx + kdy + kdz) * third * (1.0 - fres) * (1.0 - dissolve)
        rho_r = (ktx + kty + ktz) * third * (1.0 - fres) * dissolve
        rho_e = (kex + key_ + kez) * third
        total = rho_s + rho_d + rho_r + rho_e
        absorbed = total < _f(1e-4)
        tot = torch.where(absorbed, 1.0, total).to(dt)
        rho_s = rho_s / tot
        rho_d = rho_d / tot
        rho_r = rho_r / tot

        rand = _uniform(ray_id, base + 1, dt)
        pick_s = rand < rho_s
        pick_d = ~pick_s & (rand < rho_s + rho_d)
        pick_r = ~pick_s & ~pick_d & (rand < rho_s + rho_d + rho_r)
        pick_e = ~pick_s & ~pick_d & ~pick_r

        L = self.n_lights
        if L > 0:
            inv_l = _f(1.0 / L)
            xi1 = _uniform(ray_id, base + 2, dt)
            xi2 = _uniform(ray_id, base + 3, dt)
            li = torch.clamp((xi1 * L).int(), max=L - 1)
            xi1 = xi1 * L - li.to(dt)
            (l0x, l0y, l0z, l1x, l1y, l1z, l2x, l2y, l2z,
             lnx, lny, lnz, larea, lex, ley, lez) = self.lights[
                 li.long()].unbind(1)
            srt = _sqrt(xi1)
            c0 = 1.0 - srt
            c1 = srt * (1.0 - xi2)
            c2 = srt * xi2
            lpx = c0 * l0x + c1 * l1x + c2 * l2x
            lpy = c0 * l0y + c1 * l1y + c2 * l2y
            lpz = c0 * l0z + c1 * l1z + c2 * l2z
            ldx, ldy, ldz, ldist = _normalize3(lpx - hx, lpy - hy, lpz - hz)
            ok_l = ldist > _f(1e-6)
            cos_l = _max(-_dot3(ldx, ldy, ldz, lnx, lny, lnz), 0.0)
            area_pdf = _div(inv_l, _max(larea, _f(1e-30)))
            lpdf = torch.where(
                ok_l & (cos_l > _f(1e-12)),
                area_pdf * ldist * ldist / _max(cos_l, _f(1e-30)),
                torch.zeros((), dtype=dt, device=hx.device))
            shadow_max = _max(ldist - _f(_RAY_EPS), 0.0)
            nee_active = hit & pick_d & (lpdf > 0.0) & ~absorbed
            blocked = self.shadow(hx, hy, hz, ldx, ldy, ldz, shadow_max,
                                  nee_active)
            cos_t = torch.abs(_dot3(ldx, ldy, ldz, nx, ny, nz))
            invpi = _f(1.0 / np.pi)
            scale = cos_l * cos_t / _max(lpdf, _f(1e-30))
            gate = nee_active & ~blocked
            zero = torch.zeros((), dtype=dt, device=hx.device)
            cr = cr + torch.where(gate, kdx * invpi * lex * scale * wr, zero)
            cg = cg + torch.where(gate, kdy * invpi * ley * scale * wg, zero)
            cb = cb + torch.where(gate, kdz * invpi * lez * scale * wb, zero)

        zero = torch.zeros((), dtype=dt, device=hx.device)
        emit_gate = hit & pick_e & do_em & ~absorbed
        cos_e = _max(-_dot3(nx0, ny0, nz0, dx, dy, dz), 0.0)
        cr = cr + torch.where(emit_gate, cos_e * kex * wr, zero)
        cg = cg + torch.where(emit_gate, cos_e * key_ * wg, zero)
        cb = cb + torch.where(emit_gate, cos_e * kez * wb, zero)

        ddn = _dot3(dx, dy, dz, nx, ny, nz)
        sx = dx - 2.0 * ddn * nx
        sy = dy - 2.0 * ddn * ny
        sz = dz - 2.0 * ddn * nz

        u1 = _uniform(ray_id, base + 4, dt)
        u2 = _uniform(ray_id, base + 5, dt)
        if az_strata > 1:
            u2 = _div(wedge + u2, float(az_strata))
        a = u2 * _f(2.0 * np.pi)
        cphi, sphi = torch.cos(a), torch.sin(a)
        rr_ = _sqrt(u1)
        cdx_ = rr_ * cphi
        cdy_ = rr_ * sphi
        cdz_ = _sqrt(_max(1.0 - u1, 0.0))
        b1x, b1y, b1z, b2x, b2y, b2z = _onb(nx, ny, nz)
        ddx = b1x * cdx_ + b2x * cdy_ + nx * cdz_
        ddy = b1y * cdx_ + b2y * cdy_ + ny * cdz_
        ddz = b1z * cdx_ + b2z * cdy_ + nz * cdz_

        rnx = -inside * nx0
        rny = -inside * ny0
        rnz = -inside * nz0
        ndi = _dot3(rnx, rny, rnz, dx, dy, dz)
        kk = 1.0 - n1 * n1 * (1.0 - ndi * ndi)
        kroot = _sqrt(_max(kk, 0.0))
        tir = kk < 0.0
        rxx = torch.where(tir, zero, n1 * dx - (n1 * ndi + kroot) * rnx)
        rxy = torch.where(tir, zero, n1 * dy - (n1 * ndi + kroot) * rny)
        rxz = torch.where(tir, zero, n1 * dz - (n1 * ndi + kroot) * rnz)

        ndx = torch.where(pick_s, sx, torch.where(pick_d, ddx, rxx))
        ndy = torch.where(pick_s, sy, torch.where(pick_d, ddy, rxy))
        ndz = torch.where(pick_s, sz, torch.where(pick_d, ddz, rxz))
        lwx = torch.where(pick_s, ksx, torch.where(pick_d, kdx, ktx))
        lwy = torch.where(pick_s, ksy, torch.where(pick_d, kdy, kty))
        lwz = torch.where(pick_s, ksz, torch.where(pick_d, kdz, ktz))
        one = torch.ones((), dtype=dt, device=hx.device)
        wr = wr * torch.where(hit, lwx, one)
        wg = wg * torch.where(hit, lwy, one)
        wb = wb * torch.where(hit, lwz, one)

        return (torch.where(hit, hx, px), torch.where(hit, hy, py),
                torch.where(hit, hz, pz),
                torch.where(hit, ndx, dx), torch.where(hit, ndy, dy),
                torch.where(hit, ndz, dz),
                cr, cg, cb, wr, wg, wb,
                hit & ~pick_e & ~absorbed, torch.where(hit, ~pick_d, do_em))

    def _paths(self, org, dirs, ray_id, s, seed, max_bounces, rr_start,
               az_strata, spp_lanes):
        """Radiance (n, 3) of lane ``ray_id``'s path at iteration ``s``."""
        dt, dev = self.dtype, org.device
        n = org.shape[0]
        s_eff = s * spp_lanes + ray_id % spp_lanes
        zeros = torch.zeros(n, dtype=dt, device=dev)
        ones = torch.ones(n, dtype=dt, device=dev)
        tmin = torch.full((n,), _f(_EPS_T), dtype=dt, device=dev)
        st = (*org.unbind(1), *dirs.unbind(1), zeros, zeros, zeros,
              ones, ones, ones, ones.bool(), ones.bool())
        for b in range(max_bounces):
            base = (seed + (s_eff * (max_bounces + 1) + b) * 16) & _M32
            rr_apply = b > rr_start
            killed = rr_apply & (_uniform(ray_id, base, dt) < _f(0.2))
            alive = st[12] & ~killed
            rr_fac = 1.25 if rr_apply else 1.0
            st = st[:9] + tuple(w * rr_fac for w in st[9:12]) + st[12:]
            tmax = torch.where(alive, _FAR, 0.0).to(dt)
            t, hitf, n0, mat = self.closest(*st[:6], tmin, tmax)
            st = self._bounce(ray_id, base, st, t, hitf, alive, n0, mat,
                              az_strata, (int(s) + b * 3) % az_strata)
        return torch.stack(st[6:9], 1)

    def render(self, org, dirs, launch_pos, seed, spp, max_bounces,
               rr_start, az_strata, spp_lanes):
        """Radiance means (n, 3) of the camera rays ``org``/``dirs``
        (n, 3) whose launch positions are ``launch_pos`` (n,): each ray's
        lanes summed over the iterations in sample order, then over its
        lanes in lane order, then divided by ``spp``."""
        dt = self.dtype
        K = int(spp_lanes)
        org = org.to(self.device, dt).repeat_interleave(K, 0)
        dirs = dirs.to(self.device, dt).repeat_interleave(K, 0)
        lanes = (launch_pos.to(self.device).long()[:, None] * K
                 + torch.arange(K, device=self.device)[None]).reshape(-1)
        acc = torch.zeros(org.shape, dtype=dt, device=self.device)
        for s in range(int(spp) // K):
            acc = acc + self._paths(org, dirs, lanes, s, seed, max_bounces,
                                    rr_start, az_strata, K)
        per = acc.view(-1, K, 3)
        out = per[:, 0]
        for k in range(1, K):
            out = out + per[:, k]
        return _div(out, float(spp))


def tile_launch_positions(h: int, w: int, device) -> torch.Tensor:
    """Launch position of each pixel (row-major, (h * w,)) in the 32 x
    128 tile order that ``render_path_traced`` states for an image whose
    sides are multiples of 32 and 128; the identity otherwise."""
    if h % 32 or w % 128:
        return torch.arange(h * w, device=device)
    perm = torch.arange(h * w, device=device).reshape(
        h // 32, 32, w // 128, 128).transpose(1, 2).reshape(-1)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(h * w, device=device)
    return pos


def azimuth_strata(spp: int) -> int:
    """The first of 4, 8, 5, 3, 2, 1 that divides spp."""
    return next(n for n in (4, 8, 5, 3, 2, 1) if spp % n == 0)


def spp_lanes(spp: int, strata: int) -> int:
    """The largest of 25, 20, 16, 10, 8, 5, 4, 2 that divides spp with
    ``(spp // K) % strata == 0``; else 1."""
    return next((k for k in (25, 20, 16, 10, 8, 5, 4, 2)
                 if spp % k == 0 and (spp // k) % strata == 0), 1)
