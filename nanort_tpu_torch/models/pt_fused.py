"""Fused path-tracing megakernels (port of ``nanort_tpu.models.pt_fused``).

A whole render — the spp loop, the bounce loop, closest hit, NEE shadow
rays, light sampling, shading and the RNG — runs in ONE kernel launch:

* ``render_fused`` (K3, ``csrc/pt_fused.cu::pt_brute_kernel``) sweeps all
  triangles of scenes of at most ``PT_FUSED_MAX_TRIS`` triangles, each
  path's state in registers: persistent lanes claim pixels
  (``brute_grid``, ``brute_occupancy``) and run each pixel's paths one
  live bounce at a time, ending a path when it dies;
* ``render_fused_bvh`` (K4) walks the scene's BVH16 with the in-kernel
  trace K2 (``traverse/fused_trace.py``): ``pt_bvh_pool_kernel`` keeps
  2,048 paths a block in shared memory, refills ended ones and sorts
  them by origin and direction before every trace.

Semantics are the JAX package's op for op (reference path_tracer/
main.cc:785-1009, with its two deliberate deviations: the
Moller-Trumbore test and the counter-based lowbias32 uniforms keyed on
(ray, sample, bounce, draw)). The generator is ported bit for bit, so
for the same int seed both packages draw the same numbers.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain torch versions ``_render_fused_reference`` and
``_render_fused_bvh_reference`` (Python loops over samples and bounces,
vectorised over lanes, with the kernels' arithmetic: separately rounded
products, true divisions, square roots rounded once from float64,
NaN-propagating max). Every random number depends on (lane, sample,
bounce) alone, so the order in which the pooled kernel runs its paths
changes no bit: ``_trace_paths_reference`` runs any set of paths and
``sample_sums`` adds their radiance in sample order. With
``trig="poly"`` kernel and plain version agree bit for bit; ``"native"``
cos/sin differ between libms in the last ulp.

Left out on purpose: the TPU's watchdog chunking and its 120K-triangle
cap for the BVH route (``PT_FUSED_BVH_MAX_TRIS``), which exist only
because of TPU VMEM and the TPU worker's launch kill; the ``sub`` and
``interpret`` arguments, which change no result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..traverse import _ext
from ..traverse import fused_trace
from ..utils import trace

PT_FUSED_MAX_TRIS = 256  # csrc/pt_fused.cu kMaxTris (shared-memory table)
BRUTE_THREADS = 128      # K3's threads a block (csrc/pt_fused.cu kBlock)

# Kernel launches by the wrappers below (never by the plain versions),
# counted in utils.trace. Each launch of K4 ("pt_fused_bvh") also runs K2
# and counts as "bvh16_trace".
LAUNCH_KEYS = ("pt_fused_brute", "pt_fused_bvh")
trace.declare_launches(*LAUNCH_KEYS)

# The pooled kernel's per-sample radiance buffer holds at most this many
# bytes (at least one sample iteration, RL x 12 bytes): a render with more
# sample iterations runs one launch a slice of them.
POOL_SLICE_BYTES = 512 << 20

# The last pooled render's counters, a device tensor (not synchronised),
# summed over its launches and their blocks (csrc/pt_fused.cu ``Stat``):
# items claimed, waves, paths started, closest-hit and shadow traces,
# blocks.
POOL_STATS = ("items", "waves", "paths", "closest", "shadows", "blocks")
LAST_POOL_STATS = None

# The last K3 launch's closest-hit and shadow sweeps (a device tensor, not
# synchronised): the live bounces it traced and the NEE rays it asked.
LAST_BRUTE_STATS = None

_M32 = 0xFFFFFFFF
# The JAX package's multipliers: 0x7FEB352D and the int32 -2073352565,
# which is 0x846B268B, not lowbias32's published 0x846CA68B. The port
# keeps the package's value: it decides every random number.
_H1 = 0x7FEB352D
_H2 = -2073352565 & _M32


def _f(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in any op)."""
    return float(np.float32(x))


_EPS_T = _f(0.001)
_RAY_EPS = _f(0.00001)
_FAR = _f(1.0e30)


# ---------------------------------------------------------------- RNG

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without
    overflowing int64: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x) -> torch.Tensor:
    """lowbias32 as the JAX package computes it (pt_fused.py:63-69) on uint32 values held in int64.
    ``x`` may hold int32 values (their bit pattern is taken) or uint32
    values; the result is in [0, 2**32). torch's ``>>`` on int32 is
    arithmetic, so the logical shifts run on int64."""
    x = torch.as_tensor(x).long() & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _H1)
    x = x ^ (x >> 15)
    x = _mul32(x, _H2)
    return x ^ (x >> 16)


def _uniform(ray_id: torch.Tensor, ctr) -> torch.Tensor:
    """U[0,1) float32 from ``hash(ray_id ^ hash(ctr))`` (pt_fused.py:
    72-75)."""
    ctr = torch.as_tensor(ctr, device=ray_id.device)
    h = _hash32(ray_id ^ _hash32(ctr))
    return (h >> 8).float() * _f(1.0 / (1 << 24))


# --------------------------------------------------- float32 helpers

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU float32 sqrt is not)."""
    return torch.sqrt(x.double()).float()


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` as one IEEE division, tensor by tensor: torch turns a
    division by (or of) a Python number into a product with a
    reciprocal."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: NaN propagates."""
    return torch.maximum(x, torch.full_like(x, c))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z, eps: float = 1e-30):
    """``(x, y, z) * (1 / max(|v|, eps))`` and ``|v|`` (a multiply by the
    reciprocal, not a division; pt_fused.py:86-89)."""
    n = _sqrt(x * x + y * y + z * z)
    inv = _div(1.0, _max(n, _f(eps)))
    return x * inv, y * inv, z * inv, n


def _sincos_2pi_poly(u: torch.Tensor):
    """(cos 2 pi u, sin 2 pi u) for u in [0, 1) by quadrant reduction and
    degree-8/9 Taylor polynomials (pt_fused.py:92-112)."""
    t4 = u * 4.0
    q = torch.floor(t4)
    y = (t4 - q) * _f(np.pi / 2)
    y2 = y * y
    s = y * (1.0 + y2 * (_f(-1 / 6) + y2 * (
        _f(1 / 120) + y2 * (_f(-1 / 5040) + y2 * _f(1 / 362880)))))
    c = 1.0 + y2 * (-0.5 + y2 * (
        _f(1 / 24) + y2 * (_f(-1 / 720) + y2 * _f(1 / 40320))))
    qi = q.int() & 3
    cosv = torch.where(qi == 0, c, torch.where(
        qi == 1, -s, torch.where(qi == 2, -c, s)))
    sinv = torch.where(qi == 0, s, torch.where(
        qi == 1, c, torch.where(qi == 2, -s, -c)))
    return cosv, sinv


def _sincos_2pi(u: torch.Tensor, trig: str):
    if trig == "native":
        a = u * _f(2.0 * np.pi)
        return torch.cos(a), torch.sin(a)
    return _sincos_2pi_poly(u)


def _onb(nx, ny, nz):
    """Revised ONB, both sign branches by select (pt_fused.py:122-134)."""
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


# ------------------------------------------------------ bounce step

def _bounce_step(ray_id, base, st, t, hitf, alive, n0, mat, lights, trig,
                 az_strata, wedge, shadow):
    """One bounce's shading, NEE, emission and next direction
    (pt_fused.py:137-311; the plain version of ``bounce_step`` in
    ``csrc/pt_fused.cu``).

    ``st`` = (px, py, pz, dx, dy, dz, cr, cg, cb, wr, wg, wb, alive,
    do_em); ``n0`` the unflipped shading normal; ``mat`` the 14 material
    columns; ``lights`` = (table (L, 16), L, f32(1/L)).
    ``shadow(hx, hy, hz, dx, dy, dz, smax, active)`` answers, for the
    lanes in ``active``, whether [ray_eps, smax] is blocked."""
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

    inside = torch.where(_dot3(dx, dy, dz, nx0, ny0, nz0) < 0.0, -1.0, 1.0)
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
    tot = torch.where(absorbed, 1.0, total)
    rho_s = rho_s / tot
    rho_d = rho_d / tot
    rho_r = rho_r / tot

    rand = _uniform(ray_id, base + 1)
    pick_s = rand < rho_s
    pick_d = ~pick_s & (rand < rho_s + rho_d)
    pick_r = ~pick_s & ~pick_d & (rand < rho_s + rho_d + rho_r)
    pick_e = ~pick_s & ~pick_d & ~pick_r

    # ---- NEE (MeshLight::sampleDirect, main.cc:336-397) ----
    table, L, inv_l = lights
    if L > 0:
        xi1 = _uniform(ray_id, base + 2)
        xi2 = _uniform(ray_id, base + 3)
        li = torch.clamp((xi1 * L).int(), max=L - 1)
        xi1 = xi1 * L - li.float()
        (l0x, l0y, l0z, l1x, l1y, l1z, l2x, l2y, l2z,
         lnx, lny, lnz, larea, lex, ley, lez) = table[li.long()].unbind(1)
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
            area_pdf * ldist * ldist / _max(cos_l, _f(1e-30)), 0.0)
        shadow_max = _max(ldist - _RAY_EPS, 0.0)
        nee_active = hit & pick_d & (lpdf > 0.0) & ~absorbed
        blocked = shadow(hx, hy, hz, ldx, ldy, ldz, shadow_max, nee_active)
        cos_t = torch.abs(_dot3(ldx, ldy, ldz, nx, ny, nz))
        invpi = _f(1.0 / np.pi)
        scale = cos_l * cos_t / _max(lpdf, _f(1e-30))
        gate = nee_active & ~blocked
        cr = cr + torch.where(gate, kdx * invpi * lex * scale * wr, 0.0)
        cg = cg + torch.where(gate, kdy * invpi * ley * scale * wg, 0.0)
        cb = cb + torch.where(gate, kdz * invpi * lez * scale * wb, 0.0)

    # ---- emission (main.cc:964-971) ----
    emit_gate = hit & pick_e & do_em & ~absorbed
    cos_e = _max(-_dot3(nx0, ny0, nz0, dx, dy, dz), 0.0)
    cr = cr + torch.where(emit_gate, cos_e * kex * wr, 0.0)
    cg = cg + torch.where(emit_gate, cos_e * key_ * wg, 0.0)
    cb = cb + torch.where(emit_gate, cos_e * kez * wb, 0.0)

    # ---- next direction ----
    ddn = _dot3(dx, dy, dz, nx, ny, nz)
    sx = dx - 2.0 * ddn * nx
    sy = dy - 2.0 * ddn * ny
    sz = dz - 2.0 * ddn * nz

    u1 = _uniform(ray_id, base + 4)
    u2 = _uniform(ray_id, base + 5)
    if az_strata > 1:
        # every lane of this (sample, bounce) draws its azimuth in one
        # 1/az_strata wedge that cycles with the sample index
        u2 = _div(wedge + u2, float(az_strata))
    cphi, sphi = _sincos_2pi(u2, trig)
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
    rxx = torch.where(tir, 0.0, n1 * dx - (n1 * ndi + kroot) * rnx)
    rxy = torch.where(tir, 0.0, n1 * dy - (n1 * ndi + kroot) * rny)
    rxz = torch.where(tir, 0.0, n1 * dz - (n1 * ndi + kroot) * rnz)

    ndx = torch.where(pick_s, sx, torch.where(pick_d, ddx, rxx))
    ndy = torch.where(pick_s, sy, torch.where(pick_d, ddy, rxy))
    ndz = torch.where(pick_s, sz, torch.where(pick_d, ddz, rxz))
    lwx = torch.where(pick_s, ksx, torch.where(pick_d, kdx, ktx))
    lwy = torch.where(pick_s, ksy, torch.where(pick_d, kdy, kty))
    lwz = torch.where(pick_s, ksz, torch.where(pick_d, kdz, ktz))
    wr = wr * torch.where(hit, lwx, 1.0)
    wg = wg * torch.where(hit, lwy, 1.0)
    wb = wb * torch.where(hit, lwz, 1.0)

    return (torch.where(hit, hx, px), torch.where(hit, hy, py),
            torch.where(hit, hz, pz),
            torch.where(hit, ndx, dx), torch.where(hit, ndy, dy),
            torch.where(hit, ndz, dz),
            cr, cg, cb, wr, wg, wb,
            hit & ~pick_e & ~absorbed, torch.where(hit, ~pick_d, do_em))


def _trace_paths_reference(org, dirs, ray_id, s, seed, max_bounces,
                           rr_start, trig, az_strata, spp_lanes, lights,
                           closest, shadow):
    """One path a row, vectorised: the path of lane ``ray_id`` at sample
    iteration ``s`` ((n,) int64 tensors) from ``org``/``dirs`` (n, 3);
    its radiance (n, 3). ``closest(px..dz, tmin, tmax)`` returns ``(t,
    hit, normal3, material14)`` (t = tmax on a miss); ``shadow`` as in
    _bounce_step. A path's numbers depend on (lane, s, bounce) alone, so
    any grouping of paths gives each the same radiance."""
    dev = org.device
    n = org.shape[0]
    # sample-major lanes: the lane's true sample index seeds its stream
    s_eff = s * spp_lanes + ray_id % spp_lanes
    zeros = torch.zeros(n, device=dev)
    ones = torch.ones(n, device=dev)
    tmin = torch.full((n,), _EPS_T, device=dev)
    st = (*org.unbind(1), *dirs.unbind(1), zeros, zeros, zeros,
          ones, ones, ones, ones.bool(), ones.bool())
    for b in range(max_bounces):
        base = (seed + (s_eff * (max_bounces + 1) + b) * 16) & _M32
        rr_apply = b > rr_start
        killed = rr_apply & (_uniform(ray_id, base) < _f(0.2))
        alive = st[12] & ~killed
        rr_fac = 1.25 if rr_apply else 1.0
        st = st[:9] + tuple(w * rr_fac for w in st[9:12]) + st[12:]
        tmax = torch.where(alive, _FAR, 0.0)
        t, hitf, n0, mat = closest(*st[:6], tmin, tmax)
        st = _bounce_step(ray_id, base, st, t, hitf, alive, n0, mat, lights,
                          trig, az_strata, (s + b * 3) % az_strata, shadow)
    return torch.stack(st[6:9], 1)


def _render_lanes_reference(org, dirs, seed, spp_iters, max_bounces,
                            rr_start, trig, az_strata, spp_lanes, lights,
                            closest, shadow, lane_ids=None):
    """The megakernels' lane loop, vectorised over lanes: radiance sums
    (n, 3), the samples added in order. ``lane_ids`` (n,): the lanes
    that ``org``/``dirs`` hold (default ``arange(n)``), each run under
    its true ray id."""
    dev = org.device
    n = org.shape[0]
    ray_id = (torch.arange(n, dtype=torch.int64, device=dev)
              if lane_ids is None
              else torch.as_tensor(lane_ids, device=dev).long())
    acc = torch.zeros((n, 3), device=dev)
    for s in range(spp_iters):
        acc = acc + _trace_paths_reference(
            org, dirs, ray_id, torch.full_like(ray_id, s), seed, max_bounces,
            rr_start, trig, az_strata, spp_lanes, lights, closest, shadow)
    return acc


def _on_active(fn, active, *cols):
    """``fn`` on the lanes in ``active`` only, False elsewhere (the
    kernels ask a shadow ray only where NEE is active: the others trace
    with smax = 0 and can hit nothing)."""
    idx = active.nonzero().squeeze(1)
    out = torch.zeros_like(active)
    if idx.numel():
        out[idx] = fn(*(c[idx] for c in cols))
    return out


# ------------------------------------------------------------- K3

def _brute_mt(tri, px, py, pz, dx, dy, dz, tmin, tmax):
    """Moller-Trumbore of every lane against every triangle row
    [v0 | e1 | e2] (pt_fused.py:351-383): returns (tt, uu, vv, ok) of
    shape (n, F)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(1)
    px, py, pz, dx, dy, dz = (c[:, None] for c in (px, py, pz, dx, dy, dz))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = _div(1.0, torch.where(det == 0.0, 1.0, det))
    tx, ty, tz = px - v0x, py - v0y, pz - v0z
    uu = _dot3(tx, ty, tz, pvx, pvy, pvz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = _dot3(dx, dy, dz, qx, qy, qz) * inv
    tt = _dot3(e2x, e2y, e2z, qx, qy, qz) * inv
    ok = ((det != 0.0) & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt >= tmin[:, None]) & (tt <= tmax[:, None]))
    return tt, uu, vv, ok


def _render_fused_reference(tri, face, lights, org, dirs, seed, spp,
                            max_bounces, rr_start, trig, az_strata,
                            lane_ids=None):
    """Plain torch version of K3: radiance sums (R, 3). ``lane_ids``
    (R,): the pixels of a launch that ``org``/``dirs`` hold (default
    all), each traced under its own pixel's random numbers."""
    F, C = tri.shape[0], face.shape[1]
    ar_f = torch.arange(F, device=org.device)

    def closest(px, py, pz, dx, dy, dz, tmin, tmax):
        tt, uu, vv, ok = _brute_mt(tri, px, py, pz, dx, dy, dz, tmin, tmax)
        # sequential replace-on-<= keeps the LAST prim at the minimum t
        t = torch.where(ok, tt, float("inf")).amin(1, keepdim=True)
        fid = torch.where(ok & (tt == t), ar_f, -1).amax(1)
        hitf = fid >= 0
        fid = fid.clamp(min=0)  # a miss reads face row 0
        sel = fid[:, None]
        t = torch.where(hitf, t[:, 0], tmax)
        hu = torch.where(hitf, uu.gather(1, sel)[:, 0], 0.0)
        hv = torch.where(hitf, vv.gather(1, sel)[:, 0], 0.0)
        rows = face[fid].unbind(1)
        if C >= 26:
            n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z = rows[17:26]
            w0 = 1.0 - hu - hv
            nx = w0 * n0x + hu * n1x + hv * n2x
            ny = w0 * n0y + hu * n1y + hv * n2y
            nz = w0 * n0z + hu * n1z + hv * n2z
            n0 = _normalize3(nx, ny, nz)[:3]
        else:
            n0 = rows[0:3]
        return t, hitf, n0, rows[3:17]

    def shadow(hx, hy, hz, dx, dy, dz, smax, active):
        def any_hit(*c):
            tmin = torch.full_like(c[-1], _RAY_EPS)
            return _brute_mt(tri, *c[:6], tmin, c[-1])[3].any(1)
        return _on_active(any_hit, active, hx, hy, hz, dx, dy, dz, smax)

    return _render_lanes_reference(org, dirs, seed, spp, max_bounces,
                                   rr_start, trig, az_strata, 1, lights,
                                   closest, shadow, lane_ids)


# ------------------------------------------------------------- K4

def _bvh_tracers(mat, nodes, leafs, aux, slots):
    """K4's ``closest`` and ``shadow`` for the plain path loop, through
    ``trace_bvh16_reference``."""
    n_mats = mat.shape[0]

    def closest(px, py, pz, dx, dy, dz, tmin, tmax):
        org_ = torch.stack([px, py, pz], 1)
        dir_ = torch.stack([dx, dy, dz], 1)
        rec = fused_trace.trace_bvh16_reference(
            nodes, leafs, aux, org_, dir_, tmin, tmax, False, slots)
        # a miss reads material row 0; an id past the table selects
        # nothing (the TPU's select loop)
        mid = rec.material_id.long().clamp(min=0)
        row = torch.where((mid < n_mats)[:, None],
                          mat[mid.clamp(max=max(n_mats - 1, 0))], 0.0)
        return rec.t, rec.hit, rec.normal.unbind(1), row.unbind(1)

    def shadow(hx, hy, hz, dx, dy, dz, smax, active):
        def occluded(*c):
            return fused_trace.trace_bvh16_reference(
                nodes, leafs, None, torch.stack(c[:3], 1),
                torch.stack(c[3:6], 1), torch.full_like(c[-1], _RAY_EPS),
                c[-1], True, slots)
        return _on_active(occluded, active, hx, hy, hz, dx, dy, dz, smax)

    return closest, shadow


def _render_fused_bvh_reference(mat, lights, nodes, leafs, aux, slots, org,
                                dirs, seed, spp_iters, max_bounces, rr_start,
                                trig, az_strata, spp_lanes, lane_ids=None):
    """Plain torch version of K4: radiance sums (n, 3) of the lanes that
    ``org``/``dirs`` hold, ``lane_ids`` (default ``arange(n)``) of the
    (RL, 3) sample-major lanes."""
    closest, shadow = _bvh_tracers(mat, nodes, leafs, aux, slots)
    return _render_lanes_reference(org, dirs, seed, spp_iters, max_bounces,
                                   rr_start, trig, az_strata, spp_lanes,
                                   lights, closest, shadow, lane_ids)


def sample_sums(per_sample: torch.Tensor,
                acc: torch.Tensor | None = None) -> torch.Tensor:
    """(spp_iters, RL, 3) per-path radiance -> (RL, 3) lane sums, added
    in sample order ``((acc + r0) + r1) + ...`` (``acc`` defaults to
    zeros): ``_render_lanes_reference``'s sum, bit for bit, also when the
    samples come in consecutive slices, each added to the sums of the
    ones before."""
    if acc is None:
        acc = torch.zeros(per_sample.shape[1:], dtype=per_sample.dtype,
                          device=per_sample.device)
    for r in per_sample:
        acc = acc + r
    return acc


def pool_slices(n: int, spp_iters: int, cap_bytes: int) -> list:
    """The pooled kernel's launches for ``n`` lanes: consecutive (s0,
    iters) slices of the ``spp_iters`` sample iterations whose (iters, n,
    3) float32 buffer holds at most ``cap_bytes`` (one iteration when a
    single one is larger)."""
    step = max(1, int(cap_bytes) // max(12 * int(n), 1))
    return [(s0, min(step, spp_iters - s0))
            for s0 in range(0, spp_iters, step)]


def pool_box(nodes: torch.Tensor):
    """The pooled kernel's sort box: (lo (3,), max(hi - lo, 1e-30) (3,))
    of the root row's child boxes (empty slots carry inverted boxes and
    drop out)."""
    boxes = nodes[0, :96].view(16, 6)
    lo = boxes[:, :3].amin(0)
    hi = boxes[:, 3:].amax(0)
    return lo, torch.maximum(hi - lo, torch.full_like(lo, 1e-30))


def pool_sort_keys(org, dirs, live, lo, ext) -> torch.Tensor:
    """The pooled kernel's in-kernel sort key (``ray_key`` and the dead
    key in ``csrc/pt_fused.cu``), in ``ray_sort.ray_sort_keys``'s int64
    form: dead bit 31 (not ``live``) . origin Morton code on the 32^3
    grid over the box ``lo`` + ``ext`` . direction octant."""
    def cell(o, lo_, e):
        c = (o - lo_) / e * 32.0
        c = torch.where(torch.isnan(c), 0.0, c)
        return torch.clamp(c, 0.0, 31.0).long()

    def spread(v):
        for mul, mask in ((0x00010001, 0xFF0000FF), (0x00000101, 0x0F00F00F),
                          (0x00000011, 0xC30C30C3), (0x00000005, 0x49249249)):
            v = (v * mul) & mask
        return v

    q = [cell(org[:, k], lo[k], ext[k]) for k in range(3)]
    morton = (spread(q[0]) << 2) | (spread(q[1]) << 1) | spread(q[2])
    octant = ((dirs[:, 0] < 0).long() << 2 | (dirs[:, 1] < 0).long() << 1
              | (dirs[:, 2] < 0).long())
    return (morton << 3) | octant | ((~live).long() << 31)


# ------------------------------------------------- tables and routes

def _seed32(seed) -> int:
    """The kernels' int32 seed: ``seed & 0x7FFFFFFF``, as the JAX
    package folds a plain int (``pt_fused._seed_from_key``; its
    ``PRNGKey(k)`` gives ``k``)."""
    if not isinstance(seed, (int, np.integer)) or isinstance(seed, bool):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    return int(seed) & 0x7FFFFFFF


def _lights(scene, dev):
    """(light table (L, 16), L, float32(1 / max(L, 1)))."""
    light = scene.light_table
    if light is None:
        light = torch.zeros((0, 16), dtype=torch.float32, device=dev)
    n = int(light.shape[0])
    return light.contiguous(), n, _f(1.0 / max(n, 1))


def build_fused_tables(scene):
    """(tri (F, 9) = [v0 | v1 - v0 | v2 - v0], face (F, 17|26), light
    (L, 16)) float32 tables for K3, on the scene's device."""
    v = scene.mesh.vertices
    f = scene.mesh.faces.long()
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    tri = torch.cat([v0, v1 - v0, v2 - v0], 1).float().contiguous()
    light = _lights(scene, v.device)[0]
    return tri, scene.face_table.float().contiguous(), light


def build_fused_bvh_tables(scene):
    """(mat (M, 14), light (L, 16), nodes, leafs, aux) for K4. Needs a
    width-16 ``scene.scene8`` and ``scene.fused_aux`` (make_pt_scene
    attaches both with ``engine="pallas"``)."""
    mats = scene.materials
    mat = torch.cat([mats.diffuse, mats.emission, mats.specular,
                     mats.transmittance, mats.ior[:, None],
                     mats.dissolve[:, None]], 1).float().contiguous()
    light = _lights(scene, mat.device)[0]
    s8 = scene.scene8
    return (mat, light, s8.nodes, s8.leafs, scene.fused_aux)


def fused_eligible(scene) -> bool:
    """True when ``scene`` (a PTScene) can ride the brute megakernel."""
    return (scene.face_table is not None
            and scene.mesh.faces.shape[0] <= PT_FUSED_MAX_TRIS
            and (scene.light_table is not None
                 or scene.light_faces.shape[0] == 0))


def fused_bvh_eligible(scene) -> bool:
    """True when ``scene`` can ride the BVH megakernel. Unlike the TPU
    package there is no triangle cap (see the module note)."""
    s8 = scene.scene8
    return (s8 is not None and s8.width == 16
            and scene.fused_aux is not None
            and scene.facevarying_normals is None
            and (scene.light_table is not None
                 or scene.light_faces.shape[0] == 0))


def _flat_rays(org, dirs, dev):
    org = torch.as_tensor(org, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    return org.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous()


def _check_device(dev, *tabs):
    for x in tabs:
        if x.device != dev:
            raise ValueError(f"scene tables are on {x.device}, rays on {dev}: "
                             "move the scene with scene.to(device)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


@trace.span("k3")
def render_fused(scene, org, dirs, seed: int, spp: int, max_bounces: int = 8,
                 rr_start: int = 3, trig: str = "native",
                 azimuth_strata: int = 1) -> torch.Tensor:
    """Radiance means (R, 3) for ``spp`` samples per ray (``org``/``dirs``
    (..., 3)) through the brute megakernel K3, on the scene's device."""
    if not fused_eligible(scene):
        raise ValueError(
            "scene not eligible for the fused kernel "
            f"(F={scene.mesh.faces.shape[0]} > {PT_FUSED_MAX_TRIS} or no "
            "face/light tables)")
    if trig not in ("native", "poly"):
        raise ValueError(f"trig must be 'native' or 'poly': {trig}")
    seed = _seed32(seed)
    tri, face, light = build_fused_tables(scene)
    dev = tri.device
    org, dirs = _flat_rays(org, dirs, dev)
    _check_device(dev, face, light)
    lights = _lights(scene, dev)
    if dev.type == "cpu":
        sums = _render_fused_reference(
            tri, face, lights, org, dirs, seed, int(spp), int(max_bounces),
            int(rr_start), trig, int(azimuth_strata))
    else:
        sums = _launch_fused(tri, face, light, lights, org, dirs, seed,
                             int(spp), int(max_bounces), int(rr_start), trig,
                             int(azimuth_strata))
    return _div(sums, float(spp))


def _launch_fused(tri, face, light, lights, org, dirs, seed, spp,
                  max_bounces, rr_start, trig, az_strata):
    """Launch K3 on CUDA tensors; its radiance sums (R, 3)."""
    global LAST_BRUTE_STATS
    dev = org.device
    n = org.shape[0]
    sums = torch.empty_like(org)
    # the pixel counter, then the closest-hit and shadow sweeps
    scratch = torch.zeros(3, dtype=torch.int64, device=dev)
    occ = brute_occupancy(dev)
    grid = brute_grid(n, occ["blocks_per_sm"], occ["sms"])
    _ext.launch(
        "pt_fused", "nrt_pt_fused_brute", tri, tri.shape[0], face,
        face.shape[1], light, lights[1], lights[2], org, dirs, sums, scratch,
        n, seed, spp, max_bounces, rr_start, int(trig == "poly"), az_strata,
        grid, device=dev, count="pt_fused_brute")
    LAST_BRUTE_STATS = scratch[1:]
    return sums


def brute_grid(n: int, blocks_per_sm: int, sms: int) -> int:
    """K3's grid for ``n`` pixels (``_ext.resident_grid``: the resident
    blocks, or one lane a pixel for a smaller batch)."""
    return _ext.resident_grid(n, blocks_per_sm, sms, BRUTE_THREADS)


def brute_occupancy(device=None) -> dict:
    """What the card's occupancy API and the compiled kernel say of K3:
    resident ``blocks_per_sm``, ``registers`` and ``local_bytes`` (spill)
    a thread, ``threads`` a block, and the card's ``sms``. Cached per
    device."""
    return _ext.occupancy(
        "pt_fused", "nrt_pt_fused_brute_occupancy",
        ("blocks_per_sm", "registers", "local_bytes", "threads"),
        device=device)


@trace.span("k4")
def render_fused_bvh(scene, org, dirs, seed: int, spp: int,
                     max_bounces: int = 8, rr_start: int = 3,
                     trig: str = "native", azimuth_strata: int = 1,
                     spp_lanes: int = 1) -> torch.Tensor:
    """Radiance means (R, 3) through the BVH megakernel K4.

    ``spp_lanes`` (sample-major packing): each ray takes that many
    consecutive lanes, and the sample loop runs ``spp // spp_lanes``
    times; lane ``l`` of sample ``s`` draws the numbers of sample ``s *
    spp_lanes + l % spp_lanes``, with the azimuth wedge of iteration
    ``s``. Requires ``spp % spp_lanes == 0``. The lanes of a ray are
    summed in lane order, then divided by spp.

    The kernel runs the (lane, sample) paths from a pool in shared
    memory, sorted by origin and direction before each trace, and writes
    each path's radiance to a per-sample buffer, which is summed in
    sample order (``sample_sums``); a render whose buffer would pass
    ``POOL_SLICE_BYTES`` runs one launch a slice of its sample
    iterations, each added to the sums in order."""
    if not fused_bvh_eligible(scene):
        raise ValueError(
            "scene not eligible for the fused BVH kernel "
            f"(F={scene.mesh.faces.shape[0]}, "
            f"scene8={scene.scene8 is not None})")
    if trig not in ("native", "poly"):
        raise ValueError(f"trig must be 'native' or 'poly': {trig}")
    K = int(spp_lanes)
    if K < 1 or spp % K:
        raise ValueError(f"spp_lanes={K} must divide spp={spp}")
    seed = _seed32(seed)
    mat, light, _, _, _ = build_fused_bvh_tables(scene)
    dev = mat.device
    org, dirs = _flat_rays(org, dirs, dev)
    nodes, leafs, aux, slots = fused_trace._check_tables(
        scene.scene8, scene.fused_aux, dev)
    _check_device(dev, light)
    if K > 1:
        org = org.repeat_interleave(K, 0)
        dirs = dirs.repeat_interleave(K, 0)
    lights = _lights(scene, dev)
    if dev.type == "cpu":
        sums = _render_fused_bvh_reference(
            mat, lights, nodes, leafs, aux, slots, org, dirs, seed,
            int(spp) // K, int(max_bounces), int(rr_start), trig,
            int(azimuth_strata), K)
    else:
        sums = _launch_fused_bvh(mat, light, lights, nodes, leafs, aux,
                                 slots, org, dirs, seed, int(spp) // K,
                                 int(max_bounces), int(rr_start), trig,
                                 int(azimuth_strata), K)
    return _div(lane_sums(sums, K), float(spp))


def _launch_fused_bvh(mat, light, lights, nodes, leafs, aux, slots, org,
                      dirs, seed, spp_iters, max_bounces, rr_start, trig,
                      az_strata, K):
    """Launch K4 on CUDA tensors, one launch a slice of sample iterations;
    its lane sums (RL, 3)."""
    global LAST_POOL_STATS
    dev = org.device
    n = org.shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = pool_slices(n, spp_iters, POOL_SLICE_BYTES)
    buf = torch.empty((max((k for _, k in parts), default=0), n, 3),
                      dtype=torch.float32, device=dev)
    stats = torch.zeros((max(len(parts), 1), len(POOL_STATS)),
                        dtype=torch.int64, device=dev)
    box = torch.cat(pool_box(nodes)).contiguous()
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for j, (s0, k) in enumerate(parts):
        _ext.launch(
            "pt_fused", "nrt_pt_fused_bvh_pool", mat, mat.shape[0], light,
            lights[1], lights[2], nodes, leafs, aux, org, dirs, buf, err, n,
            slots, seed, spp_iters, max_bounces, rr_start,
            int(trig == "poly"), az_strata, K, s0, k, stats[j], box,
            device=dev, count=("pt_fused_bvh", "bvh16_trace"))
        out = sample_sums(buf[:k], out)
    LAST_POOL_STATS = stats.sum(0)
    fused_trace.check_overflow(err, slots)
    return out


def pool_occupancy(device=None) -> dict:
    """What the card's occupancy API says of K4's pooled kernel: ``pool``,
    its resident blocks (of 512 threads) an SM, ``pool_smem_bytes``, the
    pool's shared bytes a block, and the card's ``sms``. Cached per
    device."""
    return _ext.occupancy("pt_fused", "nrt_pt_fused_bvh_occupancy",
                          ("pool", "pool_smem_bytes"), device=device)


def lane_sums(sums: torch.Tensor, spp_lanes: int) -> torch.Tensor:
    """(R * spp_lanes, 3) lane sums -> (R, 3) ray sums, adding a ray's
    lanes in lane order."""
    lanes = sums.view(-1, spp_lanes, 3)
    acc = lanes[:, 0]
    for k in range(1, spp_lanes):
        acc = acc + lanes[:, k]
    return acc
