"""Bidirectional path tracer (port of ``nanort_tpu.models.bdpt``;
reference examples/bidir_path_tracer).

One eye subpath + one light subpath per pixel sample, every (eye, light)
vertex pair connected with MIS (main.cc:898-1289). Both random walks run
as wavefronts over the full sample batch with a fixed number of vertex
slots, and each (e, l) connection strategy evaluates over all rays with
one batched visibility trace.

Faithful semantics (citations into bidir_path_tracer/main.cc):
* subpath walk ``raytrace`` (898-1014): area-measure pdfFwd conversion
  using the *previous* vertex normal, pdfRev write-back to the previous
  vertex, eye paths store the light vertex and stop, light paths drop it
* lobe model ``sampleBRDF``/``pdfBRDF``/``Vertex::f`` (607-890): fresnel-
  weighted specular/diffuse/refraction probabilities; specular and
  refraction are delta lobes (f and pdf contribute 0 in connections);
  ``isDelta`` = any specular or transmittance component (624-630)
* uniform-area light sampling, pdfPos = 1/totalArea (692-766)
* ``calcG`` visibility: the connection ray must hit the far surface
  within kEps of the expected distance (1211-1243)
* the MIS weight recurrences with zero->one pdf substitution and delta
  skips (1081-1209); strategy (e<=2, l==0) weights 1
* constants kEps = 1e-3, cosine-hemisphere pdf = cos/pi (44, 264-280)

Every trace goes through the path tracer's ``_trace``: brute force for
small scenes, the packet traversal kernel (K1, or K1-woop on a Woop
scene) behind the ray sort when the ``PTScene`` carries BVH16 tables,
the wavefront walk otherwise. A connection's visibility ray is traced
only where the strategy is live (the others are masked out of the image
anyway), so dead rays sort last and retire at once.

Random numbers (a deviation): the JAX package draws each uniform from a
threefry key folded in along a path (``fold_in(key, 1)`` for the eye
walk, then ``100 + b`` for step b, ...). Here each comes from a
``torch.Generator`` on the scene's device, in the order of
``draw_paths``; ``draws=`` takes a dict from those fold-in paths to the
JAX package's (R,) uniforms instead, so a test renders from the same
numbers. The arithmetic after the draws is the JAX package's jitted run
op for op: every product its own op, sums over xyz in order, ``x ** n``
by repeated squaring, divisions by constants as products with the
float32 reciprocal (XLA's rewrite), square roots correctly rounded.
cos and sin are taken in float64 and rounded once, where XLA's float32
ones differ in the last ulp on a few inputs; so a few paths leave in a
direction an ulp apart (tests/test_torch_bdpt.py states the bounds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import cross, normalize
from ..core.ray import Rays
from .cameras import _cos, _ipow, _sin
from .path_tracer import (PTScene, _dot, _length, _luma, _reflect, _refract,
                          _trace)
from .pt_fused import _div, _f, _max, _sqrt

K_EPS = 1.0e-3
K_INF = 1.0e30

_INV_PI = float(np.float32(1.0) / np.float32(np.pi))
_TWO_PI = _f(2.0 * np.pi)
_KEPS = _f(K_EPS)
_KINF = _f(K_INF)


def draw_paths(eye_bounces: int, light_bounces: int) -> list[str]:
    """The fold-in paths of one sample's uniforms, in the order a
    generator draws them: per eye step the lobe pick and the cosine
    direction's two uniforms, the light vertex's face pick and two
    barycentric uniforms, its emission direction's two, then per light
    step three as for the eye."""
    def walk(root, n):
        return [p for b in range(n) for p in (
            f"{root}/{100 + b}", f"{root}/{100 + b}/2",
            f"{root}/{100 + b}/2/1")]

    return (walk(1, eye_bounces) + ["2", "2/1", "2/2", "2/3", "2/3/1"]
            + walk(4, light_bounces))


def _norm_dir(to: torch.Tensor):
    """(|to|, to / max(|to|, 1e-30))."""
    dist = _length(to)
    return dist, to / _max(dist[:, None], 1e-30)


def _cos_dir(u1, u2, n):
    """directionCosTheta (main.cc:264-280): simple-ONB cosine sampling;
    returns (dir, pdf = cos/pi)."""
    phi = _TWO_PI * u2
    r = _sqrt(u1)
    x = r * _cos(phi)
    y = r * _sin(phi)
    z = _sqrt(1.0 - u1)
    ex = torch.tensor([1.0, 0.0, 0.0], device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=n.device)
    x_dir = torch.where((n[:, 0].abs() < n[:, 1].abs())[:, None], ex, ey)
    y_dir = normalize(cross(n, x_dir))
    x_dir = cross(y_dir, n)
    d = x_dir * x[:, None] + y_dir * y[:, None] + n * z[:, None]
    return d, z * _INV_PI


def _fresnel(h, n, r):
    r0 = r * r
    c = 1.0 - _dot(h, n)
    return r0 + (1.0 - r0) * _ipow(c, 5)


def _mat(scene: PTScene, fid):
    m = scene.material_ids.long()[fid]
    ms = scene.materials
    return dict(diffuse=ms.diffuse[m], emission=ms.emission[m],
                specular=ms.specular[m], transmittance=ms.transmittance[m],
                ior=ms.ior[m], dissolve=ms.dissolve[m])


def _rhos(mat, wo, orig_n, n):
    """Fresnel-weighted lobe probabilities (main.cc:779-810). ``wo`` points
    away from the surface."""
    inside = torch.where(_dot(-wo, orig_n) < 0, -1.0, 1.0)
    n1 = torch.where(inside < 0, _div(1.0, mat["ior"]), mat["ior"])
    n2 = _div(1.0, n1)
    fres = _fresnel(wo, n, (n1 - n2) / (n1 + n2))
    rho_s = _luma(mat["specular"]) * fres
    rho_d = _luma(mat["diffuse"]) * (1.0 - fres) * (1.0 - mat["dissolve"])
    rho_r = _luma(mat["transmittance"]) * (1.0 - fres) * mat["dissolve"]
    total = rho_s + rho_d + rho_r
    ok = total >= _f(1e-4)
    t = torch.where(ok, total, 1.0)
    return rho_s / t, rho_d / t, rho_r / t, ok, inside, n1


def _is_delta(mat):
    """Vertex::isDelta (main.cc:624-630)."""
    return (mat["specular"] > 0).any(-1) | (mat["transmittance"] > 0).any(-1)


def _eval_f(mat, wo, orig_n, n, wi):
    """Vertex::f (main.cc:634-689): diffuse-only (delta lobes are zero),
    reflect-side gated, lobe-weight normalized."""
    rho_s, rho_d, rho_r, ok, _, _ = _rhos(mat, wo, orig_n, n)
    reflect = _dot(wi, n) * _dot(wo, n) > 0.0
    ret = torch.where(((rho_d > 0) & reflect)[:, None],
                      rho_d[:, None] * mat["diffuse"] * _INV_PI, 0.0)
    weight = torch.where((rho_s > 0) & reflect, rho_s, 0.0)
    weight = weight + torch.where((rho_d > 0) & reflect, rho_d, 0.0)
    weight = weight + torch.where((rho_r > 0) & ~reflect, rho_r, 0.0)
    ret = torch.where((weight != 0)[:, None],
                      ret / _max(weight, 1e-30)[:, None], 0.0)
    return torch.where(ok[:, None], ret, 0.0)


def _pdf_brdf(mat, wi, wo, orig_n, n):
    """pdfBRDF (main.cc:839-887): diffuse cos/pi only."""
    _, rho_d, _, ok, _, _ = _rhos(mat, wo, orig_n, n)
    reflect = _dot(wi, n) * _dot(wo, n) > 0.0
    pdf = torch.where((rho_d > 0) & reflect,
                      rho_d * _dot(wi, n).abs() * _INV_PI, 0.0)
    return torch.where(ok, pdf, 0.0)


def _sample_brdf(mat, wo, orig_n, n, rand, u1, u2):
    """sampleBRDF (main.cc:776-837) from the lobe pick ``rand`` and the
    cosine direction's uniforms. Returns (f, wi, pdf)."""
    rho_s, rho_d, rho_r, ok, inside, n1 = _rhos(mat, wo, orig_n, n)
    pick_s = rand < rho_s
    pick_d = ~pick_s & (rand < rho_s + rho_d)
    pick_r = ~pick_s & ~pick_d & (rand < rho_s + rho_d + rho_r)

    wi_s = _reflect(-wo, n)
    cos_s = _dot(wi_s, n).abs()
    f_s = rho_s[:, None] * mat["specular"] / _max(cos_s, 1e-30)[:, None]
    ok_s = cos_s >= _KEPS

    wi_d, pdf_cos = _cos_dir(u1, u2, n)
    f_d = rho_d[:, None] * mat["diffuse"] * _INV_PI

    wi_r = _refract(-wo, -inside[:, None] * orig_n, n1)
    cos_r = _dot(wi_r, n).abs()
    f_r = rho_r[:, None] * mat["transmittance"] / _max(cos_r, 1e-30)[:, None]
    ok_r = cos_r >= _KEPS

    wi = torch.where(pick_s[:, None], wi_s,
                     torch.where(pick_d[:, None], wi_d, wi_r))
    f = torch.where((pick_s & ok_s)[:, None], f_s,
                    torch.where(pick_d[:, None], f_d,
                                torch.where((pick_r & ok_r)[:, None], f_r,
                                            0.0)))
    pdf = torch.where(pick_s & ok_s, rho_s,
                      torch.where(pick_d, pdf_cos * rho_d,
                                  torch.where(pick_r & ok_r, rho_r, 0.0)))
    pdf = torch.where(ok, pdf, 0.0)
    return f, wi, pdf


def _light_sampler_arrays(scene: PTScene):
    """Area-weighted light CDF (LightSampler, main.cc:692-766); host
    NumPy, as the JAX package computes it. Returns the CDF on the
    scene's device and the total area."""
    lf = scene.light_faces.cpu().numpy()
    f = scene.mesh.faces.cpu().numpy()[lf]
    v = scene.mesh.vertices.cpu().numpy()
    tri = v[f]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0]), axis=-1
    )
    total = float(area.sum())
    cdf = np.cumsum(area) / max(total, 1e-30)
    return (torch.from_numpy(cdf.astype(np.float32)).to(
        scene.mesh.vertices.device), total)


def _sample_light_vertex(scene: PTScene, cdf, total_area, r, u1, u2):
    """Uniform-area point on the emissive geometry (main.cc:732-766) from
    the face pick ``r`` and the barycentric uniforms."""
    sid = torch.searchsorted(cdf, r)
    sid = torch.clamp(sid, max=cdf.shape[0] - 1)
    fid = scene.light_faces.long()[sid]
    f = scene.mesh.faces.long()[fid]
    tri = scene.mesh.vertices[f]
    s = _sqrt(u1)
    c0 = (1.0 - s)[:, None]
    c1 = (s * (1.0 - u2))[:, None]
    c2 = (s * u2)[:, None]
    pos = c0 * tri[:, 0] + c1 * tri[:, 1] + c2 * tri[:, 2]
    if scene.facevarying_normals is not None:
        n3 = scene.facevarying_normals[fid]
        nrm = c0 * n3[:, 0] + c1 * n3[:, 1] + c2 * n3[:, 2]
    else:
        nrm = cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm = normalize(nrm)
    le = scene.materials.emission[scene.material_ids.long()[fid]]
    pdf_pos = 1.0 / total_area
    return pos, nrm, le, pdf_pos


_SLOT_KEYS = ("pos", "norm", "orig_norm", "wo", "beta", "pdf_fwd", "pdf_rev",
              "is_light", "valid", "fid")


def _walk(scene, org0, dir0, beta0, pdf0, prev_pos0, prev_n0, is_eye, draws,
          root, n_steps, tile, has_normals):
    """The subpath random walk (raytrace, main.cc:898-1014), step b
    drawing ``draws[f"{root}/{100 + b}..."]``. Returns per-slot vertex
    tensors, each stacked over the n_steps slots as (R, n_steps, ...)."""
    R = org0.shape[0]
    dev = org0.device
    V = {k: [] for k in _SLOT_KEYS}
    org, d = org0, dir0
    beta = beta0
    pdf_solid = pdf0
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pos, prev_n = prev_pos0, prev_n0
    root_rev = torch.zeros(R, device=dev)
    min_t = torch.full((R,), _KEPS, device=dev)

    for b in range(n_steps):
        k = f"{root}/{100 + b}"
        hits = _trace(scene, org, d, min_t,
                      torch.where(alive, _KINF, 0.0), tile)
        hit = hits.hit & alive
        fid = torch.where(hit, hits.prim_id, 0)
        pos = org + hits.t[:, None] * d

        if has_normals:
            n3 = scene.facevarying_normals[fid]
            w0 = (1.0 - hits.u - hits.v)[:, None]
            nrm = (w0 * n3[:, 0] + hits.u[:, None] * n3[:, 1]
                   + hits.v[:, None] * n3[:, 2])
        else:
            tri = scene.mesh.vertices[scene.mesh.faces.long()[fid]]
            nrm = cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = normalize(nrm)
        orig_n = nrm
        nrm = torch.where((_dot(nrm, d) > 0)[:, None], -nrm, nrm)

        mat = _mat(scene, fid)
        on_light = (mat["emission"] > 0).any(-1)

        # pdfFwd: solid angle -> area using the PREVIOUS vertex's normal
        # (main.cc:991-995)
        dist, to_n = _norm_dir(pos - prev_pos)
        dd = _max(dist * dist, 1e-30)
        pdf_fwd_area = pdf_solid * _dot(to_n, prev_n) / dd

        if is_eye:
            light_beta = beta * mat["emission"] * _max(
                _dot(orig_n, -d), 0.0)[:, None]
            v_beta = torch.where(on_light[:, None], light_beta, beta)
            v_valid = hit
        else:
            v_beta = beta
            v_valid = hit & ~on_light  # light paths drop light hits (958-960)

        V["pos"].append(pos)
        V["norm"].append(nrm)
        V["orig_norm"].append(orig_n)
        V["wo"].append(normalize(-d))
        V["beta"].append(torch.where(v_valid[:, None], v_beta, 0.0))
        V["pdf_fwd"].append(torch.where(v_valid, pdf_fwd_area, 0.0))
        V["pdf_rev"].append(torch.zeros(R, device=dev))
        V["is_light"].append(v_valid & on_light)
        V["valid"].append(v_valid)
        V["fid"].append(fid)

        # continue the walk (light hits stop eye paths too, main.cc:997)
        f, wi, pdf_new = _sample_brdf(mat, -d, orig_n, nrm, draws[k],
                                      draws[f"{k}/2"], draws[f"{k}/2/1"])
        cont = hit & ~on_light & (pdf_new != 0.0)
        new_beta = (f * beta * _dot(nrm, wi).abs()[:, None]
                    / _max(pdf_new, 1e-30)[:, None])
        cont = cont & (new_beta > 0).any(-1)

        # pdfRev write-back to the previous slot (main.cc:1005-1013)
        pdf_rev_solid = _pdf_brdf(mat, -d, wi, orig_n, nrm)
        prev_rev = pdf_rev_solid * _dot(-to_n, nrm).abs() / dd
        if b > 0:
            V["pdf_rev"][b - 1] = torch.where(cont, prev_rev,
                                              V["pdf_rev"][b - 1])
        else:
            root_rev = torch.where(cont, prev_rev, 0.0)

        prev_pos, prev_n = pos, nrm
        org = pos
        d = wi
        beta = torch.where(cont[:, None], new_beta, beta)
        pdf_solid = torch.where(cont, pdf_new, pdf_solid)
        alive = cont

    out = {k: torch.stack(v, dim=1) for k, v in V.items()}  # (R, NB, ...)
    out["root_rev"] = root_rev  # pdfRev written back to the root vertex
    return out


def _assemble(root: dict, walk: dict, n_slots: int):
    """Prepend the root vertex to the walk arrays -> (R, 1+n_steps, ...)."""
    out = {}
    for k in ("pos", "norm", "orig_norm", "wo", "beta"):
        out[k] = torch.cat([root[k][:, None], walk[k]], dim=1)
    out["pdf_fwd"] = torch.cat([root["pdf_fwd"][:, None], walk["pdf_fwd"]], 1)
    out["pdf_rev"] = torch.cat([walk["root_rev"][:, None], walk["pdf_rev"]], 1)
    out["valid"] = torch.cat([torch.ones_like(walk["valid"][:, :1]),
                              walk["valid"]], 1)
    out["is_light"] = torch.cat([root["is_light"][:, None],
                                 walk["is_light"]], 1)
    out["fid"] = torch.cat([torch.zeros_like(walk["fid"][:, :1]),
                            walk["fid"]], 1)
    out["is_root"] = torch.cat([torch.ones_like(walk["valid"][:, :1]),
                                torch.zeros_like(walk["valid"])], 1)
    return out


def _slot(V, i):
    return {k: v[:, i] for k, v in V.items()}


def _vert_delta(scene, v):
    return torch.where(v["is_root"], False, _is_delta(_mat(scene, v["fid"])))


def _vert_f(scene, v, target_pos):
    """Vertex::f toward a target position (main.cc:634-689)."""
    wi = normalize(target_pos - v["pos"])
    return _eval_f(_mat(scene, v["fid"]), v["wo"], v["orig_norm"], v["norm"],
                   wi)


def _vert_pdf(scene, v, wi_pos, wo_pos):
    """pdfBRDF with wi/wo toward the given positions, converted to area
    measure at wo_pos (the weightMIS patch pattern, main.cc:1110-1186)."""
    wi = normalize(wi_pos - v["pos"])
    dist, wo = _norm_dir(wo_pos - v["pos"])
    pdf_o = _pdf_brdf(_mat(scene, v["fid"]), wi, wo, v["orig_norm"],
                      v["norm"])
    return pdf_o * _dot(v["norm"], wo).abs() / _max(dist * dist, 1e-30)


def _rev_light(v_from, v_to):
    """The pdfRev patch from a light-side (or lens) vertex: its cosine
    toward ``v_to``, squared over the distance (main.cc:1112-1128,
    1149-1155)."""
    dist, to_n = _norm_dir(v_to["pos"] - v_from["pos"])
    dot = _dot(v_from["norm"], to_n)
    return _max(dot, 0.0) * dot / _max(dist * dist, 1e-30)


def _weight_mis(scene, E, L, e: int, l: int, total_area: float):
    """weightMIS for static strategy (e, l) (main.cc:1081-1209)."""
    R = E["pos"].shape[0]
    dev = E["pos"].device
    if e <= 2 and l == 0:
        return torch.ones(R, device=dev)

    length = e + l
    fwd = [None] * length
    rev = [None] * length
    for i in range(e):
        fwd[i] = E["pdf_fwd"][:, i]
        rev[i] = E["pdf_rev"][:, i]
    for i in range(l - 1, -1, -1):
        fwd[e + (l - i - 1)] = L["pdf_fwd"][:, i]
        rev[e + (l - i - 1)] = L["pdf_rev"][:, i]

    ve = _slot(E, e - 1)
    vl = _slot(L, l - 1) if l >= 1 else None
    ve_m = _slot(E, e - 2) if e >= 2 else None
    vl_m = _slot(L, l - 2) if l >= 2 else None

    # patch rev[e-1] (main.cc:1106-1128)
    if l == 0:
        rev[e - 1] = torch.full((R,), _f(1.0 / total_area), device=dev)
    elif l == 1:
        rev[e - 1] = _rev_light(vl, ve)
    else:
        rev[e - 1] = _vert_pdf(scene, vl, vl_m["pos"], ve["pos"])

    # patch rev[e] (main.cc:1130-1145)
    if l >= 1:
        rev[e] = _vert_pdf(scene, ve, ve_m["pos"], vl["pos"])

    # patch rev[e-2] (main.cc:1147-1168)
    if e >= 2:
        if l == 0:
            rev[e - 2] = _rev_light(ve, ve_m)
        else:
            rev[e - 2] = _vert_pdf(scene, ve, vl["pos"], ve_m["pos"])

    # patch rev[e+1] (main.cc:1170-1186)
    if l >= 2:
        rev[e + 1] = _vert_pdf(scene, vl, ve["pos"], vl_m["pos"])

    e_delta = [_vert_delta(scene, _slot(E, i)) for i in range(e)]
    l_delta = [_vert_delta(scene, _slot(L, i)) for i in range(l)]

    mis = torch.zeros(R, device=dev)
    prob = torch.ones(R, device=dev)
    for i in range(e - 1, 1, -1):
        pf = torch.where(fwd[i] == 0.0, 1.0, fwd[i])
        pr = torch.where(rev[i] == 0.0, 1.0, rev[i])
        prob = prob * pr / pf
        skip = e_delta[i] | e_delta[i - 1]
        mis = mis + torch.where(skip, 0.0, prob * prob)
    prob = torch.ones(R, device=dev)
    for i in range(e, length):
        pf = torch.where(fwd[i] == 0.0, 1.0, fwd[i])
        pr = torch.where(rev[i] == 0.0, 1.0, rev[i])
        prob = prob * pr / pf
        skip = l_delta[length - i - 1]
        if i + 1 < length:
            skip = skip | l_delta[length - i - 2]
        mis = mis + torch.where(skip, 0.0, prob * prob)
    return _div(1.0, 1.0 + mis)


def _calc_g(scene, v1, v2, tile, active):
    """calcG (main.cc:1211-1243): visibility requires the connection ray
    to hit a surface within kEps of the target distance. ``active``: the
    rays whose result is used; the others are not traced."""
    dist, to_n = _norm_dir(v2["pos"] - v1["pos"])
    R = dist.shape[0]
    dev = dist.device
    hits = _trace(scene, v1["pos"], to_n, torch.full((R,), _KEPS, device=dev),
                  torch.where(active, _KINF, 0.0), tile)
    visible = hits.hit & ((dist - hits.t).abs() <= _KEPS)
    d1 = _max(_dot(to_n, v1["norm"]), 0.0)
    d2 = _max(_dot(-to_n, v2["norm"]), 0.0)
    g = d1 * d2 / _max(dist * dist, 1e-30)
    return torch.where(visible, g, 0.0)


def _generator(seed, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def trace_bdpt(
    scene: PTScene,
    cam_org: torch.Tensor,
    cam_dir: torch.Tensor,
    light_cdf: torch.Tensor,
    seed,
    total_area: float,
    eye_bounces: int = 5,
    light_bounces: int = 4,
    max_bounces: int = 10,
    tile: int = 8192,
    has_normals: bool = False,
    draws: dict | None = None,
):
    """One BDPT sample per camera ray (``cam_org``/``cam_dir`` (R, 3) on
    the scene's device); returns linear RGB (R, 3).

    ``seed``: an int (a new generator on the scene's device) or a
    ``torch.Generator`` there, which draws ``draw_paths(eye_bounces,
    light_bounces)`` in order; or None with ``draws``, a dict from those
    paths to (R,) uniforms. ``tile`` is the JAX signature's and changes
    nothing."""
    R = cam_org.shape[0]
    dev = cam_org.device
    paths = draw_paths(eye_bounces, light_bounces)
    if draws is None:
        if seed is None:
            raise ValueError("trace_bdpt needs a seed, a generator or draws")
        g = _generator(seed, dev)
        draws = {p: torch.rand(R, generator=g, device=dev) for p in paths}
    else:
        missing = [p for p in paths if p not in draws]
        if missing:
            raise ValueError(f"draws lacks the paths {missing}")
        draws = {p: torch.as_tensor(draws[p], dtype=torch.float32,
                                    device=dev).reshape(R) for p in paths}
    cam_org = cam_org.float()
    cam_dir = cam_dir.float()
    one3 = torch.ones((R, 3), device=dev)
    ones = torch.ones(R, device=dev)

    # ---- eye subpath (eyeSubpath, main.cc:1015-1043) ----
    eye_root = dict(
        pos=cam_org,
        norm=cam_dir,  # the lens vertex stores the ray dir as its normal
        orig_norm=cam_dir,
        wo=-cam_dir,
        beta=one3,
        pdf_fwd=ones,
        is_light=torch.zeros(R, dtype=torch.bool, device=dev),
    )
    eye_walk = _walk(scene, cam_org, cam_dir, one3, ones, cam_org, cam_dir,
                     True, draws, 1, eye_bounces, tile, has_normals)
    E = _assemble(eye_root, eye_walk, eye_bounces + 1)

    # ---- light subpath (lightSubpath, main.cc:1045-1080) ----
    lpos, lnorm, le, pdf_pos = _sample_light_vertex(
        scene, light_cdf, total_area, draws["2"], draws["2/1"], draws["2/2"])
    # le / pdf_pos, as XLA computes a division by a constant
    l_beta0 = le * float(np.float32(1.0) / np.float32(pdf_pos))
    ldir, pdf_dir = _cos_dir(draws["2/3"], draws["2/3/1"], lnorm)
    light_root = dict(
        pos=lpos,
        norm=lnorm,
        orig_norm=lnorm,
        wo=lnorm,
        beta=l_beta0,
        pdf_fwd=torch.full((R,), _f(pdf_pos), device=dev),
        is_light=torch.ones(R, dtype=torch.bool, device=dev),
    )
    light_walk = _walk(scene, lpos, ldir, l_beta0, pdf_dir, lpos, lnorm,
                       False, draws, 4, light_bounces, tile, has_normals)
    L = _assemble(light_root, light_walk, light_bounces + 1)

    color = torch.zeros((R, 3), device=dev)

    # ---- l = 0: the eye path hit the light (connectPath, main.cc:1250) ----
    for k in range(1, eye_bounces + 1):
        ev = _slot(E, k)
        mask = E["valid"][:, k] & E["is_light"][:, k]
        mis = _weight_mis(scene, E, L, k + 1, 0, total_area)
        color = color + torch.where(mask[:, None], mis[:, None] * ev["beta"],
                                    0.0)

    # ---- general connections (main.cc:1257-1285) ----
    for e in range(2, eye_bounces + 2):
        ev = _slot(E, e - 1)
        ev_ok = (E["valid"][:, e - 1] & ~E["is_light"][:, e - 1]
                 & ~_vert_delta(scene, ev))
        for l in range(1, light_bounces + 2):
            if e + l - 2 > max_bounces:
                continue
            lv = _slot(L, l - 1)
            lv_ok = L["valid"][:, l - 1]
            if l != 1:
                lv_ok = lv_ok & ~_vert_delta(scene, lv)
            active = ev_ok & lv_ok
            if l == 1:
                _, to_n = _norm_dir(lv["pos"] - ev["pos"])
                contrib = (ev["beta"] * _vert_f(scene, ev, lv["pos"])
                           * lv["beta"]
                           * _dot(lv["norm"], -to_n).abs()[:, None])
            else:
                contrib = (ev["beta"] * _vert_f(scene, ev, lv["pos"])
                           * _vert_f(scene, lv, ev["pos"]) * lv["beta"])
            nonzero = (contrib != 0).any(-1) & active
            g = _calc_g(scene, ev, lv, tile, nonzero)
            mis = _weight_mis(scene, E, L, e, l, total_area)
            color = color + torch.where(
                nonzero[:, None], contrib * g[:, None] * mis[:, None], 0.0)

    return color


def render_bdpt(scene: PTScene, cam_rays: Rays, seed, spp: int = 4,
                eye_bounces: int = 5, light_bounces: int = 4,
                tile: int = 8192):
    """Accumulate spp BDPT samples per camera ray (main.cc:1378-1398).
    ``seed``: an int or a ``torch.Generator`` on the scene's device, which
    draws every sample's uniforms in turn."""
    cdf, total = _light_sampler_arrays(scene)
    bs = cam_rays.batch_shape
    org = cam_rays.org.reshape(-1, 3)
    d = cam_rays.dir.reshape(-1, 3)
    g = _generator(seed, org.device)
    acc = torch.zeros((org.shape[0], 3), device=org.device)
    for s in range(spp):
        acc = acc + trace_bdpt(
            scene, org, d, cdf, g, total, eye_bounces=eye_bounces,
            light_bounces=light_bounces, tile=tile,
            has_normals=scene.facevarying_normals is not None)
    return (acc / torch.full((), float(spp), device=acc.device)
            ).reshape(*bs, 3)
