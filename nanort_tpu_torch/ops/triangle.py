"""Watertight ray-triangle intersection on torch tensors (port of
``nanort_tpu.ops.triangle``; Woop/Benthin/Wald, JCGT 2013).

* ``ray_coeffs`` — the per-ray shear transform (reference
  ``PrepareTraversal``, nanort.h:1163-1201): max-|dir| axis kz (first max
  wins), cyclic kx/ky swapped when dir[kz] < 0, shear constants Sx/Sy/Sz.
* ``intersect_triangles`` — shear-space edge functions U/V/W with the
  reference's exact fallback when an edge function is exactly zero
  (nanort.h:1093-1107; Dekker two-product compensation stands in for the
  reference's double recompute), sign-consistency rejection, optional
  back-face culling, barycentrics u = V/det, v = W/det.

This is also the plain version of the CUDA kernel's leaf test
(``csrc/packet_traverse.cu``): the kernel performs the same operations in
the same order, compiled with ``--fmad=false``. Every product here is its
own tensor op — never ``addcmul`` or another fused op — and reciprocals
are true divisions (``ones / x``; torch evaluates ``1.0 / x`` as
``reciprocal(x) * 1.0``), so the two agree bit for bit. Acceptance:
``tt > t_cur`` rejects (an equal-t hit replaces), ``tt < min_t`` rejects
(nanort.h:1131-1139).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RayCoeffs(NamedTuple):
    """Per-ray watertight shear coefficients (reference RayCoeff,
    nanort.h:1042-1049). ``k*`` are int64 axis ids, ``s*`` floats."""

    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor


def _comp(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Select component ``k`` of trailing-xyz ``v`` (k broadcasts)."""
    return torch.where(k == 0, v[..., 0], torch.where(k == 1, v[..., 1], v[..., 2]))


def ray_coeffs(dir: torch.Tensor) -> RayCoeffs:
    """Shear coefficients for directions ``(..., 3)``. Ties in |dir|
    resolve to the lowest axis (the reference's strict comparison chain,
    nanort.h:1166-1176)."""
    ad = dir.abs()
    kz = torch.where(ad[..., 1] > ad[..., 0], 1, 0)
    amax = torch.where(ad[..., 1] > ad[..., 0], ad[..., 1], ad[..., 0])
    kz = torch.where(ad[..., 2] > amax, 2, kz)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = _comp(dir, kz)
    neg = dz < 0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    return RayCoeffs(kx=kx, ky=ky, kz=kz, sx=_comp(dir, kx) / dz,
                     sy=_comp(dir, ky) / dz, sz=torch.ones_like(dz) / dz)


def _split_const(dtype) -> float:
    """Veltkamp splitting constant 2^ceil(p/2)+1 (p = mantissa bits)."""
    return 4097.0 if torch.finfo(dtype).bits <= 32 else 134217729.0


def _two_prod(a, b):
    """Exact product a*b = p + err by Dekker/Veltkamp splitting. Needs
    every product rounded on its own (no FMA); exact barring overflow."""
    c = _split_const(a.dtype)
    p = a * b
    a1 = a * c
    a_hi = a1 - (a1 - a)
    a_lo = a - a_hi
    b1 = b * c
    b_hi = b1 - (b1 - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _exact_prod_diff(a, b, c, d):
    """Doubled-precision a*b - c*d (the reference's float->double
    fallback, nanort.h:1093-1107)."""
    p1, e1 = _two_prod(a, b)
    p2, e2 = _two_prod(c, d)
    return (p1 - p2) + (e1 - e2)


def intersect_triangles(coeffs: RayCoeffs, org, min_t, t_cur, p0, p1, p2,
                        cull_back_face: bool = False,
                        exact_edge_fallback: bool = True):
    """Watertight test of broadcast (ray, triangle) pairs.

    ``coeffs``/``org``/``min_t``/``t_cur`` are per-ray, ``p0``/``p1``/
    ``p2`` are triangle vertices ``(..., 3)``; all broadcast. Hits
    farther than ``t_cur`` reject, an equal distance is accepted.
    Returns ``(valid, tt, u, v)`` with the broadcast batch shape.
    """
    A = p0 - org
    B = p1 - org
    C = p2 - org

    az = _comp(A, coeffs.kz)
    bz = _comp(B, coeffs.kz)
    cz = _comp(C, coeffs.kz)

    ax = _comp(A, coeffs.kx) - coeffs.sx * az
    ay = _comp(A, coeffs.ky) - coeffs.sy * az
    bx = _comp(B, coeffs.kx) - coeffs.sx * bz
    by = _comp(B, coeffs.ky) - coeffs.sy * bz
    cx = _comp(C, coeffs.kx) - coeffs.sx * cz
    cy = _comp(C, coeffs.ky) - coeffs.sy * cz

    u_e = cx * by - cy * bx
    v_e = ax * cy - ay * cx
    w_e = bx * ay - by * ax

    if exact_edge_fallback:
        any_zero = (u_e == 0) | (v_e == 0) | (w_e == 0)
        u_e = torch.where(any_zero, _exact_prod_diff(cx, by, cy, bx), u_e)
        v_e = torch.where(any_zero, _exact_prod_diff(ax, cy, ay, cx), v_e)
        w_e = torch.where(any_zero, _exact_prod_diff(bx, ay, by, ax), w_e)

    any_neg = (u_e < 0) | (v_e < 0) | (w_e < 0)
    any_pos = (u_e > 0) | (v_e > 0) | (w_e > 0)
    if cull_back_face:
        edge_ok = ~any_neg
    else:
        edge_ok = ~(any_neg & any_pos)

    det = u_e + v_e + w_e
    det_ok = det != 0

    t_num = u_e * (coeffs.sz * az) + v_e * (coeffs.sz * bz) + w_e * (coeffs.sz * cz)
    one = torch.ones_like(det)
    rcp_det = one / torch.where(det_ok, det, one)
    tt = t_num * rcp_det

    valid = edge_ok & det_ok & (tt <= t_cur) & (tt >= min_t)
    return valid, tt, v_e * rcp_det, w_e * rcp_det


def gather_triangle_vertices(vertices: torch.Tensor, faces: torch.Tensor):
    """Fetch (p0, p1, p2) for a batch of faces ``(..., 3)`` (reference
    ``get_vertex_addr``, nanort.h:468-472)."""
    tri = vertices[faces.long()]
    return tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]


class TriangleMesh(NamedTuple):
    """Indexed triangle mesh: ``vertices`` (V, 3) float, ``faces`` (F, 3)
    int. Fields may be NumPy arrays (host build) or torch tensors."""

    vertices: object
    faces: object


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def triangle_prim_bounds(mesh: TriangleMesh):
    """Per-face AABBs + centroids for the builder (host NumPy). Centroid
    = vertex mean, matching TriangleSAHPred (nanort.h:906-910)."""
    tri = _to_numpy(mesh.vertices)[_to_numpy(mesh.faces)]  # (F, 3, 3)
    return tri.min(axis=1), tri.max(axis=1), tri.mean(axis=1)
