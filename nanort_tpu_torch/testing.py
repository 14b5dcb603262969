"""Hit-record comparison under the repository's parity rules.

Two traversals agree when they report the same hit mask; the same
``prim_id`` except where both hits sit at exactly equal t (ties resolve
by traversal order, which legally differs between engines); ``t``
within a few ulp; and ``u``/``v`` within an absolute error, since ulp
distance is meaningless near a zero barycentric. Used by the tests (port
against the JAX package) and by ``chip_smoke.py`` (kernel against the
brute-force oracle on the card). Works on NumPy arrays and tensors.
"""

from __future__ import annotations

import numpy as np

from .core.options import INVALID_PRIM_ID

T_ULPS = 4
UV_ATOL = 2e-6


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def same_bits(a, b) -> bool:
    """True when two arrays have one dtype, one shape and equal bytes
    (NaN payloads and the sign of zero included)."""
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 ulps (int64; +0 and -0 are 0
    apart, and the count runs through zero across signs)."""
    ia = np.ascontiguousarray(_np(a), np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(_np(b), np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def compare_hits(got, want, t_ulps: int = T_ULPS,
                 uv_atol: float = UV_ATOL) -> dict:
    """Compare two hit records (anything with ``t/u/v/prim_id``).

    Returns counts and maxima with ``ok`` set when: the hit masks are
    equal; prim ids differ only where t is bit-equal; t is within
    ``t_ulps`` on every common hit; u/v are within ``uv_atol`` wherever
    the prim ids agree."""
    gp = _np(got.prim_id).astype(np.int64)
    wp = _np(want.prim_id).astype(np.int64)
    gt, wt = _np(got.t), _np(want.t)
    gh = gp != INVALID_PRIM_ID
    wh = wp != INVALID_PRIM_ID
    both = gh & wh
    same = both & (gp == wp)
    diff = both & (gp != wp)
    ties = diff & (gt == wt)
    t_ulp = int(ulp_distance(gt[both], wt[both]).max(initial=0))
    uv = 0.0
    if same.any():
        uv = float(max(np.abs(_np(got.u)[same] - _np(want.u)[same]).max(),
                       np.abs(_np(got.v)[same] - _np(want.v)[same]).max()))
    r = dict(
        n=int(gh.size), hits=int(gh.sum()),
        hit_mismatch=int((gh != wh).sum()),
        prim_mismatch=int((diff & ~ties).sum()), ties=int(ties.sum()),
        t_max_ulp=t_ulp, uv_max_err=uv,
    )
    r["ok"] = (r["hit_mismatch"] == 0 and r["prim_mismatch"] == 0
               and t_ulp <= t_ulps and uv <= uv_atol)
    return r
