"""Robust ray-AABB slab test on torch tensors (port of
``nanort_tpu.core.aabb``).

Re-derivation of the reference's ``IntersectRayAABB`` (nanort.h:2278-2370),
Ize, "Robust BVH Ray Traversal", JCGT 2013: slab planes chosen by the
direction sign, exit distances inflated by a 4-ulp multiplier, and
NaN-filtering folds so 0*inf NaNs from in-plane rays never poison the
interval. Everything broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch


def max_mult(dtype) -> float:
    """4-ulp robust exit-plane multiplier (nanort.h:2303-2305, 2347-2348)."""
    if torch.finfo(dtype).bits >= 64:
        return 1.0000000000000004
    return 1.00000024


def intersect_ray_aabb(bmin, bmax, org, inv_dir, dir_neg, min_t, max_t):
    """Slab test. Args broadcast; trailing axis is xyz.

    ``dir_neg`` is the boolean per-axis sign (``ray.dir < 0``).
    Returns ``(hit, tmin, tmax)``.
    """
    near = torch.where(dir_neg, bmax, bmin)
    far = torch.where(dir_neg, bmin, bmax)
    t_near = (near - org) * inv_dir
    t_far = (far - org) * inv_dir * max_mult(org.dtype)
    # safemax fold: NaN lanes behave as -inf for the max, +inf for the min
    t_near = torch.where(torch.isnan(t_near), float("-inf"), t_near)
    t_far = torch.where(torch.isnan(t_far), float("inf"), t_far)
    tmin = torch.maximum(t_near.amax(dim=-1), min_t)
    tmax = torch.minimum(t_far.amin(dim=-1), max_t)
    return tmin <= tmax, tmin, tmax
