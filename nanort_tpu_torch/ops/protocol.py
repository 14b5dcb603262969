"""The primitive protocol and the trace-option filters shared by every
traversal (port of ``nanort_tpu.ops.protocol``).

A primitive *kind* is a set of pure functions over its data, registered
in a :class:`PrimitiveKind` (the reference's Geometry/Pred/Intersector
template triad, nanort.h:862-1229):

* ``num_prims(data)``      -> int                      (host)
* ``prim_bounds(data)``    -> (bmin, bmax, centers)    (host; feeds build)
* ``prepare(data, rays)``  -> per-ray context          (``PrepareTraversal``)
* ``intersect(data, ctx, prim_ids, t_cur)`` -> (valid, t, u, v)
  (``Intersect``; batched: ``prim_ids`` carries a trailing leaf axis)

The prim-id range and the self-intersection skip (nanort.h:1054-1063)
are applied uniformly by the traversal, not per primitive kind. Prim ids
are int64 tensors here (see ``core/ray.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.options import INVALID_PRIM_ID


@dataclasses.dataclass(frozen=True)
class PrimitiveKind:
    """Static function table for one primitive type (hashable)."""

    name: str
    num_prims: Callable[[Any], int]
    prim_bounds: Callable[[Any], tuple]
    prepare: Callable[[Any, Any], Any]
    intersect: Callable[[Any, Any, torch.Tensor, torch.Tensor], tuple]


def apply_trace_filters(valid: torch.Tensor, prim_ids: torch.Tensor,
                        prim_range: tuple, skip_prim_id) -> torch.Tensor:
    """Prim-id range and skip filters (nanort.h:1054-1063).

    ``skip_prim_id`` may be None, a scalar, or a per-ray tensor
    broadcastable against ``prim_ids`` minus its trailing leaf axis (the
    path tracer skips a different prim per ray).
    """
    lo, hi = prim_range
    if lo > 0:
        valid = valid & (prim_ids >= lo)
    if hi <= 0x7FFFFFFE:
        valid = valid & (prim_ids < hi)
    if skip_prim_id is None:
        return valid
    if isinstance(skip_prim_id, int):
        if skip_prim_id == INVALID_PRIM_ID:
            return valid  # disabled (the reference default)
        return valid & (prim_ids != skip_prim_id)
    skip = torch.as_tensor(skip_prim_id, device=prim_ids.device).long()
    if skip.ndim:
        skip = skip[..., None]  # per-ray skip vs trailing leaf axis
    return valid & (prim_ids != skip)


def _build_bvh(bmin, bmax, centers, options):
    """Binary SAH BVH over host boxes: the native builder when it is
    available (float32), else ``build/sah.py``."""
    import numpy as np

    from ..build.native import build_sah_native, native_available
    from ..build.sah import build_sah
    from ..core.options import BVHBuildOptions

    options = options or BVHBuildOptions()
    if np.asarray(bmin).dtype == np.float32 and native_available():
        return build_sah_native(bmin, bmax, centers, options)
    return build_sah(bmin, bmax, centers, options)
