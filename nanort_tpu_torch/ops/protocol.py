"""Trace-option filters shared by every traversal (port of
``apply_trace_filters`` from ``nanort_tpu.ops.protocol``).

The prim-id range and the self-intersection skip (nanort.h:1054-1063)
are applied uniformly by the traversal, not per primitive kind. Prim ids
are int64 tensors here (see ``core/ray.py``).
"""

from __future__ import annotations

import torch

from ..core.options import INVALID_PRIM_ID


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
