"""SoA ray batches and hit records on torch tensors (port of
``nanort_tpu.core.ray``).

``prim_id`` dtype: **int64**, holding ``INVALID_PRIM_ID = 0xFFFFFFFF``
for a miss. torch's uint32 supports few operations; int64 holds every
uint32 value, so ``np.asarray(hits.prim_id)`` compares equal to the JAX
package's uint32 records element for element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .options import INVALID_PRIM_ID

PRIM_ID_DTYPE = torch.int64

# Ray type bitmask (nanort.h:85-94).
RAY_TYPE_NONE = 0x0
RAY_TYPE_PRIMARY = 0x1
RAY_TYPE_SECONDARY = 0x2
RAY_TYPE_DIFFUSE = 0x4
RAY_TYPE_REFLECTION = 0x8
RAY_TYPE_REFRACTION = 0x10


class Rays(NamedTuple):
    """A batch of rays. ``org``/``dir``: (..., 3); ``min_t``/``max_t``: (...,)."""

    org: torch.Tensor
    dir: torch.Tensor
    min_t: torch.Tensor
    max_t: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.org.shape[:-1])

    @property
    def dtype(self):
        return self.org.dtype


def make_rays(org, dir, min_t=None, max_t=None, dtype=None,
              device=None) -> Rays:
    """Build a ``Rays`` batch with reference defaults (min_t=0,
    max_t=+max). ``org``/``dir`` may be tensors, arrays or lists; new
    tensors are created on ``device`` (default: ``org``'s device, or the
    card for non-tensors, as the other entry points default to it). Every
    field comes back contiguous, as the traversal kernel requires."""
    if device is None:
        device = org.device if isinstance(org, torch.Tensor) else "cuda"
    org = torch.as_tensor(org, dtype=dtype, device=device)
    dir = torch.as_tensor(dir, dtype=org.dtype, device=org.device)
    bs = org.shape[:-1]
    dt = org.dtype
    if min_t is None:
        min_t = torch.zeros(bs, dtype=dt, device=org.device)
    else:
        min_t = torch.as_tensor(min_t, dtype=dt, device=org.device)
    if max_t is None:
        max_t = torch.full(bs, torch.finfo(dt).max, dtype=dt,
                           device=org.device)
    else:
        max_t = torch.as_tensor(max_t, dtype=dt, device=org.device)
    return Rays(org.contiguous(), dir.contiguous(),
                min_t.expand(bs).contiguous(), max_t.expand(bs).contiguous())


class Hits(NamedTuple):
    """Hit records matching ``TriangleIntersection<T>`` (nanort.h:996-1005):
    ``t``/``u``/``v`` floats, ``prim_id`` int64 (0xFFFFFFFF = miss)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_id: torch.Tensor

    @property
    def hit(self) -> torch.Tensor:
        return self.prim_id != INVALID_PRIM_ID


def no_hits(batch_shape, dtype=torch.float32, init_t=None,
            device=None) -> Hits:
    """All-miss hit record; ``t`` initialized to ``max_t`` like the
    reference's ``intersector.Update(ray.max_t, -1)`` (nanort.h:2501).
    New tensors go on ``device`` (default: ``init_t``'s, or the card)."""
    if device is None:
        device = init_t.device if isinstance(init_t, torch.Tensor) else "cuda"
    bs = tuple(batch_shape)
    if init_t is None:
        init_t = torch.full(bs, torch.finfo(dtype).max, dtype=dtype,
                            device=device)
    return Hits(
        t=torch.as_tensor(init_t, dtype=dtype, device=device),
        u=torch.zeros(bs, dtype=dtype, device=device),
        v=torch.zeros(bs, dtype=dtype, device=device),
        prim_id=torch.full(bs, INVALID_PRIM_ID, dtype=PRIM_ID_DTYPE,
                           device=device),
    )
