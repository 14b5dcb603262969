"""Ray sorting for incoherent batches (port of
``nanort_tpu.traverse.ray_sort``).

A batch of secondary rays (bounces, shadow rays) arrives in pixel order,
so neighbouring rays share no geometry. Sorting them by a spatial and
directional key gives the traversal kernel warps whose 32 rays start in
one cell and point into one octant, so they fetch the same node rows.
The key is the JAX package's, bit for bit: a 15-bit Morton code of the
origin quantized to a 32^3 grid over the scene box, then the 3-bit
direction octant (or octant first with ``octant_major``), and a dead bit
(31) that sorts rays with an empty interval last.

The keys are uint32 values carried in int64 (torch has few uint32
operations). ``torch.argsort(..., stable=True)`` gives the order, as the
stable ``jnp.argsort`` does, and permuting is plain indexing: the JAX
package's ``core/rowpack.py`` works around TPU gathers that canonicalise
NaN payloads, and torch indexing keeps every bit.
"""

from __future__ import annotations

import torch

from ..build.lbvh import _expand_bits
from ..core.ray import Hits, Rays
from ..utils import trace


def ray_sort_keys(rays: Rays, scene_lo, scene_hi,
                  octant_major: bool = False) -> torch.Tensor:
    """(R,) int64 keys holding the JAX package's uint32 keys: dead bit
    (31) . origin Morton (15 bits) . octant (3 bits), or octant above
    Morton with ``octant_major``. Rays with ``max_t <= min_t`` (the
    megabatch renderers' terminated paths and inactive shadow rays) sort
    last, so a bounce's cost tracks its live rays."""
    org = rays.org.reshape(-1, 3)
    d = rays.dir.reshape(-1, 3)
    dead = (rays.max_t <= rays.min_t).reshape(-1)
    lo = torch.as_tensor(scene_lo, dtype=org.dtype, device=org.device)
    hi = torch.as_tensor(scene_hi, dtype=org.dtype, device=org.device)
    ext = torch.maximum(hi - lo, torch.full_like(lo, 1e-30))
    cell = ((org - lo) / ext * 32.0).clamp(0.0, 31.0)
    # a NaN origin quantizes to cell 0, as XLA's float -> uint32 does
    q = torch.nan_to_num(cell, nan=0.0).long()
    morton = ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
              | _expand_bits(q[:, 2]))
    octant = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2
              + (d[:, 2] < 0).long())
    if octant_major:
        key = (octant << 15) | morton
    else:
        key = (morton << 3) | octant
    return key | (dead.long() << 31)


def sort_rays(rays: Rays, scene_lo, scene_hi, octant_major: bool = False):
    """Returns ``(sorted flat rays, order, unsort)``; ``unsort`` maps a
    NamedTuple of (R, ...) results (``Hits``) back to the rays' order
    and batch shape."""
    bs = rays.batch_shape
    with trace.span("ray_sort.sort"):
        flat = Rays(*(x.reshape((-1,) + x.shape[len(bs):]) for x in rays))
        keys = ray_sort_keys(flat, scene_lo, scene_hi, octant_major)
        order = torch.argsort(keys, stable=True)
        sorted_rays = Rays(*(x[order] for x in flat))

    def unsort(tree):
        def back(x):
            out = torch.empty_like(x)
            out[order] = x
            return out.reshape(bs + x.shape[1:])

        with trace.span("ray_sort.unsort"):
            return type(tree)(*(back(x) for x in tree))

    return sorted_rays, order, unsort


def traverse_bvh8_sorted(scene8, rays: Rays, *args, **kwargs) -> Hits:
    """Sort -> ``traverse_bvh8`` -> unsort: the entry point for
    incoherent batches. Takes ``traverse_bvh8``'s arguments (with
    ``intersector``), plus ``octant_major``; a per-ray ``skip_prim_id``
    is permuted with the rays."""
    from .packet import traverse_bvh8

    # the root row's child-0 box stands in for the scene box (exactness
    # does not matter: the key only groups rays)
    lo = scene8.nodes[0, 0:3]
    hi = scene8.nodes[0, 3:6]
    skip = kwargs.pop("skip_prim_id", None)
    octant_major = kwargs.pop("octant_major", False)
    sorted_rays, order, unsort = sort_rays(rays, lo, hi, octant_major)
    if skip is not None:
        with trace.span("ray_sort.sort"):
            skip = torch.as_tensor(skip, device=order.device).reshape(-1)[
                order]
    hits = traverse_bvh8(scene8, sorted_rays, *args, skip_prim_id=skip,
                         **kwargs)
    return unsort(hits)
