"""BVH refit: new node bounds for deformed geometry, fixed topology (port
of ``nanort_tpu.build.refit``; jitted XLA there, plain torch here).

The reference rebuilds from scratch on any change; for animated meshes a
refit is the standard cheap path: leaf bounds recompute from the new
primitive bounds, internal bounds re-union bottom-up, in depth-bounded
fixed-point passes like ``build/lbvh.py``'s (no per-node recursion).

Refitted trees keep the exact traversal contract (topology, leaf ranges,
preorder); quality degrades only as the geometry drifts from what the
tree was built for.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bvh import BVH, stats_from_bvh
from ..core.math import maximum, minimum


def _refit_arrays(bmin, flag, data, indices, prim_bmin, prim_bmax,
                  max_leaf: int, n_passes: int):
    """(lo, hi) per node: the JAX package's ``_refit_jit``."""
    n = flag.shape[0]
    dt = bmin.dtype
    dev = bmin.device
    is_leaf = (flag == 1)[:, None]
    count = torch.where(flag == 1, data[:, 0], 0)
    offset = torch.where(flag == 1, data[:, 1], 0)

    # leaf bounds: union over the (capped) leaf window
    lo = torch.full((n, 3), 3e38, dtype=dt, device=dev)
    hi = torch.full((n, 3), -3e38, dtype=dt, device=dev)
    last = indices.shape[0] - 1
    for k in range(max_leaf):
        valid = is_leaf & (k < count)[:, None]
        pid = indices[(offset + k).clamp(max=last)]
        lo = torch.where(valid, minimum(lo, prim_bmin[pid]), lo)
        hi = torch.where(valid, maximum(hi, prim_bmax[pid]), hi)

    l, r = data[:, 0], data[:, 1]
    # a leaf's data are (count, offset), not rows; never read there
    l, r = torch.where(flag == 1, 0, l), torch.where(flag == 1, 0, r)
    for _ in range(n_passes):
        nlo = minimum(lo[l], lo[r])
        nhi = maximum(hi[l], hi[r])
        lo = torch.where(is_leaf, lo, nlo)
        hi = torch.where(is_leaf, hi, nhi)
    return lo, hi


def refit_bvh(bvh: BVH, prim_bmin, prim_bmax, max_leaf: int | None = None,
              max_depth: int | None = None, device=None) -> BVH:
    """New BVH with the same topology and bounds refit to the given
    primitive AABBs. The passes run on ``device`` (default: the device of
    ``prim_bmin`` when it is a tensor, else the card); the result is a
    host ``BVH`` like the input."""
    flag = np.asarray(bvh.flag)
    data = np.asarray(bvh.data)
    if max_leaf is None:
        max_leaf = int(data[flag == 1, 0].max(initial=1))
    if max_depth is None:
        max_depth = stats_from_bvh(bvh).max_tree_depth + 1
    if device is None:
        device = prim_bmin.device if isinstance(prim_bmin, torch.Tensor) \
            else "cuda"

    def tab(x, dtype=None):
        t = torch.as_tensor(x, device=device)
        return t if dtype is None else t.to(dtype)

    bmin = tab(np.asarray(bvh.bmin))
    prim_bmin = tab(prim_bmin, bmin.dtype)
    prim_bmax = tab(prim_bmax, bmin.dtype)
    lo, hi = _refit_arrays(
        bmin, tab(flag, torch.long), tab(data.astype(np.int64)),
        tab(np.asarray(bvh.indices).astype(np.int64)), prim_bmin,
        prim_bmax, int(max_leaf), int(max_depth))
    return BVH(
        bmin=lo.cpu().numpy(), bmax=hi.cpu().numpy(),
        flag=np.asarray(bvh.flag), axis=np.asarray(bvh.axis),
        data=np.asarray(bvh.data), indices=np.asarray(bvh.indices),
    )
