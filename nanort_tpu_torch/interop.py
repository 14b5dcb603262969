"""Carry the JAX package's objects into the port, through NumPy.

The tests feed both packages one identical binary BVH, one identical
BVH8/BVH16 table set and one identical ray batch: take the JAX objects'
fields with ``np.asarray`` and rebuild the port's objects here. Nothing
in this module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .build.bvh8 import BVH8Scene
from .core.bvh import BVH
from .core.ray import Rays


def bvh_from_numpy(bmin, bmax, flag, axis, data, indices) -> BVH:
    """A port ``BVH`` from the six fields of a binary BVH (either
    package's ``BVH`` unpacks into them in this order)."""
    return BVH(
        bmin=np.array(bmin), bmax=np.array(bmax),
        flag=np.array(flag, np.int32), axis=np.array(axis, np.int32),
        data=np.array(data, np.uint32), indices=np.array(indices, np.uint32),
    )


def scene_from_numpy(nodes, leafs, num_nodes, num_leaf_rows, depth,
                     max_leaf, width) -> BVH8Scene:
    """A port ``BVH8Scene`` (host tables) from a BVH8/BVH16 table set."""
    return BVH8Scene(
        nodes=np.ascontiguousarray(nodes, np.float32),
        leafs=np.ascontiguousarray(leafs, np.float32),
        num_nodes=int(num_nodes), num_leaf_rows=int(num_leaf_rows),
        depth=int(depth), max_leaf=int(max_leaf), width=int(width),
    )


def rays_from_numpy(org, dir, min_t, max_t, device=None) -> Rays:
    """Contiguous float32 ``Rays`` on ``device`` from four arrays."""

    def t(x):
        return torch.as_tensor(np.array(x, np.float32, order="C"), device=device)

    return Rays(t(org), t(dir), t(min_t), t(max_t))
