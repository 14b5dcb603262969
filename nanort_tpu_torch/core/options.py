"""Build / trace option structs.

These mirror the reference's ``BVHBuildOptions`` (nanort.h:558-583),
``BVHTraceOptions`` (nanort.h:601-624) and ``BVHBuildStatistics``
(nanort.h:585-599) with identical defaults, expressed as frozen Python
dataclasses so they are hashable. Framework-free: a copy of
``nanort_tpu.core.options``, so both packages share one set of defaults.
"""

from __future__ import annotations

import dataclasses

# Reference compile-time constants (nanort.h:62-82).
MAX_STACK_DEPTH = 512
MIN_PRIMITIVES_FOR_PARALLEL_BUILD = 1024 * 8
SHALLOW_DEPTH = 4

# Sentinel prim id for "no hit" / "no skip" (matches C++ unsigned(-1)).
INVALID_PRIM_ID = 0xFFFFFFFF
PRIM_RANGE_MAX = 0x7FFFFFFF  # 2G primitive cap (nanort.h:619)


@dataclasses.dataclass(frozen=True)
class BVHBuildOptions:
    """SAH build parameters; defaults match nanort.h:558-583."""

    cost_t_aabb: float = 0.2
    min_leaf_primitives: int = 4
    max_tree_depth: int = 256
    bin_size: int = 64
    shallow_depth: int = SHALLOW_DEPTH
    cache_bbox: bool = False
    # TPU addition: hard cap on primitives per leaf so device traversal
    # can unroll leaf tests statically. The reference's leaves are bounded
    # by min_leaf_primitives except at max depth; we enforce the cap by
    # median-splitting oversized ranges.
    max_leaf_primitives: int = 4

    def __post_init__(self):
        if self.max_leaf_primitives < self.min_leaf_primitives:
            object.__setattr__(
                self, "max_leaf_primitives", self.min_leaf_primitives
            )


@dataclasses.dataclass(frozen=True)
class BVHTraceOptions:
    """Trace-time filters; defaults match nanort.h:601-624."""

    prim_ids_range: tuple = (0, PRIM_RANGE_MAX)
    skip_prim_id: int = INVALID_PRIM_ID
    cull_back_face: bool = False
    # TPU addition: whether the watertight triangle test performs the
    # reference's exact edge-function fallback when U/V/W == 0
    # (nanort.h:1093-1107). Implemented with double-word (Dekker) products
    # on TPU where fp64 is unavailable.
    exact_edge_fallback: bool = True


@dataclasses.dataclass
class BVHBuildStatistics:
    """Build statistics (nanort.h:585-599). Unlike the reference, we also
    populate ``build_secs``."""

    max_tree_depth: int = 0
    num_leaf_nodes: int = 0
    num_branch_nodes: int = 0
    build_secs: float = 0.0
