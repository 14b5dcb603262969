"""nanort_tpu_torch — the PyTorch/CUDA port of nanort_tpu.

The same ray-tracing system as ``nanort_tpu`` (the JAX package beside
it, which stays the reference), on torch tensors, with the TPU's Pallas
kernels rewritten by hand for NVIDIA Hopper. The main path:

    bvh, stats = build_triangle_bvh(mesh, BVHBuildOptions(9, ..., 9))
    scene = collapse_bvh8(bvh, v, f, width=16).to("cuda")
    rays = pinhole_rays(look_at(eye, center, ..., device="cuda"))
    hits = traverse_image(scene, rays)  # one K1 launch, (H, W) records

Config A (``models.objrender``): ``render_aovs`` / ``render_ao`` on K1
with ``scene8``, or on the reference-exact stack engine
``traverse_triangles`` without it; ``models.ao_fused.render_ao_fused``
does the AO pass in one launch (K5).

The device build: ``build.device_collapse.collapse_lbvh_device(v, f,
width=16)`` makes the same tables on the card, with no host pass over
the primitives (``build.lbvh.build_lbvh`` the binary tree,
``build.refit.refit_bvh`` new bounds for moved geometry). Spheres,
cylinders and curves (``ops.sphere``, ``ops.cylinder``, ``ops.curve``)
and ``multi_hit_traverse`` run on the stack engine.

This package imports torch and NumPy, never jax: ``nanort_tpu``'s own
``__init__`` pulls in jax, so nothing here imports from it.
"""

from .core.aabb import intersect_ray_aabb, max_mult
from .core.bvh import BVH, compute_skip_links, dump, load, validate
from .core.math import safe_inverse
from .core.options import (
    BVHBuildOptions,
    BVHBuildStatistics,
    BVHTraceOptions,
    INVALID_PRIM_ID,
)
from .core.ray import (
    PRIM_ID_DTYPE,
    Hits,
    Rays,
    RAY_TYPE_DIFFUSE,
    RAY_TYPE_NONE,
    RAY_TYPE_PRIMARY,
    RAY_TYPE_REFLECTION,
    RAY_TYPE_REFRACTION,
    RAY_TYPE_SECONDARY,
    make_rays,
    no_hits,
)
from .build.sah import build_sah
from .utils import trace as _trace
from .ops.triangle import (
    TriangleMesh,
    intersect_triangles,
    ray_coeffs,
    triangle_prim_bounds,
)
from .traverse.brute import brute_force_traverse
from .traverse.multi_hit import MultiHits, multi_hit_traverse
from .traverse.stack import (
    list_node_intersections,
    traverse,
    traverse_triangles,
)

__version__ = "0.1.0"


@_trace.span("build.sah")
def build_triangle_bvh(mesh, options: BVHBuildOptions = BVHBuildOptions(),
                       use_native: bool = True):
    """Per-face bounds -> binned-SAH linear BVH (reference
    ``BVHAccel<float>::Build``, nanort.h:716-718, 1892-2149). Uses the
    multithreaded C++ builder for float32 meshes when g++ is available
    (``build.native.native_available()``), the NumPy builder otherwise.
    Mesh fields may be NumPy arrays or torch tensors."""
    import numpy as np

    from .ops.triangle import _to_numpy

    verts = _to_numpy(mesh.vertices)
    faces = _to_numpy(mesh.faces)
    if use_native and verts.dtype == np.float32:
        from .build.native import (
            build_sah_native,
            native_available,
            triangle_bounds_native,
        )

        if native_available():
            bmin, bmax, centers = triangle_bounds_native(verts, faces)
            return build_sah_native(bmin, bmax, centers, options)
    bmin, bmax, centers = triangle_prim_bounds(mesh)
    return build_sah(bmin, bmax, centers, options)
