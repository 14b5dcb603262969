"""Peaks, operation counts and the least time of a kernel's work.

A frozen copy of ``chip_smoke.py:271-282`` (the card's peaks and the
operations of one unit of work) and ``:365-370`` (``bound``). The counts
below are taken from the cell's inputs alone, by the benchmark's own
code, never from the program's tables, counters or plain versions, so a
share reads the same work whatever implements the kernel. Bytes bind in
every cell of this benchmark, so each share is a floor: the kernel also
reads tree nodes and leaf rows that no input fixes.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at 700 W: HBM bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations of one child's slab test, and of one path vertex's
# shading (fresnel, lobe pick, light sample, basis, next direction)
SLAB_OPS = 22
SHADE_OPS = 200

# bytes a ray reads (origin, direction, min_t, max_t) and a closest-hit
# record writes (t, u, v, prim id)
RAY_BYTES = 32
RECORD_BYTES = 16


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds the card could take, "bytes" or "operations")."""
    t_b = n_bytes / HBM_BYTES_S
    t_o = n_ops / F32_OPS_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def mesh_bytes(n_vertices: int, n_faces: int) -> int:
    """float32 vertices and int32 faces, read once."""
    return n_vertices * 12 + n_faces * 12


def k1_work(n_rays: int, n_vertices: int, n_faces: int) -> tuple[int, int]:
    """(bytes, operations) of one K1 launch over ``n_rays`` rays: each ray
    read and its record written, the mesh once, one root box test a
    ray."""
    return (n_rays * (RAY_BYTES + RECORD_BYTES)
            + mesh_bytes(n_vertices, n_faces), n_rays * SLAB_OPS)


def k4_work(n_pixels: int, spp: int, primary_hits: int, n_vertices: int,
            n_faces: int, n_materials: int) -> tuple[int, int]:
    """(bytes, operations) of one path-traced render: camera rays in (24
    bytes), the float32 image out (12 bytes a pixel), the mesh and the
    14-float material rows once; a root box test a sample, plus one path
    vertex's shading a sample whose camera ray hits."""
    n_bytes = (n_pixels * (24 + 12) + mesh_bytes(n_vertices, n_faces)
               + n_materials * 14 * 4)
    return n_bytes, n_pixels * spp * SLAB_OPS + primary_hits * spp * SHADE_OPS
