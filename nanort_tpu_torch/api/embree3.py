"""Embree-3 style entry points (port of ``nanort_tpu.api.embree3``: the
function-per-call naming layer).

The reference ships an embree3 *client* example (examples/embree3-api/
main.cc: rtcNewDevice/rtcNewGeometry/rtcSetNewGeometryBuffer/
rtcAttachGeometry/rtcCommitScene/rtcIntersect1 with RTCRayHit) whose
nanort-backed shim source is referenced from its Makefile but absent —
aspirational in the reference (SURVEY.md §2.3). This module provides the
working equivalent over the batched rtc core (api/rtc.py): the embree3
call sequence and record layout, with ray *batches* where embree3 has
single rays (rtcIntersect1 accepts and returns batches; a batch of one
reproduces the classic call). ``rtc_new_device(config, device="cuda")``
carries the torch device of the rtc core; ids are int64 holding the
JAX package's uint32 values.

    device = rtc_new_device()
    scene = rtc_new_scene(device)
    geom = rtc_new_geometry(device, GeometryType.TRIANGLE)
    rtc_set_new_geometry_buffer(geom, BufferType3.VERTEX, n_vertices)[:] = V
    rtc_set_new_geometry_buffer(geom, BufferType3.INDEX, n_faces)[:] = F
    rtc_commit_geometry(geom)
    gid = rtc_attach_geometry(scene, geom)
    rtc_release_geometry(geom)
    rtc_commit_scene(scene)
    rayhit = rtc_intersect1(scene, rays)   # RTCRayHit-shaped record
    occ = rtc_occluded1(scene, rays)       # tfar = -inf where occluded
    bounds = rtc_get_scene_bounds(scene)
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from ..core.options import INVALID_PRIM_ID
from ..core.ray import Rays
from .rtc import BufferType, RTCScene, new_device as _new_device

RTC_INVALID_GEOMETRY_ID = INVALID_PRIM_ID  # 0xFFFFFFFF, rtcore_common


class GeometryType(enum.Enum):
    TRIANGLE = 0  # RTC_GEOMETRY_TYPE_TRIANGLE


class BufferType3(enum.Enum):
    VERTEX = 0  # RTC_BUFFER_TYPE_VERTEX
    INDEX = 1  # RTC_BUFFER_TYPE_INDEX


class RTCRayHit(NamedTuple):
    """Batched RTCRayHit: ray fields + hit fields (rtcore_ray.h layout,
    SoA over the batch)."""

    # ray
    org: torch.Tensor  # (..., 3)
    dir: torch.Tensor  # (..., 3)
    tnear: torch.Tensor  # (...,)
    tfar: torch.Tensor  # (...,)  on return: hit distance, or input tfar on miss
    # hit
    Ng: torch.Tensor  # (..., 3) geometric normal (unnormalized, like embree)
    u: torch.Tensor  # (...,)
    v: torch.Tensor  # (...,)
    prim_id: torch.Tensor  # (...,) int64, RTC_INVALID_GEOMETRY_ID on miss
    geom_id: torch.Tensor  # (...,) int64, RTC_INVALID_GEOMETRY_ID on miss

    @property
    def hit(self):
        return self.geom_id != RTC_INVALID_GEOMETRY_ID


class _Geom3:
    """Standalone geometry object (embree3 decouples geometry creation
    from scene attachment; the rtc core keys buffers by geometry id)."""

    def __init__(self, gtype: GeometryType):
        if gtype != GeometryType.TRIANGLE:
            raise ValueError("only RTC_GEOMETRY_TYPE_TRIANGLE is supported")
        self.vertices: np.ndarray | None = None
        self.indices: np.ndarray | None = None
        self.committed = False


def rtc_new_device(config: str | None = None, device="cuda"):
    return _new_device(config, device)


def rtc_new_scene(device) -> RTCScene:
    return device.new_scene()


def rtc_new_geometry(device, gtype: GeometryType) -> _Geom3:
    return _Geom3(gtype)


def rtc_set_new_geometry_buffer(
    geom: _Geom3, kind: BufferType3, count: int
) -> np.ndarray:
    """rtcSetNewGeometryBuffer: allocates and returns the writable host
    buffer ((count, 3) float32 vertices / int32 indices)."""
    if kind == BufferType3.VERTEX:
        geom.vertices = np.zeros((count, 3), np.float32)
        return geom.vertices
    geom.indices = np.zeros((count, 3), np.int32)
    return geom.indices


def rtc_commit_geometry(geom: _Geom3):
    if geom.vertices is None or geom.indices is None:
        raise ValueError("geometry buffers not set (rtcSetNewGeometryBuffer)")
    geom.committed = True


def rtc_attach_geometry(scene: RTCScene, geom: _Geom3) -> int:
    """rtcAttachGeometry: copies the committed buffers into the scene and
    returns the geometry id."""
    if not geom.committed:
        raise ValueError("call rtc_commit_geometry first")
    gid = scene.new_triangle_mesh(len(geom.indices), len(geom.vertices))
    scene.map_buffer(gid, BufferType.VERTEX)[:] = geom.vertices
    scene.map_buffer(gid, BufferType.INDEX)[:] = geom.indices
    return gid


def rtc_release_geometry(geom: _Geom3):
    geom.vertices = None
    geom.indices = None


def rtc_commit_scene(scene: RTCScene):
    scene.commit()


def rtc_get_scene_bounds(scene: RTCScene):
    """RTCBounds as ((lower_x, lower_y, lower_z), (upper_x, ...))."""
    return scene.bounds()


def rtc_intersect1(scene: RTCScene, rays: Rays) -> RTCRayHit:
    """rtcIntersect1 over a ray batch: nearest hit per ray, RTCRayHit
    semantics (tfar overwritten with the hit distance; geomID/primID
    RTC_INVALID_GEOMETRY_ID on miss; Ng is the unnormalized geometric
    normal, embree convention)."""
    hits = scene.intersect(rays)
    h = hits.hit
    tfar = torch.where(h, hits.t, rays.max_t)
    # scene.intersect returns normalized world normals; scale doesn't
    # matter to embree clients (they normalize), direction does
    return RTCRayHit(
        org=rays.org,
        dir=rays.dir,
        tnear=rays.min_t,
        tfar=tfar,
        Ng=hits.normal_g,
        u=hits.u,
        v=hits.v,
        prim_id=hits.prim_id,
        geom_id=hits.node_id,
    )


def rtc_occluded1(scene: RTCScene, rays: Rays) -> torch.Tensor:
    """rtcOccluded1 over a batch: returns tfar per ray, -inf where an
    intersection exists in [tnear, tfar] (embree3 convention)."""
    occ = scene.occluded(rays)
    return torch.where(occ, float("-inf"), rays.max_t)
