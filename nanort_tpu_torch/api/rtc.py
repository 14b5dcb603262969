"""Embree-style front-end API (port of ``nanort_tpu.api.rtc``; reference
examples/embree-api/).

The reference ships an Embree-2 C API shim backed by NanoSG
(nanort-embree.cc:454-693). This is the same surface re-expressed as a
Python API over the scene graph, preserving the object model and call
sequence an Embree user expects:

  device = new_device()                       # rtcNewDevice
  scene = device.new_scene()                  # rtcDeviceNewScene
  gid = scene.new_triangle_mesh(n_tris, n_v)  # rtcNewTriangleMesh
  scene.map_buffer(gid, VERTEX)[:] = ...      # rtcMapBuffer/rtcUnmapBuffer
  scene.commit()                              # rtcCommit
  hits = scene.intersect(rays)                # rtcIntersect (batched!)
  occluded = scene.occluded(rays)             # rtcOccluded
  lo, hi = scene.bounds()                     # rtcGetBounds

Differences from the C shim, by design:
* intersect/occluded take Rays *batches* (the reference shim is
  explicitly single-ray and not thread-safe).
* geometry ids come from a free-list allocator like the reference's
  HandleAllocator (nanort-embree.cc:210-254).
* errors raise instead of accumulating an error string on the device
  (the reference stores them on the Context, nanort-embree.cc:430).

Where the work runs: ``new_device(config, device="cuda")`` carries a
torch device, and every scene of it commits its tables there and takes
rays there. ``commit(fast=None)`` builds the fast tables when that
device is the card (the JAX package: when its backend is not the CPU);
``intersect`` and ``occluded`` then sort the rays and run the packet
traversal kernel (K1) in closest-hit or any-hit mode, one launch a call;
on the CPU the same call runs the kernel's plain version. Without the
fast tables they walk the scene graph. Ids are int64 holding the JAX
package's uint32 values (0xFFFFFFFF for a miss).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..core.math import cross, normalize
from ..core.options import BVHBuildOptions, BVHTraceOptions, INVALID_PRIM_ID
from ..core.ray import Rays
from ..ops.triangle import TriangleMesh
from ..scene import matrix as mat
from ..scene.graph import Node, Scene as _SG, SceneHits
from ..utils import trace

# The fast route's largest world-space mesh (JAX rtc.py:128)
FAST_MAX_TRIS = 1 << 24


class BufferType(enum.Enum):
    """Subset of RTCBufferType the reference shim supports
    (rtcMapBuffer, nanort-embree.cc:598-634)."""

    VERTEX = 0
    INDEX = 1


class _Geometry:
    def __init__(self, num_triangles: int, num_vertices: int):
        # Embree uses 16-byte vertex strides (nanort-embree.cc:149-154);
        # here buffers are plain (n, 3) arrays
        self.vertices = np.zeros((num_vertices, 3), np.float32)
        self.indices = np.zeros((num_triangles, 3), np.int32)
        self.xform = mat.identity()
        self.enabled = True


class RTCScene:
    def __init__(self, device: "RTCDevice"):
        self._device = device
        self._geoms: dict[int, _Geometry] = {}
        self._free_ids: list[int] = []
        self._next_id = 0
        self._sg: _SG | None = None
        self._scene8 = None
        self._flat_pack = None
        self._committed = False

    # -- geometry management (rtcNewTriangleMesh, rtcDeleteGeometry) --
    def new_triangle_mesh(self, num_triangles: int, num_vertices: int) -> int:
        gid = self._free_ids.pop() if self._free_ids else self._next_id
        if gid == self._next_id:
            self._next_id += 1
        self._geoms[gid] = _Geometry(num_triangles, num_vertices)
        self._committed = False
        return gid

    def delete_geometry(self, geom_id: int):
        del self._geoms[geom_id]
        self._free_ids.append(geom_id)
        self._committed = False

    def map_buffer(self, geom_id: int, kind: BufferType) -> np.ndarray:
        """Returns the writable host buffer (map/unmap collapse into one
        call; the reference's rtcUnmapBuffer is a no-op too)."""
        g = self._geoms[geom_id]
        self._committed = False
        return g.vertices if kind == BufferType.VERTEX else g.indices

    def set_transform(self, geom_id: int, xform):
        """rtcSetTransform2 (a stub in the reference shim; functional
        here via the scene graph)."""
        self._geoms[geom_id].xform = np.asarray(xform, np.float64)
        self._committed = False

    # -- commit & query --
    @trace.span("rtc.commit")
    def commit(
        self,
        options: BVHBuildOptions = BVHBuildOptions(),
        fast: bool | None = None,
    ):
        """rtcCommit -> Scene::Commit (nanort-embree.cc:688-693).

        ``fast`` additionally bakes every geometry's transform into one
        world-space mesh of at most ``FAST_MAX_TRIS`` triangles, builds
        one BVH8 over it and puts its tables on the device, so that
        ``intersect`` and ``occluded`` run the packet traversal. Default
        (None): on when the device is the card."""
        if not self._geoms:
            raise ValueError("rtcCommit on empty scene")
        dev = self._device.device
        with trace.span("commit.graph"):
            sg = _SG(device=dev)
            self._node_of = {}
            for gid in sorted(self._geoms):
                g = self._geoms[gid]
                mesh = TriangleMesh(vertices=g.vertices.copy(),
                                    faces=g.indices.copy())
                sg.add_node(Node(f"geom{gid}", mesh, g.xform))
                self._node_of[len(self._node_of)] = gid
            sg.commit(options)
        self._sg = sg
        self._scene8 = None
        self._flat_pack = None
        if fast is None:
            fast = dev.type == "cuda"
        total_tris = sum(len(g.indices) for g in self._geoms.values())
        if fast and 0 < total_tris <= FAST_MAX_TRIS:
            from .. import build_triangle_bvh
            from ..build.bvh8 import collapse_bvh8

            # flatten all geometries into one world-space mesh, baking
            # each geometry's transform into its vertices: one BVH over
            # the transformed union is the committed scene
            with trace.span("commit.flatten"):
                v_parts, f_parts, v_off = [], [], 0
                for gid in sorted(self._geoms):
                    g = self._geoms[gid]
                    vg = np.asarray(g.vertices, np.float32)
                    x = np.asarray(g.xform, np.float32)
                    if not np.allclose(x, mat.identity()):
                        vg = vg @ x[:3, :3].T + x[:3, 3]
                    v_parts.append(vg)
                    f_parts.append(np.asarray(g.indices, np.int64) + v_off)
                    v_off += len(g.vertices)
                flat_v = np.concatenate(v_parts)
                flat_f = np.concatenate(f_parts)
                # flat-prim-id -> (geom id, local prim) remap tables + the
                # world-space mesh, for the fast closest-hit path
                gids = sorted(self._geoms)
                tri_counts = [len(self._geoms[g].indices) for g in gids]
                offs = np.zeros(len(gids), np.int64)
                np.cumsum(tri_counts[:-1], out=offs[1:])
            opt8 = BVHBuildOptions(
                min_leaf_primitives=8, max_leaf_primitives=8
            )
            bvh8_src, _ = build_triangle_bvh(TriangleMesh(flat_v, flat_f),
                                             opt8)
            self._scene8 = collapse_bvh8(bvh8_src, flat_v, flat_f).to(dev)
            with trace.span("build.upload"):
                self._flat_pack = tuple(
                    torch.from_numpy(x).to(dev) for x in (
                        flat_v, flat_f, offs, np.asarray(gids, np.int64)))
        self._committed = True

    def bounds(self):
        """rtcGetBounds (nanort-embree.cc:471-498)."""
        self._check()
        return self._sg.bounding_box()

    @trace.span("rtc.intersect")
    def intersect(self, rays: Rays, cull_back_face: bool = False):
        """rtcIntersect over a ray batch. Returns a SceneHits whose
        node_id holds geometry ids.

        With the fast tables, closest-hit runs through the ray sort and
        the packet traversal over the world-space mesh (the reference's
        rtcIntersect walks the two-level NanoSG scene, nanort-embree.cc:
        515-554; with transforms baked at commit, t/u/v may differ at
        ulp level from that local-space walk)."""
        self._check()
        opt = BVHTraceOptions(cull_back_face=cull_back_face)
        if self._scene8 is not None:
            return self._intersect_fast(rays, opt)
        hits = self._sg.traverse(rays, opt)
        # remap instance index -> geometry id
        lut = np.full(max(self._node_of) + 2, INVALID_PRIM_ID, np.int64)
        for inst, gid in self._node_of.items():
            lut[inst] = gid
        lut = torch.from_numpy(lut).to(hits.node_id.device)
        geom = lut[torch.clamp(hits.node_id, max=len(lut) - 1)]
        geom = torch.where(hits.hit, geom, INVALID_PRIM_ID)
        return hits._replace(node_id=geom)

    def _intersect_fast(self, rays: Rays, opt: BVHTraceOptions):
        from ..traverse.ray_sort import traverse_bvh8_sorted

        h = traverse_bvh8_sorted(self._scene8, rays, opt)
        with trace.span("rtc.remap"):
            flat_v, flat_f, offs, gid_arr = self._flat_pack
            hit = h.prim_id != INVALID_PRIM_ID
            pid = torch.where(hit, h.prim_id, 0)
            gi = torch.searchsorted(offs, pid, right=True) - 1
            geom = torch.where(hit, gid_arr[gi], INVALID_PRIM_ID)
            local = torch.where(hit, pid - offs[gi], INVALID_PRIM_ID)
            pos = rays.org + h.t[..., None] * rays.dir
            tri = flat_v[flat_f[pid]]
            ng = normalize(cross(tri[..., 1, :] - tri[..., 0, :],
                                 tri[..., 2, :] - tri[..., 0, :]))
            h3 = hit[..., None]
            zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
            return SceneHits(
                t=h.t,
                u=h.u,
                v=h.v,
                prim_id=local,
                node_id=geom,
                position=torch.where(h3, pos, zero),
                normal_g=torch.where(h3, ng, zero),
                normal_s=torch.where(h3, ng, zero),
            )

    @trace.span("rtc.occluded")
    def occluded(self, rays: Rays) -> torch.Tensor:
        """rtcOccluded: boolean any-hit per ray. With the fast tables, the
        packet traversal's occlusion mode (rays end at their first
        hit)."""
        self._check()
        if self._scene8 is not None:
            from ..traverse.ray_sort import traverse_bvh8_sorted

            return traverse_bvh8_sorted(
                self._scene8, rays, occlusion=True
            ).hit
        return self._sg.traverse(rays).hit

    def _check(self):
        if not self._committed:
            raise RuntimeError("scene not committed (call commit())")


class RTCDevice:
    """rtcNewDevice; owns scenes (nanort-embree.cc:146-207). ``device``:
    the torch device its scenes commit to and trace on."""

    def __init__(self, config: str | None = None, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self._scenes: list[RTCScene] = []

    def new_scene(self) -> RTCScene:
        s = RTCScene(self)
        self._scenes.append(s)
        return s


def new_device(config: str | None = None, device="cuda") -> RTCDevice:
    """rtcNewDevice on ``device`` (the card unless the caller asks for
    another device)."""
    return RTCDevice(config, device)
