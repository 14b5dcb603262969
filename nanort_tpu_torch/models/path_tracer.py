"""Path tracer (port of the fused route of
``nanort_tpu.models.path_tracer``; reference examples/path_tracer/
main.cc:785-1009).

``make_pt_scene`` assembles a ``PTScene`` on the host — BVH, packed
tables, per-face shading table, per-light table and, with
``engine="pallas"``, the BVH16 tables and their aux rows — and moves it
to ``device``. ``render_path_traced`` routes it to one of the two fused
megakernels (``models/pt_fused.py``): the brute sweep K3 for scenes of
at most 256 triangles, the BVH16 megakernel K4 for scenes with BVH16
tables.

Not ported yet (ROADMAP.md, Queue 1): the per-bounce megabatch route
(``trace_paths``, which needs ``wavefront.py``, ``ray_sort.py`` and
``stack.py``), its ``_rows_by_id`` / ``_auto_spp_batch`` helpers, and
``engine="turbo"`` (K1-woop). ``fused=False``, a scene that neither
fused route takes, and ``engine="turbo"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ray import Rays
from ..ops.triangle import TriangleMesh
from ..traverse.packed import PackedScene

# Scenes at or below this many triangles build no BVH16 tables (the TPU
# package traces them brute force)
BRUTE_MAX_TRIS = 512
# Larger scenes get no face/light tables (their F x 26 floats), as in
# the JAX package; the fused routes then do not take them
FACE_TABLE_MAX_TRIS = 4_000_000

_NOT_PORTED = ("the per-bounce megabatch route (trace_paths) is not ported "
               "yet: ROADMAP.md, Queue 1, 'C.2 megabatch route'")


class Materials(NamedTuple):
    """Per-material tensors (tinyobj material_t fields the shader reads)."""

    diffuse: torch.Tensor  # (M, 3)
    emission: torch.Tensor  # (M, 3)
    specular: torch.Tensor  # (M, 3)
    transmittance: torch.Tensor  # (M, 3)
    ior: torch.Tensor  # (M,)
    dissolve: torch.Tensor  # (M,)


class PTScene(NamedTuple):
    """A path-tracer scene; every tensor lies on one device (``to``)."""

    mesh: TriangleMesh
    packed: PackedScene
    materials: Materials
    material_ids: torch.Tensor  # (F,) int32
    facevarying_normals: torch.Tensor | None  # (F, 3, 3)
    light_faces: torch.Tensor  # (L,) int32 emissive face ids
    # BVH16 tables (build.bvh8.BVH8Scene, width 16) for the BVH route
    scene8: object | None = None
    # per-face shading table (F, 17|26): [gnormal 3 | diffuse 3 |
    # emission 3 | specular 3 | transmittance 3 | ior | dissolve
    # (| vertex normals 9)]
    face_table: torch.Tensor | None = None
    # per-light-face table (L, 16): [v0 3 | v1 3 | v2 3 | unit normal 3 |
    # area | emission 3]
    light_table: torch.Tensor | None = None
    # per-leaf-row aux table (traverse/fused_trace.build_aux_rows)
    fused_aux: torch.Tensor | None = None

    def to(self, device) -> "PTScene":
        """Copy of the scene with every table on ``device``."""
        def mv(x):
            return None if x is None else x.to(device).contiguous()

        return PTScene(
            mesh=TriangleMesh(mv(self.mesh.vertices), mv(self.mesh.faces)),
            packed=PackedScene(mv(self.packed.nodes), mv(self.packed.soup),
                               self.packed.num_nodes, self.packed.num_prims,
                               self.packed.max_leaf),
            materials=Materials(*(mv(x) for x in self.materials)),
            material_ids=mv(self.material_ids),
            facevarying_normals=mv(self.facevarying_normals),
            light_faces=mv(self.light_faces),
            scene8=None if self.scene8 is None else self.scene8.to(device),
            face_table=mv(self.face_table),
            light_table=mv(self.light_table),
            fused_aux=mv(self.fused_aux),
        )


def collect_light_faces(material_ids, materials) -> np.ndarray:
    """Emissive-face collection (MeshLight ctor, main.cc:323-334)."""
    em = np.asarray(materials.emission)
    mid = np.asarray(material_ids)
    return np.nonzero((em[mid] > 0.0).any(axis=-1))[0].astype(np.int32)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-30)`` over the last axis, as the JAX package
    computes it on the host (``torch.linalg.norm`` matches
    ``jnp.linalg.norm`` there)."""
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.maximum(n, torch.tensor(1e-30))


def make_pt_scene(vertices, faces, material_ids, materials: dict,
                  facevarying_normals=None, engine: str = "wavefront",
                  device="cpu") -> PTScene:
    """Assemble a PTScene from host arrays and move it to ``device``.

    ``engine="pallas"`` also builds the BVH16 tables (leaf size 8) and
    their aux rows, the BVH route's input (scenes of more than
    ``BRUTE_MAX_TRIS`` triangles; smaller ones need none). The host
    tables are built on the CPU with the JAX package's operations
    (``torch.linalg.cross`` / ``torch.linalg.norm`` match ``jnp.cross`` /
    ``jnp.linalg.norm`` there bit for bit) and then moved."""
    from .. import build_triangle_bvh
    from ..build.bvh8 import collapse_bvh8
    from ..core.options import BVHBuildOptions
    from ..traverse.fused_trace import build_aux_rows
    from ..traverse.packed import pack_scene

    if engine == "turbo":
        raise NotImplementedError(
            "engine='turbo' needs the Woop leaf test (K1-woop), which is "
            "not ported yet: ROADMAP.md, Queue 1")
    if engine not in ("wavefront", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    v_np = np.asarray(vertices, np.float32)
    f_np = np.asarray(faces, np.int32)
    mid_np = np.asarray(material_ids, np.int32)
    n_faces = f_np.shape[0]
    if n_faces <= BRUTE_MAX_TRIS:
        engine = "wavefront"
    mesh_np = TriangleMesh(v_np, f_np)
    if engine == "pallas":
        bvh, _ = build_triangle_bvh(mesh_np, BVHBuildOptions(
            min_leaf_primitives=8, max_leaf_primitives=8))
    else:
        bvh, _ = build_triangle_bvh(mesh_np)
    packed = pack_scene(bvh, v_np, f_np)
    mats = Materials(*(torch.as_tensor(np.asarray(materials[k], np.float32))
                       for k in Materials._fields))
    lf = collect_light_faces(mid_np, mats)

    # ---- per-face shading table + per-light table (see PTScene) ----
    v = torch.from_numpy(v_np)
    f = torch.from_numpy(f_np).long()
    mid = torch.from_numpy(mid_np).long()
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    gn_unit = _unit(torch.linalg.cross(v1 - v0, v2 - v0))
    fvn = (torch.as_tensor(np.asarray(facevarying_normals, np.float32))
           if facevarying_normals is not None else None)
    face_table = light_table = None
    if n_faces <= FACE_TABLE_MAX_TRIS:
        cols = [gn_unit, mats.diffuse[mid], mats.emission[mid],
                mats.specular[mid], mats.transmittance[mid],
                mats.ior[mid][:, None], mats.dissolve[mid][:, None]]
        if fvn is not None:
            cols.append(fvn.reshape(n_faces, 9))
        face_table = torch.cat(cols, 1)
        lfi = torch.from_numpy(lf).long()
        lv0, lv1, lv2 = v0[lfi], v1[lfi], v2[lfi]
        lcr = torch.linalg.cross(lv1 - lv0, lv2 - lv0)
        larea = 0.5 * torch.linalg.norm(lcr, dim=-1)
        light_table = torch.cat([lv0, lv1, lv2, _unit(lcr), larea[:, None],
                                 mats.emission[mid[lfi]]], 1)

    scene8 = fused_aux = None
    if engine == "pallas":
        # width 16: dense single-row nodes, the layout K4 walks
        scene8 = collapse_bvh8(bvh, v_np, f_np, width=16)
        if fvn is None:
            # gn_unit is face_table column 0: the BVH route reads
            # bit-identical normals to the brute route
            fused_aux = torch.from_numpy(build_aux_rows(
                scene8.leafs, mid_np, f_np, v_np, scene8.max_leaf,
                gn_unit=gn_unit.numpy()))

    scene = PTScene(
        mesh=TriangleMesh(v, torch.from_numpy(f_np)),
        packed=PackedScene(torch.from_numpy(packed.nodes),
                           torch.from_numpy(packed.soup), packed.num_nodes,
                           packed.num_prims, packed.max_leaf),
        materials=mats,
        material_ids=torch.from_numpy(mid_np),
        facevarying_normals=fvn,
        light_faces=torch.from_numpy(lf),
        scene8=scene8,
        face_table=face_table,
        light_table=light_table,
        fused_aux=fused_aux,
    )
    return scene.to(device)


def default_azimuth_strata(spp: int) -> int:
    """The first of 4, 8, 5, 3, 2, 1 that divides spp."""
    return next(n for n in (4, 8, 5, 3, 2, 1) if spp % n == 0)


def default_spp_lanes(spp: int, azimuth_strata: int) -> int:
    """Sample-major lanes of the BVH route: the largest K that divides
    spp and keeps the per-iteration wedge cycle covering every stratum
    ((spp // K) % azimuth_strata == 0); 25 at spp=100 with 4 strata."""
    return next((k for k in (25, 20, 16, 10, 8, 5, 4, 2)
                 if spp % k == 0 and (spp // k) % azimuth_strata == 0), 1)


def render_path_traced(scene: PTScene, cam_rays: Rays, seed: int,
                       spp: int = 8, max_bounces: int = 10,
                       fused: bool | None = None,
                       azimuth_strata: int | None = None,
                       spp_lanes: int | None = None) -> torch.Tensor:
    """Accumulate spp samples per camera ray; returns linear RGB with the
    camera-ray batch shape + (3,) (the reference's SPP loop,
    main.cc:806-980; gamma is applied at save time).

    ``seed`` is the int the JAX package derives from its key
    (``pt_fused._seed_from_key``: ``PRNGKey(3)`` gives 3); for the same
    seed both packages draw the same random numbers. ``fused=None`` or
    ``True`` takes the fused route: K3 when ``fused_eligible(scene)``,
    else K4 when ``fused_bvh_eligible(scene)``. The K4 route reorders an
    (H, W) image with H % 32 == 0 and W % 128 == 0 into 32 x 128 pixel
    tiles and defaults ``spp_lanes`` to ``default_spp_lanes``; both
    decide which random numbers each sample draws, as on the TPU.
    ``azimuth_strata`` defaults to ``default_azimuth_strata(spp)``."""
    from .pt_fused import (fused_bvh_eligible, fused_eligible, render_fused,
                           render_fused_bvh)

    if fused is False:
        raise NotImplementedError(_NOT_PORTED)
    if azimuth_strata is None:
        azimuth_strata = default_azimuth_strata(spp)
    bs = cam_rays.batch_shape
    org = cam_rays.org.reshape(-1, 3)
    d = cam_rays.dir.reshape(-1, 3)
    if fused_eligible(scene):
        img = render_fused(scene, org, d, seed, spp, max_bounces=max_bounces,
                           azimuth_strata=azimuth_strata)
        return img.reshape(*bs, 3)
    if not fused_bvh_eligible(scene):
        raise NotImplementedError(
            "neither fused route takes this scene (more than "
            "PT_FUSED_MAX_TRIS triangles and no BVH16 tables, or "
            f"facevarying normals); {_NOT_PORTED}")
    # 32 x 128 pixel tiles: a block of lanes covers a compact frustum
    sub_b = 32
    perm = None
    if len(bs) == 2 and bs[0] % sub_b == 0 and bs[1] % 128 == 0:
        H, W = bs
        perm = torch.arange(H * W, device=org.device).reshape(
            H // sub_b, sub_b, W // 128, 128).transpose(1, 2).reshape(-1)
        org, d = org[perm], d[perm]
    if spp_lanes is None:
        spp_lanes = default_spp_lanes(spp, azimuth_strata)
    img = render_fused_bvh(scene, org, d, seed, spp, max_bounces=max_bounces,
                           azimuth_strata=azimuth_strata,
                           spp_lanes=spp_lanes)
    if perm is not None:
        img = torch.zeros_like(img).index_copy_(0, perm, img)
    return img.reshape(*bs, 3)
