"""Path tracer (port of ``nanort_tpu.models.path_tracer``; reference
examples/path_tracer/main.cc:785-1009).

``make_pt_scene`` assembles a ``PTScene`` on the host — BVH, packed
tables, per-face shading table, per-light table and, with
``engine="pallas"`` or ``"turbo"``, the BVH16 tables (turbo: leaf 9 and
the Woop table) and their aux rows — and moves it to ``device``.
``render_path_traced`` takes one of two routes:

* the fused route (``models/pt_fused.py``): one megakernel launch per
  render, the brute sweep K3 for scenes of at most 256 triangles, the
  BVH16 megakernel K4 for scenes with BVH16 tables and aux rows;
* the per-bounce megabatch route (``fused=False``, and any scene neither
  fused kernel takes, e.g. one with vertex normals): ``trace_paths``
  advances spp x pixels samples through the bounce loop together, one
  closest-hit and one shadow trace a bounce through ``_trace`` (brute
  force, the wavefront walk, or K1 / K1-woop behind the ray sort), with
  the shading in plain torch.

Random numbers: the fused kernels carry their own counter-based
generator (ported bit for bit). The megabatch route draws each bounce's
``(R, 6)`` uniforms from a ``torch.Generator`` on the scene's device in
place of the JAX package's threefry keys; ``trace_paths`` also takes
pre-drawn ``draws``, so a test can hand it the JAX package's numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ray import Hits, Rays
from ..ops.triangle import TriangleMesh
from ..traverse.packed import PackedScene
from ..utils import trace
from .pt_fused import _div, _f, _max, _sqrt

# Scenes at or below this many triangles build no BVH16 tables and trace
# brute force on the megabatch route: one sweep over all prims costs no
# ray sort
BRUTE_MAX_TRIS = 512
# Larger scenes get no face/light tables (their F x 26 floats), as in
# the JAX package; the fused routes then do not take them
FACE_TABLE_MAX_TRIS = 4_000_000
ENGINES = ("wavefront", "pallas", "turbo")


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

    @trace.span("build.upload")
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
                  device="cuda") -> PTScene:
    """Assemble a PTScene from host arrays and move it to ``device`` (the
    card unless the caller asks for another device).

    ``engine="pallas"`` also builds the BVH16 tables (leaf size 8), and
    ``engine="turbo"`` the BVH16 tables at leaf size 9 with their Woop
    table (``leafs_woop``), so every megabatch trace takes K1-woop. Both
    attach the aux rows that K4 needs when the scene has no vertex
    normals. Scenes of at most ``BRUTE_MAX_TRIS`` triangles need none of
    it and take the wavefront engine's tables. The host tables are built
    on the CPU with the JAX package's operations (``torch.linalg.cross`` /
    ``torch.linalg.norm`` match ``jnp.cross`` / ``jnp.linalg.norm`` there
    bit for bit) and then moved."""
    from .. import build_triangle_bvh
    from ..build.bvh8 import collapse_bvh8
    from ..core.options import BVHBuildOptions
    from ..traverse.fused_trace import build_aux_rows
    from ..traverse.packed import pack_scene

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    v_np = np.asarray(vertices, np.float32)
    f_np = np.asarray(faces, np.int32)
    mid_np = np.asarray(material_ids, np.int32)
    n_faces = f_np.shape[0]
    if n_faces <= BRUTE_MAX_TRIS:
        engine = "wavefront"
    mesh_np = TriangleMesh(v_np, f_np)
    if engine != "wavefront":
        leaf = 9 if engine == "turbo" else 8
        bvh, _ = build_triangle_bvh(mesh_np, BVHBuildOptions(
            min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    else:
        bvh, _ = build_triangle_bvh(mesh_np)
    with trace.span("build.aux"):
        packed = pack_scene(bvh, v_np, f_np)
        mats = Materials(*(torch.as_tensor(np.asarray(materials[k],
                                                      np.float32))
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
            light_table = torch.cat([lv0, lv1, lv2, _unit(lcr),
                                     larea[:, None],
                                     mats.emission[mid[lfi]]], 1)

    scene8 = fused_aux = None
    if engine != "wavefront":
        # width 16: dense single-row nodes, the layout K4 walks
        scene8 = collapse_bvh8(bvh, v_np, f_np, width=16,
                               woop=engine == "turbo")
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


# ------------------------------------------------ megabatch route
#
# The shading below is the JAX package's trace_paths op for op, with the
# rounding of its jitted CPU run: every product and sum a separate op in
# the package's order (sums over xyz as (x + y) + z), true divisions
# except where XLA turns a division by a constant into a product with
# its reciprocal (``mean`` and ``/ pi``), and square roots correctly
# rounded (taken in float64: torch's CPU float32 sqrt is not). cos and
# sin are also taken in float64 and rounded once, the same on the CPU and
# the card; XLA's float32 cos/sin differ from that in the last ulp on
# ~1.3% of inputs, so a few paths take another direction.

_EPS_T = _f(0.001)
_RAY_EPS = _f(0.00001)
_FAR = _f(1.0e30)
_THIRD = _f(1.0 / 3.0)
_INV_PI = _f(1.0 / np.pi)
_TWO_PI = _f(2.0 * np.pi)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(a * b, -1)`` over xyz, as (x + y) + z."""
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


def _length(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(a, axis=-1)``, correctly rounded."""
    return _sqrt(_dot(a, a))


def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    """``a / max(|a|, 1e-30)`` row by row."""
    return a / _max(_length(a), _f(1e-30))[:, None]


def _luma(c: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(c, -1)`` as jitted XLA computes it: sum * f32(1/3)."""
    return (c[:, 0] + c[:, 1] + c[:, 2]) * _THIRD


def _reflect(i, n):
    return i - 2.0 * _dot(i, n)[:, None] * n


def _refract(i, n, eta):
    ndi = _dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    out = (eta[:, None] * i
           - (eta * ndi + _sqrt(_max(k, 0.0)))[:, None] * n)
    return torch.where((k < 0.0)[:, None], 0.0, out)


def _fresnel_schlick(h, n, r):
    r0 = r * r
    c = 1.0 - _dot(h, n)
    return r0 + (1.0 - r0) * c * c * c * c * c


def _revised_onb(n):
    """Revised ONB, both sign branches by select (main.cc:216-229)."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    a_neg = _div(1.0, 1.0 - z)
    a_pos = _div(1.0, 1.0 + z)
    b_neg = x * y * a_neg
    b_pos = -x * y * a_pos
    neg = (z < 0.0)[:, None]
    b1 = torch.where(neg, torch.stack([1.0 - x * x * a_neg, -b_neg, x], 1),
                     torch.stack([1.0 - x * x * a_pos, b_pos, -x], 1))
    b2 = torch.where(neg, torch.stack([b_neg, y * y * a_neg - 1.0, -y], 1),
                     torch.stack([b_pos, 1.0 - y * y * a_pos, -y], 1))
    return b1, b2


def _cosine_dir(n, u2):
    """Cosine-hemisphere direction about ``n`` from two uniforms."""
    u1 = u2[:, 0]
    phi = (u2[:, 1] * _TWO_PI).double()
    r = _sqrt(u1)
    x = r * torch.cos(phi).float()
    y = r * torch.sin(phi).float()
    z = _sqrt(1.0 - u1)
    b1, b2 = _revised_onb(n)
    return b1 * x[:, None] + b2 * y[:, None] + n * z[:, None]


def _rows_by_id(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``. The JAX package reads tables of at most 64 rows by
    a one-hot matmul, a TPU device that copies the rows exactly: the two
    give the same bits."""
    return table[idx]


def _sample_light(scene: PTScene, x, u2):
    """MeshLight::sampleDirect (main.cc:336-397) at points ``x`` (R, 3)
    with uniforms ``u2`` (R, 2). Returns (dir, dist, pdf, radiance)."""
    nl = int(scene.light_faces.shape[0])
    if nl == 0:
        # no emissive faces: NEE disabled via pdf = 0 everywhere
        z1 = torch.zeros_like(x[:, 0])
        return torch.zeros_like(x), z1, z1, torch.zeros_like(x)
    xi1, xi2 = u2[:, 0], u2[:, 1]
    fidx = torch.clamp((xi1 * nl).int(), max=nl - 1).long()
    xi1 = xi1 * nl - fidx.float()
    pick_pdf = _f(1.0 / nl)
    if scene.light_table is not None:
        rows = _rows_by_id(scene.light_table, fidx)
        v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        norm = rows[:, 9:12]
        area = rows[:, 12]
        ll = rows[:, 13:16]
    else:
        fid = scene.light_faces.long()[fidx]
        f = scene.mesh.faces.long()[fid]
        vv = scene.mesh.vertices
        v0, v1, v2 = vv[f[:, 0]], vv[f[:, 1]], vv[f[:, 2]]
        cr = torch.linalg.cross(v1 - v0, v2 - v0)
        area = 0.5 * _length(cr)
        norm = _unit_rows(cr)
        ll = scene.materials.emission[scene.material_ids.long()[fid]]
    s = _sqrt(xi1)
    c0 = (1.0 - s)[:, None]
    c1 = (s * (1.0 - xi2))[:, None]
    c2 = (s * xi2)[:, None]
    d = c0 * v0 + c1 * v1 + c2 * v2 - x
    dist = _length(d)
    ok = dist > _f(1e-6)
    dirn = d / _max(dist, _f(1e-30))[:, None]
    cos_l = _max(_dot(-dirn, norm), 0.0)
    radiance = ll * cos_l[:, None]
    area_pdf = _div(pick_pdf, _max(area, _f(1e-30)))
    pdf = torch.where(ok & (cos_l > _f(1e-12)),
                      area_pdf * dist * dist / _max(cos_l, _f(1e-30)), 0.0)
    return dirn, dist, pdf, radiance


def _trace(scene: PTScene, org, d, min_t, max_t, tile,
           occlusion=False) -> Hits:
    """One trace of the megabatch route. Scenes of at most
    ``BRUTE_MAX_TRIS`` triangles sweep brute force; scenes with BVH16
    tables take K1 through the ray sort (K1-woop when they carry the
    Woop table: Monte Carlo rendering tolerates its ulp-level deviations
    by construction); the rest walk the packed tables. The brute and
    wavefront engines answer an occlusion query with the closest hit."""
    from ..traverse.brute import brute_force_traverse
    from ..traverse.ray_sort import traverse_bvh8_sorted
    from ..traverse.wavefront import traverse_wavefront

    rays = Rays(org, d, min_t, max_t)
    if scene.mesh.faces.shape[0] <= BRUTE_MAX_TRIS:
        # bound the (R, chunk) intersection temporaries to ~64M elements
        chunk = int(min(512, max(4, (1 << 26) // max(org.shape[0], 1))))
        return brute_force_traverse(scene.mesh, rays, chunk_size=chunk)
    if scene.scene8 is not None:
        woop = scene.scene8.leafs_woop is not None
        return traverse_bvh8_sorted(
            scene.scene8, rays, occlusion=occlusion,
            intersector="woop" if woop else "watertight")
    return traverse_wavefront(scene.packed, rays, tile=tile)


def trace_paths(scene: PTScene, org0: torch.Tensor, dir0: torch.Tensor,
                generator: torch.Generator | None = None,
                max_bounces: int = 10, rr_start: int = 3, tile: int = 8192,
                has_normals: bool = True,
                draws: torch.Tensor | None = None) -> torch.Tensor:
    """Trace one sample per input ray (``org0``/``dir0`` (R, 3) on the
    scene's device); returns linear-RGB radiance (R, 3).

    Each bounce draws ``(R, 6)`` uniforms (columns: roulette, lobe pick,
    light xi1/xi2, cosine u1/phi) from ``generator``, a
    ``torch.Generator`` on the scene's device, or takes them from
    ``draws`` ``(max_bounces, R, 6)``. ``tile`` is the JAX signature's
    and changes nothing."""
    R = org0.shape[0]
    dev = org0.device
    if draws is not None:
        draws = torch.as_tensor(draws, dtype=torch.float32, device=dev)
        if tuple(draws.shape) != (max_bounces, R, 6):
            raise ValueError(f"draws must be (max_bounces, R, 6) = "
                             f"({max_bounces}, {R}, 6): {tuple(draws.shape)}")
    elif generator is None:
        raise ValueError("trace_paths needs a generator or draws")
    org = org0.float().contiguous()
    dir = dir0.float().contiguous()
    color = torch.zeros((R, 3), device=dev)
    weight = torch.ones((R, 3), device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    do_emission = torch.ones(R, dtype=torch.bool, device=dev)
    min_eps = torch.full((R,), _EPS_T, device=dev)
    min_ray_eps = torch.full((R,), _RAY_EPS, device=dev)
    use_normals = has_normals and scene.facevarying_normals is not None
    for b in range(max_bounces):
        U = draws[b] if draws is not None else torch.rand(
            (R, 6), generator=generator, device=dev)

        # Russian roulette (main.cc:828-838)
        rr_apply = b > rr_start
        if rr_apply:
            alive = alive & ~(U[:, 0] < _f(0.2))
            weight = weight * _f(1.0 / (1.0 - 0.2))

        hits = _trace(scene, org, dir, min_eps,
                      torch.where(alive, _FAR, 0.0), tile)
        hit = hits.hit & alive
        fid = torch.where(hit, hits.prim_id, 0)
        p = org + dir * hits.t[:, None]

        if scene.face_table is not None:
            # one row lookup for everything the shader reads
            # (PTScene.face_table layout)
            rows = _rows_by_id(scene.face_table, fid)
            if use_normals:
                nrm3 = rows[:, 17:26].reshape(-1, 3, 3)
                w0 = (1.0 - hits.u - hits.v)[:, None]
                norm = _unit_rows(w0 * nrm3[:, 0]
                                  + hits.u[:, None] * nrm3[:, 1]
                                  + hits.v[:, None] * nrm3[:, 2])
            else:
                norm = rows[:, 0:3]
            mat_d, mat_e = rows[:, 3:6], rows[:, 6:9]
            mat_s, mat_r = rows[:, 9:12], rows[:, 12:15]
            ior, dissolve = rows[:, 15], rows[:, 16]
        else:
            if use_normals:
                nrm3 = scene.facevarying_normals[fid]
                w0 = (1.0 - hits.u - hits.v)[:, None]
                norm = _unit_rows(w0 * nrm3[:, 0]
                                  + hits.u[:, None] * nrm3[:, 1]
                                  + hits.v[:, None] * nrm3[:, 2])
            else:
                f = scene.mesh.faces.long()[fid]
                vv = scene.mesh.vertices
                v0 = vv[f[:, 0]]
                norm = _unit_rows(torch.linalg.cross(vv[f[:, 1]] - v0,
                                                     vv[f[:, 2]] - v0))
            mid = scene.material_ids.long()[fid]
            m = scene.materials
            mat_d, mat_e = m.diffuse[mid], m.emission[mid]
            mat_s, mat_r = m.specular[mid], m.transmittance[mid]
            ior, dissolve = m.ior[mid], m.dissolve[mid]

        original_norm = norm
        facing = _dot(norm, dir) > 0
        norm = torch.where(facing[:, None], -norm, norm)

        inside = torch.where(_dot(dir, original_norm) < 0, -1.0, 1.0)
        n1 = torch.where(inside < 0, _div(1.0, ior), ior)
        n2 = _div(1.0, n1)
        fres = _fresnel_schlick(-dir, norm, (n1 - n2) / (n1 + n2))

        rho_s = _luma(mat_s) * fres
        rho_d = _luma(mat_d) * (1.0 - fres) * (1.0 - dissolve)
        rho_r = _luma(mat_r) * (1.0 - fres) * dissolve
        rho_e = _luma(mat_e)
        total = rho_s + rho_d + rho_r + rho_e
        absorbed = total < _f(1e-4)
        tot = torch.where(absorbed, 1.0, total)
        rho_s, rho_d, rho_r = rho_s / tot, rho_d / tot, rho_r / tot

        rand = U[:, 1]
        pick_s = rand < rho_s
        pick_d = ~pick_s & (rand < rho_s + rho_d)
        pick_r = ~pick_s & ~pick_d & (rand < rho_s + rho_d + rho_r)
        pick_e = ~pick_s & ~pick_d & ~pick_r

        # ---- NEE on the diffuse lobe (main.cc:938-957) ----
        ldir, ldist, lpdf, lrad = _sample_light(scene, p, U[:, 2:4])
        shadow_max = _max(ldist - _RAY_EPS, 0.0)
        nee_active = hit & pick_d & (lpdf > 0.0) & ~absorbed
        sh = _trace(scene, p, ldir.contiguous(), min_ray_eps,
                    torch.where(nee_active, shadow_max, 0.0), tile,
                    occlusion=True)
        visible = ~sh.hit
        del sh
        cos_t = torch.abs(_dot(ldir, norm))
        direct = mat_d * _INV_PI * lrad * (cos_t / _max(lpdf, _f(1e-30)))[:, None]
        color = color + torch.where((nee_active & visible)[:, None],
                                    direct * weight, 0.0)

        # ---- emission (main.cc:964-971) ----
        emit_gate = hit & pick_e & do_emission & ~absorbed
        cos_e = _max(_dot(original_norm, -dir), 0.0)
        color = color + torch.where(emit_gate[:, None],
                                    cos_e[:, None] * mat_e * weight, 0.0)

        # ---- next direction & weight ----
        out_s = _reflect(dir, norm)
        out_d = _cosine_dir(norm, U[:, 4:6])
        out_r = _refract(dir, -inside[:, None] * original_norm, n1)
        new_dir = torch.where(pick_s[:, None], out_s,
                              torch.where(pick_d[:, None], out_d, out_r))
        lobe_w = torch.where(pick_s[:, None], mat_s,
                             torch.where(pick_d[:, None], mat_d, mat_r))
        weight = weight * torch.where(hit[:, None], lobe_w, 1.0)

        alive = hit & ~pick_e & ~absorbed
        org = torch.where(hit[:, None], p, org)
        dir = torch.where(hit[:, None], new_dir, dir)
        do_emission = torch.where(hit, ~pick_d, do_emission)
    return color


def _auto_spp_batch(spp: int, n_rays: int, cap_rays: int = 8_388_608) -> int:
    """Largest divisor of spp whose megabatch stays under ~8M rays (equal
    megabatch shapes)."""
    best = 1
    for k in range(1, spp + 1):
        if spp % k == 0 and k * n_rays <= cap_rays:
            best = k
    return best


def render_megabatch(scene: PTScene, org: torch.Tensor, d: torch.Tensor,
                     seed: int, spp: int, max_bounces: int = 10,
                     spp_batch: int | None = None) -> torch.Tensor:
    """Radiance means (R, 3) of ``spp`` samples per ray (``org``/``d``
    (R, 3)) on the megabatch route: ``spp_batch`` samples x all rays
    advance through ``trace_paths`` together (default
    ``_auto_spp_batch``), with one generator on the scene's device
    seeded from ``seed``."""
    from .pt_fused import _seed32

    R = org.shape[0]
    dev = org.device
    if spp_batch is None:
        spp_batch = _auto_spp_batch(spp, R)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed32(seed))
    acc = torch.zeros((R, 3), device=dev)
    s = 0
    while s < spp:
        n = min(spp_batch, spp - s)
        col = trace_paths(
            scene, org.expand(n, R, 3).reshape(-1, 3),
            d.expand(n, R, 3).reshape(-1, 3), gen, max_bounces=max_bounces,
            has_normals=scene.facevarying_normals is not None)
        acc = acc + col.view(n, R, 3).sum(0)
        s += n
    return _div(acc, float(spp))

def default_azimuth_strata(spp: int) -> int:
    """The first of 4, 8, 5, 3, 2, 1 that divides spp."""
    return next(n for n in (4, 8, 5, 3, 2, 1) if spp % n == 0)


def default_spp_lanes(spp: int, azimuth_strata: int) -> int:
    """Sample-major lanes of the BVH route: the largest K that divides
    spp and keeps the per-iteration wedge cycle covering every stratum
    ((spp // K) % azimuth_strata == 0); 25 at spp=100 with 4 strata."""
    return next((k for k in (25, 20, 16, 10, 8, 5, 4, 2)
                 if spp % k == 0 and (spp // k) % azimuth_strata == 0), 1)


@trace.span("render_path_traced")
def render_path_traced(scene: PTScene, cam_rays: Rays, seed: int,
                       spp: int = 8, max_bounces: int = 10,
                       fused: bool | None = None,
                       azimuth_strata: int | None = None,
                       spp_lanes: int | None = None,
                       spp_batch: int | None = None) -> torch.Tensor:
    """Accumulate spp samples per camera ray; returns linear RGB with the
    camera-ray batch shape + (3,) (the reference's SPP loop,
    main.cc:806-980; gamma is applied at save time).

    Routes: ``fused=False`` takes the megabatch route
    (``render_megabatch``; ``spp_batch`` is its argument).
    ``fused=None`` takes the fused route when a fused kernel takes the
    scene (K3 when ``fused_eligible(scene)``, else K4 when
    ``fused_bvh_eligible(scene)``) and the megabatch route otherwise;
    ``fused=True`` insists on the fused route and raises when neither
    kernel takes the scene. (The JAX package's default is the fused route
    on a TPU only; on the card the fused kernels are the faster route.)

    ``seed`` is the int the JAX package derives from its key
    (``pt_fused._seed_from_key``: ``PRNGKey(3)`` gives 3); for the same
    seed both packages' fused routes draw the same random numbers; the
    megabatch route seeds a ``torch.Generator`` with it. The K4 route
    reorders an (H, W) image with H % 32 == 0 and W % 128 == 0 into
    32 x 128 pixel tiles and defaults ``spp_lanes`` to
    ``default_spp_lanes``; both decide which random numbers each sample
    draws, as on the TPU. ``azimuth_strata`` (fused route) defaults to
    ``default_azimuth_strata(spp)``."""
    from .pt_fused import (fused_bvh_eligible, fused_eligible, render_fused,
                           render_fused_bvh)

    bs = cam_rays.batch_shape
    org = cam_rays.org.reshape(-1, 3)
    d = cam_rays.dir.reshape(-1, 3)
    brute, bvh = fused_eligible(scene), fused_bvh_eligible(scene)
    if fused is True and not (brute or bvh):
        raise ValueError("neither fused kernel takes this scene (more than "
                         "PT_FUSED_MAX_TRIS triangles and no BVH16 tables "
                         "with aux rows, or facevarying normals)")
    if fused is False or not (brute or bvh):
        img = render_megabatch(scene, org, d, seed, spp,
                               max_bounces=max_bounces, spp_batch=spp_batch)
        return img.reshape(*bs, 3)
    if azimuth_strata is None:
        azimuth_strata = default_azimuth_strata(spp)
    if brute:
        img = render_fused(scene, org, d, seed, spp, max_bounces=max_bounces,
                           azimuth_strata=azimuth_strata)
        return img.reshape(*bs, 3)
    # 32 x 128 pixel tiles: a block of lanes covers a compact frustum
    sub_b = 32
    perm = None
    if len(bs) == 2 and bs[0] % sub_b == 0 and bs[1] % 128 == 0:
        H, W = bs
        with trace.span("pt.tiles"):
            perm = torch.arange(H * W, device=org.device).reshape(
                H // sub_b, sub_b, W // 128, 128).transpose(1, 2).reshape(-1)
            org, d = org[perm], d[perm]
    if spp_lanes is None:
        spp_lanes = default_spp_lanes(spp, azimuth_strata)
    img = render_fused_bvh(scene, org, d, seed, spp, max_bounces=max_bounces,
                           azimuth_strata=azimuth_strata,
                           spp_lanes=spp_lanes)
    if perm is not None:
        with trace.span("pt.untile"):
            img = torch.zeros_like(img).index_copy_(0, perm, img)
    return img.reshape(*bs, 3)
