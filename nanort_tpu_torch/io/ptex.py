"""Per-face texturing (Ptex-style) for raycast hits (port of
``nanort_tpu.io.ptex``; plain torch on the textures' device).

The reference's ptex example (examples/ptex/, 4.3k LoC) links Disney's
libPtex to look up per-face textures on tri/quad meshes — without the
external lib it doesn't build there either. This module provides the
capability natively:

* ``FaceTextures``: per-face texel grids (independent power-of-two
  resolutions per face, like Ptex), padded into one tensor for
  gather-friendly lookups.
* ``sample``: bilinear filtering in face-local (u, v) with edge clamp,
  driven straight from Hits (prim_id, u, v) — including the
  triangle->quad pairing the reference uses (two consecutive triangles
  form one quad face; the second triangle's barycentrics map to the
  quad's upper parametric half). Every product and sum is its own tensor
  op in the JAX package's order, so the samples are its bits.
* a compact zlib container (``save_ptex_npz``/``load_ptex_npz``) as the
  on-disk cache (the Ptex *file format* itself is proprietary-complex;
  the reference depends on an external reader for it too). The files are
  the JAX package's: either package reads what the other wrote.
"""

from __future__ import annotations

import io as _io
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..core.options import INVALID_PRIM_ID


class FaceTextures(NamedTuple):
    """Per-face texel grids, padded to a common (res_max, res_max, C).

    texels: (F, R, R, C) float32; ures/vres: (F,) int32 true per-face
    resolutions (<= R), tensors on one device. Lookups scale (u, v) by
    the true resolution so each face keeps its own texel density,
    exactly like Ptex per-face res."""

    texels: torch.Tensor
    ures: torch.Tensor
    vres: torch.Tensor

    @property
    def num_faces(self) -> int:
        return self.texels.shape[0]


def _on(texels, ures, vres, device) -> FaceTextures:
    return FaceTextures(
        texels=torch.as_tensor(np.array(texels, np.float32), device=device),
        ures=torch.as_tensor(np.array(ures, np.int32), device=device),
        vres=torch.as_tensor(np.array(vres, np.int32), device=device),
    )


def build_face_textures(faces_texels: list[np.ndarray],
                        device="cuda") -> FaceTextures:
    """Pack a list of per-face (u_res, v_res, C) arrays (power-of-two
    resolutions, common channel count) into a FaceTextures on ``device``
    (the card unless the caller asks for another device)."""
    if not faces_texels:
        raise ValueError("no faces")
    chans = {t.shape[2] for t in faces_texels}
    if len(chans) != 1:
        raise ValueError(f"mixed channel counts {chans}")
    for t in faces_texels:
        for r in t.shape[:2]:
            if r & (r - 1) or r == 0:
                raise ValueError(f"face res {t.shape[:2]} not power of two")
    rmax = max(max(t.shape[0], t.shape[1]) for t in faces_texels)
    c = chans.pop()
    packed = np.zeros((len(faces_texels), rmax, rmax, c), np.float32)
    ures = np.zeros(len(faces_texels), np.int32)
    vres = np.zeros(len(faces_texels), np.int32)
    for i, t in enumerate(faces_texels):
        ur, vr = t.shape[0], t.shape[1]
        packed[i, :ur, :vr] = t
        ures[i], vres[i] = ur, vr
    return _on(packed, ures, vres, device)


def sample(tex: FaceTextures, face_id, u, v):
    """Bilinear per-face lookup at face-local (u, v) in [0, 1]^2.
    face_id/u/v broadcast (tensors or arrays, moved to the textures'
    device); returns (..., C). Out-of-range face ids return zeros
    (miss-safe); ids are taken as int32, as the JAX package takes them,
    so a uint32 miss id (0xFFFFFFFF) reads as -1."""
    dev = tex.texels.device
    fid = torch.as_tensor(face_id, device=dev).to(torch.int32).long()
    u = torch.as_tensor(u, device=dev)
    v = torch.as_tensor(v, device=dev)
    ok = (fid >= 0) & (fid < tex.num_faces)
    f = torch.where(ok, fid, 0)
    ur_i = tex.ures.long()[f]
    vr_i = tex.vres.long()[f]
    ur = ur_i.to(torch.float32)
    vr = vr_i.to(torch.float32)
    x = u.clamp(0.0, 1.0) * ur - 0.5
    y = v.clamp(0.0, 1.0) * vr - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = x0.to(torch.int32).long().clamp(min=0)
    yi0 = y0.to(torch.int32).long().clamp(min=0)
    xi1 = torch.minimum(xi0 + 1, ur_i - 1)
    yi1 = torch.minimum(yi0 + 1, vr_i - 1)
    xi0 = torch.minimum(xi0, ur_i - 1)
    yi0 = torch.minimum(yi0, vr_i - 1)

    def tap(xi, yi):
        return tex.texels[f, xi, yi]

    c00 = tap(xi0, yi0)
    c10 = tap(xi1, yi0)
    c01 = tap(xi0, yi1)
    c11 = tap(xi1, yi1)
    fx = fx[..., None]
    fy = fy[..., None]
    out = (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )
    return torch.where(ok[..., None], out, torch.zeros((), device=dev))


def sample_tri_hits(tex: FaceTextures, hits, quad_faces: bool = True):
    """Shade Hits from a triangulated mesh. With ``quad_faces`` each
    consecutive triangle pair (2k, 2k+1) is one ptex face (the
    reference's quad handling): triangle 2k covers the (0,0)-(1,0)-(1,1)
    half with (u, v) = barycentric (u, v) mapped to quad params, and
    triangle 2k+1 the opposite half. ``hits``' prim ids are the port's
    int64 records (0xFFFFFFFF = miss)."""
    dev = tex.texels.device
    prim_id = torch.as_tensor(hits.prim_id, device=dev)
    pid = prim_id.to(torch.int32).long()
    u = torch.as_tensor(hits.u, device=dev)
    v = torch.as_tensor(hits.v, device=dev)
    if quad_faces:
        face = torch.div(pid, 2, rounding_mode="floor")
        second = torch.remainder(pid, 2) == 1
        # quad (v0,v1,v2,v3) triangulated (v0,v1,v2)+(v0,v2,v3) with
        # params v0=(0,0) v1=(1,0) v2=(1,1) v3=(0,1):
        #   tri 2k:   P = v0 + u(v1-v0) + v(v2-v0) -> (s,t) = (u+v, v)
        #   tri 2k+1: P = v0 + u(v2-v0) + v(v3-v0) -> (s,t) = (u, u+v)
        qu = torch.where(second, u, u + v)
        qv = torch.where(second, u + v, v)
    else:
        face = pid
        qu, qv = u, v
    valid = prim_id != INVALID_PRIM_ID
    face = torch.where(valid, face, -1)
    return sample(tex, face, qu, qv)


# ---------------------------------------------------------------------------
# on-disk container
# ---------------------------------------------------------------------------


def save_ptex_npz(path: str, tex: FaceTextures) -> None:
    """Write ``tex`` (its tensors fetched to the host) as the zlib
    container."""
    buf = _io.BytesIO()
    np.savez(
        buf,
        texels=tex.texels.detach().cpu().numpy(),
        ures=tex.ures.detach().cpu().numpy(),
        vres=tex.vres.detach().cpu().numpy(),
    )
    with open(path, "wb") as f:
        f.write(b"NTPX1\x00")
        f.write(zlib.compress(buf.getvalue(), 6))


def load_ptex_npz(path: str, device="cuda") -> FaceTextures:
    """Read the zlib container into a FaceTextures on ``device`` (the
    card unless the caller asks for another device)."""
    with open(path, "rb") as f:
        head = f.read(6)
        if head != b"NTPX1\x00":
            raise ValueError("not a nanort-tpu ptex container")
        data = zlib.decompress(f.read())
    z = np.load(_io.BytesIO(data))
    return _on(z["texels"], z["ures"], z["vres"], device)
